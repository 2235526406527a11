// Euler rollout of a discovered polynomial ODE, with and without forward
// sensitivities, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of insite_tpu/ops/pallas_rollout.py:
//   rollout_kernel      <- _kernel      (through pallas_batched_rollout)
//   rollout_sens_kernel <- _sens_kernel (through pallas_rollout_with_sens)
//
// For patient b and step t: select c = coefs[b, arms[b, t], :]; take
// `substeps` Euler sub-steps y += h * sum_k c_k * prod_i X_i^e[k, i] with
// X = [y, statics[b, :]]; optionally clip y to (lo, hi); write out[b, t] = y.
// The sensitivity kernel also integrates, for each active flat coordinate
// j = (a_j, f_j), s_j += h * (dF/dy * s_j + [arm == a_j] * theta_{f_j}(X)) at
// the pre-update state, and zeroes s_j after a clip wherever y was not
// strictly inside (lo, hi) (jnp.clip's jvp).
//
// Layout: one thread per patient, blocks of 128, b < B masked. The state y
// and the Kr sensitivities stay in registers for all T steps; the exponent
// table [F, n_inputs] and the active coordinates [Kr, 2] sit in shared
// memory, read by all threads at the same address (a broadcast). Each thread
// writes its own row of out [B, T] and sens [B, T, Kr], the JAX package's
// layout.
//
// What bounds it on an H100: each patient is a sequential recurrence of
// T * substeps dependent sub-steps of a few dozen flops, and the whole call
// moves a few MB. At the main path's B = 10,000 the grid is 79 blocks of 128
// threads, fewer than the 132 SMs, so the kernel is bound by the latency of
// that dependent chain, not by bandwidth or arithmetic throughput.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
// Bounds: the degree-4 ablation library (F = 35 over 3 inputs, 2 arms) and
// the tumor family (4 arms) fit with room to spare. They are defined here
// only; the Python wrapper reads them through insite_rollout_bounds.
constexpr int MAX_F = 64;
constexpr int MAX_INPUTS = 4;
constexpr int MAX_ARMS = 8;
constexpr int MAX_KR = 72;     // every coordinate of 2 arms x 35 features
constexpr int SMALL_KR = 8;    // the EQ_4 main path has Kr = 3

struct Dims {
  int B, T, A, F, S, substeps;
  long long coef_bstride;      // 0: coefficients shared by all patients
};

template <typename Real>
struct Clip {
  int on;
  Real lo, hi;
};

// prod_i x_i^e_i for one row of the exponent table (x[0] = y).
template <typename Real>
__device__ __forceinline__ Real monomial(const int* e, int n_in,
                                         const Real (&x)[MAX_INPUTS]) {
  Real term = Real(1);
#pragma unroll
  for (int i = 0; i < MAX_INPUTS; ++i) {
    if (i < n_in) {
      for (int p = 0; p < e[i]; ++p) term *= x[i];
    }
  }
  return term;
}

// d/dy of the monomial: e_0 * y^(e_0 - 1) * prod_{i>0} x_i^e_i (e_0 > 0).
template <typename Real>
__device__ __forceinline__ Real dmonomial_dy(const int* e, int n_in,
                                             const Real (&x)[MAX_INPUTS]) {
  Real term = Real(e[0]);
  for (int p = 1; p < e[0]; ++p) term *= x[0];
#pragma unroll
  for (int i = 1; i < MAX_INPUTS; ++i) {
    if (i < n_in) {
      for (int p = 0; p < e[i]; ++p) term *= x[i];
    }
  }
  return term;
}

// NaN passes through, as in jnp.clip and torch.clamp (fmin/fmax drop it).
template <typename Real>
__device__ __forceinline__ Real clamp(Real y, Real lo, Real hi) {
  return y < lo ? lo : (y > hi ? hi : y);
}

// An arm outside [0, A) selects arm 0, as the Pallas kernel's select chain
// does; it also keeps the coefficient read in bounds.
__device__ __forceinline__ int select_arm(int a, int A) {
  return (a >= 0 && a < A) ? a : 0;
}

template <typename Real>
__device__ __forceinline__ void load_statics(Real (&x)[MAX_INPUTS],
                                             const Real* statics, int b,
                                             int S) {
#pragma unroll
  for (int i = 1; i < MAX_INPUTS; ++i) {
    x[i] = (i <= S) ? statics[(long long)b * S + (i - 1)] : Real(0);
  }
}

__device__ __forceinline__ void load_table(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

template <typename Real>
__global__ void __launch_bounds__(kBlock) rollout_kernel(
    const Real* __restrict__ coefs, const Real* __restrict__ y0,
    const Real* __restrict__ statics, const int* __restrict__ arms,
    const int* __restrict__ exps, Real* __restrict__ out, Dims d, Real h,
    Clip<Real> clip) {
  __shared__ int sh_exp[MAX_F * MAX_INPUTS];
  const int n_in = d.S + 1;
  load_table(sh_exp, exps, d.F * n_in);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= d.B) return;

  Real x[MAX_INPUTS];
  load_statics(x, statics, b, d.S);
  Real y = y0[b];
  const Real* coef_row = coefs + b * d.coef_bstride;
  const int* arm_row = arms + (long long)b * d.T;
  Real* out_row = out + (long long)b * d.T;
  for (int t = 0; t < d.T; ++t) {
    const Real* c = coef_row + select_arm(arm_row[t], d.A) * d.F;
    for (int s = 0; s < d.substeps; ++s) {
      x[0] = y;
      Real dy = Real(0);
      for (int k = 0; k < d.F; ++k) {
        dy += c[k] * monomial(sh_exp + k * n_in, n_in, x);
      }
      y = y + h * dy;
    }
    if (clip.on) y = clamp(y, clip.lo, clip.hi);
    out_row[t] = y;
  }
}

template <typename Real, int KR>
__global__ void __launch_bounds__(kBlock) rollout_sens_kernel(
    const Real* __restrict__ coefs, const Real* __restrict__ y0,
    const Real* __restrict__ statics, const int* __restrict__ arms,
    const int* __restrict__ exps, const int* __restrict__ active, int Kr,
    Real* __restrict__ out, Real* __restrict__ sens, Dims d, Real h,
    Clip<Real> clip) {
  __shared__ int sh_exp[MAX_F * MAX_INPUTS];
  __shared__ int sh_act[2 * KR];          // (arm, feature) per coordinate
  const int n_in = d.S + 1;
  load_table(sh_exp, exps, d.F * n_in);
  load_table(sh_act, active, 2 * Kr);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= d.B) return;

  Real x[MAX_INPUTS];
  load_statics(x, statics, b, d.S);
  Real y = y0[b];
  Real sj[KR];
#pragma unroll
  for (int j = 0; j < KR; ++j) sj[j] = Real(0);
  const Real* coef_row = coefs + b * d.coef_bstride;
  const int* arm_row = arms + (long long)b * d.T;
  Real* out_row = out + (long long)b * d.T;
  Real* sens_row = sens + (long long)b * d.T * Kr;
  for (int t = 0; t < d.T; ++t) {
    const int a = select_arm(arm_row[t], d.A);
    const Real* c = coef_row + a * d.F;
    for (int s = 0; s < d.substeps; ++s) {
      x[0] = y;
      Real dy = Real(0);
      Real dfdy = Real(0);
      for (int k = 0; k < d.F; ++k) {
        const int* e = sh_exp + k * n_in;
        dy += c[k] * monomial(e, n_in, x);
        if (e[0] > 0) dfdy += c[k] * dmonomial_dy(e, n_in, x);
      }
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        if (j < Kr) {
          const Real drive =
              a == sh_act[2 * j]
                  ? monomial(sh_exp + sh_act[2 * j + 1] * n_in, n_in, x)
                  : Real(0);
          sj[j] = sj[j] + h * (dfdy * sj[j] + drive);
        }
      }
      y = y + h * dy;
    }
    if (clip.on) {
      const bool inside = y > clip.lo && y < clip.hi;
      y = clamp(y, clip.lo, clip.hi);
      if (!inside) {
#pragma unroll
        for (int j = 0; j < KR; ++j) sj[j] = Real(0);
      }
    }
    out_row[t] = y;
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      if (j < Kr) sens_row[(long long)t * Kr + j] = sj[j];
    }
  }
}

bool dims_ok(const Dims& d) {
  return d.B > 0 && d.T > 0 && d.A >= 1 && d.A <= MAX_ARMS && d.F >= 1 &&
         d.F <= MAX_F && d.S >= 0 && d.S + 1 <= MAX_INPUTS &&
         d.substeps >= 1;
}

int grid_for(int B) { return (B + kBlock - 1) / kBlock; }

template <typename Real>
int launch_rollout(const void* coefs, long long coef_bstride, const void* y0,
                   const void* statics, const void* arms, const void* exps,
                   void* out, int B, int T, int A, int F, int S, int substeps,
                   Real h, int clip_on, Real lo, Real hi, void* stream) {
  const Dims d{B, T, A, F, S, substeps, coef_bstride};
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  rollout_kernel<Real><<<grid_for(B), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Real*>(coefs), static_cast<const Real*>(y0),
      static_cast<const Real*>(statics), static_cast<const int*>(arms),
      static_cast<const int*>(exps), static_cast<Real*>(out), d, h,
      Clip<Real>{clip_on, lo, hi});
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch_sens(const void* coefs, long long coef_bstride, const void* y0,
                const void* statics, const void* arms, const void* exps,
                const void* active, int Kr, void* out, void* sens, int B,
                int T, int A, int F, int S, int substeps, Real h, int clip_on,
                Real lo, Real hi, void* stream) {
  const Dims d{B, T, A, F, S, substeps, coef_bstride};
  if (!dims_ok(d) || Kr < 1 || Kr > MAX_KR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const Clip<Real> clip{clip_on, lo, hi};
  const auto* c = static_cast<const Real*>(coefs);
  const auto* y = static_cast<const Real*>(y0);
  const auto* u = static_cast<const Real*>(statics);
  const auto* ar = static_cast<const int*>(arms);
  const auto* ex = static_cast<const int*>(exps);
  const auto* ac = static_cast<const int*>(active);
  auto* o = static_cast<Real*>(out);
  auto* s = static_cast<Real*>(sens);
  // a small register array for the usual 2-8 active coordinates; the large
  // one (which may spill) only for wide supports
  if (Kr <= SMALL_KR) {
    rollout_sens_kernel<Real, SMALL_KR><<<grid_for(B), kBlock, 0, st>>>(
        c, y, u, ar, ex, ac, Kr, o, s, d, h, clip);
  } else {
    rollout_sens_kernel<Real, MAX_KR><<<grid_for(B), kBlock, 0, st>>>(
        c, y, u, ar, ex, ac, Kr, o, s, d, h, clip);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launcher returns the
// cudaError_t of its launch (cudaErrorInvalidValue for shapes outside the
// bounds above, which the wrapper rejects before it gets here).
extern "C" {

// The compile-time bounds, for the wrapper's shape check:
// out = {MAX_F, MAX_INPUTS, MAX_ARMS, MAX_KR}.
void insite_rollout_bounds(int* out) {
  out[0] = MAX_F;
  out[1] = MAX_INPUTS;
  out[2] = MAX_ARMS;
  out[3] = MAX_KR;
}

int insite_rollout_f32(const void* coefs, long long coef_bstride,
                       const void* y0, const void* statics, const void* arms,
                       const void* exps, void* out, int B, int T, int A,
                       int F, int S, int substeps, float h, int clip_on,
                       float lo, float hi, void* stream) {
  return launch_rollout<float>(coefs, coef_bstride, y0, statics, arms, exps,
                               out, B, T, A, F, S, substeps, h, clip_on, lo,
                               hi, stream);
}

int insite_rollout_f64(const void* coefs, long long coef_bstride,
                       const void* y0, const void* statics, const void* arms,
                       const void* exps, void* out, int B, int T, int A,
                       int F, int S, int substeps, double h, int clip_on,
                       double lo, double hi, void* stream) {
  return launch_rollout<double>(coefs, coef_bstride, y0, statics, arms, exps,
                                out, B, T, A, F, S, substeps, h, clip_on, lo,
                                hi, stream);
}

int insite_rollout_sens_f32(const void* coefs, long long coef_bstride,
                            const void* y0, const void* statics,
                            const void* arms, const void* exps,
                            const void* active, int Kr, void* out, void* sens,
                            int B, int T, int A, int F, int S, int substeps,
                            float h, int clip_on, float lo, float hi,
                            void* stream) {
  return launch_sens<float>(coefs, coef_bstride, y0, statics, arms, exps,
                            active, Kr, out, sens, B, T, A, F, S, substeps, h,
                            clip_on, lo, hi, stream);
}

int insite_rollout_sens_f64(const void* coefs, long long coef_bstride,
                            const void* y0, const void* statics,
                            const void* arms, const void* exps,
                            const void* active, int Kr, void* out, void* sens,
                            int B, int T, int A, int F, int S, int substeps,
                            double h, int clip_on, double lo, double hi,
                            void* stream) {
  return launch_sens<double>(coefs, coef_bstride, y0, statics, arms, exps,
                             active, Kr, out, sens, B, T, A, F, S, substeps,
                             h, clip_on, lo, hi, stream);
}

}  // extern "C"
