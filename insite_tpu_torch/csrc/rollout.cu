// Euler rollout of a discovered polynomial ODE, with and without forward
// sensitivities, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of insite_tpu/ops/pallas_rollout.py:
//   rollout_kernel      <- _kernel      (through pallas_batched_rollout)
//   rollout_sens_kernel <- _sens_kernel (through pallas_rollout_with_sens)
//
// The function. For patient b and step t: select the arm a = arms[b, t] (an
// arm outside [0, A) selects arm 0); take `substeps` Euler sub-steps
// y += h * sum_k c[b, a, k] * prod_i X_i^e[k, i] with X = [y, statics[b, :]];
// optionally clip y to (lo, hi), keeping NaN; write out[b, t] = y. The
// sensitivity kernel also integrates, for each active flat coordinate
// j = (a_j, f_j), s_j += h * (dF/dy * s_j + [a == a_j] * theta_{f_j}(X)) at
// the pre-update state, and zeroes s_j after a clip wherever y was not
// strictly inside (lo, hi) (jnp.clip's jvp). Outputs keep the JAX layouts,
// out [B, T] and sens [B, T, Kr]. The drive tests the selected arm a, so an
// arm outside [0, A) drives arm 0's coordinates and s_j stays the derivative
// of out; the Pallas kernel tests the raw arm there (no drive when A > 1).
// Real data has arms 0 and 1 only, where the two agree.
//
// What bounds it on an H100. Each patient is a chain of T * substeps
// dependent sub-steps. Nothing here is a matrix product: a sub-step is one
// polynomial in y plus three multiply-adds a sensitivity, so the tensor
// cores have no work and none are used. At the main table's n-step shape
// (B = 59,000, T = 64, Kr = 3 or 4) the call must move 80-94 MB and do
// ~0.4 GFLOP, so the bound is device-memory bytes (24-28 us at 3.35 TB/s);
// at B <= 12,000 the bytes take 2-4 us and one warp's serial chain of
// steps sets the time. The first design walked the [F, n_inputs] exponent
// table with data-dependent trip counts and re-read the F coefficients on
// every sub-step (~1,500 instructions), ran 4 warps an SM and stored one
// element a thread a step, 256-768 bytes apart. This design answers each:
//
// 1. Collapse the library once per patient. The statics are constant along
//    a trajectory and the arm is fixed within a step, so arm a's right-hand
//    side is p_a(y) = sum_d alpha[a][d] y^d with
//    alpha[a][d] = sum_{k: e[k,0] = d} c[a,k] prod_{i>0} u_i^e[k,i], and each
//    drive is theta_{f_j} = beta_j y^e[f_j,0] with
//    beta_j = prod_{i>0} u_i^e[f_j,i] (0^0 = 1). A prologue computes alpha
//    and beta; it is the only place the exponent table (a __grid_constant__
//    parameter, read through the constant cache) is walked. A sub-step is
//    then Horner's rule for p and p' = dF/dy plus Kr multiply-adds, with no
//    memory access and no data-dependent loop in the register model. The
//    update stays y + h * p(y).
// 2. No dynamic register indexing. SmallModel<Real> (A <= 4 arms,
//    D = max e[k,0] <= 1, Kr <= KR = 4, the 5 sub-steps of STEPS_FOR_DT:
//    the EQ_4 library F = 7, whose main-table fits have Kr = 3 or 4, and
//    the tumor family F = 4) keeps alpha, beta and the sensitivities in
//    registers, picks the step's arm by an unrolled select chain over its
//    4 arms, as the Pallas kernel does, and unrolls the 5 sub-steps into
//    straight-line code; unused coordinates are padding that stays 0, so
//    there is no per-coordinate branch. ptxas: 64 / 88 registers (f32
//    rollout / sens) and 114 / 114 (f64), no stack, no spill. GeneralModel
//    takes every other shape the wrapper accepts (A <= 8, D < F <= 64,
//    Kr <= 72, any sub-step count; e.g. the degree-4 ablation, D = 4, or a
//    support of more than 4 coordinates) with alpha, beta and the
//    sensitivities in shared memory, one column a thread.
// 3. Fill the card. SmallModel runs blocks of 64 threads (2 warps), one
//    patient a thread: the north star's B = 10,000 gives a grid of 157
//    blocks for the 132 SMs; the n-step set's 59,000 gives 922, which one
//    wave holds at 8 blocks (16 warps, 25 % occupancy) an SM, the limit set
//    by shared memory. GeneralModel runs one warp a block: its per-thread
//    state takes up to (8 * 64 + 2 * 72) * 8 bytes in f64.
// 4. Stage I/O through shared memory, coalesced. Each warp cuts T into
//    tiles of TT steps (tile_steps(): 32 for the f32 rollout, 16 for the
//    f32 sensitivities at Kr = 3, 8 at Kr = 4, down to 1 at Kr = 72). It
//    copies its 32 patients' arms[b0:b0+32, t0:t0+TT] into shared memory
//    with cp.async, lane i on the i-th element of the flattened block, one
//    tile ahead of the integration (double buffer). It integrates the tile,
//    writing y and s_j into shared tiles whose odd row strides keep the
//    per-step column writes free of bank conflicts, then stores them the
//    same flat way as contiguous row segments of out (TT values a patient)
//    and sens (TT * Kr values): with TT a multiple of 8 every 32-byte
//    sector of a segment is written whole, once. Shared memory a block,
//    f32: 25,344 bytes for the rollout, 25,600 for the sensitivities at
//    Kr = 3 and 15,360 at Kr = 4; see Layout.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

// Bounds: the degree-4 ablation library (F = 35 over 3 inputs, 2 arms) and
// the tumor family (4 arms) fit with room to spare. They are defined here
// only; the Python wrapper reads them through insite_rollout_bounds.
constexpr int MAX_F = 64;
constexpr int MAX_INPUTS = 4;
constexpr int MAX_ARMS = 8;
constexpr int MAX_KR = 72;     // every coordinate of 2 arms x 35 features
constexpr int kWarp = 32;
constexpr int kSubsteps = 5;  // STEPS_FOR_DT: Euler sub-steps an interval
constexpr int MAX_TT = 32;              // time steps a staged tile
constexpr int kTileBudget = 12 * 1024;  // bytes of I/O tiles a warp

struct Dims {
  int B, T, A, F, S, D, substeps, Kr;  // D = max power of y; Kr = 0: rollout
  int TT;                              // time steps a tile
  long long coef_bstride;              // 0: coefficients shared by all rows
};

template <typename Real>
struct Args {
  const Real* coefs;    // [1 or B, A, F]
  const Real* y0;       // [B]
  const Real* statics;  // [B, S]
  const int* arms;      // [B, T]
  Real* out;            // [B, T]
  Real* sens;           // [B, T, Kr]
  Real h;
  int clip_on;
  Real lo, hi;
};

// The library's exponent table and the active coordinates, passed by value
// as a __grid_constant__ kernel parameter: every thread reads them through
// the constant cache, with no copy into shared memory and no block barrier.
struct Tables {
  int exps[MAX_F * MAX_INPUTS];  // [F, S + 1]
  int act[3 * MAX_KR];           // (arm, feature, e[feature, 0]) per coord.
};

// The block's shared memory, in bytes from dyn_smem: the model's state,
// then each warp's y and sens tiles (Real), then each warp's two arm tiles
// (int). Row strides are odd, so a warp writing one column (one step of
// its 32 patients) hits 32 banks.
struct Layout {
  int AS, YS, SS;
  size_t ytile, stile, arm, total;
  __host__ __device__ Layout(const Dims& d, size_t real_bytes,
                             size_t state_slots, int threads) {
    const int warps = threads / kWarp;
    AS = d.TT | 1;
    YS = d.TT | 1;
    SS = d.Kr > 0 ? ((d.TT * d.Kr) | 1) : 0;
    size_t o = state_slots * threads * real_bytes;
    ytile = o;
    o += size_t(warps) * kWarp * YS * real_bytes;
    stile = o;
    o += size_t(warps) * kWarp * SS * real_bytes;
    arm = o;
    o += size_t(warps) * 2 * kWarp * AS * sizeof(int);
    total = o;
  }
};

// prod_{i>0} X_i^e[i] for one row of the exponent table: the statics' part
// of a monomial, by repeated multiplication (0^0 = 1).
template <typename Real>
__device__ __forceinline__ Real statics_monomial(
    const int* e, const Real (&u)[MAX_INPUTS - 1], int S) {
  Real m = Real(1);
#pragma unroll
  for (int i = 0; i < MAX_INPUTS - 1; ++i) {
    if (i < S) {
      for (int p = 0; p < e[i + 1]; ++p) m *= u[i];
    }
  }
  return m;
}

// NaN passes through, as in jnp.clip and torch.clamp (fmin/fmax drop it).
template <typename Real>
__device__ __forceinline__ Real clamp(Real y, Real lo, Real hi) {
  return y < lo ? lo : (y > hi ? hi : y);
}

// An arm outside [0, A) selects arm 0, as the Pallas kernel's select chain
// does for the coefficients (see the header note for the drive).
__device__ __forceinline__ int select_arm(int a, int A) {
  return (a >= 0 && a < A) ? a : 0;
}

// A <= 4 arms, D <= 1, Kr <= KR = 4: everything in registers.
// p_a(y) = a0[a] + a1[a] * y, so dF/dy = a1[a]. Each step sets coordinate
// j's drive to g0[j] + g1[j] * y: beta_j (e = 0) or beta_j * y (e = 1) if
// the step's arm is a_j, else 0. The KR - Kr unused coordinates have
// beta = 0 and stay 0, so a sub-step has no per-coordinate branch: two
// multiply-adds for y and three for each sensitivity.
template <typename Real>
struct SmallModel {
  static constexpr int kThreads = 64;
  static constexpr int kMinBlocks = 8;       // an SM's shared memory holds 8
  static constexpr int kFixedSubsteps = kSubsteps;
  static constexpr int NA = 4;
  static constexpr int KR = 4;
  __host__ __device__ static bool takes(const Dims& d) {
    return d.A <= NA && d.D <= 1 && d.Kr <= KR && d.substeps == kSubsteps;
  }
  __host__ __device__ static size_t state_slots(const Dims&) { return 0; }

  Real a0[NA], a1[NA];
  Real c0, c1;  // the step's arm
  Real beta[KR], s[KR], g0[KR], g1[KR];
  int act_arm[KR];
  bool act_y[KR];

  __device__ __forceinline__ void init(const Real* c,
                                       const Real (&u)[MAX_INPUTS - 1],
                                       const int* exps, const int* act,
                                       const Dims& d, Real*) {
    const int n_in = d.S + 1;
#pragma unroll
    for (int a = 0; a < NA; ++a) a0[a] = a1[a] = Real(0);
    // features in chunks of 8: a chunk's A * 8 coefficient loads are all in
    // flight together (F = 7 takes one round trip to memory)
    for (int k0 = 0; k0 < d.F; k0 += 8) {
      Real ck[NA][8];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ck[a][i] = (a < d.A && k0 + i < d.F) ? c[a * d.F + k0 + i]
                                                : Real(0);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (k0 + i < d.F) {
          const int* e = exps + (k0 + i) * n_in;
          const Real m = statics_monomial(e, u, d.S);
          const bool in_y = e[0] != 0;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            if (in_y) {
              a1[a] += ck[a][i] * m;
            } else {
              a0[a] += ck[a][i] * m;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      s[j] = Real(0);
      beta[j] = Real(0);
      act_arm[j] = -1;
      act_y[j] = false;
      if (j < d.Kr) {
        act_arm[j] = act[3 * j];
        act_y[j] = act[3 * j + 2] != 0;
        beta[j] = statics_monomial(exps + act[3 * j + 1] * n_in, u, d.S);
      }
    }
  }

  __device__ __forceinline__ void select(int a) {
    c0 = a0[0];
    c1 = a1[0];
#pragma unroll
    for (int k = 1; k < NA; ++k) {
      c0 = a == k ? a0[k] : c0;
      c1 = a == k ? a1[k] : c1;
    }
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      const Real driven = a == act_arm[j] ? beta[j] : Real(0);
      g0[j] = act_y[j] ? Real(0) : driven;
      g1[j] = act_y[j] ? driven : Real(0);
    }
  }

  template <bool kSens>
  __device__ __forceinline__ Real substep(Real y, Real h) {
    if constexpr (kSens) {
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        s[j] = s[j] + h * (c1 * s[j] + (g0[j] + g1[j] * y));
      }
    }
    return y + h * (c0 + c1 * y);
  }

  __device__ __forceinline__ void zero_sens(bool zero) {
#pragma unroll
    for (int j = 0; j < KR; ++j) s[j] = zero ? Real(0) : s[j];
  }

  __device__ __forceinline__ void write_sens(Real* dst, int Kr) const {
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      if (j < Kr) dst[j] = s[j];
    }
  }
};

// Every shape the wrapper accepts (A <= 8, D < F <= 64, Kr <= 72): alpha
// [A][D + 1], beta [Kr] and s [Kr] live in shared memory, one slot per
// thread and value, kThreads apart (conflict-free for any arm).
template <typename Real>
struct GeneralModel {
  static constexpr int kThreads = 32;
  static constexpr int kMinBlocks = 1;
  static constexpr int kFixedSubsteps = 0;  // d.substeps
  __host__ __device__ static size_t state_slots(const Dims& d) {
    return size_t(d.A) * (d.D + 1) + 2 * size_t(d.Kr);
  }

  Real* alpha;
  Real* beta;
  Real* s;
  const Real* cur;  // the step's arm in alpha
  const int* act;
  int arm, D, Kr;

  __device__ __forceinline__ void init(const Real* c,
                                       const Real (&u)[MAX_INPUTS - 1],
                                       const int* exps, const int* act_,
                                       const Dims& d, Real* state) {
    const int n_in = d.S + 1;
    D = d.D;
    Kr = d.Kr;
    act = act_;
    alpha = state;
    beta = alpha + d.A * (D + 1) * kThreads;
    s = beta + Kr * kThreads;
    for (int i = 0; i < d.A * (D + 1); ++i) alpha[i * kThreads] = Real(0);
    for (int k = 0; k < d.F; ++k) {
      const int* e = exps + k * n_in;
      const Real m = statics_monomial(e, u, d.S);
      for (int a = 0; a < d.A; ++a) {
        alpha[(a * (D + 1) + e[0]) * kThreads] += c[a * d.F + k] * m;
      }
    }
    for (int j = 0; j < Kr; ++j) {
      beta[j * kThreads] =
          statics_monomial(exps + act[3 * j + 1] * n_in, u, d.S);
      s[j * kThreads] = Real(0);
    }
  }

  __device__ __forceinline__ void select(int a) {
    arm = a;
    cur = alpha + a * (D + 1) * kThreads;
  }

  template <bool kSens>
  __device__ __forceinline__ Real substep(Real y, Real h) {
    Real p = cur[D * kThreads];
    Real dp = Real(0);
    for (int k = D - 1; k >= 0; --k) {
      dp = dp * y + p;
      p = p * y + cur[k * kThreads];
    }
    if constexpr (kSens) {
      for (int j = 0; j < Kr; ++j) {
        Real theta = beta[j * kThreads];
        for (int q = 0; q < act[3 * j + 2]; ++q) theta *= y;
        const Real drive = act[3 * j] == arm ? theta : Real(0);
        const Real sj = s[j * kThreads];
        s[j * kThreads] = sj + h * (dp * sj + drive);
      }
    }
    return y + h * p;
  }

  __device__ __forceinline__ void zero_sens(bool zero) {
    if (zero) {
      for (int j = 0; j < Kr; ++j) s[j * kThreads] = Real(0);
    }
  }

  __device__ __forceinline__ void write_sens(Real* dst, int) const {
    for (int j = 0; j < Kr; ++j) dst[j] = s[j * kThreads];
  }
};

// Visit the elements (r, c) of a [rows, width] block, element i = r *
// width + c on lane i % 32: each pass of the warp covers 32 consecutive
// elements, which lie in one or a few rows. One division a block; the
// passes are unrolled so their memory latencies overlap.
template <class Op>
__device__ __forceinline__ void for_block(int rows, int width, int lane,
                                          Op op) {
  const int n = rows * width;
  const int dr = kWarp / width, dc = kWarp % width;
  int r = lane / width, c = lane % width;
#pragma unroll 4
  for (int i = lane; i < n; i += kWarp) {
    op(r, c);
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
}

// Start copying rows [0, rows) x steps [t0, t0 + width) of a warp's arms
// into a tile with row stride AS.
__device__ __forceinline__ void load_arm_tile(int* tile, const int* arms,
                                              int T, int t0, int width,
                                              int rows, int AS, int lane) {
  for_block(rows, width, lane, [&](int r, int c) {
    __pipeline_memcpy_async(tile + r * AS + c,
                            arms + (long long)r * T + t0 + c, sizeof(int));
  });
  __pipeline_commit();
}

// Store rows [0, rows) x columns [0, width) of a tile with row stride ts to
// dst with row stride ds: one contiguous segment a row.
template <typename Real>
__device__ __forceinline__ void store_tile(Real* dst, long long ds,
                                           const Real* tile, int ts,
                                           int width, int rows, int lane) {
  for_block(rows, width, lane,
            [&](int r, int c) { dst[r * ds + c] = tile[r * ts + c]; });
}

template <typename Real, class Model, bool kSens>
__device__ __forceinline__ void integrate(const Args<Real>& g,
                                          const Dims& d, const Tables& tab) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const Layout L(d, sizeof(Real), Model::state_slots(d), Model::kThreads);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int b0 = blockIdx.x * Model::kThreads + warp * kWarp;
  if (b0 >= d.B) return;
  const int rows = min(kWarp, d.B - b0);
  // lanes past B integrate a copy of the last row and store nothing
  const int b = b0 + min(lane, rows - 1);
  Real* ytile = reinterpret_cast<Real*>(dyn_smem + L.ytile) +
                warp * kWarp * L.YS;
  Real* stile = reinterpret_cast<Real*>(dyn_smem + L.stile) +
                warp * kWarp * L.SS;
  int* atile = reinterpret_cast<int*>(dyn_smem + L.arm) +
               warp * 2 * kWarp * L.AS;
  const int* arms = g.arms + (long long)b0 * d.T;
  load_arm_tile(atile, arms, d.T, 0, min(d.TT, d.T), rows, L.AS, lane);

  // the prologue overlaps the first tile's copy
  Real u[MAX_INPUTS - 1];
#pragma unroll
  for (int i = 0; i < MAX_INPUTS - 1; ++i) {
    u[i] = i < d.S ? g.statics[(long long)b * d.S + i] : Real(0);
  }
  Model m;
  m.init(g.coefs + b * d.coef_bstride, u, tab.exps, tab.act, d,
         reinterpret_cast<Real*>(dyn_smem) + threadIdx.x);
  Real y = g.y0[b];

  Real* yrow = ytile + lane * L.YS;
  Real* srow = stile + lane * L.SS;
  for (int t0 = 0, buf = 0; t0 < d.T; t0 += d.TT, buf ^= 1) {
    const int tt = min(d.TT, d.T - t0);
    if (t0 + d.TT < d.T) {
      load_arm_tile(atile + (buf ^ 1) * kWarp * L.AS, arms, d.T, t0 + d.TT,
                    min(d.TT, d.T - t0 - d.TT), rows, L.AS, lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const int* arm = atile + buf * kWarp * L.AS + lane * L.AS;
    int a_next = arm[0];
    for (int t = 0; t < tt; ++t) {
      const int a = a_next;
      a_next = arm[min(t + 1, tt - 1)];  // off the step's critical path
      m.select(select_arm(a, d.A));
      if constexpr (Model::kFixedSubsteps > 0) {
#pragma unroll
        for (int s = 0; s < Model::kFixedSubsteps; ++s) {
          y = m.template substep<kSens>(y, g.h);
        }
      } else {
        for (int s = 0; s < d.substeps; ++s) {
          y = m.template substep<kSens>(y, g.h);
        }
      }
      // selects, not branches
      const bool outside = g.clip_on && !(y > g.lo && y < g.hi);
      y = g.clip_on ? clamp(y, g.lo, g.hi) : y;
      if constexpr (kSens) m.zero_sens(outside);
      yrow[t] = y;
      if constexpr (kSens) m.write_sens(srow + t * d.Kr, d.Kr);
    }
    __syncwarp();
    store_tile(g.out + (long long)b0 * d.T + t0, d.T, ytile, L.YS, tt, rows,
               lane);
    if constexpr (kSens) {
      store_tile(g.sens + ((long long)b0 * d.T + t0) * d.Kr,
                 (long long)d.T * d.Kr, stile, L.SS, tt * d.Kr, rows, lane);
    }
    __syncwarp();  // the tiles are free for the next steps
  }
}

template <typename Real, class Model>
__global__ void __launch_bounds__(Model::kThreads, Model::kMinBlocks)
    rollout_kernel(const Args<Real> g, const Dims d,
                   const __grid_constant__ Tables tab) {
  integrate<Real, Model, false>(g, d, tab);
}

template <typename Real, class Model>
__global__ void __launch_bounds__(Model::kThreads, Model::kMinBlocks)
    rollout_sens_kernel(const Args<Real> g, const Dims d,
                        const __grid_constant__ Tables tab) {
  integrate<Real, Model, true>(g, d, tab);
}

bool dims_ok(const Dims& d, bool sens) {
  return d.B > 0 && d.T > 0 && d.A >= 1 && d.A <= MAX_ARMS && d.F >= 1 &&
         d.F <= MAX_F && d.S >= 0 && d.S + 1 <= MAX_INPUTS &&
         d.substeps >= 1 &&
         (sens ? (d.Kr >= 1 && d.Kr <= MAX_KR) : d.Kr == 0);
}

// Steps a tile: as many as kTileBudget bytes of y, sens and the two arm
// tiles allow for a warp, from 1 to MAX_TT, and a multiple of 8 from 8 on:
// with T * Kr * sizeof(Real) a multiple of 32 bytes (the n-step set's
// T = 64), every row segment a tile stores then fills whole 32-byte
// sectors, which L2 never has to merge with a later tile's writes.
int tile_steps(size_t real_bytes, int Kr) {
  const size_t per_step = kWarp * (real_bytes * (1 + Kr) + 2 * sizeof(int));
  const int tt = int(std::max<size_t>(
      1, std::min<size_t>(MAX_TT, kTileBudget / per_step)));
  return tt >= 8 ? tt / 8 * 8 : tt;
}

template <typename Real, class Model, bool kSens>
int launch(const Args<Real>& g, Dims d, const Tables& tab,
           cudaStream_t stream) {
  d.TT = tile_steps(sizeof(Real), d.Kr);
  const Layout L(d, sizeof(Real), Model::state_slots(d), Model::kThreads);
  void (*kernel)(const Args<Real>, const Dims, const Tables) =
      kSens ? rollout_sens_kernel<Real, Model> : rollout_kernel<Real, Model>;
  if (L.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (d.B + Model::kThreads - 1) / Model::kThreads;
  kernel<<<grid, Model::kThreads, L.total, stream>>>(g, d, tab);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real, bool kSens>
int dispatch(const Args<Real>& g, const Dims& d, const Tables& tab,
             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (SmallModel<Real>::takes(d)) {
    return launch<Real, SmallModel<Real>, kSens>(g, d, tab, st);
  }
  return launch<Real, GeneralModel<Real>, kSens>(g, d, tab, st);
}

template <typename Real>
int rollout(const void* coefs, long long coef_bstride, const void* y0,
            const void* statics, const void* arms, const void* exps,
            const void* active, int Kr, void* out, void* sens, int B, int T,
            int A, int F, int S, int substeps, Real h, int clip_on, Real lo,
            Real hi, void* stream) {
  const Args<Real> g{static_cast<const Real*>(coefs),
                     static_cast<const Real*>(y0),
                     static_cast<const Real*>(statics),
                     static_cast<const int*>(arms),
                     static_cast<Real*>(out),
                     static_cast<Real*>(sens),
                     h,
                     clip_on,
                     lo,
                     hi};
  Dims d{B, T, A, F, S, 0, substeps, Kr, 0, coef_bstride};
  const bool is_sens = sens != nullptr;
  if (!dims_ok(d, is_sens)) return static_cast<int>(cudaErrorInvalidValue);
  Tables tab{};
  const int n_in = S + 1;
  const auto* e = static_cast<const int*>(exps);
  std::copy(e, e + F * n_in, tab.exps);
  for (int k = 0; k < F; ++k) d.D = std::max(d.D, e[k * n_in]);
  if (d.D >= F) return static_cast<int>(cudaErrorInvalidValue);
  const auto* act = static_cast<const int*>(active);
  for (int j = 0; j < Kr; ++j) {
    const int arm = act[2 * j], f = act[2 * j + 1];
    if (arm < 0 || arm >= A || f < 0 || f >= F) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tab.act[3 * j] = arm;
    tab.act[3 * j + 1] = f;
    tab.act[3 * j + 2] = e[f * n_in];
  }
  return is_sens ? dispatch<Real, true>(g, d, tab, stream)
                 : dispatch<Real, false>(g, d, tab, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launcher returns the
// cudaError_t of its launch (cudaErrorInvalidValue for shapes outside the
// bounds above, which the wrapper rejects before it gets here). exps
// [F, S + 1] and active [Kr, 2] (arm, feature) are host arrays; the other
// arrays are on the card.
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
                       int F, int S, int substeps, float h,
                       int clip_on, float lo, float hi, void* stream) {
  return rollout<float>(coefs, coef_bstride, y0, statics, arms, exps,
                        nullptr, 0, out, nullptr, B, T, A, F, S, substeps,
                        h, clip_on, lo, hi, stream);
}

int insite_rollout_f64(const void* coefs, long long coef_bstride,
                       const void* y0, const void* statics, const void* arms,
                       const void* exps, void* out, int B, int T, int A,
                       int F, int S, int substeps, double h,
                       int clip_on, double lo, double hi, void* stream) {
  return rollout<double>(coefs, coef_bstride, y0, statics, arms, exps,
                         nullptr, 0, out, nullptr, B, T, A, F, S,
                         substeps, h, clip_on, lo, hi, stream);
}

int insite_rollout_sens_f32(const void* coefs, long long coef_bstride,
                            const void* y0, const void* statics,
                            const void* arms, const void* exps,
                            const void* active, int Kr, void* out, void* sens,
                            int B, int T, int A, int F, int S,
                            int substeps, float h, int clip_on, float lo,
                            float hi, void* stream) {
  if (sens == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return rollout<float>(coefs, coef_bstride, y0, statics, arms, exps, active,
                        Kr, out, sens, B, T, A, F, S, substeps, h,
                        clip_on, lo, hi, stream);
}

int insite_rollout_sens_f64(const void* coefs, long long coef_bstride,
                            const void* y0, const void* statics,
                            const void* arms, const void* exps,
                            const void* active, int Kr, void* out, void* sens,
                            int B, int T, int A, int F, int S,
                            int substeps, double h, int clip_on, double lo,
                            double hi, void* stream) {
  if (sens == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return rollout<double>(coefs, coef_bstride, y0, statics, arms, exps,
                         active, Kr, out, sens, B, T, A, F, S, substeps,
                         h, clip_on, lo, hi, stream);
}

}  // extern "C"
