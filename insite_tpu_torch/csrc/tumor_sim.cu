// The tumour simulator's two day loops, one thread a patient through every
// day, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs these loops as lax.scan /
// fori_loop (insite_tpu/sim/tumor.py), and the port ran them as a Python loop
// over days on [B] tensors (insite_tpu_torch/sim/tumor.py::_factual_loop and
// _cf_factual_loop), ~60 element-wise launches a day over ~59 days. Those
// loops stay the host's path and the reference of these kernels:
//   tumor_factual_kernel    <- _factual_loop    (factual_core)
//   tumor_cf_factual_kernel <- _cf_factual_loop (cf_factual_core)
//
// The function. Patient b's ten parameters (sim/tumor.py::PARAM_KEYS), its
// rows of the draws noise, recovery, chemo_rv and radio_rv (each with its own
// row stride: the test cohort's noise is T + ph long), then for each day the
// loop's update
//   V[t] = V[t-1] (1 + rho log(K / max(V[t-1], 1e-30)) - beta_c C[t-1]
//                  - (alpha d[t-1] + beta d[t-1]^2) + eps[t])
// with the sigmoid-confounded chemo and radio assignments on the mean
// diameter of the window of earlier volumes, the chemo concentration that
// halves daily, and the stop on death (V above the threshold) or recovery
// (a draw below exp(-V * cell density)). A patient that stopped writes
// zeros from then on, as the loop's masks do. Every output of the loop is
// written here, in its layout, padding columns included, so the host adds
// nothing after the launch.
//
// Rounding. Every +, -, * and / is a round-to-nearest intrinsic, which nvcc
// never contracts into a fused multiply-add, and every / a true division, as
// the loop's operations are on the host. exp, log and pow are the CUDA math
// library's, which PyTorch's element-wise kernels call too. Against the loop
// on the card two things differ, each by a last ulp: the order of the
// window's sum (oldest first here, a reduction tree there), and the loop's
// divisions of a tensor by a Python number (calc_diameter's / (4/3 pi) and
// the window's sum / count), which PyTorch on CUDA computes as a multiply by
// the number's reciprocal. Either can flip a decision only where its draw
// lies within an ulp or so of its probability.
//
// The window. The loop keeps the last window_size + lag volumes in a
// rolling buffer and takes the diameters of `count` of them each day. Here a
// thread keeps the diameter of each volume it emits in a ring of shared
// memory (one pow a day, not count), slot j mod L for volume j, slot s of
// thread i at ring[s * blockDim.x + i] (neighbouring threads, neighbouring
// banks), and sums the window oldest first. L = min(lag + window + 1, T) + 1
// holds every volume a window reads: a window never reaches back more than
// lag + window volumes, nor before volume 0.
//
// What bounds it on an H100. Neither bytes (at B = 1,000, float32, ~1 MB
// read and ~2 MB written: under 1 us at 3.35 TB/s) nor arithmetic: a cohort
// is 100-1,000 patients, 4-32 warps, each thread a chain of ~60 dependent
// days of ~5 transcendentals, and each day's nine stores land in nine rows'
// scattered sectors, one a thread. With two warps a block (16 SMs for 1,000
// patients) a factual launch took 107 us against ~90 ms for the loop's
// ~4,600 launches; one warp a block spreads the stores over twice the SMs.
// Staging a few days in shared memory would make them coalesced; a column
// task spends well under 1 % of its time here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;   // one warp a block (see the header)
constexpr int kParams = 10;
constexpr int kDraws = 4;
constexpr int kFactualOut = 9;
constexpr int kCfOut = 5;

// sim/tumor.py::PARAM_KEYS
enum Param {
  kInitialVolume,
  kAlpha,
  kRho,
  kBeta,
  kBetaC,
  kK,
  kChemoIntercept,
  kRadioIntercept,
  kChemoBeta,
  kRadioBeta
};
enum Draw { kNoise, kRecovery, kChemoRv, kRadioRv };

// sim/tumor.py's constants, in float64 as Python holds them
constexpr double kPi = 3.14159265358979323846;
constexpr double kCellDensity = 5.8e8;
constexpr double kChemoAmount = 5.0;
constexpr double kRadioAmount = 2.0;
constexpr double kDrugDecay = 0.5;   // exp(-log(2) / 1): a 1-day half-life
constexpr double kSphere = 4.0 / 3.0 * kPi;
constexpr double kThird = 1.0 / 3.0;
constexpr double kVolumeFloor = 1e-30;
// TUMOUR_DEATH_THRESHOLD = calc_volume(13): kSphere * 6.5^3 (exact cube)
constexpr double kDeathVolume = kSphere * (6.5 * 6.5 * 6.5);

// Round-to-nearest arithmetic that nvcc does not contract, and the math
// library's exp, log and pow, for either type.
#define INSITE_TUMOR_OPS(Real, ADD, SUB, MUL, DIV, EXP, LOG, POW)            \
  __device__ __forceinline__ Real add(Real a, Real b) { return ADD(a, b); } \
  __device__ __forceinline__ Real sub(Real a, Real b) { return SUB(a, b); } \
  __device__ __forceinline__ Real mul(Real a, Real b) { return MUL(a, b); } \
  __device__ __forceinline__ Real dvd(Real a, Real b) { return DIV(a, b); } \
  __device__ __forceinline__ Real exp_(Real a) { return EXP(a); }           \
  __device__ __forceinline__ Real log_(Real a) { return LOG(a); }           \
  __device__ __forceinline__ Real pow_(Real a, Real b) { return POW(a, b); }
INSITE_TUMOR_OPS(float, __fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, expf, logf,
                 powf)
INSITE_TUMOR_OPS(double, __dadd_rn, __dsub_rn, __dmul_rn, __ddiv_rn, exp, log,
                 pow)
#undef INSITE_TUMOR_OPS

template <typename Real>
struct SimArgs {
  const Real* param[kParams];     // [B] each
  const Real* draw[kDraws];       // [B, stride] each
  long long stride[kDraws];
  Real* out[kFactualOut];         // factual: 9 of [B, T]; cf: 5 (see below)
  long long* lengths;             // factual: [B]
  bool* active;                   // cf: [B, T - 1]
  int B, T, window, lag, slots;
};

// One patient's parameters, and the loop's formulas in its order of
// operations.
template <typename Real>
struct Patient {
  Real alpha, rho, beta, beta_c, K, ci, ri, cb, rb;

  __device__ Patient(const SimArgs<Real>& a, int b)
      : alpha(a.param[kAlpha][b]), rho(a.param[kRho][b]),
        beta(a.param[kBeta][b]), beta_c(a.param[kBetaC][b]),
        K(a.param[kK][b]), ci(a.param[kChemoIntercept][b]),
        ri(a.param[kRadioIntercept][b]), cb(a.param[kChemoBeta][b]),
        rb(a.param[kRadioBeta][b]) {}

  // _volume_update(v, chemo, radio, ..., eps) with guard 0
  __device__ Real update(Real v, Real chemo, Real radio, Real eps) const {
    const Real floor_ = Real(kVolumeFloor);
    const Real v_safe = v < floor_ ? floor_ : v;    // NaN stays NaN
    const Real growth = mul(rho, log_(dvd(K, v_safe)));
    const Real dose = add(mul(alpha, radio), mul(mul(beta, radio), radio));
    const Real rate = add(sub(sub(add(Real(1), growth), mul(beta_c, chemo)),
                              dose),
                          eps);
    return mul(v, rate);
  }
};

// _assign's probability: 1 / (1 + exp(-beta (metric - intercept)))
template <typename Real>
__device__ __forceinline__ Real sigmoid(Real metric, Real beta, Real icept) {
  return dvd(Real(1), add(Real(1), exp_(mul(-beta, sub(metric, icept)))));
}

template <typename Real>
__device__ __forceinline__ Real diameter(Real v) {
  return mul(pow_(dvd(v, Real(kSphere)), Real(kThird)), Real(2));
}

// The ring of a thread's diameters (see the header).
template <typename Real>
struct Ring {
  Real* base;
  int slots;

  __device__ Ring(Real* smem, int slots_)
      : base(smem + threadIdx.x), slots(slots_) {}
  __device__ void put(int j, Real d) { base[(j % slots) * blockDim.x] = d; }
  // the mean diameter of volumes first .. first + count - 1; 0 when empty
  __device__ Real mean(int first, int count) const {
    if (count <= 0) return Real(0);
    Real sum = Real(0);
    for (int k = 0; k < count; ++k) {
      sum = add(sum, base[((first + k) % slots) * blockDim.x]);
    }
    return dvd(sum, Real(count));
  }
};

template <typename Real>
__device__ __forceinline__ Real* smem_ring() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<Real*>(smem_raw);
}

// factual_core: day t = 1 .. T - 2 from V[0] = v0, the window the volumes
// [max(t - window - lag, 0), t - lag). Outputs, each [B, T]: cancer_volume
// (column 0 = v0), chemo_dosage, radio_dosage, chemo_application,
// radio_application, chemo_probabilities, radio_probabilities, death_flags,
// recovery_flags (columns 0 and T - 1 zero but the first volume); and
// lengths [B]: stop day + 1, or T - 1.
template <typename Real>
__global__ void tumor_factual_kernel(
    const __grid_constant__ SimArgs<Real> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long T = a.T;
  const Patient<Real> p(a, b);
  Real* out[kFactualOut];
  for (int k = 0; k < kFactualOut; ++k) out[k] = a.out[k] + b * T;
  const Real* noise = a.draw[kNoise] + b * a.stride[kNoise];
  const Real* recovery = a.draw[kRecovery] + b * a.stride[kRecovery];
  const Real* chemo_rv = a.draw[kChemoRv] + b * a.stride[kChemoRv];
  const Real* radio_rv = a.draw[kRadioRv] + b * a.stride[kRadioRv];
  const Real thr = Real(kDeathVolume);

  const Real v0 = a.param[kInitialVolume][b];
  for (int k = 0; k < kFactualOut; ++k) {
    out[k][0] = k == 0 ? v0 : Real(0);
    out[k][T - 1] = Real(0);
  }
  Ring<Real> ring(smem_ring<Real>(), a.slots);
  ring.put(0, diameter(v0));
  Real v_prev = v0, chemo_prev = Real(0), radio_prev = Real(0);
  long long length = T - 1;
  bool alive = true;
  for (int t = 1; t < T - 1; ++t) {
    if (!alive) {
      for (int k = 0; k < kFactualOut; ++k) out[k][t] = Real(0);
      continue;
    }
    Real v = p.update(v_prev, chemo_prev, radio_prev, noise[t]);
    const int count = t >= a.lag ? min(t - a.lag, a.window) : 0;
    const Real metric = ring.mean(t - a.lag - count, count);
    const Real chemo_p = sigmoid(metric, p.cb, p.ci);
    const Real radio_p = sigmoid(metric, p.rb, p.ri);
    const bool chemo_app = chemo_rv[t] < chemo_p;
    const bool radio_app = radio_rv[t] < radio_p;
    const Real radio_dose = radio_app ? Real(kRadioAmount) : Real(0);
    const Real chemo_dose =
        add(mul(chemo_prev, Real(kDrugDecay)),
            chemo_app ? Real(kChemoAmount) : Real(0));
    const bool died = v > thr;
    if (died) v = thr;
    const bool recovered =
        !died && recovery[t] < exp_(mul(-v, Real(kCellDensity)));
    if (recovered) v = Real(0);

    out[0][t] = v;
    out[1][t] = chemo_dose;
    out[2][t] = radio_dose;
    out[3][t] = chemo_app ? Real(1) : Real(0);
    out[4][t] = radio_app ? Real(1) : Real(0);
    out[5][t] = chemo_p;
    out[6][t] = radio_p;
    out[7][t] = died ? Real(1) : Real(0);
    out[8][t] = recovered ? Real(1) : Real(0);
    if (died || recovered) {
      alive = false;
      length = t + 1;
    }
    v_prev = v;
    chemo_prev = chemo_dose;
    radio_prev = radio_dose;
    ring.put(t, diameter(v));
  }
  a.lengths[b] = length;
}

// cf_factual_core: day t = 0 .. T - 2 from V[0] = v0, the window the
// volumes [max(t - window - lag, 0), t - lag + 1), then V[t + 1] from the
// day's doses and noise[t + 1], clipped to [0, threshold]. Outputs: volumes
// [B, T] (column 0 = v0), and chemo_dosage, radio_dosage,
// chemo_application, radio_application [B, T - 1], active [B, T - 1] (the
// days processed: a stop ends the patient after the day's outputs).
template <typename Real>
__global__ void tumor_cf_factual_kernel(
    const __grid_constant__ SimArgs<Real> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long T = a.T;
  const Patient<Real> p(a, b);
  Real* volumes = a.out[0] + b * T;
  Real* out[kCfOut - 1];
  for (int k = 0; k < kCfOut - 1; ++k) out[k] = a.out[k + 1] + b * (T - 1);
  bool* active = a.active + b * (T - 1);
  const Real* noise = a.draw[kNoise] + b * a.stride[kNoise];
  const Real* recovery = a.draw[kRecovery] + b * a.stride[kRecovery];
  const Real* chemo_rv = a.draw[kChemoRv] + b * a.stride[kChemoRv];
  const Real* radio_rv = a.draw[kRadioRv] + b * a.stride[kRadioRv];
  const Real thr = Real(kDeathVolume);

  Real v = a.param[kInitialVolume][b];
  volumes[0] = v;
  Ring<Real> ring(smem_ring<Real>(), a.slots);
  Real chemo_prev = Real(0);
  bool live = true;
  for (int t = 0; t < T - 1; ++t) {
    if (!live) {
      volumes[t + 1] = Real(0);
      for (int k = 0; k < kCfOut - 1; ++k) out[k][t] = Real(0);
      active[t] = false;
      continue;
    }
    ring.put(t, diameter(v));
    const int count = t >= a.lag ? min(t - a.lag + 1, a.window + 1) : 0;
    const Real metric = ring.mean(t - a.lag - count + 1, count);
    const bool chemo_app = chemo_rv[t] < sigmoid(metric, p.cb, p.ci);
    const bool radio_app = radio_rv[t] < sigmoid(metric, p.rb, p.ri);
    const Real radio_dose = radio_app ? Real(kRadioAmount) : Real(0);
    const Real chemo_dose =
        add(mul(chemo_prev, Real(kDrugDecay)),
            chemo_app ? Real(kChemoAmount) : Real(0));
    Real v_next = p.update(v, chemo_dose, radio_dose, noise[t + 1]);
    // torch.clamp(v_next, 0, thr), NaN kept
    v_next = v_next < Real(0) ? Real(0) : (v_next > thr ? thr : v_next);
    const bool stop =
        (v_next >= thr) |
        (recovery[t] <= exp_(mul(-v_next, Real(kCellDensity))));

    volumes[t + 1] = v_next;
    out[0][t] = chemo_dose;
    out[1][t] = radio_dose;
    out[2][t] = chemo_app ? Real(1) : Real(0);
    out[3][t] = radio_app ? Real(1) : Real(0);
    active[t] = true;
    v = v_next;
    chemo_prev = chemo_dose;
    if (stop) live = false;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename Real>
int launch(bool factual, const void* const* params, const void* const* draws,
           const long long* strides, void* const* out, void* extra, int B,
           int T, int window, int lag, void* stream) {
  if (B < 0 || T < (factual ? 3 : 2) || window < 0 || lag < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  SimArgs<Real> a{};
  for (int k = 0; k < kParams; ++k) {
    a.param[k] = static_cast<const Real*>(params[k]);
  }
  for (int k = 0; k < kDraws; ++k) {
    a.draw[k] = static_cast<const Real*>(draws[k]);
    a.stride[k] = strides[k];
  }
  for (int k = 0; k < (factual ? kFactualOut : kCfOut); ++k) {
    a.out[k] = static_cast<Real*>(out[k]);
  }
  a.lengths = factual ? static_cast<long long*>(extra) : nullptr;
  a.active = factual ? nullptr : static_cast<bool*>(extra);
  a.B = B;
  a.T = T;
  a.window = window;
  a.lag = lag;
  a.slots = static_cast<int>(
      (static_cast<long long>(lag) + window + 1 < T
           ? static_cast<long long>(lag) + window + 1
           : T) +
      1);
  const size_t smem = size_t(kThreads) * a.slots * sizeof(Real);
  const int blocks = (B + kThreads - 1) / kThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (factual) {
    err = allow_smem(tumor_factual_kernel<Real>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tumor_factual_kernel<Real><<<blocks, kThreads, smem, st>>>(a);
  } else {
    err = allow_smem(tumor_cf_factual_kernel<Real>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tumor_cf_factual_kernel<Real><<<blocks, kThreads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// its launch (cudaErrorInvalidValue for shapes the loops do not take, which
// the wrapper rejects before it gets here). Host arrays of device pointers:
// params, the ten [B] parameter arrays in PARAM_KEYS order; draws, noise,
// recovery, chemo_rv and radio_rv, [B, strides[k]] each, at least T wide
// for noise and T - 1 for the others; out, the core's outputs in the order
// of the kernels' comments; extra, lengths [B] int64 (factual) or active
// [B, T - 1] bool (cf). Every array is contiguous on the card.
extern "C" {

int insite_tumor_factual_f32(const void* const* params,
                             const void* const* draws,
                             const long long* strides, void* const* out,
                             void* lengths, int B, int T, int window, int lag,
                             void* stream) {
  return launch<float>(true, params, draws, strides, out, lengths, B, T,
                       window, lag, stream);
}

int insite_tumor_factual_f64(const void* const* params,
                             const void* const* draws,
                             const long long* strides, void* const* out,
                             void* lengths, int B, int T, int window, int lag,
                             void* stream) {
  return launch<double>(true, params, draws, strides, out, lengths, B, T,
                        window, lag, stream);
}

int insite_tumor_cf_factual_f32(const void* const* params,
                                const void* const* draws,
                                const long long* strides, void* const* out,
                                void* active, int B, int T, int window,
                                int lag, void* stream) {
  return launch<float>(false, params, draws, strides, out, active, B, T,
                       window, lag, stream);
}

int insite_tumor_cf_factual_f64(const void* const* params,
                                const void* const* draws,
                                const long long* strides, void* const* out,
                                void* active, int B, int T, int window,
                                int lag, void* stream) {
  return launch<double>(false, params, draws, strides, out, active, B, T,
                        window, lag, stream);
}

}  // extern "C"
