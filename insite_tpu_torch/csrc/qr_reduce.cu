// Tall-skinny QR (TSQR) of weighted least-squares problems, K arms at once,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package reduces the design with XLA's QR
// (insite_tpu/discovery/stlsq.py::_qr_reduce), and the port called
// cuSOLVER's QR (`torch.linalg.qr`) until these kernels took its place on
// CUDA tensors.
//
// The function. For rows r of the design with columns [theta[r, :F], y[r]]
// (C = F + 1 columns), arm a(r) and weight w(r) (the validity mask times a
// sample weight), and each arm k < K: the upper triangle T_k [C, C] with
// T_k^T T_k = sum_{r: a(r) = k, w(r) > 0} w(r) x_r x_r^T, that is
// [R_k | Q_k^T y_k] of the QR of the rows of arm k scaled by sqrt(w), with a
// non-negative diagonal. A row whose arm lies outside [0, K), or whose weight
// is not positive, is in no arm. The arithmetic is float64 whatever the
// input type; T is written in the input's type.
//
// What bounds it on an H100. The reduction must read the design once: at the
// north star (600,000 rows, F = 7, float32, two arms) ~22 MB, ~7 us at
// 3.35 TB/s, against ~0.1 GFLOP of float64 arithmetic (~3 us). cuSOLVER's
// unblocked Householder QR (geqr2) made one dependent pass over a weighted
// copy of the whole design per column and per arm: ~4 ms an arm there. The
// design here:
//
// 1. No weighted copy. The kernels read theta, y, the weight, the mask and
//    the arm index where they lie and apply the weight in registers.
// 2. Square-root-free Givens rotations (Gentleman 1973; Miller's AS 274),
//    one thread a triangle. A thread keeps its triangle as d [C] and a unit
//    upper triangle rbar, with T = diag(sqrt(d)) rbar, and includes a row x of
//    weight w column by column: d_i' = d_i + w x_i^2, then
//    rbar_ik' = (d_i rbar_ik + w x_i x_k) / d_i', x_k -= x_i rbar_ik and
//    w' = w d_i / d_i'. That is one reciprocal and three multiply-adds an
//    entry, no square root and no reduction across threads, and it is a QR:
//    the condition number is not squared, as a Gram matrix would square it.
//    A zero column (exact dependence, an arm with no rows, fewer rows than C)
//    leaves d_i = 0 and its row of rbar 0: a zero diagonal and no NaN.
//    Householder on a shared tile was the alternative; it needs a reduction
//    across the tile per column and per pair of columns, each a barrier,
//    where a Givens row needs none.
// 3. Every arm from one pass. A block of K * P threads takes a contiguous
//    range of rows; its P threads of arm k stride over the range and include
//    the rows of arm k, so each row is read from device memory once and
//    included by one thread (with the register state below, the block first
//    stages a tile of 256 rows in shared memory, each element loaded by one
//    thread, neighbours on neighbouring addresses, and its threads include
//    from there). The P triangles of an arm are then merged in a
//    fixed binary tree (a triangle's row j enters another as the row
//    (0, .., 1, rbar_j) of weight d_j), and the block writes one triangle an
//    arm to scratch (tsqr_rows_kernel).
// 4. The stacked triangles. One block an arm merges the blocks' triangles
//    in a fixed order, P2 threads each taking every P2-th, then a binary
//    tree, and writes T_k (tsqr_merge_kernel). The order of every operation
//    is fixed by the shapes, so the result is the same bits run after run:
//    no atomics.
// 5. Registers and straight-line code where they fit. Each include is a
//    chain of dependent float64 steps, and the trees make a merge's chain
//    (C (C + 1) / 2 steps) the critical path of a call. With C <= 8 (the
//    EQ_4 library, F = 7, and the tumour family's, F = 4) a thread keeps its
//    triangle and row in registers (RegState<8>: 44 doubles), the columns
//    from C to 8 are zero, and every loop runs to 8, unrolled: no branch
//    (a step that changes nothing is a select, and the reciprocal is the
//    hardware's approximation and two Newton steps, not a division with its
//    slow path), so the scheduler overlaps the steps of a column and of
//    consecutive rows. A merge partner's triangle comes through shared
//    memory. Wider designs (the degree-4 library, F = 35; joint libraries)
//    keep the state in shared memory (SmemState, loops over the run-time
//    width). Both states run the same arithmetic.
//
// Where the time goes (an H100 at 700 W): at the north star a call takes
// ~0.095 ms, against 0.29 ms with the shared-memory state, divisions and
// branches, and ~7.9 ms for cuSOLVER's two QRs: the rows kernel ~0.063 ms,
// ~0.014 of it its tree, and the merge kernel ~0.033 ms (12 merges in a
// chain, ~2.5 us each). Both are chains of dependent float64 steps at
// 8 warps an SM (140 registers a thread), far from the design's 7 us of
// bytes; staging the rows (~5 % at the north star, ~25 % at 59,000 rows)
// helped, prefetching them or overlapping 2-8 rows a thread did not.
//
// A slot's region of shared memory holds its triangle (C (C + 1) / 2
// doubles: d, then rbar row by row; SmemState also the row, C more), element
// e at smem[e * slots + slot], so a warp's threads touch consecutive words.
// P (32 at most) and P2 (128 at most) are the largest powers of two that
// keep a block within kSmemBudget: at the north star (C = 8, K = 2) 18 KB of
// triangles and a 19 KB tile a rows block and 36 KB the merge block, under
// the 48 KB a launch takes without an attribute call.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

// the wrapper's bounds (ops/qr_reduce.py: MAX_FEATURES + 1, MAX_ARMS)
constexpr int MAX_C = 36;
constexpr int MAX_ARMS = 8;
constexpr int kRegC = 8;            // widest design kept in registers
constexpr int kRowSlots = 32;       // P, threads an arm in a rows block
constexpr int kMergeSlots = 128;    // P2, threads of a merge block
constexpr size_t kSmemBudget = 96 * 1024;
constexpr long long kMinRowsPerBlock = 512;
constexpr int kTileRows = 256;      // rows a register-state block stages
constexpr double kMinNormal = 2.2250738585072014e-308;   // DBL_MIN

// How the arm of a row is given: none (every row in arm 0), int64, or a
// float of the design's own type (an arm k is the value k exactly).
enum ArmKind { kArmNone = 0, kArmInt64 = 1, kArmReal = 2 };

__host__ __device__ constexpr int tri_elems(int C) { return C * (C + 1) / 2; }
// rbar[i][k], 0 <= i < k < C, in the strictly upper part row by row
__host__ __device__ constexpr int rbar_index(int C, int i, int k) {
  return i * (2 * C - i - 1) / 2 + (k - i - 1);
}

// A triangle in a slot's region, read only: a merge's source.
struct View {
  const double* base;
  int stride;
  int C;
  __device__ double d(int i) const { return base[i * stride]; }
  __device__ double r(int i, int k) const {
    return base[(C + rbar_index(C, i, k)) * stride];
  }
};

// A thread's triangle and row in its slot's region of shared memory.
struct SmemState {
  double* base;
  int stride;
  int C;
  __device__ double& D(int i) { return base[i * stride]; }
  __device__ double& R(int i, int k) {
    return base[(C + rbar_index(C, i, k)) * stride];
  }
  __device__ double& X(int k) { return base[(tri_elems(C) + k) * stride]; }
  __device__ void zero() {
    for (int e = 0; e < tri_elems(C); ++e) base[e * stride] = 0.0;
  }
  __device__ void publish() {}        // it lives in its region
};

// A thread's triangle and row in registers (C <= CB); publish() writes the
// triangle to the slot's region in View's layout.
template <int CB>
struct RegState {
  double d[CB];
  double rb[tri_elems(CB) - CB];
  double x[CB];
  double* base;
  int stride;
  int C;
  __device__ RegState(double* b, int s, int c) : base(b), stride(s), C(c) {}
  __device__ double& D(int i) { return d[i]; }
  __device__ double& R(int i, int k) { return rb[rbar_index(CB, i, k)]; }
  __device__ double& X(int k) { return x[k]; }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < CB; ++i) d[i] = 0.0;
#pragma unroll
    for (int e = 0; e < tri_elems(CB) - CB; ++e) rb[e] = 0.0;
  }
  __device__ void publish() {
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      if (i >= C) break;
      base[i * stride] = d[i];
#pragma unroll
      for (int k = i + 1; k < CB; ++k) {
        if (k >= C) break;
        base[(C + rbar_index(C, i, k)) * stride] = rb[rbar_index(CB, i, k)];
      }
    }
  }
};

template <int CB>
struct StateOf {
  using type = RegState<CB>;
};
template <>
struct StateOf<0> {
  using type = SmemState;
};

// Loops over columns run to CB, a constant, for the register state, so
// that they unroll into straight-line code on registers (the columns from
// C to CB are zero, and every step on them changes nothing), and to the
// run-time width for the shared-memory one (CB = 0).
template <int CB>
__device__ __forceinline__ constexpr int cols(int C) {
  return CB > 0 ? CB : C;
}

// 1 / v for normal v: the hardware's approximation refined by two Newton
// steps, with none of a division's branches, so that a merge's chain of
// includes stays one block of straight-line code for the scheduler.
__device__ __forceinline__ double recip(double v) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(v));
  double e = fma(-v, r, 1.0);
  r = fma(r, e, r);
  e = fma(-v, r, 1.0);
  return fma(r, e, r);
}

// Include the row t.X (0 before column i0) of weight w >= 0 in t's
// triangle. Without branches: a step whose w x_i is 0 (a zero entry, a row
// of weight 0), or whose w x_i^2 is too small to add to d_i = 0, leaves the
// triangle and the row as they are (cbar = 1, sbar = 0).
template <int CB, class State>
__device__ __forceinline__ void include_row(State& t, double w, int i0,
                                            int C) {
#pragma unroll
  for (int i = 0; i < cols<CB>(C); ++i) {
    if (i < i0) continue;
    const double xi = t.X(i);
    const double di = t.D(i);
    const double wxi = w * xi;
    const double dpi = fma(wxi, xi, di);
    const bool use = wxi != 0.0 && !(dpi < kMinNormal);
    const double inv = recip(dpi);
    const double cbar = use ? di * inv : 1.0;
    const double sbar = use ? wxi * inv : 0.0;
    w *= cbar;
    t.D(i) = use ? dpi : di;
#pragma unroll
    for (int k = i + 1; k < cols<CB>(C); ++k) {
      const double xk = t.X(k);
      const double r = t.R(i, k);
      t.X(k) = fma(-xi, r, xk);
      t.R(i, k) = fma(cbar, r, sbar * xk);
    }
  }
}

// Merge triangle src into dst (row j of src enters as (0, .., 1, rbar_j) of
// weight d_j; d_j = 0 means that row of rbar was never set, and its include
// changes nothing).
template <int CB, class State>
__device__ __forceinline__ void merge_into(State& dst, const View& src,
                                           int C) {
#pragma unroll
  for (int j = 0; j < cols<CB>(C); ++j) {
    const double dj = j < C ? src.d(j) : 0.0;
    dst.X(j) = 1.0;
#pragma unroll
    for (int k = j + 1; k < cols<CB>(C); ++k) {
      dst.X(k) = k < C ? src.r(j, k) : 0.0;
    }
    include_row<CB>(dst, dj, j, C);
  }
}

// The P slots of each group (slots g * P .. g * P + P - 1) merged into the
// group's first, in a fixed binary tree, whose triangle is then in its
// region. Every thread of the block calls it.
template <int CB, class State>
__device__ void merge_slots(State& st, double* smem, int C, int P) {
  const int S = blockDim.x, t = threadIdx.x, s = t % P;
  for (int h = P >> 1; h > 0; h >>= 1) {
    if (s >= h && s < 2 * h) st.publish();
    __syncthreads();
    if (s < h) merge_into<CB>(st, View{smem + t + h, S, C}, C);
  }
  if (s == 0) st.publish();
  __syncthreads();
}

template <typename Real>
struct RowArgs {
  const Real* theta;       // [N, F]
  const Real* y;           // [N]
  const Real* w;           // [N] or null: every row weighs 1
  const bool* ok;          // [N] or null: every row is valid
  const void* arm;         // [N] of arm_kind, or null
  int arm_kind;
  long long N;
  long long rows_per_block;
  int F, K, P;
  double* partial;         // [blocks, K, tri_elems(C)]
};

template <typename Real>
__device__ int row_arm(const RowArgs<Real>& a, long long r) {
  if (a.arm_kind == kArmInt64) {
    const long long v = static_cast<const long long*>(a.arm)[r];
    return (v >= 0 && v < a.K) ? int(v) : -1;
  }
  if (a.arm_kind == kArmReal) {
    const double v = double(static_cast<const Real*>(a.arm)[r]);
    return (v >= 0.0 && v < double(a.K) && v == floor(v)) ? int(v) : -1;
  }
  return 0;
}

// Row r's weight in arm k's triangle: 0 for a row of another arm or one
// left out, which changes nothing when included.
template <typename Real>
__device__ double row_weight(const RowArgs<Real>& a, long long r, int k) {
  const double w = a.w != nullptr ? double(a.w[r]) : 1.0;
  const bool in = row_arm(a, r) == k && (a.ok == nullptr || a.ok[r]);
  return in && w > 0.0 ? w : 0.0;
}

// Stage 1: each block reduces its range of rows to one triangle an arm.
template <typename Real, int CB>
__global__ void __launch_bounds__(256)
    tsqr_rows_kernel(const RowArgs<Real> a) {
  extern __shared__ double smem[];
  const int C = a.F + 1, P = a.P, S = blockDim.x;
  const int t = threadIdx.x, k = t / P, s = t % P;
  typename StateOf<CB>::type st{smem + t, S, C};
  st.zero();
  const long long r0 = blockIdx.x * a.rows_per_block;
  const long long r1 =
      r0 + a.rows_per_block < a.N ? r0 + a.rows_per_block : a.N;
  if constexpr (CB > 0) {
    // The block stages a tile of its rows in shared memory, each element
    // loaded once by one of its threads, neighbours on neighbouring
    // addresses; then each thread includes its arm's rows of the tile from
    // there: one wait on device memory a tile, not one a row.
    constexpr int TR = kTileRows, LD = kTileRows + 1;
    double* tx = smem + S * tri_elems(C);      // [C][LD]: column c, row
    double* tw = tx + C * LD;                  // [TR] weights, 0: left out
    int* tarm = reinterpret_cast<int*>(tw + TR);
    for (long long base = r0; base < r1; base += TR) {
      const int n = int(r1 - base < TR ? r1 - base : TR);
      __syncthreads();                         // the last tile is used up
      const Real* src = a.theta + base * a.F;
      for (int e = t; e < n * a.F; e += S) {
        const int row = e / a.F;
        tx[(e - row * a.F) * LD + row] = double(src[e]);
      }
      for (int row = t; row < n; row += S) {
        const long long r = base + row;
        const double w = a.w != nullptr ? double(a.w[r]) : 1.0;
        tx[a.F * LD + row] = double(a.y[r]);
        tw[row] = (a.ok == nullptr || a.ok[r]) && w > 0.0 ? w : 0.0;
        tarm[row] = row_arm(a, r);
      }
      __syncthreads();
      for (int row = s; row < n; row += P) {
        if (tarm[row] != k || tw[row] == 0.0) continue;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          st.X(c) = c <= a.F ? tx[c * LD + row] : 0.0;
        }
        include_row<CB>(st, tw[row], 0, C);
      }
    }
  } else {
    for (long long r = r0 + s; r < r1; r += P) {
      const Real* row = a.theta + r * a.F;
      for (int c = 0; c < C; ++c) {
        st.X(c) = c < a.F ? double(row[c]) : double(a.y[r]);
      }
      include_row<CB>(st, row_weight(a, r, k), 0, C);
    }
  }
  merge_slots<CB>(st, smem, C, P);
  // the arm's first slot, written by the arm's P threads
  const int E = tri_elems(C);
  double* out = a.partial + (size_t(blockIdx.x) * a.K + k) * E;
  for (int e = s; e < E; e += P) out[e] = smem[e * S + k * P];
}

// Stage 2: block k merges the n_parts triangles of arm k and writes T_k.
template <typename Real, int CB>
__global__ void __launch_bounds__(256)
    tsqr_merge_kernel(const double* partial, int n_parts, int K, int C,
                      Real* out) {
  extern __shared__ double smem[];
  const int k = blockIdx.x, S = blockDim.x, t = threadIdx.x;
  const int E = tri_elems(C);
  typename StateOf<CB>::type st{smem + t, S, C};
  st.zero();
  for (int b = t; b < n_parts; b += S) {
    merge_into<CB>(st, View{partial + (size_t(b) * K + k) * E, 1, C}, C);
  }
  merge_slots<CB>(st, smem, C, S);
  const View root{smem, S, C};
  Real* T = out + size_t(k) * C * C;
  for (int e = t; e < C * C; e += S) {
    const int i = e / C, c = e % C;
    double v = 0.0;
    if (c >= i) {
      const double sd = sqrt(root.d(i));
      v = c == i ? sd : sd * root.r(i, c);
    }
    T[e] = Real(v);
  }
}

// The largest power of two n <= cap with n * per bytes within the budget.
int fit_slots(int cap, size_t per) {
  int n = cap;
  while (n > 1 && size_t(n) * per > kSmemBudget) n >>= 1;
  return n;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename Real, int CB>
int launch(const RowArgs<Real>& args, long long N, int C, int K,
           int max_blocks, Real* out, cudaStream_t st) {
  // a slot's region: its triangle, and for the shared-memory state its row
  const size_t slot_bytes =
      size_t(tri_elems(C) + (CB > 0 ? 0 : C)) * sizeof(double);
  RowArgs<Real> a = args;
  a.P = fit_slots(kRowSlots, size_t(K) * slot_bytes);
  const long long want = (N + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  const int blocks =
      int(std::max<long long>(1, std::min<long long>(max_blocks, want)));
  a.rows_per_block = (N + blocks - 1) / blocks;
  // the register state's rows block also stages a tile of rows: their
  // columns, weights and arms
  const size_t tile_bytes =
      CB > 0 ? size_t(kTileRows) * (sizeof(double) + sizeof(int)) +
                   size_t(C) * (kTileRows + 1) * sizeof(double)
             : 0;
  const size_t smem1 = size_t(K) * a.P * slot_bytes + tile_bytes;
  cudaError_t err = allow_smem(tsqr_rows_kernel<Real, CB>, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  tsqr_rows_kernel<Real, CB><<<blocks, K * a.P, smem1, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P2 = fit_slots(kMergeSlots, slot_bytes);
  const size_t smem2 = size_t(P2) * slot_bytes;
  err = allow_smem(tsqr_merge_kernel<Real, CB>, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  tsqr_merge_kernel<Real, CB><<<K, P2, smem2, st>>>(a.partial, blocks, K, C,
                                                    out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int qr_reduce(const void* theta, const void* y, const void* w, const void* ok,
              const void* arm, int arm_kind, long long N, int F, int K,
              void* partial, int max_blocks, void* out, void* stream) {
  const int C = F + 1;
  if (N < 0 || F < 1 || C > MAX_C || K < 1 || K > MAX_ARMS ||
      max_blocks < 1 || arm_kind < kArmNone || arm_kind > kArmReal ||
      (arm_kind != kArmNone && arm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowArgs<Real> a{static_cast<const Real*>(theta),
                        static_cast<const Real*>(y),
                        static_cast<const Real*>(w),
                        static_cast<const bool*>(ok),
                        arm,
                        arm_kind,
                        N,
                        0,
                        F,
                        K,
                        0,
                        static_cast<double*>(partial)};
  const auto st = static_cast<cudaStream_t>(stream);
  Real* T = static_cast<Real*>(out);
  return C <= kRegC ? launch<Real, kRegC>(a, N, C, K, max_blocks, T, st)
                    : launch<Real, 0>(a, N, C, K, max_blocks, T, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns the cudaError_t of
// its launches (cudaErrorInvalidValue for shapes outside the bounds, which
// the wrapper rejects before it gets here). Every array is on the card:
// theta [N, F], y, w [N] of the entry's type; ok [N] bool; arm [N] int64
// (arm_kind 1) or of the entry's type (2); partial, float64 scratch of
// max_blocks * K * (F + 1) * (F + 2) / 2; out [K, F + 1, F + 1].
extern "C" {

int insite_qr_reduce_f32(const void* theta, const void* y, const void* w,
                         const void* ok, const void* arm, int arm_kind,
                         long long N, int F, int K, void* partial,
                         int max_blocks, void* out, void* stream) {
  return qr_reduce<float>(theta, y, w, ok, arm, arm_kind, N, F, K, partial,
                          max_blocks, out, stream);
}

int insite_qr_reduce_f64(const void* theta, const void* y, const void* w,
                         const void* ok, const void* arm, int arm_kind,
                         long long N, int F, int K, void* partial,
                         int max_blocks, void* out, void* stream) {
  return qr_reduce<double>(theta, y, w, ok, arm, arm_kind, N, F, K, partial,
                           max_blocks, out, stream);
}

}  // extern "C"
