// K6: the LM polish's damped solve x = A^-1 b for a batch of small SPD
// systems (m <= 64), float32 or float64, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's LM step is
// graphik_tpu/solvers/local.py `step = -spd_solve_unrolled(H, g)`
// (graphik_tpu/ops/linalg.py spd_solve_unrolled: chol_unrolled, then
// chol_solve_unrolled), which it runs on every backend. Its Cholesky clamps
// each pivot's square to 1e-30, so a float32 system that is not numerically
// positive definite still gives a step (huge, or NaN) that the LM's
// improvement test then takes or refuses; a library Cholesky reports such a
// system as failed instead. graphik_tpu_torch/ops/linalg.py holds the plain
// torch version (spd_solve_reference) that this kernel is checked against
// bit for bit.
//
// The arithmetic, for one system (only A's lower triangle is read):
// * column j of L: s_i = sum_{k<j} L_ik L_jk for every row i >= j, summed
//   k = 0, 1, ... one product and one add at a time; the pivot
//   L_jj = sqrt(max(A_jj - s_j, 1e-30)) (a NaN stays NaN); then
//   L_ij = (A_ij - s_i) / L_jj;
// * forward: y_i = (b_i - sum_{k<i} L_ik y_k) / L_ii, summed k = 0, 1, ...;
// * backward: x_i = (y_i - sum_{k>i} L_ki x_k) / L_ii, summed k = m - 1,
//   m - 2, ....
// Arithmetic is + - * / sqrt only, correctly rounded (the build passes
// -fmad=false and uses no fast math).
//
// Design: one warp a system, its lower triangle packed in shared memory
// (row i at i (i + 1) / 2) beside one vector of m for y and x; lane l holds
// rows l and, past m = 32, l + 32 (one instance per type for m <= 32, one
// for m <= 64). In column j each lane sums its own rows' dots from shared
// memory (row j's entries are a broadcast), the pivot row's lane writes the
// pivot, and after a __syncwarp the others divide; each substitution step
// broadcasts one solved entry and every lane adds its rows' products. A
// block holds up to 4 warps, fewer where their triangles would pass 48 KB
// (float64 past m = 53). Each system runs on its own warp, so its result does
// not depend on the batch it came in.
//
// What bounds it: its bytes are A's lower triangle (m (m + 1) / 2) and b
// (m) read and x (m) written a system; its flops about m^3 / 3 + 2 m^2 a
// system, under the bytes at every path's m. The first design is simple,
// not fast: the column loop's dot products are chains of dependent adds
// (m^2 / 2 a lane in all), so the latency of those chains and of the 3 m
// __syncwarp steps sets its time
// more than either bound (PERF.md section 6).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 4;          // warps a block
constexpr int kSmemBudget = 48 * 1024;  // static-launch shared memory a block

__device__ __forceinline__ float pivot_sqrt(float x) {
  return sqrtf(x < 1e-30f ? 1e-30f : x);  // NaN < 1e-30 is false: NaN stays
}

__device__ __forceinline__ double pivot_sqrt(double x) {
  return sqrt(x < 1e-30 ? 1e-30 : x);
}

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// a[r] by selects, so that the per-lane arrays stay in registers
template <typename T, int ROWS>
__device__ __forceinline__ T row_of(const T (&a)[ROWS], int r) {
  T out = a[0];
#pragma unroll
  for (int q = 1; q < ROWS; ++q)
    if (r == q) out = a[q];
  return out;
}

// ROWS rows a lane: row lane + 32 r for r < ROWS
template <typename T, int ROWS>
__global__ void __launch_bounds__(kMaxWarps * 32)
spd_solve_kernel(const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x, int B,
                 int m, int warps) {
  extern __shared__ unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sys = blockIdx.x * warps + w;
  if (w >= warps || sys >= B) return;  // whole warps: every __syncwarp below is full
  const int nt = tri(m);
  T* L = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(w) * (nt + m);
  T* v = L + nt;
  const T* As = A + static_cast<size_t>(sys) * m * m;
  const T* bs = b + static_cast<size_t>(sys) * m;

  // the lower triangle, a row at a time
  for (int i = 0; i < m; ++i)
    for (int c = lane; c <= i; c += 32) L[tri(i) + c] = As[static_cast<size_t>(i) * m + c];
  T bi[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = lane + 32 * r;
    bi[r] = i < m ? bs[i] : T(0);
  }
  __syncwarp();

  // the factor, column by column
  for (int j = 0; j < m; ++j) {
    const T* Lj = L + tri(j);
    T s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = lane + 32 * r;
      s[r] = T(0);
      if (i >= j && i < m) {
        const T* Li = L + tri(i);
        T acc = T(0);
        for (int k = 0; k < j; ++k) acc = acc + Li[k] * Lj[k];
        s[r] = Li[j] - acc;
      }
    }
    if ((j & 31) == lane) L[tri(j) + j] = pivot_sqrt(row_of(s, j >> 5));
    __syncwarp();
    const T d = L[tri(j) + j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = lane + 32 * r;
      if (i > j && i < m) L[tri(i) + j] = s[r] / d;
    }
    __syncwarp();
  }

  // forward substitution: y_i once its sum is complete, then every later
  // row adds its product with y_i
  T acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = T(0);
  for (int i = 0; i < m; ++i) {
    if ((i & 31) == lane) v[i] = (row_of(bi, i >> 5) - row_of(acc, i >> 5)) / L[tri(i) + i];
    __syncwarp();
    const T yi = v[i];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = lane + 32 * r;
      if (k > i && k < m) acc[r] = acc[r] + L[tri(k) + i] * yi;
    }
  }
  // backward substitution, from the last row: row i's sum adds L_ki x_k
  // for k = m - 1, m - 2, ...
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = T(0);
  for (int i = m - 1; i >= 0; --i) {
    if ((i & 31) == lane) v[i] = (v[i] - row_of(acc, i >> 5)) / L[tri(i) + i];
    __syncwarp();
    const T xi = v[i];
    const T* Li = L + tri(i);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = lane + 32 * r;
      if (k < i) acc[r] = acc[r] + Li[k] * xi;
    }
  }
  T* xs = x + static_cast<size_t>(sys) * m;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = lane + 32 * r;
    if (i < m) xs[i] = v[i];
  }
}

template <typename T, int ROWS>
cudaError_t launch(const void* A, const void* b, void* x, int B, int m, cudaStream_t stream) {
  const int per_warp = (tri(m) + m) * static_cast<int>(sizeof(T));
  int warps = kSmemBudget / per_warp;
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const int blocks = (B + warps - 1) / warps;
  spd_solve_kernel<T, ROWS><<<blocks, warps * 32, warps * per_warp, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), B, m, warps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_m(const void* A, const void* b, void* x, int B, int m, cudaStream_t st) {
  return m <= 32 ? launch<T, 1>(A, b, x, B, m, st) : launch<T, 2>(A, b, x, B, m, st);
}

}  // namespace

// A (B, m, m) (its lower triangle read), b (B, m) -> x (B, m) with A x = b by
// the clamped-pivot Cholesky; float64 when is_double, else float32;
// 1 <= m <= 64. Launches on `stream` of the current device; returns the
// launch's cudaError_t.
extern "C" int graphik_spd_solve(const void* A, const void* b, void* x, int B, int m,
                                 int is_double, void* stream) {
  if (B <= 0) return 0;
  if (m < 1 || m > 64) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_double ? launch_m<double>(A, b, x, B, m, st)
                                    : launch_m<float>(A, b, x, B, m, st);
  return static_cast<int>(err);
}
