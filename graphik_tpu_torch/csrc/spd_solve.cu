// K6: the LM polish's damped solve x = A^-1 b for a batch of small SPD
// systems (m <= 128), float32 or float64, for NVIDIA Hopper (sm_90a).
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
// * column j of L: s_ij = sum_{k<j} L_ik L_jk for every row i >= j, each
//   sum starting from 0 and taking its products k = 0, 1, ... in order, one
//   product and one add at a time; the pivot L_jj = sqrt(max(A_jj - s_jj,
//   1e-30)) (a NaN stays NaN); then L_ij = (A_ij - s_ij) / L_jj;
// * forward: y_i = (b_i - sum_{k<i} L_ik y_k) / L_ii, summed k = 0, 1, ...;
// * backward: x_i = (y_i - sum_{k>i} L_ki x_k) / L_ii, summed k = m - 1,
//   m - 2, ....
// Arithmetic is + - * / sqrt only, correctly rounded (the build passes
// -fmad=false and uses no fast math). Each system is worked by its own
// thread or warp, so its result does not depend on the batch it came in.
//
// What bounds it: its bytes are A's lower triangle (m (m + 1) / 2) and b
// (m) read and x (m) written a system; its flops about m^3 / 3 + 2 m^2 a
// system, under the bytes at every path's m. What sets its time is the
// latency of the sums' dependent adds, which must stay in the order above
// (PERF.md section 6). The design spreads the independent sums:
//
// * m <= 10 (every obstacle-free path's LM, the tree's, CIDGIK's finish): a
//   thread a system. A warp's 32 systems are one contiguous stretch of A,
//   copied into shared memory by coalesced 16-byte loads, a system a row
//   padded to an odd stride (no bank conflicts when each thread reads its
//   own row); the thread keeps its triangle in registers (an instance per
//   bound MAXM of m, loops unrolled over MAXM and cut at m by uniform
//   branches) and factors left-looking, each s_ij a chain of j products;
//   b and x a thread reads and writes itself. A block is one warp, so 8192
//   systems are 256 blocks over the 132 SMs.
// * m > 10 (dh19's 19, planar40's 40, planar100's 100, up to 128): a warp a system, its
//   packed triangle in shared memory, staged by one coalesced pass, and
//   factored left-looking by panels of kPanel columns: first every sum of
//   the panel's columns over the columns before the panel (rows j..m-1 of
//   each, dealt to the 32 lanes), each a lane's chain of products in order,
//   with no write between two products; then the panel's columns in turn,
//   each sum finishing with its products inside the panel, the pivot a
//   shuffle, a row a lane. (Taking every sum of a column in its row's lane
//   would make the column wait for its last row's chain of j products,
//   with the lanes of the rows above it idle.) The substitutions keep a
//   lane's rows (lane l: l, l + 32, ...: ROWS = 1 up to m = 32, 2 up to
//   64, 4 up to 128) in registers and broadcast each solved entry by a
//   shuffle. Shared memory is t(m) + kPanel m values a warp (t(a) = a (a +
//   1) / 2): up to 4 warps a block within 48 KB (34 KB a warp at m = 128
//   in float32); a warp's share past 48 KB (float64 past m = 106: 68 KB at
//   m = 128) takes a block of its own, with the dynamic shared-memory
//   opt-in.

#include <cuda_runtime.h>

// The stages a launch runs, for timing them apart (tools/torch_spd_bench.py
// builds with -DGRAPHIK_SPD_STAGES=1 or 2): 1 loads the triangle, 2 also
// factors it, 3 (the default, the only build the package makes) solves;
// a cut launch writes each system's diagonal to x, so no stage is dead code.
#ifndef GRAPHIK_SPD_STAGES
#define GRAPHIK_SPD_STAGES 3
#endif

namespace {

constexpr int kMaxWarps = 4;            // warps a block of the warp kernel
constexpr int kSmemBudget = 48 * 1024;  // shared memory a block without the opt-in
// columns a panel of the warp kernel (2 and 8 were slower at m = 19-64,
// PERF.md section 6)
constexpr int kPanel = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pivot_sqrt(float x) {
  return sqrtf(x < 1e-30f ? 1e-30f : x);  // NaN < 1e-30 is false: NaN stays
}

__device__ __forceinline__ double pivot_sqrt(double x) {
  return sqrt(x < 1e-30 ? 1e-30 : x);
}

__host__ __device__ __forceinline__ constexpr int tri(int i) { return i * (i + 1) / 2; }

// the odd stride of a row of v values in shared memory: rows read a thread
// each fall in 32 different banks
__host__ __device__ __forceinline__ constexpr int odd(int v) { return v | 1; }

// a[r] by selects, so that the per-lane arrays stay in registers
template <typename T, int ROWS>
__device__ __forceinline__ T row_of(const T (&a)[ROWS], int r) {
  T out = a[0];
#pragma unroll
  for (int q = 1; q < ROWS; ++q)
    if (r == q) out = a[q];
  return out;
}

// 16-byte vectors of T
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float get(const float4& v, int u) {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
  }
};

template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double get(const double2& v, int u) { return u == 0 ? v.x : v.y; }
};

// the shared-memory place of element e of a stretch of rows of len values,
// each row at a stride (the quotient by a float reciprocal: exact for the
// stretches here, e < 2^12 and len <= 100)
__device__ __forceinline__ int row_place(int e, int len, int stride, float inv_len) {
  const int s = static_cast<int>((static_cast<float>(e) + 0.5f) * inv_len);
  return s * stride + e - s * len;
}

// dst[row_place(e)] = src[e] for e < n by the warp's 32 threads, 16 bytes a
// load where src is 16-byte aligned
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int n, int len, int stride,
                                           T* __restrict__ dst, int t) {
  using V = Vec16<T>;
  const float inv = 1.0f / static_cast<float>(len);
  int done = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    const int nv = n / V::n;
    const typename V::type* src_v = reinterpret_cast<const typename V::type*>(src);
#pragma unroll 16
    for (int q = t; q < nv; q += 32) {
      const typename V::type v = src_v[q];
#pragma unroll
      for (int u = 0; u < V::n; ++u) dst[row_place(q * V::n + u, len, stride, inv)] = V::get(v, u);
    }
    done = nv * V::n;
  }
  for (int e = done + t; e < n; e += 32) dst[row_place(e, len, stride, inv)] = src[e];
}

// ---------------------------------------------------------------------------
// m <= MAXM <= 10: a thread a system
// ---------------------------------------------------------------------------

template <typename T, int MAXM>
__global__ void __launch_bounds__(32)
thread_spd_solve_kernel(const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x,
                        int B, int m) {
  __shared__ T sA[32 * odd(MAXM * MAXM)];
  const int t = threadIdx.x;
  const int base = blockIdx.x * 32;
  const int nsys = B - base < 32 ? B - base : 32;
  const int mm = m * m, sa = odd(mm);
  const size_t sys = static_cast<size_t>(base) + t;

  // b, a thread its own system's (loads that overlap A's); then the warp's
  // systems' A, a row of shared memory each (system e / mm holds element e
  // of the stretch), by coalesced loads
  T v[MAXM];
#pragma unroll
  for (int i = 0; i < MAXM; ++i) v[i] = i < m && t < nsys ? b[sys * m + i] : T(0);
  stage_rows(A + static_cast<size_t>(base) * mm, nsys * mm, mm, sa, sA, t);
  __syncwarp();

  T L[tri(MAXM)];
  const T* my = sA + t * sa;
#pragma unroll
  for (int i = 0; i < MAXM; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) L[tri(i) + j] = i < m ? my[i * m + j] : T(0);
  }

#if GRAPHIK_SPD_STAGES >= 2
  // the factor, left-looking: column j's sums each a chain over k < j
#pragma unroll
  for (int j = 0; j < MAXM; ++j) {
    if (j < m) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < j; ++k) acc = acc + L[tri(j) + k] * L[tri(j) + k];
      const T d = pivot_sqrt(L[tri(j) + j] - acc);
      L[tri(j) + j] = d;
#pragma unroll
      for (int i = j + 1; i < MAXM; ++i) {
        if (i < m) {
          T a = T(0);
#pragma unroll
          for (int k = 0; k < j; ++k) a = a + L[tri(i) + k] * L[tri(j) + k];
          L[tri(i) + j] = (L[tri(i) + j] - a) / d;
        }
      }
    }
  }
#endif
#if GRAPHIK_SPD_STAGES >= 3
  // forward: y_i = (b_i - sum_{k<i} L_ik y_k) / L_ii, in place in v
#pragma unroll
  for (int i = 0; i < MAXM; ++i) {
    if (i < m) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc + L[tri(i) + k] * v[k];
      v[i] = (v[i] - acc) / L[tri(i) + i];
    }
  }
  // backward: x_i = (y_i - sum_{k>i} L_ki x_k) / L_ii, k from m - 1 down
#pragma unroll
  for (int i = MAXM - 1; i >= 0; --i) {
    if (i < m) {
      T acc = T(0);
#pragma unroll
      for (int k = MAXM - 1; k > i; --k)
        if (k < m) acc = acc + L[tri(k) + i] * v[k];
      v[i] = (v[i] - acc) / L[tri(i) + i];
    }
  }
#else
#pragma unroll
  for (int i = 0; i < MAXM; ++i) v[i] = L[tri(i) + i] + v[i];
#endif

  if (t < nsys) {
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
      if (i < m) x[sys * m + i] = v[i];
  }
}

// ---------------------------------------------------------------------------
// m > 10: a warp a system (ROWS rows a lane: m <= 32 ROWS)
// ---------------------------------------------------------------------------

// the row a of the packed triangle that holds entry p: t(a) <= p < t(a + 1)
__device__ __forceinline__ int tri_row(int p) {
  const float y = 8.0f * static_cast<float>(p) + 1.0f;
  int a = static_cast<int>((y * rsqrtf(y) - 1.0f) * 0.5f);
  if (tri(a + 1) <= p) ++a;
  if (tri(a) > p) --a;
  return a;
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kMaxWarps * 32)
warp_spd_solve_kernel(const T* __restrict__ A, const T* __restrict__ b, T* __restrict__ x,
                      int B, int m, int warps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sys = blockIdx.x * warps + w;
  if (w >= warps || sys >= B) return;  // whole warps: every shuffle below is full
  // L: the packed lower triangle (row i at t(i)), A's until its column is
  // done; S: a panel's sums over the columns before it
  T* L = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(w) * (tri(m) + kPanel * m);
  T* S = L + tri(m);

  // A's lower triangle, entry p of the packed rows by lane p % 32 (rows are
  // contiguous in A, so a step's loads are, but for a row's end)
  {
    const T* As = A + static_cast<size_t>(sys) * m * m;
#pragma unroll 8
    for (int p = lane; p < tri(m); p += 32) {
      const int i = tri_row(p);
      L[p] = As[i * m + p - tri(i)];
    }
  }
  T bi[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = lane + 32 * r;
    bi[r] = i < m ? b[static_cast<size_t>(sys) * m + i] : T(0);
  }
  __syncwarp();

#if GRAPHIK_SPD_STAGES >= 2
  for (int J = 0; J < m; J += kPanel) {
    const int P = m - J < kPanel ? m - J : kPanel;
    // the panel's sums s_ij = sum_{k<J} L_ik L_jk, column j = J + c by
    // column (rows j..m-1): each a lane's chain over k = 0, 1, ..., J - 1
    if (J > 0) {
      const int np = P * (m - J) - tri(P - 1);
      for (int p = lane; p < np; p += 32) {
        int c = 0, off = p;
        while (off >= m - J - c) {
          off -= m - J - c;
          ++c;
        }
        const int j = J + c, i = j + off;
        const T* Li = L + tri(i);
        const T* Lj = L + tri(j);
        T acc = T(0);
#pragma unroll 4
        for (int k = 0; k < J; ++k) acc = acc + Li[k] * Lj[k];
        S[p] = acc;
      }
      __syncwarp();
    }
    // the panel's columns in turn: each sum takes its products k = J, ...,
    // j - 1, then the pivot and the column
    int off = 0;
    for (int c = 0; c < P; ++c) {
      const int j = J + c;
      const T* Lj = L + tri(j);
      T s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = j + lane + 32 * r;
        s[r] = T(0);
        if (i < m) {
          const T* Li = L + tri(i);
          T acc = J > 0 ? S[off + i - j] : T(0);
          for (int k = J; k < j; ++k) acc = acc + Li[k] * Lj[k];
          s[r] = Li[j] - acc;
        }
      }
      const T d = pivot_sqrt(__shfl_sync(kFull, s[0], 0));  // row j: lane 0
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = j + lane + 32 * r;
        if (i < m) L[tri(i) + j] = i == j ? d : s[r] / d;
      }
      __syncwarp();
      off += m - j;
    }
  }
#endif

  T xv[ROWS];
#if GRAPHIK_SPD_STAGES >= 3
  // forward: y_i once its sum is complete, broadcast, then every later row
  // adds its product with y_i
  T acc[ROWS], yv[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = yv[r] = T(0);
  for (int i = 0; i < m; ++i) {
    const T yi = __shfl_sync(
        kFull, (row_of(bi, i >> 5) - row_of(acc, i >> 5)) / L[tri(i) + i], i & 31);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = lane + 32 * r;
      if (k == i) yv[r] = yi;
      if (k > i && k < m) acc[r] = acc[r] + L[tri(k) + i] * yi;
    }
  }
  // backward, from the last row: row k's sum adds L_ik x_i for i = m - 1,
  // m - 2, ...
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = xv[r] = T(0);
  for (int i = m - 1; i >= 0; --i) {
    const T* Li = L + tri(i);
    const T xi = __shfl_sync(
        kFull, (row_of(yv, i >> 5) - row_of(acc, i >> 5)) / Li[i], i & 31);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int k = lane + 32 * r;
      if (k == i) xv[r] = xi;
      if (k < i) acc[r] = acc[r] + Li[k] * xi;
    }
  }
#else
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = lane + 32 * r;
    xv[r] = i < m ? L[tri(i) + i] + bi[r] : T(0);
  }
#endif
  T* xs = x + static_cast<size_t>(sys) * m;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = lane + 32 * r;
    if (i < m) xs[i] = xv[r];
  }
}

template <typename T, int MAXM>
cudaError_t launch_thread(const void* A, const void* b, void* x, int B, int m,
                          cudaStream_t stream) {
  thread_spd_solve_kernel<T, MAXM><<<(B + 31) / 32, 32, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), B, m);
  return cudaGetLastError();
}

template <typename T, int ROWS>
cudaError_t launch_warp(const void* A, const void* b, void* x, int B, int m,
                        cudaStream_t stream) {
  const int per_warp = (tri(m) + kPanel * m) * static_cast<int>(sizeof(T));
  int warps = kSmemBudget / per_warp;
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  if (warps < 1) {
    // one warp a block past 48 KB
    warps = 1;
    const cudaError_t err = cudaFuncSetAttribute(
        warp_spd_solve_kernel<T, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, per_warp);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + warps - 1) / warps;
  warp_spd_solve_kernel<T, ROWS><<<blocks, warps * 32, warps * per_warp, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x), B, m, warps);
  return cudaGetLastError();
}

// the instance of each m: a thread a system up to 8 and up to 10, a warp
// up to 32, up to 64 and up to 128
template <typename T>
cudaError_t launch_m(const void* A, const void* b, void* x, int B, int m, cudaStream_t st) {
  if (m <= 8) return launch_thread<T, 8>(A, b, x, B, m, st);
  if (m <= 10) return launch_thread<T, 10>(A, b, x, B, m, st);
  if (m <= 32) return launch_warp<T, 1>(A, b, x, B, m, st);
  return m <= 64 ? launch_warp<T, 2>(A, b, x, B, m, st) : launch_warp<T, 4>(A, b, x, B, m, st);
}

}  // namespace

// A (B, m, m) (its lower triangle read), b (B, m) -> x (B, m) with A x = b by
// the clamped-pivot Cholesky; float64 when is_double, else float32;
// 1 <= m <= 128. Launches on `stream` of the current device; returns the
// launch's cudaError_t.
extern "C" int graphik_spd_solve(const void* A, const void* b, void* x, int B, int m,
                                 int is_double, void* stream) {
  if (B <= 0) return 0;
  if (m < 1 || m > 128) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_double ? launch_m<double>(A, b, x, B, m, st)
                                    : launch_m<float>(A, b, x, B, m, st);
  return static_cast<int>(err);
}
