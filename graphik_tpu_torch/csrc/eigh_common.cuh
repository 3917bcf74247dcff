// The pieces K5's kernels share (csrc/eigh.cu, n <= 32; csrc/eigh_wide.cuh,
// 33 <= n <= 64): the type's epsilon and exact operations, the tournament's
// positions, the sort order and the write of an eigenpair. eigh.cu's head
// comment states the algorithm.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSweeps = 30;  // sweeps before a matrix stops unconverged
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr float value = FLT_EPSILON; };
template <> struct Eps<double> { static constexpr double value = DBL_EPSILON; };

__device__ __forceinline__ float absv(float x) { return fabsf(x); }
__device__ __forceinline__ double absv(double x) { return fabs(x); }
__device__ __forceinline__ float sqrtv(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrtv(double x) { return sqrt(x); }
__device__ __forceinline__ float copysignv(float x, float y) { return copysignf(x, y); }
__device__ __forceinline__ double copysignv(double x, double y) { return copysign(x, y); }

// the index at column position j at the start of a sweep (step 0): pair k
// = (k, r - k), pair 0 = (0, r)
__host__ __device__ constexpr int index0(int j, int r) {
  return j % 2 == 0 ? j / 2 : (j == 1 ? r : r - j / 2);
}

// the position whose column moves to position j at the next step
__host__ __device__ constexpr int from_pos(int j, int h) {
  return h == 1 ? j
         : j % 2 == 0 ? (j / 2 <= h - 2 ? j + 2 : 2 * h - 1)
                      : (j == 1 ? 1 : j == 3 ? 0 : j - 2);
}

// d_j (index j) sorts before d_i (index i): ascending, NaN last, ties by index.
template <typename T>
__device__ __forceinline__ bool before(T dj, int j, T di, int i) {
  const bool nj = dj != dj, ni = di != di;
  if (nj != ni) return ni;
  if (nj) return j < i;
  return dj < di || (dj == di && j < i);
}

// Writes eigenpair (d, column v of V) of index l: its rank among the n
// eigenvalues of sd, the column's sign.
template <typename T, int M, typename Col>
__device__ __forceinline__ void write_pair(const T* sd, int l, T d, Col v, int n, T* W, T* out) {
  int rank = 0;
  for (int j = 0; j < n; ++j) rank += before(sd[j], j, d, l);
  T best = absv(v(0));
  bool flip = v(0) < T(0);
#pragma unroll
  for (int i = 1; i < M; ++i) {
    const T x = v(i);
    if (i < n && absv(x) > best) {
      best = absv(x);
      flip = x < T(0);
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < n) out[i * n + rank] = flip ? -v(i) : v(i);
  W[rank] = d;
}

}  // namespace
