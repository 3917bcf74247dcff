// K5: batched symmetric eigendecomposition of small matrices (n <= 32), in
// float32 or float64, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's jitted prepare stage calls
// jnp.linalg.eigh (graphik_tpu/utils/dgp.py _eigh, via api.py
// stage_prepare, graphik_tpu/solvers/riemannian.py generate_initialization)
// inside its compiled program, and so does CIDGIK's Fantope step and eigh
// cone projection (graphik_tpu/solvers/cidgik.py). torch.linalg.eigh checks
// its `info` on the host, so it cannot be captured into a CUDA graph; this
// kernel writes a per-matrix converged flag to the device instead, and the
// port's prepare stage and CIDGIK loops run as graphs around it.
// graphik_tpu_torch/ops/eigh.py holds the plain torch version
// (sym_eigh_reference) that the kernel is checked against bit for bit.
//
// Algorithm: cyclic two-sided Jacobi, as cuSOLVER's syevjBatched.
// * The input's lower triangle is read and mirrored (torch.linalg.eigh's
//   UPLO='L'); the upper triangle is never read.
// * thr = eps * max |a_ij| over the mirrored input (eps of the type:
//   FLT_EPSILON, DBL_EPSILON).
// * A sweep is m - 1 steps (m = n rounded up to even). Step s pairs the
//   indices by the round-robin tournament: pair 0 is (s, m - 1), pair
//   k >= 1 is ((s + k) mod (m - 1), (s - k) mod (m - 1)), p < q. For odd
//   n the index m - 1 = n does not exist and its pair is skipped.
// * Each step applies its m/2 disjoint rotations at once, rows then
//   columns (A <- J^T A J, V <- V J). A pair with |a_pq| > thr rotates by
//   the symmetric Schur decomposition (Golub & Van Loan, alg. 8.4.1):
//   theta = (a_qq - a_pp) / (2 a_pq), t = 1 / (|theta| + sqrt(1 +
//   theta^2)) with theta's sign bit (copysign: -0 gives -t; either root
//   zeroes a_pq), c = 1 / sqrt(1 + t^2), s = t c; any
//   other pair takes c = 1, s = 0, t = 0. Then every pair's 2x2 block is
//   set to diag(a_pp - t a_pq, a_qq + t a_pq): a_pq of a pair that did not
//   rotate (|a_pq| <= thr) is deflated to 0. A row and column of exact
//   zeros therefore stays zero, with its unit eigenvector.
// * Before each sweep a matrix is converged when every |a_pq| <= thr
//   (p < q); it stops then, or after MAX_SWEEPS sweeps, unconverged, and
//   writes its flag. Each matrix runs its own loop: the result of a matrix
//   does not depend on the batch it came in.
// * Eigenvalues ascending, ties in index order (NaN last); each
//   eigenvector's entry of largest magnitude (the first on a tie) made
//   positive.
// Arithmetic is + - * / sqrt only, correctly rounded (the build passes
// -fmad=false and uses no fast math), and the exact copysign, so the plain
// version repeats it bit for bit.
//
// What bounds it on the card. One matrix of UR10's prepare is 16 x 16:
// ~7 sweeps of 15 steps, each step a rotation per pair and two passes of
// 2 x 16 x 16 multiply-adds, all dependent on the previous step, on 2 KB
// that never leaves the SM. Neither its bytes nor its flops (9 n^3 a
// matrix, Golub & Van Loan's count for the symmetric QR algorithm, the
// bound chip_smoke.py states) set its time: the chain of dependent steps
// of each matrix does, so the design keeps a step's work on-chip and
// spread over the matrix's lanes.
//
// Design, and why.
// * A segment of SEG lanes owns a matrix, a lane a column: SEG = 16 (two
//   matrices a warp) for n <= 16, SEG = 32 for 17 <= n <= 32, as the TR
//   kernel pairs instances. A and V live in shared memory (rows padded to
//   SEG + 1, so a column walk hits every bank once); each pair's (c, s)
//   reaches the other lanes by a shuffle.
// * Two warps a block: at SEG = 32 in float64 a block holds 2 x 2 x 32 x 33
//   doubles (33.8 KB), under the 48 KB of static shared memory.
// * The segments of a warp run in lock-step: every shuffle and __syncwarp
//   is taken by all 32 lanes, the sweep loop runs while either matrix is
//   live, and a finished (or absent) matrix does no work.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;       // warps a block
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

// Pair k of step s of the round-robin over m = r + 1 indices (p < q).
__device__ __forceinline__ void pair_of(int s, int k, int r, int& p, int& q) {
  int a = s, b = r;
  if (k) {
    a = (s + k) % r;
    b = (s - k + r) % r;
  }
  p = a < b ? a : b;
  q = a < b ? b : a;
}

// d_j (index j) sorts before d_i (index i): ascending, NaN last, ties by index.
template <typename T>
__device__ __forceinline__ bool before(T dj, int j, T di, int i) {
  const bool nj = dj != dj, ni = di != di;
  if (nj != ni) return ni;
  if (nj) return j < i;
  return dj < di || (dj == di && j < i);
}

template <typename T, int SEG>
__global__ void __launch_bounds__(kWarps * 32)
sym_eigh_kernel(const T* __restrict__ A, T* __restrict__ W, T* __restrict__ Vout,
                int* __restrict__ conv, int B, int n) {
  constexpr int kPerWarp = 32 / SEG, LD = SEG + 1;
  __shared__ T sA[kWarps * kPerWarp][SEG][LD];
  __shared__ T sV[kWarps * kPerWarp][SEG][LD];
  const int lane = threadIdx.x & 31;
  const int slot = (threadIdx.x >> 5) * kPerWarp + lane / SEG;
  const int l = lane % SEG;  // this lane's column
  const long long mat = static_cast<long long>(blockIdx.x) * (kWarps * kPerWarp) + slot;
  const bool valid = mat < B;
  T(*a)[LD] = sA[slot];
  T(*v)[LD] = sV[slot];
  const unsigned seg_bits = SEG == 32 ? kFull : (0xffffu << (lane & 16));

  // load (coalesced over the flat matrix), then mirror the lower triangle up
  if (valid) {
    const T* src = A + mat * n * n;
    for (int idx = l; idx < n * n; idx += SEG) a[idx / n][idx % n] = src[idx];
  }
  __syncwarp();
  if (valid && l < n) {
    for (int i = 0; i < l; ++i) a[i][l] = a[l][i];
    for (int i = 0; i < n; ++i) v[i][l] = i == l ? T(1) : T(0);
  }
  __syncwarp();

  T mx = T(0);
  if (valid && l < n)
    for (int i = 0; i < n; ++i) {
      const T x = absv(a[i][l]);
      mx = x > mx ? x : mx;
    }
  for (int o = SEG / 2; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kFull, mx, o, SEG);
    mx = y > mx ? y : mx;
  }
  const T thr = Eps<T>::value * mx;

  const int m = n + (n & 1), r = m - 1, h = m / 2;
  bool done = !valid, converged = false;
  for (int sweep = 0;; ++sweep) {
    bool bad = false;
    if (!done && l < n)
      for (int i = 0; i < l; ++i) bad |= !(absv(a[i][l]) <= thr);
    const unsigned ball = __ballot_sync(kFull, bad);
    if (!done) {
      if (!(ball & seg_bits)) {
        converged = true;
        done = true;
      } else if (sweep == kMaxSweeps) {
        done = true;
      }
    }
    if (__all_sync(kFull, done)) break;

    for (int s = 0; s < r; ++s) {
      // lane k < h: pair k's rotation
      int p = 0, q = 0;
      T c = T(1), sn = T(0), t = T(0), app = T(0), aqq = T(0), apq = T(0);
      if (l < h) pair_of(s, l, r, p, q);
      const bool live = !done && l < h && q < n;
      if (live) {
        app = a[p][p];
        aqq = a[q][q];
        apq = a[p][q];
        if (absv(apq) > thr) {
          const T theta = (aqq - app) / (apq + apq);
          t = copysignv(T(1) / (absv(theta) + sqrtv(T(1) + theta * theta)), theta);
          c = T(1) / sqrtv(T(1) + t * t);
          sn = t * c;
        }
      }
      __syncwarp();  // the pair lanes' reads before anyone writes
      // rows p_k, q_k of column l
      for (int k = 0; k < h; ++k) {
        const T ck = __shfl_sync(kFull, c, k, SEG), sk = __shfl_sync(kFull, sn, k, SEG);
        int pk, qk;
        pair_of(s, k, r, pk, qk);
        if (!done && qk < n && l < n) {
          const T x = a[pk][l], y = a[qk][l];
          a[pk][l] = ck * x - sk * y;
          a[qk][l] = sk * x + ck * y;
        }
      }
      __syncwarp();
      // columns p_k, q_k of row l, of A and V
      for (int k = 0; k < h; ++k) {
        const T ck = __shfl_sync(kFull, c, k, SEG), sk = __shfl_sync(kFull, sn, k, SEG);
        int pk, qk;
        pair_of(s, k, r, pk, qk);
        if (!done && qk < n && l < n) {
          const T x = a[l][pk], y = a[l][qk];
          a[l][pk] = ck * x - sk * y;
          a[l][qk] = sk * x + ck * y;
          const T vx = v[l][pk], vy = v[l][qk];
          v[l][pk] = ck * vx - sk * vy;
          v[l][qk] = sk * vx + ck * vy;
        }
      }
      __syncwarp();
      if (live) {
        const T tq = t * apq;
        a[p][p] = app - tq;
        a[q][q] = aqq + tq;
        a[p][q] = T(0);
        a[q][p] = T(0);
      }
      __syncwarp();
    }
  }

  if (valid && l < n) {
    const T d = a[l][l];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += before(a[j][j], j, d, l);
    T best = absv(v[0][l]);
    int at = 0;
    for (int i = 1; i < n; ++i) {
      const T x = absv(v[i][l]);
      if (x > best) {
        best = x;
        at = i;
      }
    }
    const bool flip = v[at][l] < T(0);
    T* out = Vout + mat * n * n;
    for (int i = 0; i < n; ++i) out[i * n + rank] = flip ? -v[i][l] : v[i][l];
    W[mat * n + rank] = d;
  }
  if (valid && l == 0) conv[mat] = converged ? 1 : 0;
}

template <typename T, int SEG>
cudaError_t launch(const void* A, void* W, void* V, void* conv, int B, int n,
                   cudaStream_t stream) {
  const int per_block = kWarps * (32 / SEG);
  const int blocks = (B + per_block - 1) / per_block;
  sym_eigh_kernel<T, SEG><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(W), static_cast<T*>(V), static_cast<int*>(conv),
      B, n);
  return cudaGetLastError();
}

}  // namespace

// A (B, n, n) -> eigenvalues W (B, n), eigenvectors V (B, n, n) as columns,
// converged flags conv (B,) int32; float64 when is_double, else float32;
// 1 <= n <= 32. Launches on `stream` of the current device; returns the
// launch's cudaError_t.
extern "C" int graphik_sym_eigh(const void* A, void* W, void* V, void* conv, int B, int n,
                                int is_double, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 32) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_double)
    err = n <= 16 ? launch<double, 16>(A, W, V, conv, B, n, st)
                  : launch<double, 32>(A, W, V, conv, B, n, st);
  else
    err = n <= 16 ? launch<float, 16>(A, W, V, conv, B, n, st)
                  : launch<float, 32>(A, W, V, conv, B, n, st);
  return static_cast<int>(err);
}
