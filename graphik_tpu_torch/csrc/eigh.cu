// K5: batched symmetric eigendecomposition of small matrices (n <= 128), in
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
// * A sweep is m - 1 steps (m = n rounded up to even, r = m - 1). Step s
//   pairs the indices by the round-robin tournament: pair 0 is (s, r),
//   pair k >= 1 is ((s + k) mod r, (s - k) mod r), p < q. For odd n the
//   index r = n does not exist and pair 0 is skipped.
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
// What bounds it on the card (tools/torch_eigh_bench.py on an H100; PERF.md
// section 6). The first form of this kernel (a lane a column, A and
// V in shared memory, each pair's indices recomputed with two integer `%`
// by every lane) took 0.64 ms on UR10's 8192 Grams (n = 16, float32) and
// 0.29 ms on 1024 of them (about one warp a scheduler): the latency of its
// ~100 dependent steps set a floor, the issue slots the rest. A step issued
// 1.1k-1.6k instructions a warp, more than half of them integer index
// arithmetic and moves and a seventh the rotations' arithmetic. Neither
// its bytes (n^2 in, n^2 + n out) nor its flops set its time: the
// instructions of a step and their chain do. The design cuts both:
// * A lane a pair. m/2 lanes hold a matrix, a segment of SEG lanes (m/2
//   rounded up to a power of two): 4 matrices a warp for n <= 16, 2 for
//   17 <= n <= 32. Lane L holds pair L's two rows of A in registers and
//   its two columns of V: in registers too, or in shared memory for
//   float64 at n > 16, where 2 m doubles of A and 2 m of V would not fit.
//   A pair's rotation, its row update and its V update are the lane's own;
//   the column update needs every pair's (c, s): m shuffles a step, all
//   issued before the update.
// * No division: a row's columns sit at positions by pair slot (2 k: the
//   first index of pair k, 2 k + 1: its second), and the kernel is a
//   template on m, so every position in a step is a compile-time
//   register. Between steps the tournament moves each index one slot
//   along a fixed cycle (pair k's first index to pair k - 1's, pair 0's
//   first to pair 1's second, pair k's second to pair k + 1's, pair
//   m/2 - 1's second to its first; r stays): a row moves to its next lane
//   by two shuffles a position, and its columns by the same fixed
//   permutation of the shuffles' registers. Which slot of a pair holds
//   the smaller index (p) sets the rotation's sign: with sigma = +-s,
//   x' = c x - sigma y and y' = sigma x + c y repeat the plain version's
//   c x - s y and s x + c y bit for bit (IEEE's u - (-v) = u + v and
//   round(-x) = -round(x)).
// * The segments of a warp run in lock-step: every shuffle and ballot is
//   taken by all 32 lanes, the sweep loop runs while any matrix is live,
//   and a finished (or absent) matrix does no arithmetic; its data keeps
//   moving along the cycle, which a whole sweep brings back to the start.
//
// Past n = 32 (m = 34 ... 64: robots past 32 nodes, whose MDS Grams are n =
// N + 1) the instances of csrc/eigh_wide.cuh take over (eigh_wide_f32.cu,
// eigh_wide_f64.cu, each source its own nvcc process): the same design with
// h = 17 ... 32 pairs a warp, (c, sigma) broadcast through shared memory,
// V^T in shared memory, and a matrix's columns split over two warps where
// its rows would not fit in registers (that file's head comment). Past n =
// 64 (m = 66 ... 128: robots past 64 nodes) the instances of
// csrc/eigh_block.cu: two pairs a lane, a block a matrix, its columns split
// over its warps, one kernel a type for every m.

#include "eigh_common.cuh"

// the instances past m = 32 (csrc/eigh_wide.cuh) and the kernels past m =
// 64 (csrc/eigh_block.cu): the launch's cudaError_t
extern "C" int graphik_sym_eigh_wide_f32(const void* A, void* W, void* V, void* conv, int B,
                                         int n, cudaStream_t stream);
extern "C" int graphik_sym_eigh_wide_f64(const void* A, void* W, void* V, void* conv, int B,
                                         int n, cudaStream_t stream);
extern "C" int graphik_sym_eigh_block_f32(const void* A, void* W, void* V, void* conv, int B,
                                          int n, cudaStream_t stream);
extern "C" int graphik_sym_eigh_block_f64(const void* A, void* W, void* V, void* conv, int B,
                                          int n, cudaStream_t stream);

namespace {

constexpr int kWarps = 2;  // warps a block

// lanes of a matrix's segment: h = m/2 rounded up to a power of two
__host__ __device__ constexpr int seg_width(int h) {
  return h <= 1 ? 1 : h <= 2 ? 2 : h <= 4 ? 4 : h <= 8 ? 8 : 16;
}

template <typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
sym_eigh_kernel(const T* __restrict__ A, T* __restrict__ W, T* __restrict__ Vout,
                int* __restrict__ conv, int B, int n) {
  constexpr int H = M / 2, R = M - 1, SEG = seg_width(H), kPerWarp = 32 / SEG;
  constexpr int kSlots = kWarps * kPerWarp;
  // V in shared memory (transposed: a row a column of V) for float64 at n > 16
  constexpr bool kVS = sizeof(T) == 8 && M > 16;
  constexpr int LDV = M + 1;
  __shared__ T sd[kSlots][M];
  __shared__ T sV[kVS ? kSlots : 1][kVS ? M : 1][LDV];
  const int lane = threadIdx.x & 31;
  const int L = lane % SEG;  // this lane's pair
  const int slot = (threadIdx.x >> 5) * kPerWarp + lane / SEG;
  const long long mat = static_cast<long long>(blockIdx.x) * kSlots + slot;
  const bool valid = mat < B;
  const bool act = valid && L < H;  // lanes past h in a segment hold no pair
  const unsigned seg_bits = SEG == 32 ? kFull : (((1u << SEG) - 1u) << (lane & ~(SEG - 1)));
  const bool even = (n & 1) == 0;  // else index r = n does not exist: pair 0 is skipped
  int ix = L, iy = L == 0 ? R : R - L;  // the indices of pair L's first and second slot

  // rows ix and iy of the mirrored lower triangle, columns by position
  T ax[M], ay[M];
  T mx = T(0);
  {
    const T* src = A + mat * n * n;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int c = index0(j, R);
      T x = T(0), y = T(0);
      if (act && c < n) {
        if (ix < n) x = src[ix >= c ? ix * n + c : c * n + ix];
        if (iy < n) y = src[iy >= c ? iy * n + c : c * n + iy];
      }
      ax[j] = x;
      ay[j] = y;
      const T u = absv(x), w = absv(y);
      mx = u > mx ? u : mx;
      mx = w > mx ? w : mx;
    }
  }
#pragma unroll
  for (int o = SEG / 2; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kFull, mx, o, SEG);
    mx = y > mx ? y : mx;
  }
  const T thr = Eps<T>::value * mx;

  // columns ix and iy of V = I
  T vx[kVS ? 1 : M], vy[kVS ? 1 : M];
  T(*sv)[LDV] = sV[kVS ? slot : 0];
  if constexpr (kVS) {
    if (act)
#pragma unroll
      for (int i = 0; i < M; ++i) {
        sv[ix][i] = i == ix ? T(1) : T(0);
        sv[iy][i] = i == iy ? T(1) : T(0);
      }
    __syncwarp();
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      vx[i] = i == ix ? T(1) : T(0);
      vy[i] = i == iy ? T(1) : T(0);
    }
  }

  bool done = !valid, converged = false;
  for (int sweep = 0;; ++sweep) {
    // the stop test on the upper triangle (row < column < n); here ix = L
    bool bad = false;
    if (!done && act)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int c = index0(j, R);
        if (c < n) {
          if (ix < c) bad |= !(absv(ax[j]) <= thr);
          if (iy < c) bad |= !(absv(ay[j]) <= thr);
        }
      }
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

#pragma unroll 1
    for (int s = 0; s < R; ++s) {
      // pair L's 2x2 block (positions 2L, 2L + 1 of its two rows); p is the
      // smaller of ix and iy
      T axx = T(0), axy = T(0), ayx = T(0), ayy = T(0);
#pragma unroll
      for (int k = 0; k < H; ++k)
        if (k == L) {
          axx = ax[2 * k];
          axy = ax[2 * k + 1];
          ayx = ay[2 * k];
          ayy = ay[2 * k + 1];
        }
      const bool xp = ix < iy;
      const T app = xp ? axx : ayy, aqq = xp ? ayy : axx, apq = xp ? axy : ayx;
      const bool live = !done && act && (L != 0 || even);
      T c = T(1), sg = T(0), t = T(0);
      if (live && absv(apq) > thr) {
        const T theta = (aqq - app) / (apq + apq);
        t = copysignv(T(1) / (absv(theta) + sqrtv(T(1) + theta * theta)), theta);
        c = T(1) / sqrtv(T(1) + t * t);
        sg = t * c;
      }
      const T sig = xp ? sg : -sg;
      if (live) {
        // rows p, q of A, then columns p, q of V: the lane's own
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const T x = ax[j], y = ay[j];
          ax[j] = c * x - sig * y;
          ay[j] = sig * x + c * y;
        }
        if constexpr (kVS) {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            const T x = sv[ix][i], y = sv[iy][i];
            sv[ix][i] = c * x - sig * y;
            sv[iy][i] = sig * x + c * y;
          }
        } else {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            const T x = vx[i], y = vy[i];
            vx[i] = c * x - sig * y;
            vy[i] = sig * x + c * y;
          }
        }
      }
      // columns p_k, q_k of both rows, with pair k's (c, sigma)
      T ck[H], sk[H];
#pragma unroll
      for (int k = 0; k < H; ++k) {
        ck[k] = __shfl_sync(kFull, c, k, SEG);
        sk[k] = __shfl_sync(kFull, sig, k, SEG);
      }
      if (!done && act)
#pragma unroll
        for (int k = 0; k < H; ++k)
          if (k != 0 || even) {
            const T x = ax[2 * k], y = ax[2 * k + 1];
            ax[2 * k] = ck[k] * x - sk[k] * y;
            ax[2 * k + 1] = sk[k] * x + ck[k] * y;
            const T u = ay[2 * k], w = ay[2 * k + 1];
            ay[2 * k] = ck[k] * u - sk[k] * w;
            ay[2 * k + 1] = sk[k] * u + ck[k] * w;
          }
      // the pair's block: diag(a_pp - t a_pq, a_qq + t a_pq)
      if (live) {
        const T tq = t * apq;
        const T dp = app - tq, dq = aqq + tq;
        const T dx = xp ? dp : dq, dy = xp ? dq : dp;
#pragma unroll
        for (int k = 0; k < H; ++k)
          if (k == L) {
            ax[2 * k] = dx;
            ax[2 * k + 1] = T(0);
            ay[2 * k] = T(0);
            ay[2 * k + 1] = dy;
          }
      }
      // the indices move one slot along the tournament's cycle: a row to
      // its next lane, a column to its next position
      if constexpr (H > 1) {
        const int up = L + 1, down = L + SEG - 1;
        T nx[M], ny[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const int f = from_pos(j, H);
          const T tx = __shfl_sync(kFull, ax[f], up, SEG);
          const T ty = __shfl_sync(kFull, L == 0 ? ax[f] : ay[f], down, SEG);
          nx[j] = L == H - 1 ? ay[f] : tx;
          ny[j] = L == 0 ? ay[f] : ty;
        }
#pragma unroll
        for (int j = 0; j < M; ++j) {
          ax[j] = nx[j];
          ay[j] = ny[j];
        }
        if constexpr (kVS) {
          __syncwarp();  // the next lanes of rows ix, iy read them after this step's writes
        } else {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            const T tx = __shfl_sync(kFull, vx[i], up, SEG);
            const T ty = __shfl_sync(kFull, L == 0 ? vx[i] : vy[i], down, SEG);
            nx[i] = L == H - 1 ? vy[i] : tx;
            ny[i] = L == 0 ? vy[i] : ty;
          }
#pragma unroll
          for (int i = 0; i < M; ++i) {
            vx[i] = nx[i];
            vy[i] = ny[i];
          }
        }
        ix = ix + 1 == R ? 0 : ix + 1;
        if (L != 0) iy = iy + 1 == R ? 0 : iy + 1;
      }
    }
  }

  // eigenvalues (the diagonal: positions 2L and 2L + 1 of the lane's rows,
  // ix = L), ranked against the matrix's others
  T dx = T(0), dy = T(0);
#pragma unroll
  for (int k = 0; k < H; ++k)
    if (k == L) {
      dx = ax[2 * k];
      dy = ay[2 * k + 1];
    }
  if (act) {
    sd[slot][ix] = dx;
    sd[slot][iy] = dy;
  }
  __syncwarp();
  if (act) {
    T* w = W + mat * n;
    T* out = Vout + mat * n * n;
    if constexpr (kVS) {
      const T* cx = sv[ix];
      const T* cy = sv[iy];
      write_pair<T, M>(sd[slot], ix, dx, [&](int i) { return cx[i]; }, n, w, out);
      if (iy < n) write_pair<T, M>(sd[slot], iy, dy, [&](int i) { return cy[i]; }, n, w, out);
    } else {
      write_pair<T, M>(sd[slot], ix, dx, [&](int i) { return vx[i]; }, n, w, out);
      if (iy < n) write_pair<T, M>(sd[slot], iy, dy, [&](int i) { return vy[i]; }, n, w, out);
    }
  }
  if (valid && L == 0) conv[mat] = converged ? 1 : 0;
}

template <typename T, int M>
cudaError_t launch(const void* A, void* W, void* V, void* conv, int B, int n,
                   cudaStream_t stream) {
  constexpr int per_block = kWarps * (32 / seg_width(M / 2));
  const int blocks = (B + per_block - 1) / per_block;
  sym_eigh_kernel<T, M><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(W), static_cast<T*>(V), static_cast<int*>(conv),
      B, n);
  return cudaGetLastError();
}

// the instance of m = n rounded up to even
template <typename T>
cudaError_t launch_n(const void* A, void* W, void* V, void* conv, int B, int n,
                     cudaStream_t st) {
  switch (n + (n & 1)) {
    case 2: return launch<T, 2>(A, W, V, conv, B, n, st);
    case 4: return launch<T, 4>(A, W, V, conv, B, n, st);
    case 6: return launch<T, 6>(A, W, V, conv, B, n, st);
    case 8: return launch<T, 8>(A, W, V, conv, B, n, st);
    case 10: return launch<T, 10>(A, W, V, conv, B, n, st);
    case 12: return launch<T, 12>(A, W, V, conv, B, n, st);
    case 14: return launch<T, 14>(A, W, V, conv, B, n, st);
    case 16: return launch<T, 16>(A, W, V, conv, B, n, st);
    case 18: return launch<T, 18>(A, W, V, conv, B, n, st);
    case 20: return launch<T, 20>(A, W, V, conv, B, n, st);
    case 22: return launch<T, 22>(A, W, V, conv, B, n, st);
    case 24: return launch<T, 24>(A, W, V, conv, B, n, st);
    case 26: return launch<T, 26>(A, W, V, conv, B, n, st);
    case 28: return launch<T, 28>(A, W, V, conv, B, n, st);
    case 30: return launch<T, 30>(A, W, V, conv, B, n, st);
    case 32: return launch<T, 32>(A, W, V, conv, B, n, st);
    default: break;
  }
  // 34 <= m <= 64: the instances of csrc/eigh_wide.cuh, one source a type
  int err;
  if (n <= 64)
    err = sizeof(T) == 8 ? graphik_sym_eigh_wide_f64(A, W, V, conv, B, n, st)
                         : graphik_sym_eigh_wide_f32(A, W, V, conv, B, n, st);
  // 66 <= m <= 128: csrc/eigh_block.cu, one kernel a type
  else
    err = sizeof(T) == 8 ? graphik_sym_eigh_block_f64(A, W, V, conv, B, n, st)
                         : graphik_sym_eigh_block_f32(A, W, V, conv, B, n, st);
  return static_cast<cudaError_t>(err);
}

}  // namespace

// A (B, n, n) -> eigenvalues W (B, n), eigenvectors V (B, n, n) as columns,
// converged flags conv (B,) int32; float64 when is_double, else float32;
// 1 <= n <= 128. Launches on `stream` of the current device; returns the
// launch's cudaError_t.
extern "C" int graphik_sym_eigh(const void* A, void* W, void* V, void* conv, int B, int n,
                                int is_double, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 128) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_double ? launch_n<double>(A, W, V, conv, B, n, st)
                                    : launch_n<float>(A, W, V, conv, B, n, st);
  return static_cast<int>(err);
}
