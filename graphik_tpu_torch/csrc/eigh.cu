// K5: batched symmetric eigendecomposition of small matrices (n <= 64), in
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
// N + 1) a lane still holds a pair, but two rows of 64 a lane no longer fit
// in registers: sym_eigh_wide_kernel keeps a matrix's A and V^T in the
// warp's shared memory ((2 m (m + 1) + m) words: 33 KB a matrix at m = 64
// in float32, 67 KB in float64), one matrix a warp, one warp a block, m a
// runtime value (one instance a type). Rows and columns stay in index
// order, so nothing moves between steps: lane L's rows are its pair's two
// indices, and a step's column update reads every pair's (c, sigma) by
// shuffle and its indices from the step number. Lane L alone writes rows
// ix, iy in a step, so the step needs no barrier inside it, only one
// __syncwarp after it. The arithmetic is the register kernel's, operation
// for operation, so the plain version holds it bit for bit too. A first,
// simple form: every step reads and writes ~12 m shared words a lane, and
// its one warp a matrix runs ~10 sweeps of m - 1 dependent steps. On an
// H100, 8192 matrices at n = 42-43 take 8.5-10.7 ms (float32) and
// 18.4-23.5 ms (float64), 100-130x their flop bound, against 4.5-7.1 s for
// torch.linalg.eigh on the same inputs (tools/torch_eigh_bench.py).

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

// lanes of a matrix's segment: h = m/2 rounded up to a power of two
__host__ __device__ constexpr int seg_width(int h) {
  return h <= 1 ? 1 : h <= 2 ? 2 : h <= 4 ? 4 : h <= 8 ? 8 : 16;
}

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

// write_pair for a runtime n: column v of V (n values) of index l.
template <typename T>
__device__ __forceinline__ void write_pair_n(const T* sd, int l, T d, const T* v, int n, T* W,
                                             T* out) {
  int rank = 0;
  for (int j = 0; j < n; ++j) rank += before(sd[j], j, d, l);
  T best = absv(v[0]);
  bool flip = v[0] < T(0);
  for (int i = 1; i < n; ++i) {
    const T x = v[i];
    if (absv(x) > best) {
      best = absv(x);
      flip = x < T(0);
    }
  }
  for (int i = 0; i < n; ++i) out[i * n + rank] = flip ? -v[i] : v[i];
  W[rank] = d;
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

// Shared-memory words of one matrix of sym_eigh_wide_kernel: A and V^T
// ([m][m + 1] each, by index), then the eigenvalues [m].
__host__ __device__ constexpr int wide_words(int m) { return 2 * m * (m + 1) + m; }

template <typename T>
__global__ void __launch_bounds__(32)
sym_eigh_wide_kernel(const T* __restrict__ A, T* __restrict__ W, T* __restrict__ Vout,
                     int* __restrict__ conv, int n) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int m = n + (n & 1), H = m / 2, R = m - 1, LD = m + 1;
  T* sa = reinterpret_cast<T*>(s_raw);  // A: row i at sa + i LD
  T* sv = sa + m * LD;                  // V^T: column i of V at sv + i LD
  T* sd = sv + m * LD;                  // the eigenvalues, by index
  const int L = threadIdx.x;
  const long long mat = blockIdx.x;
  const bool act = L < H;  // lanes past h hold no pair
  const bool even = (n & 1) == 0;
  int ix = L, iy = L == 0 ? R : R - L;  // the indices of pair L's first and second slot

  // rows ix and iy of the mirrored lower triangle, and of V^T = I
  T mx = T(0);
  if (act) {
    const T* src = A + mat * n * n;
    for (int c = 0; c < m; ++c) {
      T x = T(0), y = T(0);
      if (c < n) {
        if (ix < n) x = src[ix >= c ? ix * n + c : c * n + ix];
        if (iy < n) y = src[iy >= c ? iy * n + c : c * n + iy];
      }
      sa[ix * LD + c] = x;
      sa[iy * LD + c] = y;
      sv[ix * LD + c] = c == ix ? T(1) : T(0);
      sv[iy * LD + c] = c == iy ? T(1) : T(0);
      const T u = absv(x), w = absv(y);
      mx = u > mx ? u : mx;
      mx = w > mx ? w : mx;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kFull, mx, o);
    mx = y > mx ? y : mx;
  }
  const T thr = Eps<T>::value * mx;
  __syncwarp();

  bool converged = false;
  for (int sweep = 0;; ++sweep) {
    // the stop test on the upper triangle (row < column < n); here ix = L
    bool bad = false;
    if (act)
      for (int c = 0; c < n; ++c) {
        if (ix < c) bad |= !(absv(sa[ix * LD + c]) <= thr);
        if (iy < c) bad |= !(absv(sa[iy * LD + c]) <= thr);
      }
    if (!__any_sync(kFull, bad)) {
      converged = true;
      break;
    }
    if (sweep == kMaxSweeps) break;

    for (int s = 0; s < R; ++s) {
      // pair L's 2x2 block; p is the smaller of ix and iy
      T axx = T(0), axy = T(0), ayx = T(0), ayy = T(0);
      if (act) {
        axx = sa[ix * LD + ix];
        axy = sa[ix * LD + iy];
        ayx = sa[iy * LD + ix];
        ayy = sa[iy * LD + iy];
      }
      const bool xp = ix < iy;
      const T app = xp ? axx : ayy, aqq = xp ? ayy : axx, apq = xp ? axy : ayx;
      const bool live = act && (L != 0 || even);
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
        for (int j = 0; j < m; ++j) {
          const T x = sa[ix * LD + j], y = sa[iy * LD + j];
          sa[ix * LD + j] = c * x - sig * y;
          sa[iy * LD + j] = sig * x + c * y;
        }
        for (int i = 0; i < m; ++i) {
          const T x = sv[ix * LD + i], y = sv[iy * LD + i];
          sv[ix * LD + i] = c * x - sig * y;
          sv[iy * LD + i] = sig * x + c * y;
        }
      }
      // columns p_k, q_k of both rows, with pair k's (c, sigma); pair k's
      // indices at step s: (s + k, s - k) mod r, pair 0's (s, r)
      for (int k = 0; k < H; ++k) {
        const T ck = __shfl_sync(kFull, c, k), sk = __shfl_sync(kFull, sig, k);
        if (act && (k != 0 || even)) {
          const int pk = s + k >= R ? s + k - R : s + k;
          const int qk = k == 0 ? R : (s - k < 0 ? s - k + R : s - k);
          const T x = sa[ix * LD + pk], y = sa[ix * LD + qk];
          sa[ix * LD + pk] = ck * x - sk * y;
          sa[ix * LD + qk] = sk * x + ck * y;
          const T u = sa[iy * LD + pk], w = sa[iy * LD + qk];
          sa[iy * LD + pk] = ck * u - sk * w;
          sa[iy * LD + qk] = sk * u + ck * w;
        }
      }
      // the pair's block: diag(a_pp - t a_pq, a_qq + t a_pq)
      if (live) {
        const T tq = t * apq;
        const T dp = app - tq, dq = aqq + tq;
        sa[ix * LD + ix] = xp ? dp : dq;
        sa[ix * LD + iy] = T(0);
        sa[iy * LD + ix] = T(0);
        sa[iy * LD + iy] = xp ? dq : dp;
      }
      __syncwarp();  // the next step's lanes of rows ix, iy read them after these writes
      ix = ix + 1 == R ? 0 : ix + 1;
      if (L != 0) iy = iy + 1 == R ? 0 : iy + 1;
    }
  }

  // eigenvalues (the diagonal), ranked against the matrix's others
  T dx = T(0), dy = T(0);
  if (act) {
    dx = sa[ix * LD + ix];
    dy = sa[iy * LD + iy];
    sd[ix] = dx;
    sd[iy] = dy;
  }
  __syncwarp();
  if (act) {
    T* w = W + mat * n;
    T* out = Vout + mat * n * n;
    const T* cx = sv + ix * LD;
    const T* cy = sv + iy * LD;
    write_pair_n(sd, ix, dx, cx, n, w, out);
    if (iy < n) write_pair_n(sd, iy, dy, cy, n, w, out);
  }
  if (L == 0) conv[mat] = converged ? 1 : 0;
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
  // 34 <= m <= 64: one matrix a block of one warp, in dynamic shared memory
  const int m = n + (n & 1);
  if (m > 64) return cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * wide_words(m);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(sym_eigh_wide_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sym_eigh_wide_kernel<T><<<B, 32, smem, st>>>(static_cast<const T*>(A), static_cast<T*>(W),
                                              static_cast<T*>(V), static_cast<int*>(conv), n);
  return cudaGetLastError();
}

}  // namespace

// A (B, n, n) -> eigenvalues W (B, n), eigenvectors V (B, n, n) as columns,
// converged flags conv (B,) int32; float64 when is_double, else float32;
// 1 <= n <= 64. Launches on `stream` of the current device; returns the
// launch's cudaError_t.
extern "C" int graphik_sym_eigh(const void* A, void* W, void* V, void* conv, int B, int n,
                                int is_double, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 64) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_double ? launch_n<double>(A, W, V, conv, B, n, st)
                                    : launch_n<float>(A, W, V, conv, B, n, st);
  return static_cast<int>(err);
}
