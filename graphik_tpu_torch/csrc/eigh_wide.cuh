// K5 past n = 32: the batched Jacobi eigensolver of csrc/eigh.cu for 33 <=
// n <= 64 (m = n rounded up to even: 34 ... 64), one kernel instance per m
// and type. Robots past 32 nodes meet it: their MDS Grams are n = N + 1
// (planar40 n = 43, dh19 n = 42), decomposed twice in every prepare.
// The algorithm, its arithmetic and the order of every operation are
// eigh.cu's register kernel's (see its head comment), so the plain version
// (ops/eigh.py sym_eigh_reference) holds these instances bit for bit too.
//
// Design. A lane a rotation pair (h = m / 2 of them, 17 ... 32 lanes), as
// at n <= 32, and m a template argument, so every position of a step is a
// compile-time constant: the loops unroll and nothing in a step divides or
// works out an index.
// * A's rows in registers. Lane L holds its pair's two rows, their columns
//   at positions by pair slot (2 k, 2 k + 1: pair k's first and second
//   index); between steps the tournament moves each index one slot along
//   its cycle: a row to the next lane by shuffles, a column to the next
//   position by the choice of register. A step's row and column rotations
//   read and write registers only.
// * Split over NW warps. Where one warp's 2 m values a lane would spill
//   or run slower (wide_warps), a matrix takes two warps of one block,
//   each holding the columns of half the pairs (warp 0 pairs [0, h0),
//   warp 1 [h0, h), h0 = ceil(h / 2))
//   plus one halo pair across the cut (warp 0 also holds pair h0, warp 1
//   pair h0 - 1), whose columns it updates as the owner does, operation for
//   operation. Only the halo pair's incoming slot depends on the other
//   warp: it is copied from the other warp's own position at the start of
//   each step. A pair's rotation is worked out by the warp that owns its
//   2x2 block; its (c, sigma), and for a halo pair its new diagonal,
//   reach the other warp through shared memory. One 64-thread named
//   barrier a step orders it all; the stop test is an OR-reduction on the
//   same barrier.
// * Each pair's (c, sigma) goes through shared memory (double-buffered by
//   step parity): the column update reads every pair's by broadcast loads.
// * V^T (a row a column of V) in shared memory, rows at fixed addresses by
//   index: a lane rotates its two rows from one row base a step plus
//   compile-time offsets, with 16-byte loads and stores, each warp its
//   share of the columns. Rows are padded with zeros to a multiple of the
//   vector (the zeros stay zero), the row stride an odd number of vectors.
// * One matrix a warp (NW = 1; two matrices a block where their shared
//   memory fits in 48 KB) or a block of two warps (NW = 2). Each matrix runs
//   its own sweep loop and stops on its own test: its bits do not depend on
//   its batch.
// What bounds it (tools/torch_eigh_bench.py on an H100, PERF.md section 6):
// the issue slots, not the flops (the Jacobi's own flop count at the
// card's rate is 6-13x under its time): ~40% of a step is selects and
// register moves, since a lane
// reads and sets its pair's block by a select over the pairs and the move
// takes three selects a position beside its two shuffles. Its time grows
// in proportion to the batch from one wave on.

#pragma once

#include "eigh_common.cuh"

namespace {

// Warps a matrix (1 or 2) of the instance of type size `bytes` at m
// (tools/torch_eigh_bench.py --wide-warps 1,2 on an H100, PERF.md section
// 6). float64 splits at every m by a rule, not by time: one warp a matrix
// spills from m = 40 on (past 56 by 0.9-1.8 KB), and no instance that a
// path launches may spill, though the spilling warp measured faster at n
// = 42-56; below 40 the two tie. float32 splits up to m = 48 by time: the
// split's 64-thread blocks of 118-168 registers beat one warp of 162-249
// by 1-8% at n = 34-48, and from m = 50 one warp is faster by 3-8%.
// GRAPHIK_EIGH_WIDE_WARPS forces one value on every instance; only the
// bench tool sets it.
__host__ __device__ constexpr int wide_warps(int bytes, int m) {
#ifdef GRAPHIK_EIGH_WIDE_WARPS
  return (void)bytes, (void)m, GRAPHIK_EIGH_WIDE_WARPS;
#else
  return bytes == 8 || m <= 48 ? 2 : 1;
#endif
}

// The pairs warp W of NW holds ([lo, hi)) and owns ([own_lo, own_hi)) of a
// matrix with h pairs, and the two positions its halo exchanges: in_pos
// (the halo slot the other warp fills) and out_pos (its own position that
// fills the other warp's halo).
template <int H, int NW, int W>
struct WideSplit {
  static constexpr int H0 = (H + 1) / 2;
  static constexpr int own_lo = NW == 1 ? 0 : (W == 0 ? 0 : H0);
  static constexpr int own_hi = NW == 1 ? H : (W == 0 ? H0 : H);
  static constexpr int lo = NW == 1 ? 0 : (W == 0 ? 0 : H0 - 1);
  static constexpr int hi = NW == 1 ? H : (W == 0 ? H0 + 1 : H);
  static constexpr int in_pos = NW == 1 ? -1 : (W == 0 ? 2 * H0 : 2 * H0 - 1);
  static constexpr int out_pos = NW == 1 ? -1 : (W == 0 ? 2 * H0 - 1 : 2 * H0);
};

template <typename T> struct Vec;  // the 16-byte vector of T
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

__device__ __forceinline__ float& part(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double& part(double2& v, int i) { return i == 0 ? v.x : v.y; }

template <typename T> struct alignas(2 * sizeof(T)) Two { T a, b; };

// One matrix's shared memory.
template <typename T, int M, int NW>
struct WideShared {
  static constexpr int VW = 16 / static_cast<int>(sizeof(T));  // values a vector
  static constexpr int MP = (M + VW * NW - 1) / (VW * NW) * (VW * NW);  // a V^T row, padded
  static constexpr int LDV = (MP / VW) % 2 == 0 ? MP + VW : MP;     // its stride
  alignas(16) T v[M][LDV];  // V^T: row i is column i of V
  Two<T> cs[2][32];         // each pair's (c, sigma), by step parity
  Two<T> dd[2][32];         // each pair's new diagonal (its first, second slot)
  Two<T> cross[2][2][32];   // each warp's out_pos values (row x, row y) by lane
  T mx[2];                  // each warp's max |a_ij|
  T d[M];                   // the eigenvalues by index
};

// matrices a block of the one-warp instances
template <typename T, int M>
__host__ __device__ constexpr int wide_mats() {
  return 2 * sizeof(WideShared<T, M, 1>) <= 48 * 1024 ? 2 : 1;
}

// the matrix's warps meet: a __syncwarp, or the 64-thread named barrier 1
template <int NW>
__device__ __forceinline__ void matrix_sync() {
  if constexpr (NW == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, 64;" ::: "memory");
  }
}

// v of any lane of the matrix's warps
template <int NW>
__device__ __forceinline__ bool matrix_any(bool v) {
  if constexpr (NW == 1) {
    return __any_sync(kFull, v);
  } else {
    int r;
    asm volatile(
        "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n bar.red.or.pred q, 1, 64, p;\n"
        " selp.s32 %0, 1, 0, q;\n}"
        : "=r"(r)
        : "r"(static_cast<int>(v))
        : "memory");
    return r != 0;
  }
}

// Warp W's part of matrix `mat`: lane L holds pair L.
template <typename T, int M, int NW, int W>
__device__ __forceinline__ void wide_matrix(const T* __restrict__ A, T* __restrict__ Wout,
                                            T* __restrict__ Vout, int* __restrict__ conv,
                                            long long mat, int n, WideShared<T, M, NW>& sh,
                                            int L) {
  using S = WideSplit<M / 2, NW, W>;
  using Sh = WideShared<T, M, NW>;
  using V = typename Vec<T>::type;
  constexpr int H = M / 2, R = M - 1;
  constexpr int NP = 2 * (S::hi - S::lo), J0 = 2 * S::lo;  // local position jj is J0 + jj
  constexpr int OWN0 = 2 * (S::own_lo - S::lo), OWN1 = 2 * (S::own_hi - S::lo);
  constexpr int VLO = W * Sh::MP / NW, NV = Sh::MP / NW / Sh::VW;  // this warp's V^T columns
  const bool act = L < H;
  const bool owner = L >= S::own_lo && L < S::own_hi;
  const bool holds = L >= S::lo && L < S::hi;
  const bool even = (n & 1) == 0;  // else index r = n does not exist: pair 0 is skipped
  int ix = L, iy = L == 0 ? R : R - L;  // the indices of pair L's first and second slot

  // rows ix and iy of the mirrored lower triangle, this warp's columns
  T ax[NP], ay[NP];
  T mx = T(0);
  {
    const T* src = A + mat * n * n;
#pragma unroll
    for (int jj = 0; jj < NP; ++jj) {
      const int c = index0(J0 + jj, R);
      T x = T(0), y = T(0);
      if (act && c < n) {
        if (ix < n) x = src[ix >= c ? ix * n + c : c * n + ix];
        if (iy < n) y = src[iy >= c ? iy * n + c : c * n + iy];
      }
      ax[jj] = x;
      ay[jj] = y;
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
  if constexpr (NW == 2) {
    if (L == 0) sh.mx[W] = mx;
    matrix_sync<NW>();
    mx = sh.mx[1] > sh.mx[0] ? sh.mx[1] : sh.mx[0];
  }
  const T thr = Eps<T>::value * mx;

  // rows ix and iy of V^T = I, this warp's columns (each step's barrier
  // orders these writes before any other lane reads the rows)
  if (act)
#pragma unroll
    for (int i = VLO; i < VLO + NV * Sh::VW; ++i) {
      sh.v[ix][i] = i == ix ? T(1) : T(0);
      sh.v[iy][i] = i == iy ? T(1) : T(0);
    }

  bool converged = false;
  for (int sweep = 0;; ++sweep) {
    // the stop test on the upper triangle (row < column < n), the warp's
    // own positions; here ix = L
    bool bad = false;
    if (act)
#pragma unroll
      for (int jj = OWN0; jj < OWN1; ++jj) {
        const int c = index0(J0 + jj, R);
        if (c < n) {
          if (ix < c) bad |= !(absv(ax[jj]) <= thr);
          if (iy < c) bad |= !(absv(ay[jj]) <= thr);
        }
      }
    if (!matrix_any<NW>(bad)) {
      converged = true;
      break;
    }
    if (sweep == kMaxSweeps) break;

#pragma unroll 1
    for (int s = 0; s < R; ++s) {
      const int b = s & 1;
      const bool xp = ix < iy;  // the first slot holds p, the smaller index
      const bool live = act && (L != 0 || even);
      // the owner's rotation of pair L and its block's new diagonal
      T c = T(1), sig = T(0), dx = T(0), dy = T(0);
      if (owner) {
        T axx = T(0), axy = T(0), ayx = T(0), ayy = T(0);
#pragma unroll
        for (int k = S::own_lo; k < S::own_hi; ++k)
          if (k == L) {
            axx = ax[2 * k - J0];
            axy = ax[2 * k + 1 - J0];
            ayx = ay[2 * k - J0];
            ayy = ay[2 * k + 1 - J0];
          }
        const T app = xp ? axx : ayy, aqq = xp ? ayy : axx, apq = xp ? axy : ayx;
        T sg = T(0), t = T(0);
        if (live && absv(apq) > thr) {
          const T theta = (aqq - app) / (apq + apq);
          t = copysignv(T(1) / (absv(theta) + sqrtv(T(1) + theta * theta)), theta);
          c = T(1) / sqrtv(T(1) + t * t);
          sg = t * c;
        }
        sig = xp ? sg : -sg;
        const T tq = t * apq;
        const T dp = app - tq, dq = aqq + tq;
        dx = xp ? dp : dq;
        dy = xp ? dq : dp;
        sh.cs[b][L] = Two<T>{c, sig};
        if constexpr (NW == 2) sh.dd[b][L] = Two<T>{dx, dy};
      }
      if constexpr (NW == 2) {
        if (act) sh.cross[b][W][L] = Two<T>{ax[S::out_pos - J0], ay[S::out_pos - J0]};
      }
      matrix_sync<NW>();
      if constexpr (NW == 2) {
        if (act) {
          const Two<T> in = sh.cross[b][1 - W][L];
          ax[S::in_pos - J0] = in.a;
          ay[S::in_pos - J0] = in.b;
          if (!owner) {
            const Two<T> g = sh.cs[b][L];
            c = g.a;
            sig = g.b;
            if (holds) {
              const Two<T> e = sh.dd[b][L];
              dx = e.a;
              dy = e.b;
            }
          }
        }
      }
      if (live) {
        // rows p, q of A, then columns p, q of V: the lane's own
#pragma unroll
        for (int jj = 0; jj < NP; ++jj) {
          const T x = ax[jj], y = ay[jj];
          ax[jj] = c * x - sig * y;
          ay[jj] = sig * x + c * y;
        }
        V* rx = reinterpret_cast<V*>(&sh.v[ix][VLO]);
        V* ry = reinterpret_cast<V*>(&sh.v[iy][VLO]);
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          V x = rx[q], y = ry[q], u, w;
#pragma unroll
          for (int e = 0; e < Sh::VW; ++e) {
            part(u, e) = c * part(x, e) - sig * part(y, e);
            part(w, e) = sig * part(x, e) + c * part(y, e);
          }
          rx[q] = u;
          ry[q] = w;
        }
      }
      // columns p_k, q_k of both rows, with pair k's (c, sigma)
      if (act)
#pragma unroll
        for (int k = S::lo; k < S::hi; ++k)
          if (k != 0 || even) {
            const Two<T> g = sh.cs[b][k];
            const int p0 = 2 * k - J0;
            const T x = ax[p0], y = ax[p0 + 1];
            ax[p0] = g.a * x - g.b * y;
            ax[p0 + 1] = g.b * x + g.a * y;
            const T u = ay[p0], w = ay[p0 + 1];
            ay[p0] = g.a * u - g.b * w;
            ay[p0 + 1] = g.b * u + g.a * w;
          }
      // the pair's block: diag(a_pp - t a_pq, a_qq + t a_pq)
      if (live && holds)
#pragma unroll
        for (int k = S::lo; k < S::hi; ++k)
          if (k == L) {
            ax[2 * k - J0] = dx;
            ax[2 * k + 1 - J0] = T(0);
            ay[2 * k - J0] = T(0);
            ay[2 * k + 1 - J0] = dy;
          }
      // the indices move one slot along the tournament's cycle: a row to
      // its next lane (L + 1, L - 1 mod 32), a column to its next position;
      // the halo's incoming slot is filled at the next step
      {
        T nx[NP], ny[NP];
#pragma unroll
        for (int jj = 0; jj < NP; ++jj) {
          const int f = from_pos(J0 + jj, H) - J0;
          if (f < 0 || f >= NP) {
            nx[jj] = ax[jj];
            ny[jj] = ay[jj];
            continue;
          }
          const T tx = __shfl_sync(kFull, ax[f], L + 1);
          const T ty = __shfl_sync(kFull, L == 0 ? ax[f] : ay[f], L + 31);
          nx[jj] = L == H - 1 ? ay[f] : tx;
          ny[jj] = L == 0 ? ay[f] : ty;
        }
#pragma unroll
        for (int jj = 0; jj < NP; ++jj) {
          ax[jj] = nx[jj];
          ay[jj] = ny[jj];
        }
      }
      ix = ix + 1 == R ? 0 : ix + 1;
      if (L != 0) iy = iy + 1 == R ? 0 : iy + 1;
    }
  }

  // eigenvalues (the diagonal: the owner's positions 2 L and 2 L + 1, ix =
  // L), ranked against the matrix's others; each warp writes one of the
  // lane's two eigenpairs when the matrix is split
  if (owner) {
    T ex = T(0), ey = T(0);
#pragma unroll
    for (int k = S::own_lo; k < S::own_hi; ++k)
      if (k == L) {
        ex = ax[2 * k - J0];
        ey = ay[2 * k + 1 - J0];
      }
    sh.d[ix] = ex;
    sh.d[iy] = ey;
  }
  matrix_sync<NW>();
  if (act) {
    T* w = Wout + mat * n;
    T* out = Vout + mat * n * n;
    if (NW == 1 || W == 0)
      write_pair<T, M>(sh.d, ix, sh.d[ix], [&](int i) { return sh.v[ix][i]; }, n, w, out);
    if ((NW == 1 || W == 1) && iy < n)
      write_pair<T, M>(sh.d, iy, sh.d[iy], [&](int i) { return sh.v[iy][i]; }, n, w, out);
  }
  if (W == 0 && L == 0) conv[mat] = converged ? 1 : 0;
}

template <typename T, int M, int NW>
__global__ void __launch_bounds__(NW == 2 ? 64 : 32 * wide_mats<T, M>())
sym_eigh_wide_kernel(const T* __restrict__ A, T* __restrict__ W, T* __restrict__ Vout,
                     int* __restrict__ conv, int B, int n) {
  constexpr int kMats = NW == 2 ? 1 : wide_mats<T, M>();
  __shared__ WideShared<T, M, NW> sh[kMats];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (NW == 2) {
    const long long mat = blockIdx.x;
    if (warp == 0)
      wide_matrix<T, M, 2, 0>(A, W, Vout, conv, mat, n, sh[0], lane);
    else
      wide_matrix<T, M, 2, 1>(A, W, Vout, conv, mat, n, sh[0], lane);
  } else {
    const long long mat = static_cast<long long>(blockIdx.x) * kMats + warp;
    if (mat >= B) return;
    wide_matrix<T, M, 1, 0>(A, W, Vout, conv, mat, n, sh[warp], lane);
  }
}

template <typename T, int M>
cudaError_t launch_wide(const void* A, void* W, void* V, void* conv, int B, int n,
                        cudaStream_t st) {
  constexpr int NW = wide_warps(sizeof(T), M);
  static_assert(NW == 1 || NW == 2, "a wide instance takes one or two warps a matrix");
  constexpr int per_block = NW == 2 ? 1 : wide_mats<T, M>();
  const int blocks = (B + per_block - 1) / per_block;
  sym_eigh_wide_kernel<T, M, NW><<<blocks, NW == 2 ? 64 : 32 * per_block, 0, st>>>(
      static_cast<const T*>(A), static_cast<T*>(W), static_cast<T*>(V), static_cast<int*>(conv),
      B, n);
  return cudaGetLastError();
}

// the instance of m = n rounded up to even, 34 <= m <= 64
template <typename T>
int launch_wide_n(const void* A, void* W, void* V, void* conv, int B, int n, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (n + (n & 1)) {
    case 34: err = launch_wide<T, 34>(A, W, V, conv, B, n, st); break;
    case 36: err = launch_wide<T, 36>(A, W, V, conv, B, n, st); break;
    case 38: err = launch_wide<T, 38>(A, W, V, conv, B, n, st); break;
    case 40: err = launch_wide<T, 40>(A, W, V, conv, B, n, st); break;
    case 42: err = launch_wide<T, 42>(A, W, V, conv, B, n, st); break;
    case 44: err = launch_wide<T, 44>(A, W, V, conv, B, n, st); break;
    case 46: err = launch_wide<T, 46>(A, W, V, conv, B, n, st); break;
    case 48: err = launch_wide<T, 48>(A, W, V, conv, B, n, st); break;
    case 50: err = launch_wide<T, 50>(A, W, V, conv, B, n, st); break;
    case 52: err = launch_wide<T, 52>(A, W, V, conv, B, n, st); break;
    case 54: err = launch_wide<T, 54>(A, W, V, conv, B, n, st); break;
    case 56: err = launch_wide<T, 56>(A, W, V, conv, B, n, st); break;
    case 58: err = launch_wide<T, 58>(A, W, V, conv, B, n, st); break;
    case 60: err = launch_wide<T, 60>(A, W, V, conv, B, n, st); break;
    case 62: err = launch_wide<T, 62>(A, W, V, conv, B, n, st); break;
    case 64: err = launch_wide<T, 64>(A, W, V, conv, B, n, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace
