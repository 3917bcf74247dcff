// K5 past n = 64: the batched Jacobi eigensolver of csrc/eigh.cu for 65 <=
// n <= 128 (m = n rounded up to even: 66 ... 128), one kernel a type for
// every m, built by an nvcc process of its own beside csrc/eigh.cu, which
// launches it. Robots past 64 nodes meet it: their MDS Grams are n = N
// (dh40 n = 84, planar100 n = 103), decomposed twice in every prepare.
// The algorithm, its arithmetic and the order of every operation are
// eigh.cu's register kernel's (see its head comment), so the plain version
// (ops/eigh.py sym_eigh_reference) holds this kernel bit for bit too.
//
// Design. csrc/eigh_wide.cuh's layout, taken past 32 pairs: a rotation
// pair's two rows of A in registers, its columns at fixed positions of the
// warp's window, V^T in shared memory.
// * Two pairs a lane. h = m / 2 is 33 ... 64 pairs, more than a warp's
//   lanes, so lane L holds pair L (slot 0) and pair L + 32 (slot 1, where
//   it exists): four rows of A. Between steps the tournament moves each
//   row to the pair before or after it; slot 0's neighbours past lane 31
//   and before lane 0 are slot 1's, so every move stays inside the warp:
//   four shuffles a position for the four rows.
// * A block a matrix, its columns split over G = ceil(h / 8) warps. Warp g
//   owns the columns of pairs [8 g, min(8 g + 8, h)) and holds one halo
//   pair across each cut (the pair before its first and the one after its
//   last), whose columns it updates as the owner does, operation for
//   operation: a window of 10 pairs, 20 positions, 80 values a lane, at
//   the same places in every warp and for every m (position jj of warp g
//   is column position 16 g - 2 + jj), so m is a run-time value and one
//   kernel serves every m. Only a halo's incoming slot depends on the
//   neighbour (the first slot of the pair after the cut, the second of the
//   pair before it): it is copied from the neighbour's own position at the
//   start of each step, through shared memory (double-buffered by step
//   parity). A pair's rotation is worked out by the warp that owns its 2x2
//   block; its (c, sigma), and for a halo pair its new diagonal, reach the
//   other warps through shared memory. One block barrier a step orders it
//   all; the stop test is a block-wide OR (__syncthreads_or). The
//   tournament's turns at the ends of the cycle (positions 1, 3 and
//   2h - 2) are run-time selects between window positions.
// * V^T (a row a column of V) in dynamic shared memory, rows at fixed
//   addresses by index (133 KB at m = 128 in float64), each warp rotating
//   its share of the columns with 16-byte loads and stores; rows padded
//   with zeros to a multiple of the vector times G, the row stride an odd
//   number of vectors.
// * Each matrix runs its own sweep loop and stops on its own test: its bits
//   do not depend on its batch.
// What bounds it: as eigh_wide.cuh, the issue slots of a step's rotations,
// selects and moves, not the flops or the bytes (chip_smoke.py phase 19 on
// an H100, PERF.md section 6).

#include "eigh_common.cuh"

namespace {

template <typename T> struct BlockVec;  // the 16-byte vector of T
template <> struct BlockVec<float> { using type = float4; };
template <> struct BlockVec<double> { using type = double2; };

__device__ __forceinline__ float& block_part(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double& block_part(double2& v, int i) { return i == 0 ? v.x : v.y; }

template <typename T> struct alignas(2 * sizeof(T)) BlockTwo { T a, b; };

constexpr int kBlockPairs = 8;                // pairs a warp owns at most
constexpr int kBlockWarps = 8;                // warps of a matrix at most (h <= 64)
constexpr int kWinPairs = kBlockPairs + 2;    // its window: a halo pair each side
constexpr int kWin = 2 * kWinPairs;           // the window's positions
constexpr int kOut = 2 * kBlockPairs + 1;     // its last own position (a full warp)

__host__ __device__ inline int block_groups(int m) {
  return (m / 2 + kBlockPairs - 1) / kBlockPairs;
}

// One matrix's dynamic shared memory, by m: byte offsets of V^T (m rows of
// LDV values), each pair's (c, sigma) and new diagonal by step parity
// ([2][64]), each warp's outgoing halo values by parity, slot and lane
// ([2][kBlockWarps][2][32], to its left and to its right neighbour), each
// warp's max |a_ij| and the eigenvalues by index.
struct BlockLayout {
  int G, VW, MP, LDV;
  unsigned v, cs, dd, xl, xr, mx, d, bytes;
};

template <typename T>
__host__ __device__ inline BlockLayout block_layout(int m) {
  BlockLayout l;
  l.G = block_groups(m);
  l.VW = 16 / static_cast<int>(sizeof(T));                          // values a vector
  l.MP = (m + l.VW * l.G - 1) / (l.VW * l.G) * (l.VW * l.G);        // a V^T row, padded
  l.LDV = (l.MP / l.VW) % 2 == 0 ? l.MP + l.VW : l.MP;              // its stride
  const unsigned two = sizeof(BlockTwo<T>), halo = 2 * kBlockWarps * 2 * 32 * two;
  l.v = 0;
  l.cs = l.v + static_cast<unsigned>(m * l.LDV * sizeof(T));
  l.dd = l.cs + 2 * 64 * two;
  l.xl = l.dd + 2 * 64 * two;
  l.xr = l.xl + halo;
  l.mx = l.xr + halo;
  l.d = l.mx + kBlockWarps * static_cast<unsigned>(sizeof(T));
  l.bytes = l.d + static_cast<unsigned>(m * sizeof(T));
  return l;
}

// Writes eigenpair (d, row l of V^T) of index l: its rank among the n
// eigenvalues of sd, the column's sign (eigh_common.cuh write_pair, its
// loops to the run-time n).
template <typename T>
__device__ __forceinline__ void block_write_pair(const T* sd, int l, T d, const T* v, int n,
                                                 T* W, T* out) {
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

template <typename T>
__global__ void __launch_bounds__(32 * kBlockWarps)
sym_eigh_block_kernel(const T* __restrict__ A, T* __restrict__ Wout, T* __restrict__ Vout,
                      int* __restrict__ conv, int n) {
  extern __shared__ __align__(16) unsigned char eigh_block_smem[];
  using V = typename BlockVec<T>::type;
  constexpr int VW = 16 / static_cast<int>(sizeof(T));  // values a vector
  const int m = n + (n & 1), H = m / 2, R = m - 1;
  const BlockLayout lay = block_layout<T>(m);
  const int G = lay.G, LDV = lay.LDV;
  T* sv = reinterpret_cast<T*>(eigh_block_smem + lay.v);
  BlockTwo<T>* scs = reinterpret_cast<BlockTwo<T>*>(eigh_block_smem + lay.cs);
  BlockTwo<T>* sdd = reinterpret_cast<BlockTwo<T>*>(eigh_block_smem + lay.dd);
  BlockTwo<T>* sxl = reinterpret_cast<BlockTwo<T>*>(eigh_block_smem + lay.xl);
  BlockTwo<T>* sxr = reinterpret_cast<BlockTwo<T>*>(eigh_block_smem + lay.xr);
  T* smx = reinterpret_cast<T*>(eigh_block_smem + lay.mx);
  T* sd = reinterpret_cast<T*>(eigh_block_smem + lay.d);
  const int g = threadIdx.x >> 5, L = threadIdx.x & 31;
  const long long mat = blockIdx.x;

  // the pairs warp g owns ([own_lo, own_hi)) and holds ([lo_w, hi_w): its
  // own and its halos); window pair kk is pair lo + kk, position jj is
  // column position J0 + jj
  const int own_lo = kBlockPairs * g, own_hi = min(own_lo + kBlockPairs, H);
  const int lo = own_lo - 1, J0 = 2 * lo;
  const int lo_w = g > 0 ? own_lo - 1 : own_lo, hi_w = g < G - 1 ? own_hi + 1 : own_hi;
  const bool left = g > 0, right = g < G - 1;
  const int own1 = 2 * (own_hi - lo);  // one past its last own position
  const int VLO = g * lay.MP / G, NV = lay.MP / G / VW;  // its V^T columns
  const bool even = (n & 1) == 0;  // else index r = n does not exist: pair 0 is skipped
  int P[2], ix[2], iy[2];
  bool act[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    P[t] = L + 32 * t;
    act[t] = P[t] < H;
    ix[t] = act[t] ? P[t] : 0;  // the indices of the pair's first and second slot
    iy[t] = act[t] ? (P[t] == 0 ? R : R - P[t]) : 0;
  }

  // rows ix and iy of the mirrored lower triangle, this warp's columns
  T ax[2][kWin], ay[2][kWin];
  T mx = T(0);
  {
    const T* src = A + mat * n * n;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int jj = 0; jj < kWin; ++jj) {
        const int k = lo + jj / 2;
        const int c = k >= lo_w && k < hi_w ? index0(J0 + jj, R) : n;
        T x = T(0), y = T(0);
        if (act[t] && c < n) {
          if (ix[t] < n) x = src[ix[t] >= c ? ix[t] * n + c : c * n + ix[t]];
          if (iy[t] < n) y = src[iy[t] >= c ? iy[t] * n + c : c * n + iy[t]];
        }
        ax[t][jj] = x;
        ay[t][jj] = y;
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
  if (L == 0) smx[g] = mx;
  __syncthreads();
  mx = smx[0];
  for (int q = 1; q < G; ++q) mx = smx[q] > mx ? smx[q] : mx;
  const T thr = Eps<T>::value * mx;

  // rows ix and iy of V^T = I, this warp's columns (each step's barrier
  // orders these writes before any other lane reads the rows)
#pragma unroll
  for (int t = 0; t < 2; ++t)
    if (act[t])
      for (int i = VLO; i < VLO + NV * VW; ++i) {
        sv[ix[t] * LDV + i] = i == ix[t] ? T(1) : T(0);
        sv[iy[t] * LDV + i] = i == iy[t] ? T(1) : T(0);
      }

  bool converged = false;
  for (int sweep = 0;; ++sweep) {
    // the stop test on the upper triangle (row < column < n), the warp's
    // own positions; here ix = the pair
    bool bad = false;
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (act[t])
#pragma unroll
        for (int jj = 2; jj < 2 + 2 * kBlockPairs; ++jj)
          if (jj < own1) {
            const int c = index0(J0 + jj, R);
            if (c < n) {
              if (ix[t] < c) bad |= !(absv(ax[t][jj]) <= thr);
              if (iy[t] < c) bad |= !(absv(ay[t][jj]) <= thr);
            }
          }
    if (!__syncthreads_or(bad)) {
      converged = true;
      break;
    }
    if (sweep == kMaxSweeps) break;

#pragma unroll 1
    for (int s = 0; s < R; ++s) {
      const int b = s & 1;
      T c[2], sig[2], dx[2], dy[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bool xp = ix[t] < iy[t];  // the first slot holds p, the smaller index
        const bool live = act[t] && (P[t] != 0 || even);
        c[t] = T(1);
        sig[t] = T(0);
        dx[t] = T(0);
        dy[t] = T(0);
        // the owner's rotation of pair P[t] and its block's new diagonal
        bool owner = false;
        T axx = T(0), axy = T(0), ayx = T(0), ayy = T(0);
#pragma unroll
        for (int kk = 1; kk <= kBlockPairs; ++kk)
          if (lo + kk == P[t] && P[t] < own_hi) {
            owner = true;
            axx = ax[t][2 * kk];
            axy = ax[t][2 * kk + 1];
            ayx = ay[t][2 * kk];
            ayy = ay[t][2 * kk + 1];
          }
        if (owner) {
          const T app = xp ? axx : ayy, aqq = xp ? ayy : axx, apq = xp ? axy : ayx;
          T sg = T(0), tt = T(0);
          if (live && absv(apq) > thr) {
            const T theta = (aqq - app) / (apq + apq);
            tt = copysignv(T(1) / (absv(theta) + sqrtv(T(1) + theta * theta)), theta);
            c[t] = T(1) / sqrtv(T(1) + tt * tt);
            sg = tt * c[t];
          }
          sig[t] = xp ? sg : -sg;
          const T tq = tt * apq;
          const T dp = app - tq, dq = aqq + tq;
          dx[t] = xp ? dp : dq;
          dy[t] = xp ? dq : dp;
          scs[b * 64 + P[t]] = BlockTwo<T>{c[t], sig[t]};
          sdd[b * 64 + P[t]] = BlockTwo<T>{dx[t], dy[t]};
        }
        const int slot = ((b * kBlockWarps + g) * 2 + t) * 32 + L;
        if (left) sxl[slot] = BlockTwo<T>{ax[t][2], ay[t][2]};
        if (right) sxr[slot] = BlockTwo<T>{ax[t][kOut], ay[t][kOut]};
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        // the halos' incoming slots, from the neighbours' own positions
        if (right) {
          const BlockTwo<T> in = sxl[((b * kBlockWarps + g + 1) * 2 + t) * 32 + L];
          ax[t][kWin - 2] = in.a;
          ay[t][kWin - 2] = in.b;
        }
        if (left) {
          const BlockTwo<T> in = sxr[((b * kBlockWarps + g - 1) * 2 + t) * 32 + L];
          ax[t][1] = in.a;
          ay[t][1] = in.b;
        }
        if (act[t] && !(P[t] >= own_lo && P[t] < own_hi)) {
          const BlockTwo<T> gg = scs[b * 64 + P[t]];
          c[t] = gg.a;
          sig[t] = gg.b;
          if (P[t] >= lo_w && P[t] < hi_w) {
            const BlockTwo<T> e = sdd[b * 64 + P[t]];
            dx[t] = e.a;
            dy[t] = e.b;
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (act[t] && (P[t] != 0 || even)) {
          // rows p, q of A, then columns p, q of V: the lane's own
#pragma unroll
          for (int jj = 0; jj < kWin; ++jj) {
            const T x = ax[t][jj], y = ay[t][jj];
            ax[t][jj] = c[t] * x - sig[t] * y;
            ay[t][jj] = sig[t] * x + c[t] * y;
          }
          V* rx = reinterpret_cast<V*>(sv + ix[t] * LDV + VLO);
          V* ry = reinterpret_cast<V*>(sv + iy[t] * LDV + VLO);
          for (int q = 0; q < NV; ++q) {
            V x = rx[q], y = ry[q], u, w;
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              block_part(u, e) = c[t] * block_part(x, e) - sig[t] * block_part(y, e);
              block_part(w, e) = sig[t] * block_part(x, e) + c[t] * block_part(y, e);
            }
            rx[q] = u;
            ry[q] = w;
          }
        }
      }
      // columns p_k, q_k of the rows, with pair k's (c, sigma)
#pragma unroll
      for (int kk = 0; kk < kWinPairs; ++kk) {
        const int k = lo + kk;
        if (k >= lo_w && k < hi_w && (k != 0 || even)) {
          const BlockTwo<T> gg = scs[b * 64 + k];
          const int p0 = 2 * kk;
#pragma unroll
          for (int t = 0; t < 2; ++t)
            if (act[t]) {
              const T x = ax[t][p0], y = ax[t][p0 + 1];
              ax[t][p0] = gg.a * x - gg.b * y;
              ax[t][p0 + 1] = gg.b * x + gg.a * y;
              const T u = ay[t][p0], w = ay[t][p0 + 1];
              ay[t][p0] = gg.a * u - gg.b * w;
              ay[t][p0 + 1] = gg.b * u + gg.a * w;
            }
        }
      }
      // the pair's block: diag(a_pp - t a_pq, a_qq + t a_pq)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (act[t] && (P[t] != 0 || even))
#pragma unroll
          for (int kk = 0; kk < kWinPairs; ++kk)
            if (lo + kk == P[t] && P[t] >= lo_w && P[t] < hi_w) {
              ax[t][2 * kk] = dx[t];
              ax[t][2 * kk + 1] = T(0);
              ay[t][2 * kk] = T(0);
              ay[t][2 * kk + 1] = dy[t];
            }
      // the indices move one slot along the tournament's cycle: a first
      // index to the pair before (pair 32's to lane 31's slot 0), a second
      // to the pair after (pair 31's to lane 0's slot 1), pair 0's first to
      // pair 1's second and pair h - 1's second to its first; a column to
      // its next position: an even position from the one two after it
      // (position 2h - 2 from 2h - 1), an odd one from the one two before
      // it (position 1 stays, position 3 from 0). The halos' incoming
      // slots (positions 1 and kWin - 2, whose source lies outside the
      // window) are filled at the next step.
      {
        T nx[2][kWin], ny[2][kWin];
        const int up = (L + 1) & 31, down = (L + 31) & 31;
#pragma unroll
        for (int jj = 0; jj < kWin; ++jj) {
          const int J = J0 + jj;
          T sx0, sx1, sy0, sy1;
          if (jj % 2 == 0 && jj + 2 < kWin) {
            const bool turn = J == 2 * H - 2;
            sx0 = turn ? ax[0][jj + 1] : ax[0][jj + 2];
            sx1 = turn ? ax[1][jj + 1] : ax[1][jj + 2];
            sy0 = turn ? ay[0][jj + 1] : ay[0][jj + 2];
            sy1 = turn ? ay[1][jj + 1] : ay[1][jj + 2];
          } else if (jj % 2 == 1 && jj >= 3) {
            const int f = J == 1 ? 0 : J == 3 ? -3 : -2;
            sx0 = f == 0 ? ax[0][jj] : f == -3 ? ax[0][jj - 3] : ax[0][jj - 2];
            sx1 = f == 0 ? ax[1][jj] : f == -3 ? ax[1][jj - 3] : ax[1][jj - 2];
            sy0 = f == 0 ? ay[0][jj] : f == -3 ? ay[0][jj - 3] : ay[0][jj - 2];
            sy1 = f == 0 ? ay[1][jj] : f == -3 ? ay[1][jj - 3] : ay[1][jj - 2];
          } else {
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              nx[t][jj] = ax[t][jj];
              ny[t][jj] = ay[t][jj];
            }
            continue;
          }
          const T u0 = __shfl_sync(kFull, sx0, up);
          const T u1 = __shfl_sync(kFull, sx1, up);
          const T v0 = __shfl_sync(kFull, L == 0 ? sx0 : sy0, down);
          const T v1 = __shfl_sync(kFull, sy1, down);
          nx[0][jj] = L == 31 ? u1 : u0;
          nx[1][jj] = P[1] == H - 1 ? sy1 : u1;
          ny[0][jj] = L == 0 ? sy0 : v0;
          ny[1][jj] = L == 0 ? v0 : v1;
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int jj = 0; jj < kWin; ++jj) {
            ax[t][jj] = nx[t][jj];
            ay[t][jj] = ny[t][jj];
          }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (act[t]) {
          ix[t] = ix[t] + 1 == R ? 0 : ix[t] + 1;
          if (P[t] != 0) iy[t] = iy[t] + 1 == R ? 0 : iy[t] + 1;
        }
    }
  }

  // eigenvalues (the diagonal: the owner's positions 2 P and 2 P + 1, ix =
  // P), ranked against the matrix's others; warp 2 t + u writes slot t's
  // eigenpair of its first (u = 0) or second (u = 1) index
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    T ex = T(0), ey = T(0);
    bool owner = false;
#pragma unroll
    for (int kk = 1; kk <= kBlockPairs; ++kk)
      if (lo + kk == P[t] && P[t] < own_hi) {
        owner = true;
        ex = ax[t][2 * kk];
        ey = ay[t][2 * kk + 1];
      }
    if (owner) {
      sd[ix[t]] = ex;
      sd[iy[t]] = ey;
    }
  }
  __syncthreads();
  if (g < 4) {  // G >= 5
    const int t = g / 2;
    if (act[t]) {
      T* w = Wout + mat * n;
      T* out = Vout + mat * n * n;
      if (g % 2 == 0)
        block_write_pair<T>(sd, ix[t], sd[ix[t]], sv + ix[t] * LDV, n, w, out);
      else if (iy[t] < n)
        block_write_pair<T>(sd, iy[t], sd[iy[t]], sv + iy[t] * LDV, n, w, out);
    }
  }
  if (g == 0 && L == 0) conv[mat] = converged ? 1 : 0;
}

template <typename T>
int launch_block(const void* A, void* W, void* V, void* conv, int B, int n, cudaStream_t st) {
  if (n < 65 || n > 128) return static_cast<int>(cudaErrorInvalidValue);
  const BlockLayout lay = block_layout<T>(n + (n & 1));
  auto kern = sym_eigh_block_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B, 32 * lay.G, lay.bytes, st>>>(static_cast<const T*>(A), static_cast<T*>(W),
                                         static_cast<T*>(V), static_cast<int*>(conv), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (B, n, n) -> W (B, n), V (B, n, n), conv (B,), 65 <= n <= 128, float32
// or float64; the launch's cudaError_t.
extern "C" int graphik_sym_eigh_block_f32(const void* A, void* W, void* V, void* conv, int B,
                                          int n, cudaStream_t stream) {
  return launch_block<float>(A, W, V, conv, B, n, stream);
}
extern "C" int graphik_sym_eigh_block_f64(const void* A, void* W, void* V, void* conv, int B,
                                          int n, cudaStream_t stream) {
  return launch_block<double>(A, W, V, conv, B, n, stream);
}
