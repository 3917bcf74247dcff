// Batched edge-form cost + Euclidean gradient (K1) and Euclidean
// Hessian-vector product (K2), for NVIDIA Hopper (sm_90a): the kernel
// template. csrc/edge.cu holds the entry points and the instances up to 32
// nodes and 128 edges, csrc/edge_wide.cu the instances past them.
//
// Replaces graphik_tpu/ops/edge.py::_kernel_cost_grad (behind
// cost_and_egrad_pallas) and ::_kernel_hess (behind ehess_pallas), the
// TPU's per-op kernels:
//   cost+grad:  f = sum_e (s0^2 + e1^2 + e2^2),  g = -2 C^T (s dY)
//   hess:       H = 2 C^T (m dD dY - s dZ),      dD = 2 <dY, dZ>
// with no anchor terms and no horizontal projection, as theirs.
//
// What bounds them. A UR10 instance (N = 16, d = 3, E = 64) reads Y (192
// B) and its goal distances (256 B), K2 also Z, and writes g or H (192 B):
// 0.45-0.64 KB against ~1.2k flops of gathers, hinge terms and one scatter.
// The bytes bound is ~20x the flop bound, but what the card spends its
// time on is the instructions (shuffles, shared-memory traffic, the
// scatter's loop): with the loads taken out the kernels ran nearly as long
// as whole, and with the arithmetic taken out they streamed at ~3 TB/s.
// So the design keeps the loads off the critical path and cuts the
// instructions and shared-memory wavefronts each instance issues.
//
// Design, and why.
// * Persistent blocks. The grid is at most the number of blocks resident
//   on the card; a block loads the edge tables once and then walks over
//   tiles of T instances (tiles b, b + grid, ...). One instance a warp in
//   blocks of 4 reloaded ~4.7 KB of tables and ran a __syncthreads for
//   every 4 instances.
// * Two instances a warp when N <= 16 (W = 16: UR10, the planar chains,
//   the tree): with one a warp, half its lanes idled through node work and
//   the scatter. Larger problems keep W = 32, past 32 nodes with two node
//   slots a lane (NPL = 2: lane l holds nodes l and l + 32, as the TR
//   kernel does). A block is 8 warps, T = 8 x 32 / W instances. The
//   segment is csrc/edge_warp.cuh's Warp (lanes, edge slots, shuffle
//   sources, goal distances).
// * Asynchronous staging. A tile's Y (and Z) rows and its goal-distance
//   rows are contiguous in global memory, so thread 0 copies each into a
//   shared-memory stage with one 1D bulk asynchronous copy (cp.async.bulk,
//   the TMA's 1D form), and the copies complete on the stage's mbarrier.
//   Two stages: while the block computes one tile, the next one loads
//   (three or four stages measured no faster). The last tile of the batch,
//   when not full, is read with plain loads (its rows need not be a
//   multiple of 16 bytes). g / H are written into a shared-memory slab
//   (two, alternating) and leave with 16-byte stores by the whole block; f
//   is one store per instance.
// * What no instance changes stays on chip: each lane's edge parameters in
//   registers; the scatter's per-node incidence as a [q][node] code table
//   in shared memory (one conflict-free load a step, where the CSR's rows
//   hit the same banks), sized by the instance (32 x 32 codes at one node
//   a lane, 64 x 64 at two). The tables pass through the slabs' space
//   before the first tile.
// * The scatter. The per-edge terms go into the segment's buffer at each
//   edge's place (ops/edge.py scatter_slots: within its group of W edges,
//   chosen so that the edges the node lanes read together seldom share a
//   bank), the two segments' buffers 16 banks apart. Node lanes then sum
//   their incident edges in ascending edge order, with no float atomics
//   (runs are bitwise repeatable), all lanes for the largest degree: past
//   its own a lane reads a place that holds zero, and adds it exactly. With
//   two node slots a lane sums slot 0's node, then slot 1's.
// * The sums keep the addition tree of a 32-lane butterfly over the
//   32-lane layout (csrc/edge_warp.cuh), and the per-edge statements are
//   Warp::cost_grad_edges' and edge_hvp's. With -fmad=false the results
//   are bitwise those of the kernel-order plain versions in
//   graphik_tpu_torch/ops/edge.py (cost_and_egrad_kernel_order,
//   ehess_kernel_order).
// * Templates on D (2 or 3), EPL = ceil(E / W) (1-8 at W = 16, 1-8 at
//   W = 32), W and NPL (1, or 2 past 32 nodes): N <= 64, E <= 256, the TR
//   kernel's limits. Neither kernel lies on a solve path (the TR kernel
//   fuses the same math); they are the counterparts of the JAX package's
//   two entry points.
//
// The entry points allocate nothing, launch on the caller's stream on the
// given device and return cudaGetLastError().

#pragma once

#include <cstdint>

#include "edge_warp.cuh"

namespace graphik {

constexpr int kEdgeWarps = 8;  // warps a block
constexpr int kStages = 2;     // instance slabs in flight a block
// Sizes K1 / K2 take: two node slots a lane, eight edges a lane at W = 32.
constexpr int kEdgeMaxN = 2 * kMaxN;
constexpr int kEdgeMaxE = 2 * kMaxE;

struct EdgeArgs {
  const float* Y;
  const float* Z;  // K2 only
  const float* dgoal;
  int dg_stride;
  const int *ei, *ej;
  const float* epar;
  const int* rowptr;
  const int* codes;  // [q][N]: node's q-th incident edge, 2 place + (1 at its ej)
  const int* slot;   // each edge's place in a scatter buffer
  float* f;          // K1 only
  float* out;        // g (K1) or H (K2)
  int B, N, E, n_codes;
};

// Launches the instances past 32 nodes or 128 edges (W = 32: NPL = 2 with
// 1-8 edges a lane, NPL = 1 with 5-8), which live in their own translation
// unit (csrc/edge_wide.cu), so that nvcc builds them in parallel.
int launch_edge_wide(const EdgeArgs& a, int D, int epl, bool hess, cudaStream_t s, bool go,
                     int* info);

// The rest has internal linkage, as when it lived in one file: each
// translation unit compiles its own instances.
namespace {

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// A segment's scatter buffer, in floats: [D][W EPL + 1] (place W EPL holds
// a zero), padded so that the two segments of a warp sit 16 banks apart
// (the same edge of both instances: different banks).
__host__ __device__ constexpr int seg_floats(int W, int EPL, int D) {
  return D * (W * EPL + 1) + (W == 16 ? (48 - (D * (W * EPL + 1)) % 32) % 32 : 0);
}

// The floats of an instance's edge tables (Warp::Tables), rounded up to 4.
template <typename Tables>
__host__ __device__ constexpr int table_floats() {
  return round4((int)(sizeof(Tables) / sizeof(float)));
}

// A block's dynamic shared memory, in floats: kStages stages of [Y | Z (K2)
// | goal distances] for one tile, then two output slabs and each warp's
// scatter buffers; before the first tile, the edge tables (`tables`
// floats) sit where the slabs and buffers will be. Every piece starts on
// 16 bytes.
struct EdgeLayout {
  int tile, y, dg, stage, w, tables;
  __host__ __device__ EdgeLayout(int W, int EPL, int N, int D, int stride, bool hess,
                                 int tables)
      : tile(kEdgeWarps * (32 / W)),
        y(round4(tile * N * D)),
        dg(round4(tile * stride)),
        stage((hess ? 2 : 1) * y + dg),
        w((32 / W) * seg_floats(W, EPL, D)),
        tables(tables) {}
  __host__ __device__ int floats() const {
    const int work = 2 * y + kEdgeWarps * w;
    return kStages * stage + (work > tables ? work : tables);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1) : "memory");
}

// One arrival that also announces the bytes the stage's copies will bring.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 1D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A lane's data that no instance changes, kept in registers from tile to
// tile: the parameters of its edge slots (zero past E), their places in
// the scatter buffer (8 bits each) and its segment's scatter buffer.
template <int D, int EPL, int W, int NPL>
struct EdgeLane {
  using Seg = Warp<D, EPL, W, NPL>;
  static constexpr int kWS = W * EPL + 1;  // scatter buffer stride per coordinate
  float om[EPL], psiL[EPL], psiU[EPL], Lm[EPL], Um[EPL];
  unsigned places[(EPL + 3) / 4];
  float* w;

  __device__ int place(int j) const { return (places[j / 4] >> (8 * (j % 4))) & 0xff; }

  __device__ void init(const Seg& c, const typename Seg::Tables& t, const int* slot,
                       float* wbuf) {
#pragma unroll
    for (int j = 0; j < (EPL + 3) / 4; ++j) places[j] = 0u;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = c.edge[j];
      if (e >= 0) places[j / 4] |= (unsigned)slot[e] << (8 * (j % 4));
      om[j] = e >= 0 ? t.par[e] : 0.f;
      psiL[j] = e >= 0 ? t.par[Seg::kME + e] : 0.f;
      psiU[j] = e >= 0 ? t.par[2 * Seg::kME + e] : 0.f;
      Lm[j] = e >= 0 ? t.par[3 * Seg::kME + e] : 0.f;
      Um[j] = e >= 0 ? t.par[4 * Seg::kME + e] : 0.f;
    }
    w = wbuf + (c.base / W) * seg_floats(W, EPL, D);
  }

  // Edge cost f and the per-edge gradient terms s dY into w: the
  // statements of Warp::cost_grad_edges (csrc/edge_warp.cuh) without the
  // residual, on register parameters. Y: (D) node values, or (NPL, D)
  // node slots.
  template <typename YA>
  __device__ float cost_grad_edges(const Seg& c, const YA& Y) const {
    float fpart[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      float dY[D];
      c.edge_diff(Y, j, dY);
      const int e = c.edge[j];
      if (e >= 0) {
        const float dist = dot(dY, dY);
        const float s0 = om[j] * (c.dg[j] - dist);
        const float e1 = Lm[j] * jmax(psiL[j] - dist, 0.f);
        const float e2 = Um[j] * jmax(dist - psiU[j], 0.f);
        fpart[c.hi(j)] = fpart[c.hi(j)] + (s0 * s0 + e1 * e1 + e2 * e2);
        const float s = s0 + e1 - e2;
#pragma unroll
        for (int k = 0; k < D; ++k) w[k * kWS + place(j)] = s * dY[k];
      }
    }
    return seg_sum<W>(fpart[0], fpart[1]);
  }

  // The Hessian's Y-terms (edge_hvp_setup) and the per-edge terms
  // m dD dY - s dZ into w (edge_hvp), on register parameters.
  template <typename YA>
  __device__ void hvp_edges(const Seg& c, const YA& Y, const YA& Z) const {
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      float dY[D], dZ[D];
      c.edge_diff(Y, j, dY);
      c.edge_diff(Z, j, dZ);
      const int e = c.edge[j];
      if (e >= 0) {
        const float dist = dot(dY, dY);
        const float s0 = om[j] * (c.dg[j] - dist);
        const float e1 = Lm[j] * jmax(psiL[j] - dist, 0.f);
        const float e2 = Um[j] * jmax(dist - psiU[j], 0.f);
        const float s = s0 + e1 - e2;
        const float m = om[j] + Lm[j] * (e1 > 0.f ? 1.f : 0.f) + Um[j] * (e2 > 0.f ? 1.f : 0.f);
        const float mdD = m * (2.f * dot(dY, dZ));
#pragma unroll
        for (int k = 0; k < D; ++k) w[k * kWS + place(j)] = mdD * dY[k] - s * dZ[k];
      }
    }
  }

  // out = scale * C^T w for `node`: its incident edges in ascending order
  // (codes: [q][N], the q-th edge coded as 2 place + 1 where the node is
  // the edge's ej). Every lane runs the same qmax steps: past a node's
  // degree (and past N) its codes name the zero place, and acc + 0 is acc
  // (acc starts at +0 and is never -0).
  __device__ __forceinline__ void scatter_node(const int* codes, int N, int qmax, int node,
                                               float scale, float (&out)[D]) const {
    float acc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0.f;
    for (int q = 0; q < qmax; ++q) {
      const int code = node < N ? codes[q * N + node] : 2 * (W * EPL);
      const float* we = w + (code >> 1);
      const unsigned neg = (unsigned)(code & 1) << 31;  // acc - w is acc + (-w)
#pragma unroll
      for (int k = 0; k < D; ++k)
        acc[k] = acc[k] + __uint_as_float(__float_as_uint(we[k * kWS]) ^ neg);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) out[k] = scale * acc[k];
  }

  // The same for this lane's node, as Warp::scatter, w written by the
  // lanes since the last __syncwarp.
  __device__ void scatter(const int* codes, int N, int qmax, int lane, float scale,
                          float (&out)[D]) const {
    __syncwarp();
    scatter_node(codes, N, qmax, lane, scale, out);
    __syncwarp();
  }

  // And for the lane's two node slots, slot 0's node, then slot 1's.
  __device__ void scatter(const int* codes, int N, int qmax, int lane, float scale,
                          float (&out)[2][D]) const {
    __syncwarp();
    scatter_node(codes, N, qmax, lane, scale, out[0]);
    scatter_node(codes, N, qmax, lane + 32, scale, out[1]);
    __syncwarp();
  }
};

template <int D, int EPL, int W, int NPL, bool HESS>
__device__ __forceinline__ void edge_tiles(const EdgeArgs& a) {
  using Seg = Warp<D, EPL, W, NPL>;
  using Tables = typename Seg::Tables;
  __shared__ int s_codes[(kMaxN * NPL) * (kMaxN * NPL)];  // a.codes
  __shared__ uint64_t s_bar[kStages];
  extern __shared__ float4 s_dyn[];
  float* dyn = reinterpret_cast<float*>(s_dyn);

  const EdgeLayout L(W, EPL, a.N, D, a.dg_stride, HESS, table_floats<Tables>());
  const int T = L.tile, ND = a.N * D, stride = a.dg_stride;
  const int zoff = HESS ? L.y : 0, dgoff = (HESS ? 2 : 1) * L.y;
  const int tiles = (a.B + T - 1) / T;
  const int tid = threadIdx.x, warp = tid >> 5;
  float* slabs = dyn + kStages * L.stage;  // [2][L.y], then the scatter buffers
  Tables& tab = *reinterpret_cast<Tables*>(slabs);  // until the first tile

  // Thread 0: the bulk copies of full tile t into stage s.
  auto issue = [&](int t, int s) {
    float* st = dyn + s * L.stage;
    const size_t b0 = (size_t)t * T;
    const uint32_t by = T * ND * 4, bd = T * stride * 4;
    mbar_expect(&s_bar[s], (HESS ? 2 : 1) * by + bd);
    bulk_load(st, a.Y + b0 * ND, by, &s_bar[s]);
    if (HESS) bulk_load(st + zoff, a.Z + b0 * ND, by, &s_bar[s]);
    bulk_load(st + dgoff, a.dgoal + b0 * stride, bd, &s_bar[s]);
  };
  auto full = [&](int t) { return (t + 1) * T <= a.B; };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < tiles && full(t)) issue(t, s);
    }
  }
  for (int q = tid; q < a.E; q += blockDim.x) {
    tab.ei[q] = a.ei[q];
    tab.ej[q] = a.ej[q];
#pragma unroll
    for (int k = 0; k < 5; ++k) tab.par[k * Seg::kME + q] = a.epar[q * 5 + k];
  }
  for (int q = tid; q <= a.N; q += blockDim.x) tab.rowptr[q] = a.rowptr[q];
  for (int q = tid; q < a.n_codes; q += blockDim.x) s_codes[q] = a.codes[q];
  __syncthreads();

  float* wbuf = slabs + 2 * L.y + warp * L.w;  // this warp's scatter buffers
  using Ln = EdgeLane<D, EPL, W, NPL>;
  Seg c;  // its scatter machinery (c.w, c.scatter) goes unused: Ln's replaces it
  c.init_tables(tab, wbuf, a.N, a.E);
  Ln ln;
  ln.init(c, tab, a.slot, wbuf);
  const int local = warp * (32 / W) + (tid & 31) / W;  // this segment's instance in a tile
  const int at = local * ND + c.lane * D;               // its (first) node's first coordinate
  const int qmax = a.n_codes / a.N;                     // the largest degree
  __syncthreads();  // the tables' space becomes the slabs and scatter buffers
  if (c.lane < D) ln.w[c.lane * Ln::kWS + W * EPL] = 0.f;  // the zero place

  for (int it = 0, t = blockIdx.x; t < tiles; ++it, t += gridDim.x) {
    const int s = it % kStages;
    float* st = dyn + s * L.stage;
    const int b0 = t * T;
    const int cnt = min(T, a.B - b0);
    if (cnt == T) {
      mbar_wait(&s_bar[s], (it / kStages) & 1);
    } else {  // the batch's last tile, not full (block-uniform branch)
      for (int i = tid; i < cnt * ND; i += blockDim.x) {
        st[i] = a.Y[(size_t)b0 * ND + i];
        if (HESS) st[zoff + i] = a.Z[(size_t)b0 * ND + i];
      }
      for (int i = tid; i < cnt * stride; i += blockDim.x)
        st[dgoff + i] = a.dgoal[(size_t)b0 * stride + i];
      __syncthreads();
    }

    // A segment past cnt computes on stale stage data and stores nothing.
    c.load_goal(st + dgoff, stride, local);
    float* slab;
    if constexpr (NPL == 1) {
      float Yl[D], o[D];
#pragma unroll
      for (int k = 0; k < D; ++k) Yl[k] = c.has_node ? st[at + k] : 0.f;
      if constexpr (HESS) {
        float Zl[D];
#pragma unroll
        for (int k = 0; k < D; ++k) Zl[k] = c.has_node ? st[zoff + at + k] : 0.f;
        ln.hvp_edges(c, Yl, Zl);
        ln.scatter(s_codes, a.N, qmax, c.lane, 2.f, o);
      } else {
        const float f = ln.cost_grad_edges(c, Yl);
        ln.scatter(s_codes, a.N, qmax, c.lane, -2.f, o);
        if (c.lane == 0 && local < cnt) a.f[b0 + local] = f;
      }
      slab = slabs + (it & 1) * L.y;
      if (c.has_node) {
#pragma unroll
        for (int k = 0; k < D; ++k) slab[at + k] = o[k];
      }
    } else {  // node slot 1 (node lane + 32) sits 32 D floats on
      float Yl[2][D], o[2][D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        Yl[0][k] = c.has_node ? st[at + k] : 0.f;
        Yl[1][k] = c.has_hi ? st[at + 32 * D + k] : 0.f;
      }
      if constexpr (HESS) {
        float Zl[2][D];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          Zl[0][k] = c.has_node ? st[zoff + at + k] : 0.f;
          Zl[1][k] = c.has_hi ? st[zoff + at + 32 * D + k] : 0.f;
        }
        ln.hvp_edges(c, Yl, Zl);
        ln.scatter(s_codes, a.N, qmax, c.lane, 2.f, o);
      } else {
        const float f = ln.cost_grad_edges(c, Yl);
        ln.scatter(s_codes, a.N, qmax, c.lane, -2.f, o);
        if (c.lane == 0 && local < cnt) a.f[b0 + local] = f;
      }
      slab = slabs + (it & 1) * L.y;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (c.has_node) slab[at + k] = o[0][k];
        if (c.has_hi) slab[at + 32 * D + k] = o[1][k];
      }
    }
    // Stage s is read and the slab written; the slab written two tiles ago
    // has left (every thread stored its part before this barrier).
    __syncthreads();
    if (tid == 0) {
      const int tn = t + kStages * gridDim.x;
      if (tn < tiles && full(tn)) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue(tn, s);
      }
    }
    const int n = cnt * ND, n4 = n >> 2;
    float* gout = a.out + (size_t)b0 * ND;  // 16-byte aligned: T ND is a multiple of 4
    for (int i = tid; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(gout)[i] = reinterpret_cast<const float4*>(slab)[i];
    for (int i = 4 * n4 + tid; i < n; i += blockDim.x) gout[i] = slab[i];
  }
}

template <int D, int EPL, int W, int NPL>
__global__ void __launch_bounds__(kEdgeWarps * 32) cost_grad_kernel(EdgeArgs a) {
  edge_tiles<D, EPL, W, NPL, false>(a);
}

template <int D, int EPL, int W, int NPL>
__global__ void __launch_bounds__(kEdgeWarps * 32) hess_kernel(EdgeArgs a) {
  edge_tiles<D, EPL, W, NPL, true>(a);
}

// Launch `kern`, an instance of the kernels above (or of csrc/edge_wide.cu's)
// at these template arguments, when go is true: a grid of min(tiles,
// resident blocks); info[0..6] = W, EPL, instances a tile, tiles, dynamic
// shared memory bytes, blocks resident on the card, blocks launched.
template <int D, int EPL, int W, int NPL, bool HESS>
int launch_edge(void (*kern)(EdgeArgs), const EdgeArgs& a, cudaStream_t stream, bool go,
                int* info) {
  const EdgeLayout L(W, EPL, a.N, D, a.dg_stride, HESS,
                     table_floats<typename Warp<D, EPL, W, NPL>::Tables>());
  const size_t smem = (size_t)L.floats() * sizeof(float);
  // The occupancy query once per device and size (a host-side computation,
  // but not free at a few microseconds a call).
  static int cached_dev = -1, cached_resident = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cached_dev || smem != cached_smem) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kEdgeWarps * 32, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached_dev = dev;
    cached_smem = smem;
    cached_resident = per_sm * sms;
  }
  const int tiles = (a.B + L.tile - 1) / L.tile;
  const int grid = tiles < cached_resident ? tiles : cached_resident;
  if (info) {
    info[0] = W;
    info[1] = EPL;
    info[2] = L.tile;
    info[3] = tiles;
    info[4] = (int)smem;
    info[5] = cached_resident;
    info[6] = grid;
  }
  if (!go) return 0;
  kern<<<grid, kEdgeWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace graphik

// One row of a dispatch table (csrc/edge.cu, csrc/edge_wide.cu): launch
// instance <DD, EE, WW, NN> of the kernel pair KG (cost+gradient) / KH
// (Hessian) when the caller's D, epl and W are DD, EE and WW. The caller
// has a, hess, s, go and info in scope.
#define GRAPHIK_EDGE_CASE(KG, KH, DD, EE, WW, NN)                                        \
  if (D == DD && epl == EE && W == WW)                                                   \
    return hess ? launch_edge<DD, EE, WW, NN, true>(KH<DD, EE, WW, NN>, a, s, go, info)   \
                : launch_edge<DD, EE, WW, NN, false>(KG<DD, EE, WW, NN>, a, s, go, info);
