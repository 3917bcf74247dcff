// One instance of the EDM-completion problem per warp segment of W lanes
// (W = 32: a whole warp; W = 16: half a warp, two instances per warp) over
// its compiled edge form: the per-segment tables and the edge cost,
// gradient and Hessian-vector terms shared by csrc/tr_solve.cu (the TR
// solve) and csrc/edge.cu (the cost+gradient and Hessian-vector entry
// points).
//
// * Lane i < N of a segment holds node i's d coordinates of a state vector.
//   Past 32 nodes a lane holds NPL = 2 node slots (past 64, NPL = 4, the
//   TR kernel only): lane l nodes l, l + 32, ..., and a node sum adds a
//   lane's slots in that order (an absent node adding +0) before the
//   butterfly.
// * At NPL = 4 the per-edge state that the smaller instances keep in
//   registers (edge indices, endpoints, goal distances, the Hessian's
//   Y-terms) lives in the warp's slice of shared memory instead (`Wide`),
//   and an edge reads its endpoints from a staged copy of the vector there
//   rather than by four shuffles a slot: only the node-slot vectors stay in
//   registers. The arithmetic is the same, so are the results.
// * Edge differences C.Y: segment lane l owns edges e = l, l + W, ... (EPL
//   of them) and gathers the endpoint coordinates with __shfl_sync inside
//   its segment. This replaces the MXU incidence matmul of the TPU kernels.
// * Scatter C^T w: each lane writes its per-edge values into the segment's
//   slice of shared memory; node lane i then sums its own incidence list
//   (CSR with signs, ascending edge order). No float atomics, so a run is
//   bitwise repeatable.
// * Sums over a segment are __shfl_xor_sync butterflies, which leave a
//   bitwise-identical value in every lane of the segment, so branches on
//   them never diverge inside a segment. Every sum keeps the addition tree
//   of a 32-lane butterfly over the 32-lane layout (edges l, l + 32, ... on
//   lane l): with W = 16, lane l holds the partials of that layout's lanes
//   l (edges l, l + 32) and l + 16 (edges l + 16, l + 48) apart, adds them
//   as the xor-16 round did, and runs the rounds 8 ... 1. Node values of a
//   16-lane segment add the +0 of the 32-lane layout's empty lanes.
// * f32 throughout; the build passes -fmad=false so every product and sum
//   rounds as in the plain torch versions.

#pragma once

#include <cuda_runtime.h>

namespace graphik {

// The tables' size at one node a lane and up to 4 edges a lane (the TR
// kernel's and K1 / K2's instances up to 32 nodes and 128 edges); past
// them the tables take the instance's size (Warp::Tables).
constexpr int kMaxN = 32;
constexpr int kMaxE = 128;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// jnp.maximum / jnp.minimum: NaN in either operand propagates.
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= 3.402823466e+38f; }

// Sum over a W-lane segment of per-lane partials; with W = 16, lo and hi
// are the partials of the 32-lane layout's lanes l and l + 16 (hi is
// ignored when W = 32).
template <int W>
__device__ __forceinline__ float seg_sum(float lo, float hi) {
  float x = W == 16 ? lo + hi : lo;
#pragma unroll
  for (int m = W / 2; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// Sum of one value per node lane (the 32-lane layout's lanes N..31 add +0).
template <int W>
__device__ __forceinline__ float node_sum(float x) {
  return seg_sum<W>(x, 0.f);
}

template <int W>
__device__ __forceinline__ float seg_max(float x) {
#pragma unroll
  for (int m = W / 2; m > 0; m >>= 1) x = jmax(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float (&b)[D]) {
  float s = a[0] * b[0];
#pragma unroll
  for (int k = 1; k < D; ++k) s = s + a[k] * b[k];
  return s;
}

// The block's shared copy of the edge tables, for up to MN nodes and ME
// edges.
template <int MN, int ME>
struct EdgeTablesT {
  int ei[ME], ej[ME], inc[2 * ME], rowptr[MN + 1];
  float par[5 * ME];  // [5][ME]: omega, psi_L, psi_U, L_mask, U_mask
};
using EdgeTables = EdgeTablesT<kMaxN, kMaxE>;

// Every thread of the block calls it; the caller syncs.
template <int MN, int ME>
__device__ __forceinline__ void load_edge_tables(EdgeTablesT<MN, ME>& t, const int* ei,
                                                 const int* ej, const float* epar,
                                                 const int* rowptr, const int* inc, int N, int E) {
  for (int q = threadIdx.x; q < E; q += blockDim.x) {
    t.ei[q] = ei[q];
    t.ej[q] = ej[q];
#pragma unroll
    for (int k = 0; k < 5; ++k) t.par[k * ME + q] = epar[q * 5 + k];
  }
  for (int q = threadIdx.x; q < 2 * E; q += blockDim.x) t.inc[q] = inc[q];
  for (int q = threadIdx.x; q <= N; q += blockDim.x) t.rowptr[q] = rowptr[q];
}

// NPL = 4 (Warp::kShared): the sizes, the tables' endpoints and the warp's
// slice of shared memory; nothing at NPL <= 2.
template <bool SHARED>
struct WarpWide {};
template <>
struct WarpWide<true> {
  int n_nodes, n_edges;
  const int *tei, *tej;
  float *st, *gd, *hv;  // staged vector, goal distances, Hessian Y-terms
};

// Per-segment view of the block's shared tables plus this lane's edges, for
// NPL node slots a lane (2 or 4 only with W = 32: N <= 64, N <= 128).
template <int D, int EPL, int W = 32, int NPL = 1>
struct Warp : WarpWide<NPL == 4> {
  static_assert(W == 16 || W == 32, "a segment is half a warp or a warp");
  static_assert(NPL == 1 || ((NPL == 2 || NPL == 4) && W == 32),
                "two or four nodes a lane take a whole warp");
  // the tables' edges: kMaxE, or more past 4 edges a lane
  static constexpr int kME = EPL * W > kMaxE ? EPL * W : kMaxE;
  using Tables = EdgeTablesT<kMaxN * NPL, kME>;
  static constexpr int kWS = kME * W / 32;  // scatter buffer stride per coordinate
  // NPL = 4: the per-edge state in the warp's shared slice, of kWide floats:
  // the staged vector [32 NPL][D], goal distances [kME], the Hessian's
  // Y-terms dY [D][kME], s [kME], m [kME]
  static constexpr bool kShared = NPL == 4;
  static constexpr int kWide = kShared ? 32 * NPL * D + (D + 3) * kME : 0;
  static constexpr int kRE = kShared ? 1 : EPL;  // the per-edge register arrays

  int lane;             // lane within the segment
  int base;             // the segment's first warp lane
  bool has_node;        // node slot 0 (node lane) holds a node
  bool has_hi;          // NPL == 2: node slot 1 (node lane + 32) holds a node
  const float* par;     // [5][kME]
  const int* rowptr;    // [N + 1]
  const int* inc;       // [2E]: edge * 2 + (1 if the node is the edge's ej)
  float* w;             // this segment's [D][kWS] scatter buffer
  int edge[kRE];        // edge index, or -1 past E
  int src_i[kRE], src_j[kRE];  // warp lanes of the endpoints
  bool hi_i[kRE], hi_j[kRE];   // NPL == 2: the endpoint is in its lane's slot 1
  float dg[kRE];

  // wbuf: the warp's [D * kME] scatter buffer, split between segments;
  // wide: the warp's kWide floats (NPL = 4).
  __device__ void init_tables(const Tables& t, float* wbuf, int N, int E,
                              float* wide = nullptr) {
    const int wl = threadIdx.x & 31;
    lane = wl & (W - 1);
    base = wl - lane;
    has_node = lane < N;
    has_hi = NPL >= 2 && lane + 32 < N;
    par = t.par;
    rowptr = t.rowptr;
    inc = t.inc;
    w = wbuf + (base / W) * D * kWS;
    if constexpr (kShared) {
      this->n_nodes = N;
      this->n_edges = E;
      this->tei = t.ei;
      this->tej = t.ej;
      this->st = wide;
      this->gd = wide + 32 * NPL * D;
      this->hv = this->gd + kME;
    } else {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int e = lane + W * j;
        const bool valid = e < E;
        edge[j] = valid ? e : -1;
        if constexpr (NPL == 1) {
          src_i[j] = base + (valid ? t.ei[e] : 0);
          src_j[j] = base + (valid ? t.ej[e] : 0);
        } else {
          const int ni = valid ? t.ei[e] : 0, nj = valid ? t.ej[e] : 0;
          src_i[j] = ni & 31;
          src_j[j] = nj & 31;
          hi_i[j] = ni >= 32;
          hi_j[j] = nj >= 32;
        }
      }
    }
  }

  __device__ void load_goal(const float* dgoal, int dg_stride, int b) {
    if constexpr (kShared) {
      for (int e = lane; e < this->n_edges; e += 32) this->gd[e] = dgoal[(size_t)b * dg_stride + e];
      __syncwarp();
    } else {
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        dg[j] = edge[j] >= 0 ? dgoal[(size_t)b * dg_stride + edge[j]] : 0.f;
    }
  }

  // This lane's j-th edge, or -1 past E.
  __device__ __forceinline__ int edge_at(int j) const {
    if constexpr (kShared) {
      const int e = lane + 32 * j;
      return e < this->n_edges ? e : -1;
    } else {
      return edge[j];
    }
  }

  // The goal distance of this lane's j-th edge (a present one).
  __device__ __forceinline__ float goal(int j) const {
    if constexpr (kShared) {
      return this->gd[lane + 32 * j];
    } else {
      return dg[j];
    }
  }

  // Whether node slot s of this lane holds a node.
  __device__ __forceinline__ bool has(int s) const {
    if constexpr (kShared) {
      return lane + 32 * s < this->n_nodes;
    } else {
      return s == 0 ? has_node : has_hi;
    }
  }

  // NPL = 4: the vector's node slots into the staged copy (every lane calls
  // it before an edge loop reads the copy); a no-op otherwise.
  __device__ __forceinline__ void stage(const float (&Y)[NPL][D]) const {
    if constexpr (kShared) {
      __syncwarp();
#pragma unroll
      for (int s = 0; s < NPL; ++s)
#pragma unroll
        for (int k = 0; k < D; ++k) this->st[(lane + 32 * s) * D + k] = Y[s][k];
      __syncwarp();
    }
  }

  __device__ void init(const EdgeTables& t, float* wbuf, const float* dgoal, int dg_stride,
                       int b, int N, int E) {
    init_tables(t, wbuf, N, E);
    load_goal(dgoal, dg_stride, b);
  }

  // Whether slot j holds an edge of the 32-lane layout's lane l + 16.
  __host__ __device__ static constexpr bool hi(int j) { return W == 16 && (j & 1); }

  __device__ float p(int which, int e) const { return par[which * kME + e]; }

  // Y[ei] - Y[ej] for this lane's j-th edge (every lane must call it).
  __device__ void edge_diff(const float (&Y)[D], int j, float (&out)[D]) const {
#pragma unroll
    for (int k = 0; k < D; ++k)
      out[k] = __shfl_sync(kFull, Y[k], src_i[j]) - __shfl_sync(kFull, Y[k], src_j[j]);
  }

  // The same over NPL node slots: each endpoint's value is read from both
  // slots of its lane and the one that holds it is taken; at NPL = 4 both
  // are read from the staged copy of Y (`stage`).
  __device__ void edge_diff(const float (&Y)[NPL][D], int j, float (&out)[D]) const {
    if constexpr (NPL == 1) {
      edge_diff(Y[0], j, out);
    } else if constexpr (kShared) {
      const int e = edge_at(j);
      const int ni = e >= 0 ? this->tei[e] : 0, nj = e >= 0 ? this->tej[e] : 0;
#pragma unroll
      for (int k = 0; k < D; ++k) out[k] = this->st[ni * D + k] - this->st[nj * D + k];
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float i0 = __shfl_sync(kFull, Y[0][k], src_i[j]);
        const float i1 = __shfl_sync(kFull, Y[1][k], src_i[j]);
        const float j0 = __shfl_sync(kFull, Y[0][k], src_j[j]);
        const float j1 = __shfl_sync(kFull, Y[1][k], src_j[j]);
        out[k] = (hi_i[j] ? i1 : i0) - (hi_j[j] ? j1 : j0);
      }
    }
  }

  // out = scale * (C^T w)[node], its edges in ascending order; 0 when the
  // node is not present.
  __device__ __forceinline__ void scatter_node(int node, bool present, float scale,
                                               float (&out)[D]) const {
    float acc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0.f;
    if (present) {
      for (int q = rowptr[node]; q < rowptr[node + 1]; ++q) {
        const int code = inc[q];
        const int e = code >> 1;
        if (code & 1) {
#pragma unroll
          for (int k = 0; k < D; ++k) acc[k] = acc[k] - w[k * kWS + e];
        } else {
#pragma unroll
          for (int k = 0; k < D; ++k) acc[k] = acc[k] + w[k * kWS + e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) out[k] = scale * acc[k];
  }

  // out = scale * C^T w, w written by the lanes since the last __syncwarp.
  __device__ void scatter(float scale, float (&out)[D]) const {
    __syncwarp();
    scatter_node(lane, has_node, scale, out);
    __syncwarp();
  }

  // The same for the NPL node slots of the lane, slot by slot.
  __device__ void scatter(float scale, float (&out)[NPL][D]) const {
    if constexpr (NPL == 1) {
      scatter(scale, out[0]);
    } else if constexpr (kShared) {
      __syncwarp();
#pragma unroll
      for (int s = 0; s < NPL; ++s) scatter_node(lane + 32 * s, has(s), scale, out[s]);
      __syncwarp();
    } else {
      __syncwarp();
      scatter_node(lane, has_node, scale, out[0]);
      scatter_node(lane + 32, has_hi, scale, out[1]);
      __syncwarp();
    }
  }

  // Edge cost f, the per-edge gradient terms s dY into w (the caller
  // scatters them) and this lane's partial (unreduced) max relative
  // residual when res_tol > 0, as tr_pallas.py cost_and_grad.
  // Y: (D) node values, or (NPL, D) node slots.
  template <typename YA>
  __device__ void cost_grad_edges(const YA& Y, float res_tol, float r_floor, float& f,
                                  float& rpart) const {
    float fpart[2] = {0.f, 0.f};
    rpart = 0.f;
    if constexpr (kShared) stage(Y);
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      float dY[D];
      edge_diff(Y, j, dY);
      const int e = edge_at(j);
      if (e >= 0) {
        const float dist = dot(dY, dY);
        const float om = p(0, e), psiL = p(1, e), psiU = p(2, e);
        const float dgj = goal(j);
        const float s0 = om * (dgj - dist);
        const float e1 = p(3, e) * jmax(psiL - dist, 0.f);
        const float e2 = p(4, e) * jmax(dist - psiU, 0.f);
        fpart[hi(j)] = fpart[hi(j)] + (s0 * s0 + e1 * e1 + e2 * e2);
        const float s = s0 + e1 - e2;
#pragma unroll
        for (int k = 0; k < D; ++k) w[k * kWS + e] = s * dY[k];
        if (res_tol > 0.f) {
          float r = fabsf(s0) / jmax(dgj, r_floor);
          r = jmax(r, e1 / jmax(psiL, r_floor));
          r = jmax(r, e2 / jmax(psiU, r_floor));
          rpart = jmax(rpart, r);
        }
      }
    }
    f = seg_sum<W>(fpart[0], fpart[1]);
  }
};

// Edge terms of the Hessian-vector product that depend only on Y
// (tr_pallas.py make_hvp): edge differences, s and m.
template <int D, int EPL>
struct EdgeHvp {
  float dY[EPL][D];
  float s[EPL], m[EPL];
};

// (NPL = 4: into the warp's slice of shared memory, h unused)
template <int D, int EPL, int W, int NPL, int HE>
__device__ void edge_hvp_setup(const Warp<D, EPL, W, NPL>& c, const float (&Y)[NPL][D],
                               EdgeHvp<D, HE>& h) {
  using Seg = Warp<D, EPL, W, NPL>;
  if constexpr (Seg::kShared) {
    c.stage(Y);
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = c.edge_at(j);
      if (e >= 0) {
        float dY[D];
        c.edge_diff(Y, j, dY);
        const float dist = dot(dY, dY);
        const float s0 = c.p(0, e) * (c.goal(j) - dist);
        const float e1 = c.p(3, e) * jmax(c.p(1, e) - dist, 0.f);
        const float e2 = c.p(4, e) * jmax(dist - c.p(2, e), 0.f);
#pragma unroll
        for (int k = 0; k < D; ++k) c.hv[k * Seg::kME + e] = dY[k];
        c.hv[D * Seg::kME + e] = s0 + e1 - e2;
        c.hv[(D + 1) * Seg::kME + e] = c.p(0, e) + c.p(3, e) * (e1 > 0.f ? 1.f : 0.f)
                                       + c.p(4, e) * (e2 > 0.f ? 1.f : 0.f);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      c.edge_diff(Y, j, h.dY[j]);
      const int e = c.edge[j];
      if (e >= 0) {
        const float dist = dot(h.dY[j], h.dY[j]);
        const float s0 = c.p(0, e) * (c.dg[j] - dist);
        const float e1 = c.p(3, e) * jmax(c.p(1, e) - dist, 0.f);
        const float e2 = c.p(4, e) * jmax(dist - c.p(2, e), 0.f);
        h.s[j] = s0 + e1 - e2;
        h.m[j] = c.p(0, e) + c.p(3, e) * (e1 > 0.f ? 1.f : 0.f)
                 + c.p(4, e) * (e2 > 0.f ? 1.f : 0.f);
      } else {
        h.s[j] = 0.f;
        h.m[j] = 0.f;
      }
    }
  }
}

// Euclidean edge Hessian-vector product H = 2 C^T (m dD dY - s dZ).
template <int D, int EPL, int W, int NPL, int HE>
__device__ void edge_hvp(const Warp<D, EPL, W, NPL>& c, const EdgeHvp<D, HE>& h,
                         const float (&Z)[NPL][D], float (&H)[NPL][D]) {
  using Seg = Warp<D, EPL, W, NPL>;
  if constexpr (Seg::kShared) {
    c.stage(Z);
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = c.edge_at(j);
      if (e >= 0) {
        float dZ[D], dY[D];
        c.edge_diff(Z, j, dZ);
#pragma unroll
        for (int k = 0; k < D; ++k) dY[k] = c.hv[k * Seg::kME + e];
        const float s = c.hv[D * Seg::kME + e], m = c.hv[(D + 1) * Seg::kME + e];
        const float mdD = m * (2.f * dot(dY, dZ));
#pragma unroll
        for (int k = 0; k < D; ++k) c.w[k * Seg::kWS + e] = mdD * dY[k] - s * dZ[k];
      }
    }
    c.scatter(2.f, H);
  } else {
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      float dZ[D];
      c.edge_diff(Z, j, dZ);
      const int e = c.edge[j];
      if (e >= 0) {
        const float mdD = h.m[j] * (2.f * dot(h.dY[j], dZ));
#pragma unroll
        for (int k = 0; k < D; ++k)
          c.w[k * Warp<D, EPL, W, NPL>::kWS + e] = mdD * h.dY[j][k] - h.s[j] * dZ[k];
      }
    }
    c.scatter(2.f, H);
  }
}

}  // namespace graphik
