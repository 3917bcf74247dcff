// Batched Riemannian trust-region solve of the EDM-completion problem, for
// NVIDIA Hopper (sm_90a): one instance per half warp when it fits there,
// else one per warp. The kernel template; csrc/tr_solve.cu holds the entry
// points and the instances up to 32 nodes and 128 edges, csrc/tr_solve_*.cu
// the larger ones (each its own nvcc process).
//
// Replaces graphik_tpu/ops/tr_pallas.py::_tr_kernel, the fused Pallas TPU
// kernel that runs the whole outer TR loop plus Steihaug-Toint truncated CG
// for a tile of instances: its anchor-free branch as tr_kernel<D, EPL, W,
// NPL, false> and its has_anchors branch (the obstacle reduction: hinge
// terms of robot nodes against constant anchor points) as tr_kernel<D, EPL,
// W, NPL, true>. It computes the same thing statement for statement (stop rules,
// rho regularization, radius updates, the reduced 3x3 Lyapunov-Cholesky
// horizontal projection, per-lane counters); graphik_tpu_torch/ops/
// tr_solve.py holds the plain torch transcription the kernel is checked
// against, in the kernel's summation order.
//
// Instances: tr_kernel<D, EPL, W, NPL, HAS_A>, D = 2 or 3, EPL = ceil(E / W)
// edges a lane (up to 8 at N <= 64: E <= 256; up to 16 past 64 nodes: E <=
// 512), W = 16 or 32 lanes an instance, NPL node slots a lane: 1 up to 32
// nodes, 2 up to 64; at 4 (up to 128 nodes) tr_wide_kernel<D, EPL, HAS_A>,
// the same body (tr_instance) with its own launch bounds.
//
// What bounds it on the card. One UR10 instance is N = 16 nodes x d = 3
// coordinates and E = 64 edges: every tCG step is a Hessian-vector product
// (2 gathers and 1 scatter over 64 edges, ~1k flops) plus 5 dot-product
// reductions over 48 numbers, and each depends on the previous one. Inputs
// and outputs are ~1 KB per instance, read and written once, and the flops
// are a few % of the f32 peak: the work is a long chain of tiny dependent
// steps per instance, and with 4-6 warps per scheduler hiding most of
// their latency it is bound by instruction issue (the one-warp form issued
// ~800 instructions per tCG step, about its measured time at 1980 MHz).
// So the design cuts the instructions each instance issues. The table
// scene adds A = 624 anchor rows (600 live) on 6 nodes, of which ~0.02%
// have an active hinge at any iterate.
//
// Design, and why.
// * A segment of W lanes owns one instance and runs its own loops. The TPU
//   kernel puts instances on the 128-wide lane axis and drives a tile with
//   one loop whose trip count is set by its slowest lane; per-instance
//   loops reproduce it exactly, because lanes of the tile never interact
//   and a live lane's iteration count equals the tile's global counter
//   (so the plateau check on (k+1) % plateau_every holds).
// * Two instances per warp (W = 16) when N <= 16 and E <= 64: UR10's 16
//   nodes fill half a warp, so a whole warp left lanes 16-31 idle on every
//   node-side step. The halves run in lock-step: every shuffle is taken by
//   all 32 lanes, the loops run while either half is live (__any_sync), and
//   per-half predicates freeze a finished tCG or outer iteration. Each sum
//   keeps the 32-lane butterfly's addition tree (csrc/edge_warp.cuh), so
//   the results are bitwise those of one instance per warp. Larger
//   problems keep W = 32.
// * One segment per instance, in a grid of ceil(B / instances per block)
//   blocks. A queue from which resident warps pull their next instance
//   was measured ~1-2% slower at B = 8192: the instances of a path run
//   nearly the same number of iterations, the block scheduler fills the
//   last wave to 94%, and a pulled instance idles its half through the
//   partner's tCG before its first evaluation.
// * The edge machinery (csrc/edge_warp.cuh): shuffles for C.Y, a
//   per-segment shared-memory CSR scatter for C^T w, butterfly sums.
//   Templates on D (2 or 3), EPL = ceil(E / W) <= 8, W and NPL.
// * Past 32 nodes (NPL = 2) lane l holds nodes l and l + 32: Y, the
//   gradient and the tCG vectors are NPL x D values a lane; an edge
//   endpoint is read from both slots of its lane (two shuffles) and the
//   one that holds it taken; a node sum adds slot 0 and slot 1 (+0 for an
//   absent node) before the butterfly, the plain version's order
//   (ops/edge.py lane_sum). The edge tables and scatter buffers are sized
//   by the instance (EdgeTablesT<32 NPL, max(128, EPL W)>), so the
//   instances up to 32 nodes and 128 edges keep their footprint.
// * Past 64 nodes (NPL = 4: planar100's N = 103, E = 209; dh40's N = 84, E
//   = 272) a lane holds nodes l, l + 32, l + 64, l + 96, and a node sum
//   adds the slots below ceil(N / 32) in that order (+0 for an absent
//   node), the plain version's. Eight state vectors of 4 D values a lane
//   and up to 16 edges a lane would not fit a thread's 255 registers with
//   the per-edge state beside them, so these instances keep only the node
//   slots in registers: the per-edge state (goal distances, the Hessian's
//   Y-terms) sits in the warp's slice of dynamic shared memory, endpoints
//   come from the block's tables, and an edge loop first stages the vector
//   it reads in shared memory (csrc/edge_warp.cuh, Warp::kShared).
// * Anchors (HAS_A). The anchor rows come grouped by node (group g: a_R
//   rows of node u_g); the tables (centers, 4 parameters, group nodes) sit
//   in dynamic shared memory. Each group's rows are spread over the 32
//   lanes of the 32-lane layout (row l + 32 t on lane l; a 16-lane segment
//   holds lanes l and l + 16), and the group's sum is one butterfly taken
//   by the node lane - the TPU kernel's a_reduce row sums. The
//   Hessian-vector product needs no per-row work in tCG: the centers are
//   constant, so every row of group g has adZ = Z_u and its term is
//   exactly 2 (K_g Z_u - sigma_g Z_u) with K_g = sum_r 2 ma_r adY_r adY_r^T
//   and sigma_g = sum_r sa_r, formed once per outer iteration by the node
//   lane. That reassociates the TPU kernel's row sum; the plain version
//   does the same.
// * Anchor rows that are provably inactive are skipped, exactly. A row
//   whose hinges are off contributes exact zeros (a1 = a2 = 0, so sa = ma =
//   0): skipping it removes additions of +0 to sums that start at +0 and
//   so are never -0, and a max with 0 of a non-negative residual. The rows
//   a lane still visits keep their order, so every sum is that of the
//   plain version. cost_grad keeps, per group, the point of its last full
//   pass (on the node lane) and a bitmask per lane of the rows that were
//   within a_near of turning on there ("near"). While the node has moved
//   less than a_near since, by the triangle inequality no other row can
//   have turned on (with a 1e-4 relative margin over the f32 rounding of
//   the distances), and only the near rows are evaluated; otherwise the
//   pass is full and the reference moves. hvp_setup at Y visits only the
//   rows that cost_grad found active at Y (a second bitmask, kept for the
//   trial point and the iterate), and a group with no active row in either
//   half of the warp skips its butterflies: its sums are exactly +0.
// * HAS_A = false compiles none of the anchor code.

#pragma once

#include "edge_warp.cuh"

namespace graphik {

// Sizes the build takes: nodes (NPL <= 4), edges (EPL <= 16), anchor rows
// (their tables, (D + 4) A + a_nsel + 384 a_nsel words, fit the H100's 227
// KB of a block's shared memory beside the largest instance's 21.3 KB of
// edge tables and scatter buffers at any a_nsel <= 64 up to 64 nodes; past
// 64 nodes the launch raises where they and the instance's edge state do
// not fit: planar100 with six rings, a_nsel = 100 and A = 800, takes 211
// KB), and the rows of one anchor group (a lane's 32-bit row masks hold
// its T = ceil(a_R / 32) rows of a group).
constexpr int kMaxNodes = 128;
constexpr int kMaxEdges = 512;
constexpr int kMaxA = 3072;
constexpr int kMaxGroupRows = 1024;

// tCG stop reasons (graphik_tpu/ops/tr_pallas.py:41-44)
constexpr int kNegativeCurvature = 0;
constexpr int kExceededTR = 1;
constexpr int kReachedTarget = 2;
constexpr int kMaxInnerIter = 4;

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
// Relative margin of the anchor skip bound over the f32 rounding of the
// distances it compares (each within a few ulps, ~1e-6).
constexpr float kSlackRel = 1e-4f;

struct Params {
  int maxiter, maxinner, mininner, plateau_every;
  float mingradnorm, kappa, theta, rho_prime, rho_regularization;
  float Delta_bar, Delta0, plateau_rtol, plateau_atol, res_tol, a_near;
};

struct Problem {
  const float* Y0;
  const float* dgoal;
  int dg_stride;
  const int *ei, *ej;
  const float* epar;
  const int *rowptr, *inc;
  const float *acen, *apar;
  const int* anode;
  float *Yout, *cost, *gradnorm;
  int *iters, *ninner;
  int B, N, E, A, a_nsel, a_R;
};

// Entries of a symmetric D x D matrix kept as its upper triangle.
__host__ __device__ constexpr int sym_count(int D) { return D * (D + 1) / 2; }
__host__ __device__ constexpr int sym_idx(int D, int i, int j) {
  return i <= j ? i * D - i * (i - 1) / 2 + (j - i) : j * D - j * (j - 1) / 2 + (i - j);
}

__device__ __forceinline__ unsigned low_bits(int n) { return n >= 32 ? kFull : (1u << n) - 1u; }

// The words of a block's anchor tables in dynamic shared memory (0 without
// anchors): centers, parameters, group nodes and each warp's row masks.
__host__ __device__ inline size_t anchor_words(int D, int A, int a_nsel) {
  return A > 0 ? (size_t)(D + 4) * A + a_nsel + (size_t)kWarpsPerBlock * 3 * a_nsel * 32 : 0;
}

// The block's anchor tables in shared memory, and this warp's row masks.
template <int D>
struct Anchors {
  const float* cen;   // [D][A]
  const float* par;   // [4][A]: apsi_L, apsi_U, aL_mask, aU_mask
  const int* node;    // [nsel]: the node of each group
  unsigned* mask;     // this warp's [3][nsel][32]: near rows, active rows (2 buffers)
  int A, nsel, R;
  int T;              // rows of a group on each lane of the 32-lane layout
  float near;         // a_near

  __device__ float p(int which, int r) const { return par[which * A + r]; }

  // Hinge terms of anchor row r at node position Yu.
  __device__ void terms(const float (&Yu)[D], int r, float (&adY)[D], float& adist, float& a1,
                        float& a2) const {
#pragma unroll
    for (int k = 0; k < D; ++k) adY[k] = Yu[k] - cen[k * A + r];
    adist = dot(adY, adY);
    a1 = p(2, r) * jmax(p(0, r) - adist, 0.f);
    a2 = p(3, r) * jmax(adist - p(1, r), 0.f);
  }

  // A lower bound on how far the node must move before row r's hinges can
  // turn on, from squared distance adist to its center (+inf for a row
  // with no hinge, NaN when adist is NaN).
  __device__ float slack(int r, float adist) const {
    const float d = sqrtf(adist);
    float s = __int_as_float(0x7f800000);
    if (p(2, r) != 0.f) s = d * (1.f - kSlackRel) - sqrtf(p(0, r)) * (1.f + kSlackRel);
    if (p(3, r) != 0.f) s = jmin(s, sqrtf(p(1, r)) * (1.f - kSlackRel) - d * (1.f + kSlackRel));
    return s;
  }

  __device__ unsigned& near_rows(int g) const { return mask[g * 32 + (threadIdx.x & 31)]; }
  __device__ unsigned& active_rows(int buf, int g) const {
    return mask[((1 + buf) * nsel + g) * 32 + (threadIdx.x & 31)];
  }
};

// This lane's share of its instance's anchor state.
template <int D, int NPL>
struct AnchorLane {
  bool mine[NPL];       // the node of this lane's slot has a group
  unsigned all;         // the row slots of a group that hold rows
  int ybuf;             // the active-row buffer of the iterate Y (the other: the trial point)
  float Yref[NPL][D];   // node slots: the point of the group's last full pass
};

// Whether node slot s of this lane holds node u.
template <int D, int EPL, int W, int NPL>
__device__ __forceinline__ bool holds(const Warp<D, EPL, W, NPL>& c, int s, int u) {
  return c.lane + 32 * s == u;
}

// Every lane of the segment gets node u's value of x (one a node slot).
template <int D, int EPL, int W, int NPL>
__device__ __forceinline__ float node_value(const Warp<D, EPL, W, NPL>& c, const float (&x)[NPL],
                                            int u) {
  if constexpr (NPL == 1) {
    return __shfl_sync(kFull, x[0], c.base + u);
  } else if constexpr (NPL == 4) {
    // u is the same on every lane: each takes slot u / 32 by selects
    float v = x[0];
#pragma unroll
    for (int s = 1; s < NPL; ++s)
      if ((u >> 5) == s) v = x[s];
    return __shfl_sync(kFull, v, u & 31);
  } else {
    const float lo = __shfl_sync(kFull, x[0], u & 31), hi = __shfl_sync(kFull, x[1], u & 31);
    return u >= 32 ? hi : lo;
  }
}

// The sum over the segment's nodes of x (one a node slot): a lane adds its
// slots in order (an absent node adds +0; at NPL = 4 the slots below
// ceil(N / 32), as ops/edge.py lane_sum), then the butterfly.
template <int D, int EPL, int W, int NPL>
__device__ __forceinline__ float nodes_sum(const Warp<D, EPL, W, NPL>& c, const float (&x)[NPL]) {
  float p = x[0];
  if constexpr (NPL == 2) p = p + (c.has_hi ? x[1] : 0.f);
  if constexpr (NPL == 4) {
    const int slots = (c.n_nodes + 31) >> 5;
#pragma unroll
    for (int s = 1; s < NPL; ++s)
      if (s < slots) p = p + (c.has(s) ? x[s] : 0.f);
  }
  return node_sum<W>(p);
}

// The sum over the nodes of a . b.
template <int D, int EPL, int W, int NPL>
__device__ __forceinline__ float nodes_dot(const Warp<D, EPL, W, NPL>& c,
                                           const float (&a)[NPL][D], const float (&b)[NPL][D]) {
  float x[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) x[s] = dot(a[s], b[s]);
  return nodes_sum(c, x);
}

// The sum over the nodes of a_i b_j - a_j b_i, or of a_i b_j when sub is
// false (coordinates i, j).
template <int D, int EPL, int W, int NPL>
__device__ __forceinline__ float nodes_cross(const Warp<D, EPL, W, NPL>& c,
                                             const float (&a)[NPL][D], const float (&b)[NPL][D],
                                             int i, int j, bool sub) {
  float x[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) x[s] = sub ? a[s][i] * b[s][j] - b[s][i] * a[s][j] : a[s][i] * b[s][j];
  return nodes_sum(c, x);
}

// The 32-lane layout's lane of this lane's slot v (a 16-lane segment holds
// lanes l and l + 16); row slot bit v * T + t is group row lane + 32 t.
template <int W>
__device__ __forceinline__ int layout_lane(int lane, int v) {
  return W == 16 ? lane + 16 * v : lane;
}

// Cost f, Euclidean gradient g and (when res_tol > 0) the max relative
// residual, edge and anchor terms (tr_pallas.py cost_and_grad), at a trial
// point Y: records the rows active there in the buffer that is not Y's.
template <int D, int EPL, int W, int NPL, bool HAS_A>
__device__ void cost_grad(const Warp<D, EPL, W, NPL>& c, const Anchors<D>& a,
                          AnchorLane<D, NPL>& al, const float (&Y)[NPL][D], float res_tol,
                          float r_floor, float& f, float (&g)[NPL][D], float& rmax) {
  float rpart;
  c.cost_grad_edges(Y, res_tol, r_floor, f, rpart);
  c.scatter(-2.f, g);
  if constexpr (HAS_A) {
    constexpr int V = 32 / W;
    float fa[V];
#pragma unroll
    for (int v = 0; v < V; ++v) fa[v] = 0.f;
    const int pbuf = al.ybuf ^ 1;
    for (int gi = 0; gi < a.nsel; ++gi) {
      const int un = a.node[gi];
      float Yu[D], mv[NPL];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float x[NPL];
#pragma unroll
        for (int s = 0; s < NPL; ++s) x[s] = Y[s][k];
        Yu[k] = node_value(c, x, un);
      }
#pragma unroll
      for (int s = 0; s < NPL; ++s) {
        float dY[D];
#pragma unroll
        for (int k = 0; k < D; ++k) dY[k] = Y[s][k] - al.Yref[s][k];
        mv[s] = sqrtf(dot(dY, dY));
      }
      // how far the group's node moved since the group's last full pass
      const float moved = node_value(c, mv, un);
      const bool full = !(moved * (1.f + kSlackRel) < a.near);
      const unsigned todo = full ? al.all : a.near_rows(gi);
      unsigned act = 0, near = 0;
      float wp[V][D];
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int k = 0; k < D; ++k) wp[v][k] = 0.f;
        for (unsigned m = (todo >> (v * a.T)) & low_bits(a.T); m; m &= m - 1) {
          const int t = __ffs(m) - 1;
          const int r = gi * a.R + layout_lane<W>(c.lane, v) + 32 * t;
          float adY[D], adist, a1, a2;
          a.terms(Yu, r, adY, adist, a1, a2);
          fa[v] = fa[v] + (a1 * a1 + a2 * a2);
          const float sa = a1 - a2;
#pragma unroll
          for (int k = 0; k < D; ++k) wp[v][k] = wp[v][k] + sa * adY[k];
          if (res_tol > 0.f)
            rpart = jmax(rpart, jmax(a1 / jmax(a.p(0, r), r_floor), a2 / jmax(a.p(1, r), r_floor)));
          const unsigned bit = 1u << (v * a.T + t);
          if (a1 != 0.f || a2 != 0.f) act |= bit;
          if (full && !(a.slack(r, adist) >= a.near)) near |= bit;
        }
      }
      a.active_rows(pbuf, gi) = act;
      if (full) {
        a.near_rows(gi) = near;
#pragma unroll
        for (int s = 0; s < NPL; ++s) {
          if (holds(c, s, un)) {
#pragma unroll
            for (int k = 0; k < D; ++k) al.Yref[s][k] = Y[s][k];
          }
        }
      }
      if (__any_sync(kFull, act != 0)) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float G = seg_sum<W>(wp[0][k], wp[V - 1][k]);
#pragma unroll
          for (int s = 0; s < NPL; ++s)
            if (holds(c, s, un)) g[s][k] = g[s][k] - 2.f * G;
        }
      }
    }
    f = f + seg_sum<W>(fa[0], fa[V - 1]);
  }
  rmax = res_tol > 0.f ? seg_max<W>(rpart) : 0.f;
}

// Terms of the Riemannian Hessian-vector product that depend only on Y
// (tr_pallas.py make_hvp): the edge terms, the Cholesky factor of the
// reduced Lyapunov system and, with anchors, this lane's K_g and sigma_g.
template <int D, int EPL, int NPL, bool HAS_A>
struct Hvp {
  EdgeHvp<D, NPL == 4 ? 1 : EPL> e;  // NPL = 4: in shared memory (unused here)
  float l11, l21, l31, l22, l32, l33;  // d == 3; d == 2 keeps only l11
  // the anchored node of each slot: K_g (upper triangle) and sigma_g
  float aK[HAS_A ? NPL : 1][HAS_A ? sym_count(D) : 1], asig[HAS_A ? NPL : 1];
};

template <int D, int EPL, int W, int NPL, bool HAS_A>
__device__ void hvp_setup(const Warp<D, EPL, W, NPL>& c, const Anchors<D>& a,
                          const AnchorLane<D, NPL>& al, const float (&Y)[NPL][D],
                          Hvp<D, EPL, NPL, HAS_A>& h) {
  edge_hvp_setup(c, Y, h.e);
  if constexpr (D == 2) {
    const float x11 = nodes_cross(c, Y, Y, 0, 0, false);
    const float x22 = nodes_cross(c, Y, Y, 1, 1, false);
    const float reg = 10.f * kEps * (x11 + x22 + 1e-30f);
    h.l11 = x11 + x22 + reg;
  } else {
    const float x11 = nodes_cross(c, Y, Y, 0, 0, false);
    const float x22 = nodes_cross(c, Y, Y, 1, 1, false);
    const float x33 = nodes_cross(c, Y, Y, 2, 2, false);
    const float x12 = nodes_cross(c, Y, Y, 0, 1, false);
    const float x13 = nodes_cross(c, Y, Y, 0, 2, false);
    const float x23 = nodes_cross(c, Y, Y, 1, 2, false);
    const float reg = 10.f * kEps * (x11 + x22 + x33 + 1e-30f);
    // M = [[x11+x22, x23, -x13], [x23, x11+x33, x12], [-x13, x12, x22+x33]]
    const float m11 = x11 + x22 + reg, m12 = x23, m13 = -x13;
    const float m22 = x11 + x33 + reg, m23 = x12, m33 = x22 + x33 + reg;
    h.l11 = sqrtf(jmax(m11, 1e-30f));
    h.l21 = m12 / h.l11;
    h.l31 = m13 / h.l11;
    h.l22 = sqrtf(jmax(m22 - h.l21 * h.l21, 1e-30f));
    h.l32 = (m23 - h.l31 * h.l21) / h.l22;
    h.l33 = sqrtf(jmax(m33 - h.l31 * h.l31 - h.l32 * h.l32, 1e-30f));
  }
  if constexpr (HAS_A) {
    constexpr int V = 32 / W;
    constexpr int S = sym_count(D);
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
#pragma unroll
      for (int q = 0; q < S; ++q) h.aK[s][q] = 0.f;
      h.asig[s] = 0.f;
    }
    for (int gi = 0; gi < a.nsel; ++gi) {
      const int un = a.node[gi];
      const unsigned act = a.active_rows(al.ybuf, gi);
      if (!__any_sync(kFull, act != 0)) {
        // no active row in the warp: every sum of the group is exactly +0
#pragma unroll
        for (int s = 0; s < NPL; ++s) {
          if (holds(c, s, un)) {
#pragma unroll
            for (int q = 0; q < S; ++q) h.aK[s][q] = 0.f;
            h.asig[s] = 0.f;
          }
        }
        continue;
      }
      float Yu[D], kp[V][S], sp[V];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float x[NPL];
#pragma unroll
        for (int s = 0; s < NPL; ++s) x[s] = Y[s][k];
        Yu[k] = node_value(c, x, un);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sp[v] = 0.f;
#pragma unroll
        for (int q = 0; q < S; ++q) kp[v][q] = 0.f;
        for (unsigned m = (act >> (v * a.T)) & low_bits(a.T); m; m &= m - 1) {
          const int t = __ffs(m) - 1;
          const int r = gi * a.R + layout_lane<W>(c.lane, v) + 32 * t;
          float adY[D], adist, a1, a2;
          a.terms(Yu, r, adY, adist, a1, a2);
          const float ma =
              a.p(2, r) * (a1 > 0.f ? 1.f : 0.f) + a.p(3, r) * (a2 > 0.f ? 1.f : 0.f);
          const float w2 = 2.f * ma;
#pragma unroll
          for (int i = 0; i < D; ++i)
#pragma unroll
            for (int j = i; j < D; ++j)
              kp[v][sym_idx(D, i, j)] = kp[v][sym_idx(D, i, j)] + (w2 * adY[i]) * adY[j];
          sp[v] = sp[v] + (a1 - a2);
        }
      }
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const float sum = seg_sum<W>(kp[0][q], kp[V - 1][q]);
#pragma unroll
        for (int s = 0; s < NPL; ++s)
          if (holds(c, s, un)) h.aK[s][q] = sum;
      }
      const float sum = seg_sum<W>(sp[0], sp[V - 1]);
#pragma unroll
      for (int s = 0; s < NPL; ++s)
        if (holds(c, s, un)) h.asig[s] = sum;
    }
  }
}

// Horizontal projection H <- H - Y Om, Om antisymmetric (tr_pallas.py proj).
template <int D, int EPL, int W, int NPL, bool HAS_A>
__device__ void project(const Warp<D, EPL, W, NPL>& seg, const Hvp<D, EPL, NPL, HAS_A>& h,
                        const float (&Y)[NPL][D], float (&H)[NPL][D]) {
  if constexpr (D == 2) {
    const float c12 = nodes_cross(seg, Y, H, 0, 1, true);
    const float a = c12 / h.l11;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const float P0 = H[s][0] + a * Y[s][1];
      const float P1 = H[s][1] - a * Y[s][0];
      H[s][0] = P0;
      H[s][1] = P1;
    }
  } else {
    const float c12 = nodes_cross(seg, Y, H, 0, 1, true);
    const float c13 = nodes_cross(seg, Y, H, 0, 2, true);
    const float c23 = nodes_cross(seg, Y, H, 1, 2, true);
    const float y1 = c12 / h.l11;
    const float y2 = (c13 - h.l21 * y1) / h.l22;
    const float y3 = (c23 - h.l31 * y1 - h.l32 * y2) / h.l33;
    const float c = y3 / h.l33;
    const float b = (y2 - h.l32 * c) / h.l22;
    const float a = (y1 - h.l21 * b - h.l31 * c) / h.l11;
    // Om = [[0, a, b], [-a, 0, c], [-b, -c, 0]]; P = H - Y Om
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const float P0 = H[s][0] + a * Y[s][1] + b * Y[s][2];
      const float P1 = H[s][1] - a * Y[s][0] + c * Y[s][2];
      const float P2 = H[s][2] - b * Y[s][0] - c * Y[s][1];
      H[s][0] = P0;
      H[s][1] = P1;
      H[s][2] = P2;
    }
  }
}

// Riemannian Hessian-vector product: proj(2 C^T (m dD dY - s dZ)
// + 2 (K_u Z_u - sigma_u Z_u) on each anchored node u).
template <int D, int EPL, int W, int NPL, bool HAS_A>
__device__ void hvp(const Warp<D, EPL, W, NPL>& c, const AnchorLane<D, NPL>& al,
                    const Hvp<D, EPL, NPL, HAS_A>& h, const float (&Y)[NPL][D],
                    const float (&Z)[NPL][D], float (&H)[NPL][D]) {
  edge_hvp(c, h.e, Z, H);
  if constexpr (HAS_A) {
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      if (al.mine[s]) {
        float KZ[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          KZ[i] = h.aK[s][sym_idx(D, i, 0)] * Z[s][0];
#pragma unroll
          for (int j = 1; j < D; ++j) KZ[i] = KZ[i] + h.aK[s][sym_idx(D, i, j)] * Z[s][j];
        }
#pragma unroll
        for (int i = 0; i < D; ++i) H[s][i] = H[s][i] + 2.f * (KZ[i] - h.asig[s] * Z[s][i]);
      }
    }
  }
  project(c, h, Y, H);
}

// Steihaug-Toint truncated CG (tr_pallas.py tcg). Every lane of the warp
// takes part; only segments with `live` set update their results, and the
// loop ends when no segment is left iterating.
template <int D, int EPL, int W, int NPL, bool HAS_A>
__device__ void tcg(const Warp<D, EPL, W, NPL>& c, const AnchorLane<D, NPL>& al,
                    const Hvp<D, EPL, NPL, HAS_A>& h, const float (&Y)[NPL][D],
                    const float (&grad)[NPL][D], float Delta, const Params& P, bool live,
                    float (&eta)[NPL][D], float (&Heta)[NPL][D], int& stop, int& nsteps) {
  float r[NPL][D], delta[NPL][D], Hd[NPL][D], rn[NPL][D];
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      r[s][k] = grad[s][k];
      delta[s][k] = -grad[s][k];
      eta[s][k] = 0.f;
      Heta[s][k] = 0.f;
      rn[s][k] = 0.f;
    }
  }
  const float r_r0 = nodes_dot(c, r, r);
  const float norm_r0 = sqrtf(r_r0);
  const float pow_r0 = P.theta == 1.f ? norm_r0 : powf(norm_r0, P.theta);
  const float target = norm_r0 * jmin(pow_r0, P.kappa);
  float e_Pe = 0.f, e_Pd = 0.f, d_Pd = r_r0, z_r = r_r0;
  stop = kMaxInnerIter;
  nsteps = 0;
  bool on = live;
  for (int j = 0; j < P.maxinner && __any_sync(kFull, on); ++j) {
    hvp(c, al, h, Y, delta, Hd);
    const float d_Hd = nodes_dot(c, delta, Hd);
    const float alpha = z_r / d_Hd;
    const float e_Pe_new = e_Pe + 2.f * alpha * e_Pd + alpha * alpha * d_Pd;
    const float Dsq = Delta * Delta;
    if (on) {
      ++nsteps;
      if (d_Hd <= 0.f || e_Pe_new >= Dsq || !finite(alpha) || !finite(e_Pe_new)) {
        // negative curvature or trust-region boundary: step to the boundary
        const float disc = jmax(e_Pd * e_Pd + d_Pd * (Dsq - e_Pe), 0.f);
        const float tau = (-e_Pd + sqrtf(disc)) / d_Pd;
#pragma unroll
        for (int s = 0; s < NPL; ++s) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            eta[s][k] = eta[s][k] + tau * delta[s][k];
            Heta[s][k] = Heta[s][k] + tau * Hd[s][k];
          }
        }
        stop = d_Hd <= 0.f ? kNegativeCurvature : kExceededTR;
        on = false;
      } else {
#pragma unroll
        for (int s = 0; s < NPL; ++s) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            eta[s][k] = eta[s][k] + alpha * delta[s][k];
            Heta[s][k] = Heta[s][k] + alpha * Hd[s][k];
            rn[s][k] = r[s][k] + alpha * Hd[s][k];
          }
        }
      }
    }
    const float r_r = nodes_dot(c, rn, rn);
    if (on) {
      if (j >= P.mininner && sqrtf(r_r) <= target) {
        stop = kReachedTarget;
        on = false;
      } else {
        const float beta = r_r / z_r;
#pragma unroll
        for (int s = 0; s < NPL; ++s) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            delta[s][k] = -rn[s][k] + beta * delta[s][k];
            r[s][k] = rn[s][k];
          }
        }
        e_Pd = beta * (e_Pd + alpha * d_Pd);
        d_Pd = r_r + beta * beta * d_Pd;
        e_Pe = e_Pe_new;
        z_r = r_r;
      }
    }
  }
}

template <int D, int EPL, int W, int NPL, bool HAS_A>
__device__ __forceinline__ void tr_instance(Problem pr, Params P) {
  using Seg = Warp<D, EPL, W, NPL>;
  __shared__ typename Seg::Tables s_t;
  __shared__ float s_w[kWarpsPerBlock][D * Seg::kME];
  // anchor tables: centers [D][A], parameters [4][A], group nodes [a_nsel],
  // then each warp's row masks [3][a_nsel][32]; then, at NPL = 4, each
  // warp's Seg::kWide floats of edge state
  extern __shared__ float s_anchor[];

  load_edge_tables(s_t, pr.ei, pr.ej, pr.epar, pr.rowptr, pr.inc, pr.N, pr.E);
  const int warp = threadIdx.x >> 5;
  Anchors<D> a{};
  if constexpr (HAS_A) {
    const int A = pr.A;
    for (int t = threadIdx.x; t < (D + 4) * A; t += blockDim.x)
      s_anchor[t] = t < D * A ? pr.acen[t] : pr.apar[t - D * A];
    int* s_anode = reinterpret_cast<int*>(s_anchor + (D + 4) * A);
    for (int t = threadIdx.x; t < pr.a_nsel; t += blockDim.x) s_anode[t] = pr.anode[t];
    a.cen = s_anchor;
    a.par = s_anchor + D * A;
    a.node = s_anode;
    a.mask = reinterpret_cast<unsigned*>(s_anode + pr.a_nsel) + warp * 3 * pr.a_nsel * 32;
    a.A = A;
    a.nsel = pr.a_nsel;
    a.R = pr.a_R;
    a.T = (pr.a_R + 31) / 32;
    a.near = P.a_near;
  }
  __syncthreads();

  Seg c;
  float* wide = nullptr;
  if constexpr (Seg::kShared)
    wide = s_anchor + anchor_words(D, pr.A, pr.a_nsel) + warp * Seg::kWide;
  c.init_tables(s_t, s_w[warp], pr.N, pr.E, wide);
  const int N = pr.N;
  AnchorLane<D, NPL> al{};
  if constexpr (HAS_A) {
    for (int gi = 0; gi < a.nsel; ++gi) {
#pragma unroll
      for (int s = 0; s < NPL; ++s) al.mine[s] = al.mine[s] || holds(c, s, a.node[gi]);
    }
#pragma unroll
    for (int v = 0; v < 32 / W; ++v) {
      const int l = layout_lane<W>(c.lane, v);
      const int n = l < a.R ? min((a.R - l + 31) / 32, a.T) : 0;
      al.all |= low_bits(n) << (v * a.T);
    }
  }

  // this segment's instance
  const int b = (blockIdx.x * kWarpsPerBlock + warp) * (32 / W) + c.base / W;
  const bool live = b < pr.B;
  float Y[NPL][D];
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const bool has = c.has(s);
#pragma unroll
    for (int k = 0; k < D; ++k)
      Y[s][k] = live && has ? pr.Y0[((size_t)b * N + c.lane + 32 * s) * D + k] : 0.f;
  }
  if (live) c.load_goal(pr.dgoal, pr.dg_stride, b);
  if constexpr (HAS_A) {
#pragma unroll
    for (int s = 0; s < NPL; ++s)
#pragma unroll
      for (int k = 0; k < D; ++k) al.Yref[s][k] = __int_as_float(0x7fc00000);  // NaN: a full pass
  }

  float r_floor = 0.f;
  if (P.res_tol > 0.f) {
    // per-lane floor of the relative residual: the mean equality-edge
    // squared length
    float cnt[2] = {0.f, 0.f}, acc[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = c.edge_at(j);
      if (e >= 0) {
        const bool hi = Seg::hi(j);
        cnt[hi] = cnt[hi] + c.p(0, e);
        acc[hi] = acc[hi] + c.p(0, e) * c.goal(j);
      }
    }
    r_floor = seg_sum<W>(acc[0], acc[1]) / jmax(seg_sum<W>(cnt[0], cnt[1]), 1.f);
  }

  // ---------------- outer TR loop (tr_pallas.py:410-513) ----------------
  // Every lane takes part in every iteration the warp runs; `run` marks the
  // segments still iterating, and only they update their state.
  float f, rmax, g[NPL][D];
  cost_grad<D, EPL, W, NPL, HAS_A>(c, a, al, Y, P.res_tol, r_floor, f, g, rmax);
  if constexpr (HAS_A) al.ybuf ^= 1;
  float norm_g = sqrtf(nodes_dot(c, g, g));
  float Delta = P.Delta0;
  float fx_ref = f;
  int iters = 0, ninner = 0;
  bool run = live && P.maxiter > 0 &&
             !(norm_g < P.mingradnorm || (P.res_tol > 0.f && rmax < P.res_tol));

  while (__any_sync(kFull, run)) {
    Hvp<D, EPL, NPL, HAS_A> h;
    hvp_setup(c, a, al, Y, h);
    float eta[NPL][D], Heta[NPL][D];
    int stop, nsteps;
    tcg(c, al, h, Y, g, Delta, P, run, eta, Heta, stop, nsteps);

    float Yp[NPL][D], gp[NPL][D], fp, rmaxp;
#pragma unroll
    for (int s = 0; s < NPL; ++s)
#pragma unroll
      for (int q = 0; q < D; ++q) Yp[s][q] = Y[s][q] + eta[s][q];
    cost_grad<D, EPL, W, NPL, HAS_A>(c, a, al, Yp, P.res_tol, r_floor, fp, gp, rmaxp);
    const float norm_gp = sqrtf(nodes_dot(c, gp, gp));
    const float g_eta = nodes_dot(c, g, eta);
    const float eta_Heta = nodes_dot(c, eta, Heta);
    if (run) {
      const float rho_reg = jmax(1.f, fabsf(f)) * kEps * P.rho_regularization;
      const float rhonum = f - fp + rho_reg;
      const float rhoden = -g_eta - 0.5f * eta_Heta + rho_reg;
      const bool model_decreased = rhoden >= 0.f;
      const float rho = rhonum / rhoden;
      const bool shrink = rho < 0.25f || !model_decreased || rho != rho;
      const bool grow = !shrink && rho > 0.75f &&
                        (stop == kNegativeCurvature || stop == kExceededTR);
      const float Delta_new =
          shrink ? Delta / 4.f : (grow ? jmin(2.f * Delta, P.Delta_bar) : Delta);

      if (model_decreased && rho > P.rho_prime) {
#pragma unroll
        for (int s = 0; s < NPL; ++s)
#pragma unroll
          for (int q = 0; q < D; ++q) {
            Y[s][q] = Yp[s][q];
            g[s][q] = gp[s][q];
          }
        f = fp;
        norm_g = norm_gp;
        rmax = rmaxp;
        if constexpr (HAS_A) al.ybuf ^= 1;
      }
      Delta = Delta_new;
      bool done = norm_g < P.mingradnorm || (P.res_tol > 0.f && rmax < P.res_tol);
      if (P.plateau_every > 0 && (iters + 1) % P.plateau_every == 0) {
        // cost-plateau stop against the checkpoint plateau_every iterations ago
        done = done || (fx_ref - f) <= (P.plateau_rtol * f + P.plateau_atol);
        fx_ref = f;
      }
      ++iters;
      ninner += nsteps;
      run = !done && iters < P.maxiter;
    }
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      if (c.has(s)) {
#pragma unroll
        for (int q = 0; q < D; ++q) pr.Yout[((size_t)b * N + c.lane + 32 * s) * D + q] = Y[s][q];
      }
    }
    if (c.lane == 0) {
      pr.cost[b] = f;
      pr.gradnorm[b] = norm_g;
      pr.iters[b] = iters;
      pr.ninner[b] = ninner;
    }
  }
}

template <int D, int EPL, int W, int NPL, bool HAS_A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) tr_kernel(Problem pr, Params P) {
  tr_instance<D, EPL, W, NPL, HAS_A>(pr, P);
}

// Four node slots a lane, with a floor of one block an SM: without it ptxas
// held some of these instances to 128 or 168 registers and spilled.
template <int D, int EPL, bool HAS_A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
    tr_wide_kernel(Problem pr, Params P) {
  tr_instance<D, EPL, 32, 4, HAS_A>(pr, P);
}

// Whether two instances share a warp: N <= 16, E <= 64 and the 16-lane
// segment's row slots of a group fit in a 32-bit mask.
inline bool paired(int N, int E, int A, int a_R) {
  return N <= 16 && E <= 64 && (A == 0 || (a_R + 31) / 32 <= 16);
}

inline size_t anchor_smem(int D, int A, int a_nsel) { return anchor_words(D, A, a_nsel) * 4; }

// Launch (when go is true) one segment per instance; info[0..2] = blocks
// launched, blocks resident on the card at once, instances per block.
template <int D, int EPL, int W, int NPL, bool HAS_A>
int launch(const Problem& pr, const Params& P, cudaStream_t stream, bool go, int* info) {
  void (*kern)(Problem, Params);
  if constexpr (NPL == 4)
    kern = tr_wide_kernel<D, EPL, HAS_A>;
  else
    kern = tr_kernel<D, EPL, W, NPL, HAS_A>;
  const size_t smem = anchor_smem(D, pr.A, pr.a_nsel) +
                      (size_t)kWarpsPerBlock * Warp<D, EPL, W, NPL>::kWide * 4;
  cudaError_t err = cudaSuccess;
  if (smem > 0)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kWarpsPerBlock * 32, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_block = kWarpsPerBlock * (32 / W);
  const int blocks = (pr.B + per_block - 1) / per_block;
  if (info) {
    info[0] = blocks;
    info[1] = per_sm * sms;
    info[2] = per_block;
  }
  if (!go) return 0;
  kern<<<blocks, kWarpsPerBlock * 32, smem, stream>>>(pr, P);
  return static_cast<int>(cudaGetLastError());
}

// The instances of one W and NPL at D and epl, with and without anchors
// (cudaErrorInvalidValue for an epl outside [LO, HI] or another D).
template <int W, int NPL, int LO, int HI>
int launch_range(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s, bool go,
                 int* info) {
  if constexpr (LO > HI) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (epl != LO) return launch_range<W, NPL, LO + 1, HI>(pr, D, epl, P, s, go, info);
    if (D == 3)
      return pr.A > 0 ? launch<3, LO, W, NPL, true>(pr, P, s, go, info)
                      : launch<3, LO, W, NPL, false>(pr, P, s, go, info);
    if (D == 2)
      return pr.A > 0 ? launch<2, LO, W, NPL, true>(pr, P, s, go, info)
                      : launch<2, LO, W, NPL, false>(pr, P, s, go, info);
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The instances past 32 nodes or 128 edges, one translation unit each
// (csrc/tr_solve_*.cu), so that nvcc builds them in parallel.
int launch_e256(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s, bool go,
                int* info);
int launch_n64(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s, bool go,
               int* info);
int launch_n128(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s, bool go,
                int* info);

}  // namespace graphik
