// Batched Riemannian trust-region solve of the EDM-completion problem, for
// NVIDIA Hopper (sm_90a): one instance per half warp when it fits there,
// else one per warp.
//
// Replaces graphik_tpu/ops/tr_pallas.py::_tr_kernel, the fused Pallas TPU
// kernel that runs the whole outer TR loop plus Steihaug-Toint truncated CG
// for a tile of instances: its anchor-free branch as tr_kernel<D, EPL, W,
// false> and its has_anchors branch (the obstacle reduction: hinge terms of
// robot nodes against constant anchor points) as tr_kernel<D, EPL, W,
// true>. It computes the same thing statement for statement (stop rules,
// rho regularization, radius updates, the reduced 3x3 Lyapunov-Cholesky
// horizontal projection, per-lane counters); graphik_tpu_torch/ops/
// tr_solve.py holds the plain torch transcription the kernel is checked
// against, in the kernel's summation order.
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
//   Templates on D (2 or 3), EPL = ceil(E / W) <= 4 and W; N <= 32.
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
//
// The entry point allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include "edge_warp.cuh"

namespace {

using namespace graphik;

constexpr int kMaxA = 1024;  // anchor rows the build takes (the table scene: 624)

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
template <int D>
struct AnchorLane {
  bool mine;       // this lane's node has a group
  unsigned all;    // the row slots of a group that hold rows
  int ybuf;        // the active-row buffer of the iterate Y (the other: the trial point)
  float Yref[D];   // node lanes: the point of the group's last full pass
};

// The 32-lane layout's lane of this lane's slot v (a 16-lane segment holds
// lanes l and l + 16); row slot bit v * T + t is group row lane + 32 t.
template <int W>
__device__ __forceinline__ int layout_lane(int lane, int v) {
  return W == 16 ? lane + 16 * v : lane;
}

// Cost f, Euclidean gradient g and (when res_tol > 0) the max relative
// residual, edge and anchor terms (tr_pallas.py cost_and_grad), at a trial
// point Y: records the rows active there in the buffer that is not Y's.
template <int D, int EPL, int W, bool HAS_A>
__device__ void cost_grad(const Warp<D, EPL, W>& c, const Anchors<D>& a, AnchorLane<D>& al,
                          const float (&Y)[D], float res_tol, float r_floor, float& f,
                          float (&g)[D], float& rmax) {
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
      float Yu[D], dY[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        Yu[k] = __shfl_sync(kFull, Y[k], c.base + un);
        dY[k] = Y[k] - al.Yref[k];
      }
      // how far the group's node moved since the group's last full pass
      const float moved = __shfl_sync(kFull, sqrtf(dot(dY, dY)), c.base + un);
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
        if (c.lane == un) {
#pragma unroll
          for (int k = 0; k < D; ++k) al.Yref[k] = Y[k];
        }
      }
      if (__any_sync(kFull, act != 0)) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float G = seg_sum<W>(wp[0][k], wp[V - 1][k]);
          if (c.lane == un) g[k] = g[k] - 2.f * G;
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
template <int D, int EPL, bool HAS_A>
struct Hvp {
  EdgeHvp<D, EPL> e;
  float l11, l21, l31, l22, l32, l33;  // d == 3; d == 2 keeps only l11
  float aK[HAS_A ? sym_count(D) : 1], asig;
};

template <int D, int EPL, int W, bool HAS_A>
__device__ void hvp_setup(const Warp<D, EPL, W>& c, const Anchors<D>& a,
                          const AnchorLane<D>& al, const float (&Y)[D], Hvp<D, EPL, HAS_A>& h) {
  edge_hvp_setup(c, Y, h.e);
  if constexpr (D == 2) {
    const float x11 = node_sum<W>(Y[0] * Y[0]);
    const float x22 = node_sum<W>(Y[1] * Y[1]);
    const float reg = 10.f * kEps * (x11 + x22 + 1e-30f);
    h.l11 = x11 + x22 + reg;
  } else {
    const float x11 = node_sum<W>(Y[0] * Y[0]);
    const float x22 = node_sum<W>(Y[1] * Y[1]);
    const float x33 = node_sum<W>(Y[2] * Y[2]);
    const float x12 = node_sum<W>(Y[0] * Y[1]);
    const float x13 = node_sum<W>(Y[0] * Y[2]);
    const float x23 = node_sum<W>(Y[1] * Y[2]);
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
    for (int q = 0; q < S; ++q) h.aK[q] = 0.f;
    h.asig = 0.f;
    for (int gi = 0; gi < a.nsel; ++gi) {
      const int un = a.node[gi];
      const unsigned act = a.active_rows(al.ybuf, gi);
      if (!__any_sync(kFull, act != 0)) {
        // no active row in the warp: every sum of the group is exactly +0
        if (c.lane == un) {
#pragma unroll
          for (int q = 0; q < S; ++q) h.aK[q] = 0.f;
          h.asig = 0.f;
        }
        continue;
      }
      float Yu[D], kp[V][S], sp[V];
#pragma unroll
      for (int k = 0; k < D; ++k) Yu[k] = __shfl_sync(kFull, Y[k], c.base + un);
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
        const float s = seg_sum<W>(kp[0][q], kp[V - 1][q]);
        if (c.lane == un) h.aK[q] = s;
      }
      const float s = seg_sum<W>(sp[0], sp[V - 1]);
      if (c.lane == un) h.asig = s;
    }
  }
}

// Horizontal projection H <- H - Y Om, Om antisymmetric (tr_pallas.py proj).
template <int D, int EPL, int W, bool HAS_A>
__device__ void project(const Hvp<D, EPL, HAS_A>& h, const float (&Y)[D], float (&H)[D]) {
  if constexpr (D == 2) {
    const float c12 = node_sum<W>(Y[0] * H[1] - H[0] * Y[1]);
    const float a = c12 / h.l11;
    const float P0 = H[0] + a * Y[1];
    const float P1 = H[1] - a * Y[0];
    H[0] = P0;
    H[1] = P1;
  } else {
    const float c12 = node_sum<W>(Y[0] * H[1] - H[0] * Y[1]);
    const float c13 = node_sum<W>(Y[0] * H[2] - H[0] * Y[2]);
    const float c23 = node_sum<W>(Y[1] * H[2] - H[1] * Y[2]);
    const float y1 = c12 / h.l11;
    const float y2 = (c13 - h.l21 * y1) / h.l22;
    const float y3 = (c23 - h.l31 * y1 - h.l32 * y2) / h.l33;
    const float c = y3 / h.l33;
    const float b = (y2 - h.l32 * c) / h.l22;
    const float a = (y1 - h.l21 * b - h.l31 * c) / h.l11;
    // Om = [[0, a, b], [-a, 0, c], [-b, -c, 0]]; P = H - Y Om
    const float P0 = H[0] + a * Y[1] + b * Y[2];
    const float P1 = H[1] - a * Y[0] + c * Y[2];
    const float P2 = H[2] - b * Y[0] - c * Y[1];
    H[0] = P0;
    H[1] = P1;
    H[2] = P2;
  }
}

// Riemannian Hessian-vector product: proj(2 C^T (m dD dY - s dZ)
// + 2 (K_u Z_u - sigma_u Z_u) on each anchored node u).
template <int D, int EPL, int W, bool HAS_A>
__device__ void hvp(const Warp<D, EPL, W>& c, const AnchorLane<D>& al,
                    const Hvp<D, EPL, HAS_A>& h, const float (&Y)[D], const float (&Z)[D],
                    float (&H)[D]) {
  edge_hvp(c, h.e, Z, H);
  if constexpr (HAS_A) {
    if (al.mine) {
      float KZ[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        KZ[i] = h.aK[sym_idx(D, i, 0)] * Z[0];
#pragma unroll
        for (int j = 1; j < D; ++j) KZ[i] = KZ[i] + h.aK[sym_idx(D, i, j)] * Z[j];
      }
#pragma unroll
      for (int i = 0; i < D; ++i) H[i] = H[i] + 2.f * (KZ[i] - h.asig * Z[i]);
    }
  }
  project<D, EPL, W, HAS_A>(h, Y, H);
}

// Steihaug-Toint truncated CG (tr_pallas.py tcg). Every lane of the warp
// takes part; only segments with `live` set update their results, and the
// loop ends when no segment is left iterating.
template <int D, int EPL, int W, bool HAS_A>
__device__ void tcg(const Warp<D, EPL, W>& c, const AnchorLane<D>& al,
                    const Hvp<D, EPL, HAS_A>& h, const float (&Y)[D], const float (&grad)[D],
                    float Delta, const Params& P, bool live, float (&eta)[D], float (&Heta)[D],
                    int& stop, int& nsteps) {
  float r[D], delta[D], Hd[D], rn[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    r[k] = grad[k];
    delta[k] = -grad[k];
    eta[k] = 0.f;
    Heta[k] = 0.f;
    rn[k] = 0.f;
  }
  const float r_r0 = node_sum<W>(dot(r, r));
  const float norm_r0 = sqrtf(r_r0);
  const float pow_r0 = P.theta == 1.f ? norm_r0 : powf(norm_r0, P.theta);
  const float target = norm_r0 * jmin(pow_r0, P.kappa);
  float e_Pe = 0.f, e_Pd = 0.f, d_Pd = r_r0, z_r = r_r0;
  stop = kMaxInnerIter;
  nsteps = 0;
  bool on = live;
  for (int j = 0; j < P.maxinner && __any_sync(kFull, on); ++j) {
    hvp(c, al, h, Y, delta, Hd);
    const float d_Hd = node_sum<W>(dot(delta, Hd));
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
        for (int k = 0; k < D; ++k) {
          eta[k] = eta[k] + tau * delta[k];
          Heta[k] = Heta[k] + tau * Hd[k];
        }
        stop = d_Hd <= 0.f ? kNegativeCurvature : kExceededTR;
        on = false;
      } else {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          eta[k] = eta[k] + alpha * delta[k];
          Heta[k] = Heta[k] + alpha * Hd[k];
          rn[k] = r[k] + alpha * Hd[k];
        }
      }
    }
    const float r_r = node_sum<W>(dot(rn, rn));
    if (on) {
      if (j >= P.mininner && sqrtf(r_r) <= target) {
        stop = kReachedTarget;
        on = false;
      } else {
        const float beta = r_r / z_r;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          delta[k] = -rn[k] + beta * delta[k];
          r[k] = rn[k];
        }
        e_Pd = beta * (e_Pd + alpha * d_Pd);
        d_Pd = r_r + beta * beta * d_Pd;
        e_Pe = e_Pe_new;
        z_r = r_r;
      }
    }
  }
}

template <int D, int EPL, int W, bool HAS_A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) tr_kernel(Problem pr, Params P) {
  __shared__ EdgeTables s_t;
  __shared__ float s_w[kWarpsPerBlock][D * kMaxE];
  // anchor tables: centers [D][A], parameters [4][A], group nodes [a_nsel],
  // then each warp's row masks [3][a_nsel][32]
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

  Warp<D, EPL, W> c;
  c.init_tables(s_t, s_w[warp], pr.N, pr.E);
  const int N = pr.N;
  AnchorLane<D> al{};
  if constexpr (HAS_A) {
    for (int gi = 0; gi < a.nsel; ++gi) al.mine = al.mine || a.node[gi] == c.lane;
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
  float Y[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    Y[k] = live && c.has_node ? pr.Y0[((size_t)b * N + c.lane) * D + k] : 0.f;
  if (live) c.load_goal(pr.dgoal, pr.dg_stride, b);
  if constexpr (HAS_A) {
#pragma unroll
    for (int k = 0; k < D; ++k) al.Yref[k] = __int_as_float(0x7fc00000);  // NaN: a full pass
  }

  float r_floor = 0.f;
  if (P.res_tol > 0.f) {
    // per-lane floor of the relative residual: the mean equality-edge
    // squared length
    float cnt[2] = {0.f, 0.f}, acc[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (c.edge[j] >= 0) {
        const bool hi = Warp<D, EPL, W>::hi(j);
        cnt[hi] = cnt[hi] + c.p(0, c.edge[j]);
        acc[hi] = acc[hi] + c.p(0, c.edge[j]) * c.dg[j];
      }
    }
    r_floor = seg_sum<W>(acc[0], acc[1]) / jmax(seg_sum<W>(cnt[0], cnt[1]), 1.f);
  }

  // ---------------- outer TR loop (tr_pallas.py:410-513) ----------------
  // Every lane takes part in every iteration the warp runs; `run` marks the
  // segments still iterating, and only they update their state.
  float f, rmax, g[D];
  cost_grad<D, EPL, W, HAS_A>(c, a, al, Y, P.res_tol, r_floor, f, g, rmax);
  if constexpr (HAS_A) al.ybuf ^= 1;
  float norm_g = sqrtf(node_sum<W>(dot(g, g)));
  float Delta = P.Delta0;
  float fx_ref = f;
  int iters = 0, ninner = 0;
  bool run = live && P.maxiter > 0 &&
             !(norm_g < P.mingradnorm || (P.res_tol > 0.f && rmax < P.res_tol));

  while (__any_sync(kFull, run)) {
    Hvp<D, EPL, HAS_A> h;
    hvp_setup(c, a, al, Y, h);
    float eta[D], Heta[D];
    int stop, nsteps;
    tcg(c, al, h, Y, g, Delta, P, run, eta, Heta, stop, nsteps);

    float Yp[D], gp[D], fp, rmaxp;
#pragma unroll
    for (int q = 0; q < D; ++q) Yp[q] = Y[q] + eta[q];
    cost_grad<D, EPL, W, HAS_A>(c, a, al, Yp, P.res_tol, r_floor, fp, gp, rmaxp);
    const float norm_gp = sqrtf(node_sum<W>(dot(gp, gp)));
    const float g_eta = node_sum<W>(dot(g, eta));
    const float eta_Heta = node_sum<W>(dot(eta, Heta));
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
        for (int q = 0; q < D; ++q) {
          Y[q] = Yp[q];
          g[q] = gp[q];
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
    if (c.has_node) {
#pragma unroll
      for (int q = 0; q < D; ++q) pr.Yout[((size_t)b * N + c.lane) * D + q] = Y[q];
    }
    if (c.lane == 0) {
      pr.cost[b] = f;
      pr.gradnorm[b] = norm_g;
      pr.iters[b] = iters;
      pr.ninner[b] = ninner;
    }
  }
}

// Whether two instances share a warp: N <= 16, E <= 64 and the 16-lane
// segment's row slots of a group fit in a 32-bit mask.
bool paired(int N, int E, int A, int a_R) {
  return N <= 16 && E <= 64 && (A == 0 || (a_R + 31) / 32 <= 16);
}

size_t anchor_smem(int D, int A, int a_nsel) {
  return A > 0 ? ((size_t)(D + 4) * A + a_nsel + (size_t)kWarpsPerBlock * 3 * a_nsel * 32) * 4
               : 0;
}

// Launch (when go is true) one segment per instance; info[0..2] = blocks
// launched, blocks resident on the card at once, instances per block.
template <int D, int EPL, int W, bool HAS_A>
int launch(const Problem& pr, const Params& P, cudaStream_t stream, bool go, int* info) {
  auto kern = tr_kernel<D, EPL, W, HAS_A>;
  const size_t smem = anchor_smem(D, pr.A, pr.a_nsel);
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

int dispatch(const Problem& pr, int D, const Params& P, cudaStream_t s, bool go, int* info) {
  if (pr.B < 1 || pr.N < 1 || pr.N > kMaxN || pr.E < 1 || pr.E > kMaxE || pr.dg_stride < pr.E)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pr.A < 0 || pr.A > kMaxA ||
      (pr.A > 0 && (pr.a_nsel < 1 || pr.a_nsel > pr.N || pr.a_R < 1 ||
                    pr.a_nsel * pr.a_R != pr.A)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = paired(pr.N, pr.E, pr.A, pr.a_R);
  const int epl = two ? (pr.E + 15) / 16 : (pr.E + 31) / 32;
#define GRAPHIK_TR_CASE(DD, EE)                                                            \
  if (D == DD && epl == EE) {                                                              \
    if (two)                                                                               \
      return pr.A > 0 ? launch<DD, EE, 16, true>(pr, P, s, go, info)                       \
                      : launch<DD, EE, 16, false>(pr, P, s, go, info);                     \
    return pr.A > 0 ? launch<DD, EE, 32, true>(pr, P, s, go, info)                         \
                    : launch<DD, EE, 32, false>(pr, P, s, go, info);                       \
  }
  GRAPHIK_TR_CASE(3, 1) GRAPHIK_TR_CASE(3, 2) GRAPHIK_TR_CASE(3, 3) GRAPHIK_TR_CASE(3, 4)
  GRAPHIK_TR_CASE(2, 1) GRAPHIK_TR_CASE(2, 2) GRAPHIK_TR_CASE(2, 3) GRAPHIK_TR_CASE(2, 4)
#undef GRAPHIK_TR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// A == 0 runs the anchor-free kernel; A > 0 takes the anchor tables: acen
// (D, A) and apar (4, A) row-major f32, anode (a_nsel,) int32, with
// A == a_nsel * a_R (group g is rows g * a_R .. (g + 1) * a_R - 1).
// a_near: the skip bound's reach in the anchors' distance unit (0
// evaluates every row).
extern "C" int graphik_tr_solve(
    const float* Y0, const float* dgoal, int dg_stride, const int* ei, const int* ej,
    const float* epar, const int* rowptr, const int* inc, const float* acen,
    const float* apar, const int* anode, float* Yout, float* cost,
    float* gradnorm, int* iters, int* ninner, int B, int N, int D, int E, int A, int a_nsel,
    int a_R, int maxiter, int maxinner, int mininner, int plateau_every, float mingradnorm,
    float kappa, float theta, float rho_prime, float rho_regularization, float Delta_bar,
    float Delta0, float plateau_rtol, float plateau_atol, float res_tol, float a_near,
    void* stream) {
  const Problem pr{Y0, dgoal, dg_stride, ei, ej, epar, rowptr, inc, acen, apar, anode,
                   Yout, cost, gradnorm, iters, ninner, B, N, E, A, a_nsel, a_R};
  const Params P{maxiter, maxinner, mininner, plateau_every, mingradnorm, kappa,
                 theta, rho_prime, rho_regularization, Delta_bar, Delta0,
                 plateau_rtol, plateau_atol, res_tol, a_near};
  return dispatch(pr, D, P, static_cast<cudaStream_t>(stream), true, nullptr);
}

// The launch shape graphik_tr_solve would use for these sizes: info[0..3] =
// blocks launched, blocks resident on the card, instances per block, and 1
// when two instances share a warp.
extern "C" int graphik_tr_shape(int B, int N, int D, int E, int A, int a_nsel, int a_R,
                                int* info) {
  Problem pr{};
  pr.B = B;
  pr.N = N;
  pr.E = E;
  pr.dg_stride = E;
  pr.A = A;
  pr.a_nsel = a_nsel;
  pr.a_R = a_R;
  info[3] = paired(N, E, A, a_R) ? 1 : 0;
  return dispatch(pr, D, Params{}, nullptr, false, info);
}
