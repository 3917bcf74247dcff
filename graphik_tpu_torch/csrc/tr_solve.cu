// Batched Riemannian trust-region solve of the EDM-completion problem, one
// warp per instance, for NVIDIA Hopper (sm_90a).
//
// Replaces graphik_tpu/ops/tr_pallas.py::_tr_kernel, the fused Pallas TPU
// kernel that runs the whole outer TR loop plus Steihaug-Toint truncated CG
// for a tile of instances: its anchor-free branch as tr_kernel<D, EPL,
// false> and its has_anchors branch (the obstacle reduction: hinge terms of
// robot nodes against constant anchor points) as tr_kernel<D, EPL, true>.
// It computes the same thing statement for statement (stop rules, rho
// regularization, radius updates, the reduced 3x3 Lyapunov-Cholesky
// horizontal projection, per-lane counters); graphik_tpu_torch/ops/
// tr_solve.py holds the plain torch transcription the kernel is checked
// against, in the kernel's summation order.
//
// What bounds it on the card. One UR10 instance is N = 16 nodes x d = 3
// coordinates and E = 64 edges: every tCG step is a Hessian-vector product
// (2 gathers and 1 scatter over 64 edges, ~1k flops) plus 5 dot-product
// reductions over 48 numbers, and each depends on the previous one. The work
// is a long chain of tiny dependent steps per instance: latency of the
// reductions and of the scatter's shared-memory round trip bounds it, not
// bytes (inputs and outputs are ~1 KB per instance, read and written once)
// and not flops. The table scene adds A = 624 anchor rows (600 live) on 6
// nodes, evaluated twice per outer iteration.
//
// Design, and why.
// * The TPU kernel puts instances on the 128-wide lane axis and drives a
//   tile with one loop whose trip count is set by its slowest lane. Here a
//   warp owns one instance and runs its own loops: every lane of the warp
//   takes the same branches (all branch conditions come from butterfly
//   reductions), a finished instance frees its warp at once, and no lane
//   masks are needed. Per-instance loops reproduce the tile loop exactly
//   because lanes of the tile never interact and a live lane's iteration
//   count equals the tile's global counter (so the plateau check on
//   (k+1) % plateau_every holds).
// * The edge machinery (csrc/edge_warp.cuh): lane i < N holds node i's
//   coordinates; lanes gather edge endpoints with shuffles and scatter
//   C^T w through a per-warp shared buffer. The edge tables and incidence
//   CSR are loaded into shared memory once per block. Templates on D
//   (2 or 3) and EPL = ceil(E / 32) <= 4; N <= 32.
// * Anchors (HAS_A). The anchor rows come grouped by node (group g: a_R
//   rows of node u_g), and a group's 100 live rows all fall on one node.
//   They are staged in dynamic shared memory once per block (centers, 4
//   parameters, group nodes; ~17.5 KB for the table scene). Each group's
//   rows are spread over the 32 lanes (row l + 32 t on lane l), and the
//   group's sum is one butterfly taken by the node lane - the TPU kernel's
//   a_reduce block row-sums. Cost, gradient and residual are row-wise, once
//   per outer step. The Hessian-vector product needs no per-row work in
//   tCG: the centers are constant, so every row of group g has adZ = Z_u
//   and its term is exactly 2 (K_g Z_u - sigma_g Z_u) with
//   K_g = sum_r 2 ma_r adY_r adY_r^T (symmetric d x d) and
//   sigma_g = sum_r sa_r, formed once per outer iteration in hvp_setup and
//   held by the node lane. That reassociates the TPU kernel's row sum; the
//   plain version does the same.
// * HAS_A = false compiles none of the anchor code, so the UR10 instance
//   is the kernel it was before anchors existed.
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

struct Params {
  int maxiter, maxinner, mininner, plateau_every;
  float mingradnorm, kappa, theta, rho_prime, rho_regularization;
  float Delta_bar, Delta0, plateau_rtol, plateau_atol, res_tol;
};

// Entries of a symmetric D x D matrix kept as its upper triangle.
__host__ __device__ constexpr int sym_count(int D) { return D * (D + 1) / 2; }
__host__ __device__ constexpr int sym_idx(int D, int i, int j) {
  return i <= j ? i * D - i * (i - 1) / 2 + (j - i) : j * D - j * (j - 1) / 2 + (i - j);
}

// The block's anchor tables in shared memory, plus this lane's group.
template <int D>
struct Anchors {
  const float* cen;   // [D][A]
  const float* par;   // [4][A]: apsi_L, apsi_U, aL_mask, aU_mask
  const int* node;    // [nsel]: the node of each group
  int A, nsel, R;
  bool mine;          // this lane's node has a group

  __device__ float p(int which, int r) const { return par[which * A + r]; }

  // Hinge terms of anchor row r at node position Yu.
  __device__ void terms(const float (&Yu)[D], int r, float (&adY)[D], float& a1,
                        float& a2) const {
#pragma unroll
    for (int k = 0; k < D; ++k) adY[k] = Yu[k] - cen[k * A + r];
    const float adist = dot(adY, adY);
    a1 = p(2, r) * jmax(p(0, r) - adist, 0.f);
    a2 = p(3, r) * jmax(adist - p(1, r), 0.f);
  }
};

// Cost f, Euclidean gradient g and (when res_tol > 0) the max relative
// residual, edge and anchor terms (tr_pallas.py cost_and_grad).
template <int D, int EPL, bool HAS_A>
__device__ void cost_grad(const Warp<D, EPL>& c, const Anchors<D>& a, const float (&Y)[D],
                          float res_tol, float r_floor, float& f, float (&g)[D], float& rmax) {
  float rpart;
  c.cost_grad_edges(Y, res_tol, r_floor, f, g, rpart);
  if constexpr (!HAS_A) {
    rmax = res_tol > 0.f ? warp_max(rpart) : 0.f;
    c.scatter(-2.f, g);
  } else {
    c.scatter(-2.f, g);
    float fa = 0.f;
    for (int gi = 0; gi < a.nsel; ++gi) {
      const int u = a.node[gi];
      float Yu[D], wp[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        Yu[k] = __shfl_sync(kFull, Y[k], u);
        wp[k] = 0.f;
      }
      for (int rr = c.lane; rr < a.R; rr += 32) {
        const int r = gi * a.R + rr;
        float adY[D], a1, a2;
        a.terms(Yu, r, adY, a1, a2);
        fa = fa + (a1 * a1 + a2 * a2);
        const float sa = a1 - a2;
#pragma unroll
        for (int k = 0; k < D; ++k) wp[k] = wp[k] + sa * adY[k];
        if (res_tol > 0.f)
          rpart = jmax(rpart, jmax(a1 / jmax(a.p(0, r), r_floor), a2 / jmax(a.p(1, r), r_floor)));
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float G = warp_sum(wp[k]);
        if (c.lane == u) g[k] = g[k] - 2.f * G;
      }
    }
    f = f + warp_sum(fa);
    rmax = res_tol > 0.f ? warp_max(rpart) : 0.f;
  }
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

template <int D, int EPL, bool HAS_A>
__device__ void hvp_setup(const Warp<D, EPL>& c, const Anchors<D>& a, const float (&Y)[D],
                          Hvp<D, EPL, HAS_A>& h) {
  edge_hvp_setup(c, Y, h.e);
  if constexpr (D == 2) {
    const float x11 = warp_sum(Y[0] * Y[0]);
    const float x22 = warp_sum(Y[1] * Y[1]);
    const float reg = 10.f * kEps * (x11 + x22 + 1e-30f);
    h.l11 = x11 + x22 + reg;
  } else {
    const float x11 = warp_sum(Y[0] * Y[0]);
    const float x22 = warp_sum(Y[1] * Y[1]);
    const float x33 = warp_sum(Y[2] * Y[2]);
    const float x12 = warp_sum(Y[0] * Y[1]);
    const float x13 = warp_sum(Y[0] * Y[2]);
    const float x23 = warp_sum(Y[1] * Y[2]);
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
#pragma unroll
    for (int q = 0; q < sym_count(D); ++q) h.aK[q] = 0.f;
    h.asig = 0.f;
    for (int gi = 0; gi < a.nsel; ++gi) {
      const int u = a.node[gi];
      float Yu[D], kp[sym_count(D)], sp = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) Yu[k] = __shfl_sync(kFull, Y[k], u);
#pragma unroll
      for (int q = 0; q < sym_count(D); ++q) kp[q] = 0.f;
      for (int rr = c.lane; rr < a.R; rr += 32) {
        const int r = gi * a.R + rr;
        float adY[D], a1, a2;
        a.terms(Yu, r, adY, a1, a2);
        const float ma = a.p(2, r) * (a1 > 0.f ? 1.f : 0.f) + a.p(3, r) * (a2 > 0.f ? 1.f : 0.f);
        const float v = 2.f * ma;
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = i; j < D; ++j)
            kp[sym_idx(D, i, j)] = kp[sym_idx(D, i, j)] + (v * adY[i]) * adY[j];
        sp = sp + (a1 - a2);
      }
#pragma unroll
      for (int q = 0; q < sym_count(D); ++q) {
        const float s = warp_sum(kp[q]);
        if (c.lane == u) h.aK[q] = s;
      }
      const float s = warp_sum(sp);
      if (c.lane == u) h.asig = s;
    }
  }
}

// Horizontal projection H <- H - Y Om, Om antisymmetric (tr_pallas.py proj).
template <int D, int EPL, bool HAS_A>
__device__ void project(const Hvp<D, EPL, HAS_A>& h, const float (&Y)[D], float (&H)[D]) {
  if constexpr (D == 2) {
    const float c12 = warp_sum(Y[0] * H[1] - H[0] * Y[1]);
    const float a = c12 / h.l11;
    const float P0 = H[0] + a * Y[1];
    const float P1 = H[1] - a * Y[0];
    H[0] = P0;
    H[1] = P1;
  } else {
    const float c12 = warp_sum(Y[0] * H[1] - H[0] * Y[1]);
    const float c13 = warp_sum(Y[0] * H[2] - H[0] * Y[2]);
    const float c23 = warp_sum(Y[1] * H[2] - H[1] * Y[2]);
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
template <int D, int EPL, bool HAS_A>
__device__ void hvp(const Warp<D, EPL>& c, const Anchors<D>& a, const Hvp<D, EPL, HAS_A>& h,
                    const float (&Y)[D], const float (&Z)[D], float (&H)[D]) {
  edge_hvp(c, h.e, Z, H);
  if constexpr (HAS_A) {
    if (a.mine) {
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
  project(h, Y, H);
}

// Steihaug-Toint truncated CG (tr_pallas.py tcg), for one live instance.
template <int D, int EPL, bool HAS_A>
__device__ void tcg(const Warp<D, EPL>& c, const Anchors<D>& a, const Hvp<D, EPL, HAS_A>& h,
                    const float (&Y)[D], const float (&grad)[D], float Delta, const Params& P,
                    float (&eta)[D], float (&Heta)[D], int& stop, int& nsteps) {
  float r[D], delta[D], Hd[D], rn[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    r[k] = grad[k];
    delta[k] = -grad[k];
    eta[k] = 0.f;
    Heta[k] = 0.f;
  }
  const float r_r0 = warp_sum(dot(r, r));
  const float norm_r0 = sqrtf(r_r0);
  const float pow_r0 = P.theta == 1.f ? norm_r0 : powf(norm_r0, P.theta);
  const float target = norm_r0 * jmin(pow_r0, P.kappa);
  float e_Pe = 0.f, e_Pd = 0.f, d_Pd = r_r0, z_r = r_r0;
  stop = kMaxInnerIter;
  nsteps = 0;
  for (int j = 0; j < P.maxinner; ++j) {
    hvp(c, a, h, Y, delta, Hd);
    const float d_Hd = warp_sum(dot(delta, Hd));
    const float alpha = z_r / d_Hd;
    const float e_Pe_new = e_Pe + 2.f * alpha * e_Pd + alpha * alpha * d_Pd;
    const float Dsq = Delta * Delta;
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
      return;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      eta[k] = eta[k] + alpha * delta[k];
      Heta[k] = Heta[k] + alpha * Hd[k];
      rn[k] = r[k] + alpha * Hd[k];
    }
    const float r_r = warp_sum(dot(rn, rn));
    if (j >= P.mininner && sqrtf(r_r) <= target) {
      stop = kReachedTarget;
      return;
    }
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

template <int D, int EPL, bool HAS_A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tr_kernel(const float* __restrict__ Y0, const float* __restrict__ dgoal, int dg_stride,
          const int* __restrict__ ei, const int* __restrict__ ej,
          const float* __restrict__ epar, const int* __restrict__ rowptr,
          const int* __restrict__ inc, const float* __restrict__ acen,
          const float* __restrict__ apar, const int* __restrict__ anode,
          float* __restrict__ Yout, float* __restrict__ cost_out,
          float* __restrict__ gradnorm_out, int* __restrict__ iters_out,
          int* __restrict__ ninner_out, int B, int N, int E, int A, int a_nsel, int a_R,
          Params P) {
  __shared__ EdgeTables s_t;
  __shared__ float s_w[kWarpsPerBlock][D * kMaxE];
  // anchor tables: centers [D][A], parameters [4][A], group nodes [a_nsel]
  extern __shared__ float s_anchor[];

  load_edge_tables(s_t, ei, ej, epar, rowptr, inc, N, E);
  Anchors<D> a{};
  if constexpr (HAS_A) {
    for (int t = threadIdx.x; t < (D + 4) * A; t += blockDim.x)
      s_anchor[t] = t < D * A ? acen[t] : apar[t - D * A];
    int* s_anode = reinterpret_cast<int*>(s_anchor + (D + 4) * A);
    for (int t = threadIdx.x; t < a_nsel; t += blockDim.x) s_anode[t] = anode[t];
    a.cen = s_anchor;
    a.par = s_anchor + D * A;
    a.node = s_anode;
    a.A = A;
    a.nsel = a_nsel;
    a.R = a_R;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;

  Warp<D, EPL> c;
  c.init(s_t, s_w[warp], dgoal, dg_stride, b, N, E);
  const int lane = c.lane;
  if constexpr (HAS_A) {
    a.mine = false;
    for (int gi = 0; gi < a.nsel; ++gi) a.mine = a.mine || a.node[gi] == lane;
  }

  float Y[D];
#pragma unroll
  for (int k = 0; k < D; ++k) Y[k] = c.has_node ? Y0[((size_t)b * N + lane) * D + k] : 0.f;

  float r_floor = 0.f;
  if (P.res_tol > 0.f) {
    float cnt = 0.f, acc = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      if (c.edge[j] >= 0) {
        cnt = cnt + c.p(0, c.edge[j]);
        acc = acc + c.p(0, c.edge[j]) * c.dg[j];
      }
    }
    r_floor = warp_sum(acc) / jmax(warp_sum(cnt), 1.f);
  }

  // ---------------- outer TR loop (tr_pallas.py:410-513) ----------------
  float f, rmax, g[D];
  cost_grad<D, EPL, HAS_A>(c, a, Y, P.res_tol, r_floor, f, g, rmax);
  float norm_g = sqrtf(warp_sum(dot(g, g)));
  bool done = norm_g < P.mingradnorm || (P.res_tol > 0.f && rmax < P.res_tol);
  float Delta = P.Delta0;
  float fx_ref = f;
  int iters = 0, ninner = 0;

  for (int k = 0; k < P.maxiter && !done; ++k) {
    Hvp<D, EPL, HAS_A> h;
    hvp_setup(c, a, Y, h);
    float eta[D], Heta[D];
    int stop, nsteps;
    tcg(c, a, h, Y, g, Delta, P, eta, Heta, stop, nsteps);

    float Yp[D], gp[D], fp, rmaxp;
#pragma unroll
    for (int q = 0; q < D; ++q) Yp[q] = Y[q] + eta[q];
    cost_grad<D, EPL, HAS_A>(c, a, Yp, P.res_tol, r_floor, fp, gp, rmaxp);

    const float rho_reg = jmax(1.f, fabsf(f)) * kEps * P.rho_regularization;
    const float rhonum = f - fp + rho_reg;
    const float rhoden = -warp_sum(dot(g, eta)) - 0.5f * warp_sum(dot(eta, Heta)) + rho_reg;
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
      norm_g = sqrtf(warp_sum(dot(gp, gp)));
      rmax = rmaxp;
    }
    Delta = Delta_new;
    done = norm_g < P.mingradnorm || (P.res_tol > 0.f && rmax < P.res_tol);
    if (P.plateau_every > 0 && (k + 1) % P.plateau_every == 0) {
      // cost-plateau stop against the checkpoint plateau_every iterations ago
      done = done || (fx_ref - f) <= (P.plateau_rtol * f + P.plateau_atol);
      fx_ref = f;
    }
    ++iters;
    ninner += nsteps;
  }

  if (c.has_node) {
#pragma unroll
    for (int q = 0; q < D; ++q) Yout[((size_t)b * N + lane) * D + q] = Y[q];
  }
  if (lane == 0) {
    cost_out[b] = f;
    gradnorm_out[b] = norm_g;
    iters_out[b] = iters;
    ninner_out[b] = ninner;
  }
}

template <int D, int EPL, bool HAS_A>
int launch(const float* Y0, const float* dgoal, int dg_stride, const int* ei, const int* ej,
           const float* epar, const int* rowptr, const int* inc, const float* acen,
           const float* apar, const int* anode, float* Yout, float* cost, float* gradnorm,
           int* iters, int* ninner, int B, int N, int E, int A, int a_nsel, int a_R,
           const Params& P, cudaStream_t stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = HAS_A ? ((size_t)(D + 4) * A + a_nsel) * 4 : 0;
  tr_kernel<D, EPL, HAS_A><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      Y0, dgoal, dg_stride, ei, ej, epar, rowptr, inc, acen, apar, anode, Yout, cost,
      gradnorm, iters, ninner, B, N, E, A, a_nsel, a_R, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A == 0 runs the anchor-free kernel; A > 0 takes the anchor tables: acen
// (D, A) and apar (4, A) row-major f32, anode (a_nsel,) int32, with
// A == a_nsel * a_R (group g is rows g * a_R .. (g + 1) * a_R - 1).
extern "C" int graphik_tr_solve(
    const float* Y0, const float* dgoal, int dg_stride, const int* ei, const int* ej,
    const float* epar, const int* rowptr, const int* inc, const float* acen,
    const float* apar, const int* anode, float* Yout, float* cost, float* gradnorm,
    int* iters, int* ninner, int B, int N, int D, int E, int A, int a_nsel, int a_R,
    int maxiter, int maxinner, int mininner, int plateau_every, float mingradnorm,
    float kappa, float theta, float rho_prime, float rho_regularization,
    float Delta_bar, float Delta0, float plateau_rtol, float plateau_atol,
    float res_tol, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || E < 1 || E > kMaxE || dg_stride < E)
    return static_cast<int>(cudaErrorInvalidValue);
  if (A < 0 || A > kMaxA ||
      (A > 0 && (a_nsel < 1 || a_nsel > N || a_R < 1 || a_nsel * a_R != A)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{maxiter, maxinner, mininner, plateau_every, mingradnorm, kappa,
                 theta, rho_prime, rho_regularization, Delta_bar, Delta0,
                 plateau_rtol, plateau_atol, res_tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int epl = (E + 31) / 32;
#define GRAPHIK_TR_CASE(DD, EE)                                                            \
  if (D == DD && epl == EE)                                                                \
    return A > 0 ? launch<DD, EE, true>(Y0, dgoal, dg_stride, ei, ej, epar, rowptr, inc,   \
                                        acen, apar, anode, Yout, cost, gradnorm, iters,    \
                                        ninner, B, N, E, A, a_nsel, a_R, P, s)             \
                 : launch<DD, EE, false>(Y0, dgoal, dg_stride, ei, ej, epar, rowptr, inc,  \
                                         acen, apar, anode, Yout, cost, gradnorm, iters,   \
                                         ninner, B, N, E, A, a_nsel, a_R, P, s);
  GRAPHIK_TR_CASE(3, 1) GRAPHIK_TR_CASE(3, 2) GRAPHIK_TR_CASE(3, 3) GRAPHIK_TR_CASE(3, 4)
  GRAPHIK_TR_CASE(2, 1) GRAPHIK_TR_CASE(2, 2) GRAPHIK_TR_CASE(2, 3) GRAPHIK_TR_CASE(2, 4)
#undef GRAPHIK_TR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
