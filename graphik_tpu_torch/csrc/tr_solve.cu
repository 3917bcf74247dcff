// Batched Riemannian trust-region solve of the EDM-completion problem, one
// warp per instance, for NVIDIA Hopper (sm_90a).
//
// Replaces graphik_tpu/ops/tr_pallas.py::_tr_kernel (its anchor-free
// branch), the fused Pallas TPU kernel that runs the whole outer TR loop
// plus Steihaug-Toint truncated CG for a tile of instances. It computes the
// same thing statement for statement (stop rules, rho regularization,
// radius updates, the reduced 3x3 Lyapunov-Cholesky horizontal projection,
// per-lane counters); graphik_tpu_torch/ops/tr_solve.py holds the plain
// torch transcription the kernel is checked against.
//
// What bounds it on the card. One UR10 instance is N = 16 nodes x d = 3
// coordinates and E = 64 edges: every tCG step is a Hessian-vector product
// (2 gathers and 1 scatter over 64 edges, ~1k flops) plus 5 dot-product
// reductions over 48 numbers, and each depends on the previous one. The work
// is a long chain of tiny dependent steps per instance: latency of the
// reductions and of the scatter's shared-memory round trip bounds it, not
// bytes (inputs and outputs are ~1 KB per instance, read and written once)
// and not flops.
//
// Design, and why.
// * The TPU kernel puts instances on the 128-wide lane axis and drives a
//   tile with one loop whose trip count is set by its slowest lane. Here a
//   warp owns one instance and runs its own loops: every lane of the warp
//   takes the same branches (all branch conditions come from butterfly
//   reductions, which leave a bitwise-identical value in every lane), a
//   finished instance frees its warp at once, and no lane masks are needed.
//   Per-instance loops reproduce the tile loop exactly because lanes of the
//   tile never interact and a live lane's iteration count equals the tile's
//   global counter (so the plateau check on (k+1) % plateau_every holds).
// * Lane i < N holds node i's d coordinates of every state vector (Y, grad,
//   eta, Heta, r, delta, the HVP output, the candidate point and its
//   gradient): ~30 registers, no shared or global memory in the loops.
// * Edge differences C.Y: lane l owns edges e = l, l + 32, ... (EPL of
//   them) and gathers the endpoint coordinates with __shfl_sync. This
//   replaces the MXU incidence matmul of the TPU kernel.
// * Scatter C^T w: each lane writes its per-edge values into the warp's
//   slice of shared memory; node lane i then sums its own incidence list
//   (CSR with signs, ascending edge order). No float atomics, so a run is
//   bitwise repeatable.
// * Row sums (the TPU kernel's _rowsum) are __shfl_xor_sync butterflies; the
//   3x3 Cholesky of the reduced Lyapunov system is scalar code run by every
//   lane.
// * The edge table and incidence CSR are loaded into shared memory once per
//   block. Templates on D (2 or 3) and EPL = ceil(E / 32) <= 4; N <= 32.
//   The wrapper refuses other shapes.
// * f32 throughout; there is no matmul, so no TF32. The build passes
//   -fmad=false so every product and sum rounds as in the plain version.
//
// The entry point allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kMaxE = 128;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

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

// jnp.maximum / jnp.minimum: NaN in either operand propagates.
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= 3.402823466e+38f; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = jmax(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float (&b)[D]) {
  float s = a[0] * b[0];
#pragma unroll
  for (int k = 1; k < D; ++k) s = s + a[k] * b[k];
  return s;
}

// Per-warp view of the block's shared tables plus this lane's edges.
template <int D, int EPL>
struct Warp {
  int lane;
  bool has_node;
  const float* par;     // [5][kMaxE]: omega, psi_L, psi_U, L_mask, U_mask
  const int* rowptr;    // [N + 1]
  const int* inc;       // [2E]: edge * 2 + (1 if the node is the edge's ej)
  float* w;             // this warp's [D][kMaxE] scatter buffer
  int edge[EPL];        // edge index, or -1 past E
  int src_i[EPL], src_j[EPL];
  float dg[EPL];

  __device__ float p(int which, int e) const { return par[which * kMaxE + e]; }

  // Y[ei] - Y[ej] for this lane's j-th edge (every lane must call it).
  __device__ void edge_diff(const float (&Y)[D], int j, float (&out)[D]) const {
#pragma unroll
    for (int k = 0; k < D; ++k)
      out[k] = __shfl_sync(kFull, Y[k], src_i[j]) - __shfl_sync(kFull, Y[k], src_j[j]);
  }

  // out = scale * C^T w, w written by the lanes since the last __syncwarp.
  __device__ void scatter(float scale, float (&out)[D]) const {
    __syncwarp();
    float acc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0.f;
    if (has_node) {
      for (int q = rowptr[lane]; q < rowptr[lane + 1]; ++q) {
        const int code = inc[q];
        const int e = code >> 1;
        if (code & 1) {
#pragma unroll
          for (int k = 0; k < D; ++k) acc[k] = acc[k] - w[k * kMaxE + e];
        } else {
#pragma unroll
          for (int k = 0; k < D; ++k) acc[k] = acc[k] + w[k * kMaxE + e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) out[k] = scale * acc[k];
    __syncwarp();
  }

  // Cost f, Euclidean gradient g = -2 C^T (s dY) and (when res_tol > 0) the
  // max relative residual, as tr_pallas.py cost_and_grad.
  __device__ void cost_grad(const float (&Y)[D], float res_tol, float r_floor,
                            float& f, float (&g)[D], float& rmax) const {
    float fpart = 0.f, rpart = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      float dY[D];
      edge_diff(Y, j, dY);
      const int e = edge[j];
      if (e >= 0) {
        const float dist = dot(dY, dY);
        const float om = p(0, e), psiL = p(1, e), psiU = p(2, e);
        const float s0 = om * (dg[j] - dist);
        const float e1 = p(3, e) * jmax(psiL - dist, 0.f);
        const float e2 = p(4, e) * jmax(dist - psiU, 0.f);
        fpart = fpart + (s0 * s0 + e1 * e1 + e2 * e2);
        const float s = s0 + e1 - e2;
#pragma unroll
        for (int k = 0; k < D; ++k) w[k * kMaxE + e] = s * dY[k];
        if (res_tol > 0.f) {
          float r = fabsf(s0) / jmax(dg[j], r_floor);
          r = jmax(r, e1 / jmax(psiL, r_floor));
          r = jmax(r, e2 / jmax(psiU, r_floor));
          rpart = jmax(rpart, r);
        }
      }
    }
    f = warp_sum(fpart);
    rmax = res_tol > 0.f ? warp_max(rpart) : 0.f;
    scatter(-2.f, g);
  }
};

// Terms of the Riemannian Hessian-vector product that depend only on Y
// (tr_pallas.py make_hvp): edge differences, s, m and the Cholesky factor of
// the reduced Lyapunov system.
template <int D, int EPL>
struct Hvp {
  float dY[EPL][D];
  float s[EPL], m[EPL];
  float l11, l21, l31, l22, l32, l33;  // d == 3; d == 2 keeps only l11
};

template <int D, int EPL>
__device__ void hvp_setup(const Warp<D, EPL>& c, const float (&Y)[D], Hvp<D, EPL>& h) {
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
}

// Horizontal projection H <- H - Y Om, Om antisymmetric (tr_pallas.py proj).
template <int D, int EPL>
__device__ void project(const Hvp<D, EPL>& h, const float (&Y)[D], float (&H)[D]) {
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

// Riemannian Hessian-vector product: proj(2 C^T (m dD dY - s dZ)).
template <int D, int EPL>
__device__ void hvp(const Warp<D, EPL>& c, const Hvp<D, EPL>& h, const float (&Y)[D],
                    const float (&Z)[D], float (&H)[D]) {
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    float dZ[D];
    c.edge_diff(Z, j, dZ);
    const int e = c.edge[j];
    if (e >= 0) {
      const float mdD = h.m[j] * (2.f * dot(h.dY[j], dZ));
#pragma unroll
      for (int k = 0; k < D; ++k) c.w[k * kMaxE + e] = mdD * h.dY[j][k] - h.s[j] * dZ[k];
    }
  }
  c.scatter(2.f, H);
  project(h, Y, H);
}

// Steihaug-Toint truncated CG (tr_pallas.py tcg), for one live instance.
template <int D, int EPL>
__device__ void tcg(const Warp<D, EPL>& c, const Hvp<D, EPL>& h, const float (&Y)[D],
                    const float (&grad)[D], float Delta, const Params& P,
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
    hvp(c, h, Y, delta, Hd);
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

template <int D, int EPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tr_kernel(const float* __restrict__ Y0, const float* __restrict__ dgoal, int dg_stride,
          const int* __restrict__ ei, const int* __restrict__ ej,
          const float* __restrict__ epar, const int* __restrict__ rowptr,
          const int* __restrict__ inc, float* __restrict__ Yout,
          float* __restrict__ cost_out, float* __restrict__ gradnorm_out,
          int* __restrict__ iters_out, int* __restrict__ ninner_out,
          int B, int N, int E, Params P) {
  __shared__ int s_ei[kMaxE], s_ej[kMaxE], s_inc[2 * kMaxE], s_rowptr[kMaxN + 1];
  __shared__ float s_par[5 * kMaxE];
  __shared__ float s_w[kWarpsPerBlock][D * kMaxE];

  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    s_ei[t] = ei[t];
    s_ej[t] = ej[t];
#pragma unroll
    for (int q = 0; q < 5; ++q) s_par[q * kMaxE + t] = epar[t * 5 + q];
  }
  for (int t = threadIdx.x; t < 2 * E; t += blockDim.x) s_inc[t] = inc[t];
  for (int t = threadIdx.x; t <= N; t += blockDim.x) s_rowptr[t] = rowptr[t];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;

  Warp<D, EPL> c;
  c.lane = lane;
  c.has_node = lane < N;
  c.par = s_par;
  c.rowptr = s_rowptr;
  c.inc = s_inc;
  c.w = s_w[warp];
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane + 32 * j;
    const bool valid = e < E;
    c.edge[j] = valid ? e : -1;
    c.src_i[j] = valid ? s_ei[e] : 0;
    c.src_j[j] = valid ? s_ej[e] : 0;
    c.dg[j] = valid ? dgoal[(size_t)b * dg_stride + e] : 0.f;
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
  c.cost_grad(Y, P.res_tol, r_floor, f, g, rmax);
  float norm_g = sqrtf(warp_sum(dot(g, g)));
  bool done = norm_g < P.mingradnorm || (P.res_tol > 0.f && rmax < P.res_tol);
  float Delta = P.Delta0;
  float fx_ref = f;
  int iters = 0, ninner = 0;

  for (int k = 0; k < P.maxiter && !done; ++k) {
    Hvp<D, EPL> h;
    hvp_setup(c, Y, h);
    float eta[D], Heta[D];
    int stop, nsteps;
    tcg(c, h, Y, g, Delta, P, eta, Heta, stop, nsteps);

    float Yp[D], gp[D], fp, rmaxp;
#pragma unroll
    for (int q = 0; q < D; ++q) Yp[q] = Y[q] + eta[q];
    c.cost_grad(Yp, P.res_tol, r_floor, fp, gp, rmaxp);

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

template <int D, int EPL>
int launch(const float* Y0, const float* dgoal, int dg_stride, const int* ei,
           const int* ej, const float* epar, const int* rowptr, const int* inc,
           float* Yout, float* cost, float* gradnorm, int* iters, int* ninner,
           int B, int N, int E, const Params& P, cudaStream_t stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  tr_kernel<D, EPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      Y0, dgoal, dg_stride, ei, ej, epar, rowptr, inc, Yout, cost, gradnorm,
      iters, ninner, B, N, E, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int graphik_tr_solve(
    const float* Y0, const float* dgoal, int dg_stride, const int* ei, const int* ej,
    const float* epar, const int* rowptr, const int* inc, float* Yout, float* cost,
    float* gradnorm, int* iters, int* ninner, int B, int N, int D, int E,
    int maxiter, int maxinner, int mininner, int plateau_every, float mingradnorm,
    float kappa, float theta, float rho_prime, float rho_regularization,
    float Delta_bar, float Delta0, float plateau_rtol, float plateau_atol,
    float res_tol, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN || E < 1 || E > kMaxE || dg_stride < E)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{maxiter, maxinner, mininner, plateau_every, mingradnorm, kappa,
                 theta, rho_prime, rho_regularization, Delta_bar, Delta0,
                 plateau_rtol, plateau_atol, res_tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int epl = (E + 31) / 32;
#define GRAPHIK_TR_CASE(DD, EE)                                                   \
  if (D == DD && epl == EE)                                                       \
    return launch<DD, EE>(Y0, dgoal, dg_stride, ei, ej, epar, rowptr, inc, Yout, \
                          cost, gradnorm, iters, ninner, B, N, E, P, s);
  GRAPHIK_TR_CASE(3, 1) GRAPHIK_TR_CASE(3, 2) GRAPHIK_TR_CASE(3, 3) GRAPHIK_TR_CASE(3, 4)
  GRAPHIK_TR_CASE(2, 1) GRAPHIK_TR_CASE(2, 2) GRAPHIK_TR_CASE(2, 3) GRAPHIK_TR_CASE(2, 4)
#undef GRAPHIK_TR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
