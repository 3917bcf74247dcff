// One warp per instance of the EDM-completion problem over its compiled
// edge form: the per-warp tables and the edge cost, gradient and
// Hessian-vector terms shared by csrc/tr_solve.cu (the TR solve) and
// csrc/edge.cu (the cost+gradient and Hessian-vector entry points).
//
// * Lane i < N holds node i's d coordinates of a state vector.
// * Edge differences C.Y: lane l owns edges e = l, l + 32, ... (EPL of
//   them) and gathers the endpoint coordinates with __shfl_sync. This
//   replaces the MXU incidence matmul of the TPU kernels.
// * Scatter C^T w: each lane writes its per-edge values into the warp's
//   slice of shared memory; node lane i then sums its own incidence list
//   (CSR with signs, ascending edge order). No float atomics, so a run is
//   bitwise repeatable.
// * Row sums are __shfl_xor_sync butterflies, which leave a
//   bitwise-identical value in every lane, so branches on them never
//   diverge.
// * f32 throughout; the build passes -fmad=false so every product and sum
//   rounds as in the plain torch versions.

#pragma once

#include <cuda_runtime.h>

namespace graphik {

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

// The block's shared copy of the edge tables.
struct EdgeTables {
  int ei[kMaxE], ej[kMaxE], inc[2 * kMaxE], rowptr[kMaxN + 1];
  float par[5 * kMaxE];  // [5][kMaxE]: omega, psi_L, psi_U, L_mask, U_mask
};

// Every thread of the block calls it; the caller syncs.
__device__ __forceinline__ void load_edge_tables(EdgeTables& t, const int* ei, const int* ej,
                                                 const float* epar, const int* rowptr,
                                                 const int* inc, int N, int E) {
  for (int q = threadIdx.x; q < E; q += blockDim.x) {
    t.ei[q] = ei[q];
    t.ej[q] = ej[q];
#pragma unroll
    for (int k = 0; k < 5; ++k) t.par[k * kMaxE + q] = epar[q * 5 + k];
  }
  for (int q = threadIdx.x; q < 2 * E; q += blockDim.x) t.inc[q] = inc[q];
  for (int q = threadIdx.x; q <= N; q += blockDim.x) t.rowptr[q] = rowptr[q];
}

// Per-warp view of the block's shared tables plus this lane's edges.
template <int D, int EPL>
struct Warp {
  int lane;
  bool has_node;
  const float* par;     // [5][kMaxE]
  const int* rowptr;    // [N + 1]
  const int* inc;       // [2E]: edge * 2 + (1 if the node is the edge's ej)
  float* w;             // this warp's [D][kMaxE] scatter buffer
  int edge[EPL];        // edge index, or -1 past E
  int src_i[EPL], src_j[EPL];
  float dg[EPL];

  __device__ void init(const EdgeTables& t, float* wbuf, const float* dgoal, int dg_stride,
                       int b, int N, int E) {
    lane = threadIdx.x & 31;
    has_node = lane < N;
    par = t.par;
    rowptr = t.rowptr;
    inc = t.inc;
    w = wbuf;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = lane + 32 * j;
      const bool valid = e < E;
      edge[j] = valid ? e : -1;
      src_i[j] = valid ? t.ei[e] : 0;
      src_j[j] = valid ? t.ej[e] : 0;
      dg[j] = valid ? dgoal[(size_t)b * dg_stride + e] : 0.f;
    }
  }

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

  // Edge cost f, Euclidean gradient g = -2 C^T (s dY) and this lane's
  // partial (unreduced) max relative residual when res_tol > 0, as
  // tr_pallas.py cost_and_grad.
  __device__ void cost_grad_edges(const float (&Y)[D], float res_tol, float r_floor, float& f,
                                  float (&g)[D], float& rpart) const {
    float fpart = 0.f;
    rpart = 0.f;
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
  }
};

// Edge terms of the Hessian-vector product that depend only on Y
// (tr_pallas.py make_hvp): edge differences, s and m.
template <int D, int EPL>
struct EdgeHvp {
  float dY[EPL][D];
  float s[EPL], m[EPL];
};

template <int D, int EPL>
__device__ void edge_hvp_setup(const Warp<D, EPL>& c, const float (&Y)[D], EdgeHvp<D, EPL>& h) {
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

// Euclidean edge Hessian-vector product H = 2 C^T (m dD dY - s dZ).
template <int D, int EPL>
__device__ void edge_hvp(const Warp<D, EPL>& c, const EdgeHvp<D, EPL>& h, const float (&Z)[D],
                         float (&H)[D]) {
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
}

}  // namespace graphik
