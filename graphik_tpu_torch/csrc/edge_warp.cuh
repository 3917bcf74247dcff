// One instance of the EDM-completion problem per warp segment of W lanes
// (W = 32: a whole warp; W = 16: half a warp, two instances per warp) over
// its compiled edge form: the per-segment tables and the edge cost,
// gradient and Hessian-vector terms shared by csrc/tr_solve.cu (the TR
// solve) and csrc/edge.cu (the cost+gradient and Hessian-vector entry
// points, W = 32).
//
// * Lane i < N of a segment holds node i's d coordinates of a state vector.
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

// Per-segment view of the block's shared tables plus this lane's edges.
template <int D, int EPL, int W = 32>
struct Warp {
  static_assert(W == 16 || W == 32, "a segment is half a warp or a warp");
  static constexpr int kWS = kMaxE * W / 32;  // scatter buffer stride per coordinate

  int lane;             // lane within the segment
  int base;             // the segment's first warp lane
  bool has_node;
  const float* par;     // [5][kMaxE]
  const int* rowptr;    // [N + 1]
  const int* inc;       // [2E]: edge * 2 + (1 if the node is the edge's ej)
  float* w;             // this segment's [D][kWS] scatter buffer
  int edge[EPL];        // edge index, or -1 past E
  int src_i[EPL], src_j[EPL];  // warp lanes of the endpoints
  float dg[EPL];

  // wbuf: the warp's [D * kMaxE] scatter buffer, split between segments.
  __device__ void init_tables(const EdgeTables& t, float* wbuf, int N, int E) {
    const int wl = threadIdx.x & 31;
    lane = wl & (W - 1);
    base = wl - lane;
    has_node = lane < N;
    par = t.par;
    rowptr = t.rowptr;
    inc = t.inc;
    w = wbuf + (base / W) * D * kWS;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = lane + W * j;
      const bool valid = e < E;
      edge[j] = valid ? e : -1;
      src_i[j] = base + (valid ? t.ei[e] : 0);
      src_j[j] = base + (valid ? t.ej[e] : 0);
    }
  }

  __device__ void load_goal(const float* dgoal, int dg_stride, int b) {
#pragma unroll
    for (int j = 0; j < EPL; ++j)
      dg[j] = edge[j] >= 0 ? dgoal[(size_t)b * dg_stride + edge[j]] : 0.f;
  }

  __device__ void init(const EdgeTables& t, float* wbuf, const float* dgoal, int dg_stride,
                       int b, int N, int E) {
    init_tables(t, wbuf, N, E);
    load_goal(dgoal, dg_stride, b);
  }

  // Whether slot j holds an edge of the 32-lane layout's lane l + 16.
  __host__ __device__ static constexpr bool hi(int j) { return W == 16 && (j & 1); }

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
          for (int k = 0; k < D; ++k) acc[k] = acc[k] - w[k * kWS + e];
        } else {
#pragma unroll
          for (int k = 0; k < D; ++k) acc[k] = acc[k] + w[k * kWS + e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) out[k] = scale * acc[k];
    __syncwarp();
  }

  // Edge cost f, the per-edge gradient terms s dY into w (the caller
  // scatters them) and this lane's partial (unreduced) max relative
  // residual when res_tol > 0, as tr_pallas.py cost_and_grad.
  __device__ void cost_grad_edges(const float (&Y)[D], float res_tol, float r_floor, float& f,
                                  float& rpart) const {
    float fpart[2] = {0.f, 0.f};
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
        fpart[hi(j)] = fpart[hi(j)] + (s0 * s0 + e1 * e1 + e2 * e2);
        const float s = s0 + e1 - e2;
#pragma unroll
        for (int k = 0; k < D; ++k) w[k * kWS + e] = s * dY[k];
        if (res_tol > 0.f) {
          float r = fabsf(s0) / jmax(dg[j], r_floor);
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

template <int D, int EPL, int W>
__device__ void edge_hvp_setup(const Warp<D, EPL, W>& c, const float (&Y)[D],
                               EdgeHvp<D, EPL>& h) {
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
template <int D, int EPL, int W>
__device__ void edge_hvp(const Warp<D, EPL, W>& c, const EdgeHvp<D, EPL>& h,
                         const float (&Z)[D], float (&H)[D]) {
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    float dZ[D];
    c.edge_diff(Z, j, dZ);
    const int e = c.edge[j];
    if (e >= 0) {
      const float mdD = h.m[j] * (2.f * dot(h.dY[j], dZ));
#pragma unroll
      for (int k = 0; k < D; ++k) c.w[k * Warp<D, EPL, W>::kWS + e] = mdD * h.dY[j][k] - h.s[j] * dZ[k];
    }
  }
  c.scatter(2.f, H);
}

}  // namespace graphik
