// Batched edge-form cost + Euclidean gradient, and Euclidean
// Hessian-vector product, one warp per instance, for NVIDIA Hopper
// (sm_90a).
//
// Replaces graphik_tpu/ops/edge.py::_kernel_cost_grad (behind
// cost_and_egrad_pallas) and ::_kernel_hess (behind ehess_pallas), the
// TPU's per-op kernels:
//   cost+grad:  f = sum_e (s0^2 + e1^2 + e2^2),  g = -2 C^T (s dY)
//   hess:       H = 2 C^T (m dD dY - s dZ),      dD = 2 <dY, dZ>
// with no anchor terms and no horizontal projection, as theirs.
//
// What bounds them: each reads ~1 KB per instance (Y, Z, the goal
// distances) and writes ~0.2 KB, with ~1k flops of gathers and one scatter
// in between - memory and latency, never the arithmetic. They reuse the TR
// kernel's edge machinery (csrc/edge_warp.cuh): shuffles for C.Y, a
// per-warp shared-memory CSR scatter for C^T w, butterfly sums. Neither
// lies on a solve path (the TR kernel fuses the same math); they are the
// counterparts of the JAX package's two entry points.

#include "edge_warp.cuh"

namespace {

using namespace graphik;

template <int D, int EPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cost_grad_kernel(const float* __restrict__ Y, const float* __restrict__ dgoal, int dg_stride,
                 const int* __restrict__ ei, const int* __restrict__ ej,
                 const float* __restrict__ epar, const int* __restrict__ rowptr,
                 const int* __restrict__ inc, float* __restrict__ f_out,
                 float* __restrict__ g_out, int B, int N, int E) {
  __shared__ EdgeTables s_t;
  __shared__ float s_w[kWarpsPerBlock][D * kMaxE];
  load_edge_tables(s_t, ei, ej, epar, rowptr, inc, N, E);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;

  Warp<D, EPL> c;
  c.init(s_t, s_w[warp], dgoal, dg_stride, b, N, E);
  float Yl[D];
#pragma unroll
  for (int k = 0; k < D; ++k) Yl[k] = c.has_node ? Y[((size_t)b * N + c.lane) * D + k] : 0.f;
  float f, g[D], rpart;
  c.cost_grad_edges(Yl, 0.f, 0.f, f, rpart);
  c.scatter(-2.f, g);
  if (c.has_node) {
#pragma unroll
    for (int k = 0; k < D; ++k) g_out[((size_t)b * N + c.lane) * D + k] = g[k];
  }
  if (c.lane == 0) f_out[b] = f;
}

template <int D, int EPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hess_kernel(const float* __restrict__ Y, const float* __restrict__ Z,
            const float* __restrict__ dgoal, int dg_stride, const int* __restrict__ ei,
            const int* __restrict__ ej, const float* __restrict__ epar,
            const int* __restrict__ rowptr, const int* __restrict__ inc,
            float* __restrict__ H_out, int B, int N, int E) {
  __shared__ EdgeTables s_t;
  __shared__ float s_w[kWarpsPerBlock][D * kMaxE];
  load_edge_tables(s_t, ei, ej, epar, rowptr, inc, N, E);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;

  Warp<D, EPL> c;
  c.init(s_t, s_w[warp], dgoal, dg_stride, b, N, E);
  float Yl[D], Zl[D], H[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const size_t at = ((size_t)b * N + c.lane) * D + k;
    Yl[k] = c.has_node ? Y[at] : 0.f;
    Zl[k] = c.has_node ? Z[at] : 0.f;
  }
  EdgeHvp<D, EPL> h;
  edge_hvp_setup(c, Yl, h);
  edge_hvp(c, h, Zl, H);
  if (c.has_node) {
#pragma unroll
    for (int k = 0; k < D; ++k) H_out[((size_t)b * N + c.lane) * D + k] = H[k];
  }
}

bool bad_shape(int B, int N, int E, int dg_stride) {
  return B < 1 || N < 1 || N > kMaxN || E < 1 || E > kMaxE || dg_stride < E;
}

constexpr int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" int graphik_edge_cost_grad(const float* Y, const float* dgoal, int dg_stride,
                                      const int* ei, const int* ej, const float* epar,
                                      const int* rowptr, const int* inc, float* f, float* g,
                                      int B, int N, int D, int E, void* stream) {
  if (bad_shape(B, N, E, dg_stride)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int epl = (E + 31) / 32;
#define GRAPHIK_CG_CASE(DD, EE)                                                          \
  if (D == DD && epl == EE) {                                                            \
    cost_grad_kernel<DD, EE><<<blocks_for(B), kWarpsPerBlock * 32, 0, s>>>(              \
        Y, dgoal, dg_stride, ei, ej, epar, rowptr, inc, f, g, B, N, E);                  \
    return static_cast<int>(cudaGetLastError());                                         \
  }
  GRAPHIK_CG_CASE(3, 1) GRAPHIK_CG_CASE(3, 2) GRAPHIK_CG_CASE(3, 3) GRAPHIK_CG_CASE(3, 4)
  GRAPHIK_CG_CASE(2, 1) GRAPHIK_CG_CASE(2, 2) GRAPHIK_CG_CASE(2, 3) GRAPHIK_CG_CASE(2, 4)
#undef GRAPHIK_CG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int graphik_edge_hess(const float* Y, const float* Z, const float* dgoal,
                                 int dg_stride, const int* ei, const int* ej,
                                 const float* epar, const int* rowptr, const int* inc,
                                 float* H, int B, int N, int D, int E, void* stream) {
  if (bad_shape(B, N, E, dg_stride)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int epl = (E + 31) / 32;
#define GRAPHIK_H_CASE(DD, EE)                                                           \
  if (D == DD && epl == EE) {                                                            \
    hess_kernel<DD, EE><<<blocks_for(B), kWarpsPerBlock * 32, 0, s>>>(                   \
        Y, Z, dgoal, dg_stride, ei, ej, epar, rowptr, inc, H, B, N, E);                  \
    return static_cast<int>(cudaGetLastError());                                         \
  }
  GRAPHIK_H_CASE(3, 1) GRAPHIK_H_CASE(3, 2) GRAPHIK_H_CASE(3, 3) GRAPHIK_H_CASE(3, 4)
  GRAPHIK_H_CASE(2, 1) GRAPHIK_H_CASE(2, 2) GRAPHIK_H_CASE(2, 3) GRAPHIK_H_CASE(2, 4)
#undef GRAPHIK_H_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
