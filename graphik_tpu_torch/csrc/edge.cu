// K1 / K2's entry points (the edge cost+gradient and Hessian-vector
// product) and their instances up to 32 nodes and 128 edges: one node a
// lane, EPL = ceil(E / W) edges a lane, 1-8 at W = 16 (two instances a
// warp, N <= 16), 1-4 at W = 32. What the kernels replace and how they are
// built is in csrc/edge_kernel.cuh; larger problems (N <= 64, E <= 256)
// dispatch to csrc/edge_wide.cu.

#include "edge_kernel.cuh"

namespace {

using namespace graphik;

int dispatch(const EdgeArgs& a, int D, bool hess, cudaStream_t s, bool go, int* info) {
  if (a.B < 1 || a.N < 1 || a.N > kEdgeMaxN || a.E < 1 || a.E > kEdgeMaxE ||
      a.dg_stride < a.E || a.dg_stride > kEdgeMaxE || a.n_codes < 0 ||
      a.n_codes > (a.N > kMaxN ? kEdgeMaxN * kEdgeMaxN : kMaxN * kMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = a.N <= 16 ? 16 : 32;
  const int epl = (a.E + W - 1) / W;
  if (a.N > kMaxN || (W == 32 && epl > 4)) return launch_edge_wide(a, D, epl, hess, s, go, info);
#define GRAPHIK_EDGE_ONE(DD, EE, WW) GRAPHIK_EDGE_CASE(cost_grad_kernel, hess_kernel, DD, EE, WW, 1)
#define GRAPHIK_EDGE_D(DD)                                                              \
  GRAPHIK_EDGE_ONE(DD, 1, 16) GRAPHIK_EDGE_ONE(DD, 2, 16) GRAPHIK_EDGE_ONE(DD, 3, 16)    \
  GRAPHIK_EDGE_ONE(DD, 4, 16) GRAPHIK_EDGE_ONE(DD, 5, 16) GRAPHIK_EDGE_ONE(DD, 6, 16)    \
  GRAPHIK_EDGE_ONE(DD, 7, 16) GRAPHIK_EDGE_ONE(DD, 8, 16) GRAPHIK_EDGE_ONE(DD, 1, 32)    \
  GRAPHIK_EDGE_ONE(DD, 2, 32) GRAPHIK_EDGE_ONE(DD, 3, 32) GRAPHIK_EDGE_ONE(DD, 4, 32)
  GRAPHIK_EDGE_D(3) GRAPHIK_EDGE_D(2)
#undef GRAPHIK_EDGE_D
#undef GRAPHIK_EDGE_ONE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Makes `device` current for one entry-point call, and restores the
// caller's device after it.
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
    } else {
      prev = -1;
    }
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// Y, Z, H, g: (B, N, D) row-major f32; dgoal: (B, dg_stride), dg_stride E
// or more; f: (B,). Y, Z, dgoal and the outputs 16-byte aligned. ei, ej,
// epar and rowptr as graphik_tr_solve takes them; slot (E,): each edge's
// place in a segment's scatter buffer (edge e among the W places of its
// group e / W); codes (n_codes = max degree x N): node i's q-th incident
// edge, ascending, at [q][i] as 2 slot + (1 where i is the edge's ej), and
// 2 W ceil(E / W) (the zero place) past its degree.
extern "C" int graphik_edge_cost_grad(const float* Y, const float* dgoal, int dg_stride,
                                      const int* ei, const int* ej, const float* epar,
                                      const int* rowptr, const int* codes, const int* slot,
                                      int n_codes, float* f, float* g, int B, int N, int D,
                                      int E, int device, void* stream) {
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  const EdgeArgs a{Y, nullptr, dgoal, dg_stride, ei, ej, epar, rowptr, codes, slot, f, g,
                   B, N, E, n_codes};
  return dispatch(a, D, false, static_cast<cudaStream_t>(stream), true, nullptr);
}

extern "C" int graphik_edge_hess(const float* Y, const float* Z, const float* dgoal,
                                 int dg_stride, const int* ei, const int* ej,
                                 const float* epar, const int* rowptr, const int* codes,
                                 const int* slot, int n_codes, float* H, int B, int N, int D,
                                 int E, int device, void* stream) {
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  const EdgeArgs a{Y, Z, dgoal, dg_stride, ei, ej, epar, rowptr, codes, slot, nullptr, H,
                   B, N, E, n_codes};
  return dispatch(a, D, true, static_cast<cudaStream_t>(stream), true, nullptr);
}

// The launch shape of K1 (hess = 0) or K2 for these sizes on `device`:
// info[0..6] as `launch` fills it.
extern "C" int graphik_edge_shape(int B, int N, int D, int E, int dg_stride, int hess,
                                  int device, int* info) {
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  EdgeArgs a{};
  a.B = B;
  a.N = N;
  a.E = E;
  a.dg_stride = dg_stride;
  return dispatch(a, D, hess != 0, nullptr, false, info);
}
