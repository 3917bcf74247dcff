// K1 / K2's instances past 32 nodes or 128 edges, one instance a warp
// (W = 32): two node slots a lane (32 < N <= 64) with 1 to 8 edges a lane,
// and one node slot (N <= 32) with 5 to 8 (128 < E <= 256). The kernel
// template is csrc/edge_kernel.cuh; csrc/edge.cu dispatches here.

#include "edge_kernel.cuh"

namespace graphik {

namespace wide {

// The kernels of csrc/edge_kernel.cuh with a floor of blocks an SM for
// ptxas. Without one it held some two-slot instances (dh19's K2,
// <3, 4, 32, 2>, among them) to 64 registers and spilled; with a floor of
// one, none spills, but dh19's K1 took 84 registers, which leave room for
// two blocks of 8 warps an SM, not three (its time 59 us against its K2's
// 32 us at three). Up to 4 edges a lane the floor is three (at most 80
// registers), past them one.
template <int EPL>
constexpr int kMinBlocks = EPL <= 4 ? 3 : 1;

template <int D, int EPL, int W, int NPL>
__global__ void __launch_bounds__(kEdgeWarps * 32, kMinBlocks<EPL>)
    cost_grad_kernel(EdgeArgs a) {
  edge_tiles<D, EPL, W, NPL, false>(a);
}

template <int D, int EPL, int W, int NPL>
__global__ void __launch_bounds__(kEdgeWarps * 32, kMinBlocks<EPL>) hess_kernel(EdgeArgs a) {
  edge_tiles<D, EPL, W, NPL, true>(a);
}

}  // namespace wide

// The same dispatch table form as csrc/edge.cu's, over the instances above:
// W = 32 always; NPL = 2 past 32 nodes (1-8 edges a lane), else NPL = 1
// with 5-8 edges a lane (cudaErrorInvalidValue for anything else).
int launch_edge_wide(const EdgeArgs& a, int D, int epl, bool hess, cudaStream_t s, bool go,
                     int* info) {
  const int W = 32;
#define GRAPHIK_EDGE_ONE(DD, EE, NN) \
  GRAPHIK_EDGE_CASE(wide::cost_grad_kernel, wide::hess_kernel, DD, EE, 32, NN)
#define GRAPHIK_EDGE_D(DD)                                                                 \
  if (a.N > kMaxN) {                                                                       \
    GRAPHIK_EDGE_ONE(DD, 1, 2) GRAPHIK_EDGE_ONE(DD, 2, 2) GRAPHIK_EDGE_ONE(DD, 3, 2)       \
    GRAPHIK_EDGE_ONE(DD, 4, 2) GRAPHIK_EDGE_ONE(DD, 5, 2) GRAPHIK_EDGE_ONE(DD, 6, 2)       \
    GRAPHIK_EDGE_ONE(DD, 7, 2) GRAPHIK_EDGE_ONE(DD, 8, 2)                                  \
  } else {                                                                                 \
    GRAPHIK_EDGE_ONE(DD, 5, 1) GRAPHIK_EDGE_ONE(DD, 6, 1) GRAPHIK_EDGE_ONE(DD, 7, 1)       \
    GRAPHIK_EDGE_ONE(DD, 8, 1)                                                             \
  }
  GRAPHIK_EDGE_D(3) GRAPHIK_EDGE_D(2)
#undef GRAPHIK_EDGE_D
#undef GRAPHIK_EDGE_ONE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace graphik
