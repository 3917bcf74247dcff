// The TR kernel's instances for N <= 32 and 128 < E <= 256: one node a
// lane, 5 to 8 edges a lane, one instance a warp (csrc/tr_kernel.cuh).

#include "tr_kernel.cuh"

namespace graphik {

int launch_e256(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s, bool go,
                int* info) {
  return launch_range<32, 1, 5, 8>(pr, D, epl, P, s, go, info);
}

}  // namespace graphik
