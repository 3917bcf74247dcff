// The TR kernel's instances past 64 nodes or 256 edges with 5 to 8 edges a
// lane: four node slots a lane, one instance a warp (csrc/tr_kernel.cuh,
// dispatched from csrc/tr_solve_n128.cu).

#include "tr_kernel.cuh"

namespace graphik {

int launch_n128_e256(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s,
                     bool go, int* info) {
  return launch_range<32, 4, 5, 8>(pr, D, epl, P, s, go, info);
}

}  // namespace graphik
