// The TR kernel's instances for 32 < N <= 64 and E <= 128: two nodes a
// lane, 1 to 4 edges a lane, one instance a warp (csrc/tr_kernel.cuh); 5 to
// 8 edges a lane are in csrc/tr_solve_n64_e256.cu.

#include "tr_kernel.cuh"

namespace graphik {

int launch_n64_e256(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s, bool go,
                    int* info);

int launch_n64(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s, bool go,
               int* info) {
  if (epl > 4) return launch_n64_e256(pr, D, epl, P, s, go, info);
  return launch_range<32, 2, 1, 4>(pr, D, epl, P, s, go, info);
}

}  // namespace graphik
