// The TR kernel's instances past 64 nodes or 256 edges (N <= 128, E <= 512):
// four node slots a lane, one instance a warp, the per-edge state in shared
// memory (csrc/tr_kernel.cuh). 1 to 4 edges a lane are here; 5 to 16 in
// csrc/tr_solve_n128_e256.cu, _e384.cu and _e512.cu, so that nvcc builds
// them in parallel.

#include "tr_kernel.cuh"

namespace graphik {

int launch_n128_e256(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s,
                     bool go, int* info);
int launch_n128_e384(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s,
                     bool go, int* info);
int launch_n128_e512(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s,
                     bool go, int* info);

int launch_n128(const Problem& pr, int D, int epl, const Params& P, cudaStream_t s, bool go,
                int* info) {
  if (epl > 12) return launch_n128_e512(pr, D, epl, P, s, go, info);
  if (epl > 8) return launch_n128_e384(pr, D, epl, P, s, go, info);
  if (epl > 4) return launch_n128_e256(pr, D, epl, P, s, go, info);
  return launch_range<32, 4, 1, 4>(pr, D, epl, P, s, go, info);
}

}  // namespace graphik
