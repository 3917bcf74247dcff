// K5's instances past n = 32 in float32 (csrc/eigh_wide.cuh), built by an nvcc
// process of their own beside csrc/eigh.cu, which launches them.

#include "eigh_wide.cuh"

// A (B, n, n) -> W (B, n), V (B, n, n), conv (B,), 33 <= n <= 64; the
// launch's cudaError_t.
extern "C" int graphik_sym_eigh_wide_f32(const void* A, void* W, void* V, void* conv, int B,
                                         int n, cudaStream_t stream) {
  return launch_wide_n<float>(A, W, V, conv, B, n, stream);
}
