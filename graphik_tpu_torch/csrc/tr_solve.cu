// The TR kernel's entry points and its instances up to 32 nodes and 128
// edges (one node a lane, up to 4 edges a lane: EPL <= 4, W = 16 or 32);
// the kernel itself, what it replaces and why it is built as it is are in
// csrc/tr_kernel.cuh. Larger problems dispatch to csrc/tr_solve_e256.cu
// (N <= 32, 128 < E <= 256), csrc/tr_solve_n64.cu /
// csrc/tr_solve_n64_e256.cu (32 < N <= 64, two nodes a lane) and
// csrc/tr_solve_n128*.cu (four nodes a lane: 64 < N <= 128, or any N with
// 256 < E <= 512).
//
// The entry point allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include "tr_kernel.cuh"

namespace {

using namespace graphik;

int dispatch(const Problem& pr, int D, const Params& P, cudaStream_t s, bool go, int* info) {
  if (pr.B < 1 || pr.N < 1 || pr.N > kMaxNodes || pr.E < 1 || pr.E > kMaxEdges ||
      pr.dg_stride < pr.E)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pr.A < 0 || pr.A > kMaxA ||
      (pr.A > 0 && (pr.a_nsel < 1 || pr.a_nsel > pr.N || pr.a_R < 1 ||
                    pr.a_R > kMaxGroupRows || pr.a_nsel * pr.a_R != pr.A)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = paired(pr.N, pr.E, pr.A, pr.a_R);
  const int epl = two ? (pr.E + 15) / 16 : (pr.E + 31) / 32;
  if (pr.N > 2 * kMaxN || epl > 8) return launch_n128(pr, D, epl, P, s, go, info);
  if (pr.N > kMaxN) return launch_n64(pr, D, epl, P, s, go, info);
  if (epl > 4) return launch_e256(pr, D, epl, P, s, go, info);
  return two ? launch_range<16, 1, 1, 4>(pr, D, epl, P, s, go, info)
             : launch_range<32, 1, 1, 4>(pr, D, epl, P, s, go, info);
}

}  // namespace

// A == 0 runs the anchor-free kernel; A > 0 takes the anchor tables: acen
// (D, A) and apar (4, A) row-major f32, anode (a_nsel,) int32, with
// A == a_nsel * a_R (group g is rows g * a_R .. (g + 1) * a_R - 1).
// a_near: the skip bound's reach in the anchors' distance unit (0
// evaluates every row).
extern "C" int graphik_tr_solve(
    const float* Y0, const float* dgoal, int dg_stride, const int* ei, const int* ej,
    const float* epar, const int* rowptr, const int* inc, const float* acen,
    const float* apar, const int* anode, float* Yout, float* cost,
    float* gradnorm, int* iters, int* ninner, int B, int N, int D, int E, int A, int a_nsel,
    int a_R, int maxiter, int maxinner, int mininner, int plateau_every, float mingradnorm,
    float kappa, float theta, float rho_prime, float rho_regularization, float Delta_bar,
    float Delta0, float plateau_rtol, float plateau_atol, float res_tol, float a_near,
    void* stream) {
  const Problem pr{Y0, dgoal, dg_stride, ei, ej, epar, rowptr, inc, acen, apar, anode,
                   Yout, cost, gradnorm, iters, ninner, B, N, E, A, a_nsel, a_R};
  const Params P{maxiter, maxinner, mininner, plateau_every, mingradnorm, kappa,
                 theta, rho_prime, rho_regularization, Delta_bar, Delta0,
                 plateau_rtol, plateau_atol, res_tol, a_near};
  return dispatch(pr, D, P, static_cast<cudaStream_t>(stream), true, nullptr);
}

// The launch shape graphik_tr_solve would use for these sizes: info[0..3] =
// blocks launched, blocks resident on the card, instances per block, and 1
// when two instances share a warp.
extern "C" int graphik_tr_shape(int B, int N, int D, int E, int A, int a_nsel, int a_R,
                                int* info) {
  Problem pr{};
  pr.B = B;
  pr.N = N;
  pr.E = E;
  pr.dg_stride = E;
  pr.A = A;
  pr.a_nsel = a_nsel;
  pr.a_R = a_R;
  info[3] = paired(N, E, A, a_R) ? 1 : 0;
  return dispatch(pr, D, Params{}, nullptr, false, info);
}
