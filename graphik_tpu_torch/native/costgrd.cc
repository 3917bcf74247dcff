// Native CPU reference kernels for the masked EDM-completion cost: the
// port's float64 edge-list oracle (a copy of graphik_tpu/native/costgrd.cc,
// so both packages are held to the same arithmetic). The port's plain
// float64 costs (graphik_tpu_torch/ops/edge.py, solvers/costs.py) are
// checked against it. f64, edge-list (COO) iteration, batched over
// instances, OpenMP over the batch where the compiler has it.
//
// Semantics:
//   dist_e   = || y_i - y_j ||^2                 for edge e = (i, j), i < j
//   s0_e     = omega_e * (dgoal_e - dist_e)
//   e1_e     = lmask_e * max(psiL_e - dist_e, 0)
//   e2_e     = umask_e * max(dist_e - psiU_e, 0)
//   f        = sum_e (s0^2 + e1^2 + e2^2)        [== dense 0.5*||.||_F^2 over
//                                                 both triangles]
//   grad_i   = -2 sum_{e at i} s_e * sgn * (y_i - y_j),  s = s0 + e1 - e2
//   hess(Z)_i = 2 sum_{e at i} sgn * (m_e * dD_e * diffY - s_e * diffZ),
//     dD_e = 2 diffY . diffZ,  m_e = omega_e + lmask_e*[e1>0] + umask_e*[e2>0]
//
// Exact-distance variants are the same entry points with lmask = umask = 0.
// All arrays are C-contiguous f64 unless noted.

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int kMaxDim = 3;

inline void edge_terms(const double* Yb, const double* dgoal_b,
                       const int32_t* ei, const int32_t* ej,
                       const double* omega, const double* psil,
                       const double* psiu, const double* lmask,
                       const double* umask, int64_t e, int64_t d,
                       double* diff, double* dist, double* s0, double* e1,
                       double* e2) {
  const int32_t i = ei[e];
  const int32_t j = ej[e];
  double acc = 0.0;
  for (int64_t k = 0; k < d; ++k) {
    const double dk = Yb[i * d + k] - Yb[j * d + k];
    diff[k] = dk;
    acc += dk * dk;
  }
  *dist = acc;
  *s0 = omega[e] * (dgoal_b[e] - acc);
  const double lo = psil[e] - acc;
  const double hi = acc - psiu[e];
  *e1 = lmask[e] * (lo > 0.0 ? lo : 0.0);
  *e2 = umask[e] * (hi > 0.0 ? hi : 0.0);
}

}  // namespace

extern "C" {

// f(Y) per instance. Y: (B, N, d); dgoal: (B, E); omega/psil/psiu/lmask/
// umask: (E,); ei/ej: (E,) int32; out_f: (B,).
void gtpu_cost(const double* Y, const double* dgoal, const int32_t* ei,
               const int32_t* ej, const double* omega, const double* psil,
               const double* psiu, const double* lmask, const double* umask,
               int64_t B, int64_t N, int64_t d, int64_t E, double* out_f) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    const double* Yb = Y + b * N * d;
    const double* gb = dgoal + b * E;
    double f = 0.0;
    double diff[kMaxDim];
    for (int64_t e = 0; e < E; ++e) {
      double dist, s0, e1, e2;
      edge_terms(Yb, gb, ei, ej, omega, psil, psiu, lmask, umask, e, d, diff,
                 &dist, &s0, &e1, &e2);
      f += s0 * s0 + e1 * e1 + e2 * e2;
    }
    out_f[b] = f;
  }
}

// f(Y) and Euclidean gradient. out_g: (B, N, d).
void gtpu_cost_and_grad(const double* Y, const double* dgoal,
                        const int32_t* ei, const int32_t* ej,
                        const double* omega, const double* psil,
                        const double* psiu, const double* lmask,
                        const double* umask, int64_t B, int64_t N, int64_t d,
                        int64_t E, double* out_f, double* out_g) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    const double* Yb = Y + b * N * d;
    const double* gb = dgoal + b * E;
    double* Gb = out_g + b * N * d;
    std::memset(Gb, 0, sizeof(double) * N * d);
    double f = 0.0;
    double diff[kMaxDim];
    for (int64_t e = 0; e < E; ++e) {
      double dist, s0, e1, e2;
      edge_terms(Yb, gb, ei, ej, omega, psil, psiu, lmask, umask, e, d, diff,
                 &dist, &s0, &e1, &e2);
      f += s0 * s0 + e1 * e1 + e2 * e2;
      const double s = s0 + e1 - e2;
      const int32_t i = ei[e];
      const int32_t j = ej[e];
      for (int64_t k = 0; k < d; ++k) {
        const double g = -2.0 * s * diff[k];
        Gb[i * d + k] += g;
        Gb[j * d + k] -= g;
      }
    }
    out_f[b] = f;
  }
}

// Hessian-vector product at Y along Z. Z/out_h: (B, N, d).
void gtpu_hess(const double* Y, const double* Z, const double* dgoal,
               const int32_t* ei, const int32_t* ej, const double* omega,
               const double* psil, const double* psiu, const double* lmask,
               const double* umask, int64_t B, int64_t N, int64_t d, int64_t E,
               double* out_h) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    const double* Yb = Y + b * N * d;
    const double* Zb = Z + b * N * d;
    const double* gb = dgoal + b * E;
    double* Hb = out_h + b * N * d;
    std::memset(Hb, 0, sizeof(double) * N * d);
    double diffY[kMaxDim];
    double diffZ[kMaxDim];
    for (int64_t e = 0; e < E; ++e) {
      double dist, s0, e1, e2;
      edge_terms(Yb, gb, ei, ej, omega, psil, psiu, lmask, umask, e, d, diffY,
                 &dist, &s0, &e1, &e2);
      const int32_t i = ei[e];
      const int32_t j = ej[e];
      double dD = 0.0;
      for (int64_t k = 0; k < d; ++k) {
        diffZ[k] = Zb[i * d + k] - Zb[j * d + k];
        dD += diffY[k] * diffZ[k];
      }
      dD *= 2.0;
      const double s = s0 + e1 - e2;
      const double m =
          omega[e] + lmask[e] * (e1 > 0.0 ? 1.0 : 0.0) +
          umask[e] * (e2 > 0.0 ? 1.0 : 0.0);
      for (int64_t k = 0; k < d; ++k) {
        const double h = 2.0 * (m * dD * diffY[k] - s * diffZ[k]);
        Hb[i * d + k] += h;
        Hb[j * d + k] -= h;
      }
    }
  }
}

}  // extern "C"
