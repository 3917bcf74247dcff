"""Small-matrix linear algebra for the CIDGIK ADMM.

Port of the parts of graphik_tpu/ops/linalg.py that CIDGIK runs. The JAX
package unrolls its Cholesky, triangular solves and small matmuls by hand
because XLA's generic versions are slow to compile and, on a TPU, run
their inner products at bf16. Neither holds here: the factorizations are
`torch.linalg.cholesky` and `torch.linalg.solve_triangular`, and the
products are batched matmuls in true float32 (with TF32 off, as the entry
points' callers set it).
"""

from __future__ import annotations

import torch


def spd_inverse_factor(A):
    """Linv with A^{-1} = Linv^T Linv for SPD A (..., m, m): the inverse of
    A's lower Cholesky factor. Solving A x = b is then two products,
    x = Linv^T (Linv b)."""
    L = torch.linalg.cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def psd_project_ns(W, iters: int = 14):
    """PSD cone projection P = (W + |W|)/2 of symmetric W (..., s, s) via
    the Newton-Schulz matrix sign.

    |W| = W sign(W), and the sign iterates as S <- S (3 I - S^2) / 2 from W
    over its Frobenius norm (a bound on the spectral radius, so the
    iteration converges). Eigenvalues below ~(2/3)^iters of the norm get
    inexact signs, but their share of P is at most |lambda| / 2. Each half
    step is one batched product with its scaling and shift folded in
    (`baddbmm`), which rounds as the separate product and sum do.
    """
    shape = W.shape
    W = W.reshape((-1,) + shape[-2:])
    nrm = torch.sqrt((W * W).sum(dim=(-2, -1), keepdim=True))
    S = W / torch.clamp(nrm, min=torch.finfo(W.dtype).tiny)
    eye3 = torch.eye(shape[-1], dtype=W.dtype, device=W.device).mul_(3.0).expand(W.shape)
    for _ in range(iters):
        T = torch.baddbmm(eye3, S, S, alpha=-1.0)  # 3 I - S S
        S = torch.baddbmm(S, S, T, beta=0.0, alpha=0.5)  # S T / 2
    # resymmetrize: rounding drift in the iteration is skew-amplified
    absW = torch.bmm(W, S)
    absW = 0.5 * (absW + absW.transpose(-1, -2))
    return (0.5 * (W + absW)).reshape(shape)
