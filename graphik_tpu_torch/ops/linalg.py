"""Small-matrix linear algebra for the CIDGIK ADMM, and sums whose order
does not depend on an instance's batch position.

Port of the parts of graphik_tpu/ops/linalg.py that CIDGIK runs. The JAX
package unrolls its Cholesky, triangular solves and small matmuls by hand
because XLA's generic versions are slow to compile and, on a TPU, run
their inner products at bf16. Neither holds here: the factorizations are
`torch.linalg.cholesky` and `torch.linalg.solve_triangular`, and the
products are batched matmuls in true float32 (with TF32 off, as the entry
points' callers set it).
"""

from __future__ import annotations

import math

import torch

# torch's CUDA reduction vectorises the loads of a contiguous extent longer
# than this and starts each output's slice at its own misalignment, so the
# sum of an instance's values would round by its address, that is by its
# batch position whenever an instance's size is not a multiple of 16 bytes
ROW = 128


def rowwise_sum(x, dims: int = 1):
    """x summed over its last `dims` dimensions: one order at every batch
    position, on the CPU and on a card. Up to ROW values an instance, one
    reduction over them all; past that the last dimension first, each
    reduction over at most ROW values (a longer last dimension is summed in
    pieces of ROW, zero-padded, then the pieces)."""
    if math.prod(x.shape[-dims:]) <= ROW:
        return x.sum(dim=tuple(range(-dims, 0)))
    for _ in range(dims):
        n = x.shape[-1]
        if n > ROW:
            k = -(-n // ROW)
            x = torch.nn.functional.pad(x, (0, k * ROW - n)).unflatten(-1, (k, ROW)).sum(-1)
        x = x.sum(-1)
    return x


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
    nrm = torch.sqrt(rowwise_sum(W * W, 2))[:, None, None]
    S = W / torch.clamp(nrm, min=torch.finfo(W.dtype).tiny)
    eye3 = torch.eye(shape[-1], dtype=W.dtype, device=W.device).mul_(3.0).expand(W.shape)
    for _ in range(iters):
        T = torch.baddbmm(eye3, S, S, alpha=-1.0)  # 3 I - S S
        S = torch.baddbmm(S, S, T, beta=0.0, alpha=0.5)  # S T / 2
    # resymmetrize: rounding drift in the iteration is skew-amplified
    absW = torch.bmm(W, S)
    absW = 0.5 * (absW + absW.transpose(-1, -2))
    return (0.5 * (W + absW)).reshape(shape)
