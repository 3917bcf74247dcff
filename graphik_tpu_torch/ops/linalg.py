"""Small-matrix linear algebra: the LM's damped solve (K6), the CIDGIK
ADMM's factors, and sums whose order does not depend on an instance's
batch position.

Port of the parts of graphik_tpu/ops/linalg.py that the port runs. The JAX
package unrolls its Cholesky, triangular solves and small matmuls by hand
because XLA's generic versions are slow to compile and, on a TPU, run
their inner products at bf16. Neither holds here, so CIDGIK's
factorizations are `torch.linalg.cholesky` and
`torch.linalg.solve_triangular`, and the products are batched matmuls in
true float32 (with TF32 off, as the entry points' callers set it).

The LM polish is the exception. Its step is `spd_solve_unrolled`, a
Cholesky whose pivots are clamped to sqrt(1e-30), and the JAX package runs
that on every backend: where a float32 damped system is not numerically
positive definite, the clamped pivot still gives a step (huge, or NaN),
which the LM's improvement test then takes or refuses. Its numerics are the
reference's, so the port keeps them:

* `spd_solve_cuda(A, b)` - wrapper of the hand-written CUDA kernel
  csrc/spd_solve.cu (K6: a thread a system up to m = 10, a warp a system
  past it, the factor and both substitutions in one launch): float32 or
  float64 CUDA tensors, m <= 128; counts its launches in
  `spd_solve_cuda.launches`.
* `spd_solve_reference(A, b)` - the plain torch version, the kernel's
  arithmetic in the kernel's order, on any device and at any m.
* `spd_solve(A, b)` - the kernel for CUDA tensors, the plain version for
  CPU tensors; on a card it raises past m = 128, and anywhere for another
  dtype, or when the build or the launch fails; it never falls back.
"""

from __future__ import annotations

import math

import torch

from graphik_tpu_torch.utils import lie

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


# the largest system K6 takes (four rows a lane of one warp)
MAX_SPD = 128
# the floor of a pivot's square (graphik_tpu/ops/linalg.py chol_unrolled)
PIVOT_FLOOR = 1e-30


def check_spd_limits(A, b, max_m=None):
    """Raise unless A (..., m, m) and b (..., m) are one float32 or float64
    stack of systems with 1 <= m (and m <= max_m when it is given: K6's
    MAX_SPD)."""
    if A.dtype not in (torch.float32, torch.float64) or b.dtype != A.dtype:
        raise TypeError(f"spd_solve takes float32 or float64 A and b of one dtype, not "
                        f"{A.dtype} and {b.dtype}")
    if A.ndim < 2 or A.shape[-1] != A.shape[-2] or A.shape[:-1] != b.shape:
        raise ValueError(f"spd_solve takes A (..., m, m) and b (..., m), not {tuple(A.shape)} "
                         f"and {tuple(b.shape)}")
    if A.shape[-1] < 1:
        raise ValueError(f"spd_solve takes 1 <= m, not m = {A.shape[-1]}")
    if max_m is not None and A.shape[-1] > max_m:
        raise ValueError(f"spd_solve's kernel takes m <= {max_m}, not m = {A.shape[-1]}")


def spd_solve_cuda(A, b):
    """csrc/spd_solve.cu (K6) on float32 / float64 CUDA stacks A (..., m,
    m), b (..., m), m <= 128: x = A^-1 b by the clamped-pivot Cholesky,
    from A's lower triangle; one launch, added to `spd_solve_cuda.launches`."""
    check_spd_limits(A, b, MAX_SPD)
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"spd_solve_cuda takes CUDA tensors on one device, not {A.device} "
                         f"and {b.device}")
    m = A.shape[-1]
    Af = A.reshape(-1, m, m).contiguous()
    bf = b.reshape(-1, m).contiguous()
    x = torch.empty_like(bf)
    if x.shape[0] == 0:
        return x.reshape(b.shape)
    from graphik_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(A.device):  # the launch goes to the current device
        rc = lib.graphik_spd_solve(Af.data_ptr(), bf.data_ptr(), x.data_ptr(), x.shape[0], m,
                                   int(A.dtype == torch.float64),
                                   torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spd_solve kernel launch failed: cudaError {rc}")
    spd_solve_cuda.launches += 1
    return x.reshape(b.shape)


spd_solve_cuda.launches = 0


def spd_solve_reference(A, b):
    """The plain torch version of csrc/spd_solve.cu: x = A^-1 b for A (...,
    m, m), b (..., m), float32 or float64, any m >= 1, any device, from
    A's lower triangle, as graphik_tpu/ops/linalg.py spd_solve_unrolled
    computes it: the left-looking Cholesky with each pivot
    sqrt(max(a_jj - sum_k L_jk^2, 1e-30)) (NaN stays NaN), then the forward
    and backward substitutions. Every dot product is summed first, one
    product and one add at a time (over k = 0, 1, ... in the factor and the
    forward substitution, k = m - 1, m - 2, ... in the backward one), and
    subtracted after; on a card the kernel's results are these bit for
    bit. The pivot's sqrt is lie.sqrt_rn, correctly rounded on every
    device, as the kernel's and the JAX package's are (torch's own float32
    sqrt is not on the CPU); torch's division is correctly rounded. The loops run over k, vectorised over the batch and the
    rows: each column's products are added to every later column's sums
    as soon as it is known, which keeps each sum's order."""
    check_spd_limits(A, b)
    m = A.shape[-1]
    A = A.reshape(-1, m, m)
    b = b.reshape(-1, m)
    L = torch.zeros_like(A)
    acc = torch.zeros_like(A)  # acc[:, i, j] = sum over k < j of L_ik L_jk
    for j in range(m):
        col = A[:, j:, j] - acc[:, j:, j]
        d = lie.sqrt_rn(torch.clamp(col[:, 0], min=PIVOT_FLOOR))
        L[:, j, j] = d
        if j + 1 < m:
            L[:, j + 1:, j] = col[:, 1:] / d[:, None]
            acc[:, j + 1:, j + 1:] += L[:, j + 1:, j, None] * L[:, None, j + 1:, j]
    y = torch.zeros_like(b)
    s = torch.zeros_like(b)
    for i in range(m):
        y[:, i] = (b[:, i] - s[:, i]) / L[:, i, i]
        s[:, i + 1:] += L[:, i + 1:, i] * y[:, i, None]
    x = torch.zeros_like(b)
    s = torch.zeros_like(b)
    for i in reversed(range(m)):
        x[:, i] = (y[:, i] - s[:, i]) / L[:, i, i]
        s[:, :i] += L[:, i, :i] * x[:, i, None]
    return x.reshape(b.shape)


def spd_solve(A, b):
    """x = A^-1 b for the stack A (..., m, m), b (..., m), float32 or
    float64, by the clamped-pivot Cholesky from A's lower triangle:
    csrc/spd_solve.cu (K6) for CUDA tensors (m <= 128), the plain version
    for CPU tensors (any m)."""
    if A.device.type == "cuda":
        return spd_solve_cuda(A, b)
    return spd_solve_reference(A, b)


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
