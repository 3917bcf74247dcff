"""Batched Riemannian trust-region solver over the rank-d PSD quotient manifold.

Port of graphik_tpu/solvers/riemannian.py (the TR path). A point is Y in
R^{N x d} representing the Gram matrix Y Y^T; the horizontal projection
solves a Lyapunov system reduced to d(d-1)/2 unknowns; the retraction is
Y + U. The solve runs on the compiled edge form: the CUDA kernel for f32
CUDA tensors, the plain torch version of the same loop on the CPU
(ops/tr_solve.py). The JAX package's "dense" and "edge" XLA backends
compute the same algorithm and are the parity oracles in the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graphik_tpu_torch.ops import edge as edge_ops
from graphik_tpu_torch.ops.tr_solve import solve_tr
from graphik_tpu_torch.utils import dgp


@dataclasses.dataclass(frozen=True)
class TRParams:
    """Trust-region hyperparameters (the JAX TRParams' TR knobs).

    plateau_every: per-lane cost-plateau stop - every `plateau_every` outer
    iterations a lane stops if its cost decreased by less than
    plateau_rtol * cost + plateau_atol over the window. 0 disables it (the
    reference's maxiter/gradnorm-only stopping); `production()` opts in.
    res_tol: stop a lane once its max relative edge residual drops below
    res_tol (0 disables).
    """

    maxiter: int = 3000
    mingradnorm: Optional[float] = None  # default by dtype: 2e-6 f32, 0.5e-9 f64
    theta: float = 1.0
    kappa: float = 0.1
    rho_prime: float = 0.1
    rho_regularization: float = 1e3
    maxinner: Optional[int] = None  # default: N*d (CG dimension)
    mininner: int = 1
    Delta_bar: Optional[float] = None  # default: 10 + d
    Delta0: Optional[float] = None  # default: Delta_bar / 8
    plateau_every: int = 0
    plateau_rtol: float = 1e-4
    plateau_atol: float = 0.0
    res_tol: float = 0.0

    @classmethod
    def production(cls, **overrides) -> "TRParams":
        """Tuned serving preset: opts into the plateau stop (in float32 the
        gradnorm test almost never fires, so without it every lane burns
        the full maxiter budget)."""
        base = dict(plateau_every=16)
        base.update(overrides)
        return cls(**base)


def manifold_proj(Y, Z):
    """Horizontal-space projection on the PSDFixedRank quotient.

    Solves X Om + Om X = C with X = Y^T Y, C = Y^T Z - Z^T Y, and returns
    Z - Y Om. Om is antisymmetric, so the system has d(d-1)/2 unknowns: a
    scalar for d = 2, a 3x3 SPD solve for d = 3. A small Tikhonov shift
    keeps it finite when Y is (nearly) rank deficient.
    """
    d = Y.shape[-1]
    X = Y.transpose(-1, -2) @ Y
    YtZ = Y.transpose(-1, -2) @ Z
    C = YtZ - YtZ.transpose(-1, -2)
    reg = 10 * torch.finfo(Y.dtype).eps * (
        torch.diagonal(X, dim1=-2, dim2=-1).sum(-1) + 1e-30)
    zero = torch.zeros_like(reg)
    if d == 2:
        a = C[..., 0, 1] / (X[..., 0, 0] + X[..., 1, 1] + reg)
        Om = torch.stack([torch.stack([zero, a], -1), torch.stack([-a, zero], -1)], -2)
    elif d == 3:
        # Basis (a, b, c) -> Om = [[0, a, b], [-a, 0, c], [-b, -c, 0]];
        # M = [[X11+X22, X23, -X13], [X23, X11+X33, X12], [-X13, X12, X22+X33]].
        x11, x22, x33 = X[..., 0, 0], X[..., 1, 1], X[..., 2, 2]
        x12, x13, x23 = X[..., 0, 1], X[..., 0, 2], X[..., 1, 2]
        M = torch.stack([
            torch.stack([x11 + x22 + reg, x23, -x13], -1),
            torch.stack([x23, x11 + x33 + reg, x12], -1),
            torch.stack([-x13, x12, x22 + x33 + reg], -1),
        ], -2)
        rhs = torch.stack([C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]], -1)
        abc = torch.cholesky_solve(rhs[..., None], torch.linalg.cholesky(M))[..., 0]
        a, b, c = abc[..., 0], abc[..., 1], abc[..., 2]
        Om = torch.stack([
            torch.stack([zero, a, b], -1),
            torch.stack([-a, zero, c], -1),
            torch.stack([-b, -c, zero], -1),
        ], -2)
    else:
        raise NotImplementedError(f"manifold_proj for d={d}")
    return Z - Y @ Om


def solve(
    Y0,
    D_goal,
    omega,
    psi_L=None,
    psi_U=None,
    params: TRParams = TRParams(),
    anchors=None,
):
    """Batched Riemannian TR solve of the EDM completion problem.

    Y0 : (..., N, d) initial points; D_goal : (..., N, N) squared goal
    distances; omega, psi_L, psi_U : static (N, N) host masks (psi None =
    no limits); anchors : optional anchored-hinge spec (the host numpy dict
    of ProblemStructure.reduced_spec()) - hinge terms between rows of Y and
    constant points, the obstacle reduction. Returns dict of per-instance
    results (Y, cost, gradnorm, iterations, num_inner).
    """
    N, d = Y0.shape[-2], Y0.shape[-1]
    omega_host = np.asarray(omega, np.float64)
    if psi_L is None:
        psi_L_host = psi_U_host = np.zeros((N, N))
    else:
        psi_L_host = np.asarray(psi_L, np.float64)
        psi_U_host = np.asarray(psi_U, np.float64)
    ep = edge_ops.build_edge_problem(omega_host, psi_L_host, psi_U_host, dim=d,
                                     anchors=anchors)

    batch = Y0.shape[:-2]
    Yf = Y0.reshape((-1, N, d)).contiguous()
    D = D_goal.to(Y0.dtype).expand(batch + (N, N)).reshape((-1, N, N))
    dg_e = ep.edge_values(D).contiguous()
    p = params
    out = solve_tr(
        ep, Yf, dg_e,
        maxiter=p.maxiter,
        maxinner=p.maxinner,
        mingradnorm=p.mingradnorm,
        kappa=p.kappa,
        theta=p.theta,
        rho_prime=p.rho_prime,
        rho_regularization=p.rho_regularization,
        Delta_bar=p.Delta_bar,
        Delta0=p.Delta0,
        mininner=p.mininner,
        plateau_every=p.plateau_every,
        plateau_rtol=p.plateau_rtol,
        plateau_atol=p.plateau_atol,
        res_tol=p.res_tol,
    )
    return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}


def generate_initialization(lb, ub, omega, dim, generator=None, frac=None):
    """MDS initialization from smoothed bounds (the JAX package's "eigh"
    method, which it runs off the TPU): D = (lb + frac (ub - lb))^2 ->
    Gram -> MDS -> linear projection onto R^dim along the dominant
    edge-scatter directions. frac is 0.9, the deterministic init, unless a
    `generator` draws it per entry or `frac` gives it
    (dgp.sample_distance_matrix).

    jnp.linalg.eigh factors (G + G^T) / 2, torch.linalg.eigh reads one
    triangle only, so G is symmetrised first. A sampled D, and so its G, is
    not symmetric; the deterministic G differs from G^T by the rounding of
    its row and column means.
    """
    D_rand = dgp.sample_distance_matrix(lb, ub, generator=generator, frac=frac)
    G = dgp.gram_from_distance_matrix(D_rand)
    G = (G + G.transpose(-1, -2)) / 2.0
    X = dgp.mds(G, eps=1e-8)
    omega = torch.as_tensor(np.asarray(omega), device=lb.device)
    return dgp.linear_projection(X, omega, dim)
