"""Batched Riemannian solvers over the rank-d PSD quotient manifold.

Port of graphik_tpu/solvers/riemannian.py. A point is Y in R^{N x d}
representing the Gram matrix Y Y^T; the horizontal projection solves a
Lyapunov system reduced to d(d-1)/2 unknowns; the retraction is Y + U.

* Trust region (`solve`, TRParams): runs on the compiled edge form - the
  CUDA kernel for f32 CUDA tensors, the plain torch version of the same
  loop on the CPU (ops/tr_solve.py). The JAX package's "dense" and "edge"
  XLA backends compute the same algorithm and are the parity oracles in the
  tests.
* Conjugate gradient (`solve_cg`, CGParams): Hager-Zhang CG with an
  adaptive Armijo line search, eager batched torch over the dense masked
  costs (solvers/costs.py) or the edge form (ops/edge.py); no kernel.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from graphik_tpu_torch.ops import edge as edge_ops
from graphik_tpu_torch.ops.tr_solve import solve_tr
from graphik_tpu_torch.solvers import costs
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


@dataclasses.dataclass(frozen=True)
class CGParams:
    """Riemannian conjugate-gradient hyperparameters (the JAX CGParams):
    Hager-Zhang beta, an adaptive Armijo line search, a Powell restart when
    successive gradients lose orthogonality (orth_value; the default 1e10
    effectively never restarts), and gradnorm / stepsize stops.

    plateau_every: the per-lane cost-plateau stop, as TRParams'; 0 disables
    it, `production()` opts in. backend: "dense" (solvers/costs.py, masked
    (N, N) algebra) or "edge" (ops/edge.py) cost evaluation.
    """

    maxiter: int = 1000
    mingradnorm: Optional[float] = None  # default by dtype: 2e-6 f32, 1e-9 f64
    minstepsize: float = 1e-10
    orth_value: float = 1e10
    # line search
    ls_contraction: float = 0.5
    ls_optimism: float = 2.0
    ls_suff_decr: float = 1e-4
    ls_maxiter: int = 25
    ls_initial: float = 1.0
    plateau_every: int = 0
    plateau_rtol: float = 1e-4
    plateau_atol: float = 0.0
    backend: str = "dense"

    @classmethod
    def production(cls, **overrides) -> "CGParams":
        """Tuned serving preset: opts into the plateau stop (see
        TRParams.production)."""
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


# line searches whose slowest lane sets how many evaluations the next one
# runs before its first host read
LS_WINDOW = 16


def _inner(a, b):
    """Per-lane Frobenius inner product of (B, N, d) tensors."""
    return (a * b).sum(dim=(-2, -1))


def _cg_batch(Y0, cost_fn, grad_fn, p: CGParams):
    """Riemannian CG on a batch of lanes, each with the JAX package's
    per-instance trajectory (its vmapped while_loops): a finished lane
    keeps its state; each lane's line search stops on its own condition
    and counts its own evaluations; the batch runs until every lane is
    done. Transport is the horizontal projection at the new point (the
    total space is Euclidean).

    The flags stay on the device. Each line search first runs the least
    number of evaluations that its slowest lane needed in any of the last
    LS_WINDOW line searches, a lane that has stopped searching kept as it
    is by its flag; it then reads whether any lane still searches (and,
    once an iteration, whether any is still running) after each evaluation.
    Each read adds one to `solve_cg.host_reads`.
    """
    dt, dev = Y0.dtype, Y0.device
    B = Y0.shape[0]
    tiny = torch.finfo(dt).tiny
    mingradnorm = p.mingradnorm
    if mingradnorm is None:
        mingradnorm = 1e-9 if dt == torch.float64 else 2e-6

    Y, fx, grad = Y0, cost_fn(Y0), grad_fn(Y0)
    norm_grad = torch.sqrt(_inner(grad, grad))
    d = -grad
    oldalpha = torch.zeros(B, dtype=dt, device=dev)
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    fx_ref = fx
    zero = torch.zeros((), dtype=dt, device=dev)
    needed = collections.deque(maxlen=LS_WINDOW)  # the slowest lane's evaluations

    def lane(v):
        return v[:, None, None]

    while True:
        running = ~done
        # not a descent direction: restart along the steepest descent
        df0 = _inner(grad, d)
        bad = df0 >= 0
        d = torch.where(lane(bad), -grad, d)
        df0 = torch.where(bad, -norm_grad ** 2, df0)

        # adaptive Armijo backtracking, each lane on its own condition
        norm_d = torch.sqrt(_inner(d, d))
        alpha = torch.where(oldalpha > 0, oldalpha,
                            p.ls_initial / torch.clamp(norm_d, min=tiny))
        newf = cost_fn(Y + lane(alpha) * d)
        evals = torch.ones(B, dtype=torch.int64, device=dev)

        def searching():
            return running & (newf > fx + p.ls_suff_decr * alpha * df0) & (evals <= p.ls_maxiter)

        def contract():
            nonlocal alpha, newf, evals, search
            alpha = torch.where(search, alpha * p.ls_contraction, alpha)
            newf = torch.where(search, cost_fn(Y + lane(alpha) * d), newf)
            evals = evals + search
            search = searching()

        def read(*flags):
            solve_cg.host_reads += 1
            return torch.stack([search.sum(), evals.max()] + list(flags)).tolist()

        search = searching()
        for _ in range(min(needed, default=1) - 1):
            contract()
        any_search, n_evals, any_running = read(running.sum())
        if not any_running:
            break
        while any_search:
            contract()
            any_search, n_evals = read()
        needed.append(n_evals)
        # no decrease at all: reject the step (alpha = 0)
        alpha = torch.where(newf > fx, zero, alpha)
        newf = torch.where(alpha > 0, newf, fx)
        # memory: one contraction keeps alpha, otherwise be optimistic
        oldalpha_new = torch.where(evals == 2, alpha, p.ls_optimism * alpha)
        stepsize = alpha * norm_d

        Y_new = Y + lane(alpha) * d
        g_new = grad_fn(Y_new)
        norm_g_new = torch.sqrt(_inner(g_new, g_new))
        # Powell restart when successive gradients lose orthogonality
        orth = _inner(g_new, grad).abs() / torch.clamp(norm_g_new ** 2, min=tiny)
        powell = orth >= p.orth_value
        # Hager-Zhang beta with its robustness floor
        d_t = manifold_proj(Y_new, d)
        g_t = manifold_proj(Y_new, grad)
        diff = g_new - g_t
        deno = _inner(diff, d_t)
        nonzero = deno.abs() > 0
        safe_deno = torch.where(nonzero, deno, torch.ones_like(deno))
        numo = _inner(diff, g_new) - 2.0 * _inner(diff, diff) * _inner(d_t, g_new) / safe_deno
        beta = numo / safe_deno
        norm_dt = torch.sqrt(_inner(d_t, d_t))
        eta_hz = -1.0 / torch.clamp(norm_dt * torch.clamp(norm_grad, max=0.01), min=tiny)
        beta = torch.maximum(beta, eta_hz)
        beta = torch.where(nonzero & ~powell, beta, zero)
        d_new = -g_new + lane(beta) * d_t

        k_new = k + 1
        done_new = (norm_g_new < mingradnorm) | (stepsize < p.minstepsize) | (k_new >= p.maxiter)
        fx_ref_new = fx_ref
        if p.plateau_every:
            at_check = (k_new % p.plateau_every) == 0
            stalled = (fx_ref - newf) <= p.plateau_rtol * newf + p.plateau_atol
            done_new = done_new | (at_check & stalled)
            fx_ref_new = torch.where(at_check, newf, fx_ref)

        # a finished lane keeps its state
        Y = torch.where(lane(running), Y_new, Y)
        fx = torch.where(running, newf, fx)
        grad = torch.where(lane(running), g_new, grad)
        norm_grad = torch.where(running, norm_g_new, norm_grad)
        d = torch.where(lane(running), d_new, d)
        oldalpha = torch.where(running, oldalpha_new, oldalpha)
        k = torch.where(running, k_new, k)
        fx_ref = torch.where(running, fx_ref_new, fx_ref)
        done = done | (running & done_new)

    return {"Y": Y, "cost": fx, "gradnorm": norm_grad, "iterations": k,
            "num_inner": torch.zeros(B, dtype=torch.int32, device=dev)}


def solve_cg(
    Y0,
    D_goal,
    omega,
    psi_L=None,
    psi_U=None,
    params: CGParams = CGParams(),
    anchors=None,
):
    """Batched Riemannian conjugate-gradient solve of the EDM completion
    problem; the same data contract as `solve`.

    Returns dict of per-instance results: Y, cost, gradnorm, iterations,
    and num_inner, which is all zeros - CG has no inner solver, and the
    JAX package fills the key with zeros too.
    """
    N, d = Y0.shape[-2], Y0.shape[-1]
    dt, dev = Y0.dtype, Y0.device
    omega_host = np.asarray(omega, np.float64)
    if psi_L is None:
        psi_L_host = psi_U_host = np.zeros((N, N))
    else:
        psi_L_host = np.asarray(psi_L, np.float64)
        psi_U_host = np.asarray(psi_U, np.float64)
    batch = Y0.shape[:-2]
    Yf = Y0.reshape((-1, N, d))
    D = D_goal.to(dt).expand(batch + (N, N)).reshape((-1, N, N))

    if params.backend == "edge":
        ep = edge_ops.build_edge_problem(omega_host, psi_L_host, psi_U_host, dim=d,
                                         anchors=anchors)
        dg_e = ep.edge_values(D)

        def cost_fn(Y):
            return edge_ops.cost(ep, Y, dg_e)

        def grad_fn(Y):
            return edge_ops.egrad(ep, Y, dg_e)
    elif params.backend == "dense":
        def dev_t(x):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        L_mask, U_mask = costs.make_masks(omega_host, psi_L_host, psi_U_host)
        masks = tuple(dev_t(m) for m in (omega_host, psi_L_host, psi_U_host, L_mask, U_mask))
        anc = None
        if anchors is not None:  # on the device once, not at every evaluation
            anc = {k: dev_t(anchors[k]) for k in ("centers", "psi_L", "psi_U", "L_mask", "U_mask")}
            anc["idx"] = torch.as_tensor(np.asarray(anchors["idx"]), dtype=torch.long, device=dev)

        def cost_fn(Y):
            return costs.cost(Y, D, *masks, anc)

        def grad_fn(Y):
            return costs.egrad(Y, D, *masks, anc)
    else:
        raise ValueError(f"unknown CG backend {params.backend!r}")

    out = _cg_batch(Yf, cost_fn, grad_fn, params)
    return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}


solve_cg.host_reads = 0
