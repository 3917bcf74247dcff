"""Batched Riemannian solvers over the rank-d PSD quotient manifold.

Port of graphik_tpu/solvers/riemannian.py. A point is Y in R^{N x d}
representing the Gram matrix Y Y^T; the horizontal projection solves a
Lyapunov system reduced to d(d-1)/2 unknowns; the retraction is Y + U.

* Trust region (`solve`, TRParams): backend "kernel" runs on the compiled
  edge form - the CUDA kernel for f32 CUDA tensors, the plain torch version
  of the same loop on the CPU (ops/tr_solve.py); "dense" and "edge" (the
  JAX package's XLA backends) run an eager batched loop (`_tr_batch`) over
  the dense masked costs (solvers/costs.py) or the edge form (ops/edge.py),
  on any device and dtype. Float64 solves run "dense", as in the JAX
  package.
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
    backend: "kernel" (the JAX package's "pallas": the fused solve of
    ops/tr_solve.py; float64 inputs run "dense"), "dense" or "edge" (see
    `solve`).
    check_model_decrease: the reference's model-increase exit of the tCG
    (it returns the previous eta); "dense" and "edge" honour it, "kernel"
    ignores it, as the JAX package's Pallas kernel does.
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
    check_model_decrease: bool = False
    backend: str = "kernel"

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
    scalar for d = 2, a 3x3 SPD solve for d = 3. For d > 3 it solves the
    whole d^2 x d^2 SPD system, as the JAX package does. A small Tikhonov
    shift keeps it finite when Y is (nearly) rank deficient.
    """
    return projector(Y)(Z)


def projector(Y):
    """Z -> manifold_proj(Y, Z), with the factor of the system, which
    depends on Y alone, computed once."""
    d = Y.shape[-1]
    Yt = Y.transpose(-1, -2)
    X = Yt @ Y
    reg = 10 * torch.finfo(Y.dtype).eps * (
        torch.diagonal(X, dim1=-2, dim2=-1).sum(-1) + 1e-30)
    zero = torch.zeros_like(reg)
    if d == 2:
        den = X[..., 0, 0] + X[..., 1, 1] + reg
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
        L = torch.linalg.cholesky(M)
    else:
        # A[(ij),(kl)] = X[i,k] delta[j,l] + delta[i,k] X[j,l] (row-major vec)
        eye = torch.eye(d, dtype=Y.dtype, device=Y.device)
        A = (X[..., :, None, :, None] * eye[None, :, None, :]
             + eye[:, None, :, None] * X[..., None, :, None, :]).reshape(X.shape[:-2] + (d * d, d * d))
        A = A + reg[..., None, None] * torch.eye(d * d, dtype=Y.dtype, device=Y.device)
        L = torch.linalg.cholesky(A)

    def proj(Z):
        YtZ = Yt @ Z
        C = YtZ - YtZ.transpose(-1, -2)
        if d == 2:
            a = C[..., 0, 1] / den
            Om = torch.stack([torch.stack([zero, a], -1), torch.stack([-a, zero], -1)], -2)
        elif d == 3:
            rhs = torch.stack([C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]], -1)
            abc = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            a, b, c = abc[..., 0], abc[..., 1], abc[..., 2]
            Om = torch.stack([
                torch.stack([zero, a, b], -1),
                torch.stack([-a, zero, c], -1),
                torch.stack([-b, -c, zero], -1),
            ], -2)
        else:
            vec = C.reshape(C.shape[:-2] + (d * d, 1))
            Om = torch.cholesky_solve(vec, L).reshape(C.shape)
        return Z - Y @ Om

    return proj


def _masks(omega, psi_L, psi_U, N):
    """Host float64 (omega, psi_L, psi_U); psi None means no limits."""
    omega = np.asarray(omega, np.float64)
    if psi_L is None:
        return omega, np.zeros((N, N)), np.zeros((N, N))
    return omega, np.asarray(psi_L, np.float64), np.asarray(psi_U, np.float64)


class _Costs(collections.namedtuple("_Costs", "cost grad hessian_at residual_max")):
    """A backend's cost, Euclidean gradient, Y -> (Z -> Hessian at Y applied
    to Z) and max relative residual, each over (B, N, d) points."""


# the EdgeProblems `solve` has built, by the bytes of their masks, dim and
# anchors. Never evicted: a captured CUDA graph reads the device tables
# cached on its EdgeProblem (utils/compiled.py), which live as long as it.
_EDGE_PROBLEMS: dict = {}


def _edge_problem(masks, d, anchors):
    """edge_ops.build_edge_problem(*masks, dim=d, anchors=anchors), built
    once per content of (masks, d, anchors) and the same EdgeProblem after:
    the per-EdgeProblem device tables then stay cached too."""
    def digest(x):
        x = np.asarray(x)
        return x.shape, x.dtype.str, x.tobytes()

    key = (d, *(digest(m) for m in masks),
           None if anchors is None else tuple((k, digest(v)) for k, v in sorted(anchors.items())))
    ep = _EDGE_PROBLEMS.get(key)
    if ep is None:
        ep = _EDGE_PROBLEMS[key] = edge_ops.build_edge_problem(*masks, dim=d, anchors=anchors)
    return ep


def _costs(backend, D, masks, d, anchors):
    """The cost functions of `backend` on the goals D (B, N, N): "dense",
    the masked (N, N) algebra of solvers/costs.py, or "edge", the compiled
    edge form of ops/edge.py. The masks and anchors go to D's device once."""
    dt, dev = D.dtype, D.device
    if backend == "edge":
        ep = edge_ops.on_device(_edge_problem(masks, d, anchors), dt, dev)
        dg_e = ep.edge_values(D)
        return _Costs(lambda Y: edge_ops.cost(ep, Y, dg_e),
                      lambda Y: edge_ops.egrad(ep, Y, dg_e),
                      lambda Y: edge_ops.hessian_at(ep, Y, dg_e),
                      lambda Y: edge_ops.residual_max(ep, Y, dg_e))
    if backend == "dense":
        def dev_t(x):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        L_mask, U_mask = costs.make_masks(*masks)
        dm = tuple(dev_t(m) for m in masks + (L_mask, U_mask))
        anc = None
        if anchors is not None:
            anc = {k: dev_t(anchors[k]) for k in ("centers", "psi_L", "psi_U", "L_mask", "U_mask")}
            anc["idx"] = torch.as_tensor(np.asarray(anchors["idx"]), dtype=torch.long, device=dev)
        return _Costs(lambda Y: costs.cost(Y, D, *dm, anc),
                      lambda Y: costs.egrad(Y, D, *dm, anc),
                      lambda Y: costs.hessian_at(Y, D, *dm, anc),
                      lambda Y: costs.residual_max(Y, D, *dm, anc))
    raise ValueError(f"unknown backend {backend!r}")


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

    params.backend "kernel" runs ops/tr_solve.py::solve_tr on float32 (the
    CUDA kernel for CUDA tensors, its plain version for CPU tensors) and
    "dense" on float64, on every device, as the JAX package routes its
    float64 solves. "dense" and "edge" run `_tr_batch`.
    """
    N, d = Y0.shape[-2], Y0.shape[-1]
    masks = _masks(omega, psi_L, psi_U, N)
    batch = Y0.shape[:-2]
    Yf = Y0.reshape((-1, N, d)).contiguous()
    D = D_goal.to(Y0.dtype).expand(batch + (N, N)).reshape((-1, N, N))
    p = params
    backend = p.backend
    if backend == "kernel" and Y0.dtype == torch.float64:
        backend = "dense"
    if backend == "kernel":
        ep = _edge_problem(masks, d, anchors)
        out = solve_tr(
            ep, Yf, ep.edge_values(D).contiguous(),
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
    else:
        out = _tr_batch(Yf, _costs(backend, D, masks, d, anchors), p)
    return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}


solve.host_reads = 0


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
    omega = torch.as_tensor(omega, device=lb.device)  # a tensor on lb's device: no copy
    return dgp.linear_projection(X, omega, dim)


# line searches whose slowest lane sets how many evaluations the next one
# runs before its first host read
LS_WINDOW = 16
# inner steps between two host reads of a truncated-CG loop
TR_READ_EVERY = 4


def _inner(a, b):
    """Per-lane Frobenius inner product of (B, N, d) tensors."""
    return (a * b).sum(dim=(-2, -1))


def _lane(v):
    """(B,) lane scalar -> broadcastable over (B, N, d)."""
    return v[:, None, None]


def _host_any(flags):
    """Whether any of the device flags is set, read on the host; each read
    adds one to `solve.host_reads`."""
    solve.host_reads += 1
    return bool(flags.any())


def _tcg_batch(hvp, grad, Delta, active, p: TRParams, maxinner: int):
    """Steihaug-Toint truncated CG on a batch of lanes, each with the JAX
    package's per-instance trajectory (its `_tcg`). Only `active` lanes
    step; each stops on its own condition - boundary (negative curvature,
    the trust region, or a non-finite alpha or e_Pe) before model increase
    before the residual target - and then keeps its state. Reads whether any
    lane still steps every TR_READ_EVERY steps; extra steps change nothing.

    Returns (eta, Heta, inner steps per lane (int32), boundary exit per lane).
    """
    r = grad
    r_r0 = _inner(r, r)
    norm_r0 = torch.sqrt(r_r0)
    target = norm_r0 * torch.clamp(norm_r0 ** p.theta, max=p.kappa)
    eta = torch.zeros_like(grad)
    Heta = torch.zeros_like(grad)
    delta = -r
    e_Pe = torch.zeros_like(r_r0)
    e_Pd = torch.zeros_like(r_r0)
    d_Pd = r_r0
    z_r = r_r0
    model = torch.zeros_like(r_r0)
    boundary = torch.zeros_like(active)
    steps = torch.zeros(active.shape, dtype=torch.int32, device=grad.device)
    Dsq = Delta * Delta
    for j in range(maxinner):
        if j % TR_READ_EVERY == 0 and j and not _host_any(active):
            break
        Hd = hvp(delta)
        d_Hd = _inner(delta, Hd)
        alpha = z_r / d_Hd
        e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd
        hit = (d_Hd <= 0) | (e_Pe_new >= Dsq) | ~torch.isfinite(alpha) | ~torch.isfinite(e_Pe_new)
        disc = torch.clamp(e_Pd * e_Pd + d_Pd * (Dsq - e_Pe), min=0.0)
        tau = (-e_Pd + torch.sqrt(disc)) / d_Pd

        new_eta = eta + _lane(alpha) * delta
        new_Heta = Heta + _lane(alpha) * Hd
        if p.check_model_decrease:
            new_model = _inner(new_eta, grad) + 0.5 * _inner(new_eta, new_Heta)
            # a NaN model counts as increased: exit with the previous eta
            increased = ~hit & ~(new_model < model)
        else:
            new_model = model
            increased = torch.zeros_like(hit)
        r_new = r + _lane(alpha) * Hd
        r_r = _inner(r_new, r_new)
        reached = ~hit & ~increased & (j >= p.mininner) & (torch.sqrt(r_r) <= target)
        beta = r_r / z_r

        # boundary exit > model increase (the previous eta) > target > step
        eta_out = torch.where(_lane(hit), eta + _lane(tau) * delta,
                              torch.where(_lane(increased), eta, new_eta))
        Heta_out = torch.where(_lane(hit), Heta + _lane(tau) * Hd,
                               torch.where(_lane(increased), Heta, new_Heta))
        eta = torch.where(_lane(active), eta_out, eta)
        Heta = torch.where(_lane(active), Heta_out, Heta)
        boundary = boundary | (active & hit)
        steps = steps + active.to(torch.int32)
        cont = active & ~(hit | increased | reached)
        r = torch.where(_lane(cont), r_new, r)
        delta = torch.where(_lane(cont), -r_new + _lane(beta) * delta, delta)
        e_Pe = torch.where(cont, e_Pe_new, e_Pe)
        e_Pd = torch.where(cont, beta * (e_Pd + alpha * d_Pd), e_Pd)
        d_Pd = torch.where(cont, r_r + beta * beta * d_Pd, d_Pd)
        z_r = torch.where(cont, r_r, z_r)
        model = torch.where(cont, new_model, model)
        active = cont
    return eta, Heta, steps, boundary


def _tr_batch(Y0, f: _Costs, p: TRParams):
    """Riemannian trust region on a batch of lanes (B, N, d), each with the
    JAX package's per-instance trajectory (its vmapped `_solve_single`): a
    finished lane keeps its state; rho carries the regularisation; the
    radius shrinks by 4 and grows by 2 up to Delta_bar; a lane stops on
    gradnorm, maxiter, res_tol (the initial point too) and the cost
    plateau. The flags stay on the device: the loop reads whether any lane
    still runs once an iteration, and its tCG every TR_READ_EVERY steps.

    Returns dict(Y, cost, gradnorm, iterations, num_inner), as solve_tr.
    """
    B, N, d = Y0.shape
    dt, dev = Y0.dtype, Y0.device
    eps = torch.finfo(dt).eps
    maxinner = p.maxinner if p.maxinner is not None else N * d
    Delta_bar = p.Delta_bar if p.Delta_bar is not None else 10.0 + d
    Delta0 = p.Delta0 if p.Delta0 is not None else Delta_bar / 8.0
    mingradnorm = p.mingradnorm
    if mingradnorm is None:
        mingradnorm = 0.5e-9 if dt == torch.float64 else 2e-6
    use_res = p.res_tol > 0.0

    Y, fx, grad = Y0, f.cost(Y0), f.grad(Y0)
    norm_grad = torch.sqrt(_inner(grad, grad))
    Delta = torch.full_like(fx, Delta0)
    rmax = f.residual_max(Y0) if use_res else None
    done = rmax < p.res_tol if use_res else torch.zeros(B, dtype=torch.bool, device=dev)
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    num_inner = torch.zeros(B, dtype=torch.int32, device=dev)
    fx_ref = fx
    it = 0
    while _host_any(~done):
        running = ~done
        proj, hess = projector(Y), f.hessian_at(Y)
        eta, Heta, steps, boundary = _tcg_batch(lambda v: proj(hess(v)), grad, Delta, running,
                                                p, maxinner)
        Y_prop = Y + eta
        fx_prop = f.cost(Y_prop)

        rho_reg = torch.clamp(fx.abs(), min=1.0) * eps * p.rho_regularization
        rhonum = fx - fx_prop + rho_reg
        rhoden = -_inner(grad, eta) - 0.5 * _inner(eta, Heta) + rho_reg
        model_decreased = rhoden >= 0
        rho = rhonum / rhoden
        shrink = (rho < 0.25) | ~model_decreased | torch.isnan(rho)
        grow = ~shrink & (rho > 0.75) & boundary
        Delta_new = torch.where(shrink, Delta / 4.0,
                                torch.where(grow, torch.clamp(2.0 * Delta, max=Delta_bar), Delta))

        accept = running & model_decreased & (rho > p.rho_prime)
        Y = torch.where(_lane(accept), Y_prop, Y)
        fx = torch.where(accept, fx_prop, fx)
        grad = torch.where(_lane(accept), f.grad(Y_prop), grad)
        norm_grad = torch.where(accept, torch.sqrt(_inner(grad, grad)), norm_grad)
        Delta = torch.where(running, Delta_new, Delta)
        k = k + running.to(torch.int32)
        num_inner = num_inner + steps
        it += 1
        stop = (norm_grad < mingradnorm) | (k >= p.maxiter)
        if use_res:
            rmax = torch.where(accept, f.residual_max(Y_prop), rmax)
            stop = stop | (rmax < p.res_tol)
        if p.plateau_every and it % p.plateau_every == 0:
            # a running lane has taken `it` steps, as many as the batch
            stop = stop | ((fx_ref - fx) <= p.plateau_rtol * fx + p.plateau_atol)
            fx_ref = torch.where(running, fx, fx_ref)
        done = done | (running & stop)

    return {"Y": Y, "cost": fx, "gradnorm": norm_grad, "iterations": k, "num_inner": num_inner}


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
    batch = Y0.shape[:-2]
    Yf = Y0.reshape((-1, N, d))
    D = D_goal.to(Y0.dtype).expand(batch + (N, N)).reshape((-1, N, N))
    f = _costs(params.backend, D, _masks(omega, psi_L, psi_U, N), d, anchors)
    out = _cg_batch(Yf, f.cost, f.grad, params)
    return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}


solve_cg.host_reads = 0
