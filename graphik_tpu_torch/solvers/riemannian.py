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
import weakref
from typing import Optional

import numpy as np
import torch

from graphik_tpu_torch.ops import edge as edge_ops
from graphik_tpu_torch.ops.linalg import rowwise_sum
from graphik_tpu_torch.ops.tr_solve import solve_tr
from graphik_tpu_torch.solvers import costs
from graphik_tpu_torch.utils import compiled, dgp


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


def _cho_solve(L, b):
    """L L^T x = b by two triangular solves (cuBLAS trsm on a card, which a
    CUDA graph can capture; a batched torch.cholesky_solve goes to MAGMA,
    whose capture fails)."""
    w = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)


def projector(Y):
    """Z -> manifold_proj(Y, Z), with the factor of the system, which
    depends on Y alone, computed once (`cholesky_ex`: no check that
    synchronises with the host)."""
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
        L = torch.linalg.cholesky_ex(M)[0]
    else:
        # A[(ij),(kl)] = X[i,k] delta[j,l] + delta[i,k] X[j,l] (row-major vec)
        eye = torch.eye(d, dtype=Y.dtype, device=Y.device)
        A = (X[..., :, None, :, None] * eye[None, :, None, :]
             + eye[:, None, :, None] * X[..., None, :, None, :]).reshape(X.shape[:-2] + (d * d, d * d))
        A = A + reg[..., None, None] * torch.eye(d * d, dtype=Y.dtype, device=Y.device)
        L = torch.linalg.cholesky_ex(A)[0]

    def proj(Z):
        YtZ = Yt @ Z
        C = YtZ - YtZ.transpose(-1, -2)
        if d == 2:
            a = C[..., 0, 1] / den
            Om = torch.stack([torch.stack([zero, a], -1), torch.stack([-a, zero], -1)], -2)
        elif d == 3:
            rhs = torch.stack([C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]], -1)
            abc = _cho_solve(L, rhs[..., None])[..., 0]
            a, b, c = abc[..., 0], abc[..., 1], abc[..., 2]
            Om = torch.stack([
                torch.stack([zero, a, b], -1),
                torch.stack([-a, zero, c], -1),
                torch.stack([-b, -c, zero], -1),
            ], -2)
        else:
            vec = C.reshape(C.shape[:-2] + (d * d, 1))
            Om = _cho_solve(L, vec).reshape(C.shape)
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


# The EdgeProblems `solve` has built, by the bytes of their masks, dim and
# anchors: held weakly, so an EdgeProblem lives as long as someone uses it
# (a compiled solver's graphs hold those whose tables they read:
# utils/compiled.py), and the _EDGE_PROBLEMS_KEPT used last held strongly,
# so that eager solves of the same structures do not build theirs anew.
_EDGE_PROBLEMS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_EDGE_PROBLEMS_RECENT: "collections.OrderedDict" = collections.OrderedDict()
_EDGE_PROBLEMS_KEPT = 8


def _edge_problem(masks, d, anchors):
    """edge_ops.build_edge_problem(*masks, dim=d, anchors=anchors), built
    once per content of (masks, d, anchors) and the same EdgeProblem while
    it lives: the per-EdgeProblem device tables then stay cached too."""
    def digest(x):
        x = np.asarray(x)
        return x.shape, x.dtype.str, x.tobytes()

    key = (d, *(digest(m) for m in masks),
           None if anchors is None else tuple((k, digest(v)) for k, v in sorted(anchors.items())))
    ep = _EDGE_PROBLEMS.get(key)
    if ep is None:
        ep = _EDGE_PROBLEMS[key] = edge_ops.build_edge_problem(*masks, dim=d, anchors=anchors)
    _EDGE_PROBLEMS_RECENT[key] = ep
    _EDGE_PROBLEMS_RECENT.move_to_end(key)
    while len(_EDGE_PROBLEMS_RECENT) > _EDGE_PROBLEMS_KEPT:
        _EDGE_PROBLEMS_RECENT.popitem(last=False)
    return ep


_DENSE_MASKS = ("omega", "psi_L", "psi_U", "L_mask", "U_mask")
_ANCHOR_KEYS = ("centers", "psi_L", "psi_U", "L_mask", "U_mask")


def _cost_data(backend, D, masks, d, anchors):
    """What the cost functions of `backend` read on the goals D (B, N, N):
    (static, consts). "dense" reads the masked (N, N) algebra of
    solvers/costs.py, "edge" the compiled edge form of ops/edge.py. static
    is the edge form on D's device (None for "dense"), consts the goal data
    and the masks and anchors on D's device, made once per EdgeProblem
    (compiled.device_const)."""
    dt, dev = D.dtype, D.device
    ep = _edge_problem(masks, d, anchors)
    if backend == "edge":
        epd = compiled.cached(ep, ("on_device", dt, dev), lambda: edge_ops.on_device(ep, dt, dev))
        return epd, {"dg": epd.edge_values(D)}
    if backend == "dense":
        consts = {"D": D.contiguous()}
        for name, m in zip(_DENSE_MASKS, masks + costs.make_masks(*masks)):
            consts[name] = compiled.device_const(ep, ("dense", name), m, dt, dev)
        if anchors is not None:
            for k in _ANCHOR_KEYS:
                consts["a_" + k] = compiled.device_const(ep, ("anchor", k), anchors[k], dt, dev)
            consts["a_idx"] = compiled.device_const(ep, ("anchor", "idx"), anchors["idx"],
                                                    torch.long, dev)
        return None, consts
    raise ValueError(f"unknown backend {backend!r}")


def _costs(backend, consts, epd):
    """The cost functions of `backend` over `_cost_data`'s (static, consts)."""
    if backend == "edge":
        dg = consts["dg"]
        return _Costs(lambda Y: edge_ops.cost(epd, Y, dg),
                      lambda Y: edge_ops.egrad(epd, Y, dg),
                      lambda Y: edge_ops.hessian_at(epd, Y, dg),
                      lambda Y: edge_ops.residual_max(epd, Y, dg))
    D = consts["D"]
    dm = tuple(consts[k] for k in _DENSE_MASKS)
    anc = None
    if "a_idx" in consts:
        anc = {k: consts["a_" + k] for k in _ANCHOR_KEYS + ("idx",)}
    return _Costs(lambda Y: costs.cost(Y, D, *dm, anc),
                  lambda Y: costs.egrad(Y, D, *dm, anc),
                  lambda Y: costs.hessian_at(Y, D, *dm, anc),
                  lambda Y: costs.residual_max(Y, D, *dm, anc))


def solve(
    Y0,
    D_goal,
    omega,
    psi_L=None,
    psi_U=None,
    params: TRParams = TRParams(),
    anchors=None,
    graphs=None,
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
    float64 solves. "dense" and "edge" run `_tr_batch`, whose loop runs
    through CUDA graphs that `graphs` (a compiled.StageGraphs) keeps when
    it is given and the tensors are on a card, and eagerly otherwise.
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
        epd, consts = _cost_data(backend, D, masks, d, anchors)
        out = _tr_batch(Yf, backend, epd, consts, p, graphs)
    return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}


solve.host_reads = 0


def generate_initialization(lb, ub, omega, dim, generator=None, frac=None):
    """MDS initialization from smoothed bounds (the JAX package's "eigh"
    method, which it runs off the TPU): D = (lb + frac (ub - lb))^2 ->
    Gram -> MDS -> linear projection onto R^dim along the dominant
    edge-scatter directions. frac is 0.9, the deterministic init, unless a
    `generator` draws it per entry or `frac` gives it
    (dgp.sample_distance_matrix).

    jnp.linalg.eigh factors (G + G^T) / 2, sym_eigh reads one triangle
    only, so G is symmetrised first. A sampled D, and so its G, is not
    symmetric; the deterministic G differs from G^T by the rounding of its
    row and column means. Nothing here reads the host: on a card the two
    eigendecompositions are K5 (ops/eigh.py), and the whole init runs
    inside prepare's CUDA graph (a generator's draw is the exception:
    pass `frac` there).
    """
    if generator is not None:
        frac = dgp.draw_fractions(lb.shape, lb.dtype, lb.device, generator)
    return generate_initializations(lb, ub, omega, dim, [frac])[0]


def generate_initializations(lb, ub, omega, dim, fracs):
    """One `generate_initialization` for each entry of fracs (None: the
    deterministic 0.9), stacked (R, ..., N, dim). Each init's arithmetic
    is its own call's, on the same shapes; only the two eigendecompositions
    take the R inits' stacks at once (one sym_eigh launch each, whose
    result for a matrix does not depend on the stack it came in)."""
    Gs = []
    for frac in fracs:
        G = dgp.gram_from_distance_matrix(dgp.sample_distance_matrix(lb, ub, frac=frac))
        Gs.append((G + G.transpose(-1, -2)) / 2.0)
    Xs = dgp.mds(torch.stack(Gs), eps=1e-8)
    omega = torch.as_tensor(omega, device=lb.device)  # a tensor on lb's device: no copy
    bases = dgp.top_basis(torch.stack([dgp.edge_scatter(X, omega) for X in Xs]), dim)
    return torch.stack([X @ basis for X, basis in zip(Xs, bases)])


# line searches whose slowest lane sets how many evaluations the next one
# runs before its first host read
LS_WINDOW = 16
# line-search contractions between two host reads once a line search reads
LS_READ_EVERY = 1
# inner steps between two host reads of a truncated-CG loop
TR_READ_EVERY = 4


def _inner(a, b):
    """Per-lane Frobenius inner product of (B, N, d) tensors."""
    return rowwise_sum(a * b, 2)


def _lane(v):
    """(B,) lane scalar -> broadcastable over (B, N, d)."""
    return v[:, None, None]


def _read(loop, key, counter):
    """loop's flag `key` on the host; each read adds one to
    counter.host_reads."""
    counter.host_reads += 1
    return loop.read(key)


# The trust region's loop (`_tr_batch`) is three pieces of compiled.Loop, its
# state the outer iterate and the truncated CG's: `_tr_head` starts the tCG
# and takes its first steps, `_tcg_more` takes TR_READ_EVERY more, `_tr_tail`
# ends the outer step. Each piece builds the cost functions, the projector and
# the Hessian at Y from the state and constants (Y does not change during a
# tCG, so each piece finds the same values).
_TCG_KEYS = ("eta", "Heta", "r", "delta", "e_Pe", "e_Pd", "d_Pd", "z_r", "model", "boundary",
             "steps", "active", "target", "running")


def _tr_limits(p: TRParams, N, d, dt):
    """(maxinner, Delta_bar, Delta0, mingradnorm) with their defaults."""
    maxinner = p.maxinner if p.maxinner is not None else N * d
    Delta_bar = p.Delta_bar if p.Delta_bar is not None else 10.0 + d
    Delta0 = p.Delta0 if p.Delta0 is not None else Delta_bar / 8.0
    mingradnorm = p.mingradnorm
    if mingradnorm is None:
        mingradnorm = 0.5e-9 if dt == torch.float64 else 2e-6
    return maxinner, Delta_bar, Delta0, mingradnorm


def _tcg_steps(t, grad, Delta, hvp, p: TRParams, late):
    """Steihaug-Toint truncated CG steps on a batch of lanes, each with the
    JAX package's per-instance trajectory (its `_tcg`): one step for each
    entry of `late` (whether the step's index j is at least mininner). Only
    active lanes step; each stops on its own condition - boundary (negative
    curvature, the trust region, or a non-finite alpha or e_Pe) before model
    increase before the residual target - and then keeps its state, so
    extra steps change nothing. t: the tCG state (_TCG_KEYS); returns it
    updated, with "more_inner": whether any lane still steps."""
    eta, Heta, r, delta = t["eta"], t["Heta"], t["r"], t["delta"]
    e_Pe, e_Pd, d_Pd, z_r, model = t["e_Pe"], t["e_Pd"], t["d_Pd"], t["z_r"], t["model"]
    boundary, steps, active, target = t["boundary"], t["steps"], t["active"], t["target"]
    Dsq = Delta * Delta
    for j_late in late:
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
        reached = ~hit & ~increased & j_late & (torch.sqrt(r_r) <= target)
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
    return dict(t, eta=eta, Heta=Heta, r=r, delta=delta, e_Pe=e_Pe, e_Pd=e_Pd, d_Pd=d_Pd,
                z_r=z_r, model=model, boundary=boundary, steps=steps, active=active,
                more_inner=active.any())


def _tr_hvp(state, consts, backend, epd):
    """The tCG's operator at the state's Y: Z -> proj(Hess(Z))."""
    Y = state["Y"]
    proj, hess = projector(Y), _costs(backend, consts, epd).hessian_at(Y)
    return lambda v: proj(hess(v))


def _tcg_start(grad, running, p: TRParams):
    """The tCG's state at eta = 0 from the gradient, the `running` lanes
    active."""
    r_r0 = _inner(grad, grad)
    norm_r0 = torch.sqrt(r_r0)
    zero = torch.zeros_like(r_r0)
    return {"eta": torch.zeros_like(grad), "Heta": torch.zeros_like(grad), "r": grad,
            "delta": -grad, "e_Pe": zero, "e_Pd": zero, "d_Pd": r_r0, "z_r": r_r0,
            "model": zero, "boundary": torch.zeros_like(running),
            "steps": torch.zeros(running.shape, dtype=torch.int32, device=grad.device),
            "active": running, "running": running,
            "target": norm_r0 * torch.clamp(norm_r0 ** p.theta, max=p.kappa)}


def _tr_head(state, consts, p: TRParams, backend, epd, late):
    """Start the tCG at the state's iterate, every lane still running, and
    take its first steps."""
    t = _tcg_start(state["grad"], ~state["done"], p)
    return _tcg_steps(t, state["grad"], state["Delta"], _tr_hvp(state, consts, backend, epd),
                      p, late)


def _tcg_more(state, consts, p: TRParams, backend, epd, late):
    """More steps of the tCG in flight."""
    t = {k: state[k] for k in _TCG_KEYS}
    return _tcg_steps(t, state["grad"], state["Delta"], _tr_hvp(state, consts, backend, epd),
                      p, late)


def _tr_tail(state, consts, p: TRParams, backend, epd, plateau):
    """End the outer step: the ratio test, the radius update, the accepted
    point's cost and gradient, the stops (the cost plateau when `plateau`),
    and "more_outer": whether any lane still runs."""
    f = _costs(backend, consts, epd)
    Y, fx, grad, norm_grad, Delta = (state[k] for k in ("Y", "fx", "grad", "norm_grad", "Delta"))
    eta, Heta, boundary, running = state["eta"], state["Heta"], state["boundary"], state["running"]
    N, d = Y.shape[-2:]
    _, Delta_bar, _, mingradnorm = _tr_limits(p, N, d, Y.dtype)
    eps = torch.finfo(Y.dtype).eps
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
    out = {"Y": torch.where(_lane(accept), Y_prop, Y),
           "fx": torch.where(accept, fx_prop, fx)}
    out["grad"] = torch.where(_lane(accept), f.grad(Y_prop), grad)
    out["norm_grad"] = torch.where(accept, torch.sqrt(_inner(out["grad"], out["grad"])),
                                   norm_grad)
    out["Delta"] = torch.where(running, Delta_new, Delta)
    out["k"] = state["k"] + running.to(torch.int32)
    out["num_inner"] = state["num_inner"] + state["steps"]
    stop = (out["norm_grad"] < mingradnorm) | (out["k"] >= p.maxiter)
    if p.res_tol > 0.0:
        out["rmax"] = torch.where(accept, f.residual_max(Y_prop), state["rmax"])
        stop = stop | (out["rmax"] < p.res_tol)
    if plateau:
        # a running lane has taken as many steps as the batch
        stop = stop | ((state["fx_ref"] - out["fx"]) <= p.plateau_rtol * out["fx"] + p.plateau_atol)
        out["fx_ref"] = torch.where(running, out["fx"], state["fx_ref"])
    out["done"] = state["done"] | (running & stop)
    out["more_outer"] = (~out["done"]).any()
    return out


def _tr_batch(Y0, backend, epd, consts, p: TRParams, graphs=None):
    """Riemannian trust region on a batch of lanes (B, N, d), each with the
    JAX package's per-instance trajectory (its vmapped `_solve_single`): a
    finished lane keeps its state; rho carries the regularisation; the
    radius shrinks by 4 and grows by 2 up to Delta_bar; a lane stops on
    gradnorm, maxiter, res_tol (the initial point too) and the cost
    plateau. The flags stay on the device: the loop reads whether any lane
    still runs once an iteration, and its tCG every TR_READ_EVERY steps;
    each read adds one to `solve.host_reads`. The loop runs as a
    compiled.Loop over `graphs`.

    Returns dict(Y, cost, gradnorm, iterations, num_inner), as solve_tr.
    """
    B, N, d = Y0.shape
    dev = Y0.device
    f = _costs(backend, consts, epd)
    maxinner, _, Delta0, _ = _tr_limits(p, N, d, Y0.dtype)
    fx, grad = f.cost(Y0), f.grad(Y0)
    zero = torch.zeros_like(fx)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    use_res = p.res_tol > 0.0
    rmax = f.residual_max(Y0) if use_res else zero
    done = rmax < p.res_tol if use_res else no
    state = {"Y": Y0, "fx": fx, "grad": grad, "norm_grad": torch.sqrt(_inner(grad, grad)),
             "Delta": torch.full_like(fx, Delta0), "rmax": rmax, "done": done,
             "k": torch.zeros(B, dtype=torch.int32, device=dev),
             "num_inner": torch.zeros(B, dtype=torch.int32, device=dev), "fx_ref": fx,
             "more_outer": (~done).any(), "more_inner": no.any(),
             **{k: zero for k in _TCG_KEYS}}
    state.update(eta=torch.zeros_like(Y0), Heta=torch.zeros_like(Y0), r=torch.zeros_like(Y0),
                 delta=torch.zeros_like(Y0), boundary=no, active=no, running=no,
                 steps=torch.zeros(B, dtype=torch.int32, device=dev))
    loop = compiled.Loop(graphs, "tr", state, consts)

    def late(j, n):
        return tuple(i >= p.mininner for i in range(j, j + n))

    it = 0
    while _read(loop, "more_outer", solve):
        n = min(TR_READ_EVERY, maxinner)
        loop.run(_tr_head, p, backend, epd, late(0, n))
        while n < maxinner and _read(loop, "more_inner", solve):
            m = min(TR_READ_EVERY, maxinner - n)
            loop.run(_tcg_more, p, backend, epd, late(n, m))
            n += m
        it += 1
        loop.run(_tr_tail, p, backend, epd, bool(p.plateau_every and it % p.plateau_every == 0))
    Y, fx, norm_grad, k, num_inner = loop.take("Y", "fx", "norm_grad", "k", "num_inner")
    return {"Y": Y, "cost": fx, "gradnorm": norm_grad, "iterations": k, "num_inner": num_inner}


# Riemannian CG's loop (`_cg_batch`) is two pieces of compiled.Loop:
# `_cg_iterate` ends an iteration (unless it is the first) and starts the
# next one's line search with its first contractions, `_cg_contract` takes
# LS_READ_EVERY more contractions. Each leaves "flags": the lanes still
# searching, the most evaluations a lane has made, the lanes still running.

def _cg_flags(search, evals, running):
    return torch.stack([search.sum(), evals.max(), running.sum()])


def _cg_searching(s, p: CGParams):
    return (s["running"] & (s["newf"] > s["fx"] + p.ls_suff_decr * s["alpha"] * s["df0"])
            & (s["evals"] <= p.ls_maxiter))


def _cg_contractions(s, cost_fn, p: CGParams, n):
    """n contractions of the Armijo line search in flight (s: the state, a
    dict, updated); a lane that has stopped searching keeps its step."""
    for _ in range(n):
        search = s["search"]
        s["alpha"] = torch.where(search, s["alpha"] * p.ls_contraction, s["alpha"])
        s["newf"] = torch.where(search, cost_fn(s["Y"] + _lane(s["alpha"]) * s["d"]), s["newf"])
        s["evals"] = s["evals"] + search
        s["search"] = _cg_searching(s, p)
    return s


def _cg_contract(state, consts, p: CGParams, backend, epd):
    s = _cg_contractions(dict(state), _costs(backend, consts, epd).cost, p, LS_READ_EVERY)
    s["flags"] = _cg_flags(s["search"], s["evals"], s["running"])
    return s


def _cg_iterate(state, consts, p: CGParams, backend, epd, tail, n):
    """With `tail`, end the iteration whose line search has stopped (the
    step, the Hager-Zhang direction, the stops); then start the next one's
    line search and take its first n contractions."""
    f = _costs(backend, consts, epd)
    s = dict(state)
    Y, fx, grad, norm_grad, d = s["Y"], s["fx"], s["grad"], s["norm_grad"], s["d"]
    dt = Y.dtype
    tiny = torch.finfo(dt).tiny
    zero = torch.zeros((), dtype=dt, device=Y.device)
    if tail:
        running, alpha, newf, evals = s["running"], s["alpha"], s["newf"], s["evals"]
        mingradnorm = p.mingradnorm
        if mingradnorm is None:
            mingradnorm = 1e-9 if dt == torch.float64 else 2e-6
        # no decrease at all: reject the step (alpha = 0)
        alpha = torch.where(newf > fx, zero, alpha)
        newf = torch.where(alpha > 0, newf, fx)
        # memory: one contraction keeps alpha, otherwise be optimistic
        oldalpha_new = torch.where(evals == 2, alpha, p.ls_optimism * alpha)
        stepsize = alpha * s["norm_d"]

        Y_new = Y + _lane(alpha) * d
        g_new = f.grad(Y_new)
        norm_g_new = torch.sqrt(_inner(g_new, g_new))
        # Powell restart when successive gradients lose orthogonality
        orth = _inner(g_new, grad).abs() / torch.clamp(norm_g_new ** 2, min=tiny)
        powell = orth >= p.orth_value
        # Hager-Zhang beta with its robustness floor
        proj = projector(Y_new)
        d_t = proj(d)
        g_t = proj(grad)
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
        d_new = -g_new + _lane(beta) * d_t

        k, fx_ref = s["k"], s["fx_ref"]
        k_new = k + 1
        done_new = (norm_g_new < mingradnorm) | (stepsize < p.minstepsize) | (k_new >= p.maxiter)
        fx_ref_new = fx_ref
        if p.plateau_every:
            at_check = (k_new % p.plateau_every) == 0
            stalled = (fx_ref - newf) <= p.plateau_rtol * newf + p.plateau_atol
            done_new = done_new | (at_check & stalled)
            fx_ref_new = torch.where(at_check, newf, fx_ref)

        # a finished lane keeps its state
        Y = s["Y"] = torch.where(_lane(running), Y_new, Y)
        fx = s["fx"] = torch.where(running, newf, fx)
        grad = s["grad"] = torch.where(_lane(running), g_new, grad)
        norm_grad = s["norm_grad"] = torch.where(running, norm_g_new, norm_grad)
        d = torch.where(_lane(running), d_new, d)
        s["oldalpha"] = torch.where(running, oldalpha_new, s["oldalpha"])
        s["k"] = torch.where(running, k_new, k)
        s["fx_ref"] = torch.where(running, fx_ref_new, fx_ref)
        s["done"] = s["done"] | (running & done_new)

    running = s["running"] = ~s["done"]
    # not a descent direction: restart along the steepest descent
    df0 = _inner(grad, d)
    bad = df0 >= 0
    d = s["d"] = torch.where(_lane(bad), -grad, d)
    s["df0"] = torch.where(bad, -norm_grad ** 2, df0)
    # adaptive Armijo backtracking, each lane on its own condition
    norm_d = s["norm_d"] = torch.sqrt(_inner(d, d))
    alpha = s["alpha"] = torch.where(s["oldalpha"] > 0, s["oldalpha"],
                                     p.ls_initial / torch.clamp(norm_d, min=tiny))
    s["newf"] = f.cost(Y + _lane(alpha) * d)
    s["evals"] = torch.ones_like(s["evals"])
    s["search"] = _cg_searching(s, p)
    s = _cg_contractions(s, f.cost, p, n)
    s["flags"] = _cg_flags(s["search"], s["evals"], running)
    return s


def _cg_batch(Y0, backend, epd, consts, p: CGParams, graphs=None):
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
    once an iteration, whether any is still running) after every
    LS_READ_EVERY evaluations. Each read adds one to `solve_cg.host_reads`.
    The loop runs as a compiled.Loop over `graphs`.
    """
    dev = Y0.device
    B = Y0.shape[0]
    f = _costs(backend, consts, epd)
    fx, grad = f.cost(Y0), f.grad(Y0)
    zero = torch.zeros_like(fx)
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    state = {"Y": Y0, "fx": fx, "grad": grad, "norm_grad": torch.sqrt(_inner(grad, grad)),
             "d": -grad, "oldalpha": zero, "k": torch.zeros(B, dtype=torch.int32, device=dev),
             "done": no, "fx_ref": fx, "running": no, "df0": zero, "norm_d": zero,
             "alpha": zero, "newf": zero, "evals": torch.zeros(B, dtype=torch.int64, device=dev),
             "search": no, "flags": torch.zeros(3, dtype=torch.int64, device=dev)}
    loop = compiled.Loop(graphs, "cg", state, consts)
    needed = collections.deque(maxlen=LS_WINDOW)  # the slowest lane's evaluations
    loop.run(_cg_iterate, p, backend, epd, False, 0)
    while True:
        any_search, n_evals, any_running = _read(loop, "flags", solve_cg)
        if not any_running:
            break
        while any_search:
            loop.run(_cg_contract, p, backend, epd)
            any_search, n_evals, _ = _read(loop, "flags", solve_cg)
        needed.append(n_evals)
        loop.run(_cg_iterate, p, backend, epd, True, min(needed) - 1)
    Y, fx, norm_grad, k = loop.take("Y", "fx", "norm_grad", "k")
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
    graphs=None,
):
    """Batched Riemannian conjugate-gradient solve of the EDM completion
    problem; the same data contract as `solve` (its loop runs through
    `graphs` as `solve`'s does).

    Returns dict of per-instance results: Y, cost, gradnorm, iterations,
    and num_inner, which is all zeros - CG has no inner solver, and the
    JAX package fills the key with zeros too.
    """
    N, d = Y0.shape[-2], Y0.shape[-1]
    batch = Y0.shape[:-2]
    Yf = Y0.reshape((-1, N, d))
    D = D_goal.to(Y0.dtype).expand(batch + (N, N)).reshape((-1, N, N))
    epd, consts = _cost_data(params.backend, D, _masks(omega, psi_L, psi_U, N), d, anchors)
    out = _cg_batch(Yf, params.backend, epd, consts, params, graphs)
    return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}


solve_cg.host_reads = 0
