"""Joint-space local solver: batched Levenberg-Marquardt on the pose residual.

Port of graphik_tpu/solvers/local.py (the obstacle-free branch). The cost
is the body-frame pose log residual e = log(T(q)^-1 T_goal) with the
analytic Jacobian J_e = inv_left_jacobian(e) Ad(T^-1) J; each step solves
the damped 6x6 system with a batched Cholesky and clips to the joint limits.
Lanes run in lockstep; a lane that has converged is frozen by masks.
"""

from __future__ import annotations

import dataclasses

import torch

from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.robots import kinematics
from graphik_tpu_torch.utils import lie


@dataclasses.dataclass(frozen=True)
class LocalParams:
    maxiter: int = 100
    lm_init: float = 1e-3
    lm_up: float = 3.0
    lm_down: float = 0.5
    tol_grad: float = 1e-9
    clip_limits: bool = True


def _pose_residuals(tpl, T_goal, q, with_jacobian=True):
    """Stacked body-frame pose residuals over every end effector.

    T_goal: (..., n_ee, 4, 4); q: (..., n). Returns (e (..., 6 n_ee),
    de/dq (..., 6 n_ee, n)) - the Jacobian is None when not asked for.
    """
    A = kinematics.prefix_products(tpl, q)
    T_all = A @ torch.as_tensor(tpl.T0, dtype=q.dtype, device=q.device)
    es, Js = [], []
    for e_idx, ee in enumerate(tpl.ee):
        T_inv = lie.se3_inv(T_all[..., int(ee), :, :])
        e = lie.se3_log(T_inv @ T_goal[..., e_idx, :, :])
        es.append(e)
        if with_jacobian:
            J = kinematics.jacobian(tpl, q, int(ee), A=A)
            # d(e)/dq = -J_e through T(q)
            Js.append(-(lie.se3_inv_left_jacobian(e) @ lie.se3_adjoint(T_inv) @ J))
    return torch.cat(es, dim=-1), torch.cat(Js, dim=-2) if with_jacobian else None


def solve_local(
    ps: ProblemStructure,
    T_goal,
    q0,
    params: LocalParams = LocalParams(),
):
    """Batched joint-space solve over all end effectors.

    T_goal: (..., 4, 4) or (..., n_ee, 4, 4); q0: (..., n).
    Returns dict(q, cost, iterations, max_violation).
    """
    if ps.n_obstacles:
        raise NotImplementedError("obstacles: slice 2")
    tpl = ps.template
    dt, dev = q0.dtype, q0.device
    lb = torch.as_tensor(tpl.lb[1:], dtype=dt, device=dev)
    ub = torch.as_tensor(tpl.ub[1:], dtype=dt, device=dev)
    T_goal = T_goal.to(dt)
    if T_goal.ndim == q0.ndim + 1:  # (..., 4, 4): add the ee axis
        T_goal = T_goal[..., None, :, :]
    eye = torch.eye(tpl.n, dtype=dt, device=dev)

    batch = q0.shape[:-1]
    q = q0
    lam = torch.full(batch, params.lm_init, dtype=dt, device=dev)
    iters = torch.zeros(batch, dtype=torch.int32, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    for _ in range(params.maxiter):
        live = ~done
        r, J = _pose_residuals(tpl, T_goal, q)
        Jt = J.transpose(-1, -2)
        g = (Jt @ r[..., None])[..., 0]
        H = Jt @ J + lam[..., None, None] * eye
        # A lane whose f32 system is not numerically SPD (info != 0) takes no
        # step and raises its damping - the same outcome as the JAX
        # package's clamped-pivot solve, whose step then fails the
        # improvement test.
        Lc, info = torch.linalg.cholesky_ex(H)
        step = -torch.cholesky_solve(g[..., None], Lc)[..., 0]
        step = torch.where((info == 0)[..., None], step, torch.zeros_like(step))
        q_new = q + step
        if params.clip_limits:
            q_new = torch.clamp(q_new, lb, ub)
        r_new, _ = _pose_residuals(tpl, T_goal, q_new, with_jacobian=False)
        improved = (info == 0) & ((r_new * r_new).sum(-1) < (r * r).sum(-1))
        q_out = torch.where(improved[..., None], q_new, q)
        lam_new = torch.clamp(
            torch.where(improved, lam * params.lm_down, lam * params.lm_up), 1e-12, 1e8)
        q = torch.where(live[..., None], q_out, q)
        lam = torch.where(live, lam_new, lam)
        iters = iters + live.to(torch.int32)
        done = done | (live & (torch.linalg.norm(g, dim=-1) < params.tol_grad))
    e, _ = _pose_residuals(tpl, T_goal, q, with_jacobian=False)
    return {
        "q": q,
        "cost": (e * e).sum(-1),
        "iterations": iters,
        "max_violation": torch.zeros(batch, dtype=dt, device=dev),
    }
