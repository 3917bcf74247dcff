"""Joint-space local solver: batched Levenberg-Marquardt on the pose residual.

Port of graphik_tpu/solvers/local.py. The cost is the body-frame pose log
residual e = log(T(q)^-1 T_goal) with the analytic Jacobian
J_e = inv_left_jacobian(e) Ad(T^-1) J (for planar robots, SE(2)'s log and
its analytic derivative, where the JAX package takes jax.jacfwd); each
step solves the damped n x n system with the reference's clamped-pivot
Cholesky (ops/linalg.py spd_solve: K6 on a card) and clips to the joint
limits. Spherical
obstacles add hinge residuals r - ||c - p_i(q)|| on the main points
p1..pn, enforced by an augmented-Lagrangian loop around the LM. Lanes run
in lockstep; a lane that has converged is frozen by masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.ops.linalg import rowwise_sum, spd_solve
from graphik_tpu_torch.robots import kinematics
from graphik_tpu_torch.utils import lie
from graphik_tpu_torch.utils.compiled import device_const


@dataclasses.dataclass(frozen=True)
class LocalParams:
    maxiter: int = 100
    lm_init: float = 1e-3
    lm_up: float = 3.0
    lm_down: float = 0.5
    tol_grad: float = 1e-9
    clip_limits: bool = True
    # Obstacle constraints: al_iters augmented-Lagrangian rounds around the
    # LM; the penalty rho starts at al_rho0 and grows by al_growth a round.
    al_iters: int = 4
    al_rho0: float = 100.0
    al_growth: float = 10.0


def _se2_residual_jacobian(e, M, Jb):
    """de/dq of the planar residual e = se2_log(M), M = T(q)^-1 T_goal,
    from the body-frame twists Jb = Ad(T^-1) J (..., 3, n) of the joints.

    A joint rate with body twist (v, w) moves M by dM = -[(v, w)]^ M: the
    angle by -w and the translation t by -(w [-t_y, t_x] + v). se2_log's
    translation part is Jinv(angle) t with Jinv = [[al, h], [-h, al]],
    al = (angle/2) cot(angle/2) and h = angle/2, so (analytically, where
    the JAX package takes jax.jacfwd)
      d e_w = -w,
      d e_v = -(dJinv/dangle t) w - Jinv (w [-t_y, t_x] + v).
    """
    ang = e[..., 2]
    t = M[..., :2, 2]
    a, b = lie._se2_v(ang)  # Jinv's entries as se2_log forms them
    det = a * a + b * b
    al, h = a / det, b / det
    dal = lie.se2_log_dangle(ang)
    w = Jb[..., 2, :]                                          # (..., n)
    dt = -(w[..., None, :] * torch.stack([-t[..., 1], t[..., 0]], dim=-1)[..., :, None]
           + Jb[..., :2, :])                                   # (..., 2, n)
    dv0 = -(dal * t[..., 0] + 0.5 * t[..., 1])[..., None] * w \
        + al[..., None] * dt[..., 0, :] + h[..., None] * dt[..., 1, :]
    dv1 = -(-0.5 * t[..., 0] + dal * t[..., 1])[..., None] * w \
        - h[..., None] * dt[..., 0, :] + al[..., None] * dt[..., 1, :]
    return torch.stack([dv0, dv1, -w], dim=-2)


def _pose_residuals(tpl, T_goal, q, with_jacobian=True, A=None):
    """Stacked body-frame pose residuals over every end effector.

    T_goal: (..., n_ee, hd, hd); q: (..., n). Returns (e (..., tw n_ee),
    de/dq (..., tw n_ee, n)), tw = 6 (3D) or 3 (planar) - the Jacobian is
    None when not asked for. Pass the prefix products `A` when the caller
    already has them.
    """
    if A is None:
        A = kinematics.prefix_products(tpl, q)
    T_all = lie.matmul_small(A, device_const(tpl, "T0", tpl.T0, q.dtype, q.device))
    planar = tpl.dim == 2
    es, Js = [], []
    for e_idx, ee in enumerate(tpl.ee):
        if planar:
            T_inv = lie.se2_inv(T_all[..., int(ee), :, :])
            M = lie.matmul_small(T_inv, T_goal[..., e_idx, :, :])
            e = lie.se2_log(M)
        else:
            T_inv = lie.se3_inv(T_all[..., int(ee), :, :])
            e = lie.se3_log(lie.matmul_small(T_inv, T_goal[..., e_idx, :, :]))
        es.append(e)
        if with_jacobian:
            J = kinematics.jacobian(tpl, q, int(ee), A=A)
            if planar:
                Js.append(_se2_residual_jacobian(e, M, lie.matmul_small(lie.se2_adjoint(T_inv), J)))
            else:
                # d(e)/dq = -J_e through T(q)
                Js.append(-lie.matmul_small(
                    lie.matmul_small(lie.se3_inv_left_jacobian(e), lie.se3_adjoint(T_inv)), J))
    return torch.cat(es, dim=-1), torch.cat(Js, dim=-2) if with_jacobian else None


def _obstacle_pairs(ps: ProblemStructure):
    """Static (centers (n_obs, d), radii (n_obs,)) numpy arrays. The
    constraints are every obstacle against every main point p1..pn,
    obstacle-major: constraint o * n + (i - 1) is obstacle o vs p_i."""
    cen = np.asarray([np.asarray(c)[:ps.dim] for c, _ in ps.obstacles], np.float64)
    rad = np.asarray([r for _, r in ps.obstacles], np.float64)
    return cen, rad


def _obstacle_g_and_jac(tpl, q, centers, radii, A=None, with_jacobian=True):
    """Violations g = r - ||c - p_i(q)|| (..., n_obs * n) and, when asked
    for, their analytic Jacobian (..., n_obs * n, n) from the one-pass
    world-frame position Jacobians (kinematics.linear_jacobians)."""
    if A is None:
        A = kinematics.prefix_products(tpl, q)
    T = lie.matmul_small(A, device_const(tpl, "T0", tpl.T0, q.dtype, q.device))
    d = tpl.dim
    p = T[..., 1:, :d, d]                                  # (..., n, d)
    # no copy when the caller hands them on q's device in q's dtype
    c = torch.as_tensor(centers, dtype=q.dtype, device=q.device)[:, None, :]
    r = torch.as_tensor(radii, dtype=q.dtype, device=q.device)[:, None]
    diff = c - p[..., None, :, :]                          # (..., n_obs, n, d)
    dist = torch.sqrt((diff * diff).sum(dim=-1) + 1e-30)
    g = (r - dist).flatten(-2)
    if not with_jacobian:
        return g, None
    # d(-dist)/dq = (c - p)^T / dist . dp/dq
    u = diff / dist[..., None]
    J = kinematics.linear_jacobians(tpl, q, T)[..., 1:, :, :]  # (..., n, d, n)
    Jg = torch.einsum("...oid,...idk->...oik", u, J)
    return g, Jg.flatten(-3, -2)


def solve_local(
    ps: ProblemStructure,
    T_goal,
    q0,
    params: LocalParams = LocalParams(),
):
    """Batched joint-space solve over all end effectors.

    Damped Gauss-Newton (LM) on the pose log residual; spherical-obstacle
    inequality constraints through an augmented-Lagrangian outer loop
    (al_iters rounds, each a full LM solve from the previous round's q).

    T_goal: (..., hd, hd) or (..., n_ee, hd, hd); q0: (..., n).
    Returns dict(q, cost, iterations, max_violation).
    """
    tpl = ps.template
    dt, dev = q0.dtype, q0.device
    lb = device_const(tpl, "joint_lb", tpl.lb[1:], dt, dev)
    ub = device_const(tpl, "joint_ub", tpl.ub[1:], dt, dev)
    T_goal = T_goal.to(dt)
    if T_goal.ndim == q0.ndim + 1:  # (..., hd, hd): add the ee axis
        T_goal = T_goal[..., None, :, :]
    eye = torch.eye(tpl.n, dtype=dt, device=dev)
    batch = q0.shape[:-1]
    if ps.n_obstacles:
        centers, radii = (device_const(ps, ("obstacle_pairs", k), x, dt, dev)
                          for k, x in enumerate(_obstacle_pairs(ps)))

    def residuals(q, mult, rho, with_jacobian=True):
        A = kinematics.prefix_products(tpl, q)
        e, J = _pose_residuals(tpl, T_goal, q, with_jacobian, A=A)
        if not ps.n_obstacles:
            return e, J
        g, Jg = _obstacle_g_and_jac(tpl, q, centers, radii, A=A, with_jacobian=with_jacobian)
        # AL term (rho/2) max(0, g + mult/rho)^2 as the least-squares
        # residual sqrt(rho/2) max(0, g + mult/rho).
        ghat = g + mult / rho
        act = ghat > 0
        w = torch.sqrt(rho / 2.0)
        e = torch.cat([e, w * torch.where(act, ghat, torch.zeros_like(ghat))], dim=-1)
        if with_jacobian:
            J = torch.cat([J, w * torch.where(act[..., None], Jg, torch.zeros_like(Jg))], dim=-2)
        return e, J

    def normal_equations(J, r):
        """J^T r and J^T J. A pose residual's few rows as lie.matmul_small
        rounds them (the JAX package's bits on the CPU, the same on a card);
        with obstacles, hundreds of rows, a sum of products and a batched
        GEMM (one fused multiply-add a row would be hundreds of kernels)."""
        Jt = J.transpose(-1, -2)
        if ps.n_obstacles:
            return (J * r[..., :, None]).sum(-2), Jt @ J
        return lie.matvec_small(Jt, r), lie.matmul_small(Jt, J)

    def sumsq(r):
        """The residual's sum of squares: a pose residual's few values as
        lie.dot_small sums them (one rounding on every device); with
        obstacles a residual holds 6 + n_obs n values (606 on the table),
        summed by rows (rowwise_sum: one order at every batch position)."""
        return rowwise_sum(r * r) if ps.n_obstacles else lie.dot_small(r, r)

    def lm_solve(q, mult, rho):
        lam = torch.full(batch, params.lm_init, dtype=dt, device=dev)
        iters = torch.zeros(batch, dtype=torch.int32, device=dev)
        done = torch.zeros(batch, dtype=torch.bool, device=dev)
        for _ in range(params.maxiter):
            live = ~done
            r, J = residuals(q, mult, rho)
            g, JtJ = normal_equations(J, r)
            H = JtJ + lam[..., None, None] * eye
            # the reference's clamped-pivot Cholesky (K6 on a card): where a
            # float32 system is not numerically SPD its step is huge or NaN,
            # and the improvement test takes or refuses it
            step = -spd_solve(H, g)
            q_new = q + step
            if params.clip_limits:
                q_new = torch.clamp(q_new, lb, ub)
            r_new, _ = residuals(q_new, mult, rho, with_jacobian=False)
            improved = sumsq(r_new) < sumsq(r)
            q_out = torch.where(improved[..., None], q_new, q)
            lam_new = torch.clamp(
                torch.where(improved, lam * params.lm_down, lam * params.lm_up), 1e-12, 1e8)
            q = torch.where(live[..., None], q_out, q)
            lam = torch.where(live, lam_new, lam)
            iters = iters + live.to(torch.int32)
            # one kernel: the stop test's rounding moved no verdict and no bit
            # of q between card and CPU (PERF.md section 6, the polish's table)
            done = done | (live & (torch.linalg.norm(g, dim=-1) < params.tol_grad))
        return q, iters

    if ps.n_obstacles:
        mult = torch.zeros(batch + (len(radii) * tpl.n,), dtype=dt, device=dev)
        rho = torch.full((), params.al_rho0, dtype=dt, device=dev)  # a fill: no host copy
        q = q0
        iters = torch.zeros(batch, dtype=torch.int32, device=dev)
        for _ in range(params.al_iters):
            q, k = lm_solve(q, mult, rho)
            g, _ = _obstacle_g_and_jac(tpl, q, centers, radii, with_jacobian=False)
            # standard inequality multiplier update
            mult = torch.clamp(mult + rho * g, min=0.0)
            rho = rho * params.al_growth
            iters = iters + k
        g, _ = _obstacle_g_and_jac(tpl, q, centers, radii, with_jacobian=False)
        max_viol = torch.clamp(g, min=0.0).amax(dim=-1)
    else:
        q, iters = lm_solve(q0, None, None)
        max_viol = torch.zeros(batch, dtype=dt, device=dev)
    e, _ = _pose_residuals(tpl, T_goal, q, with_jacobian=False)
    return {
        "q": q,
        "cost": (e * e).sum(-1),
        "iterations": iters,
        "max_violation": max_viol,
    }
