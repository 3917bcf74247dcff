"""High-level IK API: batched IK solves with the Riemannian solver.

Port of graphik_tpu/api.py for 3D revolute robots, with or without
spherical obstacles. The pipeline runs eagerly in three stages - prepare
(goal anchors, bound smoothing, MDS init), solve (the TR kernel), finish
(joint recovery, FK validation, pose error, LM polish, keep-the-better) -
on the goals' device: goals given as a torch tensor stay where the caller
put them, and goals with no device (numpy arrays) go to the solver's
`device`, the card unless the caller names another. With obstacles,
prepare and solve run on the Nr robot nodes only (the anchored reduction,
ProblemStructure.reduced_spec) and the obstacle positions are padded back
into Y after the solve.
Layouts match the JAX package: Y is (B, N, d), T_goal is (B, n_ee, 4, 4),
and the output dicts carry the same keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.robots import kinematics
from graphik_tpu_torch.solvers import local as local_solver
from graphik_tpu_torch.solvers import riemannian
from graphik_tpu_torch.solvers.local import LocalParams
from graphik_tpu_torch.solvers.riemannian import TRParams
from graphik_tpu_torch.utils import lie


def pose_error(structure: ProblemStructure, q, T_goal):
    """Per-instance position / rotation error of the end effector(s):
    translation norm, and the norm of log(R_goal R_sol^T); max over
    end effectors."""
    tpl = structure.template
    T_goal = T_goal.to(q.dtype)
    n_ee = len(tpl.ee)
    if T_goal.shape[-3:-2] != (n_ee,) or T_goal.ndim < 3:
        T_goal = T_goal[..., None, :, :]
    T_all = kinematics.all_poses(tpl, q)
    e_pos, e_rot = [], []
    for e, ee in enumerate(tpl.ee):
        T_sol = T_all[..., int(ee), :, :]
        Tg = T_goal[..., e, :, :]
        e_pos.append(torch.linalg.norm(Tg[..., :3, 3] - T_sol[..., :3, 3], dim=-1))
        R_rel = Tg[..., :3, :3] @ T_sol[..., :3, :3].transpose(-1, -2)
        e_rot.append(torch.linalg.norm(lie.so3_log(R_rel), dim=-1))
    return (torch.stack(e_pos, dim=-1).amax(dim=-1),
            torch.stack(e_rot, dim=-1).amax(dim=-1))


def solve_reduced(structure, Y0, D_goal, omega_np, psi_L, psi_U,
                  params: TRParams = TRParams(), use_limits: bool = True):
    """Riemannian solve with the anchored-obstacle reduction.

    Obstacle nodes have constant positions, so they leave the variable set
    and their bound edges become anchored hinge terms. Y0 and D_goal may be
    reduced (Nr nodes) or full-graph. The returned Y is padded back to the
    full node count with the obstacle positions.
    """
    spec = structure.reduced_spec()
    if spec is None:
        return riemannian.solve(
            Y0, D_goal, omega_np,
            psi_L if use_limits else None,
            psi_U if use_limits else None,
            params=params,
        )
    Nr = spec["Nr"]
    sol = riemannian.solve(
        Y0[..., :Nr, :],
        D_goal[..., :Nr, :Nr],
        omega_np[:Nr, :Nr],
        psi_L[:Nr, :Nr] if use_limits else None,
        psi_U[:Nr, :Nr] if use_limits else None,
        params=params,
        anchors=spec if use_limits else None,
    )
    Yr = sol["Y"]
    obs = torch.as_tensor(structure.pos_fixed[Nr:], dtype=Yr.dtype, device=Yr.device)
    sol["Y"] = torch.cat([Yr, obs.expand(Yr.shape[:-2] + obs.shape)], dim=-2)
    return sol


def polish_solution(structure, q, T_goal, e_pos, e_rot, max_viol, limits_ok,
                    limit_tol: float = 1e-6, params: Optional[LocalParams] = None):
    """Joint-space LM polish; the polished q is taken per instance only when
    it scores better (pose error, plus a large penalty when infeasible).

    Returns (q, e_pos, e_rot, max_viol, limits_ok).
    """
    pp = params or LocalParams(maxiter=30, tol_grad=1e-8)
    q_p = local_solver.solve_local(structure, T_goal, q, pp)["q"]
    viol_p, ok_p = structure.check_distance_limits(structure.realization(q_p), tol=limit_tol)
    e_pos_p, e_rot_p = pose_error(structure, q_p, T_goal)
    zero = torch.zeros_like(e_pos)
    big = torch.full_like(e_pos, 1e3)
    score0 = e_pos + e_rot + torch.where(limits_ok, zero, big)
    score1 = e_pos_p + e_rot_p + torch.where(ok_p, zero, big)
    take = score1 < score0
    return (
        torch.where(take[..., None], q_p, q),
        torch.where(take, e_pos_p, e_pos),
        torch.where(take, e_rot_p, e_rot),
        torch.where(take, viol_p, max_viol),
        torch.where(take, ok_p, limits_ok),
    )


@dataclasses.dataclass
class Solver:
    """The staged pipeline of `make_solver`; call it on T_goal, or run the
    stages one by one (prepare -> solve -> finish) to time them."""

    structure: ProblemStructure
    params: TRParams = TRParams()
    use_limits: bool = True
    dtype: Optional[torch.dtype] = None
    limit_tol: float = 1e-6
    polish: bool = True
    polish_params: Optional[LocalParams] = None
    smooth_iters: Optional[int] = None
    device: Optional[torch.device] = None  # for goals with no device; None: the card

    def __post_init__(self):
        self.omega, self.psi_L, self.psi_U = self.structure.masks()
        spec = self.structure.reduced_spec()
        # obstacle nodes are constants: prepare runs on the Nr robot nodes
        self.n_nodes = None if spec is None else spec["Nr"]

    def goals(self, T_goal):
        """T_goal as a tensor: a torch tensor as it is, anything else (a
        numpy array) on the solver's device."""
        if isinstance(T_goal, torch.Tensor):
            return T_goal
        return torch.as_tensor(T_goal, device=kinematics.entry_device(self.device))

    def prepare(self, T_goal):
        """Goal anchors, bound smoothing and the MDS init -> (D_goal, Y0),
        over the Nr robot nodes when the structure has obstacles."""
        T_goal = self.goals(T_goal)
        inst = self.structure.instance(T_goal, dtype=self.dtype, smooth=True,
                                       n_nodes=self.n_nodes, smooth_iters=self.smooth_iters)
        M = self.structure.N if self.n_nodes is None else self.n_nodes
        Y0 = riemannian.generate_initialization(
            inst["lb"], inst["ub"], self.omega[:M, :M], self.structure.dim)
        return inst["D_goal"], Y0

    def solve(self, Y0, D_goal):
        return solve_reduced(self.structure, Y0, D_goal, self.omega, self.psi_L,
                             self.psi_U, params=self.params, use_limits=self.use_limits)

    def finish(self, sol, T_goal):
        """Joint recovery, FK validation, pose error and the polish."""
        ps = self.structure
        Y = sol["Y"]
        T_goal = self.goals(T_goal).to(Y.device, Y.dtype)
        q = ps.joint_variables(Y, T_goal)
        max_viol, limits_ok = ps.check_distance_limits(ps.realization(q), tol=self.limit_tol)
        e_pos, e_rot = pose_error(ps, q, T_goal)
        if self.polish:
            q, e_pos, e_rot, max_viol, limits_ok = polish_solution(
                ps, q, T_goal, e_pos, e_rot, max_viol, limits_ok,
                limit_tol=self.limit_tol, params=self.polish_params,
            )
        return {
            "q": q,
            "Y": Y,
            "e_pos": e_pos,
            "e_rot": e_rot,
            "limit_violation": max_viol,
            "success": limits_ok,
            **{k: sol[k] for k in ("cost", "gradnorm", "iterations", "num_inner")},
        }

    def __call__(self, T_goal):
        T_goal = self.goals(T_goal)
        D_goal, Y0 = self.prepare(T_goal)
        return self.finish(self.solve(Y0, D_goal), T_goal)


def make_solver(structure: ProblemStructure, params: TRParams = TRParams(),
                use_limits: bool = True, dtype=None, limit_tol: float = 1e-6,
                polish: bool = True, polish_params: Optional[LocalParams] = None,
                smooth_iters: Optional[int] = None, device=None) -> Solver:
    """A batched solver for `structure`: solver(T_goal) -> dict of
    per-instance q, Y, e_pos, e_rot, limit_violation, success, cost,
    gradnorm, iterations, num_inner. A tensor T_goal runs on its own
    device; goals with no device run on `device` (None: the card, which
    raises when there is none)."""
    return Solver(structure, params, use_limits, dtype, limit_tol, polish,
                  polish_params, smooth_iters, device)


def solve_ik(structure: ProblemStructure, T_goal, params: TRParams = TRParams(),
             use_limits: bool = True, Y_init=None, dtype=None, limit_tol: float = 1e-6,
             polish: bool = True, polish_params: Optional[LocalParams] = None,
             smooth_iters: Optional[int] = None, device=None):
    """One-shot batched IK solve.

    Y_init: optional (..., N, d) or (..., Nr, d) initialization, broadcast
    over the batch; the default is the bound-smoothing MDS init. device: as
    `make_solver`'s, for goals with no device.
    """
    solver = make_solver(structure, params, use_limits, dtype, limit_tol, polish,
                         polish_params, smooth_iters, device)
    T_goal = solver.goals(T_goal)
    if Y_init is None:
        return solver(T_goal)
    D_goal = structure.instance(T_goal, dtype=dtype, smooth=False)["D_goal"]
    Y0 = torch.as_tensor(Y_init, device=D_goal.device)
    Y0 = Y0.expand(D_goal.shape[:-2] + Y0.shape[-2:])
    return solver.finish(solver.solve(Y0, D_goal), T_goal)


def random_goals(structure: ProblemStructure, batch_shape=(),
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float64, device=None):
    """Random reachable goal poses via FK at random configurations, on
    `device` (None: the card, which raises when there is none).

    Returns (T_goal (..., n_ee, 4, 4), q_goal (..., n)).
    """
    tpl = structure.template
    q = kinematics.random_configuration(tpl, batch_shape, generator, dtype, device)
    T_all = kinematics.all_poses(tpl, q)
    return T_all[..., torch.as_tensor(tpl.ee, device=q.device), :, :], q


def summarize(out, criterion_pos: float = 1e-3, criterion_rot: float = math.pi / 180):
    """Batch metrics (graphik_tpu/parallel/mesh.py::summarize): success =
    pose error within (pos < 1 mm, rot < 1 deg) and limit/obstacle
    feasible; pose_only_rate drops the feasibility test, so on an obstacle
    scene success_rate < pose_only_rate counts goals reached through an
    obstacle. The median and the 90th percentile interpolate linearly, as
    numpy's do."""
    e_pos = out["e_pos"].reshape(-1)
    e_rot = out["e_rot"].reshape(-1)
    pose_ok = (e_pos < criterion_pos) & (e_rot < criterion_rot)
    hit = pose_ok & out["success"].reshape(-1)
    iters = out["iterations"].reshape(-1).to(torch.float64)
    return {
        "success_rate": float(hit.to(torch.float64).mean()),
        "pose_only_rate": float(pose_ok.to(torch.float64).mean()),
        "mean_pos_err": float(e_pos.to(torch.float64).mean()),
        "median_pos_err": float(torch.quantile(e_pos.to(torch.float64), 0.5)),
        "mean_iterations": float(iters.mean()),
        "p90_iterations": float(torch.quantile(iters, 0.9)),
    }
