"""Problem-graph compiler: robot template -> static distance-geometry arrays.

Port of graphik_tpu/graphs/problem.py for 3D revolute robots without
obstacles. The graph is compiled once, host-side, into a `ProblemStructure`
of dense numpy matrices (the numpy builder is a copy of the JAX package's,
so both packages compile identical structures); per-goal instance data is
then assembled as tensors on the goals' device, batched over goals.

Node indexing (3D revolute, n joints):
    0..n        -> p0..pn           (main joint points)
    n+1..2n+1   -> q0..qn           (auxiliary rotation-axis points)
    2n+2, 2n+3  -> x, y             (base frame points)

Obstacles (the anchored reduction) and planar chains are later slices:
the entry points that would need them raise NotImplementedError instead of
silently dropping them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from graphik_tpu_torch.robots import kinematics
from graphik_tpu_torch.robots.templates import RobotTemplate, _rotz, _se3
from graphik_tpu_torch.utils import dgp, lie

# Bounded-edge classification codes.
UNBOUNDED = 0
BELOW = 1
ABOVE = 2


def _max_min_distance_revolute(r, P, C, N):
    """Host-side circle min/max distance."""
    delta = P - C
    axial = float(np.dot(N, delta))
    radial = float(np.linalg.norm(np.cross(N, delta)))
    d_min = np.sqrt(max(axial**2 + (radial - r) ** 2, 0.0))
    d_max = np.sqrt(max(axial**2 + (radial + r) ** 2, 0.0))
    return d_max, d_min


def _const(x, like, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype or like.dtype, device=like.device)


@dataclasses.dataclass(eq=False)
class ProblemStructure:
    """Static arrays describing one robot + environment template.

    All matrices are (N, N) numpy float64, symmetric. Squared distances in
    ``D_struct``/``psi_*``; unsquared bounds in ``L_edges``/``U_edges``/
    ``check_*``.
    """

    template: RobotTemplate
    axis_length: float
    names: List[str]

    # masks / matrices
    omega_struct: np.ndarray  # bool: edges with exact known distance
    D_struct: np.ndarray  # squared distances on omega_struct
    psi_L: np.ndarray  # squared lower bounds (BELOW edges)
    psi_U: np.ndarray  # squared upper bounds (ABOVE edges)
    edge_mask: np.ndarray  # bool: any edge with bounds (for smoothing)
    L_edges: np.ndarray  # unsquared lower bounds on edge_mask
    U_edges: np.ndarray  # unsquared upper bounds on edge_mask
    bounded_mask: np.ndarray  # bool: BELOW/ABOVE edges (validated)
    check_L: np.ndarray  # unsquared, for check_distance_limits
    check_U: np.ndarray

    # positions
    pos_mask: np.ndarray  # (N,) statically positioned nodes
    pos_fixed: np.ndarray  # (N, dim)
    anchor_mask: np.ndarray  # (N,) positioned incl. goal anchors

    # index maps
    idx_x: int
    idx_y: int
    n_obstacles: int
    obstacles: List[Tuple[np.ndarray, float]]
    limited_joints: List[int]

    # ------------------------------------------------------------------
    # index helpers
    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.template.dim

    @property
    def n(self) -> int:
        return self.template.n

    @property
    def N(self) -> int:
        return len(self.names)

    def idx_p(self, i: int) -> int:
        return i

    def idx_q(self, i: int) -> int:
        return self.template.n + 1 + i

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_template(
        cls,
        template: RobotTemplate,
        axis_length: float = 1.0,
        obstacles: Optional[Sequence[Tuple[np.ndarray, float]]] = None,
    ) -> "ProblemStructure":
        if template.dim != 3:
            raise NotImplementedError("planar robots: slice 3")
        ps = _build_revolute(template, axis_length)
        for center, radius in obstacles or []:
            ps = ps.add_spherical_obstacle(np.asarray(center, dtype=float), float(radius))
        return ps

    def add_spherical_obstacle(self, center: np.ndarray, radius: float) -> "ProblemStructure":
        raise NotImplementedError("obstacles: slice 2")

    def reduced_spec(self) -> Optional[dict]:
        """None without obstacles; the anchored-obstacle reduction is not
        ported yet, so a structure with obstacles raises."""
        if self.n_obstacles == 0:
            return None
        raise NotImplementedError("obstacles: slice 2")

    def masks(self):
        """Static solver masks: (omega, psi_L, psi_U) as numpy arrays.

        omega includes the anchor-pair completion edges: distances among
        positioned nodes are exact.
        """
        anchor = self.anchor_mask
        pair = np.logical_and.outer(anchor, anchor) & ~np.eye(self.N, dtype=bool)
        omega = self.omega_struct | pair
        return omega, self.psi_L, self.psi_U

    # ------------------------------------------------------------------
    # instance assembly (tensors on the goals' device)
    # ------------------------------------------------------------------
    def goal_positions(self, T_goal):
        """Node positions implied by end-effector goal pose(s).

        T_goal: (..., 4, 4) single-ee or (..., n_ee, 4, 4).
        Returns (..., N, 3) positions (zeros at unpositioned nodes): fixed
        nodes + goal anchors.
        """
        tpl = self.template
        n_ee = len(tpl.ee)
        if T_goal.shape[-3:-2] != (n_ee,) or T_goal.ndim < 3:
            T_goal = T_goal[..., None, :, :]  # single-ee convenience
        batch = T_goal.shape[:-3]
        pos = _const(self.pos_fixed, T_goal).expand(batch + (self.N, self.dim)).clone()
        for e, ee in enumerate(tpl.ee):
            Te = T_goal[..., e, :, :]
            t = Te[..., :3, 3]
            pos[..., self.idx_p(int(ee)), :] = t
            pos[..., self.idx_q(int(ee)), :] = t + self.axis_length * Te[..., :3, 2]
        return pos

    def instance(self, T_goal, dtype=None, smooth=True, smooth_iters=None):
        """Assemble per-goal solver inputs (batched).

        Returns dict with:
          D_goal: (..., N, N) squared goal distance matrix
          pos_anchor: (..., N, 3) anchor positions
          lb, ub: (..., N, N) smoothed unsquared bounds (if smooth)
        `omega`, `psi_L`, `psi_U` are static - see `masks()`.
        """
        if dtype is not None:
            T_goal = T_goal.to(dtype)
        pos = self.goal_positions(T_goal)
        N = self.N
        anchor = torch.as_tensor(self.anchor_mask, device=pos.device)
        eye = torch.eye(N, dtype=torch.bool, device=pos.device)
        pair = anchor[:, None] & anchor[None, :] & ~eye

        D_anchor = dgp.distance_matrix_from_pos(pos)
        D_goal = torch.where(pair, D_anchor, _const(self.D_struct, pos))

        out = {"D_goal": D_goal, "pos_anchor": pos}
        if smooth:
            d_anchor = torch.sqrt(torch.clamp(D_anchor, min=0.0))
            L = torch.where(pair, d_anchor, _const(self.L_edges, pos))
            U = torch.where(pair, d_anchor, _const(self.U_edges, pos))
            mask = torch.as_tensor(self.edge_mask, device=pos.device) | pair
            out["lb"], out["ub"] = dgp.bound_smoothing(L, U, mask, n_iter=smooth_iters)
        return out

    # ------------------------------------------------------------------
    # realization / validation / joint extraction
    # ------------------------------------------------------------------
    def realization(self, q):
        """(..., n) joint angles -> (..., N, 3) node positions (FK into the
        point graph)."""
        tpl = self.template
        p_pos, q_pos = kinematics.joint_positions(tpl, q, self.axis_length)
        batch = q.shape[:-1]
        fixed = _const(self.pos_fixed, q).expand(batch + (self.N, self.dim))
        return torch.cat([p_pos, q_pos, fixed[..., 2 * tpl.n + 2:, :]], dim=-2)

    def check_distance_limits(self, pos, tol=1e-6):
        """Max violation of BELOW/ABOVE bounded edges at positions `pos`.

        Returns (max_violation, ok) where ok = max_violation <= 0 at `tol`.
        """
        D = torch.sqrt(torch.clamp(dgp.distance_matrix_from_pos(pos), min=0.0))
        bounded = torch.as_tensor(self.bounded_mask, device=pos.device)
        cL = _const(self.check_L, pos)
        cU = _const(self.check_U, pos)
        ninf = torch.full_like(D, -float("inf"))
        below = torch.where(bounded, (cL - tol) - D, ninf)
        above = torch.where(bounded, D - (cU + tol), ninf)
        max_viol = torch.amax(torch.maximum(below, above), dim=(-2, -1))
        return max_viol, max_viol <= 0.0

    def joint_variables(self, pos, T_goal=None):
        """Recover joint angles from solved node positions (..., N, 3).

        `T_goal` optionally supplies end-effector poses for the final-joint
        correction when the last relative translation is along z.
        """
        return _joint_variables_revolute(self, pos, T_goal)


# ---------------------------------------------------------------------------
# builders (numpy, identical to the JAX package's)
# ---------------------------------------------------------------------------

def _sym_set(M, i, j, v):
    M[i, j] = v
    M[j, i] = v


def _build_revolute(tpl: RobotTemplate, axis_length: float) -> ProblemStructure:
    """Base + structure + limit edges for a 3D revolute robot.

    Mirrors ProblemGraphRevolute.__init__ (graph_revolute.py:15-30):
    base_subgraph, structure_graph, set_limits, root_angle_limits.
    """
    n = tpl.n
    N = 2 * (n + 1) + 2
    idx_p = lambda i: i
    idx_q = lambda i: n + 1 + i
    idx_x, idx_y = 2 * n + 2, 2 * n + 3
    names = (
        [f"p{i}" for i in range(n + 1)]
        + [f"q{i}" for i in range(n + 1)]
        + ["x", "y"]
    )

    omega = np.zeros((N, N), dtype=bool)
    D = np.zeros((N, N))
    psi_L = np.zeros((N, N))
    psi_U = np.zeros((N, N))
    edge_mask = np.zeros((N, N), dtype=bool)
    L = np.zeros((N, N))
    U = np.zeros((N, N))
    bounded = np.zeros((N, N), dtype=bool)
    cL = np.zeros((N, N))
    cU = np.zeros((N, N))

    T_axis = _se3(np.eye(3), [0, 0, axis_length])
    T0 = tpl.T0  # (n+1, 4, 4)
    p_pos = T0[:, :3, 3]
    q_pos = np.einsum("nij,j->ni", T0 @ T_axis, np.array([0.0, 0.0, 0.0, 1.0]))[:, :3]

    def add_exact(i, j, d):
        _sym_set(omega, i, j, True)
        _sym_set(D, i, j, d**2)
        _sym_set(edge_mask, i, j, True)
        _sym_set(L, i, j, d)
        _sym_set(U, i, j, d)

    # --- base subgraph (graph_revolute.py:32-57) ---
    base_pos = {
        idx_p(0): np.zeros(3),
        idx_x: np.array([axis_length, 0.0, 0.0]),
        idx_y: np.array([0.0, -axis_length, 0.0]),
        idx_q(0): np.array([0.0, 0.0, axis_length]),
    }
    base_edges = [
        (idx_p(0), idx_x),
        (idx_p(0), idx_y),
        (idx_p(0), idx_q(0)),
        (idx_x, idx_y),
        (idx_y, idx_q(0)),
        (idx_q(0), idx_x),
    ]
    for i, j in base_edges:
        add_exact(i, j, float(np.linalg.norm(base_pos[i] - base_pos[j])))

    # --- structure subgraph (graph_revolute.py:59-106) ---
    for path in tpl.paths:
        path = [int(v) for v in path if v >= 0]
        for k, cur in enumerate(path):
            add_exact(
                idx_p(cur), idx_q(cur), float(np.linalg.norm(p_pos[cur] - q_pos[cur]))
            )
            if k > 0:
                prev = path[k - 1]
                pts = {
                    idx_p(prev): p_pos[prev],
                    idx_q(prev): q_pos[prev],
                    idx_p(cur): p_pos[cur],
                    idx_q(cur): q_pos[cur],
                }
                for u in (idx_p(prev), idx_q(prev)):
                    for v in (idx_p(cur), idx_q(cur)):
                        add_exact(u, v, float(np.linalg.norm(pts[u] - pts[v])))

    limited_joints: List[int] = []

    def limit_edge(u_idx, v_idx, T0m, T1m, T2m, P, cur_node):
        """Shared circle-geometry limit logic (graph_revolute.py:190-239)."""
        Nax = T1m[:3, 2]
        C = T1m[:3, 3] + np.dot(Nax, T2m[:3, 3] - T1m[:3, 3]) * Nax
        r = float(np.linalg.norm(T2m[:3, 3] - C))
        d_max, d_min = _max_min_distance_revolute(r, P, C, Nax)
        d = float(np.linalg.norm(T2m[:3, 3] - P))

        # classification mirrors the reference's exact float comparisons
        if np.isclose(d_max, d_min, rtol=1e-12, atol=1e-12):
            limit = UNBOUNDED  # exact
            exact = True
        elif np.isclose(d, d_max, rtol=1e-12, atol=1e-12):
            limit, exact = BELOW, False
        elif np.isclose(d, d_min, rtol=1e-12, atol=1e-12):
            limit, exact = ABOVE, False
        else:
            limit, exact = UNBOUNDED, False

        if limit != UNBOUNDED:
            rot_limit = _se3(_rotz(tpl.ub[cur_node]), np.zeros(3))
            T_rel = np.linalg.inv(T1m) @ T2m
            d_limit = float(np.linalg.norm((T1m @ rot_limit @ T_rel)[:3, 3] - P))
            if limit == ABOVE:
                d_max = d_limit
            else:
                d_min = d_limit
            limited_joints.append(cur_node)

        if exact:
            _sym_set(omega, u_idx, v_idx, True)
            _sym_set(D, u_idx, v_idx, d_max**2)
        _sym_set(edge_mask, u_idx, v_idx, True)
        _sym_set(L, u_idx, v_idx, d_min)
        _sym_set(U, u_idx, v_idx, d_max)
        if limit in (BELOW, ABOVE):
            _sym_set(bounded, u_idx, v_idx, True)
            _sym_set(cL, u_idx, v_idx, d_min)
            _sym_set(cU, u_idx, v_idx, d_max)
            if limit == BELOW:
                _sym_set(psi_L, u_idx, v_idx, d_min**2)
            else:
                _sym_set(psi_U, u_idx, v_idx, d_max**2)

    # --- set_limits: 2-apart pairs (graph_revolute.py:167-241) ---
    for path in tpl.paths:
        path = [int(v) for v in path if v >= 0]
        for k in range(2, len(path)):
            prev, mid, cur = path[k - 2], path[k - 1], path[k]
            for use_aux0 in (False, True):
                for use_aux2 in (False, True):
                    T0m = T0[prev] @ (T_axis if use_aux0 else np.eye(4))
                    T1m = T0[mid]
                    T2m = T0[cur] @ (T_axis if use_aux2 else np.eye(4))
                    u_idx = idx_q(prev) if use_aux0 else idx_p(prev)
                    v_idx = idx_q(cur) if use_aux2 else idx_p(cur)
                    limit_edge(u_idx, v_idx, T0m, T1m, T2m, T0m[:3, 3], cur)

    # --- root_angle_limits: x,y vs p1,q1 (graph_revolute.py:108-165) ---
    if n >= 1:
        first = int(tpl.paths[0][1]) if tpl.paths.shape[1] > 1 else None
        # every ee path shares the same first joint only for chains; handle
        # each path's first node (reference hard-codes "p1")
        firsts = sorted({int(p[1]) for p in tpl.paths if len(p) > 1 and p[1] >= 0})
        for first in firsts:
            T1m = T0[0]
            for base_idx in (idx_x, idx_y):
                for use_aux in (False, True):
                    T2m = T0[first] @ (T_axis if use_aux else np.eye(4))
                    v_idx = idx_q(first) if use_aux else idx_p(first)
                    P = base_pos[base_idx]
                    limit_edge(base_idx, v_idx, None, T1m, T2m, P, first)

    pos_mask = np.zeros(N, dtype=bool)
    pos_fixed = np.zeros((N, 3))
    for i, p in base_pos.items():
        pos_mask[i] = True
        pos_fixed[i] = p

    anchor_mask = pos_mask.copy()
    for ee in tpl.ee:
        anchor_mask[idx_p(int(ee))] = True
        anchor_mask[idx_q(int(ee))] = True

    return ProblemStructure(
        template=tpl,
        axis_length=axis_length,
        names=names,
        omega_struct=omega,
        D_struct=D,
        psi_L=psi_L,
        psi_U=psi_U,
        edge_mask=edge_mask,
        L_edges=L,
        U_edges=U,
        bounded_mask=bounded,
        check_L=cL,
        check_U=cU,
        pos_mask=pos_mask,
        pos_fixed=pos_fixed,
        anchor_mask=anchor_mask,
        idx_x=idx_x,
        idx_y=idx_y,
        n_obstacles=0,
        obstacles=[],
        limited_joints=sorted(set(limited_joints)),
    )


# ---------------------------------------------------------------------------
# joint-variable extraction
# ---------------------------------------------------------------------------

def _joint_variables_revolute(ps: ProblemStructure, pos, T_goal):
    """Batched revolute joint recovery: gauge-fix from the base points, then
    walk the joint tree recovering each angle from its aux point."""
    tpl = ps.template
    n = tpl.n
    dt, dev = pos.dtype, pos.device
    batch = pos.shape[:-2]

    def nrm(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    # gauge fix from base points
    p0 = pos[..., ps.idx_p(0), :]
    x_hat = pos[..., ps.idx_x, :] - p0
    y_hat = pos[..., ps.idx_y, :] - p0
    z_hat = pos[..., ps.idx_q(0), :] - p0
    R = torch.stack([nrm(x_hat), -nrm(y_hat), nrm(z_hat)], dim=-1)
    B_inv = lie.se3_inv(lie.se3_make(R, p0))

    T0 = _const(tpl.T0, pos)
    T_axis = lie.se3_trans_axis(ps.axis_length, dtype=dt, device=dev)

    theta = [torch.zeros(batch, dtype=dt, device=dev)]
    T_all = [T0[0].expand(batch + (4, 4))]
    for k in range(1, n + 1):
        pred = int(tpl.parents[k])
        T_prev = T_all[pred]

        T_prev_0_inv = lie.se3_inv(T0[pred])
        T_rel = T_prev_0_inv @ T0[k]
        qs_0 = (T_prev_0_inv @ (T0[k] @ T_axis))[:3, 3]

        p_pt = pos[..., k, :]
        diff = pos[..., n + 1 + k, :] - p_pt
        qnorm = p_pt + diff / torch.linalg.norm(diff, dim=-1, keepdim=True)
        q_in_B = torch.einsum("...ij,...j->...i", B_inv[..., :3, :3], qnorm) + B_inv[..., :3, 3]
        qs = torch.einsum("...ji,...j->...i", T_prev[..., :3, :3], q_in_B - T_prev[..., :3, 3])

        # theta = atan2(-qs0^T Omega_z qs, qs0^T Omega_z Omega_z^T qs)
        num = -(qs_0[0] * (-qs[..., 1]) + qs_0[1] * qs[..., 0])
        den = qs_0[0] * qs[..., 0] + qs_0[1] * qs[..., 1]
        th = torch.atan2(num, den)

        theta.append(th)
        T_all.append((T_prev @ lie.se3_rotz(th)) @ T_rel)

    # final-joint correction when the last axis is along ee z
    if T_goal is not None:
        Tg = T_goal.to(dt)
        n_ee = len(tpl.ee)
        if Tg.shape[-3:-2] != (n_ee,) or Tg.ndim < 3:
            Tg = Tg[..., None, :, :]
        for e, ee in enumerate(tpl.ee):
            ee = int(ee)
            pred = int(tpl.parents[ee])
            T_rel_np = np.linalg.inv(tpl.T0[pred]) @ tpl.T0[ee]
            if np.linalg.norm(np.cross(T_rel_np[:3, 3], [0.0, 0.0, 1.0])) < 1e-10:
                T_th = lie.se3_inv(T_all[ee]) @ Tg[..., e, :, :]
                delta = torch.atan2(T_th[..., 1, 0], T_th[..., 0, 0])
                theta[ee] = lie.wraptopi(theta[ee] + delta)
    return torch.stack(theta[1:], dim=-1)
