"""Problem-graph compiler: robot template -> static distance-geometry arrays.

Port of graphik_tpu/graphs/problem.py for 3D revolute and planar (d = 2)
robots, with spherical (circular, at d = 2) obstacles. The graph is
compiled once, host-side, into a `ProblemStructure` of dense numpy
matrices (the numpy builder is a copy of the JAX package's, so both
packages compile identical structures); per-goal instance data is then
assembled as tensors on the goals' device, batched over goals.

Node indexing (3D revolute, n joints):
    0..n        -> p0..pn           (main joint points)
    n+1..2n+1   -> q0..qn           (auxiliary rotation-axis points)
    2n+2, 2n+3  -> x, y             (base frame points)
    2n+4..      -> o0, o1, ...      (obstacle centers)
Planar (2D): 0..n -> p0..pn, n+1 -> x, n+2 -> y, n+3.. -> o0, o1, ...
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from graphik_tpu_torch.robots import kinematics
from graphik_tpu_torch.robots.templates import RobotTemplate, _rotz, _se3
from graphik_tpu_torch.utils import dgp, lie
from graphik_tpu_torch.utils.compiled import device_const

# Bounded-edge classification codes.
UNBOUNDED = 0
BELOW = 1
ABOVE = 2

# Upper "distance" placed on obstacle avoidance edges (graph_base.py:211).
OBSTACLE_UPPER = 100.0


def _max_min_distance_revolute(r, P, C, N):
    """Host-side circle min/max distance."""
    delta = P - C
    axial = float(np.dot(N, delta))
    radial = float(np.linalg.norm(np.cross(N, delta)))
    d_min = np.sqrt(max(axial**2 + (radial - r) ** 2, 0.0))
    d_max = np.sqrt(max(axial**2 + (radial + r) ** 2, 0.0))
    return d_max, d_min


def _const(owner, key, x, like, dtype=None):
    """Host data x of `owner` as a tensor in like's dtype (or `dtype`) on
    like's device, made once (compiled.device_const)."""
    return device_const(owner, key, x, dtype or like.dtype, like.device)


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
        assert self.dim == 3
        return self.template.n + 1 + i

    def idx_obs(self, k: int) -> int:
        return (2 * self.n + 4 if self.dim == 3 else self.n + 3) + k

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
        if template.dim == 3:
            ps = _build_revolute(template, axis_length)
        else:
            ps = _build_planar(template)
        for center, radius in obstacles or []:
            ps = ps.add_spherical_obstacle(np.asarray(center, dtype=float), float(radius))
        return ps

    def add_spherical_obstacle(self, center: np.ndarray, radius: float) -> "ProblemStructure":
        """Append an obstacle node (graph_base.py:201-211, intended
        semantics): exact edges to every statically positioned node and
        bounded-below edges (radius) to the main points p1..pn. A planar
        structure keeps the centre's first two coordinates."""
        N_old = self.N
        N = N_old + 1
        dim = self.dim

        def grow(M):
            out = np.zeros((N, N), dtype=M.dtype)
            out[:N_old, :N_old] = M
            return out

        omega = grow(self.omega_struct)
        D = grow(self.D_struct)
        psi_L = grow(self.psi_L)
        psi_U = grow(self.psi_U)
        edge_mask = grow(self.edge_mask)
        L = grow(self.L_edges)
        U = grow(self.U_edges)
        bounded = grow(self.bounded_mask)
        cL = grow(self.check_L)
        cU = grow(self.check_U)

        pos_mask = np.concatenate([self.pos_mask, [True]])
        pos_fixed = np.vstack([self.pos_fixed, center[None, :dim]])
        anchor_mask = np.concatenate([self.anchor_mask, [True]])
        o = N_old

        # Anchor edges: exact distance to every statically positioned node
        # (add_anchor_node, graph_base.py:182-199).
        for j in range(N_old):
            if pos_mask[j]:
                d = float(np.linalg.norm(pos_fixed[j] - center[:dim]))
                _sym_set(omega, o, j, True)
                _sym_set(D, o, j, d**2)
                _sym_set(edge_mask, o, j, True)
                _sym_set(L, o, j, d)
                _sym_set(U, o, j, d)

        # Bounded-below edges to the main robot points p1..pn (p0 is fixed).
        for i in range(1, self.n + 1):
            p = self.idx_p(i)
            _sym_set(bounded, o, p, True)
            _sym_set(cL, o, p, radius)
            _sym_set(cU, o, p, OBSTACLE_UPPER)
            _sym_set(psi_L, o, p, radius**2)
            _sym_set(edge_mask, o, p, True)
            _sym_set(L, o, p, radius)
            _sym_set(U, o, p, OBSTACLE_UPPER)

        return dataclasses.replace(
            self,
            names=self.names + [f"o{self.n_obstacles}"],
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
            n_obstacles=self.n_obstacles + 1,
            obstacles=self.obstacles + [(center, radius)],
        )

    def clear_obstacles(self) -> "ProblemStructure":
        """Rebuild without obstacle nodes."""
        return ProblemStructure.from_template(self.template, self.axis_length)

    def reduced_spec(self) -> Optional[dict]:
        """The anchored-obstacle reduction of the solver's variable set.

        Obstacle positions are constants, so each obstacle bound edge
        becomes a hinge term of a robot node against a constant point, and
        the variables shrink to the Nr = N - n_obstacles robot nodes
        (validation still runs on the full graph).

        Returns None without obstacles, else a dict of host numpy arrays:
          Nr       variable node count (robot + base + aux)
          idx      (A,) int32 robot-node row per anchored term
          centers  (A, dim) constant anchor points
          psi_L, psi_U, L_mask, U_mask  (A,) squared hinge bounds/masks
        """
        if self.n_obstacles == 0:
            return None
        Nr = self.N - self.n_obstacles
        rows, cols = [], []
        for k in range(self.n_obstacles):
            o = Nr + k
            for i in range(Nr):
                if self.bounded_mask[i, o]:
                    rows.append(i)
                    cols.append(o)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        psi_L = self.psi_L[rows, cols]
        psi_U = self.psi_U[rows, cols]
        diff = psi_L != psi_U
        return {
            "Nr": Nr,
            "idx": rows.astype(np.int32),
            "centers": np.asarray(self.pos_fixed[cols], np.float64),
            "psi_L": np.asarray(psi_L, np.float64),
            "psi_U": np.asarray(psi_U, np.float64),
            "L_mask": (diff & (psi_L > 0)).astype(np.float64),
            "U_mask": (diff & (psi_U > 0)).astype(np.float64),
        }

    def distance_bounds_from_sampling(self, generator: Optional[torch.Generator] = None,
                                      n_samples: int = 2000) -> "ProblemStructure":
        """Empirical all-pairs distance bounds from random configurations:
        n_samples configurations drawn within the limits (on the CPU, from
        `generator`, seed 0 when None), elementwise min / max distances
        installed as [L, U] on every node pair; pairs with max - min < 1e-5
        become exact edges. Returns an updated copy."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        q = kinematics.random_configuration(self.template, (n_samples,), generator,
                                            dtype=torch.float64, device="cpu")
        pos = self.realization(q)  # (S, N, dim)
        D = torch.sqrt(torch.clamp(dgp.distance_matrix_from_pos(pos), min=0.0))
        D_min = D.amin(dim=0).numpy()
        D_max = D.amax(dim=0).numpy()

        edge_mask = np.ones_like(self.edge_mask, dtype=bool)
        np.fill_diagonal(edge_mask, False)
        near_exact = (D_max - D_min) < 1e-5
        omega = self.omega_struct | (near_exact & edge_mask)
        D_struct = self.D_struct.copy()
        new_exact = near_exact & edge_mask & ~self.omega_struct
        D_struct[new_exact] = (0.5 * (D_min + D_max))[new_exact] ** 2
        return dataclasses.replace(
            self,
            omega_struct=omega,
            D_struct=D_struct,
            L_edges=D_min.copy(),
            U_edges=D_max.copy(),
            edge_mask=edge_mask,
        )

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
    def goal_batch_shape(self, T_goal):
        """The batch dims of goal poses T_goal: (..., hd, hd) single-ee or
        (..., n_ee, hd, hd)."""
        n_ee = len(self.template.ee)
        if T_goal.shape[-3:-2] != (n_ee,) or T_goal.ndim < 3:
            return tuple(T_goal.shape[:-2])  # single-ee convenience
        return tuple(T_goal.shape[:-3])

    def goal_positions(self, T_goal, dtype=None):
        """Node positions implied by end-effector goal pose(s).

        T_goal: (..., hd, hd) single-ee or (..., n_ee, hd, hd), cast to
        `dtype` when one is given.
        Returns (..., N, dim) positions (zeros at unpositioned nodes): fixed
        nodes + goal anchors. A planar goal anchors the end effector and its
        parent, one link length back along the goal's x axis.
        """
        tpl = self.template
        dim = self.dim
        T_goal = torch.as_tensor(T_goal, dtype=dtype)
        batch = self.goal_batch_shape(T_goal)
        T_goal = T_goal.reshape(batch + (len(tpl.ee),) + T_goal.shape[-2:])
        pos = _const(self, "pos_fixed", self.pos_fixed, T_goal).expand(
            batch + (self.N, dim)).clone()
        for e, ee in enumerate(tpl.ee):
            ee = int(ee)
            Te = T_goal[..., e, :, :]
            t = Te[..., :dim, dim]
            pos[..., self.idx_p(ee), :] = t
            if dim == 3:
                pos[..., self.idx_q(ee), :] = t + self.axis_length * Te[..., :3, 2]
            else:
                pred = int(tpl.parents[ee])
                pos[..., self.idx_p(pred), :] = t - Te[..., :2, 0] * float(tpl.link_lengths[ee])
        return pos

    def instance(self, T_goal, dtype=None, smooth=True, n_nodes=None, smooth_iters=None):
        """Assemble per-goal solver inputs (batched).

        Returns dict with:
          D_goal: (..., M, M) squared goal distance matrix
          pos_anchor: (..., M, 3) anchor positions
          lb, ub: (..., M, M) smoothed unsquared bounds (if smooth)
        where M = n_nodes or N. `omega`, `psi_L`, `psi_U` are static - see
        `masks()`.

        n_nodes: restrict assembly to the first n_nodes nodes, for the
        anchored-obstacle reduction (reduced_spec). The obstacle bound
        edges are folded into the reduced smoothing in closed form
        (dgp.bound_smoothing_anchored), which gives the full-graph bounds
        on the reduced block.
        """
        if dtype is not None:
            T_goal = T_goal.to(dtype)
        M = self.N if n_nodes is None else int(n_nodes)
        pos = self.goal_positions(T_goal)[..., :M, :]
        anchor = device_const(self, ("anchor_mask", M), self.anchor_mask[:M], device=pos.device)
        eye = torch.eye(M, dtype=torch.bool, device=pos.device)
        pair = anchor[:, None] & anchor[None, :] & ~eye

        D_anchor = dgp.distance_matrix_from_pos(pos)
        D_goal = torch.where(pair, D_anchor,
                             _const(self, ("D_struct", M), self.D_struct[:M, :M], pos))

        out = {"D_goal": D_goal, "pos_anchor": pos}
        if smooth:
            d_anchor = torch.sqrt(torch.clamp(D_anchor, min=0.0))
            L = torch.where(pair, d_anchor, _const(self, ("L_edges", M), self.L_edges[:M, :M], pos))
            U = torch.where(pair, d_anchor, _const(self, ("U_edges", M), self.U_edges[:M, :M], pos))
            mask = device_const(self, ("edge_mask", M), self.edge_mask[:M, :M],
                                device=pos.device) | pair
            if M < self.N:
                # The excluded nodes sit at known positions: their bound
                # edges enter the reduced smoothing as side-node terms.
                obs_pos = np.asarray(self.pos_fixed[M:], np.float64)
                d_ro = torch.sqrt(torch.clamp(
                    ((pos[..., :, None, :] - _const(self, ("obs_pos", M), obs_pos, pos)) ** 2
                     ).sum(dim=-1), min=0.0))
                anch = anchor[:, None]
                ro_mask = device_const(self, ("edge_mask_ro", M), self.edge_mask[:M, M:],
                                       device=pos.device)
                big = torch.full_like(d_ro, dgp.BIG)
                zero = torch.zeros_like(d_ro)
                U_ro = torch.minimum(torch.where(anch, d_ro, big),
                                     torch.where(ro_mask, _const(self, ("U_edges_ro", M),
                                                                 self.U_edges[:M, M:], pos), big))
                L_ro = torch.maximum(torch.where(anch, d_ro, zero),
                                     torch.where(ro_mask, _const(self, ("L_edges_ro", M),
                                                                 self.L_edges[:M, M:], pos), zero))
                D_oo = np.sqrt(np.maximum(
                    ((obs_pos[:, None, :] - obs_pos[None, :, :]) ** 2).sum(axis=-1), 0.0))
                out["lb"], out["ub"] = dgp.bound_smoothing_anchored(
                    L, U, mask, U_ro, L_ro, _const(self, ("D_oo", M), D_oo, pos),
                    n_iter=smooth_iters)
            else:
                out["lb"], out["ub"] = dgp.bound_smoothing(L, U, mask, n_iter=smooth_iters)
        return out

    # ------------------------------------------------------------------
    # realization / validation / joint extraction
    # ------------------------------------------------------------------
    def realization(self, q):
        """(..., n) joint angles -> (..., N, dim) node positions (FK into
        the point graph)."""
        tpl = self.template
        p_pos, q_pos = kinematics.joint_positions(tpl, q, self.axis_length)
        batch = q.shape[:-1]
        fixed = _const(self, "pos_fixed", self.pos_fixed, q).expand(batch + (self.N, self.dim))
        if self.dim == 2:
            return torch.cat([p_pos, fixed[..., tpl.n + 1:, :]], dim=-2)
        return torch.cat([p_pos, q_pos, fixed[..., 2 * tpl.n + 2:, :]], dim=-2)

    def check_distance_limits(self, pos, tol=1e-6):
        """Max violation of BELOW/ABOVE bounded edges at positions `pos`.

        Returns (max_violation, ok) where ok = max_violation <= 0 at `tol`.
        Only the bounded pairs' distances are formed (dgp.pair_distances,
        sqrt correctly rounded): the JAX package's rounding, on the CPU and
        on a card alike.
        """
        ii, jj = np.nonzero(self.bounded_mask)
        if ii.size == 0:
            max_viol = torch.full(pos.shape[:-2], -float("inf"), dtype=pos.dtype,
                                  device=pos.device)
            return max_viol, max_viol <= 0.0
        pairs = device_const(self, "bounded_pairs", np.stack([ii, jj]), device=pos.device)
        D = lie.sqrt_rn(torch.clamp(dgp.pair_distances(pos, pairs[0], pairs[1]), min=0.0))
        cL = _const(self, "check_L_pairs", self.check_L[ii, jj], pos)
        cU = _const(self, "check_U_pairs", self.check_U[ii, jj], pos)
        max_viol = torch.amax(torch.maximum((cL - tol) - D, D - (cU + tol)), dim=-1)
        return max_viol, max_viol <= 0.0

    def joint_variables(self, pos, T_goal=None):
        """Recover joint angles from solved node positions (..., N, dim).

        `T_goal` optionally supplies end-effector poses for the final-joint
        correction when the last relative translation is along z (3D only;
        a planar robot's angles follow from the positions alone).
        """
        if self.dim == 3:
            return _joint_variables_revolute(self, pos, T_goal)
        return _joint_variables_planar(self, pos)


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


def _build_planar(tpl: RobotTemplate) -> ProblemStructure:
    """Base + structure + limit edges for a planar robot (graph_planar.py)."""
    n = tpl.n
    N = n + 3
    idx_x, idx_y = n + 1, n + 2
    names = [f"p{i}" for i in range(n + 1)] + ["x", "y"]

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

    p_pos = tpl.T0[:, :2, 2]

    def add_exact(i, j, d):
        _sym_set(omega, i, j, True)
        _sym_set(D, i, j, d**2)
        _sym_set(edge_mask, i, j, True)
        _sym_set(L, i, j, d)
        _sym_set(U, i, j, d)

    # base: p0=(0,0), x=(-1,0), y=(0,1) (graph_planar.py:30-48)
    base_pos = {0: np.zeros(2), idx_x: np.array([-1.0, 0.0]), idx_y: np.array([0.0, 1.0])}
    for i, j in [(0, idx_x), (0, idx_y), (idx_x, idx_y)]:
        add_exact(i, j, float(np.linalg.norm(base_pos[i] - base_pos[j])))

    # structure: consecutive p edges (graph_planar.py:50-88)
    for i in range(1, n + 1):
        par = int(tpl.parents[i])
        add_exact(par, i, float(np.linalg.norm(p_pos[i] - p_pos[par])))

    def law_of_cos(l1, l2, lim):
        return float(np.sqrt(max(l1**2 + l2**2 - 2 * l1 * l2 * np.cos(np.pi - lim), 0.0)))

    def add_below(i, j, lo, hi):
        _sym_set(edge_mask, i, j, True)
        _sym_set(L, i, j, lo)
        _sym_set(U, i, j, hi)
        _sym_set(bounded, i, j, True)
        _sym_set(cL, i, j, lo)
        _sym_set(cU, i, j, hi)
        _sym_set(psi_L, i, j, lo**2)

    # set_limits: 2-apart pairs (graph_planar.py:110-134)
    children = [[] for _ in range(n + 1)]
    for i in range(1, n + 1):
        children[int(tpl.parents[i])].append(i)
    for u in range(n + 1):
        for v1 in children[u]:
            for v2 in children[v1]:
                l1 = float(tpl.link_lengths[v1])
                l2 = float(tpl.link_lengths[v2])
                lim = max(abs(tpl.ub[v2]), abs(tpl.lb[v2]))
                add_below(u, v2, law_of_cos(l1, l2, lim), l1 + l2)

    # root_angle_limits: x vs children of p0 (graph_planar.py:90-108)
    l1 = float(np.linalg.norm(base_pos[idx_x]))
    for v in children[0]:
        l2 = float(tpl.link_lengths[v])
        lim = max(abs(tpl.ub[v]), abs(tpl.lb[v]))
        add_below(idx_x, v, law_of_cos(l1, l2, lim), l1 + l2)

    pos_mask = np.zeros(N, dtype=bool)
    pos_fixed = np.zeros((N, 2))
    for i, p in base_pos.items():
        pos_mask[i] = True
        pos_fixed[i] = p

    anchor_mask = pos_mask.copy()
    for ee in tpl.ee:
        anchor_mask[int(ee)] = True
        anchor_mask[int(tpl.parents[int(ee)])] = True

    return ProblemStructure(
        template=tpl,
        axis_length=1.0,
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
        limited_joints=[],
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
        return v / lie.norm_small(v, keepdim=True)

    # gauge fix from base points
    p0 = pos[..., ps.idx_p(0), :]
    x_hat = pos[..., ps.idx_x, :] - p0
    y_hat = pos[..., ps.idx_y, :] - p0
    z_hat = pos[..., ps.idx_q(0), :] - p0
    R = torch.stack([nrm(x_hat), -nrm(y_hat), nrm(z_hat)], dim=-1)
    B_inv = lie.se3_inv(lie.se3_make(R, p0))

    T0 = _const(tpl, "T0", tpl.T0, pos)
    T_axis = lie.se3_trans_axis(ps.axis_length, dtype=dt, device=dev)

    theta = [torch.zeros(batch, dtype=dt, device=dev)]
    T_all = [T0[0].expand(batch + (4, 4))]
    for k in range(1, n + 1):
        pred = int(tpl.parents[k])
        T_prev = T_all[pred]

        T_prev_0_inv = lie.se3_inv(T0[pred])
        T_rel = lie.matmul_small(T_prev_0_inv, T0[k])
        qs_0 = lie.matmul_small(T_prev_0_inv, lie.matmul_small(T0[k], T_axis))[:3, 3]

        p_pt = pos[..., k, :]
        diff = pos[..., n + 1 + k, :] - p_pt
        qnorm = p_pt + diff / lie.norm_small(diff, keepdim=True)
        q_in_B = lie.matvec_small(B_inv[..., :3, :3], qnorm) + B_inv[..., :3, 3]
        qs = lie.matvec_small(T_prev[..., :3, :3].transpose(-1, -2), q_in_B - T_prev[..., :3, 3])

        # theta = atan2(-qs0^T Omega_z qs, qs0^T Omega_z Omega_z^T qs)
        num = -(qs_0[0] * (-qs[..., 1]) + qs_0[1] * qs[..., 0])
        den = qs_0[0] * qs[..., 0] + qs_0[1] * qs[..., 1]
        th = lie.atan2_rn(num, den)

        theta.append(th)
        T_all.append(lie.matmul_small(lie.matmul_small(T_prev, lie.se3_rotz(th)), T_rel))

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
                T_th = lie.matmul_small(lie.se3_inv(T_all[ee]), Tg[..., e, :, :])
                delta = lie.atan2_rn(T_th[..., 1, 0], T_th[..., 0, 0])
                theta[ee] = lie.wraptopi(theta[ee] + delta)
    return torch.stack(theta[1:], dim=-1)


def _joint_variables_planar(ps: ProblemStructure, pos):
    """Batched planar joint recovery (graph_planar.py:147-176): the rigid
    map of the base points (p0, x, y) onto their canonical places, then each
    joint angle from its link direction relative to its parent's frame."""
    tpl = ps.template
    dt, dev = pos.dtype, pos.device
    canon = device_const(ps, "planar_canon", [[0.0, 0.0], [-1.0, 0.0], [0.0, 1.0]], dt, dev)
    src = torch.stack([pos[..., 0, :], pos[..., ps.idx_x, :], pos[..., ps.idx_y, :]], dim=-2)
    R_, _ = dgp.best_fit_transform(src, canon)

    theta = [torch.zeros(pos.shape[:-2], dtype=dt, device=dev)]
    R_acc = [torch.eye(2, dtype=dt, device=dev).expand(pos.shape[:-2] + (2, 2))]
    for k in range(1, tpl.n + 1):
        u = int(tpl.parents[k])
        diff = lie.matvec_small(R_, pos[..., k, :] - pos[..., u, :])
        diff = diff / lie.norm_small(diff, keepdim=True)
        sol = lie.matvec_small(R_acc[u].transpose(-1, -2), diff)
        th = lie.wraptopi(lie.atan2_rn(sol[..., 1], sol[..., 0]))
        theta.append(th)
        R_acc.append(lie.matmul_small(R_acc[u], lie.rot2(th)))
    return torch.stack(theta[1:], dim=-1)
