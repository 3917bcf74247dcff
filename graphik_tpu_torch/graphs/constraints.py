"""Constraint-function generation: residual callables over positions.

Port of graphik_tpu/graphs/constraints.py. Each constraint is a residual
function pos (..., N, dim) -> (...,) on torch tensors that is zero
(equalities) or non-negative (satisfied inequalities): penalty terms,
verification oracles or autograd targets.

  constraints_from_structure  - exact edges and bounded edges
  angular_constraints         - joint-angle limits as distance bounds
  nearest_neighbour_cost      - squared distances to target points
  nearest_points_from_config  - FK -> the full node-position matrix
  violations                  - evaluate a list at positions
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from graphik_tpu_torch.graphs.problem import ProblemStructure


@dataclasses.dataclass(frozen=True)
class Constraint:
    """One scalar constraint over the node-position matrix.

    kind: "eq" (residual == 0) or "ineq" (residual >= 0 when satisfied).
    fn: pos (..., N, dim) -> (...,) residual.
    """

    name: str
    kind: str
    fn: Callable

    def __call__(self, pos):
        return self.fn(pos)


def _sqdist(pos, i, j):
    d = pos[..., i, :] - pos[..., j, :]
    return (d * d).sum(dim=-1)


def constraints_from_structure(
    ps: ProblemStructure,
    include_bounds: bool = True,
) -> List[Constraint]:
    """Distance constraints as callables.

    Equalities ||p_u - p_v||^2 = d^2 for every exact edge between non-base
    nodes (x, y and the p0-q0 pair excluded); with include_bounds,
    BELOW/ABOVE bounded edges
    become inequality residuals (D - lo^2 >= 0, hi^2 - D >= 0).
    """
    omega, psi_L, psi_U = ps.masks()
    skip = {ps.idx_x, ps.idx_y}
    out: List[Constraint] = []
    names = ps.names
    for a in range(ps.N):
        for b in range(a + 1, ps.N):
            if a in skip or b in skip:
                continue
            if ps.dim == 3 and {a, b} == {ps.idx_p(0), ps.idx_q(0)}:
                continue  # p0-q0
            if ps.omega_struct[a, b]:
                d2 = float(ps.D_struct[a, b])
                out.append(Constraint(
                    name=f"eq:{names[a]}-{names[b]}",
                    kind="eq",
                    fn=(lambda pos, a=a, b=b, d2=d2:
                        _sqdist(pos, a, b) - d2),
                ))
            elif include_bounds and ps.bounded_mask[a, b]:
                lo = float(ps.check_L[a, b]) ** 2
                hi = float(ps.check_U[a, b]) ** 2
                out.append(Constraint(
                    name=f"lo:{names[a]}-{names[b]}",
                    kind="ineq",
                    fn=(lambda pos, a=a, b=b, lo=lo:
                        _sqdist(pos, a, b) - lo),
                ))
                out.append(Constraint(
                    name=f"hi:{names[a]}-{names[b]}",
                    kind="ineq",
                    fn=(lambda pos, a=a, b=b, hi=hi:
                        hi - _sqdist(pos, a, b)),
                ))
    return out


def angular_constraints(
    ps: ProblemStructure,
    angular_limits: Optional[np.ndarray] = None,
    as_equality: bool = False,
) -> List[Constraint]:
    """Joint-angle limits as cosine inequalities over positions.

    For consecutive main points (p_{i-1}, p_i, p_{i+1}) with link lengths
    l_i, l_{i+1}, the angle limit theta_i gives the law-of-cosines bound
    ||p_{i+1} - p_{i-1}||^2 >= l_i^2 + l_{i+1}^2 - 2 l_i l_{i+1}
    cos(pi - theta) ... expressed as the residual
    D(p_{i-1}, p_{i+1}) - (l_i^2 + l_{i+1}^2 + 2 l_i l_{i+1} cos(theta)).

    angular_limits: (n,) per-joint limits; default = template upper bounds.
    as_equality: emit equalities at the limit.
    """
    tpl = ps.template
    if angular_limits is None:
        angular_limits = np.asarray(tpl.ub[1:])
    out: List[Constraint] = []
    parents = tpl.parents
    for i in range(1, tpl.n + 1):
        par = int(parents[i])
        if par < 1:
            continue
        gpar = int(parents[par])
        a = ps.idx_p(gpar)
        c = ps.idx_p(i)
        l1 = float(np.linalg.norm(tpl.T0[par][:ps.dim, ps.dim]
                                  - tpl.T0[gpar][:ps.dim, ps.dim]))
        l2 = float(np.linalg.norm(tpl.T0[i][:ps.dim, ps.dim]
                                  - tpl.T0[par][:ps.dim, ps.dim]))
        theta = float(angular_limits[par - 1])
        # minimum squared distance at the joint limit: the bend is largest
        # there, D(p_{i-1}, p_{i+1}) = l1^2 + l2^2 + 2 l1 l2 cos(theta) is
        # smallest; feasible configurations satisfy D >= bound.
        bound = l1**2 + l2**2 - 2.0 * l1 * l2 * np.cos(np.pi - theta)
        kind = "eq" if as_equality else "ineq"
        out.append(Constraint(
            name=f"ang:{ps.names[a]}-{ps.names[c]}",
            kind=kind,
            fn=(lambda pos, a=a, c=c, bound=bound:
                _sqdist(pos, a, c) - bound),
        ))
    return out


def nearest_neighbour_cost(ps: ProblemStructure, targets) -> Callable:
    """Sum of squared distances of robot nodes to target points.
    targets: (N, dim) with NaN rows ignored."""
    targets = np.asarray(targets, dtype=float)
    mask = ~np.isnan(targets).any(axis=-1)

    def cost(pos):
        t = torch.as_tensor(np.nan_to_num(targets), dtype=pos.dtype, device=pos.device)
        sq = ((pos - t) ** 2).sum(dim=-1)
        m = torch.as_tensor(mask, device=pos.device)
        return torch.where(m, sq, torch.zeros_like(sq)).sum(dim=-1)

    return cost


def nearest_points_from_config(ps: ProblemStructure, q):
    """FK -> the full node-position matrix: the standard seed for
    nearest-point SDPs. q: (..., n), a tensor or an array (float64 CPU)."""
    if not isinstance(q, torch.Tensor):
        q = torch.as_tensor(np.asarray(q, dtype=np.float64))
    return ps.realization(q)


def violations(constraints: List[Constraint], pos, tol: float = 1e-9):
    """Evaluate all constraints at pos. Returns (residuals (..., m),
    violated (..., m))."""
    res = torch.stack([c(pos) for c in constraints], dim=-1)
    kinds_eq = torch.as_tensor([c.kind == "eq" for c in constraints], device=res.device)
    viol = torch.where(kinds_eq, res.abs() > tol, res < -tol)
    return res, viol
