"""Multi-restart solves with per-goal best-solution selection.

Port of the restart part of graphik_tpu/parallel/mesh.py (`solve_ik_restarts`,
`_select_best_restart`, `make_restart_solver`; `summarize` is re-exported
from api.py). Restart 0 starts from the deterministic bound-interpolation
init; restarts 1..R-1 sample the distance matrix uniformly inside the
smoothed bounds, drawn in order from an explicit `torch.Generator` (where
the JAX package splits a PRNG key). The R restarts fold into one flat batch
of R * B instances, restart-major, so the TR kernel sees one launch per
call; the best restart per goal is chosen by (limit-feasible, e_pos + e_rot).
The sharded mesh solve of the JAX module (`make_mesh`, `shard_batch`,
`solve_ik_sharded`) is multi-GPU work and is not ported here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from graphik_tpu_torch.api import Solver, summarize  # noqa: F401  (summarize: re-export)
from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.solvers import riemannian
from graphik_tpu_torch.solvers.local import LocalParams
from graphik_tpu_torch.solvers.riemannian import TRParams


def _select_best_restart(all_out):
    """Per-goal selection over the leading restart axis: feasible first,
    then pose error (pos + rot); the first of equal scores, as jnp.argmin.
    Returns the selected dict plus "restart_index"."""
    score = all_out["e_pos"] + all_out["e_rot"] + torch.where(
        all_out["success"], 0.0, 1e6).to(all_out["e_pos"].dtype)
    best = torch.argmin(score, dim=0)  # (batch,)

    def pick(x):
        idx = best.reshape((1,) + best.shape + (1,) * (x.ndim - 1 - best.ndim))
        return torch.take_along_dim(x, idx, dim=0)[0]

    out = {k: pick(v) for k, v in all_out.items()}
    out["restart_index"] = best
    return out


@dataclasses.dataclass
class RestartSolver(Solver):
    """The staged restart pipeline of `make_restart_solver`: call it on
    (T_goal, generator), or run prepare(T_goal, generator) -> solve(Y0,
    D_goal) -> finish(sol, T_goal) to time the stages. The stages carry
    the folded batch of R * B instances; finish selects per goal."""

    n_restarts: int = 4

    def prepare(self, T_goal, generator: Optional[torch.Generator] = None, fracs=None):
        """Goal anchors, bound smoothing and R MDS inits -> (D_goal, Y0),
        each folded to (R * B, M, ...). `fracs` (R - 1, B, M, M), in place
        of a generator, gives restarts 1.. their interpolation fractions
        (to replay another run's draws)."""
        R = self.n_restarts
        if R > 1 and generator is None and fracs is None:
            raise ValueError("restarts 1.. sample their inits: pass a torch.Generator")
        T_goal = self.goals(T_goal)
        inst = self.structure.instance(T_goal, dtype=self.dtype, smooth=True,
                                       n_nodes=self.n_nodes, smooth_iters=self.smooth_iters)
        M = self.structure.N if self.n_nodes is None else self.n_nodes
        omega, dim = self.omega[:M, :M], self.structure.dim
        Y0 = torch.stack([
            riemannian.generate_initialization(
                inst["lb"], inst["ub"], omega, dim, generator=None if r == 0 else generator,
                frac=None if r == 0 or fracs is None else fracs[r - 1])
            for r in range(R)])
        D_goal = inst["D_goal"]
        D_goal = D_goal.expand((R,) + D_goal.shape).reshape((-1,) + D_goal.shape[1:])
        return D_goal, Y0.reshape((-1,) + Y0.shape[2:])

    def finish(self, sol, T_goal):
        """The single-init finish on every restart, then the per-goal pick."""
        R = self.n_restarts
        T_goal = self.goals(T_goal)
        T_f = T_goal.expand((R,) + T_goal.shape).reshape((-1,) + T_goal.shape[1:])
        out = super().finish(sol, T_f)
        return _select_best_restart(
            {k: v.reshape((R, -1) + v.shape[1:]) for k, v in out.items()})

    def __call__(self, T_goal, generator: Optional[torch.Generator] = None, fracs=None):
        T_goal = self.goals(T_goal)
        D_goal, Y0 = self.prepare(T_goal, generator, fracs)
        return self.finish(self.solve(Y0, D_goal), T_goal)


def make_restart_solver(structure: ProblemStructure, n_restarts: int = 4,
                        params: TRParams = TRParams(), use_limits: bool = True, dtype=None,
                        polish: bool = True, polish_params: Optional[LocalParams] = None,
                        smooth_iters: Optional[int] = None, device=None) -> RestartSolver:
    """A batched multi-restart solver: solver(T_goal, generator) -> the
    selected per-goal dict of `api.make_solver`'s keys plus
    "restart_index". Devices as in `api.make_solver`."""
    return RestartSolver(structure, params, use_limits, dtype, polish=polish,
                         polish_params=polish_params, smooth_iters=smooth_iters,
                         device=device, n_restarts=n_restarts)


def solve_ik_restarts(structure: ProblemStructure, T_goal,
                      generator: Optional[torch.Generator] = None, n_restarts: int = 4,
                      params: TRParams = TRParams(), use_limits: bool = True, dtype=None,
                      polish: bool = True, device=None):
    """One-shot multi-restart solve (see `make_restart_solver`)."""
    return make_restart_solver(structure, n_restarts, params, use_limits, dtype, polish,
                               device=device)(T_goal, generator)
