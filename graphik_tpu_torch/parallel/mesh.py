"""The data-parallel fleet layer: the sharded solve, and multi-restart
solves with per-goal best-solution selection.

Port of graphik_tpu/parallel/mesh.py. A mesh is a 1-D list of
`torch.device`s over the instance batch (`make_mesh`: every visible card,
or a list the caller gives). `solve_ik_sharded` splits the goal batch over
it - padded to a multiple of the shard count with copies of goal 0, as the
JAX package's shard_map requires - runs each shard on its own device through
one compiled solver (api.make_solver; on a card each device captures and
replays its own CUDA graphs), gathers to the first device and slices back
to the batch.
The shards are enqueued one after another from the calling thread; the
devices overlap as far as a shard's path leaves the host free (the JAX
package's shard_map runs them as one program). `dryrun_multigpu` is the
analogue of __graft_entry__.py's multi-chip dry run.

Restarts (`solve_ik_restarts`, `_select_best_restart`,
`make_restart_solver`; `summarize` is re-exported from api.py): restart 0
starts from the deterministic bound-interpolation init; restarts 1..R-1
sample the distance matrix uniformly inside the smoothed bounds, drawn in
order from an explicit `torch.Generator` (where the JAX package splits a
PRNG key). The R restarts fold into one flat batch of R * B instances,
restart-major, so the TR kernel sees one launch per call; the best restart
per goal is chosen by (limit-feasible, e_pos + e_rot).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import torch

from graphik_tpu_torch import api
from graphik_tpu_torch.api import Solver, summarize  # noqa: F401  (summarize: re-export)
from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.solvers import riemannian
from graphik_tpu_torch.solvers.local import LocalParams
from graphik_tpu_torch.solvers.riemannian import TRParams
from graphik_tpu_torch.utils import compiled, dgp


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """A 1-D mesh over the instance batch: `devices` when the caller gives
    them (e.g. [cpu, cpu, cpu]), else every visible CUDA device; the first
    n_devices of them when that is set. Raises when there is no card and
    no list."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass devices= for another mesh)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(mesh):
            raise ValueError(f"n_devices={n_devices} of a mesh of {len(mesh)}")
        mesh = mesh[:n_devices]
    return mesh


def shard_batch(x, mesh: Sequence[torch.device]):
    """Split the leading axis of a tensor, or of each tensor of a dict,
    over the mesh: a list of len(mesh) contiguous shards, shard i on
    mesh[i] (the last shards one row shorter when the batch is ragged)."""
    if isinstance(x, dict):
        parts = {k: shard_batch(v, mesh) for k, v in x.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(len(mesh))]
    return [part.to(dev) for part, dev in zip(torch.tensor_split(x, len(mesh)), mesh)]


# (structure, params, keyword arguments) -> the compiled solver of its
# sharded solves, which keeps its structure and graphs alive; past
# _SHARDED_SOLVERS_MAX entries the least recently used goes, as the JAX
# package bounds its memoized runners (graphik_tpu/parallel/distributed.py),
# and its graphs and their memory pools are released at once.
_SHARDED_SOLVERS: "collections.OrderedDict" = collections.OrderedDict()
_SHARDED_SOLVERS_MAX = 16


def _sharded_solver(structure: ProblemStructure, params: TRParams = TRParams(), **kwargs):
    """The compiled solver (`api.make_solver(structure, params, **kwargs)`)
    that `solve_ik_sharded` runs its shards with: made on the first call
    for these arguments, the same solver after, so each device keeps the
    graphs it captured for its shards."""
    key = (structure, params, tuple(sorted(kwargs.items())))
    solver = _SHARDED_SOLVERS.get(key)
    if solver is None:
        solver = _SHARDED_SOLVERS[key] = api.make_solver(structure, params, **kwargs)
        while len(_SHARDED_SOLVERS) > _SHARDED_SOLVERS_MAX:
            _SHARDED_SOLVERS.popitem(last=False)[1].graphs.release()
    _SHARDED_SOLVERS.move_to_end(key)
    return solver


def solve_ik_sharded(structure: ProblemStructure, T_goal, mesh: Sequence[torch.device],
                     params: TRParams = TRParams(), Y_init=None, **kwargs):
    """Batched IK solve with the goal batch sharded over the mesh: the
    batch is padded to a multiple of the shard count with copies of goal 0,
    each shard is solved on its own device by the compiled solver of
    `_sharded_solver(structure, params, **kwargs)` (`api.solve_ik`'s
    arguments; one TR launch a shard, inside that device's CUDA graph on a
    card), and every output is gathered to mesh[0] and sliced back to the
    batch. The solve is data-parallel, so each lane is the unsharded
    solver's up to the rounding of batched eigh and matmul at another batch
    size."""
    mesh = [torch.device(d) for d in mesh]
    if not isinstance(T_goal, torch.Tensor):
        T_goal = torch.as_tensor(T_goal, device=mesh[0])
    B = T_goal.shape[0]
    n = len(mesh)
    Bp = -(-B // n) * n
    if Bp != B:
        pad = T_goal[:1].expand((Bp - B,) + T_goal.shape[1:])
        T_goal = torch.cat([T_goal, pad], dim=0)
    solver = _sharded_solver(structure, params, **kwargs)
    outs = [solver(shard, Y_init) for shard in shard_batch(T_goal, mesh)]
    return {k: torch.cat([o[k].to(mesh[0]) for o in outs], dim=0)[:B] for k in outs[0]}


def dryrun_multigpu(n_devices: Optional[int] = None, devices: Optional[Sequence] = None):
    """The multi-device dry run (__graft_entry__.py:26-68): the UR10 solve
    at TRParams(maxiter=3) on 2 float32 goals a device, sharded over make_mesh(
    n_devices, devices), then summarize. Returns (q on the first device,
    the metrics)."""
    from graphik_tpu_torch.robots.library import load_ur10

    tpl, ps = load_ur10()
    mesh = make_mesh(n_devices, devices)
    batch = 2 * len(mesh)
    gen = torch.Generator(device="cpu").manual_seed(0)
    T_goal, _ = api.random_goals(ps, (batch,), gen, dtype=torch.float32, device="cpu")
    out = solve_ik_sharded(ps, T_goal.to(mesh[0]), mesh, params=TRParams(maxiter=3))
    metrics = summarize(out)
    if tuple(out["q"].shape) != (batch, tpl.n):
        raise RuntimeError(f"dryrun_multigpu: q has shape {tuple(out['q'].shape)}")
    return out["q"], metrics


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
        each folded to (R * B, M, ...). Restarts 1.. take their
        interpolation fractions (R - 1, B, M, M) from `fracs` (to replay
        another run's draws) or draw them from `generator`, in order, as
        dgp.sample_distance_matrix draws them - here, before the stage, so
        that on a card the stage (the instance and the R inits, whose two
        eigendecompositions are one K5 launch each) runs as one CUDA graph
        with the fractions as an input."""
        R = self.n_restarts
        if R > 1 and generator is None and fracs is None:
            raise ValueError("restarts 1.. sample their inits: pass a torch.Generator")
        T_goal = self.goals(T_goal)
        args = (T_goal,)
        if R > 1:
            if fracs is None:
                dt = T_goal.dtype if self.dtype is None else self.dtype
                M = self.structure.N if self.n_nodes is None else self.n_nodes
                shape = self.structure.goal_batch_shape(T_goal) + (M, M)
                fracs = torch.stack([dgp.draw_fractions(shape, dt, T_goal.device, generator)
                                     for _ in range(R - 1)])
            args += (torch.as_tensor(fracs, device=T_goal.device),)
        if self._graphed(T_goal):
            out = self.graphs.run("prepare", self._prepare_restarts, *args)
        else:
            out = self._prepare_restarts(*args)
        return out["D_goal"], out["Y0"]

    def _prepare_restarts(self, T_goal, fracs=()):
        inst, omega = self._instance(T_goal)
        Y0 = riemannian.generate_initializations(inst["lb"], inst["ub"], omega,
                                                 self.structure.dim, [None, *fracs])
        D_goal = inst["D_goal"]
        D_goal = D_goal.expand((self.n_restarts,) + D_goal.shape).reshape((-1,) + D_goal.shape[1:])
        return {"D_goal": D_goal, "Y0": Y0.reshape((-1,) + Y0.shape[2:])}

    def finish(self, sol, T_goal):
        """The single-init finish on every restart, then the per-goal pick."""
        Y = sol["Y"]
        T_goal = self.goals(T_goal).to(Y.device, Y.dtype)
        if self._graphed(Y):
            return self.graphs.run("finish_pick", self._finish_pick, sol, T_goal)
        return self._finish_pick(sol, T_goal)

    def _finish_pick(self, sol, T_goal):
        R = self.n_restarts
        T_f = T_goal.expand((R,) + T_goal.shape).reshape((-1,) + T_goal.shape[1:])
        out = self._finish(sol, T_f)
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
    """The compiled batched multi-restart solver: solver(T_goal, generator)
    -> the selected per-goal dict of `api.make_solver`'s keys plus
    "restart_index". On a card prepare (after the generator's draws, which
    it takes as an input), solve and finish with the pick run as
    `api.make_solver`'s (CUDA graphs, one captured per batch length, as the
    JAX package jits one finish per batch length), for every params and
    dtype. Devices as in `api.make_solver`."""
    return RestartSolver(structure, params, use_limits, dtype, polish=polish,
                         polish_params=polish_params, smooth_iters=smooth_iters,
                         device=device, graphs=compiled.StageGraphs(), n_restarts=n_restarts)


def solve_ik_restarts(structure: ProblemStructure, T_goal,
                      generator: Optional[torch.Generator] = None, n_restarts: int = 4,
                      params: TRParams = TRParams(), use_limits: bool = True, dtype=None,
                      polish: bool = True, device=None):
    """One-shot multi-restart solve, every stage eager (see
    `make_restart_solver`)."""
    return RestartSolver(structure, params, use_limits, dtype, polish=polish, device=device,
                         n_restarts=n_restarts)(T_goal, generator)
