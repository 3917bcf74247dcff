"""The multi-process data-parallel solve, on torch.distributed.

Port of graphik_tpu/parallel/distributed.py. Each process owns one device
and its own shard of the global goal batch (it makes or loads its goals
itself: nothing funnels through one process). The solve of a shard needs
no communication; the metrics are sums all-reduced over the processes, so
every process reports the same numbers.

  * `initialize()` - `torch.distributed.init_process_group` from the
    standard environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), or
    from the arguments. The backend follows the device: NCCL for `cuda`,
    gloo for `cpu`. A failing NCCL initialization raises; there is no
    fallback to gloo. A no-op when a process group is already up.
  * `global_batch_mesh()` - this process's place on the batch axis: world
    size, rank and its device.
  * `shard_local_batch()` - this process's shard on its device, checked to
    be the same size on every process.
  * `solve_ik_global()` - solve the local shard and reduce the metrics.

Without a process group every function works on one process, so the same
driver runs from one CPU to several cards.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.parallel.mesh import _sharded_solver
from graphik_tpu_torch.solvers.riemannian import TRParams


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The batch axis over processes: one device a process."""

    world_size: int
    rank: int
    device: torch.device


def _device(device, rank: Optional[int] = None) -> torch.device:
    """`device` as a torch.device; a bare "cuda" becomes this process's
    card: LOCAL_RANK, else the rank, modulo the cards visible."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a cuda process")
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def initialize(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> torch.device:
    """Join the process group and return this process's device.

    init_method defaults to "env://" (MASTER_ADDR and MASTER_PORT);
    world_size and rank default to WORLD_SIZE and RANK. The backend is NCCL
    for a cuda device (its communicator made here, so a failure raises
    here) and gloo for cpu. Nothing is joined when a process group is
    already initialized.
    """
    if dist.is_initialized():
        return _device(device)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    dev = _device(device, rank)
    kw = dict(init_method=init_method or "env://", world_size=world_size, rank=rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return dev


def global_batch_mesh(device="cuda") -> ProcessMesh:
    """The batch axis over every process of the group (one process, rank
    0, without a group), with this process's device."""
    if dist.is_initialized():
        return ProcessMesh(dist.get_world_size(), dist.get_rank(), _device(device))
    return ProcessMesh(1, 0, _device(device))


def shard_local_batch(x_local, mesh: ProcessMesh):
    """This process's shard of the global batch on its device. Every
    process passes a shard of the same size (checked across the group)."""
    x = torch.as_tensor(x_local).to(mesh.device)
    if mesh.world_size > 1:
        sizes = [torch.zeros(1, dtype=torch.int64, device=mesh.device)
                 for _ in range(mesh.world_size)]
        dist.all_gather(sizes, torch.tensor([x.shape[0]], dtype=torch.int64, device=mesh.device))
        if len({int(s) for s in sizes}) != 1:
            raise ValueError(f"local batches differ in size: {[int(s) for s in sizes]}")
    return x


def solve_ik_global(structure: ProblemStructure, T_goal_local, mesh: Optional[ProcessMesh] = None,
                    params: TRParams = TRParams(), criterion_pos: float = 1e-3,
                    criterion_rot: float = math.pi / 180, device="cuda", **kwargs):
    """Solve this process's shard of the global goal batch; return (local
    result, global metrics).

    The solve is the compiled solver of `api.solve_ik`'s arguments (made
    once per structure and arguments and kept, as the JAX package memoizes
    its jitted runner) on the shard, on this process's device, with no
    communication. The metrics are sums over every process's lanes
    (one all_reduce of float64 sums whenever a process group is up, at
    world size 1 too), so they are identical on every
    process: success_rate (pose within the criteria and limit- and
    obstacle-feasible), pose_only_rate, mean_iterations, mean_pos_err, and
    global_batch and num_processes.
    """
    if mesh is None:
        mesh = global_batch_mesh(device)
    T_goal = shard_local_batch(T_goal_local, mesh)
    Y_init = kwargs.pop("Y_init", None)
    out = _sharded_solver(structure, params, **kwargs)(T_goal, Y_init)
    pose_ok = (out["e_pos"] < criterion_pos) & (out["e_rot"] < criterion_rot)
    hit = pose_ok & out["success"]
    sums = torch.stack([
        hit.to(torch.float64).sum(),
        pose_ok.to(torch.float64).sum(),
        out["iterations"].to(torch.float64).sum(),
        out["e_pos"].to(torch.float64).sum(),
        torch.tensor(float(hit.numel()), dtype=torch.float64, device=hit.device),
    ])
    if dist.is_initialized():
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    s = sums.tolist()
    n = s[4]
    metrics = {
        "success_rate": s[0] / n,
        "pose_only_rate": s[1] / n,
        "mean_iterations": s[2] / n,
        "mean_pos_err": s[3] / n,
        "global_batch": int(n),
        "num_processes": mesh.world_size,
    }
    return out, metrics
