#!/usr/bin/env python3
"""One process of the port's distributed solve (parallel/distributed.py).

Run one copy per process (tests/test_torch_distributed.py starts two on the
CPU). Environment:

  WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT
      the standard torch.distributed configuration; with WORLD_SIZE unset
      the worker runs alone, without a process group (the same code path,
      one process).
  GRAPHIK_INIT_METHOD  init_method in place of env:// (e.g. file:///tmp/x)
  GRAPHIK_DEVICE       cpu (gloo) or cuda (NCCL); default cpu
  GRAPHIK_GOALS        global goal batch size (default 8)
  GRAPHIK_OUT          path of this process's JSON record

Each process makes the whole seeded global batch (numpy RandomState(42),
the planar 6-chain with limits pi/2) and keeps its own slice of it, by
rank; it solves its slice with TRParams(maxiter=60) and writes {world,
process, local_batch, metrics} to GRAPHIK_OUT.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main():
    from graphik_tpu_torch.parallel import distributed
    from graphik_tpu_torch.robots import kinematics, library
    from graphik_tpu_torch.solvers.riemannian import TRParams

    torch.set_num_threads(1)
    device = os.environ.get("GRAPHIK_DEVICE", "cpu")
    if "WORLD_SIZE" in os.environ:
        device = distributed.initialize(device, init_method=os.environ.get("GRAPHIK_INIT_METHOD"))
    goals = int(os.environ.get("GRAPHIK_GOALS", "8"))
    out_path = os.environ["GRAPHIK_OUT"]

    tpl, ps = library.load_planar_chain(6, limits=np.pi / 2)
    q = np.random.RandomState(42).uniform(tpl.lb[1:], tpl.ub[1:], size=(goals, tpl.n))
    T_goal = kinematics.all_poses(tpl, torch.from_numpy(q))[:, tpl.ee]
    mesh = distributed.global_batch_mesh(device)
    per = goals // mesh.world_size
    T_local = T_goal[mesh.rank * per:(mesh.rank + 1) * per]
    out, metrics = distributed.solve_ik_global(ps, T_local, mesh=mesh, params=TRParams(maxiter=60))
    record = {"world": mesh.world_size, "process": mesh.rank,
              "local_batch": int(out["q"].shape[0]), "metrics": metrics}
    with open(out_path, "w") as f:
        json.dump(record, f)
    print(f"[worker {mesh.rank}] metrics {metrics}", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
