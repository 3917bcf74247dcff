"""The fleet layer: the data-parallel sharded solve, the distributed
solve over processes, and multi-restart solves with per-goal selection."""

from graphik_tpu_torch.parallel.mesh import (
    RestartSolver,
    dryrun_multigpu,
    make_mesh,
    make_restart_solver,
    shard_batch,
    solve_ik_restarts,
    solve_ik_sharded,
    summarize,
)
