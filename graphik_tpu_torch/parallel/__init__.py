"""The fleet layer: multi-restart solves with per-goal selection."""

from graphik_tpu_torch.parallel.mesh import (
    RestartSolver,
    make_restart_solver,
    solve_ik_restarts,
    summarize,
)
