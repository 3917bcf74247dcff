"""Riemannian IK on a UR10 among the table's 100 spheres, with the PyTorch
port: one call solves a whole batch of goals, then prints the success
metrics. The port's counterpart of examples/riemannian_example.py.

    python examples/torch_riemannian_example.py            # on the card
    python examples/torch_riemannian_example.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from graphik_tpu_torch import api
from graphik_tpu_torch.parallel.mesh import summarize
from graphik_tpu_torch.robots.library import load_ur10
from graphik_tpu_torch.solvers.riemannian import TRParams
from graphik_tpu_torch.utils.environments import table_environment


def main(batch=64, seed=0, device=None, params=TRParams(maxiter=1000)):
    """Solve `batch` random goals; device None is the card. Returns the
    summary metrics."""
    tpl, graph = load_ur10()
    for center, radius in table_environment():
        graph = graph.add_spherical_obstacle(center, radius)
    print(f"UR10 with {graph.n_obstacles} obstacles, N = {graph.N} nodes")

    gen = torch.Generator().manual_seed(seed)
    T_goal, _ = api.random_goals(graph, (batch,), gen, dtype=torch.float32, device=device)
    stats = summarize(api.solve_ik(graph, T_goal, params=params))
    print("success rate (pos<1mm, rot<1deg, limits ok):", stats["success_rate"])
    print("median pos err:", stats["median_pos_err"])
    print("mean iterations:", stats["mean_iterations"])
    return stats


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--batch", type=int, default=64)
    a = p.parse_args()
    main(batch=a.batch, device=a.device)
