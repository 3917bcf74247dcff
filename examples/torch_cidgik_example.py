"""CIDGIK convex-iteration IK on a UR10 with the PyTorch port: the plain
solve, the table scene with the polish, and floor_mode. The port's
counterpart of examples/cidgik_example.py.

    python examples/torch_cidgik_example.py            # on the card
    python examples/torch_cidgik_example.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from graphik_tpu_torch import api
from graphik_tpu_torch.robots import kinematics
from graphik_tpu_torch.robots.library import load_ur10
from graphik_tpu_torch.solvers.cidgik import CidgikParams, compile_cidgik, solve_cidgik


def main(batch=16, seed=0, device=None, params=None):
    """The tuned serving point (CidgikParams.production) on random goals.
    Returns the success rate at 1 cm."""
    tpl, graph = load_ur10()
    comp = compile_cidgik(graph)
    T_goal, _ = api.random_goals(graph, (batch,), torch.Generator().manual_seed(seed),
                                 dtype=torch.float64, device=device)
    out = solve_cidgik(comp, T_goal, params=params or CidgikParams.production())
    e_pos, e_rot = api.pose_error(graph, out["q"], T_goal)
    hit = ((e_pos < 1e-2) & (e_rot < 1e-2)).double().mean().item()
    print("CIDGIK success rate (err < 0.01):", hit)
    print("median pos err:", float(e_pos.median()))
    print("median excess-rank eig sum:", float(out["eig_sum"].median()))
    print("feasible:", int((out["status"] == 0).sum()), "/", batch)
    return hit


def main_obstacles(batch=8, seed=0, device=None, params=None):
    """UR10 over the table: the obstacle inequalities enter the SDP as LMI
    rows, then the polish drives the ADMM's ~cm answers to the 1 mm
    criterion while keeping clear of the spheres. Returns (success at 1 mm,
    the share of limit- and obstacle-feasible answers)."""
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.utils.environments import table_environment

    tpl, _ = load_ur10()
    graph = ProblemStructure.from_template(tpl, obstacles=table_environment())
    comp = compile_cidgik(graph)
    dev = kinematics.entry_device(device)
    # feasible goals: FK of configurations that clear the table
    rng = np.random.RandomState(seed)
    goals = []
    while len(goals) < batch:
        q = torch.as_tensor(rng.uniform(-np.pi, np.pi, graph.n))
        _, ok = graph.check_distance_limits(graph.realization(q))
        if bool(ok):
            goals.append(kinematics.pose(tpl, q, graph.n))
    T_goal = torch.stack(goals).to(dev)

    out = solve_cidgik(comp, T_goal, params=params or CidgikParams.production())
    e_pos0, e_rot0 = api.pose_error(graph, out["q"], T_goal)
    viol, ok = graph.check_distance_limits(graph.realization(out["q"]))
    q, e_pos, e_rot, viol, ok = api.polish_solution(graph, out["q"], T_goal, e_pos0, e_rot0,
                                                    viol, ok)
    hit = ((e_pos < 1e-3) & (e_rot < np.pi / 180)).double().mean().item()
    clear = ok.double().mean().item()
    print("obstacle scene polished success (@1mm):", hit)
    print("obstacle clearance:", clear)
    return hit, clear


def main_floor(batch=8, seed=3, device=None, params=None):
    """floor_mode: the base is freed from its anchors and held only to the
    floor plane, so the solver may place the robot anywhere on the floor
    that reaches the goal. q is in the solved base frame and out["T_base"]
    maps it back: world ee pose = T_base @ fk(q). Returns the success rate
    at 1 cm in each solution's own base frame."""
    tpl, graph = load_ur10()
    comp = compile_cidgik(graph, floor_mode=True)
    T_goal, _ = api.random_goals(graph, (batch,), torch.Generator().manual_seed(seed),
                                 dtype=torch.float64, device=device)
    out = solve_cidgik(comp, T_goal, params=params or CidgikParams.production())
    Tb = out["T_base"].double()
    # goal expressed in each solution's own base frame (per-ee axis kept)
    Tg_base = torch.linalg.inv(Tb)[:, None] @ T_goal.double()
    e_pos, e_rot = api.pose_error(graph, out["q"].double(), Tg_base)
    hit = ((e_pos < 1e-2) & (e_rot < 5e-2)).double().mean().item()
    print("floor_mode success rate (err < 1cm):", hit)
    print("base positions on the floor (x, y, z):")
    print(np.round(Tb[:, :3, 3].cpu().numpy(), 3))
    return hit


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the card")
    a = p.parse_args()
    main(device=a.device)
    main_obstacles(device=a.device)
    main_floor(device=a.device)
