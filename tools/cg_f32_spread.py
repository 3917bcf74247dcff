#!/usr/bin/env python3
"""How far the port's float32 Riemannian CG lies from its float64 result
on the CPU over a short run: the spread that a float32 comparison of two
runs (the card against the CPU in chip_smoke.py phase 14 and in
tests/test_torch_cuda.py) has to allow.

    python tools/cg_f32_spread.py --goals 64 --seed 0 --iters 20

Prepares seeded UR10 goals (random_goals from a CPU generator) with
make_solver(CGParams.production()) on the CPU, then runs
riemannian.solve_cg with CGParams.production(maxiter=--iters) from the
same Y0 in float32 and in float64, and prints one JSON line: the lanes
whose iteration counts differ, the largest per-lane max |d Y| and its
quantiles, and the largest |d cost| over max(1, max cost), the scale of
the tests' float64 comparisons.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--goals", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()

    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers import riemannian
    from graphik_tpu_torch.solvers.riemannian import CGParams

    _, ps = load_ur10()
    solver = api.make_solver(ps, params=CGParams.production(), device="cpu")
    T = api.random_goals(ps, (args.goals,), torch.Generator().manual_seed(args.seed),
                         dtype=torch.float32, device="cpu")[0]
    D, Y0 = solver.prepare(T)
    params = CGParams.production(maxiter=args.iters)
    masks = (solver.omega, solver.psi_L, solver.psi_U)
    a = riemannian.solve_cg(Y0, D, *masks, params=params)
    b = riemannian.solve_cg(Y0.double(), D.double(), *masks, params=params)
    d_Y = (a["Y"].double() - b["Y"]).abs().flatten(1).amax(1)
    d_cost = (a["cost"].double() - b["cost"]).abs().max() / max(1.0, float(b["cost"].abs().max()))
    q = torch.quantile(d_Y, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
    print(json.dumps({
        "goals": args.goals, "seed": args.seed, "iters": args.iters, "device": "cpu",
        "iterations_differ": int((a["iterations"] != b["iterations"]).sum()),
        "iterations": sorted(set(b["iterations"].tolist())),
        "max_d_Y": float(d_Y.max()), "d_Y_q50_q90_q99": q.tolist(),
        "max_d_cost_scaled": float(d_cost),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
