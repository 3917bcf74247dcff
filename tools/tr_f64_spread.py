#!/usr/bin/env python3
"""How far one rounding step moves the port's float64 trust-region solve
on the CPU over a short run: the spread that a float64 comparison of two
runs that round differently (the card against the CPU in chip_smoke.py
phase 17 and in tests/test_torch_cuda.py) has to allow.

    python tools/tr_f64_spread.py --goals 64 --seeds 0 1 2 3 --iters 1 3 5

Prepares seeded UR10 goals (random_goals from a CPU generator) with
make_solver(TRParams.production(maxiter=100, maxinner=24)) on the CPU at
float64, then runs riemannian.solve ("dense", where float64 goes) with
TRParams.production(maxiter=k, maxinner=24) from Y0 and from Y0 with each
entry moved by about one unit in the last place, and prints one JSON line
per seed and k: the largest per-lane max |d Y|, the lanes past 1e-9 and
whether the iteration and inner-step counts are equal on every lane. With
--finish it runs the whole solver's solve and finish (the 10-step polish)
from both starts instead and counts the goals whose success (1 mm, 1 deg,
feasible) differs: the per-goal agreement that two such runs can promise.
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
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--iters", type=int, nargs="+", default=[1, 3, 5])
    p.add_argument("--finish", action="store_true")
    args = p.parse_args()

    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers import riemannian
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import TRParams

    _, ps = load_ur10()
    solver = api.make_solver(ps, TRParams.production(maxiter=100, maxinner=24), smooth_iters=2,
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8), device="cpu")

    def hits(o):
        return (o["e_pos"] < 1e-3) & (o["e_rot"] < torch.pi / 180) & o["success"]

    for seed in args.seeds:
        T = api.random_goals(ps, (args.goals,), torch.Generator().manual_seed(seed),
                             dtype=torch.float64, device="cpu")[0]
        D, Y0 = solver.prepare(T)
        noise = torch.randn(Y0.shape, generator=torch.Generator().manual_seed(100 + seed),
                            dtype=torch.float64)
        Y1 = Y0 * (1 + torch.finfo(torch.float64).eps * noise)
        if args.finish:
            a, b = (solver.finish(solver.solve(Y, D), T) for Y in (Y0, Y1))
            print(json.dumps({"seed": seed, "goals": args.goals,
                              "success": [int(hits(a).sum()), int(hits(b).sum())],
                              "goals_differing": int((hits(a) != hits(b)).sum())}), flush=True)
            continue
        for k in args.iters:
            params = TRParams.production(maxiter=k, maxinner=24)
            a, b = (riemannian.solve(Y, D, solver.omega, solver.psi_L, solver.psi_U, params=params)
                    for Y in (Y0, Y1))
            dY = (a["Y"] - b["Y"]).abs().amax((1, 2))
            print(json.dumps({"seed": seed, "iterations": k, "max_dY": float(dY.max()),
                              "lanes_past_1e-9": int((dY > 1e-9).sum()),
                              "counts_equal": all(bool(torch.equal(a[c], b[c]))
                                                  for c in ("iterations", "num_inner"))}),
                  flush=True)


if __name__ == "__main__":
    main()
