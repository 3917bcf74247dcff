#!/usr/bin/env python3
"""How far the port's float32 CIDGIK lies from its float64 result on the
CPU: the spread that a float32 comparison (the card against the CPU in
chip_smoke.py, the float32 parity test) has to allow.

    python tools/cidgik_f32_spread.py --config ur10_cidgik --goals 256 --seed 11

Configs: ur10_cidgik and ur10_table_cidgik (dense, solve_cidgik),
ur10_cidgik_sparse (sparse, solve_cidgik_sparse).

Solves the same seeded goals (random_goals from a CPU generator) at the
reduced budget of chip_smoke.py's 16-goal check (production, ADMM
(200, 2 x 100)) in float32 and float64 and prints one JSON line: the max
per-lane |d points|, |d eig_sum| and |d feas|, the largest relative feas
difference, the lanes whose status differs, the lane of the largest
|d eig_sum| (its float64 eig_sum and |d points|), and the largest
|d eig_sum| relative to the lane's own size, |d eig_sum| / max(|eig_sum|,
1e-3) (the form of chip_smoke.py's SPARSE_EIG_RTOL), with that lane's
eig_sum and |d eig_sum|.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", choices=["ur10_cidgik", "ur10_table_cidgik", "ur10_cidgik_sparse"],
                   default="ur10_cidgik")
    p.add_argument("--goals", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers import cidgik, cidgik_sparse
    from graphik_tpu_torch.utils.environments import table_environment

    obstacles = table_environment() if args.config == "ur10_table_cidgik" else None
    ps = ProblemStructure.from_template(load_ur10()[0], obstacles=obstacles)
    if args.config == "ur10_cidgik_sparse":
        comp = cidgik_sparse.compile_cidgik_sparse(ps)
        solve = cidgik_sparse.solve_cidgik_sparse
    else:
        comp = cidgik.compile_cidgik(ps)
        solve = cidgik.solve_cidgik
    params = cidgik.CidgikParams.production(admm_iters=200, admm_iters_rest=100, max_outer=3)
    T = api.random_goals(ps, (args.goals,), torch.Generator().manual_seed(args.seed),
                         dtype=torch.float32, device="cpu")[0]
    a = solve(comp, T, params=params)
    b = solve(comp, T.double(), params=params)
    d_feas = (a["feas"].double() - b["feas"]).abs()
    d_pts = (a["points"].double() - b["points"]).abs().flatten(1).amax(1)
    d_eig = (a["eig_sum"].double() - b["eig_sum"]).abs()
    rel = d_eig / b["eig_sum"].abs().clamp(min=1e-3)
    print(json.dumps({
        "config": args.config, "goals": args.goals, "seed": args.seed, "device": "cpu",
        "max_d_points": float(d_pts.max()),
        "max_d_eig_sum": float(d_eig.max()),
        "eig_sum_of_worst_lane": float(b["eig_sum"][d_eig.argmax()]),
        "d_points_of_worst_lane": float(d_pts[d_eig.argmax()]),
        "max_rel_d_eig_sum": float(rel.max()),
        "eig_sum_of_rel_worst_lane": float(b["eig_sum"][rel.argmax()]),
        "d_eig_sum_of_rel_worst_lane": float(d_eig[rel.argmax()]),
        "max_d_feas": float(d_feas.max()),
        "max_rel_d_feas": float((d_feas / b["feas"]).max()),
        "status_differs": int((a["status"] != b["status"]).sum()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
