#!/usr/bin/env python3
"""Time the port's Riemannian CG solve stage (riemannian.solve_cg through
api.Solver.solve, CGParams.production(), the dense backend) on UR10 at
B = 8192 from one or more source trees on the same inputs, in turns, on
one GPU.

    python3 tools/torch_cg_bench.py --tree parent=build/dev/parent --tree change=.

A tree is a directory that holds a `graphik_tpu_torch` package and the
robot specs it reads (for example the parent commit's, unpacked with
`git archive HEAD graphik_tpu_torch graphik_tpu/robots/specs | tar -x -C
build/dev/parent`). Each tree runs in its own process, in the order
A B B A ..., and each run makes the same goals from a seed, prepares them
once, makes one warm solve call, then times `--reps` solve calls with the
host clock between two `torch.cuda.synchronize()` calls. It reports their
median, the host reads and cost evaluations of one call, the mean
iterations and a hash of Y (equal hashes mean bitwise-equal results); at
the end, for each tree, the quartiles of its runs' medians. The last line
is one JSON object. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

B = 8192
SEED = 0


def run_one(reps):
    import numpy as np
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers import costs, riemannian

    torch.backends.cuda.matmul.allow_tf32 = False
    evals = [0]
    cost = costs.cost

    def counted(*a, **k):
        evals[0] += 1
        return cost(*a, **k)

    costs.cost = counted
    _, ps = load_ur10()
    solver = api.make_solver(ps, params=riemannian.CGParams.production())
    T_goal = api.random_goals(ps, (B,), torch.Generator().manual_seed(SEED),
                              dtype=torch.float32, device="cuda")[0]
    D_goal, Y0 = solver.prepare(T_goal)
    solver.solve(Y0, D_goal)  # warm call
    walls = []
    for _ in range(reps):
        riemannian.solve_cg.host_reads = evals[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solver.solve(Y0, D_goal)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"solve_ms_median": float(np.median(walls)), "solve_ms": walls,
            "host_reads": riemannian.solve_cg.host_reads, "cost_evals": evals[0],
            "mean_iterations": float(sol["iterations"].double().mean()),
            "Y_sha256": hashlib.sha256(sol["Y"].cpu().numpy().tobytes()).hexdigest()[:16]}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[], help="label=path (default: this tree)")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--turns", type=int, default=4, help="runs in all, trees in turn A B B A ...")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        print(json.dumps(run_one(args.reps)))
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_cg_bench: no CUDA device", file=sys.stderr)
        return 2
    trees = [t.split("=", 1) for t in args.tree] or [["this", "."]]
    order = []
    for i in range(args.turns):
        pair = trees if (i // 2) % 2 == 0 else trees[::-1]
        order.append(pair[i % len(pair)] if len(trees) > 1 else trees[0])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    for label, path in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(path))
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", label,
                              "--reps", str(args.reps)], env=env, cwd=os.path.abspath(path),
                             capture_output=True, text=True, check=True)
        r = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": label, **r})
        print(f"{label}: solve {r['solve_ms_median']:.1f} ms ({r['host_reads']} host reads, "
              f"{r['cost_evals']} cost evaluations, Y {r['Y_sha256']})", flush=True)
    summary = {}
    for label, _ in trees:
        meds = [r["solve_ms_median"] for r in runs if r["tree"] == label]
        q = np.percentile(meds, [25, 50, 75]).tolist()
        summary[label] = {"runs": len(meds), "q25_q50_q75_ms": q}
        print(f"{label}: median of {len(meds)} runs' medians {q[1]:.1f} ms "
              f"(quartiles {q[0]:.1f} / {q[2]:.1f})", flush=True)
    print(json.dumps({"card": card, "B": B, "reps": args.reps, "summary": summary,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
