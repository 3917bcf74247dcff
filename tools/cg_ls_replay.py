#!/usr/bin/env python3
"""How many host reads and cost evaluations CG's batched line search makes
when its first read waits for a given number of evaluations: a replay, on
the CPU, of one UR10 solve's per-iteration needs.

    python tools/cg_ls_replay.py --goals 8192 --seed 0

Solves seeded UR10 goals with make_solver(CGParams.production()) on the
CPU at float32 with riemannian.LS_WINDOW = 0 (a host read after every
evaluation, so each line search runs exactly what its slowest lane needs),
counting the cost evaluations between gradient evaluations. It then replays
that sequence under each rule for the first read: the last line search's
need ("prev") and the least need of the last K line searches ("minK"), and
prints one JSON line with the evaluations needed, and for each rule the
evaluations run, the evaluations wasted and the host reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--goals", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import numpy as np
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers import costs, riemannian

    needs = [0]
    cost, egrad = costs.cost, costs.egrad

    def counted_cost(*a, **k):
        needs[-1] += 1
        return cost(*a, **k)

    def counted_egrad(*a, **k):
        needs.append(0)
        return egrad(*a, **k)

    costs.cost, costs.egrad = counted_cost, counted_egrad
    riemannian.LS_WINDOW = 0
    _, ps = load_ur10()
    solver = api.make_solver(ps, params=riemannian.CGParams.production(), device="cpu")
    T = api.random_goals(ps, (args.goals,), torch.Generator().manual_seed(args.seed),
                         dtype=torch.float32, device="cpu")[0]
    solver.solve(*solver.prepare(T)[::-1])
    # needs[0] is the initial cost, needs[k] the line search of iteration k;
    # the last one only finds every lane done
    m = np.array(needs[1:-1])
    rules = {"prev": lambda i: m[i - 1] if i else 1}
    for K in (2, 3, 5, 8, 16, 32):
        rules[f"min{K}"] = lambda i, K=K: m[max(0, i - K):i].min() if i else 1
    out = {"goals": args.goals, "seed": args.seed, "line_searches": len(m),
           "evaluations_needed": int(m.sum()), "reads_one_per_evaluation": int(m.sum())}
    for name, rule in rules.items():
        first = np.array([rule(i) for i in range(len(m))])
        out[name] = {"evaluations": int(np.maximum(first, m).sum()),
                     "wasted": int(np.maximum(first - m, 0).sum()),
                     "reads": int((np.maximum(m - first, 0) + 1).sum())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
