#!/usr/bin/env python3
"""Does a lane's result depend on the batch it is solved in? Stage by
stage, the UR10 main path on a batch of B goals against the same path on
its first h goals alone, for each h of --prefix: the lanes whose prepare
outputs (D_goal, Y0), solve outputs (the same Y0 in), joint recovery and
LM polish (the same solve outputs in) differ in any bit, and the largest
difference. A data-parallel shard is such a prefix, so this is what
parallel.solve_ik_sharded can differ by from the unsharded solver.

    python3 tools/torch_shard_invariance.py                 # on the card
    python3 tools/torch_shard_invariance.py --device cpu --batch 64 --prefix 32 7

Prints one JSON line per prefix.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def differ(a, b):
    """(lanes of b that differ from a's first lanes in any bit, max |a - b|)."""
    a = a[:b.shape[0]]
    lanes = int((a != b).reshape(b.shape[0], -1).any(1).sum())
    return lanes, float((a.double() - b.double()).abs().max())


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=8191)
    p.add_argument("--prefix", type=int, nargs="+", default=[4096, 2048, 501])
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()

    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers import local
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import TRParams

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_shard_invariance: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    ps = load_ur10()[1]
    polish = LocalParams(maxiter=10, tol_grad=1e-8)
    solver = api.make_solver(ps, TRParams.production(maxiter=100, maxinner=24),
                             polish_params=polish, smooth_iters=2)
    T = api.random_goals(ps, (a.batch,), torch.Generator().manual_seed(a.seed),
                         dtype=torch.float32, device=dev)[0]
    D, Y0 = solver.prepare(T)
    sol = solver.solve(Y0, D)
    q0 = ps.joint_variables(sol["Y"], T)
    q_lm = local.solve_local(ps, T, q0, polish)["q"]
    out = solver.finish(sol, T)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for h in a.prefix:
        Dh, Y0h = solver.prepare(T[:h])
        sol_h = solver.solve(Y0[:h], D[:h])
        q0h = ps.joint_variables(sol["Y"][:h], T[:h])
        q_lmh = local.solve_local(ps, T[:h], q0[:h], polish)["q"]
        out_h = solver.finish({k: v[:h] for k, v in sol.items()}, T[:h])
        rec = {"device": device, "batch": a.batch, "prefix": h,
               "prepare_D_goal": differ(D, Dh), "prepare_Y0": differ(Y0, Y0h),
               "solve_Y": differ(sol["Y"], sol_h["Y"]),
               "joint_variables": differ(q0, q0h), "solve_local": differ(q_lm, q_lmh),
               "finish_q": differ(out["q"], out_h["q"]),
               "finish_success": int((out["success"][:h] != out_h["success"]).sum())}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
