#!/usr/bin/env python3
"""Per-goal success parity of the PyTorch port against the JAX package on
one configuration at its bench parameters, float32, a 10-step LM polish and
2-squaring bound smoothing:

  ur10_table (default): UR10 + the 100-sphere table scene,
      TRParams.production(maxiter=250, maxinner=32), goals from seed 7;
  ur10: UR10 alone, TRParams.production(maxiter=100, maxinner=24), goals
      from seed 2026.

Two halves, because the machine with the GPU has no JAX:

    # 1. JAX package on the CPU: make the goals, solve them, save both
    python tools/torch_parity.py jax --config ur10_table --n 1000

    # 2. the port (on the GPU, or --device cpu): solve the same goals
    python3 tools/torch_parity.py torch --goals build/parity/ur10_table.npz

Goals are FK poses of joint angles drawn uniformly within the limits from
numpy's RandomState(seed). Success is the JAX package's summarize()
criterion: position error < 1 mm, rotation error < 1 degree, and
limit/obstacle feasible. The torch half prints one JSON line with both
counts, the JAX count's Wilson 95% interval and the goals solved by both,
and exits 1 when the port's count falls outside that interval.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POLISH_ITERS, SMOOTH_ITERS = 10, 2
# config -> (obstacles, maxiter, maxinner, default seed)
CONFIGS = {"ur10_table": (True, 250, 32, 7), "ur10": (False, 100, 24, 2026)}
CRIT_POS, CRIT_ROT = 1e-3, math.pi / 180


def wilson95(n, k):
    """Wilson score 95% interval of k successes in n trials."""
    z = 1.959963984540054
    p = k / n
    den = 1 + z * z / n
    centre = p + z * z / (2 * n)
    rad = z * math.sqrt((p * (1 - p) + z * z / (4 * n)) / n)
    return (centre - rad) / den, (centre + rad) / den


def run_jax(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from graphik_tpu import api
    from graphik_tpu.graphs.problem import ProblemStructure
    from graphik_tpu.robots import kinematics, library
    from graphik_tpu.solvers.local import LocalParams
    from graphik_tpu.solvers.riemannian import TRParams
    from graphik_tpu.utils.environments import table_environment

    obstacles, maxiter, maxinner, seed = CONFIGS[args.config]
    seed = seed if args.seed is None else args.seed
    tpl = library.load_ur10()[0]
    ps = ProblemStructure.from_template(tpl, obstacles=table_environment() if obstacles else None)
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(args.n, tpl.n))
    T_goal = np.asarray(kinematics.all_poses(tpl, jnp.asarray(q))[:, tpl.ee], np.float32)
    solver = api.make_solver(
        ps, params=TRParams.production(maxiter=maxiter, maxinner=maxinner),
        dtype=jnp.float32, polish_params=LocalParams(maxiter=POLISH_ITERS, tol_grad=1e-8),
        smooth_iters=SMOOTH_ITERS)
    t0 = time.perf_counter()
    out = jax.block_until_ready(solver(jnp.asarray(T_goal)))
    wall = time.perf_counter() - t0
    e_pos, e_rot = np.asarray(out["e_pos"]), np.asarray(out["e_rot"])
    ok = (e_pos < CRIT_POS) & (e_rot < CRIT_ROT) & np.asarray(out["success"])
    path = args.out or f"build/parity/{args.config}.npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, T_goal=T_goal, q_goal=q, seed=seed, config=args.config, success=ok,
             e_pos=e_pos, e_rot=e_rot, iterations=np.asarray(out["iterations"]))
    print(json.dumps({"half": "jax", "config": args.config, "device": jax.default_backend(),
                      "n": args.n, "seed": seed, "success": int(ok.sum()), "wall_s": wall,
                      "out": path}))
    return 0


def run_torch(args):
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import TRParams
    from graphik_tpu_torch.utils.environments import table_environment

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_parity: no CUDA device (pass --device cpu for the plain version)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = np.load(args.goals)
    config = str(ref["config"]) if "config" in ref else "ur10_table"
    obstacles, maxiter, maxinner, _ = CONFIGS[config]
    tpl = load_ur10()[0]
    ps = ProblemStructure.from_template(tpl, obstacles=table_environment() if obstacles else None)
    solver = api.make_solver(
        ps, params=TRParams.production(maxiter=maxiter, maxinner=maxinner),
        polish_params=LocalParams(maxiter=POLISH_ITERS, tol_grad=1e-8),
        smooth_iters=SMOOTH_ITERS, device=dev)
    T_goal = torch.as_tensor(ref["T_goal"], dtype=torch.float32, device=dev)
    launches = solve_tr_cuda.launches
    out = solver(T_goal)
    ok_t = ((out["e_pos"] < CRIT_POS) & (out["e_rot"] < CRIT_ROT) & out["success"]).cpu().numpy()
    ok_j = ref["success"].astype(bool)
    n, k_j, k_t = len(ok_j), int(ok_j.sum()), int(ok_t.sum())
    lo, hi = wilson95(n, k_j)
    inside = lo <= k_t / n <= hi
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "half": "torch", "config": config, "device": device, "n": n,
        "seed": int(ref["seed"]),
        "jax_success": k_j, "jax_wilson95": [lo, hi], "port_success": k_t,
        "both": int((ok_j & ok_t).sum()), "port_only": int((ok_t & ~ok_j).sum()),
        "jax_only": int((ok_j & ~ok_t).sum()),
        "port_mean_iterations": float(out["iterations"].double().mean()),
        "kernel_launches": solve_tr_cuda.launches - launches,
        "port_inside_jax_interval": inside,
    }))
    return 0 if inside else 1


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="half", required=True)
    pj = sub.add_parser("jax", help="make goals and solve them with the JAX package (CPU)")
    pj.add_argument("--config", choices=sorted(CONFIGS), default="ur10_table")
    pj.add_argument("--n", type=int, default=1000)
    pj.add_argument("--seed", type=int, default=None, help="default: the config's")
    pj.add_argument("--out", default=None, help="default: build/parity/<config>.npz")
    pt = sub.add_parser("torch", help="solve the saved goals with the port")
    pt.add_argument("--goals", default="build/parity/ur10_table.npz")
    pt.add_argument("--device", default="cuda")
    args = p.parse_args()
    return run_jax(args) if args.half == "jax" else run_torch(args)


if __name__ == "__main__":
    sys.exit(main())
