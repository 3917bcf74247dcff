#!/usr/bin/env python3
"""Iterations to convergence of Riemannian CG at float64, the port against
the JAX package, over many goals: whether the port's "edge" (or "dense")
backend needs more iterations in distribution than the JAX package's.

    python tools/cg_iterations.py --robot planar6 --goals 64 --key 0 --maxiter 3000

Runs on the CPU. Goals come from the JAX package's random_goals
(PRNGKey(--key)); both packages solve them with solve_ik, CGParams(maxiter,
backend) and no plateau stop (with --production, CGParams.production: the
plateau stop every 16 iterations, without which CG on UR10 rarely reaches
its float64 gradnorm stop), use_limits=True, no polish, from the
realization of the zero configuration, as tests/test_riemannian.py's CG
tests do (planar6 is their planar_from_links(np.ones(6)); ur10 is
load_ur10). A lane that reaches maxiter has not converged. Prints one JSON
line: for each (package, backend), the iteration quantiles (50, 90, max),
the mean and the lanes at maxiter; and, for pairs of runs on the same
goals, the lanes where the first needs more iterations than the second and
the median of the per-lane ratio. The JAX package's own edge / dense pair
is the spread that parted float64 trajectories give.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--robot", choices=["planar6", "ur10"], default="planar6")
    p.add_argument("--goals", type=int, default=64)
    p.add_argument("--key", type=int, default=0)
    p.add_argument("--maxiter", type=int, default=3000)
    p.add_argument("--production", action="store_true")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from graphik_tpu import api as japi
    from graphik_tpu.graphs.problem import ProblemStructure as JPS
    from graphik_tpu.robots import library as jlib
    from graphik_tpu.robots.templates import planar_from_links
    from graphik_tpu.solvers import riemannian as jriem
    from graphik_tpu_torch import api as tapi
    from graphik_tpu_torch import interop
    from graphik_tpu_torch.solvers import riemannian as triem

    tpl = planar_from_links(np.ones(6)) if args.robot == "planar6" else jlib.load_ur10()[0]
    jps = JPS.from_template(tpl)
    tps = interop.structure_from_numpy(dataclasses.asdict(jps))
    T = japi.random_goals(jps, jax.random.PRNGKey(args.key), (args.goals,))[0]
    T_t = torch.from_numpy(np.array(T))
    iters = {}
    for backend in ("dense", "edge"):
        kw = dict(maxiter=args.maxiter, backend=backend)
        jp, tp = ((jriem.CGParams.production(**kw), triem.CGParams.production(**kw))
                  if args.production else (jriem.CGParams(**kw), triem.CGParams(**kw)))
        out = japi.solve_ik(jps, T, params=jp, use_limits=True,
                            Y_init=jps.realization(jnp.zeros(jps.n)), polish=False)
        iters[f"jax_{backend}"] = np.asarray(out["iterations"])
        out = tapi.solve_ik(tps, T_t, params=tp, use_limits=True, polish=False,
                            Y_init=tps.realization(torch.zeros(tps.n, dtype=torch.float64)))
        iters[f"port_{backend}"] = out["iterations"].numpy()

    def stats(it):
        return {"q50": float(np.quantile(it, 0.5)), "q90": float(np.quantile(it, 0.9)),
                "max": int(it.max()), "mean": float(it.mean()),
                "at_maxiter": int((it >= args.maxiter).sum())}

    def pair(a, b):
        x, y = iters[a].astype(float), iters[b].astype(float)
        return {"first_more": int((x > y).sum()), "second_more": int((y > x).sum()),
                "median_ratio": float(np.median(x / y))}

    print(json.dumps({
        "robot": args.robot, "goals": args.goals, "key": args.key, "maxiter": args.maxiter,
        "production": args.production,
        "runs": {k: stats(v) for k, v in iters.items()},
        "pairs": {f"{a} / {b}": pair(a, b) for a, b in [
            ("port_edge", "jax_edge"), ("port_dense", "jax_dense"),
            ("jax_edge", "jax_dense"), ("port_edge", "port_dense")]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
