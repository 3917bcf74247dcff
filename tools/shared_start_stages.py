#!/usr/bin/env python3
"""Where the JAX package and the port part on a shared-start config's
perturbed starts, stage by stage, both on the CPU at float32:

    python tools/shared_start_stages.py --goals build/parity/planar40_smooth2_s56.npz

The goals and JAX's own Y0 come from the JAX half of tools/torch_parity.py
(`--init-noise K` configs: planar40_smooth2, dh19_smooth2; for a config
whose half saved no Y0, planar40 say, JAX's prepare makes it here). For
each of the K perturbations (torch_parity.init_noise; with `--noise 0` the
start itself) both packages start from the same float32 array, JAX's Y0
times the perturbation, and run the config's stages: the solve (JAX's
"edge" backend, the port's plain TR version), joint recovery, the distance
limits and pose error, and the LM polish. For each stage it reports how
far the packages lie apart (Y: lanes bitwise equal, max |dY| over max |Y|,
iteration counts; q before the polish: max |dq|), the success counts
before and after the polish (before it also with each package's q held
to the distance limits in float64), and a cross-feed: the port's polish
from JAX's pre-polish q, against JAX's from the same q. A stage whose
counts part systematically over the K starts (the permutation test of
tools/torch_parity.py) is where the packages differ; one JSON line per
start, then a summary line. Needs both
packages (JAX on the CPU); 6-17 s a start for planar40's 1000 goals.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--goals", required=True, help="a shared-start config's JAX half (.npz)")
    p.add_argument("--noise", type=int, default=16,
                   help="perturbed starts (the first K; 0: the start itself)")
    p.add_argument("--n", type=int, default=None, help="the first n goals (default: all)")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import torch_parity as tp
    from graphik_tpu import api as japi
    from graphik_tpu.graphs.problem import ProblemStructure as JPS
    from graphik_tpu.robots import library as jlib
    from graphik_tpu.solvers import riemannian as jriem
    from graphik_tpu.solvers.local import LocalParams as JLocal
    from graphik_tpu.solvers.riemannian import CGParams as JCG, TRParams as JTR
    from graphik_tpu.utils.environments import table_environment as jtable
    from graphik_tpu_torch import api as tapi
    from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
    from graphik_tpu_torch.robots import library as tlib
    from graphik_tpu_torch.solvers.local import LocalParams as TLocal
    from graphik_tpu_torch.solvers.riemannian import CGParams as TCG, TRParams as TTR
    from graphik_tpu_torch.utils.environments import table_environment as ttable

    torch.set_num_threads(max(1, os.cpu_count() // 2))
    ref = np.load(args.goals)
    config = str(ref["config"])
    cfg = tp.CONFIGS[config]
    n = args.n or len(ref["T_goal"])
    T = np.asarray(ref["T_goal"][:n], np.float32)
    jps = tp.structure(cfg["robot"], jlib, JPS, jtable, None)
    tps = tp.structure(cfg["robot"], tlib, TPS, ttable, None)
    jkw = tp.solver_kwargs(cfg, JTR, JLocal, JCG)
    jkw["params"] = dataclasses.replace(jkw["params"], backend="edge")
    tkw = tp.solver_kwargs(cfg, TTR, TLocal, TCG)
    omega, psi_L, psi_U = jps.masks()
    lt = 1e-6

    @jax.jit
    def j_prepare(Tg):
        with jax.default_matmul_precision("highest"):
            return jps.instance(Tg, dtype=jnp.float32, smooth=True,
                                smooth_iters=jkw.get("smooth_iters"))["D_goal"]

    @jax.jit
    def j_solve(Y, D):
        with jax.default_matmul_precision("highest"):
            sol = japi.solve_reduced(jps, Y, D, omega, psi_L, psi_U, params=jkw["params"])
            return sol["Y"], sol["iterations"]

    @jax.jit
    def j_pre(Y, Tg):
        with jax.default_matmul_precision("highest"):
            q = jps.joint_variables(Y, Tg)
            viol, ok = jps.check_distance_limits(jps.realization(q), tol=lt)
            e_pos, e_rot = japi.pose_error(jps, q, Tg)
            return q, e_pos, e_rot, viol, ok

    @jax.jit
    def j_polish(q, Tg, e_pos, e_rot, viol, ok):
        with jax.default_matmul_precision("highest"):
            _, e_pos, e_rot, _, ok = japi.polish_solution(jps, q, Tg, e_pos, e_rot, viol, ok,
                                                          limit_tol=lt,
                                                          params=jkw.get("polish_params"))
            return (e_pos < tp.CRIT_POS) & (e_rot < tp.CRIT_ROT) & ok

    solver = tapi.Solver(tps, device="cpu", **tkw)

    def t_pre(Y, Tg):
        q = tps.joint_variables(Y, Tg)
        viol, ok = tps.check_distance_limits(tps.realization(q), tol=lt)
        e_pos, e_rot = tapi.pose_error(tps, q, Tg)
        return q, e_pos, e_rot, viol, ok

    def t_polish(pre, Tg):
        _, e_pos, e_rot, _, ok = tapi.polish_solution(tps, *pre[:1], Tg, *pre[1:],
                                                      limit_tol=lt,
                                                      params=tkw.get("polish_params"))
        return ((e_pos < tp.CRIT_POS) & (e_rot < tp.CRIT_ROT) & ok).numpy()

    def hits(e_pos, e_rot, ok):
        return np.asarray((e_pos < tp.CRIT_POS) & (e_rot < tp.CRIT_ROT) & ok)

    def hits_float64_limits(pre):
        # the same errors, the distance limits of q checked in float64
        q = torch.from_numpy(np.asarray(pre[0])).double()
        ok = tps.check_distance_limits(tps.realization(q), tol=lt)[1].numpy()
        return int(hits(np.asarray(pre[1]), np.asarray(pre[2]), ok).sum())

    Tj, Tt = jnp.asarray(T), torch.from_numpy(T)
    if "Y0" in ref:
        Y0 = np.asarray(ref["Y0"][:n], np.float32)
    else:
        Y0 = np.asarray(tp.jax_from_init(japi, jps, jriem, jkw, jnp.float32)[0](Tj)[1])
    starts = [(k, Y0 * tp.init_noise(k, Y0.shape[-2:])) for k in range(args.noise)] or [(None, Y0)]
    Dj = j_prepare(Tj)
    Dt = solver.prepare(Tt)[0]
    d_equal = bool(np.array_equal(np.asarray(Dj), Dt.numpy()))
    rows = []
    for k, Yk in starts:
        t0 = time.perf_counter()
        Yj, it_j = (np.asarray(x) for x in j_solve(jnp.asarray(Yk), Dj))
        sol = solver.solve(torch.from_numpy(Yk), Dt)
        Yt, it_t = sol["Y"].numpy(), sol["iterations"].numpy()
        pre_j = j_pre(jnp.asarray(Yj), Tj)
        pre_t = t_pre(sol["Y"], Tt)
        qj, qt = np.asarray(pre_j[0]), pre_t[0].numpy()
        ok_j = np.asarray(j_polish(*pre_j[:1], Tj, *pre_j[1:]))
        ok_t = t_polish(pre_t, Tt)
        # the port's polish from JAX's pre-polish q, limits and errors
        cross = t_polish(tuple(torch.from_numpy(np.asarray(x)) for x in pre_j), Tt)
        row = {
            "k": k, "Y_lanes_equal": int((Yj == Yt).reshape(n, -1).all(1).sum()),
            "Y_max_rel": float(np.abs(Yj - Yt).max() / max(np.abs(Yj).max(), 1e-30)),
            "iterations_equal": int((it_j == it_t).sum()),
            "q_pre_max_abs": float(np.abs(qj - qt).max()),
            "pre_polish": [int(hits(*pre_j[1:3], pre_j[4]).sum()),
                           int(hits(pre_t[1].numpy(), pre_t[2].numpy(), pre_t[4].numpy()).sum())],
            "pre_polish_float64_limits": [hits_float64_limits(pre_j),
                                          hits_float64_limits(pre_t)],
            "post_polish": [int(ok_j.sum()), int(ok_t.sum())],
            "port_polish_from_jax_q": int(cross.sum()),
            "post_disagree": int((ok_j != ok_t).sum()),
            "cross_disagree": int((ok_j != cross).sum()),
            "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    jax_post = [r["post_polish"][0] for r in rows]
    summary = {
        "config": config, "seed": int(ref["seed"]), "n": n, "starts": len(rows),
        "D_goal_bitwise": d_equal,
        "Y_lanes_equal_mean": float(np.mean([r["Y_lanes_equal"] for r in rows])),
        "iterations_equal_mean": float(np.mean([r["iterations_equal"] for r in rows])),
        "q_pre_max_abs": max(r["q_pre_max_abs"] for r in rows),
        "mean_pre_polish": [float(np.mean([r["pre_polish"][i] for r in rows])) for i in (0, 1)],
        "mean_pre_polish_float64_limits": [
            float(np.mean([r["pre_polish_float64_limits"][i] for r in rows])) for i in (0, 1)],
        "mean_post_polish": [float(np.mean(jax_post)),
                             float(np.mean([r["post_polish"][1] for r in rows]))],
        "mean_port_polish_from_jax_q": float(np.mean([r["port_polish_from_jax_q"]
                                                      for r in rows])),
        "mean_cross_disagree": float(np.mean([r["cross_disagree"] for r in rows]))}
    if len(rows) > 1:
        summary.update(
            p_post=tp.permutation_p(np.array(jax_post),
                                    np.array([r["post_polish"][1] for r in rows])),
            p_cross=tp.permutation_p(np.array(jax_post),
                                     np.array([r["port_polish_from_jax_q"] for r in rows])))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
