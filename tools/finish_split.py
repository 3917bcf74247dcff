#!/usr/bin/env python3
"""Which stage parts the port from the JAX package on the CPU, goal for goal,
on a single-init parity config with its Y0 saved (tools/torch_parity.py jax
--config dh40_perturbed, planar40_perturbed):

    python tools/finish_split.py --goals build/parity/dh40_perturbed.npz --starts 6

For each of the first K perturbed starts of the JAX half's Y0 (the starts
tools/torch_parity.py uses), both packages solve from the same start and
the per-start success counts (1 mm / 1 deg, limit-feasible) are printed:

  solve x finish     each package's finish (joint recovery, the 10-step LM
                     polish, the verdict) of each package's solved Y;
  recovery x LM      from the JAX solve's Y: each package's joint recovery
                     (`joint_variables`) under each package's polish;
  jax_q_noise_jax_lm the JAX package's polish from its own q times
                     (1 + 1e-7 g), g ~ N(0, 1) from RandomState(k): how far
                     a change of q at float32's rounding moves its count.

then the totals over the starts, and, on start 0's JAX q, the first LM
step's damped solve (H = J^T J + lm_init I, g = J^T e from the port's
residual) by each package's clamped-pivot Cholesky (JAX's
spd_solve_unrolled, the port's `ops/linalg.py::spd_solve_reference`)
against the float64 solve of the same float32 H and g, at lm_init and at
a tenth of it: the median relative error of each and the lanes where the
port's is the larger. Both packages run at float32 on the CPU (JAX's
stages as its make_solver jits them, the port's eager stages)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--goals", required=True, help="a parity config's JAX half with its Y0")
    p.add_argument("--starts", type=int, default=6)
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
    from graphik_tpu.solvers.local import LocalParams as JLP
    from graphik_tpu.solvers.riemannian import TRParams as JTR
    from graphik_tpu.utils.environments import table_environment as jte
    from graphik_tpu_torch import api as tapi
    from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
    from graphik_tpu_torch.robots import library as tlib
    from graphik_tpu_torch.solvers.local import LocalParams as TLP
    from graphik_tpu_torch.solvers.riemannian import CGParams as TCG
    from graphik_tpu_torch.solvers.riemannian import TRParams as TTR

    torch.set_num_threads(max(1, os.cpu_count() // 2))
    ref = np.load(args.goals)
    cfg = tp.CONFIGS[str(ref["config"])]
    if cfg["restarts"] or "cidgik" in cfg or "Y0" not in ref:
        raise SystemExit("single-init Riemannian configs with a saved Y0 only")
    jps = tp.structure(cfg["robot"], jlib, JPS, jte, None)
    tps = tp.structure(cfg["robot"], tlib, TPS, None, None)
    jkw = tp.solver_kwargs(cfg, JTR, JLP, None)
    tkw = tp.solver_kwargs(cfg, TTR, TLP, TCG)
    jpp, tpp = jkw.get("polish_params"), tkw.get("polish_params")
    omega, psi_L, psi_U = jps.masks()
    T = jnp.asarray(ref["T_goal"])
    Tt = torch.as_tensor(ref["T_goal"])

    @jax.jit
    def j_solve(Y0, D_goal):
        with jax.default_matmul_precision("highest"):
            return japi.solve_reduced(jps, Y0, D_goal, omega, psi_L, psi_U,
                                      params=jkw["params"])["Y"]

    @jax.jit
    def j_recover(Y, Tg):
        with jax.default_matmul_precision("highest"):
            return jps.joint_variables(Y, Tg)

    @jax.jit
    def j_polish(q, Tg):
        with jax.default_matmul_precision("highest"):
            viol, ok = jps.check_distance_limits(jps.realization(q), tol=1e-6)
            e_pos, e_rot = japi.pose_error(jps, q, Tg)
            _, e_pos, e_rot, _, ok = japi.polish_solution(jps, q, Tg, e_pos, e_rot, viol, ok,
                                                          limit_tol=1e-6, params=jpp)
            return (e_pos < tp.CRIT_POS) & (e_rot < tp.CRIT_ROT) & ok

    def t_polish(q):
        viol, ok = tps.check_distance_limits(tps.realization(q), tol=1e-6)
        e_pos, e_rot = tapi.pose_error(tps, q, Tt)
        _, e_pos, e_rot, _, ok = tapi.polish_solution(tps, q, Tt, e_pos, e_rot, viol, ok,
                                                      limit_tol=1e-6, params=tpp)
        return tp.ok_of({"e_pos": e_pos, "e_rot": e_rot, "success": ok})

    def count(x):
        return int(np.asarray(x).sum())

    prepare, _ = tp.jax_from_init(japi, jps, jriem, jkw, jnp.float32)
    D_goal, Y0 = prepare(T)
    port = tapi.make_solver(tps, device="cpu", **tkw)
    D_t = torch.as_tensor(np.array(D_goal))
    total = {}
    for k in range(args.starts):
        t0 = time.perf_counter()
        Yk = np.asarray(Y0) * tp.init_noise(k, Y0.shape[-2:])
        Y_j = np.asarray(j_solve(jnp.asarray(Yk), D_goal))
        Y_t = port.solve(torch.as_tensor(Yk).contiguous(), D_t)["Y"].numpy()
        q = {}
        for s, Y in (("jax", Y_j), ("port", Y_t)):
            q[s, "jax"] = np.asarray(j_recover(jnp.asarray(Y), T))
            q[s, "port"] = tps.joint_variables(torch.as_tensor(Y), Tt).numpy()
        row = {}
        for s in ("jax", "port"):
            row[f"{s}_solve_jax_finish"] = count(j_polish(jnp.asarray(q[s, "jax"]), T))
            row[f"{s}_solve_port_finish"] = count(t_polish(torch.as_tensor(q[s, "port"])))
        row["jax_q_port_lm"] = count(t_polish(torch.as_tensor(q["jax", "jax"])))
        row["port_q_jax_lm"] = count(j_polish(jnp.asarray(q["jax", "port"]), T))
        g = np.random.RandomState(k).standard_normal(q["jax", "jax"].shape)
        q_n = (q["jax", "jax"] * (1.0 + 1e-7 * g)).astype(np.float32)
        row["jax_q_noise_jax_lm"] = count(j_polish(jnp.asarray(q_n), T))
        for key, v in row.items():
            total[key] = total.get(key, 0) + v
        if k == 0:
            q0 = torch.as_tensor(q["jax", "jax"])
        print(json.dumps({"k": k, **row, "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"config": str(ref["config"]), "starts": args.starts, "total": total}))
    print(json.dumps({"first_lm_step": step_accuracy(jps, tps, q0, Tt, tpp)}))
    return 0


def step_accuracy(jps, tps, q0, T_goal, pp):
    """The first LM step's damped solve at q0 by both packages against the
    float64 solve of the same float32 system."""
    import jax
    import jax.numpy as jnp
    import torch

    from graphik_tpu.ops.linalg import spd_solve_unrolled
    from graphik_tpu_torch.ops.linalg import spd_solve_reference
    from graphik_tpu_torch.solvers.local import _pose_residuals
    from graphik_tpu_torch.utils import lie

    e, J = _pose_residuals(tps.template, T_goal, q0)
    Jt = J.transpose(-1, -2)
    g, JtJ = lie.matvec_small(Jt, e), lie.matmul_small(Jt, J)
    eye = torch.eye(JtJ.shape[-1], dtype=JtJ.dtype)
    j_solve = jax.jit(jax.vmap(spd_solve_unrolled))
    out = {}
    for lam in (pp.lm_init, pp.lm_init / 10):
        H = JtJ + lam * eye
        x64 = torch.linalg.solve(H.double(), g.double()[..., None])[..., 0]
        x_j = torch.as_tensor(np.asarray(j_solve(jnp.asarray(H.numpy()), jnp.asarray(g.numpy()))))
        x_t = spd_solve_reference(H, g)
        err_j, err_t = ((x.double() - x64).norm(dim=-1) / x64.norm(dim=-1) for x in (x_j, x_t))
        out[str(lam)] = {"jax_median_rel_err": float(err_j.median()),
                         "port_median_rel_err": float(err_t.median()),
                         "port_larger_lanes": int((err_t > err_j).sum()), "lanes": len(err_t),
                         "median_cond": float(torch.linalg.cond(H.double()).median())}
    return out


if __name__ == "__main__":
    sys.exit(main())
