#!/usr/bin/env python3
"""Which piece of the LM polish parts the port from the JAX package, both
on the CPU at float32, from the same pre-polish q:

    python tools/lm_polish_pieces.py --goals build/parity/planar40_smooth2_s256.npz

The goals and JAX's own Y0 come from the JAX half of tools/torch_parity.py
(for a config whose half saved no Y0, JAX's prepare makes it here). For
each start (with `--noise K`, K perturbed starts as
tools/shared_start_stages.py makes them; 0: the start itself) JAX's solve
and joint recovery give the pre-polish q. From it the polish's LM runs
step for step (solvers/local.py's loop at the config's LocalParams), each
of its three pieces from either package (a combination names them in
this order, j: JAX, t: the port):

  residual  the pose residual r and its Jacobian J;
  normal    g = J^T r and H = J^T J + lam I;
  solve     the damped step -H^-1 g (JAX: its unrolled Cholesky with
            clamped pivots, graphik_tpu/ops/linalg.py; the port: the same
            algorithm, ops/linalg.py spd_solve, summed one product at a
            time).

Three more solves: c, torch.linalg.cholesky_ex and two triangular solves,
no step where the factorization fails (the port's solve before it took
the clamped pivots); u, JAX's unrolled Cholesky and substitutions
transcribed in torch (torch's sums); and d, the port's solve in float64
on the float32 system. Every combination's polished q is judged
alike, by JAX's polish_solution selection (pose error and distance
limits against the pre-polish q's). jjj must reproduce JAX's solve_local
and ttt the port's, lane for lane (checked; the improvement test's sum of
the residual's squares is the same numpy sum for every combination). One
JSON line per start with each combination's success count, then a summary:
each combination's mean and its permutation p against jjj's counts and
ttt's (tools/torch_parity.py's test). With `--accuracy`, the first
start's steps along JAX's own path instead: each package's residual,
Jacobian, g, H and step against float64 (median over lanes of the
relative error). Needs both packages (JAX on the CPU); ~1 min a start
for planar40's 1000 goals. Configs without obstacles only.
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

COMBOS = ["jjj", "ttt", "tjj", "jtj", "jjt", "jtt", "tjt", "ttj", "ttc", "ttu", "ttd"]


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--goals", required=True, help="a parity config's JAX half (.npz)")
    p.add_argument("--noise", type=int, default=16,
                   help="perturbed starts (the first K; 0: the start itself)")
    p.add_argument("--combos", default=",".join(COMBOS),
                   help="combinations of residual / normal / solve, comma-separated")
    p.add_argument("--accuracy", action="store_true",
                   help="each piece's error against float64 on the first start instead")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import torch_parity as tp
    from graphik_tpu import api as japi
    from graphik_tpu.graphs.problem import ProblemStructure as JPS
    from graphik_tpu.ops.linalg import spd_solve_unrolled
    from graphik_tpu.robots import library as jlib
    from graphik_tpu.solvers import local as jlocal
    from graphik_tpu.solvers import riemannian as jriem
    from graphik_tpu.solvers.local import LocalParams as JLocal
    from graphik_tpu.solvers.riemannian import CGParams as JCG, TRParams as JTR
    from graphik_tpu.utils.environments import table_environment as jtable
    from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
    from graphik_tpu_torch.ops import linalg as tlinalg
    from graphik_tpu_torch.robots import library as tlib
    from graphik_tpu_torch.solvers import local as tlocal
    from graphik_tpu_torch.utils.environments import table_environment as ttable

    torch.set_num_threads(max(1, os.cpu_count() // 2))
    ref = np.load(args.goals)
    config = str(ref["config"])
    cfg = tp.CONFIGS[config]
    T = np.asarray(ref["T_goal"], np.float32)
    n = len(T)
    jps = tp.structure(cfg["robot"], jlib, JPS, jtable, None)
    tps = tp.structure(cfg["robot"], tlib, TPS, ttable, None)
    if jps.n_obstacles:
        raise SystemExit("configs without obstacles only")
    jkw = tp.solver_kwargs(cfg, JTR, JLocal, JCG)
    jkw["params"] = dataclasses.replace(jkw["params"], backend="edge")
    pp = jkw.get("polish_params") or JLocal(maxiter=30, tol_grad=1e-8)
    omega, psi_L, psi_U = jps.masks()
    tpl_j, tpl_t = jps.template, tps.template
    m = tpl_j.n
    lb = np.asarray(tpl_j.lb[1:], np.float32)
    ub = np.asarray(tpl_j.ub[1:], np.float32)
    Tj, Tt = jnp.asarray(T), torch.from_numpy(T)

    def highest(f):
        def g(*a):
            with jax.default_matmul_precision("highest"):
                return f(*a)
        return jax.jit(g)

    @highest
    def j_pre(Y, Tg):
        D = jps.instance(Tg, dtype=jnp.float32, smooth=True,
                         smooth_iters=jkw.get("smooth_iters"))["D_goal"]
        sol = japi.solve_reduced(jps, Y, D, omega, psi_L, psi_U, params=jkw["params"])
        q = jps.joint_variables(sol["Y"], Tg)
        _, ok = jps.check_distance_limits(jps.realization(q), tol=1e-6)
        e_pos, e_rot = japi.pose_error(jps, q, Tg)
        return q, e_pos, e_rot, ok

    @highest
    def j_judge(q_p, Tg, e_pos, e_rot, ok):
        # polish_solution's selection and the parity's success
        _, ok_p = jps.check_distance_limits(jps.realization(q_p), tol=1e-6)
        e_pos_p, e_rot_p = japi.pose_error(jps, q_p, Tg)
        big = jnp.asarray(1e3, e_pos.dtype)
        take = (e_pos_p + e_rot_p + jnp.where(ok_p, 0.0, big)
                < e_pos + e_rot + jnp.where(ok, 0.0, big))
        e_pos = jnp.where(take, e_pos_p, e_pos)
        e_rot = jnp.where(take, e_rot_p, e_rot)
        return (e_pos < tp.CRIT_POS) & (e_rot < tp.CRIT_ROT) & jnp.where(take, ok_p, ok)

    j_local = highest(lambda q, Tg: jlocal.solve_local(jps, Tg, q, pp)["q"])

    # the pieces: numpy float32 in, numpy out
    j_res = highest(jax.vmap(lambda q, Tg: jlocal._stacked_pose_residuals(tpl_j, Tg, q)))
    j_normal = highest(jax.vmap(lambda r, J, lam: (J.T @ r, J.T @ J + lam * jnp.eye(m, dtype=r.dtype))))
    j_solve = highest(jax.vmap(lambda H, g: -spd_solve_unrolled(H, g)))

    def t_res(q):
        e, J = tlocal._pose_residuals(tpl_t, Tt, torch.tensor(q))
        return e.numpy(), J.numpy()

    def t_normal(r, J, lam):
        r, J, lam = (torch.tensor(x) for x in (r, J, lam))
        g = (J * r[..., :, None]).sum(-2)
        return g.numpy(), (J.transpose(-1, -2) @ J + lam[:, None, None] * torch.eye(m)).numpy()

    def t_solve(H, g):
        return (-tlinalg.spd_solve_reference(torch.tensor(H), torch.tensor(g))).numpy()

    def c_solve(H, g):
        H, g = torch.tensor(H), torch.tensor(g)
        L, info = torch.linalg.cholesky_ex(H)
        w = torch.linalg.solve_triangular(L, g[..., None], upper=False)
        step = -torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)[..., 0]
        return torch.where((info == 0)[:, None], step, torch.zeros_like(step)).numpy()

    def u_solve(H, g):
        # graphik_tpu/ops/linalg.py's chol_unrolled and chol_solve_unrolled
        H, b = torch.tensor(H), torch.tensor(g)
        L = torch.zeros_like(H)
        for j in range(m):
            d = torch.sqrt(torch.clamp(H[:, j, j] - (L[:, j, :j] ** 2).sum(-1), min=1e-30))
            L[:, j, j] = d
            L[:, j + 1:, j] = (H[:, j + 1:, j]
                               - (L[:, j + 1:, :j] * L[:, j, None, :j]).sum(-1)) / d[:, None]
        y = torch.zeros_like(b)
        for i in range(m):
            y[:, i] = (b[:, i] - (L[:, i, :i] * y[:, :i]).sum(-1)) / L[:, i, i]
        x = torch.zeros_like(b)
        for i in reversed(range(m)):
            x[:, i] = (y[:, i] - (L[:, i + 1:, i] * x[:, i + 1:]).sum(-1)) / L[:, i, i]
        return (-x).numpy()

    def d_solve(H, g):
        return t_solve(H.astype(np.float64), g.astype(np.float64)).astype(np.float32)

    pieces = {"res": {"j": lambda q: j_res(q, Tj), "t": t_res},
              "normal": {"j": j_normal, "t": t_normal},
              "solve": {"j": j_solve, "t": t_solve, "c": c_solve, "u": u_solve, "d": d_solve}}

    def lm(combo, q, path=None):
        """solvers/local.py's lm_solve (no obstacles) with the pieces of
        `combo`; path collects each step's (q, r, J, lam, g, H)."""
        res, normal, solve = (pieces[k][c] for k, c in zip(("res", "normal", "solve"), combo))
        lam = np.full(n, pp.lm_init, np.float32)
        done = np.zeros(n, bool)
        for _ in range(pp.maxiter):
            live = ~done
            r, J = (np.asarray(x) for x in res(q))
            g, H = (np.asarray(x) for x in normal(r, J, lam))
            if path is not None:
                path.append((q, r, J, lam, g, H))
            q_new = np.clip(q + np.asarray(solve(H, g)), lb, ub)
            r_new = np.asarray(res(q_new)[0])
            # a NaN step (a clamped pivot's) fails the test, as in both packages
            improved = (r_new * r_new).sum(-1) < (r * r).sum(-1)
            q = np.where((live & improved)[:, None], q_new, q)
            lam = np.where(live, np.clip(np.where(improved, lam * pp.lm_down, lam * pp.lm_up),
                                         1e-12, 1e8), lam).astype(np.float32)
            done = done | (live & (np.linalg.norm(g, axis=-1) < pp.tol_grad))
        return q

    if "Y0" in ref:
        Y0 = np.asarray(ref["Y0"], np.float32)
    else:
        Y0 = np.asarray(tp.jax_from_init(japi, jps, jriem, jkw, jnp.float32)[0](Tj)[1])
    starts = [(k, Y0 * tp.init_noise(k, Y0.shape[-2:])) for k in range(args.noise)] or [(None, Y0)]

    if args.accuracy:
        q0, *_ = (np.asarray(x) for x in j_pre(jnp.asarray(starts[0][1]), Tj))
        path = []
        lm("jjj", q0, path)
        T64 = torch.from_numpy(T.astype(np.float64))

        def rel(a, b):
            a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
            return float(np.median(np.linalg.norm(a - b, axis=1)
                                   / np.maximum(np.linalg.norm(b, axis=1), 1e-30)))
        for step, (q, r, J, lam, g, H) in enumerate(path):
            e64, J64 = (x.numpy() for x in tlocal._pose_residuals(
                tpl_t, T64, torch.from_numpy(q.astype(np.float64))))
            Jd = J.astype(np.float64)
            g64 = np.einsum("bij,bi->bj", Jd, r.astype(np.float64))
            H64 = np.einsum("bij,bik->bjk", Jd, Jd) + lam.astype(np.float64)[:, None, None] * np.eye(m)
            s64 = -np.linalg.solve(H.astype(np.float64), g.astype(np.float64)[..., None])[..., 0]
            row = {"step": step}
            for c in "jt":
                r_c, J_c = (np.asarray(x) for x in pieces["res"][c](q))
                g_c, H_c = (np.asarray(x) for x in pieces["normal"][c](r, J, lam))
                s_c = np.asarray(pieces["solve"][c](H, g))
                # the lanes whose system the library's Cholesky factors
                ok = np.isfinite(s_c).all(1) & (c_solve(H, g) != 0).any(1)
                row[c] = {"r": rel(r_c, e64), "J": rel(J_c, J64), "g": rel(g_c, g64),
                          "H": rel(H_c, H64), "step": rel(s_c[ok], s64[ok])}
            row["lanes_library_cholesky_fails"] = int(n - ok.sum())
            print(json.dumps(row), flush=True)
        return 0

    combos = args.combos.split(",")
    rows = []
    for k, Yk in starts:
        t0 = time.perf_counter()
        q0, e_pos, e_rot, ok = j_pre(jnp.asarray(Yk), Tj)
        q0 = np.asarray(q0)
        counts, qs = {}, {}
        for c in combos:
            qs[c] = lm(c, q0)
            counts[c] = int(np.asarray(j_judge(jnp.asarray(qs[c]), Tj, e_pos, e_rot, ok)).sum())
        row = {"k": k, "counts": counts, "seconds": time.perf_counter() - t0}
        if "jjj" in qs:
            row["jjj_lanes_equal_jax_solve_local"] = int(
                (qs["jjj"] == np.asarray(j_local(jnp.asarray(q0), Tj))).all(1).sum())
        if "ttt" in qs:
            q_t = tlocal.solve_local(tps, Tt, torch.tensor(q0), tlocal.LocalParams(
                maxiter=pp.maxiter, tol_grad=pp.tol_grad))["q"].numpy()
            row["ttt_lanes_equal_port_solve_local"] = int((qs["ttt"] == q_t).all(1).sum())
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"config": config, "seed": int(ref["seed"]), "n": n, "starts": len(rows),
               "mean": {c: float(np.mean([r["counts"][c] for r in rows])) for c in combos}}
    if len(rows) > 1:
        for base in ("jjj", "ttt"):
            if base in combos:
                b = np.array([r["counts"][base] for r in rows])
                summary[f"p_against_{base}"] = {
                    c: tp.permutation_p(b, np.array([r["counts"][c] for r in rows]))
                    for c in combos if c != base}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
