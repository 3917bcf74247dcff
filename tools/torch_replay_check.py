#!/usr/bin/env python3
"""Where do the port and the JAX package part on ur10_table_restarts2 when
both start from the same sampled inits?

Replaying the JAX package's sampled interpolation fractions through the port
(tools/torch_parity.py), a few goals are solved only by JAX. This check
takes the stages apart, restart by restart (restart 0 deterministic,
restart 1 sampled from draw i's key, as the restart solver draws them), on
the parity goals (seed 46, production(250, 32), 10-step polish, 2-squaring
smoothing, float32):

    # 1. JAX on the CPU: the sampled Grams, their eigh, the inits, the TR
    #    solutions and the finish's success of every restart
    python tools/torch_replay_check.py jax --draws 4

    # 2. the port on the card, from those numbers
    python3 tools/torch_replay_check.py torch

The port half reports, over all instances and over the goals only JAX
solves: torch.linalg.eigh of JAX's own Grams against jnp.linalg.eigh
(eigenvalues, and the projector onto the top-3 eigenvectors), the port's
Grams and inits (as Gram matrices Y0 Y0^T) against JAX's, the port's TR
solve and finish from JAX's inits, and the port's finish from JAX's TR
solutions. It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED, RESTART_SEED, R = 46, 7, 2
TR = dict(maxiter=250, maxinner=32)
POLISH, SMOOTH, CRIT_POS, CRIT_ROT = 10, 2, 1e-3, np.pi / 180
OUT = "build/parity/ur10_table_restarts2_replay.npz"


def top3_projector(U):
    """The projector onto the top-3 eigenvectors (eigh's last columns)."""
    V = U[..., -3:]
    return V @ V.swapaxes(-1, -2)


def run_jax(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from graphik_tpu import api
    from graphik_tpu.graphs.problem import ProblemStructure
    from graphik_tpu.robots import kinematics, library
    from graphik_tpu.solvers import riemannian
    from graphik_tpu.solvers.local import LocalParams
    from graphik_tpu.solvers.riemannian import TRParams
    from graphik_tpu.utils import dgp
    from graphik_tpu.utils.environments import table_environment

    ps = ProblemStructure.from_template(library.load_ur10()[0], obstacles=table_environment())
    tpl = ps.template
    q = np.random.RandomState(SEED).uniform(tpl.lb[1:], tpl.ub[1:], size=(args.n, tpl.n))
    T_goal = jnp.asarray(np.asarray(kinematics.all_poses(tpl, jnp.asarray(q))[:, tpl.ee],
                                    np.float32))
    Nr = ps.reduced_spec()["Nr"]
    omega_np, psi_L, psi_U = ps.masks()
    omega = jnp.asarray(omega_np[:Nr, :Nr])
    params = TRParams.production(**TR)
    t0 = time.perf_counter()
    inst = jax.jit(lambda T: ps.instance(T, dtype=jnp.float32, smooth=True, n_nodes=Nr,
                                         smooth_iters=SMOOTH))(T_goal)
    lb, ub = inst["lb"], inst["ub"]

    @jax.jit
    def solve(Y0):
        return api.solve_reduced(ps, Y0, inst["D_goal"], omega_np, psi_L, psi_U, params=params)

    @jax.jit
    def finish(Y):
        qs = ps.joint_variables(Y, T_goal)
        viol, ok = ps.check_distance_limits(ps.realization(qs))
        e_pos, e_rot = api.pose_error(ps, qs, T_goal)
        _, e_pos, e_rot, _, ok = api.polish_solution(
            ps, qs, T_goal, e_pos, e_rot, viol, ok,
            params=LocalParams(maxiter=POLISH, tol_grad=1e-8))
        return (e_pos < CRIT_POS) & (e_rot < CRIT_ROT) & ok

    keys = [None] + [jax.random.split(jax.random.PRNGKey(RESTART_SEED + i), R)[1]
                     for i in range(args.draws)]
    rec = {k: [] for k in ("fracs", "gram", "lam", "proj", "Y0", "Y", "success")}
    for key in keys:
        Y0 = riemannian.generate_initialization(lb, ub, omega, 3, key=key)
        Y = solve(Y0)["Y"]
        rec["Y0"].append(np.asarray(Y0))
        rec["Y"].append(np.asarray(Y))
        rec["success"].append(np.asarray(finish(Y)))
        if key is not None:
            frac = jax.random.uniform(key, lb.shape, dtype=lb.dtype)
            G = dgp.gram_from_distance_matrix(dgp.sample_distance_matrix(lb, ub, key=key))
            G = (G + jnp.swapaxes(G, -1, -2)) / 2
            lam, U = jnp.linalg.eigh(G)
            rec["fracs"].append(np.asarray(frac))
            rec["gram"].append(np.asarray(G))
            rec["lam"].append(np.asarray(lam))
            rec["proj"].append(np.asarray(top3_projector(U)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, T_goal=np.asarray(T_goal), **{k: np.stack(v) for k, v in rec.items()})
    s = np.stack(rec["success"])
    print(json.dumps({"half": "jax", "n": args.n, "draws": args.draws,
                      "success_per_restart": s.sum(1).tolist(),
                      "picked_per_draw": (s[0] | s[1:]).sum(1).tolist(),
                      "wall_s": time.perf_counter() - t0, "out": args.out}))
    return 0


def run_torch(args):
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.robots import library
    from graphik_tpu_torch.solvers import riemannian
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import TRParams
    from graphik_tpu_torch.utils import dgp
    from graphik_tpu_torch.utils.environments import table_environment

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_replay_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = {k: torch.as_tensor(v, device=dev) for k, v in np.load(args.goals).items()}
    ps = ProblemStructure.from_template(library.load_ur10()[0], obstacles=table_environment())
    solver = api.make_solver(ps, params=TRParams.production(**TR),
                             polish_params=LocalParams(maxiter=POLISH, tol_grad=1e-8),
                             smooth_iters=SMOOTH)
    T_goal = ref["T_goal"]
    inst = ps.instance(T_goal, smooth=True, n_nodes=solver.n_nodes, smooth_iters=SMOOTH)
    D_goal, lb, ub = inst["D_goal"], inst["lb"], inst["ub"]
    omega = solver.omega[:solver.n_nodes, :solver.n_nodes]

    def success(sol):
        o = solver.finish(sol, T_goal)
        return ((o["e_pos"] < CRIT_POS) & (o["e_rot"] < CRIT_ROT) & o["success"]).cpu()

    def per_instance_max(x):
        return x.abs().flatten(-2).amax(-1).cpu()

    own, from_init, from_Y = [], [], []
    d_lam, d_proj, d_gram, d_init = [], [], [], []
    for r in range(len(ref["success"])):
        frac = None if r == 0 else ref["fracs"][r - 1]
        Y0 = riemannian.generate_initialization(lb, ub, omega, 3, frac=frac)
        own.append(success(solver.solve(Y0, D_goal)))
        from_init.append(success(solver.solve(ref["Y0"][r], D_goal)))
        zeros = torch.zeros(T_goal.shape[0], device=dev)
        from_Y.append(success({"Y": ref["Y"][r], "cost": zeros, "gradnorm": zeros,
                               "iterations": zeros, "num_inner": zeros}))
        Yj = ref["Y0"][r]
        d_init.append(per_instance_max(Y0 @ Y0.transpose(-1, -2) - Yj @ Yj.transpose(-1, -2)))
        if r:
            lam, U = torch.linalg.eigh(ref["gram"][r - 1])
            d_lam.append((lam - ref["lam"][r - 1]).abs().amax(-1).cpu())
            d_proj.append(per_instance_max(top3_projector(U) - ref["proj"][r - 1]))
            G = dgp.gram_from_distance_matrix(dgp.sample_distance_matrix(lb, ub, frac=frac))
            d_gram.append(per_instance_max((G + G.transpose(-1, -2)) / 2 - ref["gram"][r - 1]))
    jax_s = ref["success"].cpu()
    own, from_init, from_Y = torch.stack(own), torch.stack(from_init), torch.stack(from_Y)
    # per draw, the restart pick succeeds where either restart does
    pick_j, pick_t = jax_s[0] | jax_s[1:], own[0] | own[1:]
    jax_only = pick_j & ~pick_t
    d_lam, d_proj, d_gram = torch.stack(d_lam), torch.stack(d_proj), torch.stack(d_gram)
    d_init = torch.stack(d_init)

    def stats(x, mask=None):
        x = x[mask] if mask is not None else x.flatten()
        return {"max": float(x.max()), "median": float(x.median())} if x.numel() else None

    # the JAX-only goals' sampled restarts: where JAX's restart 1 succeeded
    # and the port's did not
    lost = jax_only & jax_s[1:] & ~own[1:]
    print(json.dumps({
        "half": "torch", "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n": int(T_goal.shape[0]), "draws": int(len(jax_s) - 1),
        "success_per_restart": {"jax": jax_s.sum(1).tolist(), "port_own_init": own.sum(1).tolist(),
                                "port_from_jax_init": from_init.sum(1).tolist(),
                                "port_finish_of_jax_Y": from_Y.sum(1).tolist()},
        "picked": {"jax": pick_j.sum(1).tolist(), "port": pick_t.sum(1).tolist(),
                   "jax_only": int(jax_only.sum()), "port_only": int((pick_t & ~pick_j).sum())},
        "jax_only_sampled_restarts": int(lost.sum()),
        "on_those": {"port_from_jax_init": int((from_init[1:] & lost).sum()),
                     "port_finish_of_jax_Y": int((from_Y[1:] & lost).sum()),
                     "d_eig": stats(d_lam, lost), "d_proj": stats(d_proj, lost),
                     "d_gram": stats(d_gram, lost), "d_init_gram": stats(d_init[1:], lost)},
        "all_sampled": {"d_eig": stats(d_lam), "d_proj": stats(d_proj), "d_gram": stats(d_gram),
                        "d_init_gram": stats(d_init[1:])},
        "deterministic_d_init_gram": stats(d_init[0]),
    }))
    return 0


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="half", required=True)
    pj = sub.add_parser("jax", help="the JAX package's stages on the CPU")
    pj.add_argument("--n", type=int, default=1000)
    pj.add_argument("--draws", type=int, default=4)
    pj.add_argument("--out", default=OUT)
    pt = sub.add_parser("torch", help="the port's stages from the JAX numbers")
    pt.add_argument("--goals", default=OUT)
    pt.add_argument("--device", default="cuda")
    args = p.parse_args()
    return run_jax(args) if args.half == "jax" else run_torch(args)


if __name__ == "__main__":
    sys.exit(main())
