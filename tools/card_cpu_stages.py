#!/usr/bin/env python3
"""Whether the port's card and its CPU part on a parity config, and in
which stage, from the same starts: the K perturbations of the JAX half's
saved Y0 that tools/torch_parity.py uses (`init_noise`).

    python tools/card_cpu_stages.py card --goals build/parity/planar40_perturbed.npz \\
        --out build/planar40_card_stages.npz        # on a card
    python tools/card_cpu_stages.py cpu --card build/planar40_card_stages.npz

The card half runs the compiled solver on the config's goals: prepare
once, then from each start the solve and the finish, with the polish and
without; it saves D_goal, each start's solved Y (and the solve's other
outputs) and the per-goal success. The CPU half runs the same solver on
CPU tensors (the kernels' plain versions): its own prepare, solve and
finish from the same starts, and the finish, with the polish and
without, from the card's solved Y. One JSON line per start with the
success counts

  card_pre, card_post        the card's, before and after the polish;
  cpu_pre, cpu_post          the CPU's own;
  cpu_finish_of_card_pre / _post   the CPU's finish from the card's Y;

then a summary with the means and tools/torch_parity.py's permutation p
of each against the card's post-polish counts. Where the CPU's finish
from the card's Y gives the card's counts, the stages up to the solve
part them; where it gives the CPU's, the finish does. Configs without
restarts and without a CIDGIK path; the CPU half takes ~30 s a start for
planar40's 1000 goals.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SOL_KEYS = ("Y", "cost", "gradnorm", "iterations", "num_inner")
PRE_KEYS = ("q", "e_pos", "e_rot", "limit_violation", "success")  # the finish without the polish


def solvers(ref, dev):
    """The config's solver on `dev`, with the polish and without, and the
    goals as a tensor there."""
    import dataclasses

    import torch

    import torch_parity as tp
    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.robots import library
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import CGParams, TRParams
    from graphik_tpu_torch.utils.environments import table_environment

    cfg = tp.CONFIGS[str(ref["config"])]
    if cfg["restarts"] or "cidgik" in cfg:
        raise SystemExit("single-init Riemannian configs only")
    ps = tp.structure(cfg["robot"], library, ProblemStructure, table_environment,
                      lambda: library.load_tree5()[1])
    kw = tp.solver_kwargs(cfg, TRParams, LocalParams, CGParams)
    if "port_backend" in cfg:
        kw["params"] = dataclasses.replace(kw["params"], backend=cfg["port_backend"])
    dtype = getattr(torch, cfg.get("dtype", "float32"))
    post = api.make_solver(ps, device=dev, dtype=dtype, **kw)
    pre = api.make_solver(ps, device=dev, dtype=dtype, **{**kw, "polish": False})
    return post, pre, torch.as_tensor(ref["T_goal"], dtype=dtype, device=dev)


def starts(ref, K):
    """The JAX half's Y0 and its first K perturbations (numpy)."""
    import torch_parity as tp

    Y0 = np.asarray(ref["Y0"])
    return [Y0 * tp.init_noise(k, Y0.shape[-2:]) for k in range(K)]


def run_card(args):
    import torch

    import torch_parity as tp

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("card_cpu_stages: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = np.load(args.goals)
    post, pre, T = solvers(ref, dev)
    D_goal, _ = post.prepare(T)
    out = {"config": str(ref["config"]), "goals": args.goals, "D_goal": D_goal.cpu().numpy()}
    for k, Yk in enumerate(starts(ref, args.noise)):
        sol = post.solve(torch.as_tensor(Yk, device=dev).contiguous(), D_goal)
        ok_post = tp.ok_of(post.finish(sol, T))
        fin = pre.finish(sol, T)
        ok_pre = tp.ok_of(fin)
        for key in SOL_KEYS:
            out[f"{key}_{k}"] = sol[key].cpu().numpy()
        for key in PRE_KEYS:
            out[f"pre_{key}_{k}"] = fin[key].cpu().numpy()
        out[f"ok_pre_{k}"], out[f"ok_post_{k}"] = ok_pre, ok_post
        print(json.dumps({"k": k, "card_pre": int(ok_pre.sum()), "card_post": int(ok_post.sum())}),
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    np.savez(args.out, K=args.noise, device=name, **out)
    return 0


def finish_diff(ps, card, k, fin, tp):
    """The card's finish without the polish against the CPU's, both from
    the card's Y of start k: lanes whose q is bitwise equal, the largest
    |dq|, and the lanes whose verdict differs (card / CPU successes), by
    the test that parts them: position, rotation, distance limits; and
    each side's successes with the distance limits of its q checked in
    float64 (the realization too), the same tolerance."""
    import torch

    c = {key: np.asarray(card[f"pre_{key}_{k}"]) for key in PRE_KEYS}
    u = {key: fin[key].numpy() for key in PRE_KEYS}
    ok_c, ok_u = (tp.ok_of({key: torch.as_tensor(d[key]) for key in d}) for d in (c, u))
    part = ok_c != ok_u

    def float64_limits(d):
        _, ok = ps.check_distance_limits(ps.realization(torch.as_tensor(d["q"]).double()))
        return int(tp.ok_of({"e_pos": torch.as_tensor(d["e_pos"]),
                             "e_rot": torch.as_tensor(d["e_rot"]), "success": ok}).sum())
    return {"q_lanes_equal": int((c["q"] == u["q"]).all(1).sum()),
            "q_max_abs_diff": float(np.abs(c["q"] - u["q"]).max()),
            "verdicts_differ": int(part.sum()), "card_only": int((ok_c & ~ok_u).sum()),
            "cpu_only": int((ok_u & ~ok_c).sum()),
            "by": {"position": int((part & ((c["e_pos"] < tp.CRIT_POS)
                                            != (u["e_pos"] < tp.CRIT_POS))).sum()),
                   "rotation": int((part & ((c["e_rot"] < tp.CRIT_ROT)
                                            != (u["e_rot"] < tp.CRIT_ROT))).sum()),
                   "limits": int((part & (c["success"] != u["success"])).sum())},
            "limit_violation_max_abs_diff": float(
                np.abs(c["limit_violation"] - u["limit_violation"]).max()),
            "float64_limits": {"card": float64_limits(c), "cpu": float64_limits(u)}}


def run_cpu(args):
    import torch

    import torch_parity as tp

    torch.set_num_threads(max(1, os.cpu_count() // 2))
    card = np.load(args.card)
    ref = np.load(str(card["goals"]))
    post, pre, T = solvers(ref, torch.device("cpu"))
    D_goal, _ = post.prepare(T)
    D_card = torch.as_tensor(card["D_goal"])
    rows = []
    for k, Yk in enumerate(starts(ref, int(card["K"]))):
        t0 = time.perf_counter()
        sol = post.solve(torch.as_tensor(Yk).contiguous(), D_goal)
        sol_card = {key: torch.as_tensor(card[f"{key}_{k}"]) for key in SOL_KEYS}
        fin = pre.finish(sol_card, T)
        row = {"k": k,
               "card_pre": int(card[f"ok_pre_{k}"].sum()),
               "card_post": int(card[f"ok_post_{k}"].sum()),
               "cpu_pre": int(tp.ok_of(pre.finish(sol, T)).sum()),
               "cpu_post": int(tp.ok_of(post.finish(sol, T)).sum()),
               "cpu_finish_of_card_pre": int(tp.ok_of(fin).sum()),
               "cpu_finish_of_card_post": int(tp.ok_of(post.finish(sol_card, T)).sum()),
               "Y_lanes_equal": int((sol["Y"] == sol_card["Y"]).flatten(1).all(1).sum()),
               "iterations_equal": int((sol["iterations"] == sol_card["iterations"]).sum())}
        if f"pre_q_{k}" in card:
            row["pre_finish_of_card_Y"] = finish_diff(post.structure, card, k, fin, tp)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = [key for key in rows[0] if key.startswith(("card", "cpu"))]
    base = [r["card_post"] for r in rows]
    print(json.dumps({
        "config": str(card["config"]), "card": str(card["device"]), "starts": len(rows),
        "D_goal_lanes_equal": int((D_goal == D_card).flatten(1).all(1).sum()),
        "mean": {key: float(np.mean([r[key] for r in rows])) for key in keys},
        "p_against_card_post": {key: tp.permutation_p(base, [r[key] for r in rows])
                                for key in keys if key != "card_post"}}))
    return 0


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="half", required=True)
    pc = sub.add_parser("card", help="solve from the starts on the card and save the stages")
    pc.add_argument("--goals", required=True, help="a parity config's JAX half with its Y0")
    pc.add_argument("--noise", type=int, default=16, help="perturbed starts")
    pc.add_argument("--out", required=True)
    pc.add_argument("--device", default="cuda", help="cpu: check the tool itself")
    pu = sub.add_parser("cpu", help="the same starts on the CPU, and its finish of the card's Y")
    pu.add_argument("--card", required=True, help="the card half's output")
    args = p.parse_args()
    return run_card(args) if args.half == "card" else run_cpu(args)


if __name__ == "__main__":
    sys.exit(main())
