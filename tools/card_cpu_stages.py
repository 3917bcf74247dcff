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
import contextlib
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



# the op kinds of the planar finish before the polish whose rounding comes
# from libm (sin, cos, atan2), not from the port's choice of arithmetic
LIBM_KINDS = ("rigid_angle", "rigid_R", "angle", "rot2", "fk_exp", "pose_e_rot")


def planar_steps(ps, limit_tol=1e-6):
    """The finish of a planar robot before the polish, op by op, as the port
    computes it (problem.py `_joint_variables_planar` with
    dgp.best_fit_transform, kinematics.prefix_products / all_poses,
    ProblemStructure.realization and check_distance_limits, api.pose_error):
    a list of (kind, key, fn, args), each step's output values[key] =
    fn(*values[args]) from the goals' positions "Y" and poses "T_goal".
    `chain` checks on every run that its q, limit violation and pose errors
    are the package's own, bit for bit."""
    import torch

    from graphik_tpu_torch.robots import kinematics
    from graphik_tpu_torch.utils import dgp, lie
    from graphik_tpu_torch.utils.compiled import device_const

    tpl = ps.template
    n = tpl.n
    steps = []

    def step(kind, key, fn, *args):
        steps.append((kind, key, fn, args))

    def const(key, value, like):
        return device_const(ps, ("card_cpu_stages", key), value, like.dtype, like.device)

    canon_np = [[0.0, 0.0], [-1.0, 0.0], [0.0, 1.0]]

    def src(Y):
        return torch.stack([Y[..., 0, :], Y[..., ps.idx_x, :], Y[..., ps.idx_y, :]], dim=-2)

    def cross_cov(Y, ca):
        canon = const("canon", canon_np, Y)
        return lie.matmul_small((src(Y) - ca).transpose(-1, -2),
                                canon - lie.mean_small(canon, -2, keepdim=True))

    def rotating(H):
        return H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0] >= 0

    def angle(H):
        h00, h01, h10, h11 = H[..., 0, 0], H[..., 0, 1], H[..., 1, 0], H[..., 1, 1]
        return torch.where(rotating(H), lie.atan2_rn(h01 - h10, h00 + h11),
                           lie.atan2_rn(h01 + h10, h00 - h11))

    def rotation(ang, H):
        rot = rotating(H)
        c, s = lie.cos_rn(ang), lie.sin_rn(ang)
        return torch.stack([torch.stack([c, torch.where(rot, -s, s)], dim=-1),
                            torch.stack([s, torch.where(rot, c, -c)], dim=-1)], dim=-2)

    step("rigid_mean", "ca", lambda Y: lie.mean_small(src(Y), -2, keepdim=True), "Y")
    step("rigid_H", "H", cross_cov, "Y", "ca")
    step("rigid_angle", "ang", angle, "H")
    step("rigid_R", "R", rotation, "ang", "H")
    step("exact", "Racc0", lambda Y: torch.eye(2, dtype=Y.dtype, device=Y.device).expand(
        Y.shape[:-2] + (2, 2)), "Y")
    for k in range(1, n + 1):
        u = int(tpl.parents[k])
        step("link_diff", f"diff{k}",
             lambda R, Y, k=k, u=u: lie.matvec_small(R, Y[..., k, :] - Y[..., u, :]), "R", "Y")
        step("link_dir", f"dir{k}", lambda d: d / lie.norm_small(d, keepdim=True), f"diff{k}")
        step("link_sol", f"sol{k}", lambda Ra, d: lie.matvec_small(Ra.transpose(-1, -2), d),
             f"Racc{u}", f"dir{k}")
        step("angle", f"th{k}", lambda s: lie.wraptopi(lie.atan2_rn(s[..., 1], s[..., 0])),
             f"sol{k}")
        step("rot2", f"rot{k}", lie.rot2, f"th{k}")
        step("rot_acc", f"Racc{k}", lie.matmul_small, f"Racc{u}", f"rot{k}")
    step("exact", "q", lambda *th: torch.stack(th, dim=-1), *[f"th{k}" for k in range(1, n + 1)])

    step("exact", "A0", lambda q: const("T0", tpl.T0, q)[0].expand(q.shape[:-1] + (3, 3)), "q")
    for i in range(1, n + 1):
        p = int(tpl.parents[i])
        step("fk_twist", f"xi{i}", lambda q, i=i, p=p: const("S", tpl.S, q)[p] * q[..., i - 1, None],
             "q")
        step("fk_exp", f"exp{i}", lambda xi: kinematics._exp(tpl, xi), f"xi{i}")
        step("fk_prefix", f"A{i}", lie.matmul_small, f"A{p}", f"exp{i}")
    step("fk_poses", "T", lambda *A: lie.matmul_small(torch.stack(A, dim=-3),
                                                       const("T0", tpl.T0, A[0])),
         *[f"A{i}" for i in range(n + 1)])
    step("exact", "pos", lambda T: torch.cat([T[..., :2, 2], const("fixed", ps.pos_fixed, T)
                                              .expand(T.shape[:-3] + (ps.N, 2))[..., n + 1:, :]],
                                             dim=-2), "T")
    ii, jj = np.nonzero(ps.bounded_mask)
    def distances(pos):
        pairs = device_const(ps, "bounded_pairs", np.stack([ii, jj]), device=pos.device)
        return dgp.pair_distances(pos, pairs[0], pairs[1])

    step("distance", "D", distances, "pos")
    step("distance_sqrt", "Dr", lambda D: lie.sqrt_rn(torch.clamp(D, min=0.0)), "D")

    def violation(Dr):
        return torch.amax(torch.maximum((const("cL", ps.check_L[ii, jj], Dr) - limit_tol) - Dr,
                                        Dr - (const("cU", ps.check_U[ii, jj], Dr) + limit_tol)),
                          dim=-1)

    step("max_viol", "viol", violation, "Dr")
    ee = int(tpl.ee[0])

    def goal(Tg, like):
        Tg = Tg.to(like.dtype)
        return Tg[..., 0, :, :] if Tg.ndim == like.ndim else Tg

    step("pose_e_pos", "e_pos", lambda T, Tg: lie.norm_small(
        goal(Tg, T)[..., :2, 2] - T[..., ee, :2, 2]), "T", "T_goal")
    step("pose_R_rel", "R_rel", lambda T, Tg: lie.matmul_small(
        goal(Tg, T)[..., :2, :2], T[..., ee, :2, :2].transpose(-1, -2)), "T", "T_goal")
    step("pose_e_rot", "e_rot", lambda R: lie.atan2_rn(R[..., 1, 0], R[..., 0, 0]).abs(), "R_rel")
    return steps


def chain(ps, steps, Y, T_goal, on_card=(), dev=None):
    """values of every step from Y and T_goal on their device (the CPU),
    but the steps of the kinds in `on_card`, which take their inputs to
    `dev`, run there, and bring their outputs back. With every step on the
    CPU the result is checked against the package's own functions, bit for
    bit."""
    from graphik_tpu_torch import api

    values = {"Y": Y, "T_goal": T_goal}
    for kind, key, fn, args in steps:
        if kind in on_card:
            values[key] = fn(*[values[a].to(dev) for a in args]).to(Y.device)
        else:
            values[key] = fn(*[values[a] for a in args])
    if not on_card:
        q = ps.joint_variables(Y, T_goal)
        viol, _ = ps.check_distance_limits(ps.realization(q))
        e_pos, e_rot = api.pose_error(ps, q, T_goal)
        for key, ref in (("q", q), ("viol", viol), ("e_pos", e_pos), ("e_rot", e_rot)):
            if not bitwise(values[key], ref):
                raise RuntimeError(f"the staged finish's {key} is not the package's on "
                                   f"{Y.device}: update planar_steps")
    return values


def bitwise(a, b):
    """Whether a and b hold the same values, NaN where the other has NaN."""
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)))


def verdict(values):
    """Success at 1 mm / 1 degree within the distance limits
    (tools/torch_parity.py's criteria)."""
    import torch_parity as tp

    return (values["e_pos"] < tp.CRIT_POS) & (values["e_rot"] < tp.CRIT_ROT) & (values["viol"] <= 0)


def op_table(ps, steps, card, Y, T_goal, dev):
    """For each op kind: the share of its output entries that the CPU
    recomputes bit for bit from the card's own inputs to each of its steps,
    the goals with any entry that differs, and the verdicts that change when
    that kind alone runs on the card (`dev`) in the CPU's chain from the
    card's Y; then the verdicts changed by the libm kinds together, by the
    others together, and by every kind (the card's own chain)."""
    import torch

    ok_base = verdict(chain(ps, steps, Y, T_goal))
    kinds = list(dict.fromkeys(k for k, _, _, _ in steps if k != "exact"))

    def moved(on_card):
        return int((verdict(chain(ps, steps, Y, T_goal, set(on_card), dev)) != ok_base).sum())

    rows = {}
    for kind in kinds:
        equal = total = 0
        goals = torch.zeros(Y.shape[0], dtype=torch.bool)
        for knd, key, fn, args in steps:
            if knd != kind:
                continue
            out = fn(*[card[a] for a in args])
            same = (out == card[key]) | (torch.isnan(out) & torch.isnan(card[key]))
            equal += int(same.sum())
            total += same.numel()
            goals |= ~same.reshape(Y.shape[0], -1).all(dim=1)
        rows[kind] = {"entries_equal": equal / total, "goals_differ": int(goals.sum()),
                      "verdicts_moved": moved([kind]), "libm": kind in LIBM_KINDS}
    ok_card = verdict(card)
    return rows, {"cpu_pre": int(ok_base.sum()), "card_pre": int(ok_card.sum()),
                  "verdicts_differ": int((ok_card != ok_base).sum()),
                  "moved_by_libm_kinds": moved(k for k in kinds if k in LIBM_KINDS),
                  "moved_by_other_kinds": moved(k for k in kinds if k not in LIBM_KINDS),
                  "moved_by_every_kind": moved(kinds)}


def run_ops(args):
    """Card and CPU in one process: the solve from each start on the card,
    the staged finish of its Y on the card, then on the CPU (this machine's
    torch) the op table of each start (`op_table`), and the counts after the
    polish of the card's finish and of the CPU's from the card's Y."""
    import torch

    import torch_parity as tp

    if not torch.cuda.is_available():
        print("card_cpu_stages: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    ref = np.load(args.goals)
    dev = torch.device("cuda")
    post, pre, T = solvers(ref, dev)
    ps = post.structure
    if ps.dim != 2:
        raise SystemExit("the op table takes planar robots")
    steps = planar_steps(ps, post.limit_tol)
    D_goal, _ = post.prepare(T)
    rows = []
    for k, Yk in enumerate(starts(ref, args.noise)):
        t0 = time.perf_counter()
        sol = post.solve(torch.as_tensor(Yk, device=dev).contiguous(), D_goal)
        Y = sol["Y"]
        card = chain(ps, steps, Y, T)
        fin = pre.finish(sol, T)
        if not bitwise(fin["q"], card["q"]):
            raise RuntimeError("the compiled finish's q is not the staged finish's")
        card = {key: v.cpu() for key, v in card.items()}
        sol_cpu = {key: v.cpu() for key, v in sol.items()}
        table, counts = op_table(ps, steps, card, card["Y"], T.cpu(), dev)
        counts["card_post"] = int(tp.ok_of(post.finish(sol, T)).sum())
        counts["cpu_post_of_card_Y"] = int(tp.ok_of(post.finish(sol_cpu, T.cpu())).sum())
        row = {"k": k, **counts, "ops": table, "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    kinds = list(rows[0]["ops"])
    summary = {
        "config": str(ref["config"]), "card": torch.cuda.get_device_name(dev),
        "torch": torch.__version__, "starts": len(rows),
        **{key: [r[key] for r in rows] for key in rows[0] if key not in ("k", "ops", "seconds")},
        "ops": {kind: {"entries_equal_mean": float(np.mean([r["ops"][kind]["entries_equal"]
                                                             for r in rows])),
                       "goals_differ": [r["ops"][kind]["goals_differ"] for r in rows],
                       "verdicts_moved": [r["ops"][kind]["verdicts_moved"] for r in rows],
                       "libm": kind in LIBM_KINDS} for kind in kinds}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f)
    print(json.dumps(summary))
    return 0


# the LM's arithmetic in the forms the port had before its finish took one
# rounding (utils/lie.py's helpers), by group: small products by `@`
# (cuBLAS on a card) or as products summed by torch; torch's norms and
# means; torch's float32 sqrt, sin, cos and atan2 (libm on either device)
def _parent_forms():
    import torch

    return {
        "products_gemm": {"matmul_small": torch.matmul,
                          "matvec_small": lambda a, v: (a @ v[..., None])[..., 0],
                          "dot_small": lambda a, b: (a * b).sum(-1)},
        "products_sum": {"matmul_small": lambda a, b: (a[..., :, :, None]
                                                       * b[..., None, :, :]).sum(-2),
                         "matvec_small": lambda a, v: (a * v[..., None, :]).sum(-1),
                         "dot_small": lambda a, b: (a * b).sum(-1)},
        "norms": {"norm_small": lambda v, keepdim=False: torch.linalg.norm(
                      v, dim=-1, keepdim=keepdim),
                  "mean_small": lambda x, dim, keepdim=False: x.mean(dim=dim, keepdim=keepdim)},
        "libm": {"sqrt_rn": torch.sqrt, "sin_rn": torch.sin, "cos_rn": torch.cos,
                 "atan2_rn": torch.atan2},
        "torch_sqrt": {"sqrt_rn": torch.sqrt},
    }


# the variants of the polish's table: the package as it is, each group alone
# in its earlier form, every group at once (products by `@`, as most of the
# LM's were), and torch's own sqrt in place of lie.sqrt_rn ("torch_sqrt":
# the pivot of ops/linalg.py spd_solve_reference, the CPU's solve, took it
# before; on a card torch's sqrt is correctly rounded, as sqrt_rn and K6's
# are, on the CPU not)
LM_VARIANTS = {"helpers": (), "products_gemm": ("products_gemm",),
               "products_sum": ("products_sum",), "norms": ("norms",), "libm": ("libm",),
               "parent": ("products_gemm", "norms", "libm"), "torch_sqrt": ("torch_sqrt",)}


@contextlib.contextmanager
def lm_forms(groups):
    """Within the block, every call of solvers/local.py solve_local (the LM
    polish, called by api.polish_solution) runs with utils/lie.py's helpers
    of `groups` replaced by their earlier forms (_parent_forms); the finish
    before the polish and its checks keep the helpers."""
    from graphik_tpu_torch.solvers import local
    from graphik_tpu_torch.utils import lie

    forms = {name: fn for g in groups for name, fn in _parent_forms()[g].items()}
    real = local.solve_local

    def swapped(*args, **kwargs):
        saved = {name: getattr(lie, name) for name in forms}
        for name, fn in forms.items():
            setattr(lie, name, fn)
        try:
            return real(*args, **kwargs)
        finally:
            for name, fn in saved.items():
                setattr(lie, name, fn)

    local.solve_local = swapped
    try:
        yield
    finally:
        local.solve_local = real


def run_polish(args):
    """Card and CPU in one process: from each start, the solve on the card,
    then the finish with the polish (eager) of the card's Y on the card and
    on the CPU, for each variant of the LM's arithmetic (LM_VARIANTS). The
    finish before the polish gives the same bits on both, so whatever parts
    them is the polish. Per start and variant: the goals whose q after the
    polish differs in any bit, the verdicts (1 mm, 1 degree, the limits)
    that differ between card and CPU, each side's successes, and the CPU's
    verdicts that the variant moves from the package's own ("helpers")."""
    import torch

    import torch_parity as tp

    if not torch.cuda.is_available():
        print("card_cpu_stages: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    ref = np.load(args.goals)
    dev = torch.device("cuda")
    post, _, T = solvers(ref, dev)
    D_goal, Y0 = post.prepare(T)
    T = post.goals(T)  # as Solver.finish hands _finish its goals
    T_cpu = T.cpu()
    ys = ([torch.as_tensor(Yk, device=dev).contiguous() for Yk in starts(ref, args.noise)]
          if "Y0" in ref else [Y0])
    rows = []
    for k, Yk in enumerate(ys):
        sol = post.solve(Yk, D_goal)
        sol_cpu = {key: v.cpu() for key, v in sol.items()}
        row, base = {"k": k}, None
        for name, groups in LM_VARIANTS.items():
            with lm_forms(groups):
                card = {key: v.cpu() for key, v in post._finish(sol, T).items()}
                cpu = post._finish(sol_cpu, T_cpu)
            ok_card, ok_cpu = tp.ok_of(card), tp.ok_of(cpu)
            base = ok_cpu if base is None else base
            row[name] = {"q_goals_differ": int((card["q"] != cpu["q"]).any(-1).sum()),
                         "verdicts_differ": int((ok_card != ok_cpu).sum()),
                         "card": int(ok_card.sum()), "cpu": int(ok_cpu.sum()),
                         "cpu_moved_from_helpers": int((ok_cpu != base).sum())}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"config": str(ref["config"]), "card": torch.cuda.get_device_name(dev),
               "torch": torch.__version__, "starts": len(rows),
               **{name: {key: [r[name][key] for r in rows] for key in rows[0][name]}
                  for name in LM_VARIANTS}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f)
    print(json.dumps(summary))
    return 0


def primitive_cases(B, seed=0):
    """(name, fn, inputs) of the finish's elementary operations at its
    shapes, on seeded float32 inputs (float64 where the name says so)."""
    import torch

    from graphik_tpu_torch.utils import lie

    rs = np.random.RandomState(seed)

    def x(*shape, dtype=torch.float32):
        return torch.as_tensor(rs.normal(size=(B,) + shape), dtype=dtype)

    cases = [("mean over 3 points", lambda a: a.mean(dim=-2), (x(3, 2),)),
             ("mean_small over 3 points", lambda a: lie.mean_small(a, -2), (x(3, 2),)),
             ("sum over 3 points / 3", lambda a: a.sum(dim=-2) / 3, (x(3, 2),)),
             ("norm of 2-vectors", lambda a: torch.linalg.norm(a, dim=-1), (x(43, 2),)),
             ("norm of 3-vectors", lambda a: torch.linalg.norm(a, dim=-1), (x(16, 3),)),
             ("norm_small of 2-vectors", lie.norm_small, (x(43, 2),)),
             ("norm_small of 3-vectors", lie.norm_small, (x(16, 3),)),
             ("sqrt_rn", lambda a: lie.sqrt_rn(a.abs()), (x(64),)),
             ("sin", torch.sin, (x(64),)), ("cos", torch.cos, (x(64),)),
             ("atan2", torch.atan2, (x(64), x(64))),
             ("sqrt", lambda a: torch.sqrt(a.abs()), (x(64),)),
             ("division", torch.div, (x(64), x(64))),
             ("wraptopi", lie.wraptopi, (4 * x(64),)),
             ("amax of 43 x 43", lambda a: a.amax(dim=(-2, -1)), (x(43, 43),)),
             ("addcmul", torch.addcmul, (x(64), x(64), x(64))),
             ("addcmul float64", torch.addcmul, (x(64, dtype=torch.float64),
                                                 x(64, dtype=torch.float64),
                                                 x(64, dtype=torch.float64)))]
    for k in (2, 3, 4):
        cases.append((f"matvec_small {k}", lie.matvec_small, (x(k, k), x(k))))
    shapes = [("2x2 @ 2x2", (2, 2), (2, 2)), ("3x3 @ 3x3", (3, 3), (3, 3)),
              ("4x4 @ 4x4", (4, 4), (4, 4)), ("2x3 @ 3x2", (2, 3), (3, 2)),
              ("6x6 @ 6x6", (6, 6), (6, 6)), ("40x3 @ 3x40 (J^T J)", (40, 3), (3, 40)),
              ("6x6 @ 6x6 (J^T J of UR10)", (6, 6), (6, 6))]
    for name, sa, sb in shapes:
        a, b = x(*sa), x(*sb)
        cases += [(f"@ {name}", torch.matmul, (a, b)),
                  (f"matmul_small {name}", lie.matmul_small, (a, b))]
    for n, d in ((43, 2), (16, 3), (42, 3)):
        Y = x(n, d)
        cases += [(f"@ Gram {n}x{d}", lambda Y: Y @ Y.transpose(-1, -2), (Y,)),
                  (f"matmul_small Gram {n}x{d}",
                   lambda Y: lie.matmul_small(Y, Y.transpose(-1, -2)), (Y,))]
    a, b = x(4, 4, dtype=torch.float64), x(4, 4, dtype=torch.float64)
    cases += [("@ 4x4 @ 4x4 float64", torch.matmul, (a, b)),
              ("matmul_small 4x4 @ 4x4 float64", lie.matmul_small, (a, b))]
    return cases


def run_primitives(args):
    """Each elementary operation of the finish on the card and on this
    machine's CPU from the same seeded inputs: the share of bitwise-equal
    output entries; and the card's float32 addcmul against a * b + c taken
    in float64 and rounded once to float32 (a fused multiply-add rounds
    once too, and they differ only where the float64 sum lies within
    float64 rounding of a float32 midpoint)."""
    import torch

    if not torch.cuda.is_available():
        print("card_cpu_stages: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows = {}
    for name, fn, inputs in primitive_cases(args.batch):
        out_c = fn(*inputs)
        out_g = fn(*[t.to(dev) for t in inputs]).cpu()
        same = (out_c == out_g) | (torch.isnan(out_c) & torch.isnan(out_g))
        rows[name] = float(same.double().mean())
        print(f"{name}: card == CPU on {rows[name]:.6f} of {same.numel()} entries", flush=True)
    a, b, c = (torch.as_tensor(np.random.RandomState(1).normal(size=2 ** 22), dtype=torch.float32,
                               device=dev) for _ in range(3))
    fused = torch.addcmul(c, a, b)
    emulated = (a.double() * b.double() + c.double()).float()
    rows["card addcmul == float64-emulated FMA"] = float((fused == emulated).double().mean())
    rows["card addcmul == a * b + c"] = float((fused == a * b + c).double().mean())
    print(json.dumps({"card": torch.cuda.get_device_name(dev), "torch": torch.__version__,
                      "batch": args.batch, "equal": rows}))
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
    po = sub.add_parser("ops", help="the op table of the finish before the polish, card and "
                                    "CPU in one process (planar robots)")
    po.add_argument("--goals", required=True, help="a parity config's JAX half with its Y0")
    po.add_argument("--noise", type=int, default=4, help="perturbed starts")
    po.add_argument("--out", default=None, help="the summary as JSON")
    pl = sub.add_parser("polish", help="the polish's table: card against CPU after the polish "
                                       "for each form of the LM's arithmetic")
    pl.add_argument("--goals", required=True, help="a parity config's JAX half (its Y0 if any)")
    pl.add_argument("--noise", type=int, default=4, help="perturbed starts (with a Y0)")
    pl.add_argument("--out", default=None, help="the summary as JSON")
    pp = sub.add_parser("primitives", help="each elementary op of the finish, card and CPU")
    pp.add_argument("--batch", type=int, default=8192)
    args = p.parse_args()
    return {"card": run_card, "cpu": run_cpu, "ops": run_ops, "polish": run_polish,
            "primitives": run_primitives}[args.half](args)


if __name__ == "__main__":
    sys.exit(main())
