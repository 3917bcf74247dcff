#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths once on one GPU and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an exception):
  0. card name and power limit (nvidia-smi), torch and CUDA versions;
  1. build the CUDA kernels from graphik_tpu_torch/csrc (one nvcc per
     source, sm_90a) and print each kernel's registers, shared memory and
     spills;
  2. the TR kernel (anchor-free) vs its plain torch version on the card,
     UR10, B = 1000 (a ragged last block): one TR step (cost rtol 2e-5 /
     atol 1e-6, Y atol 1e-4, num_inner equal), then the production params
     (all lanes finite, median cost within 10x, mean iterations within 5%);
  3. the UR10 path - api.make_solver on UR10 at B = 8192 with
     TRParams.production(maxiter=100, maxinner=24), a 10-step LM polish and
     2-squaring bound smoothing: one warm call, then 3 timed calls with
     per-stage walls; success >= 0.85 (1 mm / 1 deg, limit-feasible), all
     outputs finite, the kernel launched on every call; plus a 64-goal
     batch on the card against the same solver on the CPU (plain version);
  4. the TR kernel's and its plain version's times at the UR10 path's
     shapes (CUDA events);
  5. the anchored TR kernel vs its plain version on the table scene's
     reduced problem (16 nodes, 624 anchor rows), B = 1000, inputs from
     Solver.prepare: one step bitwise equal (and from world-frame starts,
     where the hinges are active), then maxiter=100, maxinner=32 with the
     plateau stop (all lanes finite, bitwise-equal lanes printed); times;
  6. the table path - make_solver on UR10 + the 100-sphere table at
     B = 8192 with TRParams.production(maxiter=250, maxinner=32): one warm
     call, 3 timed calls with per-stage walls and the prepare stage's peak
     memory; the anchored kernel launched once per call; success >= 0.78
     on each call; every successful lane keeps p1..p6 at least
     radius - 1e-3 from every center; outputs finite, of the right shapes;
     one anchored TR step bitwise equal to the plain version at B = 8192,
     then the kernel's time there; a 64-goal batch on the card against
     the same solver on the CPU;
  7. the edge cost+grad and Hessian kernels vs ops/edge.py's plain
     versions at B = 8192, on the Y the UR10 path hands to the solve and
     a seeded Z: f rtol 1e-5, g and H max abs error <= 1e-4 x max |plain|;
     times.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. Without a CUDA device it exits 2
and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
B_CHECK = 1000
B_MAIN = 8192
B_SMALL = 64
TABLE_SUCCESS_MIN = 0.78  # JAX f32 pipeline: 0.809 [0.796, 0.820] (PARITY.md:27)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.ops._build import library_path, load_library
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda, solve_tr_reference
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import TRParams
    from graphik_tpu_torch.utils.environments import table_environment

    dev = torch.device("cuda:0")
    # f32 means true f32: no TF32 in any matmul of the path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 0: the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[0] card: {smi}")
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    load_library()
    log(f"[1] kernel build+load: {time.perf_counter() - t0:.2f} s -> {library_path()}")
    with open(library_path() + ".log") as f:
        ptxas = f.read()
    # one line per kernel instance: name<template args>, registers, static
    # shared memory, spill stores
    for entry in ptxas.split("Compiling entry function '")[1:]:
        name = re.search(r"([a-z][a-z_]*_kernel)I((?:Li\d+E|Lb\d+E)+)E", entry)
        args = ",".join(re.findall(r"L[ib](\d+)E", name.group(2)))
        regs, smem = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", entry).groups()
        spill = re.search(r"(\d+) bytes spill stores", entry).group(1)
        log(f"[1] ptxas: {name.group(1)}<{args}>: {regs} registers, {smem} B static smem, "
            f"{spill} B spill stores")

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def staged(solver, T_goal):
        """One call of the path, stage by stage: (prepare, solve, finish walls
        in s, peak device memory of prepare in bytes, out)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        D_goal, Y0m = solver.prepare(T_goal)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() - base
        sol = solver.solve(Y0m, D_goal)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = solver.finish(sol, T_goal)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2, peak, out

    tpl, ps = load_ur10()
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    prod = TRParams.production(maxiter=100, maxinner=24)
    polish = LocalParams(maxiter=10, tol_grad=1e-8)
    solver = api.make_solver(ps, params=prod, polish_params=polish, smooth_iters=2)
    tr_kw = dict(maxinner=24, plateau_every=16, plateau_rtol=prod.plateau_rtol)

    def goals(B, device=dev):
        return api.random_goals(ps, (B,), gen, dtype=torch.float32, device=device)[0]

    def kernel_inputs(T_goal):
        D_goal, Y0 = solver.prepare(T_goal)
        return Y0.contiguous(), ep.edge_values(D_goal).contiguous()

    # ---- phase 2: kernel vs plain version on the card ----
    Y0, dg = kernel_inputs(goals(B_CHECK))
    k1 = solve_tr_cuda(ep, Y0, dg, maxiter=1, maxinner=24)
    p1 = solve_tr_reference(ep, Y0, dg, maxiter=1, maxinner=24)
    torch.cuda.synchronize()
    err_y = float((k1["Y"] - p1["Y"]).abs().max())
    err_c = float(((k1["cost"] - p1["cost"]).abs() / (1e-6 + 2e-5 * p1["cost"].abs())).max())
    n_diff = int((k1["num_inner"] != p1["num_inner"]).sum())
    log(f"[2] one step, B={B_CHECK}: max|dY| {err_y:.3e} (tol 1e-4), cost err/tol "
        f"{err_c:.3f} (<= 1), num_inner mismatches {n_diff}")
    check(err_y <= 1e-4 and err_c <= 1.0 and n_diff == 0, "one-step kernel/plain mismatch")

    kp = solve_tr_cuda(ep, Y0, dg, maxiter=100, **tr_kw)
    pp = solve_tr_reference(ep, Y0, dg, maxiter=100, **tr_kw)
    torch.cuda.synchronize()
    for name, out in (("kernel", kp), ("plain", pp)):
        check(all(bool(torch.isfinite(out[k]).all()) for k in ("Y", "cost", "gradnorm")), name)
    same = int((kp["Y"] == pp["Y"]).flatten(1).all(1).sum())
    log(f"[2] production, B={B_CHECK}: lanes whose Y is bitwise equal: {same}/{B_CHECK} "
        "(the plain version sums in the kernel's order)")
    med_k, med_p = float(kp["cost"].median()), float(pp["cost"].median())
    it_k = float(kp["iterations"].double().mean())
    it_p = float(pp["iterations"].double().mean())
    log(f"[2] production, B={B_CHECK}: median cost kernel {med_k:.4e} plain {med_p:.4e}; "
        f"mean iterations kernel {it_k:.3f} plain {it_p:.3f}; mean num_inner kernel "
        f"{float(kp['num_inner'].double().mean()):.2f} plain "
        f"{float(pp['num_inner'].double().mean()):.2f}")
    check(med_k <= 10 * med_p and med_p <= 10 * med_k, "median cost not within 10x")
    check(abs(it_k - it_p) <= 0.05 * it_p, "mean iterations not within 5%")

    # ---- phase 3: the main path ----
    out = solver(goals(B_MAIN))  # warm call
    torch.cuda.synchronize()
    goal_sets = [goals(B_MAIN) for _ in range(3)]
    calls = []
    solve_tr_cuda.launches = solve_tr_cuda.anchored_launches = 0
    for T_goal in goal_sets:
        tp, ts, tf, _, out = staged(solver, T_goal)
        calls.append((tp, ts, tf, api.summarize(out), out))
    launches = solve_tr_cuda.launches
    log(f"[3] kernel launches during the 3 timed main-path calls: {launches} "
        f"(anchored {solve_tr_cuda.anchored_launches})")
    check(launches == 3 and solve_tr_cuda.anchored_launches == 0,
          "the UR10 path did not launch the anchor-free TR kernel once per call")
    shapes = {"q": (B_MAIN, tpl.n), "Y": (B_MAIN, ps.N, ps.dim), "e_pos": (B_MAIN,),
              "e_rot": (B_MAIN,), "cost": (B_MAIN,), "iterations": (B_MAIN,)}
    for i, (tp, ts, tf, summ, o) in enumerate(calls):
        wall = tp + ts + tf
        log(f"[3] call {i}: prepare {tp * 1e3:.1f} ms, solve {ts * 1e3:.1f} ms, finish "
            f"{tf * 1e3:.1f} ms, total {wall * 1e3:.1f} ms, {B_MAIN / wall:.1f} solves/s; "
            f"success {summ['success_rate']:.4f}, median e_pos "
            f"{summ['median_pos_err']:.3e} m, mean iterations {summ['mean_iterations']:.2f}")
        for k, shape in shapes.items():
            check(tuple(o[k].shape) == shape, (k, tuple(o[k].shape)))
            check(bool(torch.isfinite(o[k].double()).all()), f"non-finite {k}")
        check(summ["success_rate"] >= 0.85, "UR10 success below 0.85")
    walls = [sum(c[:3]) for c in calls]
    log(f"[3] mean over the timed calls: {B_MAIN / (sum(walls) / 3):.1f} solves/s")

    # the same solver on a small batch, on the card and on the CPU (plain version)
    T_small = goals(B_SMALL, device=torch.device("cpu"))
    s_gpu = api.summarize(solver(T_small.to(dev)))["success_rate"]
    s_cpu = api.summarize(solver(T_small))["success_rate"]
    log(f"[3] {B_SMALL} goals: success on the card {s_gpu:.4f}, on the CPU {s_cpu:.4f}")
    check(abs(s_gpu - s_cpu) * B_SMALL <= 6, "card and CPU success differ by more than 6 goals")

    # ---- phase 4: kernel vs plain time at the main path's shapes ----
    Y0, dg = kernel_inputs(goals(B_MAIN))
    ms_kernel = event_ms(lambda: solve_tr_cuda(ep, Y0, dg, maxiter=100, **tr_kw), 5)
    ms_plain = event_ms(lambda: solve_tr_reference(ep, Y0, dg, maxiter=100, **tr_kw), 1)
    log(f"[4] TR solve at B={B_MAIN}, production params: kernel {ms_kernel:.3f} ms, "
        f"plain torch {ms_plain:.3f} ms")

    # ---- phase 5: the anchored TR kernel vs its plain version ----
    ps_t = ProblemStructure.from_template(tpl, obstacles=table_environment())
    spec = ps_t.reduced_spec()
    Nr = spec["Nr"]
    om_t, pl_t, pu_t = ps_t.masks()
    ep_t = edge_ops.build_edge_problem(om_t[:Nr, :Nr], pl_t[:Nr, :Nr], pu_t[:Nr, :Nr],
                                       dim=ps_t.dim, anchors=spec)
    table_params = TRParams.production(maxiter=250, maxinner=32)
    solver_t = api.make_solver(ps_t, params=table_params, polish_params=polish, smooth_iters=2)
    log(f"[5] table scene: N = {ps_t.N}, Nr = {Nr}, E = {ep_t.E}, anchor rows A = {ep_t.A} "
        f"({ep_t.a_nsel} groups of {ep_t.a_R})")

    def goals_t(B, device=dev):
        return api.random_goals(ps_t, (B,), gen, dtype=torch.float32, device=device)[0]

    D_t, Y0_t = solver_t.prepare(goals_t(B_CHECK))
    Y0_t, dg_t = Y0_t.contiguous(), ep_t.edge_values(D_t).contiguous()
    # world-frame starts near random configurations: the hinges meet the robot
    Yw_t = ps_t.realization(
        api.random_goals(ps_t, (B_CHECK,), gen, dtype=torch.float32, device=dev)[1]
    )[:, :Nr].contiguous()
    err_a = 0.0
    for name, Ys in (("prepare", Y0_t), ("world-frame", Yw_t)):
        k1 = solve_tr_cuda(ep_t, Ys, dg_t, maxiter=1, maxinner=32)
        p1 = solve_tr_reference(ep_t, Ys, dg_t, maxiter=1, maxinner=32)
        torch.cuda.synchronize()
        e = float((k1["Y"] - p1["Y"]).abs().max())
        nd = int((k1["num_inner"] != p1["num_inner"]).sum())
        same_cost = bool(torch.equal(k1["cost"], p1["cost"]))
        log(f"[5] one step from {name} starts, B={B_CHECK}: max|dY| {e:.3e}, cost bitwise "
            f"equal {same_cost}, num_inner mismatches {nd}")
        check(e == 0.0 and nd == 0 and same_cost, f"anchored one-step mismatch ({name})")
        err_a = max(err_a, e)
    t_kw = dict(maxinner=32, plateau_every=16, plateau_rtol=table_params.plateau_rtol)
    ka = solve_tr_cuda(ep_t, Y0_t, dg_t, maxiter=100, **t_kw)
    # the plain version is launch-bound (tens of seconds): time its one run
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    pa = solve_tr_reference(ep_t, Y0_t, dg_t, maxiter=100, **t_kw)
    end.record()
    torch.cuda.synchronize()
    ms_a_plain = start.elapsed_time(end)
    for name, o in (("kernel", ka), ("plain", pa)):
        check(all(bool(torch.isfinite(o[k]).all()) for k in ("Y", "cost", "gradnorm")),
              f"anchored {name}: non-finite lanes")
    same_a = int((ka["Y"] == pa["Y"]).flatten(1).all(1).sum())
    log(f"[5] maxiter=100, maxinner=32, plateau stop, B={B_CHECK}: lanes whose Y is bitwise "
        f"equal: {same_a}/{B_CHECK}; mean iterations kernel "
        f"{float(ka['iterations'].double().mean()):.3f} plain "
        f"{float(pa['iterations'].double().mean()):.3f}")
    ms_a_kernel = event_ms(lambda: solve_tr_cuda(ep_t, Y0_t, dg_t, maxiter=100, **t_kw), 5)
    log(f"[5] anchored TR at B={B_CHECK}, maxiter=100: kernel {ms_a_kernel:.3f} ms, plain "
        f"torch {ms_a_plain:.3f} ms")

    # ---- phase 6: the table path ----
    out_t = solver_t(goals_t(B_MAIN))  # warm call
    torch.cuda.synchronize()
    goal_sets = [goals_t(B_MAIN) for _ in range(3)]
    calls_t = []
    solve_tr_cuda.launches = solve_tr_cuda.anchored_launches = 0
    for T_goal in goal_sets:
        tp, ts, tf, peak, o = staged(solver_t, T_goal)
        calls_t.append((tp, ts, tf, peak, api.summarize(o), o))
    launches_a = solve_tr_cuda.anchored_launches
    log(f"[6] TR kernel launches during the 3 timed table-path calls: "
        f"{solve_tr_cuda.launches}, anchored {launches_a}")
    check(launches_a == 3 and solve_tr_cuda.launches == 3,
          "the table path did not launch the anchored TR kernel once per call")
    centers = torch.tensor(np.stack([c for c, _ in ps_t.obstacles]), dtype=torch.float32,
                           device=dev)
    radii = torch.tensor([r for _, r in ps_t.obstacles], dtype=torch.float32, device=dev)
    shapes_t = {"q": (B_MAIN, tpl.n), "Y": (B_MAIN, ps_t.N, 3), "e_pos": (B_MAIN,),
                "e_rot": (B_MAIN,), "cost": (B_MAIN,), "iterations": (B_MAIN,)}
    for i, (tp, ts, tf, peak, summ, o) in enumerate(calls_t):
        wall = tp + ts + tf
        log(f"[6] call {i}: prepare {tp * 1e3:.1f} ms (peak {peak / 2**20:.1f} MiB), solve "
            f"{ts * 1e3:.1f} ms, finish {tf * 1e3:.1f} ms, total {wall * 1e3:.1f} ms, "
            f"{B_MAIN / wall:.1f} solves/s; success {summ['success_rate']:.4f}, pose only "
            f"{summ['pose_only_rate']:.4f}, median e_pos {summ['median_pos_err']:.3e} m, mean "
            f"iterations {summ['mean_iterations']:.2f}, p90 {summ['p90_iterations']:.0f}")
        for k, shape in shapes_t.items():
            check(tuple(o[k].shape) == shape, (k, tuple(o[k].shape)))
            check(bool(torch.isfinite(o[k].double()).all()), f"non-finite {k}")
        check(summ["success_rate"] >= TABLE_SUCCESS_MIN,
              f"table success below {TABLE_SUCCESS_MIN}")
        p = ps_t.realization(o["q"])[:, 1:tpl.n + 1]  # (B, n, 3)
        clear = torch.linalg.norm(p[:, :, None, :] - centers, dim=-1) - radii  # (B, n, n_obs)
        worst = float(clear[o["success"]].min())
        log(f"[6] call {i}: least clearance over successful lanes {worst:.3e} m (>= -1e-3)")
        check(worst >= -1e-3, "a successful lane enters an obstacle")
    walls_t = [sum(c[:3]) for c in calls_t]
    log(f"[6] mean over the timed calls: {B_MAIN / (sum(walls_t) / 3):.1f} solves/s")
    D_m, Y0_m = solver_t.prepare(goal_sets[-1])
    Y0_m, dg_m = Y0_m.contiguous(), ep_t.edge_values(D_m).contiguous()
    # one step at the table path's own shapes, against the plain version
    k1 = solve_tr_cuda(ep_t, Y0_m, dg_m, maxiter=1, maxinner=32)
    p1 = solve_tr_reference(ep_t, Y0_m, dg_m, maxiter=1, maxinner=32)
    torch.cuda.synchronize()
    e = float((k1["Y"] - p1["Y"]).abs().max())
    nd = int((k1["num_inner"] != p1["num_inner"]).sum())
    log(f"[6] anchored one step at B={B_MAIN}: max|dY| {e:.3e}, num_inner mismatches {nd}")
    check(e == 0.0 and nd == 0, "anchored one-step mismatch at the table path's shapes")
    err_a = max(err_a, e)
    ms_a_main = event_ms(lambda: solve_tr_cuda(ep_t, Y0_m, dg_m, maxiter=250, **t_kw), 3)
    log(f"[6] anchored TR kernel at the table path's shapes (B={B_MAIN}, maxiter=250, "
        f"maxinner=32): {ms_a_main:.3f} ms")

    T_small = goals_t(B_SMALL, device=torch.device("cpu"))
    s_gpu = api.summarize(solver_t(T_small.to(dev)))["success_rate"]
    s_cpu = api.summarize(solver_t(T_small))["success_rate"]
    log(f"[6] {B_SMALL} table goals: success on the card {s_gpu:.4f}, on the CPU {s_cpu:.4f}")
    check(abs(s_gpu - s_cpu) * B_SMALL <= 6, "card and CPU success differ by more than 6 goals")

    # ---- phase 7: the edge cost+grad and Hessian kernels ----
    # On the Y the UR10 path hands to the solve (prepare's Y0, cost O(1)).
    # At the Y it returns the cost is ~1e-7, a sum of squared differences
    # of O(1) squared lengths: f32 cancellation there puts any two
    # summation orders ~1e-2 apart in f and ~1e-5 apart in g, whatever
    # the kernel does, so a relative tolerance says nothing at that point.
    Z = torch.randn(Y0.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
    edge_ops.cost_and_egrad_cuda.launches = edge_ops.ehess_cuda.launches = 0
    f_k, g_k = edge_ops.cost_and_egrad_cuda(ep, Y0, dg)
    h_k = edge_ops.ehess_cuda(ep, Y0, Z, dg)
    launches_cg, launches_h = edge_ops.cost_and_egrad_cuda.launches, edge_ops.ehess_cuda.launches
    check(launches_cg == 1 and launches_h == 1, "the edge entry points did not launch")
    f_p, g_p = edge_ops.cost_and_egrad(ep, Y0, dg)
    h_p = edge_ops.ehess(ep, Y0, Z, dg)
    torch.cuda.synchronize()
    f_rel = float(((f_k - f_p).abs() / f_p.abs().clamp(min=1e-30)).max())
    err_g, err_h = float((g_k - g_p).abs().max()), float((h_k - h_p).abs().max())
    g_scale, h_scale = float(g_p.abs().max()), float(h_p.abs().max())
    log(f"[7] B={B_MAIN}: f max rel err {f_rel:.3e} (<= 1e-5), g max abs err {err_g:.3e} "
        f"(<= 1e-4 x {g_scale:.3e}), H max abs err {err_h:.3e} (<= 1e-4 x {h_scale:.3e})")
    check(f_rel <= 1e-5, "edge cost mismatch")
    check(err_g <= 1e-4 * g_scale and err_h <= 1e-4 * h_scale, "edge gradient/Hessian mismatch")
    ms_cg = event_ms(lambda: edge_ops.cost_and_egrad_cuda(ep, Y0, dg), 20)
    ms_cg_p = event_ms(lambda: edge_ops.cost_and_egrad(ep, Y0, dg), 20)
    ms_h = event_ms(lambda: edge_ops.ehess_cuda(ep, Y0, Z, dg), 20)
    ms_h_p = event_ms(lambda: edge_ops.ehess(ep, Y0, Z, dg), 20)
    log(f"[7] cost+grad: kernel {ms_cg:.4f} ms, plain {ms_cg_p:.4f} ms; Hessian: kernel "
        f"{ms_h:.4f} ms, plain {ms_h_p:.4f} ms")

    record = {"kernels": [
        {"name": "tr_solve", "route": "cuda", "source": "graphik_tpu_torch/csrc/tr_solve.cu",
         "replaces": "graphik_tpu/ops/tr_pallas.py:59", "launches": launches,
         "max_abs_err": err_y, "ms": ms_kernel, "plain_ms": ms_plain,
         "at": f"UR10, B={B_MAIN}, maxiter=100, maxinner=24"},
        {"name": "tr_solve_anchored", "route": "cuda",
         "source": "graphik_tpu_torch/csrc/tr_solve.cu",
         "replaces": "graphik_tpu/ops/tr_pallas.py:77", "launches": launches_a,
         "max_abs_err": err_a, "ms": ms_a_kernel, "plain_ms": ms_a_plain,
         "at": f"table, B={B_CHECK}, maxiter=100, maxinner=32",
         "ms_table_path": ms_a_main},
        {"name": "edge_cost_grad", "route": "cuda", "source": "graphik_tpu_torch/csrc/edge.cu",
         "replaces": "graphik_tpu/ops/edge.py:302", "launches": launches_cg,
         "max_abs_err": err_g, "ms": ms_cg, "plain_ms": ms_cg_p, "at": f"UR10, B={B_MAIN}"},
        {"name": "edge_hess", "route": "cuda", "source": "graphik_tpu_torch/csrc/edge.cu",
         "replaces": "graphik_tpu/ops/edge.py:325", "launches": launches_h,
         "max_abs_err": err_h, "ms": ms_h, "plain_ms": ms_h_p, "at": f"UR10, B={B_MAIN}"},
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
