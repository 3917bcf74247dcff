#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check its kernel.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an exception):
  0. card name and power limit (nvidia-smi), torch and CUDA versions;
  1. build the CUDA kernel from graphik_tpu_torch/csrc (nvcc, sm_90a);
  2. kernel vs its plain torch version on the card, UR10, B = 1000 (a
     ragged last block): one TR step (cost rtol 2e-5 / atol 1e-6, Y atol
     1e-4, num_inner equal), then the production params (all lanes finite,
     median cost within 10x, mean iterations within 5%);
  3. the main path - api.make_solver on UR10 at B = 8192 with
     TRParams.production(maxiter=100, maxinner=24), a 10-step LM polish and
     2-squaring bound smoothing: one warm call, then 3 timed calls with
     per-stage walls; success >= 0.85 (1 mm / 1 deg, limit-feasible), all
     outputs finite, the kernel launched on every call; plus a 64-goal
     batch on the card against the same solver on the CPU (plain version);
  4. kernel and plain-version times at the main path's shapes (CUDA events).

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. Without a CUDA device it exits 2
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
B_CHECK = 1000
B_MAIN = 8192
B_SMALL = 64


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from graphik_tpu_torch import api
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.ops._build import library_path, load_library
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda, solve_tr_reference
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import TRParams

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
        for line in f:
            if any(w in line for w in ("entry function", "registers", "spill")):
                log(f"[1] ptxas: {line.strip()}")

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
    calls = []
    solve_tr_cuda.launches = 0
    for _ in range(3):
        T_goal = goals(B_MAIN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D_goal, Y0m = solver.prepare(T_goal)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sol = solver.solve(Y0m, D_goal)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = solver.finish(sol, T_goal)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        calls.append((t1 - t0, t2 - t1, t3 - t2, api.summarize(out), out))
    launches = solve_tr_cuda.launches
    log(f"[3] kernel launches during the 3 timed main-path calls: {launches}")
    check(launches == 3, "the main path did not launch the TR kernel once per call")
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

    ms_kernel = event_ms(lambda: solve_tr_cuda(ep, Y0, dg, maxiter=100, **tr_kw), 5)
    ms_plain = event_ms(lambda: solve_tr_reference(ep, Y0, dg, maxiter=100, **tr_kw), 1)
    log(f"[4] TR solve at B={B_MAIN}, production params: kernel {ms_kernel:.3f} ms, "
        f"plain torch {ms_plain:.3f} ms")

    record = {"kernels": [{
        "name": "tr_solve",
        "route": "cuda",
        "source": "graphik_tpu_torch/csrc/tr_solve.cu",
        "replaces": "graphik_tpu/ops/tr_pallas.py:59",
        "launches": launches,
        "max_abs_err": err_y,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}
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
