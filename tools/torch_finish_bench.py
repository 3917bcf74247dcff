#!/usr/bin/env python3
"""Time the port's finish stage (joint recovery, FK validation, pose error,
the LM polish and keep-the-better: api.Solver.finish) from one or more
source trees on the same inputs, in turns, on one GPU.

    python3 tools/torch_finish_bench.py --tree parent=build/dev/parent --tree change=.

A tree is a directory that holds a `graphik_tpu_torch` package and the
robot specs it reads (for example the parent commit's, unpacked with
`git archive HEAD graphik_tpu_torch graphik_tpu/robots/specs | tar -x -C
build/dev/parent`); `--lm-parent LABEL=PATH` adds a tree whose LM polish
runs with utils/lie.py's helpers in their earlier forms (small products by
`@`, torch's norms, libm's float32 sqrt, sin, cos and atan2:
tools/card_cpu_stages.py `lm_forms`), the finish before the polish as it
is. Each tree runs in its own process, in turns A B C C B A ... (`--turns`
passes), and each run makes the same inputs from a seed: B = 8192
goals for the UR10 path (10-step polish), the table path (UR10 + 100
spheres, the augmented-Lagrangian polish) and planar40
(load_planar_chain(40, limits=pi/2), 10-step polish), and solved-looking
node positions, the goals' FK positions plus 1 mm of noise, in place of
the TR solve's Y (so the TR kernel is not run). Each path's finish runs
compiled (make_solver's CUDA graph, captured on the warm call). It then
times `--reps` finish calls of each path with the host clock between two
`torch.cuda.synchronize()` calls and reports their median, the success
rate and a hash of q (equal hashes mean bitwise-equal results), and from
one more call under torch.profiler the host launches (CUDA API calls that
start device work, a graph launch counting one), the device kernels, and
among them the LM's solves: K6 (spd_solve_kernel) and the library's
Cholesky factor and triangular solves (potrf, trsm), the device kernels of
the same finish without the polish (so the LM's share is the difference),
and the MiB its solver's graph pools hold (the caching allocator's segments of those
pools, after the warm call captured the finish); at the end, for each
tree and path, the quartiles of its runs' medians. The last line is one
JSON object. Without a CUDA device it exits 2.

    python tools/torch_finish_bench.py --ops --tree parent=build/dev/parent --tree change=.

counts instead, on the CPU with B = 64, the top-level aten operators one
finish call of each path dispatches, with the polish and without
(torch.profiler): on the card each is
at least one kernel launch, the cost the finish stage is bound by.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import kernel_trees  # beside this script

B = 8192
B_OPS = 64
SEED = 0


def count_ops(fn):
    """Top-level aten operators dispatched by fn() (not those nested in
    another aten operator)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    return sum(1 for e in aten
               if e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))


# the CUDA API calls (runtime cuda*, low-level cu*) by which the host starts device work
HOST_LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync"}
PATHS = ("ur10", "table", "planar40")


def launch_counts(fn):
    """One run of fn under torch.profiler: host launches, device kernels,
    and the kernels of the LM's solve by kind."""
    import re

    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    kernels = [e.name() for e in events if e.device_type() == cuda
               and not e.name().startswith(("Memcpy", "Memset"))]
    return {"host_launches": sum(1 for e in events if e.device_type() != cuda
                                 and e.name() in HOST_LAUNCH_CALLS),
            "device_kernels": len(kernels),
            "k6_kernels": sum("spd_solve_kernel" in n for n in kernels),
            "potrf_kernels": sum(bool(re.search("potrf|cholesky", n, re.I)) for n in kernels),
            "trsm_kernels": sum(bool(re.search("trsm", n, re.I)) for n in kernels)}


def pool_mib(solver):
    """MiB held by the memory pools of the solver's CUDA graphs."""
    import torch

    pools = {tuple(p) for p in solver.graphs.pools.values()}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools) / 2 ** 20


def run_one(reps, ops=False, lm_parent=False):
    import numpy as np
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.robots.library import load_planar_chain, load_ur10
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.utils.environments import table_environment

    torch.backends.cuda.matmul.allow_tf32 = False
    tpl, ps = load_ur10()
    ps_t = ProblemStructure.from_template(tpl, obstacles=table_environment())
    gen = torch.Generator().manual_seed(SEED)
    dev, B_ = ("cpu", B_OPS) if ops else ("cuda", B)
    out = {}
    ps_40 = load_planar_chain(40, limits=np.pi / 2)[1]
    if lm_parent:
        import card_cpu_stages

        def forms():
            return card_cpu_stages.lm_forms(card_cpu_stages.LM_VARIANTS["parent"])
    else:
        forms = contextlib.nullcontext
    for name, structure in zip(PATHS, (ps, ps_t, ps_40)):
        with forms():  # every finish call of the path, the captured one included
            kw = dict(polish_params=LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
            solver = api.make_solver(structure, **kw)
            no_polish = api.make_solver(structure, polish=False, **kw)
            T_goal, q = api.random_goals(structure, (B_,), gen, dtype=torch.float32, device=dev)
            noise = torch.randn((B_, structure.N, structure.dim), generator=gen).to(dev)
            zero = torch.zeros(B_, device=dev)
            sol = {"Y": structure.realization(q) + 1e-3 * noise, "cost": zero, "gradnorm": zero,
                   "iterations": zero.int(), "num_inner": zero.int()}
            res = solver.finish(sol, T_goal)  # warm call: runs the finish, then captures it
            if ops:
                out[name] = {"aten_ops": count_ops(lambda: solver.finish(sol, T_goal)),
                             "aten_ops_pre_polish": count_ops(
                                 lambda: no_polish.finish(sol, T_goal))}
                continue
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solver.finish(sol, T_goal)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out[name] = {"finish_ms_median": float(np.median(walls)), "finish_ms": walls,
                         "success": api.summarize(res)["success_rate"],
                         "q_sha256": hashlib.sha256(
                             res["q"].cpu().numpy().tobytes()).hexdigest()[:16],
                         "graph_pool_mib": pool_mib(solver),
                         **launch_counts(lambda: solver.finish(sol, T_goal))}
            no_polish.finish(sol, T_goal)
            out[name]["pre_polish_kernels"] = launch_counts(
                lambda: no_polish.finish(sol, T_goal))["device_kernels"]
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[], help="label=path (default: this tree)")
    p.add_argument("--lm-parent", action="append", default=[], metavar="LABEL=PATH",
                   help="a tree whose LM runs on the earlier forms of lie's helpers")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--turns", type=int, default=2,
                   help="passes over the trees, in turns A B C C B A ...")
    p.add_argument("--ops", action="store_true",
                   help="count each path's aten operators per finish call on the CPU")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    p.add_argument("--child-lm-parent", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        print(json.dumps(run_one(args.reps, args.ops, args.child_lm_parent)))
        return 0
    import numpy as np
    import torch

    trees = [(label, path, False) for label, path in kernel_trees.trees(args.tree)]
    trees += [(*t.split("=", 1), True) for t in args.lm_parent]
    if args.ops:
        counts = {label: json.loads(subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", label, "--ops"]
            + ["--child-lm-parent"] * lm,
            env=dict(os.environ, PYTHONPATH=os.path.abspath(path)), cwd=os.path.abspath(path),
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1])
            for label, path, lm in trees}
        print(json.dumps({"B": B_OPS, "device": "cpu", "aten_ops": counts}))
        return 0
    if not torch.cuda.is_available():
        print("torch_finish_bench: no CUDA device", file=sys.stderr)
        return 2
    order = kernel_trees.alternate(trees, args.turns)
    card = kernel_trees.smi("name,power.limit")
    runs = []
    for label, path, lm in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(path))
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", label,
                              "--reps", str(args.reps)] + ["--child-lm-parent"] * lm, env=env,
                             cwd=os.path.abspath(path), capture_output=True, text=True,
                             check=True)
        r = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": label, **r})
        print(f"{label}: " + ", ".join(f"{k} {v['finish_ms_median']:.1f} ms (success "
                                       f"{v['success']:.4f}, q {v['q_sha256']}; host launches "
                                       f"{v['host_launches']}, kernels {v['device_kernels']} "
                                       f"({v['pre_polish_kernels']} before the polish): "
                                       f"K6 {v['k6_kernels']}, potrf {v['potrf_kernels']}, "
                                       f"trsm {v['trsm_kernels']}; graph pools "
                                       f"{v['graph_pool_mib']:.1f} MiB)"
                                       for k, v in r.items()), flush=True)
    summary = {}  # tree -> path -> quartiles of the runs' medians
    for label, _, _ in trees:
        for path in PATHS:
            meds = [r[path]["finish_ms_median"] for r in runs if r["tree"] == label]
            q = np.percentile(meds, [25, 50, 75]).tolist()
            summary.setdefault(label, {})[path] = {"runs": len(meds), "q25_q50_q75_ms": q}
            print(f"{label} {path}: median of {len(meds)} runs' medians {q[1]:.1f} ms "
                  f"(quartiles {q[0]:.1f} / {q[2]:.1f})", flush=True)
    print(json.dumps({"card": card, "B": B, "reps": args.reps, "summary": summary,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
