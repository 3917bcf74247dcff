#!/usr/bin/env python3
"""Time the port's TR kernel (K3 anchor-free, K4 anchored) from one or more
source trees on the same inputs, in turns, on one GPU.

    python3 tools/torch_tr_bench.py                            # this tree only
    python3 tools/torch_tr_bench.py --tree parent=build/dev/parent --tree change=.

A tree is a directory that holds a `graphik_tpu_torch` package and the
robot specs it reads (for example the parent commit's, unpacked with
`git archive HEAD graphik_tpu_torch graphik_tpu/robots/specs | tar -x -C
build/dev/parent`). The inputs are made once
by this tree's package: B = 8192 goals from a seeded generator, prepared
for the UR10 path and for the table path (UR10 + 100 spheres, reduced to
16 nodes and 624 anchor rows). Each tree then runs in its own process
(a package of one name cannot be imported twice), in the order
A B B A A B ..., and each run times:

  K3: solve_tr_cuda on the UR10 inputs, maxiter=100, maxinner=24, plateau 16;
  K4: solve_tr_cuda on the table inputs, maxiter=250, maxinner=32, plateau 16;

with CUDA events around `--launches` launches after one warm-up launch. It
also reports mean iterations and num_inner, a hash of the outputs (equal
hashes mean bitwise-equal results), each kernel instance's registers,
shared memory and spills from the build log, and the SM clock read by
nvidia-smi right after the timed launches. `--sass REGEX` writes the
`cuobjdump -sass` of each tree's kernels whose mangled name matches REGEX
to <--sass-dir>/sass_<label>.txt. The last line is one JSON object.
Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8192
SEED = 0


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def problems():
    """The UR10 and table EdgeProblems, built by the imported package."""
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.utils.environments import table_environment

    tpl, ps = load_ur10()
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=3)
    ps_t = ProblemStructure.from_template(tpl, obstacles=table_environment())
    spec = ps_t.reduced_spec()
    Nr = spec["Nr"]
    om, pl, pu = ps_t.masks()
    ep_t = edge_ops.build_edge_problem(om[:Nr, :Nr], pl[:Nr, :Nr], pu[:Nr, :Nr], dim=3,
                                       anchors=spec)
    return ps, ep, ps_t, ep_t


def make_inputs(path):
    import torch

    from graphik_tpu_torch import api

    ps, ep, ps_t, ep_t = problems()
    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for name, structure, e in (("ur10", ps, ep), ("table", ps_t, ep_t)):
        T_goal, _ = api.random_goals(structure, (B,), gen, dtype=torch.float32, device="cuda")
        D_goal, Y0 = api.make_solver(structure, smooth_iters=2).prepare(T_goal)
        out[name] = (Y0.contiguous().cpu(), e.edge_values(D_goal).contiguous().cpu())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(out, path)


def child(label, tree, inputs, launches, sass, sass_dir):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import graphik_tpu_torch
    from graphik_tpu_torch.ops import _build
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda

    pkg = os.path.dirname(os.path.abspath(graphik_tpu_torch.__file__))
    if os.path.dirname(pkg) != tree:
        raise RuntimeError(f"imported {pkg}, not the package under {tree}")
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    lib = _build.library_path()
    with open(lib + ".log") as f:
        ptxas = f.read()
    regs = []
    for entry in ptxas.split("Compiling entry function '")[1:]:
        name = re.search(r"([a-z][a-z_]*_kernel)I((?:Li\d+E|Lb\d+E)+)E", entry)
        args = ",".join(re.findall(r"L[ib](\d+)E", name.group(2)))
        r, s = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", entry).groups()
        spill = re.search(r"(\d+) bytes spill stores", entry).group(1)
        regs.append(f"{name.group(1)}<{args}>: {r} registers, {s} B smem, {spill} B spill stores")
    if sass:
        os.makedirs(sass_dir, exist_ok=True)
        dump = subprocess.run([os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                            "bin", "cuobjdump"), "-sass", lib],
                              capture_output=True, text=True, check=True).stdout
        funcs = re.split(r"\n(?=\s+Function : )", dump)
        with open(os.path.join(sass_dir, f"sass_{label}.txt"), "w") as f:
            f.write("\n".join(x for x in funcs[1:] if re.search(sass, x.split("\n", 1)[0])))

    _, ep, _, ep_t = problems()
    data = torch.load(inputs)
    res = {"label": label, "tree": tree, "build_s": build_s, "ptxas": regs}
    cases = (
        ("k3", ep, data["ur10"], dict(maxiter=100, maxinner=24, plateau_every=16,
                                      plateau_rtol=1e-4)),
        ("k4", ep_t, data["table"], dict(maxiter=250, maxinner=32, plateau_every=16,
                                         plateau_rtol=1e-4)),
    )
    for name, e, (Y0, dg), kw in cases:
        Y0, dg = Y0.cuda(), dg.cuda()
        out = solve_tr_cuda(e, Y0, dg, **kw)  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            solve_tr_cuda(e, Y0, dg, **kw)
        end.record()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for k in ("Y", "cost", "gradnorm", "iterations", "num_inner"):
            h.update(out[k].cpu().numpy().tobytes())
        it = out["iterations"].double()
        ni = out["num_inner"].double()
        res[name] = {
            "ms": start.elapsed_time(end) / launches,
            "mean_iterations": float(it.mean()),
            "mean_num_inner": float(ni.mean()),
            "inner_per_outer": float(ni.sum() / it.sum().clamp(min=1)),
            "outputs_sha256": h.hexdigest()[:16],
            "sm_clock": smi("clocks.sm"),
        }
    print(json.dumps(res))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="LABEL=DIR of a tree holding graphik_tpu_torch (default: change=.)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--launches", type=int, default=3)
    p.add_argument("--sass", default="", metavar="REGEX")
    p.add_argument("--sass-dir", default=os.path.join(ROOT, "build", "bench"))
    p.add_argument("--inputs", default=os.path.join(ROOT, "build", "bench", "tr_inputs.pt"))
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        label, tree = args.child.split("=", 1)
        child(label, tree, args.inputs, args.launches, args.sass,
              os.path.abspath(args.sass_dir))
        return 0

    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_tr_bench: no CUDA device", file=sys.stderr)
        return 2
    trees = [t.split("=", 1) for t in (args.tree or ["change=."])]
    card = smi("name,power.limit")
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    make_inputs(args.inputs)
    order = []
    for r in range(args.reps):
        order += trees if r % 2 == 0 else trees[::-1]
    runs = []
    for i, (label, tree) in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", f"{label}={tree}",
               "--inputs", args.inputs, "--launches", str(args.launches)]
        if args.sass and i < len(trees):
            cmd += ["--sass", args.sass, "--sass-dir", os.path.abspath(args.sass_dir)]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the run of {label} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        print(f"{label}: K3 {r['k3']['ms']:.3f} ms, K4 {r['k4']['ms']:.3f} ms "
              f"(build {r['build_s']:.1f} s, SM clock {r['k4']['sm_clock']})", flush=True)
    summary = {"card": card, "B": B, "runs": runs}
    for label, _ in trees:
        mine = [r for r in runs if r["label"] == label]
        summary[label] = {k: [r[k]["ms"] for r in mine] for k in ("k3", "k4")}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
