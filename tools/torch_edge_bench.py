#!/usr/bin/env python3
"""Time the port's edge kernels K1 (cost + gradient, `cost_and_egrad_cuda`)
and K2 (Hessian-vector product, `ehess_cuda`) from one or more source
trees on the same inputs, in turns, on one GPU.

    python3 tools/torch_edge_bench.py                          # this tree only
    python3 tools/torch_edge_bench.py --tree parent=build/dev/parent --tree change=.

A tree is a directory that holds a `graphik_tpu_torch` package and the
robot specs it reads (for example the parent commit's, unpacked with
`git archive HEAD graphik_tpu_torch graphik_tpu/robots/specs | tar -x -C
build/dev/parent`). The inputs are made once by this tree's package: the
UR10 path's prepared Y0 and goal distances at B = 8192 (seeded goals) and
a seeded Z; B = 131,072 repeats them 16 times, so that the working set
(84 MB for K1, 109 MB for K2) passes the card's 50 MB L2. Each tree runs
in its own process (a package of one name cannot be imported twice), in
the order A B B A ..., and for each kernel and batch reports:

  device_ms  the kernel's own time: the median (and the least) of the
             profiler's kernel-event durations over `--flushes` launches
             (at least half of the events must arrive), each after a read
             of 256 MB that flushes the L2, so that every launch finds its
             inputs cold, as a caller does (`--flush write` flushes with a
             256 MB write instead, as PR 8's first parent run did: its
             dirty lines are written back during the timed launch);
  call_ms    the wrapper's call time: CUDA events around `--calls`
             back-to-back calls (checks, allocation, launch) after a warm
             call, divided by the count;
  sha256     a hash of the outputs (equal hashes: bitwise-equal results).

The bound of each (bytes: inputs read once, outputs written once, over
3.35 TB/s; operations: `edge_flops` over 67 TFLOP/s) is counted from the
shapes. The last line is one JSON object. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_PATH = 8192
REPEAT = 16  # B = 131,072
SEED = 0
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
KERNELS = {"cost_grad": "cost_grad_kernel", "hess": "hess_kernel"}
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kernel_trees  # noqa: E402  (beside this script)


def edge_flops(N, d, E):
    """chip_smoke.py's count for one instance of K1 (K2 adds E d)."""
    return E * d + 20 * E + 2 * E * d + N * d


def bound_ms(kernel, B, N, d, E):
    """(ms, "bytes" or "operations", bytes) for one launch."""
    if kernel == "cost_grad":
        flops, nbytes = B * edge_flops(N, d, E), B * (2 * N * d + E + 1) * 4
    else:
        flops, nbytes = B * (edge_flops(N, d, E) + E * d), B * (3 * N * d + E) * 4
    t_op, t_b = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations", nbytes) if t_op >= t_b else (t_b, "bytes", nbytes)


def ur10_problem():
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.robots.library import load_ur10

    _, ps = load_ur10()
    omega, psi_L, psi_U = ps.masks()
    return ps, edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=3)


def make_inputs(path):
    import torch

    from graphik_tpu_torch import api

    ps, ep = ur10_problem()
    gen = torch.Generator().manual_seed(SEED)
    T_goal, _ = api.random_goals(ps, (B_PATH,), gen, dtype=torch.float32, device="cuda")
    D_goal, Y0 = api.make_solver(ps, smooth_iters=2).prepare(T_goal)
    Z = torch.randn(Y0.shape, generator=torch.Generator().manual_seed(SEED))
    out = {"Y": Y0.contiguous().cpu(), "dg": ep.edge_values(D_goal).contiguous().cpu(), "Z": Z}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(out, path)


def device_times(fn, kernel_name, flushes, flush_by="read"):
    """Durations (ms) of the kernel events named kernel_name over `flushes`
    launches of fn, each after an L2 flush: by default a sum over a 256 MB
    buffer, which leaves the L2 holding clean lines of that buffer; "write"
    zeroes it instead, leaving dirty lines whose write-back the next kernel
    pays for."""
    import torch

    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    flush_fn = flush.sum if flush_by == "read" else flush.zero_
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(flushes):
            flush_fn()
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ms = [e.duration_ns() / 1e6 for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and kernel_name in e.name()]
    # the profiler's buffers may drop a few events; a median needs most of them
    if 2 * len(ms) < flushes:
        raise RuntimeError(f"expected {flushes} {kernel_name} events, found {len(ms)}")
    return ms


def call_ms(fn, calls):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def child(label, tree, inputs, flushes, calls, flush_by):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import graphik_tpu_torch
    from graphik_tpu_torch.ops import _build
    from graphik_tpu_torch.ops import edge as edge_ops

    pkg = os.path.dirname(os.path.abspath(graphik_tpu_torch.__file__))
    if os.path.dirname(pkg) != tree:
        raise RuntimeError(f"imported {pkg}, not the package under {tree}")
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    with open(_build.library_path() + ".log") as f:
        ptxas = f.read()
    regs = []
    for entry in ptxas.split("Compiling entry function '")[1:]:
        name = re.search(r"([a-z][a-z_]*_kernel)I((?:Li\d+E|Lb\d+E)+)E", entry)
        if not name or name.group(1) not in KERNELS.values():  # K5's take a type argument
            continue
        args = ",".join(re.findall(r"L[ib](\d+)E", name.group(2)))
        r, s = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", entry).groups()
        spill = re.search(r"(\d+) bytes spill stores", entry).group(1)
        regs.append(f"{name.group(1)}<{args}>: {r} registers, {s} B smem, {spill} B spill stores")

    ps, ep = ur10_problem()
    data = torch.load(inputs)
    res = {"label": label, "tree": tree, "build_s": build_s, "ptxas": regs}
    fns = {}
    for B in (B_PATH, B_PATH * REPEAT):
        reps = B // B_PATH
        Y = data["Y"].repeat(reps, 1, 1).cuda()
        Z = data["Z"].repeat(reps, 1, 1).cuda()
        dg = data["dg"].repeat(reps, 1).cuda()
        fns[f"cost_grad_{B}"] = (
            "cost_grad", lambda Y=Y, dg=dg: edge_ops.cost_and_egrad_cuda(ep, Y, dg))
        fns[f"hess_{B}"] = ("hess", lambda Y=Y, Z=Z, dg=dg: edge_ops.ehess_cuda(ep, Y, Z, dg))
    for key, (_, fn) in fns.items():
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        # every call time before this process runs a profiler, as a caller's
        # process would not
        res[key] = {"sha256": h.hexdigest()[:16], "call_ms": call_ms(fn, calls)}
    for key, (kernel, fn) in fns.items():
        dev = device_times(fn, KERNELS[kernel], flushes, flush_by)
        res[key].update(device_ms=statistics.median(dev), device_ms_min=min(dev),
                        device_events=len(dev), sm_clock=kernel_trees.smi("clocks.sm"))
    print(json.dumps(res))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="LABEL=DIR of a tree holding graphik_tpu_torch (default: change=.)")
    p.add_argument("--reps", type=int, default=2, help="runs of each tree, in turns")
    p.add_argument("--flushes", type=int, default=30)
    p.add_argument("--flush", choices=("read", "write"), default="read")
    p.add_argument("--calls", type=int, default=100)
    p.add_argument("--inputs", default=os.path.join(ROOT, "build", "bench", "edge_inputs.pt"))
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        label, tree = args.child.split("=", 1)
        child(label, tree, args.inputs, args.flushes, args.calls, args.flush)
        return 0

    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_edge_bench: no CUDA device", file=sys.stderr)
        return 2
    trees = kernel_trees.trees(args.tree, "change=.")
    card = kernel_trees.smi("name,power.limit")
    print(f"card: {card}", flush=True)
    make_inputs(args.inputs)
    ps, ep = ur10_problem()
    bounds = {f"{k}_{B}": bound_ms(k, B, ep.N, 3, ep.E)
              for k in KERNELS for B in (B_PATH, B_PATH * REPEAT)}
    for key, (ms, by, nbytes) in bounds.items():
        print(f"bound {key}: {ms * 1e3:.2f} us ({by}; {nbytes / 1e6:.1f} MB)", flush=True)
    order = kernel_trees.alternate(trees, args.reps)
    runs = []
    for label, tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", f"{label}={tree}",
               "--inputs", args.inputs, "--flushes", str(args.flushes), "--flush", args.flush,
               "--calls", str(args.calls)]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the run of {label} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        for line in r["ptxas"]:
            print(f"{label}: ptxas {line}", flush=True)
        for key in bounds:
            x = r[key]
            print(f"{label} {key}: device {x['device_ms'] * 1e3:.2f} us (min "
                  f"{x['device_ms_min'] * 1e3:.2f}; {x['device_events']} events), call "
                  f"{x['call_ms'] * 1e3:.2f} us, "
                  f"sha {x['sha256']}, SM clock {x['sm_clock']} (build {r['build_s']:.1f} s)",
                  flush=True)
    summary = {"card": card, "flush": args.flush,
               "bounds_ms": {k: v[0] for k, v in bounds.items()}, "runs": runs}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
