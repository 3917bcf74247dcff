#!/usr/bin/env python3
"""Time K6, the LM's clamped-pivot solve (`graphik_tpu_torch/csrc/spd_solve.cu`),
from one or more source trees on the same inputs, in turns, on one GPU.

    python3 tools/torch_spd_bench.py                          # this tree only
    python3 tools/torch_spd_bench.py --tree parent=build/dev/parent --tree change=.
    python3 tools/torch_spd_bench.py --stages                 # and the cut launches

A tree is a directory holding `graphik_tpu_torch/csrc/spd_solve.cu` (for
example the parent commit's, unpacked with `git archive HEAD graphik_tpu_torch
| tar -x -C build/dev/parent`). Each tree's spd_solve.cu is compiled alone with
this tree's nvcc flags into a library under build/spd_bench/<label>/ and
called through its C entry point `graphik_spd_solve`, unchanged since it was
written (tools/kernel_trees.py). With `--stages`, each tree whose source
knows GRAPHIK_SPD_STAGES is also built with only the triangle's load
(<label>_load) and with the load and the factor (<label>_factor): the times
of the cut launches apart are a stall picture without a profiler of the
kernel's own counters. Another design (a panel width, the largest m of a
thread a system) is timed as a tree of its own: a copy under build/ with
the constant edited.

The inputs are chip_smoke.py phase 21's (`chip_smoke.spd_cases`): every
path's LM systems at the batch its polish hands K6 and random systems at
m = 3, 33, 64, float32 and float64. For each input and build, in turns
A B B A:

  device_ms  the kernel's time on the card: CUDA events around the replays
             of a CUDA graph of REPS launches, over REPS (the host's pace
             does not count);
  prof_ms    the median of the profiler's kernel-event durations over
             REPS launches;
  launch_ms  CUDA events around REPS back-to-back ctypes launches, over
             REPS (the host's pace counts);
  sha256     a hash of x (equal hashes: bitwise-equal results);

beside the bound (chip_smoke.spd_bound) and the time of cholesky_ex + 2
solve_triangular on the same inputs (the library's solve, pivots not
clamped). The last line is one JSON object, also written to
<--out>/spd_bench.json. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import kernel_trees  # noqa: E402  (beside this script)

REPS = 20
SEED = 0
STAGES = {"load": 1, "factor": 2}


class Kernel:
    """One build's graphik_spd_solve, with x preallocated per input."""

    def __init__(self, lib):
        self.entry = kernel_trees.Entry(lib, "graphik_spd_solve", 3, 3)
        self.out = {}

    def __call__(self, A, b):
        import torch

        key = (A.data_ptr(), b.data_ptr())
        if key not in self.out:
            self.out[key] = torch.empty_like(b)
        x = self.out[key]
        self.entry((A, b, x), (b.shape[0], b.shape[1], int(A.dtype == torch.float64)))
        return x


def digest(x):
    import torch

    torch.cuda.synchronize()
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def profiled_ms(fn, reps):
    """Median duration (ms) of the profiler's spd_solve kernel events over
    reps launches, or None where it recorded fewer than half of them."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ms = [e.duration_ns() / 1e6 for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and "spd_solve" in e.name()]
    return statistics.median(ms) if 2 * len(ms) >= reps else None


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH")
    p.add_argument("--turns", type=int, default=1, help="pairs of turns (A B B A per pair)")
    p.add_argument("--stages", action="store_true",
                   help="also build each tree with only the load, and with the load and factor")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_spd_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke

    trees = kernel_trees.trees(args.tree)
    builds = [(label, tree, ()) for label, tree in trees]
    if args.stages:
        for label, tree in trees:
            with open(os.path.join(tree, "graphik_tpu_torch", "csrc", "spd_solve.cu")) as f:
                if "GRAPHIK_SPD_STAGES" in f.read():
                    builds += [(f"{label}_{name}", tree, (f"-DGRAPHIK_SPD_STAGES={k}",))
                               for name, k in STAGES.items()]
    card = kernel_trees.smi("name,power.limit")
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda:0")
    record = {"card": card, "builds": {}}
    kernels = {}
    for label, tree, flags in builds:
        lib, record["builds"][label] = kernel_trees.build("spd_bench", label, tree,
                                                          "spd_solve.cu", flags)
        kernels[label] = Kernel(lib)

    def library(A, b):
        L = torch.linalg.cholesky_ex(A)[0]
        w = torch.linalg.solve_triangular(L, b[..., None], upper=False)
        return torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)[..., 0]

    labels = [label for label, _, _ in builds]
    order = kernel_trees.alternate(labels, 2 * args.turns)
    rows = []
    for tag, A, b in chip_smoke.spd_cases(dev, torch.Generator(device="cpu").manual_seed(SEED)):
        A, b = A.contiguous(), b.contiguous()
        B, m = b.shape
        key = "f64" if A.dtype == torch.float64 else "f32"
        hashes = {label: digest(kernels[label](A, b)) for label in labels}
        t = {label: {"device_ms": [], "prof_ms": [], "launch_ms": []} for label in labels}
        for label in order:
            fn = (lambda k=kernels[label]: k(A, b))
            t[label]["device_ms"].append(chip_smoke.graph_ms(fn, REPS))
            t[label]["prof_ms"].append(profiled_ms(fn, REPS))
            t[label]["launch_ms"].append(chip_smoke.event_ms(fn, REPS))
        bd = chip_smoke.spd_bound(m, B, A.dtype)
        lib_ms = chip_smoke.event_ms(lambda: library(A, b), 5)
        row = {"case": tag, "dtype": key, "B": B, "m": m, "bound_ms": bd[0], "bound_by": bd[1],
               "library_ms": lib_ms, "times": t, "sha256": hashes}
        rows.append(row)
        print(f"{tag} {key}: B = {B}, m = {m}: "
              + "; ".join(f"{lb} device {min(v['device_ms']) * 1e3:.2f}-"
                          f"{max(v['device_ms']) * 1e3:.2f} us, profiler "
                          + ", ".join("-" if x is None else f"{x * 1e3:.2f}"
                                      for x in v["prof_ms"])
                          + f" us, launch {min(v['launch_ms']) * 1e3:.2f}-"
                          f"{max(v['launch_ms']) * 1e3:.2f} us ({hashes[lb]})"
                          for lb, v in t.items())
              + f"; bound {bd[0] * 1e3:.2f} us ({bd[1]}); cholesky_ex + 2 solve_triangular "
              f"{lib_ms * 1e3:.2f} us", flush=True)
    record["rows"] = rows
    record["card_after"] = kernel_trees.smi("name,power.limit,clocks.sm,temperature.gpu")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "spd_bench.json"), "w") as f:
        json.dump(record, f)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
