#!/usr/bin/env python3
"""Time K5, the batched eigensolver (`graphik_tpu_torch/csrc/eigh*.cu`), from
one or more source trees on the same inputs, in turns, on one GPU, and show
what each tree's kernel compiles to.

    python3 tools/torch_eigh_bench.py                          # this tree only
    python3 tools/torch_eigh_bench.py --tree parent=build/dev/parent --tree change=.

A tree is a directory holding `graphik_tpu_torch/csrc/eigh*.cu` (for example
the parent commit's, unpacked with `git archive HEAD graphik_tpu_torch | tar
-x -C build/dev/parent`). Each tree's eigh*.cu are compiled with this tree's
nvcc flags, one nvcc process a source, into a library under
build/eigh_bench/<label>/ and called through its C entry point
`graphik_sym_eigh`, unchanged since it was written (tools/kernel_trees.py).
`--wide-warps 1,2` also builds each tree that has csrc/eigh_wide.cuh with
every instance past n = 32 at one and at two warps a matrix
(-DGRAPHIK_EIGH_WIDE_WARPS), labelled <label>_nw1, <label>_nw2: the
measurement that picks each instance's split. For each build the script
reports:

  build      nvcc's wall, and each kernel instance's registers, static
             shared memory and spill stores (-Xptxas -v);
  sass       with --sass-dir, `cuobjdump -sass` of the library written to
             <dir>/eigh_sass_<label>.txt.gz, and for each kernel instance its
             instruction count and, for each loop (a backward branch), the
             loop's instructions by class: integer division (I2F.RP starts
             a divisor's reciprocal, IMAD.HI.U32 takes a quotient),
             shuffles, shared loads and stores, float operations,
             special-function (MUFU) and the rest;
  occupancy  the time on the first B of UR10's prepare Grams (n = 16) and
             of planar40's (n = 43), float32 and float64, for B in
             chip_smoke.EIGH_OCCUPANCY_B (1024 to 8192): an issue-bound
             kernel's time grows with the warps on each scheduler, a
             latency-bound one's stays flat;
  paths      the time at each matrix shape a path launches
             (chip_smoke.eigh_path_inputs), beside the bound
             (chip_smoke.eigh_bound) and torch.linalg.eigh's time;
  sizes      the time on SIZES_B seeded random symmetric matrices at each n
             of --sizes (default 34, 42, 43, 48, 56, 64: past n = 32),
             float32 and float64, beside the bound and torch.linalg.eigh's
             time (every tree must take n > 32; pass --sizes "" for a
             parent that does not).
Past n = 32 each row also has the mean sweeps a matrix and the Jacobi's
own operation count over the card's rate (chip_smoke.eigh_sweeps).

Times are CUDA-event means over REPS back-to-back launches into
preallocated outputs after a warm launch, taken in turns A B B A over the
builds. Every build's outputs (eigenvalues, eigenvectors, flags) are
hashed: equal hashes are bitwise-equal results. The inputs are made by this
tree's package from SEED. The last line is one JSON object, also written to
<--out>/eigh_bench.json. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import kernel_trees  # noqa: E402  (beside this script)

REPS = 20  # launches a timing
SEED = 0
SIZES_B = 8192


def sass_classes(lines):
    """Instruction counts of SASS lines by class."""
    c = collections.Counter()
    for op in lines:
        base = op.split(".")[0]
        if op.startswith("I2F.RP"):
            c["int_div_setups"] += 1
        if op.startswith("IMAD.HI.U32"):
            c["int_div_quotients"] += 1
        if base == "SHFL":
            c["shfl"] += 1
        elif base in ("LDS", "STS"):
            c[base.lower()] += 1
        elif base in ("FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA", "FSETP", "DSETP",
                      "FSEL", "FMNMX", "DMNMX"):
            c["float"] += 1
        elif base == "MUFU":
            c["mufu"] += 1
        elif base in ("SEL", "ISETP", "IADD3", "IMAD", "LOP3", "LEA", "SHF", "IABS", "I2F",
                      "F2I", "IMNMX", "PLOP3", "P2R", "R2P", "MOV", "PRMT", "VOTE", "FLO"):
            c["integer_and_move"] += 1
        else:
            c["other"] += 1
        c["total"] += 1
    return dict(c)


def sass_report(lib, label, sass_dir):
    """{kernel: {"instructions": n, "loops": [{"start", "end", classes...}]}}
    of the library's SASS, and the listing written to sass_dir."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    os.makedirs(sass_dir, exist_ok=True)
    with gzip.open(os.path.join(sass_dir, f"eigh_sass_{label}.txt.gz"), "wt") as f:
        f.write(text)
    return sass_loops(text)


def sass_loops(text):
    """{kernel: {"instructions": n, "loops": [...], "all_<class>": n}} of a
    `cuobjdump -sass` listing: each loop is the run of instructions from a
    backward branch's target to the branch, with its counts by class."""
    report = {}
    for func in text.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        m = re.search(r"(sym_eigh(?:_wide)?_kernel)I((?:[fd]|L[ib]\d+E)+)E", name)
        if not m:
            continue
        args = ",".join(num or {"f": "float", "d": "double"}[t]
                        for num, t in re.findall(r"L[ib](\d+)E|([fd])", m.group(2)))
        instr, at_addr, branches = [], {}, []
        for line in func.split("\n"):
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*);",
                           line)
            if not ins:
                continue
            op = ins.group(3)
            at_addr[int(ins.group(1), 16)] = len(instr)
            tgt = re.match(r"\s*(0x[0-9a-f]+)", ins.group(4))
            if op.startswith("BRA") and tgt:
                branches.append((len(instr), int(tgt.group(1), 16)))
            instr.append(op)
        loops = []
        for at, tgt in branches:
            start = at_addr.get(tgt)
            if start is not None and start <= at:
                body = instr[start:at + 1]
                loops.append({"start": start, "end": at, **sass_classes(body)})
        report[f"{m.group(1)}<{args}>"] = {"instructions": len(instr), "loops": loops,
                                              **{"all_" + k: v for k, v in
                                                 sass_classes(instr).items()}}
    return report


class Kernel:
    """One tree's graphik_sym_eigh, with outputs preallocated per input."""

    def __init__(self, lib):
        self.entry = kernel_trees.Entry(lib, "graphik_sym_eigh", 4, 3)
        self.out = {}

    def __call__(self, A):
        import torch

        B, n = A.shape[0], A.shape[-1]
        key = (A.data_ptr(), B, n, A.dtype)
        if key not in self.out:
            self.out[key] = (torch.empty((B, n), dtype=A.dtype, device=A.device),
                             torch.empty((B, n, n), dtype=A.dtype, device=A.device),
                             torch.empty((B,), dtype=torch.int32, device=A.device))
        w, V, conv = self.out[key]
        self.entry((A, w, V, conv), (B, n, int(A.dtype == torch.float64)))
        return w, V, conv


def digest(outs):
    import torch

    h = hashlib.sha256()
    for t in outs:
        torch.cuda.synchronize()
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH")
    p.add_argument("--turns", type=int, default=2, help="pairs of turns (A B B A per pair)")
    p.add_argument("--sass-dir", default="", help="write each tree's SASS here")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    p.add_argument("--sizes", default="34,42,43,48,56,64", help="n of the random 'sizes' inputs")
    p.add_argument("--wide-warps", default="",
                   help="also build each tree that has csrc/eigh_wide.cuh with every n > 32 "
                        "instance at these warps a matrix (comma-separated: 1, 2), labelled "
                        "<label>_nw<k>")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_eigh_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke

    trees = kernel_trees.trees(args.tree)
    builds = [(label, tree, ()) for label, tree in trees]
    for k in [int(x) for x in args.wide_warps.split(",") if x]:
        builds += [(f"{label}_nw{k}", tree, (f"-DGRAPHIK_EIGH_WIDE_WARPS={k}",))
                   for label, tree in trees if os.path.exists(
                       os.path.join(tree, "graphik_tpu_torch", "csrc", "eigh_wide.cuh"))]
    card = kernel_trees.smi("name,power.limit")
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda:0")
    record = {"card": card, "trees": {}}
    kernels = {}
    for label, tree, flags in builds:
        lib, entry = kernel_trees.build("eigh_bench", label, tree, "eigh*.cu", flags)
        kernels[label] = Kernel(lib)
        if args.sass_dir:
            entry["sass"] = sass_report(lib, label, args.sass_dir)
        record["trees"][label] = entry

    paths = chip_smoke.eigh_path_inputs(dev, torch.Generator(device="cpu").manual_seed(SEED))
    inputs = [("occupancy", f"{tag} B={B}", A[:B].contiguous())
              for tag, A in paths if tag.startswith(chip_smoke.EIGH_OCCUPANCY_PATHS)
              for B in chip_smoke.EIGH_OCCUPANCY_B]
    inputs += [("paths", tag, A.contiguous()) for tag, A in paths]
    import numpy as np

    rs = np.random.RandomState(SEED)
    for n in [int(x) for x in args.sizes.split(",") if x]:
        X = rs.normal(size=(SIZES_B, n, n))
        for dt, key in ((torch.float32, "f32"), (torch.float64, "f64")):
            inputs.append(("sizes", f"random n={n} {key}",
                           torch.tensor(X + X.transpose(0, 2, 1), dtype=dt, device=dev)))

    labels = [label for label, _, _ in builds]
    order = kernel_trees.alternate(labels, 2 * args.turns)
    rows = []
    for group, tag, A in inputs:
        B, n = A.shape[0], A.shape[-1]
        times = {label: [] for label in labels}
        hashes = {label: digest(kernels[label](A)) for label in labels}
        for label in order:
            times[label].append(chip_smoke.event_ms(lambda: kernels[label](A), REPS))
        b = chip_smoke.eigh_bound(n, B, A.dtype)
        # past n = 32 torch.linalg.eigh takes seconds a call at B = 8192: one
        # timed call after the warm one
        lib_ms = (None if group == "occupancy"
                  else chip_smoke.event_ms(lambda: torch.linalg.eigh(A), 5 if n <= 32 else 1))
        sweeps = None if group == "occupancy" or n <= 32 else chip_smoke.eigh_sweeps(A)
        row = {"group": group, "case": tag, "B": B, "n": n, "bound_ms": b[0], "bound_by": b[1],
               "ms": times, "library_ms": lib_ms, "sha256": hashes, **(sweeps or {})}
        rows.append(row)
        print(f"{group} {tag}: B = {B}, n = {n}: "
              + "; ".join(f"{lb} {min(v):.4f}-{max(v):.4f} ms ({hashes[lb]})"
                          for lb, v in times.items())
              + f"; bound {b[0] * 1e3:.2f} us ({b[1]})"
              + ("" if lib_ms is None else f"; torch.linalg.eigh {lib_ms:.3f} ms")
              + ("" if sweeps is None else f"; {sweeps['mean_sweeps']:.3f} sweeps a matrix, "
                 f"Jacobi {sweeps['jacobi_ms']:.3f} ms"), flush=True)
    record["rows"] = rows
    record["card_after"] = kernel_trees.smi("name,power.limit,clocks.sm,temperature.gpu")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "eigh_bench.json"), "w") as f:
        json.dump(record, f)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
