"""What the kernel benches share: source trees given as LABEL=PATH, their
runs in turns, the card's name, and one kernel's sources built from a tree
alone and called through its plain C entry point.

tools/torch_spd_bench.py (K6) and tools/torch_eigh_bench.py (K5) build each
tree's sources into a library of their own with this tree's nvcc flags
(ops/_build.py compile_library) and call its entry point by ctypes, so that
two trees' kernels run in one process on the same inputs;
tools/torch_edge_bench.py runs each tree's package in a process of its own
and takes the trees, the turns and the card from here.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smi(query):
    """nvidia-smi's answer to --query-gpu=query (name, power limit, ...)."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def trees(specs, default="this=."):
    """[(label, path)] of --tree LABEL=PATH arguments (default: this tree)."""
    return [tuple(t.split("=", 1)) for t in (specs or [default])]


def alternate(items, runs):
    """`runs` entries of items in turns A B B A A B ...: each pass through
    items is followed by one in reverse, so that no item always runs first."""
    order = []
    for r in range(runs):
        order += items if r % 2 == 0 else items[::-1]
    return order


def build(bench, label, tree, pattern, flags=()):
    """(library, record) of the sources csrc/<pattern> of the tree, each by
    its own nvcc process, with `flags` added, linked into
    build/<bench>/<label>/lib.so; the record holds the tree, the flags,
    nvcc's wall and each kernel instance's registers, static shared memory
    and spill stores (-Xptxas -v)."""
    import chip_smoke
    from graphik_tpu_torch.ops._build import compile_library

    out_dir = os.path.join(ROOT, "build", bench, label)
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "lib.so")
    srcs = sorted(glob.glob(os.path.join(os.path.abspath(tree), "graphik_tpu_torch", "csrc",
                                         pattern)))
    t0 = time.perf_counter()
    log = compile_library(srcs, lib, flags)
    record = {"tree": tree, "flags": list(flags), "build_s": time.perf_counter() - t0,
              "ptxas": {k: {"registers": r, "smem": s, "spill_stores": sp}
                        for k, (r, s, sp) in chip_smoke.parse_ptxas(log).items()}}
    print(f"{label}: built in {record['build_s']:.2f} s; {json.dumps(record)}", flush=True)
    return lib, record


class Entry:
    """A library's C entry point `name(pointers..., ints..., stream)`,
    returning a cudaError_t, called on torch tensors and ints on the current
    stream; a launch that fails raises."""

    def __init__(self, lib, name, n_pointers, n_ints):
        self.name = name
        self.fn = getattr(ctypes.CDLL(lib), name)
        self.fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                            + [ctypes.c_void_p])
        self.fn.restype = ctypes.c_int

    def __call__(self, tensors, ints):
        import torch

        rc = self.fn(*[t.data_ptr() for t in tensors], *ints,
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
