"""Build and load the port's CUDA kernels.

The sources under graphik_tpu_torch/csrc/ have a plain C interface; on first
use each .cu is compiled by its own nvcc process for sm_90a (all started
together), the objects are linked into one shared library under
<repo>/build/graphik_tpu_torch/ (keyed by a hash of the sources, headers
and flags, so an edit rebuilds), and the library is loaded with ctypes.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "graphik_tpu_torch")

# -fmad=false: the kernels are checked against plain torch transcriptions,
# so products and sums round separately as they do there.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Argument types of each C entry point, in the order of csrc/*.cu.
_SIGNATURES = {
    "graphik_tr_solve": [
        _P, _P, _I,                                         # Y0, dgoal, dg_stride
        _P, _P, _P, _P, _P,                                 # ei, ej, epar, rowptr, inc
        _P, _P, _P,                                         # acen, apar, anode
        _P, _P, _P, _P, _P,                                 # Yout, cost, gradnorm, iters, ninner
        _I, _I, _I, _I, _I, _I, _I,                         # B, N, D, E, A, a_nsel, a_R
        _I, _I, _I, _I,                                     # maxiter .. plateau_every
        _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,         # mingradnorm .. res_tol, a_near
        _P,                                                 # stream
    ],
    "graphik_tr_shape": [
        _I, _I, _I, _I, _I, _I, _I,                         # B, N, D, E, A, a_nsel, a_R
        _P,                                                 # info (4 int32)
    ],
    "graphik_edge_cost_grad": [
        _P, _P, _I,                                         # Y, dgoal, dg_stride
        _P, _P, _P, _P,                                     # ei, ej, epar, rowptr
        _P, _P, _I,                                         # codes, slot, n_codes
        _P, _P,                                             # f, g
        _I, _I, _I, _I,                                     # B, N, D, E
        _I, _P,                                             # device, stream
    ],
    "graphik_edge_hess": [
        _P, _P, _P, _I,                                     # Y, Z, dgoal, dg_stride
        _P, _P, _P, _P,                                     # ei, ej, epar, rowptr
        _P, _P, _I,                                         # codes, slot, n_codes
        _P,                                                 # H
        _I, _I, _I, _I,                                     # B, N, D, E
        _I, _P,                                             # device, stream
    ],
    "graphik_edge_shape": [
        _I, _I, _I, _I, _I, _I, _I,                         # B, N, D, E, dg_stride, hess, device
        _P,                                                 # info (7 int32)
    ],
    "graphik_sym_eigh": [
        _P, _P, _P, _P,                                     # A, W, V, conv
        _I, _I, _I,                                         # B, n, is_double
        _P,                                                 # stream
    ],
    "graphik_spd_solve": [
        _P, _P, _P,                                         # A, b, x
        _I, _I, _I,                                         # B, m, is_double
        _P,                                                 # stream
    ],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libgraphik_tpu_torch_{h.hexdigest()[:16]}.so")


def compile_library(sources, so, extra_flags=()) -> str:
    """Compile `sources`, each by its own nvcc process (all started
    together), and link them into the shared library `so`; returns nvcc's
    output (ptxas register, shared-memory and spill counts of every kernel)
    and raises when a step fails."""
    nvcc = _nvcc()
    tag = f"{so}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in sources]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([nvcc, "-shared", "-o", f"{tag}.tmp", *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    os.replace(f"{tag}.tmp", so)
    return "".join(logs)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile csrc/*.cu if this source hash has no library yet; load it.

    nvcc's output (ptxas register, shared-memory and spill counts of every
    kernel) is kept beside the library as <lib>.log.
    """
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        log = ""
        try:
            log = compile_library(_sources(), so)
        except RuntimeError as e:
            log = str(e)
            raise
        finally:
            with open(so + ".log", "w") as f:
                f.write(log)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
