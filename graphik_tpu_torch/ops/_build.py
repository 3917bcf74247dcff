"""Build and load the port's CUDA kernels.

The sources under graphik_tpu_torch/csrc/ have a plain C interface; on first
use they are compiled by nvcc for sm_90a into one shared library under
<repo>/build/graphik_tpu_torch/ (keyed by a hash of the sources and flags,
so an edit rebuilds) and loaded with ctypes. Nothing here runs at import.
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
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Argument types of each C entry point, in the order of csrc/*.cu.
_SIGNATURES = {
    "graphik_tr_solve": [
        _P, _P, _I,                                         # Y0, dgoal, dg_stride
        _P, _P, _P, _P, _P,                                 # ei, ej, epar, rowptr, inc
        _P, _P, _P, _P, _P,                                 # Yout, cost, gradnorm, iters, ninner
        _I, _I, _I, _I,                                     # B, N, D, E
        _I, _I, _I, _I,                                     # maxiter .. plateau_every
        _F, _F, _F, _F, _F, _F, _F, _F, _F, _F,             # mingradnorm .. res_tol
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


def library_path() -> str:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgraphik_tpu_torch_{h.hexdigest()[:16]}.so")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile csrc/*.cu if this source hash has no library yet; load it.

    nvcc's output (ptxas register and spill counts) is kept beside the
    library as <lib>.log.
    """
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
            capture_output=True, text=True,
        )
        with open(so + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
