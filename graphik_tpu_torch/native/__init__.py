"""The native (C++) float64 CPU oracle for the EDM-completion edge costs.

Port of graphik_tpu/native: the port's own copy of costgrd.cc, built on
first use with the system g++ (OpenMP where it links, else without) into
<repo>/build/graphik_tpu_torch/native/, keyed by a hash of the source, and
bound through ctypes. It is a reference to hold the port's plain float64
costs to (ops/edge.py, solvers/costs.py), not a path of the solver.

Public surface:
  available() -> bool                did the library build and load?
  edges_from_masks(...)              dense (N, N) masks -> COO edge arrays
  cost / cost_and_grad / hess        batched kernels over (B, N, d) float64
Inputs may be numpy arrays or torch tensors; outputs are numpy float64.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "costgrd.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "graphik_tpu_torch",
                         "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64 = ctypes.c_int64


def library_path() -> str:
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"costgrd-{key}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # compile to a name of this process, then publish atomically, so a
        # concurrent builder never loads a half-written file
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp", "-o", tmp, _SRC]
        errors = []
        for c in (cmd, [a for a in cmd if a != "-fopenmp"]):
            try:
                subprocess.run(c, check=True, capture_output=True, text=True)
                break
            except (subprocess.CalledProcessError, FileNotFoundError) as exc:
                errors.append(f"{exc}\n{getattr(exc, 'stderr', '')}")
        else:
            _build_error = "\n".join(errors)
            return None
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    common = [_f64p, _f64p, _i32p, _i32p, _f64p, _f64p, _f64p, _f64p, _f64p,
              _i64, _i64, _i64, _i64]
    lib.gtpu_cost.argtypes = common + [_f64p]
    lib.gtpu_cost.restype = None
    lib.gtpu_cost_and_grad.argtypes = common + [_f64p, _f64p]
    lib.gtpu_cost_and_grad.restype = None
    lib.gtpu_hess.argtypes = [_f64p] + common + [_f64p]
    lib.gtpu_hess.restype = None
    return lib


def _get() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if _build_error is None:
                _lib = _build()
            if _lib is None:
                raise RuntimeError(f"native build failed:\n{_build_error}")
        return _lib


def available() -> bool:
    try:
        _get()
        return True
    except (RuntimeError, OSError):
        return False


def _np(x, dtype=np.float64):
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype)


def edges_from_masks(omega, psi_L, psi_U, L_mask, U_mask) -> Tuple[np.ndarray, ...]:
    """Dense (N, N) masks -> upper-triangular COO edge arrays (ei, ej,
    omega_e, psil_e, psiu_e, lmask_e, umask_e) over every unordered pair
    where any of the three cost terms is active."""
    omega = _np(omega)
    active = (omega != 0) | (_np(L_mask) != 0) | (_np(U_mask) != 0)
    iu = np.triu_indices(omega.shape[-1], k=1)
    keep = active[iu]
    ei = iu[0][keep].astype(np.int32)
    ej = iu[1][keep].astype(np.int32)
    sel = lambda M: np.ascontiguousarray(_np(M)[ei, ej])
    return ei, ej, sel(omega), sel(psi_L), sel(psi_U), sel(L_mask), sel(U_mask)


def _prep(Y, dgoal, ei, ej, *edge_arrays):
    """The exact ABI the C++ kernels assume: contiguous float64 and int32
    arrays of consistent lengths, indices in range."""
    Y = _np(Y)
    squeeze = Y.ndim == 2
    if squeeze:
        Y = Y[None]
    B, N, d = Y.shape
    if d > 3:
        raise ValueError("native kernels support d <= 3")
    ei, ej = _np(ei, np.int32), _np(ej, np.int32)
    E = len(ei)
    if len(ej) != E or any(len(a) != E for a in edge_arrays):
        raise ValueError("edge arrays must all have the same length E")
    if E and (ei.max() >= N or ej.max() >= N or ei.min() < 0 or ej.min() < 0):
        raise ValueError("edge indices out of range for N")
    dgoal = np.ascontiguousarray(np.broadcast_to(_np(dgoal), (B, E)))
    return (Y, dgoal, ei, ej, B, N, d, E, squeeze) + tuple(_np(a) for a in edge_arrays)


def _ptr(a):
    return a.ctypes.data_as(_f64p)


def _call(fn, Y, dgoal_e, ei, ej, edge_arrays, outs, Z=None):
    """Run one entry point; outs names its outputs in order: "f" a (B,)
    cost, "g" a (B, N, d) array."""
    (Y, dgoal_e, ei, ej, B, N, d, E, squeeze, *arrs) = _prep(Y, dgoal_e, ei, ej, *edge_arrays)
    lead = []  # gtpu_hess takes Z after Y
    if Z is not None:
        Z = _np(Z)
        Z = Z[None] if Z.ndim == 2 else Z
        if Z.shape != Y.shape:
            raise ValueError("Z must match Y's shape")
        lead = [_ptr(Z)]
    res = [np.empty((B,) if o == "f" else (B, N, d), np.float64) for o in outs]
    fn(_ptr(Y), *lead, _ptr(dgoal_e), ei.ctypes.data_as(_i32p), ej.ctypes.data_as(_i32p),
       *[_ptr(a) for a in arrs], B, N, d, E, *[_ptr(r) for r in res])
    return [r[0] if squeeze else r for r in res]


def cost(Y, dgoal_e, ei, ej, omega_e, psil_e, psiu_e, lmask_e, umask_e):
    """Batched cost f (B,), or a scalar for one (N, d) instance."""
    return _call(_get().gtpu_cost, Y, dgoal_e, ei, ej,
                 (omega_e, psil_e, psiu_e, lmask_e, umask_e), "f")[0]


def cost_and_grad(Y, dgoal_e, ei, ej, omega_e, psil_e, psiu_e, lmask_e, umask_e):
    """Batched (f (B,), Euclidean gradient (B, N, d))."""
    f, g = _call(_get().gtpu_cost_and_grad, Y, dgoal_e, ei, ej,
                 (omega_e, psil_e, psiu_e, lmask_e, umask_e), "fg")
    return f, g


def hess(Y, Z, dgoal_e, ei, ej, omega_e, psil_e, psiu_e, lmask_e, umask_e):
    """Batched Euclidean Hessian-vector product at Y along Z (B, N, d)."""
    return _call(_get().gtpu_hess, Y, dgoal_e, ei, ej,
                 (omega_e, psil_e, psiu_e, lmask_e, umask_e), "g", Z=Z)[0]
