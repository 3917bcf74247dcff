"""The port covers the JAX package's public API.

Walks the public modules of graphik_tpu and, for every public function and
class defined there, asserts that graphik_tpu_torch has its counterpart:
the same name in the same module, every parameter of a function or method,
and every public attribute (dataclass fields included) of a class. The only
gaps allowed are listed below, each with its reason; a JAX parameter that
the port replaces names its replacement, which must then be in the port's
signature.
"""

import dataclasses
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import graphik_tpu
import graphik_tpu.solvers.riemannian as jriem
import graphik_tpu_torch
from graphik_tpu_torch.solvers import riemannian as triem

# JAX module -> the port's module of another name
MODULE_MAP = {
    "ops.tr_pallas": "ops.tr_solve",  # the fused TR solve: a CUDA kernel, not Pallas
}
# (JAX module, name) -> the port's name of another name
NAME_MAP = {
    ("ops.tr_pallas", "solve_tr_pallas"): "solve_tr_reference",  # and solve_tr_cuda, same signature
}
# JAX modules the port leaves out
SKIP_MODULES = {
    "ops.jacobi": "Jacobi eigh sweeps: a TPU workaround for XLA's eigh; the port's eigendecompositions "
                  "run on its own kernel, ops/eigh.py::sym_eigh",
    "ops.subspace": "subspace iteration: a TPU workaround for XLA's eigh",
    "utils.cache": "JAX's persistent compilation cache; the port compiles nothing with XLA",
}
# (JAX module, name) the port leaves out
SKIP_NAMES = {
    ("ops.linalg", "chol_unrolled"):
        "the clamped-pivot Cholesky: ported, with its two substitutions, as one function, "
        "ops/linalg.py::spd_solve (K6)",
    ("ops.linalg", "chol_solve_unrolled"):
        "its substitutions: ported inside ops/linalg.py::spd_solve (K6)",
    ("ops.linalg", "spd_solve_unrolled"):
        "ported as ops/linalg.py::spd_solve (K6, the LM's step), under the port's name",
    ("ops.linalg", "chol_blocked"): "blocked Cholesky, a TPU workaround",
    ("ops.linalg", "tri_lower_inv_blocked"): "blocked triangular inverse, a TPU workaround",
    ("ops.linalg", "mm_unrolled"): "unrolled matmul, a TPU dispatch-latency workaround",
}
# (JAX module, class, attribute) the port leaves out
SKIP_ATTRS = {
    ("solvers.riemannian", "TRParams", "tile"): "the Pallas kernel's VMEM lane tile",
}
# JAX parameter -> (the port's parameter that replaces it, or None, reason)
PARAM_MAP = {
    "key": ("generator", "a torch.Generator replaces JAX's PRNG key"),
    "axis_name": (None, "the port's mesh is a list of devices, with no named axis"),
    "eigh_sweeps": (None, "the Jacobi eigh's sweep count (ops/jacobi.py, a TPU workaround)"),
    "subspace_iters": (None, "the subspace iteration's count (ops/subspace.py, a TPU workaround)"),
    "unroll": (None, "unrolls a loop for the TPU; the port's loop is eager"),
    "block": (None, "the blocked TPU factorisation's block size"),
    "tile": (None, "the Pallas kernel's VMEM lane tile"),
    "interpret": (None, "Pallas's interpret mode; the port picks the plain version by device"),
}
# per function, JAX parameter -> (replacement or None, reason)
FUNC_PARAM_MAP = {
    ("parallel.distributed", "initialize"): {
        "coordinator_address": ("init_method", "torch.distributed's rendezvous URL"),
        "num_processes": ("world_size", "the process group's size"),
        "process_id": ("rank", "the process's rank"),
        "local_device_ids": ("device", "one device a process"),
    },
    ("solvers.riemannian", "generate_initialization"): {
        "method": (None, "selects the TPU 'subspace' init; the port has the 'eigh' method"),
        "rank": (None, "the 'subspace' init's rank"),
    },
}
# (JAX module, class, field) -> {JAX value: the port's value}
VALUE_MAP = {
    ("solvers.riemannian", "TRParams", "backend"): {"pallas": "kernel", "dense": "dense",
                                                    "edge": "edge"},
}


def _modules(pkg):
    out = {"": pkg}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        rel = m.name[len(pkg.__name__) + 1:]
        if not any(part.startswith("_") for part in rel.split(".")):
            out[rel] = importlib.import_module(m.name)
    return out


def _public(mod):
    """Functions and classes defined in mod, by name."""
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


def _params(f):
    return list(inspect.signature(f).parameters)


def _attrs(cls):
    names = {k for k in dir(cls) if not k.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


def _function(obj):
    obj = obj.__func__ if isinstance(obj, (classmethod, staticmethod)) else obj
    return obj if inspect.isfunction(obj) else None


JAX_MODULES = _modules(graphik_tpu)
PORT_MODULES = _modules(graphik_tpu_torch)


def _missing_params(mod, fname, jf, tf):
    """JAX parameters of jf the port's tf neither has nor replaces."""
    have = _params(tf)
    allowed = dict(PARAM_MAP, **FUNC_PARAM_MAP.get((mod, fname), {}))
    missing = []
    for p in _params(jf):
        if p in have:
            continue
        repl = allowed.get(p)
        if repl is None or (repl[0] is not None and repl[0] not in have):
            missing.append(p)
    return missing


def _gaps(mod):
    """Everything of JAX module `mod` the port lacks, past the lists."""
    port = PORT_MODULES.get(MODULE_MAP.get(mod, mod))
    if port is None:
        return [f"module {mod}"]
    gaps = []
    for name, jv in sorted(_public(JAX_MODULES[mod]).items()):
        if (mod, name) in SKIP_NAMES:
            continue
        tv = getattr(port, NAME_MAP.get((mod, name), name), None)
        if tv is None:
            gaps.append(f"{mod}.{name}")
            continue
        if inspect.isfunction(jv):
            gaps += [f"{mod}.{name}({p})" for p in _missing_params(mod, name, jv, tv)]
            continue
        for attr in sorted(_attrs(jv)):
            if (mod, name, attr) in SKIP_ATTRS:
                continue
            if attr not in _attrs(tv):
                gaps.append(f"{mod}.{name}.{attr}")
                continue
            jf = _function(inspect.getattr_static(jv, attr, None))
            tf = _function(inspect.getattr_static(tv, attr, None))
            if jf is not None and tf is not None:
                gaps += [f"{mod}.{name}.{attr}({p})"
                         for p in _missing_params(mod, f"{name}.{attr}", jf, tf)]
    return gaps


@pytest.mark.parametrize("mod", sorted(m for m in JAX_MODULES if m not in SKIP_MODULES),
                         ids=lambda m: m or "graphik_tpu")
def test_module_covered(mod):
    assert _gaps(mod) == []


def test_exclusions_are_needed():
    """Every listed gap is one: the JAX package has the name or parameter,
    the port does not."""
    for mod in SKIP_MODULES:
        assert mod in JAX_MODULES and mod not in PORT_MODULES, mod
    for mod, name in SKIP_NAMES:
        assert name in _public(JAX_MODULES[mod]), (mod, name)
        assert not hasattr(PORT_MODULES[mod], name), (mod, name)
    for mod, cls, attr in SKIP_ATTRS:
        assert attr in _attrs(getattr(JAX_MODULES[mod], cls)), (mod, cls, attr)
        assert attr not in _attrs(getattr(PORT_MODULES[mod], cls)), (mod, cls, attr)
    for (mod, fname), params in FUNC_PARAM_MAP.items():
        jf, tf = getattr(JAX_MODULES[mod], fname), getattr(PORT_MODULES[mod], fname)
        for p, (repl, _) in params.items():
            assert p in _params(jf) and p not in _params(tf), (mod, fname, p)
    for mod, name in NAME_MAP:
        port = PORT_MODULES[MODULE_MAP.get(mod, mod)]
        assert not hasattr(port, name), (mod, name)


def test_trparams_backend_values_map():
    """The JAX package's TR backends under the port's names: its default
    "pallas" is the port's default "kernel", and the port's solve takes each
    mapped value (a step of UR10 at float32 on the CPU)."""
    values = VALUE_MAP[("solvers.riemannian", "TRParams", "backend")]
    assert values[jriem.TRParams().backend] == triem.TRParams().backend
    from graphik_tpu_torch.robots.library import load_ur10

    _, ps = load_ur10()
    rs = np.random.RandomState(0)
    Y0 = torch.tensor(rs.normal(size=(2, ps.N, 3)), dtype=torch.float32)
    D = torch.tensor(rs.uniform(0.5, 1.5, size=(ps.N, ps.N)), dtype=torch.float32)
    for port_value in values.values():
        out = triem.solve(Y0, D, *ps.masks(), params=triem.TRParams(maxiter=1, backend=port_value))
        assert out["iterations"].tolist() == [1, 1], port_value


@pytest.mark.parametrize("d", [2, 3, 4, 5])
def test_projection_takes_every_dimension(d):
    """manifold_proj takes any d, as the JAX package's does: its result is
    horizontal (Y^T P symmetric)."""
    rs = np.random.RandomState(d)
    Y, Z = (torch.from_numpy(x) for x in rs.normal(size=(2, 3, 8, d)))
    P = triem.manifold_proj(Y, Z)
    YtP = Y.transpose(-1, -2) @ P
    torch.testing.assert_close(YtP, YtP.transpose(-1, -2), rtol=0, atol=1e-9)
