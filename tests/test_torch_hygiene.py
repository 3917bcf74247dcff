"""Boundaries of the port: no JAX inside it, a lazy kernel build, and
wrappers that refuse what their kernel does not take."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.ops import tr_solve
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import riemannian as triem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.join(d, f)
    for d, _, files in os.walk(os.path.join(ROOT, "graphik_tpu_torch"))
    for f in files if f.endswith(".py")
) + [os.path.join(ROOT, "chip_smoke.py")]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "graphik_tpu"), (path, name)


def test_import_is_lazy_and_needs_no_nvcc():
    """Importing the kernel module builds nothing and needs no CUDA
    toolkit: the build module is loaded only at the first launch."""
    code = (
        "import sys\n"
        "import graphik_tpu_torch.ops.tr_solve, graphik_tpu_torch.api\n"
        "assert 'graphik_tpu_torch.ops._build' not in sys.modules\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


@pytest.fixture(scope="module")
def ur10_edge():
    _, ps = tlib.load_ur10()
    omega, psi_L, psi_U = ps.masks()
    ep = tedge.build_edge_problem(omega, psi_L, psi_U, dim=3)
    rs = np.random.RandomState(0)
    Y0 = torch.from_numpy(rs.normal(size=(4, ps.N, 3)).astype(np.float32))
    D = torch.from_numpy(rs.uniform(0.1, 1.0, size=(4, ps.N, ps.N)).astype(np.float32))
    return (omega, psi_L, psi_U), ep, Y0, D


def test_cpu_solve_launches_no_kernel(ur10_edge):
    masks, _, Y0, D = ur10_edge
    before = tr_solve.solve_tr_cuda.launches
    out = triem.solve(Y0, D, *masks, params=triem.TRParams(maxiter=2))
    assert tr_solve.solve_tr_cuda.launches == before
    assert out["Y"].device.type == "cpu"


def test_kernel_wrapper_refuses_cpu_tensors(ur10_edge):
    _, ep, Y0, D = ur10_edge
    with pytest.raises(ValueError, match="CUDA"):
        tr_solve.solve_tr_cuda(ep, Y0, ep.edge_values(D), maxiter=1)


def test_kernel_wrapper_refuses_float64(ur10_edge):
    _, ep, Y0, D = ur10_edge
    with pytest.raises(TypeError, match="float32"):
        tr_solve.solve_tr_cuda(ep, Y0.double(), ep.edge_values(D).double(), maxiter=1)


def test_wrappers_refuse_anchors(ur10_edge):
    masks, _, Y0, D = ur10_edge
    anchors = {"idx": np.array([3]), "centers": np.zeros((1, 3)), "psi_L": np.array([0.1]),
               "psi_U": np.array([0.0]), "L_mask": np.array([1.0]), "U_mask": np.array([0.0])}
    ep = tedge.build_edge_problem(*masks, dim=3, anchors=anchors)
    assert ep.A > 0
    dg = ep.edge_values(D)
    for fn in (tr_solve.solve_tr_cuda, tr_solve.solve_tr_reference, tr_solve.solve_tr):
        with pytest.raises(NotImplementedError, match="slice 2"):
            fn(ep, Y0, dg, maxiter=1)


def test_obstacles_raise():
    tpl, ps = tlib.load_ur10()
    with pytest.raises(NotImplementedError, match="obstacles: slice 2"):
        ps.add_spherical_obstacle(np.array([0.5, 0.0, 0.5]), 0.2)
    from graphik_tpu_torch.graphs.problem import ProblemStructure

    with pytest.raises(NotImplementedError, match="obstacles: slice 2"):
        ProblemStructure.from_template(tpl, obstacles=[(np.zeros(3), 0.1)])
