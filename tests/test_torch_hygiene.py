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
) + [os.path.join(ROOT, f) for f in ("chip_smoke.py", "tools/torch_distributed_worker.py",
                                      "tools/torch_edge_bench.py", "tools/torch_eigh_bench.py",
                                      "tools/torch_spd_bench.py", "tools/kernel_trees.py",
                                      "tools/tr_f64_spread.py",
                                      "tools/torch_f64_card_cpu.py",
                                      "tools/card_cpu_stages.py",
                                      "tools/torch_prepare_spread.py",
                                      "tools/torch_position_probe.py",
                                      "examples/torch_riemannian_example.py",
                                      "examples/torch_cidgik_example.py")]


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


# calls whose string arguments name a file or directory to read
_PATH_CALLS = {"join", "open", "Path", "exists", "isfile", "isdir", "listdir", "glob", "load",
               "loadtxt", "read_text", "abspath", "realpath"}


def _names_jax_tree(node):
    """Whether a string constant inside `node` names the JAX package's
    directory (graphik_tpu, not graphik_tpu_torch)."""
    return any(isinstance(c, ast.Constant) and isinstance(c.value, str)
               and any(part == "graphik_tpu" for part in c.value.replace("\\", "/").split("/"))
               for c in ast.walk(node))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_path_into_the_jax_package(path):
    """No port module (nor chip_smoke.py) builds a path into graphik_tpu/:
    no call that opens, joins or lists paths takes a string naming it, and
    no string is the bare directory name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and node.value == "graphik_tpu":
            raise AssertionError(f"{path}:{node.lineno}: the JAX package's directory name")
        if isinstance(node, ast.Call):
            fn = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(node.func, "id", "")
            if fn in _PATH_CALLS:
                args = [*node.args, *(k.value for k in node.keywords)]
                assert not any(_names_jax_tree(a) for a in args), (path, node.lineno)


def test_robot_specs_are_the_jax_packages_byte_for_byte():
    """graphik_tpu_torch/robots/specs/ holds the port's own copy of every
    spec of graphik_tpu/robots/specs/, each file byte for byte the same,
    and the library reads the port's copy."""
    mine = os.path.join(ROOT, "graphik_tpu_torch", "robots", "specs")
    theirs = os.path.join(ROOT, "graphik_tpu", "robots", "specs")
    assert os.path.samefile(tlib.SPEC_DIR, mine)
    names = sorted(os.listdir(theirs))
    assert names and sorted(os.listdir(mine)) == names
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


def test_robot_library_works_without_the_jax_package(tmp_path):
    """A copy of graphik_tpu_torch alone, in a directory with nothing else
    of the repo, loads every robot of its library."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "graphik_tpu_torch"), tmp_path / "graphik_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import os\n"
        "from graphik_tpu_torch.robots import library as lib\n"
        "assert lib.SPEC_DIR.startswith(os.getcwd()), lib.SPEC_DIR\n"
        "for load in (lib.load_ur10, lib.load_kuka, lib.load_kuka_lwr, lib.load_schunk_lwa4d,\n"
        "             lib.load_schunk_lwa4p, lib.load_panda, lib.load_panda_truncated,\n"
        "             lib.load_jaco, lib.load_tree5):\n"
        "    tpl, ps = load()\n"
        "    assert ps.N > tpl.n\n"
        "try:\n"
        "    import graphik_tpu\n"
        "    raise AssertionError('the JAX package is importable here')\n"
        "except ModuleNotFoundError:\n"
        "    pass\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, check=True, timeout=120)


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
    """With anchors, the TR kernel's wrapper still refuses CPU tensors, and
    the plain version and the dispatcher take them on the CPU."""
    masks, _, Y0, D = ur10_edge
    anchors = {"idx": np.array([3]), "centers": np.zeros((1, 3)), "psi_L": np.array([0.1]),
               "psi_U": np.array([0.0]), "L_mask": np.array([1.0]), "U_mask": np.array([0.0])}
    ep = tedge.build_edge_problem(*masks, dim=3, anchors=anchors)
    assert ep.A > 0
    dg = ep.edge_values(D)
    with pytest.raises(ValueError, match="CUDA"):
        tr_solve.solve_tr_cuda(ep, Y0, dg, maxiter=1)
    before = tr_solve.solve_tr_cuda.launches
    ref = tr_solve.solve_tr_reference(ep, Y0, dg, maxiter=1)
    out = tr_solve.solve_tr(ep, Y0, dg, maxiter=1)
    assert tr_solve.solve_tr_cuda.launches == before
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def test_kernel_wrapper_refuses_anchor_rows_over_the_build(ur10_edge):
    """A group of more anchor rows than a lane's 32-bit row masks hold
    (1024) raises before any launch: 1100 rows on one node."""
    masks, _, Y0, D = ur10_edge
    n = 1100
    anchors = {"idx": np.full(n, 3), "centers": np.zeros((n, 3)), "psi_L": np.full(n, 0.1),
               "psi_U": np.zeros(n), "L_mask": np.ones(n), "U_mask": np.zeros(n)}
    ep = tedge.build_edge_problem(*masks, dim=3, anchors=anchors)
    assert ep.A > 1024
    with pytest.raises(ValueError, match="anchor layout"):
        tr_solve.solve_tr_cuda(ep, Y0, ep.edge_values(D), maxiter=1)


def test_edge_kernel_wrappers_refuse_anchors(ur10_edge):
    """The K1/K2 wrappers take edge terms only: an EdgeProblem with anchors
    raises (JAX's Pallas wrappers drop them silently)."""
    masks, _, Y0, D = ur10_edge
    anchors = {"idx": np.array([3]), "centers": np.zeros((1, 3)), "psi_L": np.array([0.1]),
               "psi_U": np.array([0.0]), "L_mask": np.array([1.0]), "U_mask": np.array([0.0])}
    ep = tedge.build_edge_problem(*masks, dim=3, anchors=anchors)
    dg = ep.edge_values(D)
    with pytest.raises(ValueError, match="anchor"):
        tedge.cost_and_egrad_cuda(ep, Y0, dg)
    with pytest.raises(ValueError, match="anchor"):
        tedge.ehess_cuda(ep, Y0, Y0, dg)


def test_edge_kernel_wrappers_refuse_cpu_and_float64(ur10_edge):
    _, ep, Y0, D = ur10_edge
    dg = ep.edge_values(D)
    with pytest.raises(ValueError, match="CUDA"):
        tedge.cost_and_egrad_cuda(ep, Y0, dg)
    with pytest.raises(ValueError, match="CUDA"):
        tedge.ehess_cuda(ep, Y0, Y0, dg)
    with pytest.raises(TypeError, match="float32"):
        tedge.cost_and_egrad_cuda(ep, Y0.double(), dg.double())
    with pytest.raises(TypeError, match="float32"):
        tedge.ehess_cuda(ep, Y0, Y0.double(), dg)
    assert tedge.cost_and_egrad_cuda.launches == tedge.ehess_cuda.launches == 0


def test_obstacles_raise():
    """Obstacles compile on 3D robots and on planar robots (the anchored
    kernel at d = 2): nothing raises, and a planar obstacle node sits at
    its centre's first two coordinates."""
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.robots.templates import planar_from_links

    _, ps = tlib.load_ur10()
    assert ps.add_spherical_obstacle(np.array([0.5, 0.0, 0.5]), 0.2).n_obstacles == 1
    planar = planar_from_links([1.0, 1.0, 1.0])
    assert ProblemStructure.from_template(planar).N == 6
    ps_o = ProblemStructure.from_template(planar, obstacles=[(np.array([0.5, 2.0, 7.0]), 0.1)])
    assert ps_o.N == 7 and ps_o.n_obstacles == 1
    np.testing.assert_array_equal(ps_o.pos_fixed[-1], [0.5, 2.0])
