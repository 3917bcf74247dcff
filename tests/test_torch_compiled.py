"""The compiled solver (api.make_solver, api.solve_ik_jit,
parallel.make_restart_solver; utils/compiled.py) on the CPU: it runs every
stage eagerly there, so its results are solve_ik's bit for bit, and they
match the JAX package's jitted solvers on the same goals. Plus what makes
its stages capturable on a card: the EdgeProblem and the kernel tables
built once, no tensor made from host data once a stage has run, and the
planar joint recovery's rigid fit in closed form (no SVD)."""

import gc

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu import api as japi
from graphik_tpu.parallel.mesh import summarize as jsummarize
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import local as jlocal
from graphik_tpu.solvers.riemannian import TRParams as JTRParams
from graphik_tpu.utils import dgp as jdgp
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.ops import tr_solve as ttr
from graphik_tpu_torch.parallel import mesh as tmesh
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import local as tlocal
from graphik_tpu_torch.solvers import riemannian as triem
from graphik_tpu_torch.solvers.riemannian import TRParams as TTRParams
from graphik_tpu_torch.utils import compiled
from graphik_tpu_torch.utils import dgp as tdgp

torch.set_num_threads(1)
CPU = torch.device("cpu")


def robots(name):
    """(JAX template and structure, port structure)."""
    if name == "ur10":
        return jlib.load_ur10(), tlib.load_ur10()[1]
    return jlib.load_planar_chain(6, limits=np.pi / 2), tlib.load_planar_chain(6, limits=np.pi / 2)[1]


def goals(tpl, seed, B):
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee]).astype(np.float32)


def kwargs(maxiter=30):
    return dict(params=TTRParams.production(maxiter=maxiter, maxinner=24),
                polish_params=tlocal.LocalParams(maxiter=5, tol_grad=1e-8), smooth_iters=2)


def assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("robot", ["ur10", "planar6"])
def test_compiled_entry_points_equal_solve_ik(robot):
    """On CPU tensors the compiled solver is solve_ik, bit for bit: called
    whole, stage by stage, twice, and from a given Y_init."""
    (jt, _), tps = robots(robot)
    T = torch.from_numpy(goals(jt, 3, 6))
    kw = kwargs()
    ref = tapi.solve_ik(tps, T, **kw)
    solver = tapi.make_solver(tps, **kw)
    assert_same(solver(T), ref)
    assert_same(tapi.solve_ik_jit(tps, **kw)(T), ref)
    D, Y0 = solver.prepare(T)
    assert_same(solver.finish(solver.solve(Y0, D), T), ref)
    assert solver.graphs.graphs == {}  # nothing is captured on the CPU
    Y_init = ref["Y"][0]
    assert_same(tapi.solve_ik_jit(tps, Y_init=Y_init, **kw)(T),
                tapi.solve_ik(tps, T, Y_init=Y_init, **kw))


def test_restart_solver_compiled_equals_eager():
    """make_restart_solver's compiled solver against the eager
    RestartSolver (solve_ik_restarts' own) from the same draws."""
    _, tps = robots("ur10")
    T = torch.from_numpy(goals(jlib.load_ur10()[0], 4, 5))
    kw = kwargs(maxiter=20)
    comp = tmesh.make_restart_solver(tps, n_restarts=3, **kw)(T, torch.Generator().manual_seed(7))
    eager = tmesh.RestartSolver(tps, n_restarts=3, **kw)(T, torch.Generator().manual_seed(7))
    assert_same(comp, eager)
    assert set(comp) == set(eager) and "restart_index" in comp


@pytest.mark.parametrize("robot", ["ur10", "planar6"])
def test_compiled_matches_jax(robot):
    """solve_ik_jit and make_solver against the JAX package's solve_ik_jit
    and make_solver on 16 float32 goals with the bench parameters: the same
    keys and shapes, finite outputs, and success counts within 3 of JAX's
    (tests/test_torch_api.py's tolerance). The JAX side runs its "edge"
    backend on planar6, as tests/test_torch_planar.py does."""
    (jt, jps), tps = robots(robot)
    T32 = goals(jt, 50 if robot == "ur10" else 51, 16)
    backend = "pallas" if robot == "ur10" else "edge"
    jkw = dict(params=JTRParams.production(maxiter=100, maxinner=24, backend=backend),
               polish_params=jlocal.LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2,
               dtype=jnp.float32)
    tkw = dict(params=TTRParams.production(maxiter=100, maxinner=24),
               polish_params=tlocal.LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    jouts = [japi.solve_ik_jit(jps, **jkw)(jnp.asarray(T32)),
             japi.make_solver(jps, **jkw)(jnp.asarray(T32))]
    touts = [tapi.solve_ik_jit(tps, **tkw)(torch.from_numpy(T32)),
             tapi.make_solver(tps, **tkw)(torch.from_numpy(T32))]
    assert_same(touts[0], touts[1])
    for jout, tout in zip(jouts, touts):
        assert set(tout) == set(jout)
        for k, v in tout.items():
            assert tuple(v.shape) == tuple(jout[k].shape), k
            assert bool(torch.isfinite(v.double()).all()), k
        n_j = round(float(jsummarize(jout)["success_rate"]) * 16)
        n_t = round(tapi.summarize(tout)["success_rate"] * 16)
        assert abs(n_t - n_j) <= 3, (n_t, n_j)


def test_solver_builds_edge_problem_and_tables_once(monkeypatch):
    """Two calls of one solver build its EdgeProblem and the TR solve's
    tables (the plain version's on the CPU) once; a second solver of the
    same structure finds both built."""
    _, tps = robots("ur10")
    T = torch.from_numpy(goals(jlib.load_ur10()[0], 5, 4))
    builds = {"edge_problem": 0, "tables": 0}

    def counted(name, fn):
        def wrapper(*args, **kw):
            builds[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(triem, "_EDGE_PROBLEMS", {})
    monkeypatch.setattr(tedge, "build_edge_problem",
                        counted("edge_problem", tedge.build_edge_problem))
    monkeypatch.setattr(ttr, "kernel_order_tables", counted("tables", ttr.kernel_order_tables))
    solver = tapi.make_solver(tps, **kwargs(maxiter=3))
    solver(T)
    solver(T)
    assert builds == {"edge_problem": 1, "tables": 1}
    tapi.make_solver(tps, **kwargs(maxiter=3))(T)
    assert builds == {"edge_problem": 1, "tables": 1}


def test_kernel_tables_are_cached_per_device():
    """ops/tr_solve.py::kernel_tables: one build per (EdgeProblem,
    device), the same tensors after, gone with the EdgeProblem."""
    _, tps = robots("ur10")
    ep = tedge.build_edge_problem(*tps.masks(), dim=3)
    first = ttr.kernel_tables(ep, CPU)
    again = ttr.kernel_tables(ep, "cpu")
    assert all(a is b for a, b in zip(first, again))
    assert len(first) == 9 and first[-1] == 0.0  # no anchors: the skip reaches nothing
    n = len(compiled._CACHE)
    del ep, first, again
    gc.collect()
    assert len(compiled._CACHE) == n - 1


def test_device_const_once_per_owner_key_dtype():
    _, tps = robots("ur10")
    a = compiled.device_const(tps, "check_L", tps.check_L, torch.float32, CPU)
    assert compiled.device_const(tps, "check_L", tps.check_L, torch.float32, "cpu") is a
    b = compiled.device_const(tps, "check_L", tps.check_L, torch.float64, CPU)
    assert b is not a and b.dtype == torch.float64
    np.testing.assert_array_equal(b.numpy(), tps.check_L)


def test_stages_make_no_tensor_from_host_data_once_run(monkeypatch):
    """What a CUDA graph cannot capture is a copy from pageable host
    memory: once the solve and finish stages have run, a second run makes
    no tensor from numpy or Python data (the UR10 table scene: the
    anchored solve and the augmented-Lagrangian polish; and planar6)."""
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.utils.environments import table_environment

    tpl = tlib.load_ur10()[0]
    made = []
    real_as_tensor, real_tensor = torch.as_tensor, torch.tensor

    def as_tensor(data, *a, **kw):
        if not isinstance(data, torch.Tensor):
            made.append(type(data).__name__)
        return real_as_tensor(data, *a, **kw)

    def tensor(data, *a, **kw):
        made.append(type(data).__name__)
        return real_tensor(data, *a, **kw)

    cases = [(ProblemStructure.from_template(tpl, obstacles=table_environment()),
              jlib.load_ur10()[0]),
             (robots("planar6")[1], jlib.load_planar_chain(6, limits=np.pi / 2)[0])]
    for ps, jt in cases:
        T = torch.from_numpy(goals(jt, 6, 3))
        solver = tapi.make_solver(ps, **kwargs(maxiter=3))
        D, Y0 = solver.prepare(T)
        solver.finish(solver.solve(Y0, D), T)
        monkeypatch.setattr(torch, "as_tensor", as_tensor)
        monkeypatch.setattr(torch, "tensor", tensor)
        solver.finish(solver.solve(Y0, D), T)
        monkeypatch.setattr(torch, "as_tensor", real_as_tensor)
        monkeypatch.setattr(torch, "tensor", real_tensor)
        assert made == [], (ps.N, made)


def test_stage_graphs_run_cpu_tensors_eagerly():
    graphs = compiled.StageGraphs()
    x = torch.arange(4.0)
    out = graphs.run("stage", lambda a, d: {"y": a + d["b"]}, x, {"b": x})
    assert torch.equal(out["y"], 2 * x) and graphs.graphs == {}


def test_sharded_solves_share_one_compiled_solver():
    """solve_ik_sharded keeps the compiled solver of its arguments (each
    device keeps its graphs): the same solver on the next call."""
    _, tps = robots("ur10")
    a = tmesh._sharded_solver(tps, TTRParams(maxiter=2), smooth_iters=2)
    assert tmesh._sharded_solver(tps, TTRParams(maxiter=2), smooth_iters=2) is a
    assert a.graphs is not None
    assert tmesh._sharded_solver(tps, TTRParams(maxiter=3), smooth_iters=2) is not a


def test_planar_rigid_fit_matches_jax():
    """dgp.best_fit_transform at d = 2 (closed form, no SVD) against the
    JAX package's SVD at float64, on point sets whose fit is a rotation
    and on mirrored ones (a reflection, which neither corrects): R within
    1e-12, t within 1e-12."""
    rs = np.random.RandomState(8)
    A = rs.normal(size=(64, 3, 2))
    B = rs.normal(size=(64, 3, 2))
    B[32:] = A[32:] @ np.array([[1.0, 0.0], [0.0, -1.0]])  # exact reflections
    jR, jt = jdgp.best_fit_transform(jnp.asarray(A), jnp.asarray(B))
    tR, tt = tdgp.best_fit_transform(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-12)
    assert (np.linalg.det(tR.numpy())[32:] < 0).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_planar_joint_recovery_matches_jax(dtype):
    """The sync-free planar joint recovery against the JAX package's (SVD)
    on planar6 and planar10 from noisy and from mirrored node positions
    (the solver's Y is defined up to a reflection): within 1e-9 at float64
    and 2e-4 at float32 (float32 angles of a 10-link chain, each a
    difference of atan2s of rounded positions)."""
    atol = 1e-9 if dtype == np.float64 else 2e-4
    for n in (6, 10):
        jt, jps = jlib.load_planar_chain(n, limits=np.pi / 2)
        tps = tlib.load_planar_chain(n, limits=np.pi / 2)[1]
        rs = np.random.RandomState(9 + n)
        q = rs.uniform(jt.lb[1:], jt.ub[1:], size=(32, n))
        pos = np.array(jps.realization(jnp.asarray(q)))
        pos = pos + 1e-2 * rs.normal(size=pos.shape)
        pos[16:, :, 1] *= -1.0
        pos = pos.astype(dtype)
        jq = np.asarray(jps.joint_variables(jnp.asarray(pos)))
        tq = tps.joint_variables(torch.from_numpy(pos)).numpy()
        d = np.abs(np.angle(np.exp(1j * (tq.astype(np.float64) - jq))))  # modulo 2 pi
        assert d.max() <= atol, d.max()
