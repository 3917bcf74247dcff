"""Port vs JAX package: the finish stage at float64, and the whole main path
(make_solver with the bench parameters) at float32."""

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
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import local as tlocal
from graphik_tpu_torch.solvers.riemannian import TRParams as TTRParams

torch.set_num_threads(1)
ATOL = 1e-8


def _goals(tpl, seed, B):
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return q, np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])


@pytest.fixture(scope="module")
def finish_inputs():
    """Solved-looking node positions: FK of the goal configurations plus
    1 mm noise, with the goals' poses."""
    jt, jps = jlib.load_ur10()
    _, tps = tlib.load_ur10()
    q_true, T_goal = _goals(jt, 21, 6)
    Y = np.array(jps.realization(jnp.asarray(q_true)))
    Y = Y + 1e-3 * np.random.RandomState(22).normal(size=Y.shape)
    return jps, tps, Y, T_goal


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_joint_variables_and_realization(finish_inputs):
    jps, tps, Y, T_goal = finish_inputs
    jq = jps.joint_variables(jnp.asarray(Y), jnp.asarray(T_goal))
    tq = tps.joint_variables(torch.from_numpy(Y), torch.from_numpy(T_goal))
    close(tq, jq)
    q = np.array(jq)
    close(tps.realization(torch.from_numpy(q)), jps.realization(jnp.asarray(q)))
    # without the goal-pose correction
    close(tps.joint_variables(torch.from_numpy(Y)), jps.joint_variables(jnp.asarray(Y)))


def test_check_distance_limits(finish_inputs):
    jps, tps, Y, _ = finish_inputs
    for pos in (Y, Y * 1.3):  # the second set violates limits
        jv, jok = jps.check_distance_limits(jnp.asarray(pos))
        tv, tok = tps.check_distance_limits(torch.from_numpy(pos))
        close(tv, jv)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_pose_error(finish_inputs):
    jps, tps, Y, T_goal = finish_inputs
    q = np.array(jps.joint_variables(jnp.asarray(Y), jnp.asarray(T_goal)))
    je, jr = japi.pose_error(jps, jnp.asarray(q), jnp.asarray(T_goal))
    te, tr = tapi.pose_error(tps, torch.from_numpy(q), torch.from_numpy(T_goal))
    close(te, je)
    close(tr, jr)


def test_solve_local(finish_inputs):
    jps, tps, Y, T_goal = finish_inputs
    q = np.array(jps.joint_variables(jnp.asarray(Y), jnp.asarray(T_goal)))
    jo = jlocal.solve_local(jps, jnp.asarray(T_goal), jnp.asarray(q),
                            jlocal.LocalParams(maxiter=10, tol_grad=1e-8))
    to = tlocal.solve_local(tps, torch.from_numpy(T_goal), torch.from_numpy(q),
                            tlocal.LocalParams(maxiter=10, tol_grad=1e-8))
    close(to["q"], jo["q"])
    close(to["cost"], jo["cost"])
    np.testing.assert_array_equal(to["iterations"].numpy(), np.asarray(jo["iterations"]))


def test_polish_solution(finish_inputs):
    jps, tps, Y, T_goal = finish_inputs
    q = np.array(jps.joint_variables(jnp.asarray(Y), jnp.asarray(T_goal)))
    Tj, Tt = jnp.asarray(T_goal), torch.from_numpy(T_goal)
    jv, jok = jps.check_distance_limits(jps.realization(jnp.asarray(q)))
    je, jr = japi.pose_error(jps, jnp.asarray(q), Tj)
    params = jlocal.LocalParams(maxiter=10, tol_grad=1e-8)
    jout = japi.polish_solution(jps, jnp.asarray(q), Tj, je, jr, jv, jok, params=params)
    tout = tapi.polish_solution(
        tps, torch.from_numpy(q), Tt, torch.from_numpy(np.array(je)),
        torch.from_numpy(np.array(jr)), torch.from_numpy(np.array(jv)),
        torch.from_numpy(np.array(jok)), params=tlocal.LocalParams(maxiter=10, tol_grad=1e-8))
    for t, j in zip(tout[:4], jout[:4]):
        close(t, j)
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))


def test_make_solver_end_to_end_f32():
    """The main path on 32 UR10 goals at float32 with the bench parameters:
    the port's success count is within 3 of the JAX package's."""
    jt, jps = jlib.load_ur10()
    _, tps = tlib.load_ur10()
    _, T_goal = _goals(jt, 5, 32)
    T32 = T_goal.astype(np.float32)
    kw = dict(polish_params=jlocal.LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    jout = japi.make_solver(jps, params=JTRParams.production(maxiter=100, maxinner=24),
                            dtype=jnp.float32, **kw)(jnp.asarray(T32))
    kw["polish_params"] = tlocal.LocalParams(maxiter=10, tol_grad=1e-8)
    tout = tapi.make_solver(tps, params=TTRParams.production(maxiter=100, maxinner=24),
                            **kw)(torch.from_numpy(T32))
    assert set(tout) == set(jout)
    for k, v in tout.items():
        assert tuple(v.shape) == tuple(jout[k].shape), k
        assert bool(torch.isfinite(v.double()).all()), k
    assert tout["Y"].dtype == torch.float32
    n_j = round(float(jsummarize(jout)["success_rate"]) * 32)
    n_t = round(tapi.summarize(tout)["success_rate"] * 32)
    assert abs(n_t - n_j) <= 3, (n_t, n_j)


def test_random_goals_reproducible():
    _, tps = tlib.load_ur10()
    T1, q1 = tapi.random_goals(tps, (5,), torch.Generator().manual_seed(3), device="cpu")
    T2, q2 = tapi.random_goals(tps, (5,), torch.Generator().manual_seed(3), device="cpu")
    assert T1.shape == (5, 1, 4, 4) and q1.shape == (5, 6)
    assert torch.equal(T1, T2) and torch.equal(q1, q2)


SHORT = dict(params=TTRParams.production(maxiter=5, maxinner=24),
             polish_params=tlocal.LocalParams(maxiter=2, tol_grad=1e-8), smooth_iters=2)


def test_entry_points_default_to_the_card():
    """With no device, goals are made on the card and goals that carry no
    device (numpy) are solved there; without a card both raise."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, tps = tlib.load_ur10()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.random_goals(tps, (2,))
    T_goal = tapi.random_goals(tps, (2,), torch.Generator().manual_seed(4), device="cpu")[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.make_solver(tps, **SHORT)(T_goal.numpy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.solve_ik(tps, T_goal.numpy(), **SHORT)


def test_cpu_when_asked():
    """device="cpu" gives the draw the generator makes, and numpy goals on
    the CPU solve as CPU tensors do."""
    _, tps = tlib.load_ur10()
    T_goal, q = tapi.random_goals(tps, (3,), torch.Generator().manual_seed(5), device="cpu")
    u = torch.rand((3, 6), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    lb, ub = torch.from_numpy(tps.template.lb[1:]), torch.from_numpy(tps.template.ub[1:])
    assert q.device.type == "cpu" and torch.equal(q, lb + u * (ub - lb))
    T32 = T_goal.float()
    ref = tapi.make_solver(tps, **SHORT)(T32)
    for out in (tapi.make_solver(tps, device="cpu", **SHORT)(T32.numpy()),
                tapi.solve_ik(tps, T32.numpy(), device="cpu", **SHORT),
                tapi.solve_ik(tps, T32, **SHORT)):
        assert set(out) == set(ref)
        for k in ref:
            assert out[k].device.type == "cpu"
            assert torch.equal(out[k], ref[k]), k


def test_summarize_matches_jax():
    """api.summarize returns the JAX package's keys and values
    (parallel/mesh.py::summarize) on the same arrays, an even batch with
    ties so the median interpolates."""
    rs = np.random.RandomState(31)
    B = 64
    out = {
        "e_pos": 10.0 ** rs.uniform(-8, -1, size=B),
        "e_rot": 10.0 ** rs.uniform(-8, -1, size=B),
        "success": rs.rand(B) < 0.8,
        "iterations": rs.randint(10, 250, size=B).astype(np.int32),
    }
    ref = {k: float(v) for k, v in jsummarize({k: jnp.asarray(v) for k, v in out.items()}).items()}
    got = tapi.summarize({k: torch.from_numpy(v) for k, v in out.items()})
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=0, err_msg=k)
