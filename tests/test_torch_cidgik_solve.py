"""Port vs JAX package, dense CIDGIK solves (graphik_tpu/solvers/cidgik.py
solve_cidgik): both ADMM engines, the Newton-Schulz and eigh cone
projections, floor_mode with its base pose, residual-balancing rho, the
early stops (per lane on the vmap engine, for the whole batch on the split
engine), the table scene, a planar chain and one float32 case. Goals are FK
poses of seeded numpy draws. Tolerances: points, q, eig_sum and feas to 1e-6
and status equal at float64; the float32 case's are stated at its test."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import cidgik as jcd
from graphik_tpu.utils.environments import table_environment as jtable
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import cidgik as tcd
from graphik_tpu_torch.utils.environments import table_environment as ttable

torch.set_num_threads(1)

KEYS = ("q", "T_base", "points", "status", "eig_sum", "feas")
SHORT = dict(admm_iters=100, admm_iters_rest=50, max_outer=3)
# name -> (robot, floor_mode, engine, params, goals, seed)
CASES = {
    "split_ns": ("ur10", False, "split", dict(SHORT, cone_ns_iters=16, rho=10.0), 12, 0),
    "vmap_eigh": ("ur10", False, "vmap", dict(admm_iters=100, max_outer=3), 12, 0),
    "floor": ("ur10", True, "split", SHORT, 8, 1),
    # rho adaptation, and a tolerance that stops 5 of the 12 lanes early
    "vmap_adapt_tol": ("ur10", False, "vmap",
                       dict(admm_iters=300, max_outer=2, adapt_every=10, admm_tol=4e-3), 12, 0),
    # a tolerance that stops the whole batch after 250 of 600 iterations
    "split_tol": ("ur10", False, "split", dict(admm_iters=300, max_outer=2, admm_tol=0.05), 12, 0),
    "table": ("table", False, "split",
              dict(admm_iters=60, admm_iters_rest=30, max_outer=2, cone_ns_iters=16, rho=10.0),
              8, 2),
    "planar6": ("planar6", False, "split", SHORT, 8, 3),
}


def structures(robot):
    if robot == "planar6":
        return (jlib.load_planar_chain(6, limits=np.pi / 2)[1],
                tlib.load_planar_chain(6, limits=np.pi / 2)[1])
    obstacles = (jtable(), ttable()) if robot == "table" else (None, None)
    return (JPS.from_template(jlib.load_ur10()[0], obstacles=obstacles[0]),
            TPS.from_template(tlib.load_ur10()[0], obstacles=obstacles[1]))


def goals(tpl, B, seed):
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])


def port_case(name):
    """(port compiled problem, goals, port params, engine) of a case."""
    robot, floor, engine, kw, B, seed = CASES[name]
    jps, tps = structures(robot)
    T = goals(jps.template, B, seed)
    return tcd.compile_cidgik(tps, floor_mode=floor), T, tcd.CidgikParams(**kw), engine


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax(name):
    robot, floor, engine, kw, B, seed = CASES[name]
    jps = structures(robot)[0]
    comp, T, params, engine = port_case(name)
    out_j = jcd.solve_cidgik(jcd.compile_cidgik(jps, floor_mode=floor), jnp.asarray(T),
                             params=jcd.CidgikParams(**kw), engine=engine)
    out_j = {k: np.asarray(v) for k, v in out_j.items()}
    out_t = tcd.solve_cidgik(comp, torch.from_numpy(T), params=params, engine=engine)
    assert sorted(out_t) == sorted(KEYS)
    for k in KEYS:
        assert tuple(out_t[k].shape) == out_j[k].shape, (name, k)
    np.testing.assert_array_equal(out_t["status"].numpy(), out_j["status"], err_msg=name)
    for k in ("q", "T_base", "points", "eig_sum", "feas"):
        np.testing.assert_allclose(out_t[k].numpy(), out_j[k], rtol=0, atol=1e-6,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["floor", "split_ns"])
def test_floor_mode_base_pose(name):
    """floor_mode's base slides on the floor: T_base is the rigid pose of
    the solved base, the realigned points and goals map back through it to
    the solved ones, and q is extracted from the realigned points. Anchored
    problems return the identity."""
    comp, T, params, engine = port_case(name)
    T_goal = torch.from_numpy(T)
    out = tcd.solve_cidgik(comp, T_goal, params=params, engine=engine)
    Tb = out["T_base"]
    if name == "split_ns":
        assert torch.equal(Tb, torch.eye(4, dtype=Tb.dtype).expand_as(Tb))
        return
    ps = comp.structure
    P, Tg, Tb2 = tcd.realign_floor_solution(ps, out["points"], T_goal)
    assert torch.equal(Tb, Tb2) and Tg.shape == T_goal.shape
    R, p0 = Tb[:, :3, :3], Tb[:, :3, 3]
    eye = torch.eye(3, dtype=R.dtype).expand_as(R)
    torch.testing.assert_close(R @ R.transpose(1, 2), eye, rtol=0, atol=1e-12)
    back = P @ R.transpose(1, 2) + p0[:, None]
    keep = [i for i in range(ps.N) if i not in (ps.idx_x, ps.idx_y)]
    torch.testing.assert_close(back[:, keep], out["points"][:, keep], rtol=0, atol=1e-12)
    torch.testing.assert_close(Tb[:, None] @ Tg, T_goal, rtol=0, atol=1e-12)
    torch.testing.assert_close(out["q"], ps.joint_variables(P, Tg), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["vmap_adapt_tol", "split_tol"])
def test_early_stops_took_effect(name):
    """admm_tol stops some lanes (vmap engine) or the whole batch (split
    engine) early: against admm_tol = 0, the stopped lanes differ and, on
    the vmap engine, the others are bitwise unchanged."""
    comp, T, params, engine = port_case(name)
    tcd.solve_cidgik.admm_steps = 0
    a = tcd.solve_cidgik(comp, torch.from_numpy(T), params=params, engine=engine)["points"]
    steps = tcd.solve_cidgik.admm_steps
    b = tcd.solve_cidgik(comp, torch.from_numpy(T), engine=engine,
                         params=dataclasses.replace(params, admm_tol=0.0))["points"]
    same = int((a == b).flatten(1).all(1).sum())
    if engine == "vmap":
        assert 0 < same < len(T), same
    else:
        assert same == 0 and steps < 2 * params.admm_iters, (same, steps)


def test_float32():
    """float32 UR10 at the production point (Newton-Schulz, rho = 10), short
    schedule: the port and the JAX package both in float32 on the CPU, status
    equal, points and eig_sum within 2e-4, feas within 1e-5, q within 2e-3
    (tools/cidgik_f32_spread.py puts the port's float32 within 2.4e-5 of
    its float64 in points and eig_sum on 16 goals at this budget)."""
    jps, tps = structures("ur10")
    T = goals(jps.template, 12, 4).astype(np.float32)
    kw = dict(admm_iters=200, admm_iters_rest=100, max_outer=3)
    out_j = jcd.solve_cidgik(jcd.compile_cidgik(jps), jnp.asarray(T),
                             params=jcd.CidgikParams.production(**kw))
    out_t = tcd.solve_cidgik(tcd.compile_cidgik(tps), torch.from_numpy(T),
                             params=tcd.CidgikParams.production(**kw))
    assert out_t["points"].dtype == torch.float32
    np.testing.assert_array_equal(out_t["status"].numpy(), np.asarray(out_j["status"]))
    for k, tol in (("points", 2e-4), ("eig_sum", 2e-4), ("feas", 1e-5), ("q", 2e-3)):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=0, atol=tol,
                                   err_msg=k)


def test_entry_points_default_to_the_card():
    """Numpy goals with no device go to the card and raise without one;
    device="cpu" runs them on the CPU; a torch tensor stays where it is."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    tps = tlib.load_ur10()[1]
    comp = tcd.compile_cidgik(tps)
    T = goals(jlib.load_ur10()[0], 2, 5)
    p = tcd.CidgikParams(admm_iters=5, max_outer=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcd.solve_cidgik(comp, T, params=p)
    anc = tps.goal_positions(torch.from_numpy(T))[:, comp.anchor_idx].numpy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcd.solve_nearest_point_sdp(comp, anc, np.zeros((2, comp.n_free, 3)), params=p)
    assert tcd.solve_cidgik(comp, T, params=p, device="cpu")["q"].device.type == "cpu"
    assert tcd.solve_cidgik(comp, torch.from_numpy(T), params=p)["q"].device.type == "cpu"
    with pytest.raises(ValueError, match="engine"):
        tcd.solve_cidgik(comp, T, params=p, device="cpu", engine="dense")
