"""The obstacle path of the port against the JAX package (mirrors
tests/test_anchored.py).

Scenes: UR10 with the 3 spheres of test_anchored.py, UR10 with the
100-sphere table (utils/environments.py), and a synthetic anchor set whose
lower and upper hinges are active at the inputs. Inputs are made with numpy
and handed to both packages. The kernel's own checks are in
test_torch_cuda.py (they need the card).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu import api as japi
from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.ops import edge as jedge
from graphik_tpu.ops.tr_pallas import solve_tr_pallas
from graphik_tpu.parallel.mesh import summarize as jsummarize
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import local as jlocal
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu.utils.environments import table_environment as jtable
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch import interop
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.ops import tr_solve
from graphik_tpu_torch.robots import kinematics as tkin
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import local as tlocal
from graphik_tpu_torch.solvers import riemannian as triem
from graphik_tpu_torch.utils import dgp as tdgp
from graphik_tpu_torch.utils.environments import table_environment as ttable

torch.set_num_threads(1)

OBS3 = [
    (np.array([0.5, 0.5, 0.5]), 0.25),
    (np.array([-0.5, 0.4, 0.8]), 0.2),
    (np.array([0.2, -0.6, 0.3]), 0.3),
]
PROD = dict(maxinner=32, plateau_every=16, plateau_rtol=1e-4)


def _scene(name):
    if name == "obs3":
        return OBS3, OBS3
    return jtable(), ttable()


@pytest.fixture(scope="module", params=["obs3", "table"])
def scenes(request):
    jt, _ = jlib.load_ur10()
    tt, _ = tlib.load_ur10()
    jobs, tobs = _scene(request.param)
    return JPS.from_template(jt, obstacles=jobs), TPS.from_template(tt, obstacles=tobs)


@pytest.fixture(scope="module")
def obs3():
    jt, _ = jlib.load_ur10()
    tt, _ = tlib.load_ur10()
    return JPS.from_template(jt, obstacles=OBS3), TPS.from_template(tt, obstacles=OBS3)


def _goals(tpl, seed, B):
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return q, np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])


def test_table_environment_equal():
    for (jc, jr), (tc, tr) in zip(jtable(), ttable(), strict=True):
        assert np.array_equal(jc, tc) and jr == tr
    assert len(ttable()) == 100


def test_structure_fields_equal(scenes):
    jps, tps = scenes
    assert tps.N == jps.N == 16 + jps.n_obstacles
    for f in dataclasses.fields(tps):
        a, b = getattr(tps, f.name), getattr(jps, f.name)
        if f.name == "template":
            continue
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif f.name == "obstacles":
            assert all(np.array_equal(c1, c2) and r1 == r2 for (c1, r1), (c2, r2) in zip(a, b))
        else:
            assert a == b, f.name
    assert [tps.idx_obs(k) for k in range(3)] == [jps.idx_obs(k) for k in range(3)]
    assert tps.clear_obstacles().N == jps.clear_obstacles().N == 16


def test_reduced_spec_equal(scenes):
    jps, tps = scenes
    js, ts = jps.reduced_spec(), tps.reduced_spec()
    assert ts.keys() == js.keys()
    for k in js:
        assert np.array_equal(np.asarray(ts[k]), np.asarray(js[k])), k
    assert len(ts["idx"]) == tps.n_obstacles * tps.n


def test_interop_roundtrip(scenes):
    """An obstacle structure carried from the JAX package through plain
    numpy fields compiles the same reduced problem."""
    jps, tps = scenes
    fields = {f.name: getattr(jps, f.name) for f in dataclasses.fields(jps)}
    fields["template"] = dataclasses.asdict(jps.template)
    moved = interop.structure_from_numpy(fields)
    assert moved.n_obstacles == tps.n_obstacles
    for (c1, r1), (c2, r2) in zip(moved.obstacles, tps.obstacles, strict=True):
        assert np.array_equal(c1, c2) and r1 == r2
    for k, v in moved.reduced_spec().items():
        assert np.array_equal(np.asarray(v), np.asarray(tps.reduced_spec()[k])), k


def test_reduced_instance_matches_jax(scenes):
    """instance(n_nodes=Nr) at float64: the anchored-obstacle fold gives the
    JAX package's bounds."""
    jps, tps = scenes
    Nr = tps.reduced_spec()["Nr"]
    _, T = _goals(jps.template, 3, 3)
    ji = jps.instance(jnp.asarray(T), smooth=True, n_nodes=Nr)
    ti = tps.instance(torch.from_numpy(T), smooth=True, n_nodes=Nr)
    for k in ("D_goal", "pos_anchor", "lb", "ub"):
        assert tuple(ti[k].shape) == ji[k].shape
        np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]), rtol=0, atol=1e-12, err_msg=k)


def test_reduced_smoothing_matches_full_graph(scenes):
    """The fold is exact: the reduced bounds equal the port's own full-graph
    smoothing on the reduced block (test_anchored.py:45-64)."""
    _, tps = scenes
    Nr = tps.reduced_spec()["Nr"]
    _, T = _goals(tps.template, 4, 2)
    full = tps.instance(torch.from_numpy(T), smooth=True)
    red = tps.instance(torch.from_numpy(T), smooth=True, n_nodes=Nr)
    for k in ("lb", "ub"):
        np.testing.assert_allclose(red[k].numpy(), full[k].numpy()[:, :Nr, :Nr], rtol=0, atol=1e-12)


def test_minplus_slices_agree(monkeypatch):
    """Slicing the min-plus product over the batch changes no value."""
    rs = np.random.RandomState(0)
    A = torch.from_numpy(rs.normal(size=(7, 5, 6)))
    B = torch.from_numpy(rs.normal(size=(6, 4)))
    whole = tdgp._minplus(A, B)
    monkeypatch.setattr(tdgp, "MINPLUS_ELEMS", 2 * 5 * 6 * 4)
    assert torch.equal(tdgp._minplus(A, B), whole)
    Bb = torch.from_numpy(rs.normal(size=(7, 6, 4)))
    monkeypatch.setattr(tdgp, "MINPLUS_ELEMS", 1 << 27)
    whole = tdgp._minplus(A, Bb)
    monkeypatch.setattr(tdgp, "MINPLUS_ELEMS", 1)
    assert torch.equal(tdgp._minplus(A, Bb), whole)


def test_linear_jacobians_match_jax():
    jt, _ = jlib.load_ur10()
    tt, _ = tlib.load_ur10()
    q = np.random.RandomState(5).uniform(jt.lb[1:], jt.ub[1:], size=(4, jt.n))
    ref = np.asarray(jkin.linear_jacobians(jt, jnp.asarray(q)))
    out = tkin.linear_jacobians(tt, torch.from_numpy(q)).numpy()
    assert out.shape == ref.shape == (4, jt.n + 1, 3, jt.n)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_obstacle_constraints_match_jax(obs3):
    jps, tps = obs3
    q = np.random.RandomState(6).uniform(jps.template.lb[1:], jps.template.ub[1:], size=(3, 6))
    idx, cen, rad = jlocal._obstacle_pairs(jps)
    for i in range(3):
        gj, Jj = jlocal._obstacle_g_and_jac(jps, jps.template, jnp.asarray(q[i]), idx, cen, rad)
        gt, Jt = tlocal._obstacle_g_and_jac(tps.template, torch.from_numpy(q[i]),
                                           *tlocal._obstacle_pairs(tps))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-12)
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=0, atol=1e-12)


def _synthetic_anchors(Y_ref):
    """Anchor rows on p1..p6 whose lower and upper hinges are both active
    near Y_ref (one configuration's node positions)."""
    idx, cen, pL, pU, Lm, Um = [], [], [], [], [], []
    for i in range(1, 7):
        for off, lo, hi in (((0.1, 0.0, 0.0), 0.3, 0.0), ((0.0, -0.2, 0.1), 0.25, 0.0),
                            ((0.9, 0.0, 0.0), 0.0, 0.6)):
            idx.append(i)
            cen.append(Y_ref[i] + np.asarray(off))
            pL.append(lo ** 2)
            pU.append(hi ** 2)
            Lm.append(float(lo > 0))
            Um.append(float(hi > 0))
    return {"Nr": 16, "idx": np.asarray(idx, np.int32), "centers": np.asarray(cen),
            "psi_L": np.asarray(pL), "psi_U": np.asarray(pU),
            "L_mask": np.asarray(Lm), "U_mask": np.asarray(Um)}


def _anchored_problem(name, B=8):
    """(masks over the robot nodes, anchor spec, Y0 f32, D_goal f32): goals
    from a RandomState seed, Y0 in the world frame near a second random
    configuration, so the anchor hinges meet the robot."""
    jt, ps = jlib.load_ur10()
    rs = np.random.RandomState(11)
    q = rs.uniform(jt.lb[1:], jt.ub[1:], size=(B, 6))
    q2 = rs.uniform(jt.lb[1:], jt.ub[1:], size=(B, 6))
    T = jkin.all_poses(jt, jnp.asarray(q))[:, jt.ee]
    Yw = np.array(ps.realization(jnp.asarray(q2)))
    if name == "synthetic":
        spec = _synthetic_anchors(Yw[0])
    else:
        spec = JPS.from_template(jt, obstacles=_scene(name)[0]).reduced_spec()
    om, pl, pu = ps.masks()
    D = np.array(ps.instance(T, smooth=False)["D_goal"], np.float32)
    Y0 = (Yw[:1] + 0.05 * rs.normal(size=Yw.shape)).astype(np.float32)
    return (om, pl, pu), spec, Y0, D


@pytest.mark.parametrize("name", ["obs3", "table", "synthetic"])
@pytest.mark.parametrize("res_tol", [0.0, 0.05])
def test_anchored_tr_one_step_matches_pallas(name, res_tol):
    """One anchored TR step of the plain version against the JAX Pallas
    kernel in interpret mode, at the tolerances of test_anchored.py:177-182."""
    masks, spec, Y0, D = _anchored_problem(name)
    jep = jedge.build_edge_problem(*masks, dim=3, anchors=spec)
    tep = tedge.build_edge_problem(*masks, dim=3, anchors=spec)
    assert tep.A == jep.A > 0 and (tep.a_nsel, tep.a_R) == (jep.a_nsel, jep.a_R)
    dg = np.array(jep.edge_values(jnp.asarray(D)))
    kw = dict(maxiter=1, res_tol=res_tol, **PROD)
    ref = solve_tr_pallas(jep, jnp.asarray(Y0), jnp.asarray(dg), interpret=True, **kw)
    out = tr_solve.solve_tr_reference(tep, torch.from_numpy(Y0), torch.from_numpy(dg), **kw)
    np.testing.assert_allclose(out["cost"].numpy(), np.asarray(ref["cost"]), rtol=3e-5, atol=1e-6)
    np.testing.assert_array_equal(out["num_inner"].numpy(), np.asarray(ref["num_inner"]))
    np.testing.assert_array_equal(out["iterations"].numpy(), np.asarray(ref["iterations"]))


def test_synthetic_anchors_are_active():
    """The synthetic scene's hinges contribute to the cost at Y0 (both
    kinds), so the parity tests above exercise the anchored terms."""
    masks, spec, Y0, D = _anchored_problem("synthetic")
    ep = tedge.build_edge_problem(*masks, dim=3, anchors=spec)
    ep0 = tedge.build_edge_problem(*masks, dim=3)
    Y, dg = torch.from_numpy(Y0).double(), ep.edge_values(torch.from_numpy(D).double())
    assert bool((tedge.cost(ep, Y, dg) - tedge.cost(ep0, Y, dg) > 1e-3).all())
    adiff, a1, a2 = tedge._anchor_terms(ep, Y)
    assert bool((a1 > 0).any()) and bool((a2 > 0).any())


@pytest.mark.parametrize("route", ["reference", "dense"])
@pytest.mark.parametrize("name", ["obs3", "synthetic"])
def test_anchored_tr_f64_against_dense(name, route):
    """At float64 the anchored port - the plain kernel-order version called
    directly ("reference"), or riemannian.solve's "dense" backend - follows
    the JAX dense solver lane for lane up to the 5-iteration horizon of the
    f64 parity tests."""
    masks, spec, Y0, D = _anchored_problem(name)
    p = dict(maxiter=5, **PROD)
    ref = jriem.solve(jnp.asarray(Y0, jnp.float64), jnp.asarray(D, jnp.float64), *masks,
                      params=jriem.TRParams(backend="dense", **p), anchors=spec)
    Y, Dg = torch.from_numpy(Y0).double(), torch.from_numpy(D).double()
    if route == "reference":
        ep = tedge.build_edge_problem(*masks, dim=3, anchors=spec)
        out = tr_solve.solve_tr_reference(ep, Y, ep.edge_values(Dg), **p)
    else:
        out = triem.solve(Y, Dg, *masks, params=triem.TRParams(backend=route, **p), anchors=spec)
    np.testing.assert_array_equal(out["iterations"].numpy(), np.asarray(ref["iterations"]))
    np.testing.assert_array_equal(out["num_inner"].numpy(), np.asarray(ref["num_inner"]))
    np.testing.assert_allclose(out["Y"].numpy(), np.asarray(ref["Y"]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["cost"].numpy(), np.asarray(ref["cost"]), rtol=1e-9, atol=1e-14)


def test_solve_local_with_obstacles(obs3):
    """The augmented-Lagrangian LM at float64 against the JAX package's."""
    jps, tps = obs3
    q0, T = _goals(jps.template, 7, 6)
    q0 = q0 + 0.2 * np.random.RandomState(8).normal(size=q0.shape)
    kw = dict(maxiter=5, al_iters=2, tol_grad=1e-8)
    jo = jlocal.solve_local(jps, jnp.asarray(T), jnp.asarray(q0), jlocal.LocalParams(**kw))
    to = tlocal.solve_local(tps, torch.from_numpy(T), torch.from_numpy(q0), tlocal.LocalParams(**kw))
    np.testing.assert_allclose(to["q"].numpy(), np.asarray(jo["q"]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(to["cost"].numpy(), np.asarray(jo["cost"]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(to["max_violation"].numpy(), np.asarray(jo["max_violation"]),
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(to["iterations"].numpy(), np.asarray(jo["iterations"]))


def test_realization_and_limits_at_full_width(scenes):
    """realization and check_distance_limits cover the obstacle nodes: a
    robot point inside an obstacle is flagged as in the JAX package."""
    jps, tps = scenes
    q = np.random.RandomState(9).uniform(jps.template.lb[1:], jps.template.ub[1:], size=(5, 6))
    pos_j = np.asarray(jps.realization(jnp.asarray(q)))
    pos_t = tps.realization(torch.from_numpy(q)).numpy()
    assert pos_t.shape == (5, tps.N, 3)
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-12)
    # move the first obstacle onto p3 of instance 0
    pos = pos_t.copy()
    pos[0, tps.idx_obs(0)] = pos[0, 3]
    jv, jok = jps.check_distance_limits(jnp.asarray(pos))
    tv, tok = tps.check_distance_limits(torch.from_numpy(pos))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not bool(tok[0])


def test_solve_reduced_pads_obstacles(obs3):
    jps, tps = obs3
    Nr = tps.reduced_spec()["Nr"]
    masks, _, Y0, D = _anchored_problem("obs3", B=2)
    sol = tapi.solve_reduced(tps, torch.from_numpy(Y0).double(), torch.from_numpy(D).double(),
                             *tps.masks(), params=triem.TRParams(maxiter=2))
    assert tuple(sol["Y"].shape) == (2, tps.N, 3)
    for k, (c, _) in enumerate(OBS3):
        assert np.array_equal(sol["Y"][:, Nr + k].numpy(), np.broadcast_to(c, (2, 3)))


def test_solve_ik_with_y_init_matches_jax(obs3):
    """A fixed Y_init on the 3-obstacle scene gives the same Y in both
    packages at float64 (maxiter=3)."""
    jps, tps = obs3
    _, T = _goals(jps.template, 12, 4)
    Y_init = np.array(jps.realization(jnp.zeros(6)))
    Y_init = Y_init + 0.05 * np.random.RandomState(13).normal(size=Y_init.shape)
    params = dict(maxiter=3, maxinner=32)
    jo = japi.solve_ik(jps, jnp.asarray(T), params=jriem.TRParams(backend="dense", **params),
                       Y_init=jnp.asarray(Y_init), polish=False)
    to = tapi.solve_ik(tps, torch.from_numpy(T), params=triem.TRParams(**params),
                       Y_init=torch.from_numpy(Y_init), polish=False)
    assert tuple(to["Y"].shape) == (4, tps.N, 3)
    np.testing.assert_allclose(to["Y"].numpy(), np.asarray(jo["Y"]), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(to["iterations"].numpy(), np.asarray(jo["iterations"]))
    np.testing.assert_allclose(to["q"].numpy(), np.asarray(jo["q"]), rtol=0, atol=1e-8)


def test_make_solver_end_to_end_f32(obs3):
    """The obstacle path on 8 goals at float32 with the table cell's TR
    parameters: successful lanes keep every obstacle clear, and the success
    count is within 1 goal of the JAX package's on the same goals."""
    jps, tps = obs3
    _, T = _goals(jps.template, 3, 8)
    T32 = T.astype(np.float32)
    jout = japi.make_solver(
        jps, params=jriem.TRParams.production(maxiter=150, maxinner=32), dtype=jnp.float32,
        polish_params=jlocal.LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2,
    )(jnp.asarray(T32))
    solver = tapi.make_solver(
        tps, params=triem.TRParams.production(maxiter=150, maxinner=32),
        polish_params=tlocal.LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    tout = solver(torch.from_numpy(T32))
    assert set(tout) == set(jout)
    for k, v in tout.items():
        assert tuple(v.shape) == tuple(jout[k].shape), k
        assert bool(torch.isfinite(v.double()).all()), k
    ok = tout["success"].numpy()
    assert ok.any()
    pos = tps.realization(tout["q"]).numpy()
    for c, r in OBS3:
        d = np.linalg.norm(pos[:, 1:tps.n + 1] - c, axis=-1)
        assert (d[ok] >= r - 1e-3).all()
    n_j = round(float(jsummarize(jout)["success_rate"]) * 8)
    n_t = round(tapi.summarize(tout)["success_rate"] * 8)
    assert abs(n_t - n_j) <= 1, (n_t, n_j)
