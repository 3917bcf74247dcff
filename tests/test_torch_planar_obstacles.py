"""Port vs JAX package: planar robots with obstacles (circles at d = 2), the
planar10_ring6 scene - load_planar_chain(10, limits=pi/2) and the six
circles of utils/environments.py ring_environment. The compiled structure,
the anchored reduction and its smoothing, the obstacle residuals of the
polish, the plain anchored TR solve at float64 against the JAX package's
"edge" backend, and the whole main path and the restart path at float32.
The kernel's own checks (the <2, 2, 16, true> instance) are in
test_torch_cuda.py (they need the card)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu import api as japi
from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.ops import edge as jedge
from graphik_tpu.parallel.mesh import summarize as jsummarize
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import local as jlocal
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.ops import tr_solve
from graphik_tpu_torch.parallel import mesh as tmesh
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import local as tlocal
from graphik_tpu_torch.solvers import riemannian as triem
from graphik_tpu_torch.utils.environments import ring_environment

torch.set_num_threads(1)

TABLE = dict(maxinner=32, plateau_every=16, plateau_rtol=1e-4)


@pytest.fixture(scope="module")
def ring6():
    """(JAX structure, port structure) of planar10_ring6."""
    env = ring_environment()
    jt = jlib.load_planar_chain(10, limits=np.pi / 2)[0]
    tt = tlib.load_planar_chain(10, limits=np.pi / 2)[0]
    return JPS.from_template(jt, obstacles=env), TPS.from_template(tt, obstacles=env)


def _goals(tpl, seed, B):
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return q, np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])


def test_ring_environment():
    env = ring_environment()
    assert len(env) == 6
    for k, (c, r) in enumerate(env):
        a = np.deg2rad(30 + 60 * k)
        np.testing.assert_allclose(c, [4 * np.cos(a), 4 * np.sin(a), 0.0], rtol=0, atol=1e-14)
        assert r == 0.5


def test_structure_fields_equal(ring6):
    jps, tps = ring6
    assert tps.N == jps.N == 13 + 6 and tps.dim == 2
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
    # obstacle nodes follow x and y, each at its centre's first two coordinates
    assert [tps.idx_obs(k) for k in range(6)] == [jps.idx_obs(k) for k in range(6)] == \
        list(range(13, 19))
    np.testing.assert_array_equal(tps.pos_fixed[13:], np.stack([c[:2] for c, _ in ring_environment()]))
    for a, b in zip(tps.masks(), jps.masks()):
        np.testing.assert_array_equal(a, b)


def test_reduced_spec_equal(ring6):
    jps, tps = ring6
    js, ts = jps.reduced_spec(), tps.reduced_spec()
    assert ts.keys() == js.keys()
    for k in js:
        assert np.array_equal(np.asarray(ts[k]), np.asarray(js[k])), k
    assert ts["Nr"] == 13 and len(ts["idx"]) == 60 and ts["centers"].shape == (60, 2)


def test_anchored_edge_problem_equal(ring6):
    """The compiled edge form with anchors at d = 2: the JAX package's
    arrays (10 groups of 6 live rows, each padded to 8 with masked rows),
    the kernel's tables (centers (2, A)) and its skip reach (the circles'
    radius)."""
    jps, tps = ring6
    spec = tps.reduced_spec()
    Nr = spec["Nr"]
    om, pl, pu = tps.masks()
    args = (om[:Nr, :Nr], pl[:Nr, :Nr], pu[:Nr, :Nr])
    jep = jedge.build_edge_problem(*args, dim=2, anchors=spec)
    tep = tedge.build_edge_problem(*args, dim=2, anchors=spec)
    assert (tep.N, tep.E, tep.A, tep.a_nsel, tep.a_R) == (jep.N, jep.E, jep.A, jep.a_nsel,
                                                         jep.a_R) == (13, 29, 80, 10, 8)
    for f in ("ei", "ej", "omega", "psi_L", "psi_U", "L_mask", "U_mask", "acenters", "apsi_L",
              "apsi_U", "aL_mask", "aU_mask", "aP", "aPsel"):
        np.testing.assert_array_equal(np.asarray(getattr(tep, f)), np.asarray(getattr(jep, f)),
                                      err_msg=f)
    assert np.asarray(tep.acenters).shape == (80, 2)
    assert int(np.asarray(tep.aL_mask).sum()) == 60 and not np.asarray(tep.aU_mask).any()
    cen, par, node = tr_solve._anchor_tables(tep, torch.device("cpu"))
    assert tuple(cen.shape) == (2, 80) and tuple(par.shape) == (4, 80)
    assert node.tolist() == list(range(1, 11))
    assert tr_solve._anchor_near(tep) == pytest.approx(0.5, abs=1e-12)


def test_reduced_instance_matches_jax(ring6):
    """instance(n_nodes=Nr) at float64 against the JAX package's, and the
    fold against the port's own full-graph smoothing on the reduced block."""
    jps, tps = ring6
    Nr = tps.reduced_spec()["Nr"]
    _, T = _goals(jps.template, 3, 4)
    ji = jps.instance(jnp.asarray(T), smooth=True, n_nodes=Nr)
    ti = tps.instance(torch.from_numpy(T), smooth=True, n_nodes=Nr)
    for k in ("D_goal", "pos_anchor", "lb", "ub"):
        assert tuple(ti[k].shape) == ji[k].shape
        np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]), rtol=0, atol=1e-12, err_msg=k)
    full = tps.instance(torch.from_numpy(T), smooth=True)
    for k in ("lb", "ub"):
        np.testing.assert_allclose(ti[k].numpy(), full[k].numpy()[:, :Nr, :Nr], rtol=0, atol=1e-12)


def test_realization_and_limits(ring6):
    """realization covers the obstacle nodes after x and y, and
    check_distance_limits flags a robot point inside a circle as the JAX
    package does."""
    jps, tps = ring6
    q = np.random.RandomState(9).uniform(jps.template.lb[1:], jps.template.ub[1:], size=(5, 10))
    pos_j = np.asarray(jps.realization(jnp.asarray(q)))
    pos_t = tps.realization(torch.from_numpy(q)).numpy()
    assert pos_t.shape == (5, 19, 2)
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-12)
    pos = pos_t.copy()
    pos[0, tps.idx_obs(2)] = pos[0, 4] + np.array([0.1, 0.0])
    jv, jok = jps.check_distance_limits(jnp.asarray(pos))
    tv, tok = tps.check_distance_limits(torch.from_numpy(pos))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert not bool(tok[0]) and float(tv[0]) == pytest.approx(0.4 - 1e-6, abs=1e-12)


def test_obstacle_constraints_match_jax(ring6):
    """The polish's hinge residuals and their analytic Jacobians at d = 2."""
    jps, tps = ring6
    q = np.random.RandomState(6).uniform(jps.template.lb[1:], jps.template.ub[1:], size=(3, 10))
    idx, cen, rad = jlocal._obstacle_pairs(jps)
    gt, Jt = tlocal._obstacle_g_and_jac(tps.template, torch.from_numpy(q),
                                       *tlocal._obstacle_pairs(tps))
    assert tuple(Jt.shape) == (3, 60, 10)
    for i in range(3):
        gj, Jj = jlocal._obstacle_g_and_jac(jps, jps.template, jnp.asarray(q[i]), idx, cen, rad)
        np.testing.assert_allclose(gt[i].numpy(), np.asarray(gj), rtol=0, atol=1e-12)
        np.testing.assert_allclose(Jt[i].numpy(), np.asarray(Jj), rtol=0, atol=1e-12)


def test_solve_local_with_obstacles(ring6):
    """The augmented-Lagrangian LM at float64 against the JAX package's,
    from starts that meet the circles."""
    jps, tps = ring6
    q0, T = _goals(jps.template, 7, 6)
    q0 = q0 + 0.3 * np.random.RandomState(8).normal(size=q0.shape)
    kw = dict(maxiter=5, al_iters=2, tol_grad=1e-8)
    jo = jlocal.solve_local(jps, jnp.asarray(T), jnp.asarray(q0), jlocal.LocalParams(**kw))
    to = tlocal.solve_local(tps, torch.from_numpy(T), torch.from_numpy(q0), tlocal.LocalParams(**kw))
    for k in ("q", "cost", "max_violation"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=0, atol=1e-8, err_msg=k)
    np.testing.assert_array_equal(to["iterations"].numpy(), np.asarray(jo["iterations"]))


def _anchored_problem(ps, B=8):
    """(reduced masks, anchor spec, Y0, D_goal) at float64: goals from a
    RandomState seed, Y0 near a second random configuration's positions,
    so the circles' hinges meet the chain."""
    tpl = ps.template
    spec = ps.reduced_spec()
    Nr = spec["Nr"]
    rs = np.random.RandomState(11)
    q = rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(B, 10))
    q2 = rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(B, 10))
    T = np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])
    Yw = np.array(ps.realization(jnp.asarray(q2)))[:, :Nr]
    om, pl, pu = ps.masks()
    D = np.array(ps.instance(jnp.asarray(T), smooth=False, n_nodes=Nr)["D_goal"])
    Y0 = Yw + 0.05 * rs.normal(size=Yw.shape)
    return (om[:Nr, :Nr], pl[:Nr, :Nr], pu[:Nr, :Nr]), spec, Y0, D


def test_anchored_hinges_active(ring6):
    """The starts of the f64 parity test below meet the circles: the
    anchor hinges add to the cost on some lanes."""
    jps, _ = ring6
    masks, spec, Y0, D = _anchored_problem(jps)
    ep = tedge.build_edge_problem(*masks, dim=2, anchors=spec)
    Y, dg = torch.from_numpy(Y0), ep.edge_values(torch.from_numpy(D))
    _, a1, _ = tedge._anchor_terms(ep, Y)
    assert int((a1 > 0).any(-1).sum()) >= 2


@pytest.mark.parametrize("route", ["reference", "dense", "edge"])
@pytest.mark.parametrize("res_tol", [0.0, 0.05])
def test_anchored_tr_f64_against_edge(ring6, res_tol, route):
    """At float64 the anchored TR at d = 2 - the plain kernel-order version
    called directly ("reference"), or riemannian.solve's "dense" or "edge"
    backend - follows the JAX package's "edge" backend with the same
    anchors lane for lane for 5 iterations (the horizon of
    test_torch_tr_solve.py)."""
    jps, _ = ring6
    masks, spec, Y0, D = _anchored_problem(jps)
    p = dict(maxiter=5, res_tol=res_tol, **TABLE)
    ref = jriem.solve(jnp.asarray(Y0), jnp.asarray(D), *masks,
                      params=jriem.TRParams(backend="edge", **p), anchors=spec)
    Y, Dg = torch.from_numpy(Y0), torch.from_numpy(D)
    if route == "reference":
        ep = tedge.build_edge_problem(*masks, dim=2, anchors=spec)
        out = tr_solve.solve_tr_reference(ep, Y, ep.edge_values(Dg), **p)
    else:
        out = triem.solve(Y, Dg, *masks, params=triem.TRParams(backend=route, **p), anchors=spec)
    np.testing.assert_array_equal(out["iterations"].numpy(), np.asarray(ref["iterations"]))
    np.testing.assert_array_equal(out["num_inner"].numpy(), np.asarray(ref["num_inner"]))
    np.testing.assert_allclose(out["Y"].numpy(), np.asarray(ref["Y"]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["cost"].numpy(), np.asarray(ref["cost"]), rtol=1e-9, atol=1e-14)


def test_solve_reduced_pads_obstacles(ring6):
    jps, tps = ring6
    masks, _, Y0, D = _anchored_problem(jps, B=2)
    sol = tapi.solve_reduced(tps, torch.from_numpy(Y0), torch.from_numpy(D), *tps.masks(),
                             params=triem.TRParams(maxiter=2))
    assert tuple(sol["Y"].shape) == (2, 19, 2)
    for k, (c, _) in enumerate(ring_environment()):
        assert np.array_equal(sol["Y"][:, 13 + k].numpy(), np.broadcast_to(c[:2], (2, 2)))


def _clearance(ps, q):
    """Least clearance of p1..pn from every circle, per lane."""
    pos = ps.realization(q).numpy()[:, 1:ps.n + 1]
    return np.min([np.linalg.norm(pos - c[:2], axis=-1) - r for c, r in ps.obstacles], axis=(0, 2))


def test_make_solver_end_to_end_f32(ring6):
    """The planar10_ring6 path on 32 goals at float32 with its parameters
    (production(250, 32), 10-step polish, 2-squaring smoothing): the
    port's success count is within 3 of the JAX package's ("edge" backend),
    and every successful lane clears every circle."""
    jps, tps = ring6
    _, T = _goals(jps.template, 54, 32)
    T32 = T.astype(np.float32)
    kw = dict(polish_params=jlocal.LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    jparams = jriem.TRParams.production(maxiter=250, maxinner=32, backend="edge")
    jout = japi.make_solver(jps, params=jparams, dtype=jnp.float32, **kw)(jnp.asarray(T32))
    kw["polish_params"] = tlocal.LocalParams(maxiter=10, tol_grad=1e-8)
    tout = tapi.make_solver(tps, params=triem.TRParams.production(maxiter=250, maxinner=32),
                            **kw)(torch.from_numpy(T32))
    assert set(tout) == set(jout)
    for k, v in tout.items():
        assert tuple(v.shape) == tuple(jout[k].shape), k
        assert bool(torch.isfinite(v.double()).all()), k
    assert tout["Y"].shape == (32, 19, 2)
    ok = tout["success"].numpy()
    assert (_clearance(tps, tout["q"])[ok] >= -1e-3).all()
    n_j = round(float(jsummarize(jout)["success_rate"]) * 32)
    n_t = round(tapi.summarize(tout)["success_rate"] * 32)
    assert abs(n_t - n_j) <= 3, (n_t, n_j)
    assert n_t >= 22, n_t


def test_restart_solver_with_obstacles(ring6):
    """The restart path with obstacles at d = 2 on the CPU: two restarts
    fold into one anchored solve, restart 0 is the single-init solver's
    (so the pick is never worse), the picked fields come from one restart,
    and successful lanes clear every circle."""
    _, tps = ring6
    T = torch.from_numpy(_goals(tps.template, 55, 8)[1].astype(np.float32))
    params = triem.TRParams.production(maxiter=60, maxinner=32)
    kw = dict(params=params, polish_params=tlocal.LocalParams(maxiter=5, tol_grad=1e-8),
              smooth_iters=2)
    rsolver = tmesh.make_restart_solver(tps, n_restarts=2, **kw)
    D_goal, Y0 = rsolver.prepare(T, torch.Generator().manual_seed(0))
    assert tuple(Y0.shape) == (16, 13, 2) and tuple(D_goal.shape) == (16, 13, 13)
    multi = rsolver(T, torch.Generator().manual_seed(0))
    single = tapi.make_solver(tps, **kw)(T)

    def score(o):
        return (o["e_pos"] + o["e_rot"] + torch.where(o["success"], 0.0, 1e6)).double()

    assert bool((score(multi) <= score(single) + 1e-6).all())
    assert set(multi["restart_index"].tolist()) <= {0, 1}
    e_pos, e_rot = tapi.pose_error(tps, multi["q"], T)
    np.testing.assert_allclose(e_pos.numpy(), multi["e_pos"].numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(e_rot.numpy(), multi["e_rot"].numpy(), rtol=1e-5, atol=1e-7)
    ok = multi["success"].numpy()
    assert ok.any() and (_clearance(tps, multi["q"])[ok] >= -1e-3).all()
