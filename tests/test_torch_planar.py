"""Port vs JAX package: planar robots - the SE(2) maps, planar kinematics,
the planar problem compiler, joint recovery, pose error and the LM polish at
float64, and the whole main path (make_solver with the bench parameters) at
float32. The robots are the bench's planar chains, load_planar_chain(6 / 10,
limits=pi/2), and the planar tree of tests/test_trees.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu import api as japi
from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.parallel.mesh import summarize as jsummarize
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.robots.templates import planar_from_links as jplanar
from graphik_tpu.solvers import local as jlocal
from graphik_tpu.solvers.riemannian import TRParams as JTRParams
from graphik_tpu.utils import lie as jlie
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.robots import kinematics as tkin
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.robots.templates import planar_from_links as tplanar
from graphik_tpu_torch.solvers import local as tlocal
from graphik_tpu_torch.solvers.riemannian import TRParams as TTRParams
from graphik_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)
ATOL = 1e-8
CHAINS = [6, 10]


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=atol)


def chain(n):
    """(JAX structure, port structure) of the bench's planar n-chain."""
    return (jlib.load_planar_chain(n, limits=np.pi / 2)[1],
            tlib.load_planar_chain(n, limits=np.pi / 2)[1])


def tree():
    parents = np.array([-1, 0, 1, 1, 2, 3])
    return (JPS.from_template(jplanar(np.ones(5), parents=parents)),
            TPS.from_template(tplanar(np.ones(5), parents=parents)))


def goals(tpl, seed, B, spread=0.0):
    """Joint angles within the limits (plus `spread` Gaussian noise) and
    the FK poses of the angles without noise."""
    rs = np.random.RandomState(seed)
    q = rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    T = np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])
    return q + spread * rs.normal(size=q.shape), T


def test_se2_maps():
    rs = np.random.RandomState(1)
    w = np.concatenate([[0.0, 1e-12, -1e-7, 1e-4, 0.05, -0.09, 0.11, 1.0, -2.5, 3.1],
                        rs.uniform(-np.pi, np.pi, 22)])
    xi = np.concatenate([rs.normal(size=(len(w), 2)), w[:, None]], axis=1)
    T = np.array(jlie.se2_exp(jnp.asarray(xi)))
    close(tlie.se2_exp(torch.from_numpy(xi)), T)
    Tt = torch.from_numpy(T)
    close(tlie.rot2(torch.from_numpy(w)), jlie.rot2(jnp.asarray(w)))
    close(tlie.se2_make(Tt[:, :2, :2], Tt[:, :2, 2]), jlie.se2_make(T[:, :2, :2], T[:, :2, 2]))
    close(tlie.se2_rot(Tt), jlie.se2_rot(T))
    close(tlie.se2_trans(Tt), jlie.se2_trans(T))
    close(tlie.se2_angle(Tt), jlie.se2_angle(jnp.asarray(T)))
    close(tlie.se2_inv(Tt), jlie.se2_inv(jnp.asarray(T)))
    close(tlie.se2_log(Tt), jlie.se2_log(jnp.asarray(T)))
    close(tlie.se2_adjoint(Tt), jlie.se2_adjoint(jnp.asarray(T)))
    # the log's derivative used by the polish's analytic Jacobian
    wt = torch.from_numpy(w).requires_grad_()
    a, b = tlie._se2_v(wt)
    (torch.autograd.grad((a / (a * a + b * b)).sum(), wt)[0] - tlie.se2_log_dangle(wt.detach())
     ).abs().max() < 1e-8 or pytest.fail("se2_log_dangle")


@pytest.mark.parametrize("n", CHAINS)
def test_kinematics(n):
    jps, tps = chain(n)
    q, _ = goals(jps.template, n, 5)
    qt, qj = torch.from_numpy(q), jnp.asarray(q)
    close(tkin.all_poses(tps.template, qt), jkin.all_poses(jps.template, qj))
    for node in range(1, n + 1):
        close(tkin.jacobian(tps.template, qt, node), jkin.jacobian(jps.template, qj, node))
    close(tkin.linear_jacobians(tps.template, qt), jkin.linear_jacobians(jps.template, qj))
    p, aux = tkin.joint_positions(tps.template, qt)
    assert aux is None and p.shape == (5, n + 1, 2)


@pytest.mark.parametrize("n", CHAINS)
def test_compiled_fields_equal(n):
    jps, tps = chain(n)
    assert tps.N == n + 3 and tps.dim == 2
    jf, tf = dataclasses.asdict(jps), dataclasses.asdict(tps)
    assert jf.keys() == tf.keys()
    for k in jf:
        if isinstance(jf[k], np.ndarray):
            assert jf[k].dtype == tf[k].dtype, k
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
        elif k != "template":
            assert tf[k] == jf[k], k
    for a, b in zip(tps.masks(), jps.masks()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", CHAINS)
@pytest.mark.parametrize("smooth_iters", [2, None])
def test_goal_positions_and_instance(n, smooth_iters):
    jps, tps = chain(n)
    _, T = goals(jps.template, 10 + n, 6)
    close(tps.goal_positions(torch.from_numpy(T)), jps.goal_positions(jnp.asarray(T)))
    ji = jps.instance(jnp.asarray(T), smooth=True, smooth_iters=smooth_iters)
    ti = tps.instance(torch.from_numpy(T), smooth=True, smooth_iters=smooth_iters)
    for k in ("D_goal", "lb", "ub", "pos_anchor"):
        close(ti[k], ji[k])


@pytest.mark.parametrize("robot", ["chain6", "chain10", "tree"])
def test_realization_joint_variables(robot):
    jps, tps = chain(int(robot[5:])) if robot != "tree" else tree()
    tpl = jps.template
    rs = np.random.RandomState(3)
    q = rs.uniform(-np.pi, np.pi, size=(10, tpl.n))
    pos_j = jps.realization(jnp.asarray(q))
    pos_t = tps.realization(torch.from_numpy(q))
    close(pos_t, pos_j)
    T = np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])
    q_t = tps.joint_variables(pos_t, torch.from_numpy(T))
    close(q_t, jps.joint_variables(pos_j, jnp.asarray(T)))
    np.testing.assert_allclose(q_t.numpy(), q, rtol=1e-5, atol=1e-8)  # the round trip
    # from perturbed positions, where the base fit is not exact
    noisy = np.array(pos_j) + 1e-2 * rs.normal(size=pos_j.shape)
    close(tps.joint_variables(torch.from_numpy(noisy)), jps.joint_variables(jnp.asarray(noisy)))


@pytest.mark.parametrize("n", CHAINS)
def test_pose_error_and_random_goals(n):
    jps, tps = chain(n)
    q, T = goals(jps.template, 20 + n, 8, spread=0.05)
    je, jr = japi.pose_error(jps, jnp.asarray(q), jnp.asarray(T))
    te, tr = tapi.pose_error(tps, torch.from_numpy(q), torch.from_numpy(T))
    close(te, je)
    close(tr, jr)
    assert float(tr.max()) > 1e-3  # the noise makes real rotation errors
    Tg, qg = tapi.random_goals(tps, (4,), torch.Generator().manual_seed(0),
                              dtype=torch.float64, device="cpu")
    assert Tg.shape == (4, 1, 3, 3) and qg.shape == (4, n)


@pytest.mark.parametrize("robot", ["chain6", "chain10", "tree"])
def test_solve_local(robot):
    jps, tps = chain(int(robot[5:])) if robot != "tree" else tree()
    q, T = goals(jps.template, 30, 6, spread=0.05)
    jo = jlocal.solve_local(jps, jnp.asarray(T), jnp.asarray(q),
                            jlocal.LocalParams(maxiter=10, tol_grad=1e-8))
    to = tlocal.solve_local(tps, torch.from_numpy(T), torch.from_numpy(q),
                            tlocal.LocalParams(maxiter=10, tol_grad=1e-8))
    close(to["q"], jo["q"])
    close(to["cost"], jo["cost"])
    np.testing.assert_array_equal(to["iterations"].numpy(), np.asarray(jo["iterations"]))


def test_polish_jacobian_matches_jacfwd():
    """The analytic Jacobian of the planar pose residual against the JAX
    package's jax.jacfwd, residual by residual, over both end effectors of
    the tree, at angles near 0 and far from it."""
    jps, tps = tree()
    tpl = jps.template
    q, T = goals(tpl, 31, 4, spread=0.3)
    q[0] = np.array(jnp.asarray(goals(tpl, 31, 4)[0][0])) + 1e-9  # residual angle ~1e-9
    et, Jt = tlocal._pose_residuals(tps.template, torch.from_numpy(T), torch.from_numpy(q))
    for i in range(len(q)):
        ej, Jj = jlocal._stacked_pose_residuals(tpl, jnp.asarray(T[i]), jnp.asarray(q[i]))
        close(et[i], ej)
        close(Jt[i], Jj)


@pytest.mark.parametrize("n", CHAINS)
def test_make_solver_end_to_end_f32(n):
    """The main path on 32 goals at float32 with the bench parameters: the
    port's success count is within 3 of the JAX package's. The JAX side
    runs its "edge" backend: its Pallas kernel in interpret mode stalls
    near convergence at d = 2 (tools/torch_parity.py)."""
    jps, tps = chain(n)
    _, T = goals(jps.template, 40 + n, 32)
    T32 = T.astype(np.float32)
    kw = dict(polish_params=jlocal.LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    jparams = JTRParams.production(maxiter=100, maxinner=24, backend="edge")
    jout = japi.make_solver(jps, params=jparams, dtype=jnp.float32, **kw)(jnp.asarray(T32))
    kw["polish_params"] = tlocal.LocalParams(maxiter=10, tol_grad=1e-8)
    tout = tapi.make_solver(tps, params=TTRParams.production(maxiter=100, maxinner=24),
                            **kw)(torch.from_numpy(T32))
    assert set(tout) == set(jout)
    for k, v in tout.items():
        assert tuple(v.shape) == tuple(jout[k].shape), k
        assert bool(torch.isfinite(v.double()).all()), k
    assert tout["Y"].shape == (32, n + 3, 2) and tout["Y"].dtype == torch.float32
    n_j = round(float(jsummarize(jout)["success_rate"]) * 32)
    n_t = round(tapi.summarize(tout)["success_rate"] * 32)
    assert abs(n_t - n_j) <= 3, (n_t, n_j)
    assert n_t >= 24, n_t
