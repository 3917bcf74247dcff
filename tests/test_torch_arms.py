"""Port vs JAX package on the other 3D robots of the bench: KUKA iiwa
(spec kuka_iiwr), Schunk LWA4D, and the 5-joint, two-end-effector tree of
tests/test_trees.py - compiled structures, joint recovery at float64, and the
whole main path (make_solver with the bench parameters) at float32."""

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
from graphik_tpu.solvers import local as jlocal
from graphik_tpu.solvers.riemannian import TRParams as JTRParams
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import local as tlocal
from graphik_tpu_torch.solvers.riemannian import TRParams as TTRParams
from tests.test_trees import tree_template

torch.set_num_threads(1)
ROBOTS = ["kuka_iiwa", "lwa4d", "tree"]


def structures(robot):
    """(JAX structure, port structure)."""
    if robot == "kuka_iiwa":
        return jlib.load_kuka()[1], tlib.load_kuka()[1]
    if robot == "lwa4d":
        return jlib.load_schunk_lwa4d()[1], tlib.load_schunk_lwa4d()[1]
    return JPS.from_template(tree_template()), tlib.load_tree5()[1]


def goals(tpl, seed, B):
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return q, np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])


@pytest.mark.parametrize("robot", ROBOTS)
def test_compiled_fields_equal(robot):
    jps, tps = structures(robot)
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
    N, E = {"kuka_iiwa": (18, 76), "lwa4d": (18, 76), "tree": (14, 62)}[robot]
    edges = np.triu(tps.masks()[0] | (tps.psi_L > 0) | (tps.psi_U > 0))
    assert tps.N == N and int(edges.sum()) == E


@pytest.mark.parametrize("robot", ROBOTS)
def test_joint_variables(robot):
    """From FK positions with 1 mm of noise, with and without the goal
    poses (two of them on the tree)."""
    jps, tps = structures(robot)
    q, T = goals(jps.template, 3, 8)
    assert T.shape[1] == len(jps.template.ee) == (2 if robot == "tree" else 1)
    Y = np.array(jps.realization(jnp.asarray(q)))
    np.testing.assert_allclose(tps.realization(torch.from_numpy(q)).numpy(), Y, rtol=0, atol=1e-8)
    Y = Y + 1e-3 * np.random.RandomState(4).normal(size=Y.shape)
    np.testing.assert_allclose(
        tps.joint_variables(torch.from_numpy(Y), torch.from_numpy(T)).numpy(),
        np.asarray(jps.joint_variables(jnp.asarray(Y), jnp.asarray(T))), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tps.joint_variables(torch.from_numpy(Y)).numpy(),
                               np.asarray(jps.joint_variables(jnp.asarray(Y))), rtol=0, atol=1e-8)


@pytest.mark.parametrize("robot", ROBOTS)
def test_make_solver_end_to_end_f32(robot):
    """The main path on 32 goals at float32 with the bench parameters: the
    port's success count is within 3 of the JAX package's."""
    jps, tps = structures(robot)
    _, T = goals(jps.template, 50, 32)
    T32 = T.astype(np.float32)
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
    n_j = round(float(jsummarize(jout)["success_rate"]) * 32)
    n_t = round(tapi.summarize(tout)["success_rate"] * 32)
    assert abs(n_t - n_j) <= 3, (n_t, n_j)
