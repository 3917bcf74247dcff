"""Port vs JAX package: the prepare stage (instance assembly, min-plus bound
smoothing, MDS initialization) on UR10 at float64."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu.utils import dgp as jdgp
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import riemannian as triem
from graphik_tpu_torch.utils import dgp as tdgp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ur10_goals():
    jt, jps = jlib.load_ur10()
    _, tps = tlib.load_ur10()
    rs = np.random.RandomState(7)
    q = rs.uniform(jt.lb[1:], jt.ub[1:], size=(6, jt.n))
    T_goal = np.array(jkin.all_poses(jt, jnp.asarray(q))[:, jt.ee])  # (6, 1, 4, 4)
    return jps, tps, T_goal


def test_goal_positions(ur10_goals):
    jps, tps, T_goal = ur10_goals
    np.testing.assert_allclose(
        tps.goal_positions(torch.from_numpy(T_goal)).numpy(),
        np.asarray(jps.goal_positions(jnp.asarray(T_goal))), rtol=0, atol=1e-12)


@pytest.mark.parametrize("smooth_iters", [2, None])
def test_instance(ur10_goals, smooth_iters):
    jps, tps, T_goal = ur10_goals
    ji = jps.instance(jnp.asarray(T_goal), smooth=True, smooth_iters=smooth_iters)
    ti = tps.instance(torch.from_numpy(T_goal), smooth=True, smooth_iters=smooth_iters)
    for k in ("D_goal", "lb", "ub", "pos_anchor"):
        assert ti[k].dtype == torch.float64
        np.testing.assert_allclose(ti[k].numpy(), np.asarray(ji[k]), rtol=0, atol=1e-10,
                                   err_msg=k)


def test_instance_keeps_float32(ur10_goals):
    _, tps, T_goal = ur10_goals
    ti = tps.instance(torch.from_numpy(T_goal), dtype=torch.float32, smooth_iters=2)
    assert all(v.dtype == torch.float32 for v in ti.values())


def test_bound_smoothing_random():
    """Min-plus smoothing on random bounded graphs, batched."""
    rs = np.random.RandomState(11)
    N = 9
    U = rs.uniform(1.0, 3.0, size=(4, N, N))
    U = 0.5 * (U + U.transpose(0, 2, 1))
    L = U * rs.uniform(0.2, 0.9, size=(4, N, N))
    L = 0.5 * (L + L.transpose(0, 2, 1))
    mask = rs.uniform(size=(N, N)) < 0.5
    mask = mask | mask.T
    for n_iter in (1, None):
        jl, ju = jdgp.bound_smoothing(jnp.asarray(L), jnp.asarray(U), jnp.asarray(mask), n_iter)
        tl, tu = tdgp.bound_smoothing(torch.from_numpy(L), torch.from_numpy(U),
                                      torch.from_numpy(mask), n_iter)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-12)


@pytest.mark.parametrize("smooth_iters", [2, None])
def test_generate_initialization_gram(ur10_goals, smooth_iters):
    """Eigenvector signs differ between eigh implementations, so compare
    the Gram Y0 Y0^T, which is invariant to them."""
    jps, tps, T_goal = ur10_goals
    omega = jps.masks()[0]
    ji = jps.instance(jnp.asarray(T_goal), smooth=True, smooth_iters=smooth_iters)
    ti = tps.instance(torch.from_numpy(T_goal), smooth=True, smooth_iters=smooth_iters)
    jY = np.asarray(jriem.generate_initialization(ji["lb"], ji["ub"], jnp.asarray(omega), 3))
    tY = triem.generate_initialization(ti["lb"], ti["ub"], omega, 3).numpy()
    assert tY.shape == jY.shape == (6, tps.N, 3)
    np.testing.assert_allclose(tY @ tY.transpose(0, 2, 1), jY @ jY.transpose(0, 2, 1),
                               rtol=0, atol=1e-8)


def test_distance_helpers():
    Y = np.random.RandomState(12).normal(size=(3, 10, 3))
    D_t = tdgp.distance_matrix_from_pos(torch.from_numpy(Y))
    D_j = jdgp.distance_matrix_from_pos(jnp.asarray(Y))
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tdgp.gram_from_distance_matrix(D_t).numpy(),
                               np.asarray(jdgp.gram_from_distance_matrix(D_j)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [9, 13, 43])
def test_gram_is_one_at_every_batch_position(n):
    """One matrix copied to every position of a stack gives one Gram,
    bitwise, at every position, and so does the same stack read through a
    view 4 bytes into its storage (every matrix misaligned); that Gram is
    the matrix's alone and JAX's within 1e-6 of its scale (float32). n = 9,
    13, 43: planar6's, planar10's and planar40's node counts, whose n^2
    values are not a multiple of 4."""
    rs = np.random.RandomState(n)
    P = rs.normal(size=(n, 2)).astype(np.float32)
    D = ((P[:, None] - P[None]) ** 2).sum(-1)
    one = tdgp.gram_from_distance_matrix(torch.from_numpy(D))
    stack = torch.from_numpy(D).expand(11, n, n).contiguous()
    buf = torch.empty(stack.numel() + 1, dtype=torch.float32)
    view = buf[1:].view(stack.shape)
    view.copy_(stack)
    for S in (stack, view):
        G = tdgp.gram_from_distance_matrix(S)
        assert torch.equal(G, one.expand_as(G))
    Gj = np.asarray(jdgp.gram_from_distance_matrix(jnp.asarray(D)))
    np.testing.assert_allclose(one.numpy(), Gj, rtol=0, atol=1e-6 * np.abs(Gj).max())
