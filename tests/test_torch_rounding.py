"""The finish's one rounding rule (graphik_tpu_torch/utils/lie.py
matmul_small and its kin): each small product, dot, norm and mean rounds as
the JAX package's float32 arithmetic does on the CPU, bit for bit, with
elementwise torch operations that round the same on a card
(tests/test_torch_cuda.py holds the card's bits to the CPU's); and the
finish's functions built on them stay within their tolerances of JAX's at
planar40's and UR10's shapes."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphik_tpu.ops.linalg import spd_solve_unrolled
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.utils import dgp as jdgp
from graphik_tpu_torch.ops.linalg import spd_solve_reference
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.utils import dgp as tdgp
from graphik_tpu_torch.utils import lie

B = 512


def _stack(seed, *shape):
    return np.random.RandomState(seed).normal(size=(B,) + shape).astype(np.float32)


def _bitwise(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("k", [2, 3, 4, 6])
def test_matmul_small_is_jax_float32_matmul(k):
    """(B, k, k) stacks and a (B, 3, k) by (B, k, 3) product: bitwise
    jnp.matmul at "highest" and jnp.einsum; matvec_small bitwise the
    einsum of a matrix and a vector."""
    a, b, v = _stack(k, k, k), _stack(k + 10, k, k), _stack(k + 20, k)
    t = lie.matmul_small(torch.from_numpy(a), torch.from_numpy(b))
    _bitwise(t, jnp.matmul(a, b, precision="highest"))
    _bitwise(t, jnp.einsum("...ik,...kj->...ij", a, b))
    r, c = _stack(k + 30, 3, k), _stack(k + 40, k, 3)
    _bitwise(lie.matmul_small(torch.from_numpy(r), torch.from_numpy(c)),
             jnp.matmul(r, c, precision="highest"))
    _bitwise(lie.matvec_small(torch.from_numpy(a), torch.from_numpy(v)),
             jnp.einsum("...ij,...j->...i", a, v))


@pytest.mark.parametrize("n, d", [(43, 2), (16, 3)])
def test_gram_and_pair_distances_are_jax(n, d):
    """At planar40's (43, 2) and UR10's (16, 3) point sets: the Gram by
    matmul_small bitwise JAX's einsum, and dgp.pair_distances at every pair
    bitwise the JAX package's distance_matrix_from_pos."""
    Y = _stack(n, n, d)
    G = lie.matmul_small(torch.from_numpy(Y), torch.from_numpy(Y).transpose(-1, -2))
    _bitwise(G, jnp.einsum("...ik,...jk->...ij", Y, Y))
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    D = tdgp.pair_distances(torch.from_numpy(Y), torch.from_numpy(ii.ravel()),
                            torch.from_numpy(jj.ravel()))
    _bitwise(D, np.asarray(jdgp.distance_matrix_from_pos(Y)).reshape(B, -1))


def test_norm_mean_and_sqrt_are_jax():
    """norm_small of the finish's 2- and 3-vectors, mean_small and sqrt_rn
    bitwise jnp.linalg.norm, jnp.mean and jnp.sqrt in float32 (torch's own
    CPU sqrt and mean are not)."""
    for d in (2, 3):
        v = _stack(d, 64, d)
        _bitwise(lie.norm_small(torch.from_numpy(v)), jnp.linalg.norm(v, axis=-1))
    p = _stack(5, 3, 2)
    _bitwise(lie.mean_small(torch.from_numpy(p), -2), jnp.mean(p, axis=-2))
    _bitwise(lie.mean_small(torch.from_numpy(p), -2, keepdim=True),
             jnp.mean(p, axis=-2, keepdims=True))
    x = np.abs(_stack(6, 256))
    _bitwise(lie.sqrt_rn(torch.from_numpy(x)), jnp.sqrt(x))


def test_spd_solve_pivot_is_jax_sqrt():
    """The LM's solve on the CPU (spd_solve_reference, K6's plain version)
    takes its pivots' sqrt correctly rounded, as K6 and the JAX package's
    spd_solve_unrolled does: at m = 1 (x = b / L / L, L = sqrt(a)) bitwise
    JAX's, op by op (jit lets XLA rewrite the two divisions), on 4096
    systems, 30 of whose pivots torch's own float32 sqrt rounds otherwise
    on the CPU."""
    rs = np.random.RandomState(7)
    a = np.abs(rs.normal(size=(4096, 1, 1))).astype(np.float32) + np.float32(1e-3)
    b = rs.normal(size=(4096, 1)).astype(np.float32)
    with jax.disable_jit():
        ref = spd_solve_unrolled(a, b)
    _bitwise(spd_solve_reference(torch.from_numpy(a), torch.from_numpy(b)), ref)


def _robot(name):
    if name == "planar40":
        return (jlib.load_planar_chain(40, limits=np.pi / 2),
                tlib.load_planar_chain(40, limits=np.pi / 2))
    return jlib.load_ur10(), tlib.load_ur10()


@pytest.mark.parametrize("name", ["planar40", "ur10"])
def test_finish_functions_at_planar40_and_ur10(name):
    """check_distance_limits, realization and joint_variables against the
    JAX package's at planar40's and UR10's shapes (32 goals): float64
    within 1e-8 (tests/test_torch_api.py's tolerance); in float32
    check_distance_limits bitwise JAX's on the same positions, the inside
    and the violating set."""
    (jt, jps), (_, tps) = _robot(name)
    rs = np.random.RandomState(40)
    q = rs.uniform(jt.lb[1:], jt.ub[1:], size=(32, jt.n))
    T = np.array(jkin.all_poses(jt, jnp.asarray(q))[:, jt.ee])
    pos = np.array(jps.realization(jnp.asarray(q)))
    np.testing.assert_allclose(tps.realization(torch.from_numpy(q)).numpy(), pos,
                               rtol=0, atol=1e-8)
    Y = pos + 1e-3 * rs.normal(size=pos.shape)
    np.testing.assert_allclose(
        tps.joint_variables(torch.from_numpy(Y), torch.from_numpy(T)).numpy(),
        np.asarray(jps.joint_variables(jnp.asarray(Y), jnp.asarray(T))), rtol=0, atol=1e-8)
    for P in (Y, Y * 1.3):
        jv, jok = jps.check_distance_limits(jnp.asarray(P))
        tv, tok = tps.check_distance_limits(torch.from_numpy(P))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-8)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        with jax.enable_x64(False):
            P32 = P.astype(np.float32)
            jv32, jok32 = jps.check_distance_limits(jnp.asarray(P32))
            tv32, tok32 = tps.check_distance_limits(torch.from_numpy(P32))
            _bitwise(tv32, jv32)
            np.testing.assert_array_equal(tok32.numpy(), np.asarray(jok32))
