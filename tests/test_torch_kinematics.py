"""Port vs JAX package: Lie-group maps and forward kinematics at float64.

Inputs are numpy arrays from RandomState seeds handed to both packages;
tolerance atol 1e-10 (both are the same closed forms at float64).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.utils import lie as jlie
from graphik_tpu_torch.robots import kinematics as tkin
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)
ATOL = 1e-10


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def rodrigues(axis, angle):
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


ANGLES = [0.0, 1e-9, 1e-6, 1e-3, 0.05, 0.5, 1.0, 2.0, 3.0,
          np.pi - 1e-3, np.pi - 1e-6, np.pi - 1e-9, np.pi]


@pytest.mark.parametrize("angle", ANGLES)
def test_so3_log(angle):
    rs = np.random.RandomState(1)
    R = np.stack([rodrigues(rs.normal(size=3), angle) for _ in range(4)])
    close(tlie.so3_log(torch.from_numpy(R)), jlie.so3_log(jnp.asarray(R)))


@pytest.mark.parametrize("scale", [1e-7, 1e-2, 0.3, 1.5, 3.0])
def test_so3_exp_and_jacobians(scale):
    w = np.random.RandomState(2).normal(size=(6, 3)) * scale
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    close(tlie.so3_exp(tw), jlie.so3_exp(jw))
    close(tlie.so3_left_jacobian(tw), jlie.so3_left_jacobian(jw))
    close(tlie.so3_inv_left_jacobian(tw), jlie.so3_inv_left_jacobian(jw))


@pytest.mark.parametrize("scale", [1e-7, 1e-2, 0.3, 1.5, 3.0])
def test_se3_maps(scale):
    xi = np.random.RandomState(3).normal(size=(6, 6)) * scale
    txi, jxi = torch.from_numpy(xi), jnp.asarray(xi)
    T = np.array(jlie.se3_exp(jxi))
    tT, jT = torch.from_numpy(T), jnp.asarray(T)
    close(tlie.se3_exp(txi), jlie.se3_exp(jxi))
    close(tlie.se3_log(tT), jlie.se3_log(jT))
    close(tlie.se3_inv(tT), jlie.se3_inv(jT))
    close(tlie.se3_adjoint(tT), jlie.se3_adjoint(jT))
    close(tlie.se3_inv_left_jacobian(txi), jlie.se3_inv_left_jacobian(jxi))


def test_rotz_and_wraptopi():
    th = np.random.RandomState(4).uniform(-10, 10, size=17)
    close(tlie.se3_rotz(torch.from_numpy(th)), jlie.se3_rotz(jnp.asarray(th)))
    close(tlie.wraptopi(torch.from_numpy(th)), jlie.wraptopi(jnp.asarray(th)))


@pytest.fixture(scope="module")
def ur10():
    return jlib.load_ur10()[0], tlib.load_ur10()[0]


def _q(tpl, seed, B=7):
    rs = np.random.RandomState(seed)
    return rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))


def test_all_poses(ur10):
    jt, tt = ur10
    q = _q(jt, 0)
    close(tkin.all_poses(tt, torch.from_numpy(q)), jkin.all_poses(jt, jnp.asarray(q)))
    # unbatched
    close(tkin.all_poses(tt, torch.from_numpy(q[0])), jkin.all_poses(jt, jnp.asarray(q[0])))


def test_joint_positions(ur10):
    jt, tt = ur10
    q = _q(jt, 1)
    tp, tq = tkin.joint_positions(tt, torch.from_numpy(q), 0.7)
    jp, jq = jkin.joint_positions(jt, jnp.asarray(q), 0.7)
    close(tp, jp)
    close(tq, jq)


@pytest.mark.parametrize("node", [3, 6])
def test_jacobian(ur10, node):
    jt, tt = ur10
    q = _q(jt, 2)
    close(tkin.jacobian(tt, torch.from_numpy(q), node), jkin.jacobian(jt, jnp.asarray(q), node))


def test_random_configuration_within_limits(ur10):
    _, tt = ur10
    g = torch.Generator().manual_seed(0)
    q = tkin.random_configuration(tt, (1000,), g, dtype=torch.float64, device="cpu")
    assert q.shape == (1000, tt.n) and q.dtype == torch.float64
    lb, ub = torch.from_numpy(tt.lb[1:]), torch.from_numpy(tt.ub[1:])
    assert bool(((q >= lb) & (q <= ub)).all())
    again = tkin.random_configuration(tt, (1000,), torch.Generator().manual_seed(0),
                                      dtype=torch.float64, device="cpu")
    assert torch.equal(q, again)
