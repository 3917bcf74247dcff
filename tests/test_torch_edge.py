"""Port vs JAX package: the compiled edge form and its plain cost functions
(cost, gradient, Hessian-vector product, residual) at float64."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.ops import edge as jedge
from graphik_tpu.robots import library as jlib
from graphik_tpu_torch import interop
from graphik_tpu_torch.ops import edge as tedge

torch.set_num_threads(1)
ATOL = 1e-9


def _anchors(N, seed=0):
    """A synthetic anchored-hinge spec (node rows vs constant points)."""
    rs = np.random.RandomState(seed)
    idx = np.array([3, 3, 5, 9, 9, 9, 12], np.int32)
    psi_L = rs.uniform(0.05, 0.4, size=len(idx))
    psi_U = np.where(np.arange(len(idx)) % 3 == 0, psi_L + 2.0, 0.0)
    return {
        "idx": idx,
        "centers": rs.normal(size=(len(idx), 3)),
        "psi_L": psi_L,
        "psi_U": psi_U,
        "L_mask": (psi_L > 0).astype(np.float64),
        "U_mask": (psi_U > 0).astype(np.float64),
    }


@pytest.fixture(scope="module", params=["plain", "anchored"])
def problems(request):
    _, ps = jlib.load_ur10()
    omega, psi_L, psi_U = ps.masks()
    anchors = _anchors(ps.N) if request.param == "anchored" else None
    jep = jedge.build_edge_problem(omega, psi_L, psi_U, dim=3, anchors=anchors)
    tep = tedge.build_edge_problem(omega, psi_L, psi_U, dim=3, anchors=anchors)
    rs = np.random.RandomState(3)
    Y = rs.normal(size=(5, ps.N, 3))
    Z = rs.normal(size=(5, ps.N, 3))
    D = rs.uniform(0.1, 2.0, size=(5, ps.N, ps.N))
    D = 0.5 * (D + D.transpose(0, 2, 1))
    return jep, tep, Y, Z, D


def test_edge_problem_arrays_equal(problems):
    jep, tep, *_ = problems
    jd, td = dataclasses.asdict(jep), dataclasses.asdict(tep)
    assert jd.keys() == td.keys()
    for k in jd:
        if isinstance(jd[k], np.ndarray):
            assert jd[k].dtype == td[k].dtype, k
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
        else:
            assert td[k] == jd[k], k
    assert (tep.E, tep.Ep, tep.A) == (jep.E, jep.Ep, jep.A)


def test_ur10_edge_counts():
    _, ps = jlib.load_ur10()
    omega, psi_L, psi_U = ps.masks()
    ep = tedge.build_edge_problem(omega, psi_L, psi_U, dim=3)
    assert (ep.N, ep.E, ep.Ep, ep.A) == (16, 64, 64, 0)
    assert (ep.omega.sum(), ep.L_mask.sum(), ep.U_mask.sum()) == (54, 7, 3)


def test_edge_values(problems):
    jep, tep, _, _, D = problems
    np.testing.assert_array_equal(tep.edge_values(torch.from_numpy(D)).numpy(),
                                  np.asarray(jep.edge_values(jnp.asarray(D))))


def test_cost_grad_hess_residual(problems):
    jep, tep, Y, Z, D = problems
    dg = np.array(jep.edge_values(jnp.asarray(D)))
    tY, tZ, tdg = torch.from_numpy(Y), torch.from_numpy(Z), torch.from_numpy(dg)
    jY, jZ, jdg = jnp.asarray(Y), jnp.asarray(Z), jnp.asarray(dg)

    def close(t, j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)

    close(tedge.cost(tep, tY, tdg), jedge.cost(jep, jY, jdg))
    tf, tg = tedge.cost_and_egrad(tep, tY, tdg)
    jf, jg = jedge.cost_and_egrad(jep, jY, jdg)
    close(tf, jf)
    close(tg, jg)
    close(tedge.ehess(tep, tY, tZ, tdg), jedge.ehess(jep, jY, jZ, jdg))
    close(tedge.residual_max(tep, tY, tdg), jedge.residual_max(jep, jY, jdg))


def test_interop_edge_problem_round_trip(problems):
    jep, tep, Y, _, D = problems
    ep2 = interop.edge_problem_from_numpy(dataclasses.asdict(jep))
    for k, v in dataclasses.asdict(tep).items():
        w = getattr(ep2, k)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(w, v)
        else:
            assert w == v
    dg = tep.edge_values(torch.from_numpy(D))
    assert torch.equal(tedge.cost(ep2, torch.from_numpy(Y), dg),
                       tedge.cost(tep, torch.from_numpy(Y), dg))
