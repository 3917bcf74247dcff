"""The port's native float64 CPU oracle (graphik_tpu_torch/native, built
with g++ on first use) against the port's plain float64 costs - the dense
ones (solvers/costs.py) and the edge-list ones (ops/edge.py) - and against
the JAX package's own oracle, mirroring tests/test_native.py (the same
problems, seeds and tolerances)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu import native as jnative
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu_torch import native
from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.robots.templates import planar_from_links
from graphik_tpu_torch.solvers import costs
from tests.test_kinematics import ur10_template

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    """The oracle builds from the repository's source: a build failure is a
    failure here, not a skip."""
    assert native.available(), native._build_error
    return native


def _structure(make):
    if make == "planar":
        return ProblemStructure.from_template(planar_from_links(np.ones(8)))
    return ProblemStructure.from_template(ur10_template())


def _problem_arrays(ps, seed):
    """D_goal from a goal at random joint angles, and the masks, float64."""
    rng = np.random.RandomState(seed)
    q_goal = rng.uniform(-np.pi, np.pi, ps.n)
    ee = int(ps.template.ee[0])
    T_goal = np.array(jkin.pose(ps.template, jnp.asarray(q_goal), ee))
    D_goal = ps.instance(torch.from_numpy(T_goal), smooth=False)["D_goal"].numpy()
    omega, psi_L, psi_U = ps.masks()
    omega = omega.astype(np.float64)
    L_mask, U_mask = costs.make_masks(omega, psi_L, psi_U)
    return D_goal, omega, psi_L, psi_U, L_mask, U_mask


@pytest.mark.parametrize("make", ["planar", "ur10"])
@pytest.mark.parametrize("seed", [0, 3])
def test_native_matches_port(lib, make, seed):
    ps = _structure(make)
    D_goal, omega, psi_L, psi_U, L_mask, U_mask = _problem_arrays(ps, seed)
    ei, ej, om_e, pl_e, pu_e, lm_e, um_e = lib.edges_from_masks(omega, psi_L, psi_U, L_mask, U_mask)
    assert len(ei) > 0
    dgoal_e = D_goal[ei, ej]
    rng = np.random.RandomState(seed + 100)
    B = 5
    Y, Z = rng.randn(B, ps.N, ps.dim), rng.randn(B, ps.N, ps.dim)

    # the port's dense float64 path
    args = tuple(torch.from_numpy(a) for a in (D_goal, omega, psi_L, psi_U, L_mask, U_mask))
    Yt, Zt = torch.from_numpy(Y), torch.from_numpy(Z)
    f_ref = costs.cost(Yt, *args).numpy()
    g_ref = costs.egrad(Yt, *args).numpy()
    h_ref = costs.ehess(Yt, Zt, *args).numpy()

    f_nat = lib.cost(Y, dgoal_e, ei, ej, om_e, pl_e, pu_e, lm_e, um_e)
    f_nat2, g_nat = lib.cost_and_grad(Yt, dgoal_e, ei, ej, om_e, pl_e, pu_e, lm_e, um_e)
    h_nat = lib.hess(Y, Zt, dgoal_e, ei, ej, om_e, pl_e, pu_e, lm_e, um_e)

    scale = max(1.0, np.abs(f_ref).max())
    np.testing.assert_allclose(f_nat / scale, f_ref / scale, atol=1e-12)
    np.testing.assert_allclose(f_nat2, f_nat, rtol=0, atol=0)
    gs = max(1.0, np.abs(g_ref).max())
    np.testing.assert_allclose(g_nat / gs, g_ref / gs, atol=1e-12)
    hs = max(1.0, np.abs(h_ref).max())
    np.testing.assert_allclose(h_nat / hs, h_ref / hs, atol=1e-12)

    # the port's edge-list float64 path (ops/edge.py)
    ep = tedge.build_edge_problem(omega, psi_L, psi_U, L_mask, U_mask, dim=ps.dim)
    dg = ep.edge_values(torch.from_numpy(D_goal).expand(B, -1, -1))
    fe, ge = tedge.cost_and_egrad(ep, Yt, dg)
    he = tedge.ehess(ep, Yt, Zt, dg)
    np.testing.assert_allclose(fe.numpy() / scale, f_nat / scale, atol=1e-12)
    np.testing.assert_allclose(ge.numpy() / gs, g_nat / gs, atol=1e-12)
    np.testing.assert_allclose(he.numpy() / hs, h_nat / hs, atol=1e-12)

    # the JAX package's oracle, built from its own copy of the source
    if jnative.available():
        np.testing.assert_array_equal(
            jnative.cost(Y, dgoal_e, ei, ej, om_e, pl_e, pu_e, lm_e, um_e), f_nat)


def test_native_unbatched_and_broadcast(lib):
    ps = ProblemStructure.from_template(planar_from_links(np.ones(4)))
    D_goal, omega, psi_L, psi_U, L_mask, U_mask = _problem_arrays(ps, 7)
    ei, ej, om_e, pl_e, pu_e, lm_e, um_e = lib.edges_from_masks(omega, psi_L, psi_U, L_mask, U_mask)
    dgoal_e = D_goal[ei, ej]
    Y = np.random.RandomState(1).randn(ps.N, ps.dim)
    f1 = lib.cost(Y, dgoal_e, ei, ej, om_e, pl_e, pu_e, lm_e, um_e)
    fB = lib.cost(np.stack([Y, Y]), dgoal_e, ei, ej, om_e, pl_e, pu_e, lm_e, um_e)
    assert np.ndim(f1) == 0
    np.testing.assert_allclose(fB, [f1, f1])
    f, g = lib.cost_and_grad(Y, dgoal_e, ei, ej, om_e, pl_e, pu_e, lm_e, um_e)
    assert g.shape == (ps.N, ps.dim) and f == f1


def test_native_rejects_bad_inputs(lib):
    ei, ej = np.array([0, 1]), np.array([1, 5])
    ones = np.ones(2)
    with pytest.raises(ValueError, match="out of range"):
        lib.cost(np.zeros((1, 3, 2)), ones, ei, ej, ones, ones, ones, ones, ones)
    with pytest.raises(ValueError, match="same length"):
        lib.cost(np.zeros((1, 6, 2)), ones, ei, ej, ones[:1], ones, ones, ones, ones)
    with pytest.raises(ValueError, match="d <= 3"):
        lib.cost(np.zeros((1, 6, 4)), ones, ei, ej, ones, ones, ones, ones, ones)


def test_native_builds_into_the_repository():
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and "build" in path.split("/")
