"""The TR solve: the plain torch version vs the JAX package.

Oracles: at float32 the JAX Pallas kernel run in interpret mode (as the JAX
package's own tests run it on the CPU), with the tolerances of
tests/test_tr_pallas.py; at float64 the JAX dense XLA solver. The kernel's
own tests are in test_torch_cuda.py (they need the card).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.ops import edge as jedge
from graphik_tpu.ops.tr_pallas import solve_tr_pallas
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.ops import tr_solve
from graphik_tpu_torch.solvers import riemannian as triem

torch.set_num_threads(1)

PROD = dict(maxinner=24, plateau_every=16, plateau_rtol=1e-4)


@pytest.fixture(scope="module")
def ur10_problem():
    """8 UR10 goals from a RandomState seed; Y0 and D_goal at float32 from
    the JAX prepare stage, handed to both packages."""
    jt, ps = jlib.load_ur10()
    omega, psi_L, psi_U = ps.masks()
    q = np.random.RandomState(0).uniform(jt.lb[1:], jt.ub[1:], size=(8, jt.n))
    T_goal = jkin.all_poses(jt, jnp.asarray(q))[:, jt.ee]
    inst = ps.instance(T_goal.astype(jnp.float32), smooth=True, smooth_iters=2)
    Y0 = np.array(jriem.generate_initialization(
        inst["lb"], inst["ub"], jnp.asarray(omega, jnp.float32), 3), np.float32)
    D = np.array(inst["D_goal"], np.float32)
    jep = jedge.build_edge_problem(omega, psi_L, psi_U, dim=3)
    tep = tedge.build_edge_problem(omega, psi_L, psi_U, dim=3)
    dg = np.array(jep.edge_values(jnp.asarray(D)))
    return (omega, psi_L, psi_U), jep, tep, Y0, D, dg


def _jax(jep, Y0, dg, **kw):
    out = solve_tr_pallas(jep, jnp.asarray(Y0), jnp.asarray(dg), interpret=True, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port(tep, Y0, dg, **kw):
    out = tr_solve.solve_tr_reference(tep, torch.from_numpy(Y0), torch.from_numpy(dg), **kw)
    return {k: v.numpy() for k, v in out.items()}


def test_one_step_parity(ur10_problem):
    """After one TR step the plain version matches the kernel near-exactly."""
    _, jep, tep, Y0, _, dg = ur10_problem
    ref = _jax(jep, Y0, dg, maxiter=1)
    out = _port(tep, Y0, dg, maxiter=1)
    np.testing.assert_allclose(out["cost"], ref["cost"], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(out["num_inner"], ref["num_inner"])
    np.testing.assert_allclose(out["Y"], ref["Y"], rtol=1e-4, atol=1e-5)


def test_multi_step_convergence_parity(ur10_problem):
    """Both reach comparable cost after 40 iterations. Trajectories diverge
    in f32 (different accumulation orders), so assert convergence quality,
    not equality."""
    _, jep, tep, Y0, _, dg = ur10_problem
    ref = _jax(jep, Y0, dg, maxiter=40)
    out = _port(tep, Y0, dg, maxiter=40)
    assert np.median(out["cost"]) < 10 * max(np.median(ref["cost"]), 1e-8)
    assert np.all(out["cost"] < 1e-2)


def test_batch_padding_independence(ur10_problem):
    """Lanes are independent: a 3-instance batch matches the first 3 lanes
    of the 8-instance batch."""
    _, _, tep, Y0, _, dg = ur10_problem
    full = _port(tep, Y0, dg, maxiter=5)
    sub = _port(tep, Y0[:3], dg[:3], maxiter=5)
    np.testing.assert_allclose(sub["Y"], full["Y"][:3], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(sub["iterations"], full["iterations"][:3])


def test_production_params(ur10_problem):
    """The bench's stops (plateau_every=16, maxinner=24, maxiter=100): all
    lanes finite, median cost within 10x, mean iterations within 5%."""
    _, jep, tep, Y0, _, dg = ur10_problem
    ref = _jax(jep, Y0, dg, maxiter=100, **PROD)
    out = _port(tep, Y0, dg, maxiter=100, **PROD)
    for k in ("Y", "cost", "gradnorm"):
        assert np.all(np.isfinite(out[k])), k
    assert np.median(out["cost"]) < 10 * np.median(ref["cost"])
    assert np.median(ref["cost"]) < 10 * np.median(out["cost"])
    assert abs(out["iterations"].mean() - ref["iterations"].mean()) <= 0.05 * ref["iterations"].mean()


def _dense64(masks, Y0, D, maxiter):
    return jriem.solve(jnp.asarray(Y0, jnp.float64), jnp.asarray(D, jnp.float64), *masks,
                       params=jriem.TRParams(maxiter=maxiter, backend="dense", **PROD))


def _port64(masks, Y0, D, maxiter):
    return triem.solve(torch.from_numpy(Y0).double(), torch.from_numpy(D).double(), *masks,
                       params=triem.TRParams(maxiter=maxiter, **PROD))


def test_f64_against_dense_exact_horizon(ur10_problem):
    """At float64 with the production stops the plain version follows the
    JAX dense solver step for step. The horizon is 5 iterations: further
    out the problem amplifies last-bit differences of the cost forms (the
    JAX package's own edge and dense backends part by ~1e-5 in Y by
    iteration 10), so per-lane equality is asserted only where the
    reference's backends agree with each other."""
    masks, *_, Y0, D, _ = ur10_problem
    ref = _dense64(masks, Y0, D, 5)
    out = _port64(masks, Y0, D, 5)
    assert out["Y"].dtype == torch.float64
    np.testing.assert_array_equal(out["iterations"].numpy(), np.asarray(ref["iterations"]))
    np.testing.assert_array_equal(out["num_inner"].numpy(), np.asarray(ref["num_inner"]))
    np.testing.assert_allclose(out["Y"].numpy(), np.asarray(ref["Y"]), rtol=0, atol=1e-8)


def test_f64_against_dense_30_steps(ur10_problem):
    """30 float64 iterations with the production stops: the same iteration
    counts per lane, and per-lane cost within 10x of the dense solver's (the
    trajectories themselves part, see the test above)."""
    masks, *_, Y0, D, _ = ur10_problem
    ref = _dense64(masks, Y0, D, 30)
    out = _port64(masks, Y0, D, 30)
    np.testing.assert_array_equal(out["iterations"].numpy(), np.asarray(ref["iterations"]))
    ratio = out["cost"].numpy() / np.maximum(np.asarray(ref["cost"]), 1e-300)
    assert np.all((ratio < 10) & (ratio > 0.1)), ratio


def test_solve_dispatch_matches_direct_call(ur10_problem):
    """riemannian.solve on CPU f32 runs the plain version on the edge form."""
    masks, _, tep, Y0, D, dg = ur10_problem
    via = triem.solve(torch.from_numpy(Y0), torch.from_numpy(D), *masks,
                      params=triem.TRParams(maxiter=3))
    direct = tr_solve.solve_tr_reference(tep, torch.from_numpy(Y0), torch.from_numpy(dg),
                                         maxiter=3)
    for k in direct:
        assert torch.equal(via[k], direct[k]), k


@pytest.mark.parametrize("d", [2, 3])
def test_manifold_proj(d):
    """Horizontal projection at float64 against the JAX package's."""
    rs = np.random.RandomState(d)
    Y, Z = rs.normal(size=(2, 5, 12, d))
    out = triem.manifold_proj(torch.from_numpy(Y), torch.from_numpy(Z)).numpy()
    ref = np.asarray(jriem.manifold_proj(jnp.asarray(Y), jnp.asarray(Z)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
    # the result is horizontal: Y^T P is symmetric
    YtP = np.swapaxes(Y, -1, -2) @ out
    np.testing.assert_allclose(YtP, np.swapaxes(YtP, -1, -2), rtol=0, atol=1e-9)
