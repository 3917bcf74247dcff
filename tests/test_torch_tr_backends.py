"""The trust-region solver's "dense" and "edge" backends (TRParams.backend)
against the JAX package's same backends, on the CPU at float64.

Inputs are made with numpy from seeds and handed to both packages: UR10
(d = 3, joint limits) and planar6 (d = 2) from the JAX prepare stage, and
UR10 among the three spheres of tests/test_anchored.py (the anchored
reduction) from world-frame starts near a second random configuration.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import riemannian as triem

torch.set_num_threads(1)

OBS3 = [
    (np.array([0.5, 0.5, 0.5]), 0.25),
    (np.array([-0.5, 0.4, 0.8]), 0.2),
    (np.array([0.2, -0.6, 0.3]), 0.3),
]
PROD = dict(plateau_every=16, plateau_rtol=1e-4)
MAXINNER = {"ur10": 24, "planar6": 24, "obs3": 32}


def _prepared(jt, ps, seed, d, B=8):
    omega, psi_L, psi_U = ps.masks()
    q = np.random.RandomState(seed).uniform(jt.lb[1:], jt.ub[1:], size=(B, jt.n))
    inst = ps.instance(jkin.all_poses(jt, jnp.asarray(q))[:, jt.ee], smooth=True, smooth_iters=2)
    Y0 = np.array(jriem.generate_initialization(inst["lb"], inst["ub"], jnp.asarray(omega), d))
    return (omega, psi_L, psi_U), None, Y0, np.array(inst["D_goal"])


def _obs3(B=8):
    jt, ps = jlib.load_ur10()
    rs = np.random.RandomState(11)
    q = rs.uniform(jt.lb[1:], jt.ub[1:], size=(B, 6))
    q2 = rs.uniform(jt.lb[1:], jt.ub[1:], size=(B, 6))
    T = jkin.all_poses(jt, jnp.asarray(q))[:, jt.ee]
    Yw = np.array(ps.realization(jnp.asarray(q2)))
    spec = JPS.from_template(jt, obstacles=OBS3).reduced_spec()
    D = np.array(ps.instance(T, smooth=False)["D_goal"])
    return ps.masks(), spec, Yw[:1] + 0.05 * rs.normal(size=Yw.shape), D


@pytest.fixture(scope="module")
def problems():
    """name -> (masks, anchors, Y0, D_goal), float64."""
    return {
        "ur10": _prepared(*jlib.load_ur10(), 0, 3),
        "planar6": _prepared(*jlib.load_planar_chain(6, limits=np.pi / 2), 3, 2),
        "obs3": _obs3(),
    }


def _both(prob, name, **kw):
    """(JAX result, port result) as numpy dicts for the same params."""
    masks, spec, Y0, D = prob
    kw = dict(maxinner=MAXINNER[name], **PROD, **kw)
    ref = jriem.solve(jnp.asarray(Y0), jnp.asarray(D), *masks, params=jriem.TRParams(**kw),
                      anchors=spec)
    out = triem.solve(torch.from_numpy(Y0), torch.from_numpy(D), *masks,
                      params=triem.TRParams(**kw), anchors=spec)
    assert out["Y"].dtype == torch.float64
    return ({k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()})


def _same_lanes(ref, out, atol):
    np.testing.assert_array_equal(out["iterations"], ref["iterations"])
    np.testing.assert_array_equal(out["num_inner"], ref["num_inner"])
    np.testing.assert_allclose(out["Y"], ref["Y"], rtol=0, atol=atol)


@pytest.mark.parametrize("backend", ["dense", "edge"])
@pytest.mark.parametrize("name", ["ur10", "obs3", "planar6"])
def test_follows_jax_lane_for_lane(problems, name, backend):
    """Per-lane iterations and inner steps equal, and Y close, over the
    horizon that holds on these seeded goals for both backends. UR10 and
    the spheres: 15 iterations, Y within 1e-3 (seen: 4.6e-4 dense, 1.4e-4
    edge; one TR step is bitwise JAX's, and the lanes part from ~1e-15 at
    5 iterations as rounding grows; past 15 the inner-step counts of the
    sphere scene's edge backend part, of UR10's dense backend past 20 -
    JAX's own dense and edge backends part by ~1e-5 in Y by 10). planar6:
    5 iterations, Y within 1e-5 (seen: 6.2e-7): it meets the gradnorm stop
    in ~8 iterations at float64, after which the inner steps of its
    finished lanes count rounding noise, and its lanes (a redundant chain)
    can settle at different points of their solution set."""
    it, atol = (5, 1e-5) if name == "planar6" else (15, 1e-3)
    ref, out = _both(problems[name], name, maxiter=it, backend=backend)
    _same_lanes(ref, out, atol)


@pytest.mark.parametrize("backend", ["dense", "edge"])
@pytest.mark.parametrize("name", ["ur10", "obs3", "planar6"])
def test_cost_close_to_jax_at_30(problems, name, backend):
    """30 iterations: the same iterations per lane and the per-lane cost
    within 10x of JAX's, or both below 1e-12 (a float64 lane at the
    gradnorm stop has a cost of rounding size, ~1e-20)."""
    ref, out = _both(problems[name], name, maxiter=30, backend=backend)
    np.testing.assert_array_equal(out["iterations"], ref["iterations"])
    lo = np.maximum(out["cost"], 1e-12) / np.maximum(ref["cost"], 1e-12)
    assert np.all((lo < 10) & (lo > 0.1)), (out["cost"], ref["cost"])


@pytest.mark.parametrize("backend", ["dense", "edge"])
def test_res_tol_against_jax(problems, backend):
    """res_tol = 0.05 on UR10: lanes stop on their residual at different
    iterations, as JAX's do, over the 15-iteration horizon."""
    ref, out = _both(problems["ur10"], "ur10", maxiter=15, res_tol=0.05, backend=backend)
    assert len(set(ref["iterations"].tolist())) > 1
    _same_lanes(ref, out, 1e-3)


def test_check_model_decrease_solve_against_jax(problems):
    """check_model_decrease=True through the whole solve, UR10 "dense",
    10 iterations: lane for lane as without it."""
    ref, out = _both(problems["ur10"], "ur10", maxiter=10, backend="dense",
                     check_model_decrease=True)
    _same_lanes(ref, out, 1e-5)


def _tcg_inputs(seed=0, B=12, n=12, skew=0.8):
    """Per-lane Hessian stand-ins A = Q Q^T + I + skew K (K antisymmetric):
    not symmetric, as for the nonlinear Hessian approximations the guard is
    for, so the tCG model can rise. grad (B, n // 2, 2), Delta (B,)."""
    rs = np.random.RandomState(seed)
    Q = rs.normal(size=(B, n, n)) / np.sqrt(n)
    K = rs.normal(size=(B, n, n))
    A = Q @ np.swapaxes(Q, 1, 2) + np.eye(n) + skew * (K - np.swapaxes(K, 1, 2))
    g = rs.normal(size=(B, n // 2, 2))
    Delta = rs.uniform(0.5, 3.0, size=B)
    return A, g, Delta


@pytest.mark.parametrize("check", [False, True])
def test_tcg_model_increase_exit_against_jax(check):
    """The tCG alone against JAX's `_tcg` (vmapped) with a non-symmetric
    operator: eta, Heta, inner steps and the boundary exit per lane. With
    the guard on, JAX takes the model-increase exit on some lanes and the
    port stops there too, with the previous eta."""
    A, g, Delta = _tcg_inputs()
    n = A.shape[-1]
    p = dict(maxinner=n, check_model_decrease=check)
    jp = jriem.TRParams(**p)

    def one(A_i, g_i, D_i):
        return jriem._tcg(lambda v: (A_i @ v.reshape(-1)).reshape(v.shape), g_i, D_i, jp, n)

    eta_j, Heta_j, j_j, stop_j = (np.asarray(x) for x in jax.vmap(one)(A, g, Delta))
    At = torch.from_numpy(A)
    tp = triem.TRParams(**p)
    gt = torch.from_numpy(g)
    t = triem._tcg_steps(triem._tcg_start(gt, torch.ones(len(g), dtype=torch.bool), tp), gt,
                         torch.from_numpy(Delta),
                         lambda v: (At @ v.reshape(v.shape[0], n, 1)).reshape(v.shape), tp,
                         tuple(j >= tp.mininner for j in range(n)))
    eta, Heta, steps, boundary = t["eta"], t["Heta"], t["steps"], t["boundary"]
    assert (stop_j == jriem.MODEL_INCREASED).any() == check
    np.testing.assert_array_equal(steps.numpy(), j_j)
    np.testing.assert_array_equal(boundary.numpy(), stop_j <= jriem.EXCEEDED_TR)
    np.testing.assert_allclose(eta.numpy(), eta_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Heta.numpy(), Heta_j, rtol=0, atol=1e-12)


def test_edge_matches_dense_in_the_port():
    """The TR over the edge form equals the dense masked form through the
    api (as tests/test_riemannian.py holds CG's two backends): planar6, two
    goals, float64, one start, no polish."""
    _, ps = tlib.load_planar_chain(6, limits=np.pi / 2)
    T, _ = tapi.random_goals(ps, (2,), torch.Generator().manual_seed(9), dtype=torch.float64,
                             device="cpu")
    Y_init = ps.realization(torch.zeros(ps.n, dtype=torch.float64))
    outs = {b: tapi.solve_ik(ps, T, params=triem.TRParams(maxiter=400, backend=b),
                             Y_init=Y_init, polish=False)
            for b in ("dense", "edge")}
    np.testing.assert_allclose(outs["edge"]["cost"].numpy(), outs["dense"]["cost"].numpy(),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(outs["edge"]["e_pos"].numpy(), outs["dense"]["e_pos"].numpy(),
                               atol=1e-6)


def test_float64_routes_to_dense(problems):
    """backend "kernel" with float64 inputs runs "dense" (the JAX package's
    dispatch: tests/test_tr_pallas.py's f64 routing), on any device."""
    masks, _, Y0, D = problems["ur10"]
    Y, Dg = torch.from_numpy(Y0), torch.from_numpy(D)
    via = triem.solve(Y, Dg, *masks, params=triem.TRParams(maxiter=3))
    dense = triem.solve(Y, Dg, *masks, params=triem.TRParams(maxiter=3, backend="dense"))
    assert via["Y"].dtype == torch.float64
    for k in dense:
        assert torch.equal(via[k], dense[k]), k


def test_unknown_backend_raises(problems):
    masks, _, Y0, D = problems["ur10"]
    with pytest.raises(ValueError, match="backend"):
        triem.solve(torch.from_numpy(Y0), torch.from_numpy(D), *masks,
                    params=triem.TRParams(maxiter=1, backend="pallas"))


@pytest.mark.parametrize("backend", ["dense", "edge"])
def test_host_read_interval_changes_nothing(problems, backend, monkeypatch):
    """Reading the flags after every inner step or every fifth gives
    bitwise-equal results: extra steps on finished lanes change nothing."""
    masks, spec, Y0, D = problems["obs3"]
    outs, reads = [], []
    for every in (1, 5):
        monkeypatch.setattr(triem, "TR_READ_EVERY", every)
        triem.solve.host_reads = 0
        outs.append(triem.solve(torch.from_numpy(Y0), torch.from_numpy(D), *masks, anchors=spec,
                                params=triem.TRParams(maxiter=20, maxinner=32, backend=backend,
                                                      res_tol=0.05, **PROD)))
        reads.append(triem.solve.host_reads)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert reads[0] > reads[1] > 0


@pytest.mark.parametrize("d", [4, 5])
def test_manifold_proj_general_d(d):
    """The d^2 x d^2 branch of the horizontal projection against JAX's."""
    rs = np.random.RandomState(d)
    Y, Z = rs.normal(size=(2, 5, 12, d))
    out = triem.manifold_proj(torch.from_numpy(Y), torch.from_numpy(Z)).numpy()
    ref = np.asarray(jax.jit(jriem.manifold_proj)(jnp.asarray(Y), jnp.asarray(Z)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
    YtP = np.swapaxes(Y, -1, -2) @ out
    np.testing.assert_allclose(YtP, np.swapaxes(YtP, -1, -2), rtol=0, atol=1e-9)
