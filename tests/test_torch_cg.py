"""The dense costs and the Riemannian conjugate-gradient solver: the port
against the JAX package (graphik_tpu/solvers/costs.py, ops/edge.py::egrad,
solvers/riemannian.py::solve_cg) and the mirrors of
tests/test_riemannian.py's cost-calculus and CG tests.

Inputs are numpy (seeded draws, or the JAX tests' own goals) handed to both
packages, float64. The costs agree to 1e-10 relative to each output's
scale. solve_cg follows JAX's solve_cg lane for lane - iterations equal, Y
and cost within 1e-7 - over 20 iterations (measured: 2.3e-8 and below).
Past ~30 iterations the float64 trajectories part, as the JAX package's
own dense and edge backends do (on UR10 they are 3.3e-9 apart in Y at 20
iterations and 0.15 at 50), so the longer runs are held to the JAX tests'
absolute criteria.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphik_tpu import api as japi
from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.ops import edge as jedge
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.robots.templates import planar_from_links
from graphik_tpu.solvers import costs as jcosts
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch import interop
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import costs as tcosts
from graphik_tpu_torch.solvers import riemannian as triem

torch.set_num_threads(1)

OBS3 = [
    (np.array([0.5, 0.5, 0.5]), 0.25),
    (np.array([-0.5, 0.4, 0.8]), 0.2),
    (np.array([0.2, -0.6, 0.3]), 0.3),
]


def structure(name):
    """The JAX ProblemStructure of one scene (the port's comes through
    interop, field for field)."""
    if name == "planar6":
        return jlib.load_planar_chain(6, limits=np.pi / 2)[1]
    return JPS.from_template(jlib.load_ur10()[0], obstacles=OBS3 if name == "obs3" else None)


def problem(name, B=6, seed=0):
    """(masks over the solved nodes, anchor spec or None, Y0, D_goal), float64
    numpy: goals of seeded configurations and the JAX package's MDS init
    from the smoothed bounds. With obstacles (over the robot's Nr nodes),
    Y0 is instead the world-frame realization of other seeded
    configurations plus noise, where the spheres' hinges are active (the
    MDS init lies in its own frame, away from them)."""
    ps = structure(name)
    tpl = ps.template
    rs = np.random.RandomState(seed)
    q = rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    T = jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee]
    spec = ps.reduced_spec()
    M = ps.N if spec is None else spec["Nr"]
    inst = ps.instance(T, smooth=True, n_nodes=None if spec is None else M)
    om, pl, pu = (m[:M, :M] for m in ps.masks())
    if spec is None:
        Y0 = jriem.generate_initialization(inst["lb"], inst["ub"], jnp.asarray(om), ps.dim)
    else:
        q2 = rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
        Y0 = np.asarray(ps.realization(jnp.asarray(q2)))[:, :M] + 0.05 * rs.normal(size=(B, M, 3))
    return (om, pl, pu), spec, np.array(Y0), np.array(inst["D_goal"])


def dense_args(masks):
    om, pl, pu = (np.asarray(m, np.float64) for m in masks)
    return (om, pl, pu) + tuple(jcosts.make_masks(om, pl, pu))


@pytest.fixture(scope="module", params=["planar6", "ur10", "obs3"])
def cost_inputs(request):
    """Points near the solved configuration (the init plus noise) and a
    direction Z, with the scene's masks, anchors and goal distances."""
    masks, spec, Y0, D = problem(request.param)
    rs = np.random.RandomState(1)
    Y = Y0 + 0.3 * rs.normal(size=Y0.shape)
    Z = rs.normal(size=Y0.shape)
    return request.param, dense_args(masks), spec, Y, Z, D


def close(out, ref, what, tol=1e-10):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale, err_msg=what)


def test_costs_match_jax(cost_inputs):
    """residuals, cost, egrad, cost_and_egrad, ehess and residual_max, with
    the anchored hinges on the 3-sphere scene, batched over 6 instances, and
    _adj / _adj_mv."""
    name, args, spec, Y, Z, D = cost_inputs
    tY, tZ, tD = torch.from_numpy(Y), torch.from_numpy(Z), torch.from_numpy(D)
    jY, jZ, jD = jnp.asarray(Y), jnp.asarray(Z), jnp.asarray(D)
    jargs = tuple(jnp.asarray(a) for a in args)
    for out, ref in zip(tcosts.residuals(tY, tD, *args), jcosts.residuals(jY, jD, *jargs)):
        close(out, ref, f"{name} residuals")
    close(tcosts.cost(tY, tD, *args, spec), jcosts.cost(jY, jD, *jargs, spec), f"{name} cost")
    close(tcosts.egrad(tY, tD, *args, spec), jcosts.egrad(jY, jD, *jargs, spec), f"{name} egrad")
    f_t, g_t = tcosts.cost_and_egrad(tY, tD, *args, spec)
    f_j, g_j = jcosts.cost_and_egrad(jY, jD, *jargs, spec)
    close(f_t, f_j, f"{name} cost_and_egrad f")
    close(g_t, g_j, f"{name} cost_and_egrad g")
    close(tcosts.ehess(tY, tZ, tD, *args, spec), jcosts.ehess(jY, jZ, jD, *jargs, spec),
          f"{name} ehess")
    close(tcosts.residual_max(tY, tD, *args, spec), jcosts.residual_max(jY, jD, *jargs, spec),
          f"{name} residual_max")
    S = tD - tY @ tY.transpose(-1, -2)
    close(tcosts._adj(S), jcosts._adj(jnp.asarray(S.numpy())), f"{name} _adj")
    close(tcosts._adj_mv(S, tY), jcosts._adj_mv(jnp.asarray(S.numpy()), jY), f"{name} _adj_mv")


def test_anchor_terms_are_active():
    """The 3-sphere scene's hinges add to the cost at the cost tests' points
    and at the CG tests' starts, so the anchored terms are exercised."""
    masks, spec, Y0, D = problem("obs3")
    args = dense_args(masks)
    for Y in (Y0 + 0.3 * np.random.RandomState(1).normal(size=Y0.shape), Y0):
        tY, tD = torch.from_numpy(Y), torch.from_numpy(D)
        assert bool((tcosts.cost(tY, tD, *args, spec) > tcosts.cost(tY, tD, *args)).any())


def test_egrad_and_ehess_match_autograd(cost_inputs):
    """egrad is half of the true gradient of cost (the reference's
    convention, kept by both packages) and ehess is the derivative of
    egrad along Z, anchors included: against torch.autograd, to 1e-9
    relative to the norm."""
    name, args, spec, Y, Z, D = cost_inputs
    tD = torch.from_numpy(D)
    Yv = torch.from_numpy(Y).requires_grad_(True)
    g_auto, = torch.autograd.grad(tcosts.cost(Yv, tD, *args, spec).sum(), Yv)
    g = tcosts.egrad(torch.from_numpy(Y), tD, *args, spec)
    scale = float(g_auto.norm())
    assert float((2.0 * g - g_auto).norm()) <= 1e-9 * scale
    _, hz_auto = torch.func.jvp(lambda y: tcosts.egrad(y, tD, *args, spec),
                                (torch.from_numpy(Y),), (torch.from_numpy(Z),))
    hz = tcosts.ehess(torch.from_numpy(Y), torch.from_numpy(Z), tD, *args, spec)
    assert float((hz - hz_auto).norm()) <= 1e-9 * float(hz_auto.norm())


def test_cost_zero_at_truth():
    """The realization of the goal configuration has zero cost."""
    jps = JPS.from_template(planar_from_links(np.ones(6)))
    ps = interop.structure_from_numpy(dataclasses.asdict(jps))
    q = np.random.RandomState(0).uniform(-np.pi, np.pi, ps.n)
    T = jkin.pose(jps.template, jnp.asarray(q), int(jps.template.ee[0]))
    D = torch.from_numpy(np.asarray(jps.instance(T, smooth=False)["D_goal"]))
    Y = ps.realization(torch.from_numpy(q))
    f = tcosts.cost(Y, D, *dense_args(ps.masks()))
    assert float(f) < 1e-12


def test_edge_egrad_matches_jax(cost_inputs):
    """ops/edge.py::egrad over the compiled edge form, anchors included."""
    name, args, spec, Y, Z, D = cost_inputs
    om, pl, pu = args[:3]
    jep = jedge.build_edge_problem(om, pl, pu, dim=Y.shape[-1], anchors=spec)
    tep = tedge.build_edge_problem(om, pl, pu, dim=Y.shape[-1], anchors=spec)
    dg = np.asarray(jep.edge_values(jnp.asarray(D)))
    close(tedge.egrad(tep, torch.from_numpy(Y), torch.from_numpy(dg)),
          jedge.egrad(jep, jnp.asarray(Y), jnp.asarray(dg)), f"{name} edge egrad")


# ---------------------------------------------------------------------------
# solve_cg against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "edge"])
@pytest.mark.parametrize("name", ["planar6", "ur10", "obs3"])
def test_solve_cg_matches_jax(name, backend):
    """20 CG iterations from the same Y0: iterations equal per lane, Y and
    cost within 1e-7 (of 1 and of the cost's scale; measured 9e-9 and 2.3e-8
    at most), gradnorm within 1e-6 (it moves with the Hessian times dY:
    measured 5.5e-7 on the anchored edge case), num_inner all zero."""
    masks, spec, Y0, D = problem(name)
    kw = dict(maxiter=20, backend=backend)
    ref = jriem.solve_cg(jnp.asarray(Y0), jnp.asarray(D), *masks,
                         params=jriem.CGParams(**kw), anchors=spec)
    out = triem.solve_cg(torch.from_numpy(Y0), torch.from_numpy(D), *masks,
                         params=triem.CGParams(**kw), anchors=spec)
    assert sorted(out) == sorted(ref)
    np.testing.assert_array_equal(out["iterations"].numpy(), np.asarray(ref["iterations"]))
    np.testing.assert_array_equal(out["num_inner"].numpy(), 0)
    close(out["Y"], ref["Y"], f"{name} Y", tol=1e-7)
    close(out["cost"], ref["cost"], f"{name} cost", tol=1e-7)
    close(out["gradnorm"], ref["gradnorm"], f"{name} gradnorm", tol=1e-6)


def test_solve_cg_stops_per_lane():
    """A plateau stop every 4 iterations with a loose rtol, and a stepsize
    floor of 1e-3, so that lanes stop at 3 or more different iterations
    (each frozen from then on): iterations per lane equal to JAX's, Y and
    cost within 1e-7."""
    masks, spec, Y0, D = problem("ur10", B=8, seed=2)
    kw = dict(maxiter=24, plateau_every=4, plateau_rtol=0.08, minstepsize=1e-3)
    ref = jriem.solve_cg(jnp.asarray(Y0), jnp.asarray(D), *masks, params=jriem.CGParams(**kw))
    out = triem.solve_cg(torch.from_numpy(Y0), torch.from_numpy(D), *masks,
                         params=triem.CGParams(**kw))
    iters = np.asarray(ref["iterations"])
    assert len(set(iters.tolist())) >= 3, iters
    np.testing.assert_array_equal(out["iterations"].numpy(), iters)
    close(out["Y"], ref["Y"], "Y", tol=1e-7)
    close(out["cost"], ref["cost"], "cost", tol=1e-7)


def test_solve_ik_cg_with_anchors_matches_jax():
    """The api dispatch on CGParams, on the obstacle path (the anchored
    reduction, obstacles padded back into Y): solve_ik from a given Y_init,
    20 iterations, no polish, against the JAX package's solve_ik."""
    jps = structure("obs3")
    tps = interop.structure_from_numpy(dataclasses.asdict(jps))
    tpl = jps.template
    q = np.random.RandomState(4).uniform(tpl.lb[1:], tpl.ub[1:], size=(4, tpl.n))
    T = np.asarray(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])
    q0 = np.random.RandomState(5).uniform(tpl.lb[1:], tpl.ub[1:], size=(tpl.n,))
    Y_init = np.asarray(jps.realization(jnp.asarray(q0)))
    kw = dict(maxiter=20)
    ref = japi.solve_ik(jps, jnp.asarray(T), params=jriem.CGParams(**kw),
                        Y_init=jnp.asarray(Y_init), polish=False)
    out = tapi.solve_ik(tps, torch.from_numpy(T), params=triem.CGParams(**kw),
                        Y_init=torch.from_numpy(Y_init), polish=False)
    assert sorted(out) == sorted(ref)
    np.testing.assert_array_equal(out["iterations"].numpy(), np.asarray(ref["iterations"]))
    close(out["Y"], ref["Y"], "Y", tol=1e-7)
    close(out["cost"], ref["cost"], "cost", tol=1e-7)
    np.testing.assert_array_equal(out["Y"][:, spec_nr(jps):].numpy(),
                                  np.broadcast_to(jps.pos_fixed[spec_nr(jps):], (4, 3, 3)))


def spec_nr(ps):
    return ps.reduced_spec()["Nr"]


def test_make_solver_cg_end_to_end_f32():
    """make_solver with CGParams.production() on UR10 at float32 on the CPU,
    the UR10 path's 10-step polish and 2-squaring smoothing, on 16 goals:
    the JAX package's output keys, shapes, finite values, num_inner zero,
    no TR kernel launch, and a success count within 4 of the JAX package's
    on the same goals (float32 CG trajectories part; 4 is the two-sample
    95% limit 1.96 sqrt(2 n p (1 - p)) at n = 16, p = 0.79, the JAX
    package's rate on 1000 goals, tools/torch_parity.py ur10_cg)."""
    from graphik_tpu.solvers.local import LocalParams as JLocalParams
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda
    from graphik_tpu_torch.solvers.local import LocalParams

    jps = structure("ur10")
    tps = tlib.load_ur10()[1]
    tpl = jps.template
    q = np.random.RandomState(6).uniform(tpl.lb[1:], tpl.ub[1:], size=(16, tpl.n))
    T = np.asarray(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee], np.float32)
    launches = solve_tr_cuda.launches
    solver = tapi.make_solver(tps, params=triem.CGParams.production(),
                              polish_params=LocalParams(maxiter=10, tol_grad=1e-8),
                              smooth_iters=2, device="cpu")
    out = solver(T)
    assert solve_tr_cuda.launches == launches
    ref = japi.make_solver(jps, params=jriem.CGParams.production(), dtype=jnp.float32,
                           polish_params=JLocalParams(maxiter=10, tol_grad=1e-8),
                           smooth_iters=2)(jnp.asarray(T))
    assert sorted(out) == sorted(ref)
    assert out["Y"].shape == (16, tps.N, 3) and out["Y"].dtype == torch.float32
    for k, v in out.items():
        assert v.shape[0] == 16 and bool(torch.isfinite(v.double()).all()), k
    assert not bool(out["num_inner"].any())
    ok_t = tapi.summarize(out)["success_rate"] * 16
    ok_j = float(np.mean((np.asarray(ref["e_pos"]) < 1e-3) & (np.asarray(ref["e_rot"]) < np.pi / 180)
                         & np.asarray(ref["success"]))) * 16
    assert abs(ok_t - ok_j) <= 4, (ok_t, ok_j)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_riemannian.py (CG), on the port, with its inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planar6():
    """The JAX tests' planar6 (planar_from_links(np.ones(6))): (JAX, port)."""
    jps = JPS.from_template(planar_from_links(np.ones(6)))
    return jps, interop.structure_from_numpy(dataclasses.asdict(jps))


def jax_goals(jps, key, n):
    return torch.from_numpy(np.asarray(japi.random_goals(jps, jax.random.PRNGKey(key), (n,))[0]))


def test_conjugate_gradient_backend(planar6):
    """CG solves the instances through the same api pipeline as TR."""
    jps, ps = planar6
    out = tapi.solve_ik(ps, jax_goals(jps, 6, 4), params=triem.CGParams(maxiter=1500))
    assert np.all(out["e_pos"].numpy() < 1e-2), (out["e_pos"], out["gradnorm"],
                                                 out["iterations"])
    assert np.all(out["e_rot"].numpy() < 1e-2)


def test_cg_edge_backend_matches_dense(planar6):
    """CG over the edge form equals the dense masked cost path once both have
    converged. The JAX test runs 400 iterations; here 1500: the float64
    trajectories part after ~30 iterations, and the port's edge path needs
    705 iterations on lane 0 (JAX's 331, its dense path 267, the port's
    dense 315), where it stands at cost 4.6e-10 after 400. That lane is the
    tail of a distribution JAX's edge path has too, not a slower edge path:
    on 128 planar6 goals (tools/cg_iterations.py, keys 0 and 1) the port's
    edge path needs more iterations than JAX's on 62 goals and fewer on 63,
    at means of 309 and 333 against JAX's 319 and 350, and JAX's edge path
    needs up to 1,964 where its dense one needs at most 1,248."""
    jps, ps = planar6
    T = jax_goals(jps, 9, 2)
    Y_init = ps.realization(torch.zeros(ps.n, dtype=torch.float64))
    outs = {b: tapi.solve_ik(ps, T, params=triem.CGParams(maxiter=1500, backend=b),
                             use_limits=True, Y_init=Y_init, polish=False)
            for b in ("dense", "edge")}
    np.testing.assert_allclose(outs["edge"]["cost"].numpy(), outs["dense"]["cost"].numpy(),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(outs["edge"]["e_pos"].numpy(), outs["dense"]["e_pos"].numpy(),
                               atol=1e-6)


def test_cg_matches_tr_cost_no_limits(planar6):
    """From the same init, CG and TR reach comparable final costs on the
    unconstrained EDM completion."""
    jps, ps = planar6
    T = jax_goals(jps, 8, 3)
    Y_init = ps.realization(torch.zeros(ps.n, dtype=torch.float64))
    tr = tapi.solve_ik(ps, T, params=triem.TRParams.production(maxiter=1500),
                       use_limits=False, Y_init=Y_init, polish=False)
    cg = tapi.solve_ik(ps, T, params=triem.CGParams(maxiter=3000),
                       use_limits=False, Y_init=Y_init, polish=False)
    assert np.all(cg["cost"].numpy() < 1e-8), cg["cost"]
    assert np.all(cg["e_pos"].numpy() < 1e-3), cg["e_pos"]
    assert np.all(tr["cost"].numpy() < 1e-8)


def test_default_params_reference_faithful():
    """Library defaults stop on gradnorm / maxiter only; the production
    presets opt into the plateau stop; overrides pass through."""
    assert triem.CGParams().plateau_every == 0
    assert triem.CGParams.production().plateau_every == 16
    assert triem.CGParams.production(maxiter=7).maxiter == 7
    assert triem.CGParams().backend == "dense"
    for f in dataclasses.fields(jriem.CGParams):
        assert getattr(triem.CGParams(), f.name) == getattr(jriem.CGParams(), f.name), f.name
