"""Robots past 64 nodes: the port against the JAX package where the kernels'
old limits (N, n, m <= 64, E <= 256) stood. On the CPU the plain versions
take any size, as the JAX package does; on a card the kernels take N, n,
m <= 128 and E <= 512 (tests/test_torch_cuda.py -k past_64 holds them
bitwise to these plain versions there).

* `ops/eigh.py::sym_eigh_reference` at n = 67, 104 and 128 against
  jnp.linalg.eigh (eigenvalues and the rebuilt matrix V diag(w) V^T).
* `ops/linalg.py::spd_solve_reference` against spd_solve_unrolled at m = 65,
  and against numpy's float64 solve at m = 100 and 128.
* The plain TR version against the JAX package on planar64 (N = 67, its
  "edge" backend), dh31 (N = 66, d = 3, the Pallas kernel in interpret
  mode) and dh40 (N = 84, E = 272 past 256 edges, the "edge" backend).
* `api.solve_ik` on planar64 and planar100 against the JAX package's, the
  compiled solver (`make_solver(device="cpu")`) on planar100 against the
  JAX package's and against the port's eager stages: sizes the port
  refused before.

planar<n> is load_planar_chain(n, limits=pi/2) (N = n + 3); dh<n> is
tools/torch_parity.py's n-DoF DH chain (N = 2n + 4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphik_tpu import api as japi
from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.ops import edge as jedge
from graphik_tpu.ops import linalg as jlinalg
from graphik_tpu.ops.tr_pallas import solve_tr_pallas
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.robots.templates import revolute_from_dh as jdh
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.ops import eigh as teigh
from graphik_tpu_torch.ops import linalg as tlinalg
from graphik_tpu_torch.ops import tr_solve
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.robots.templates import revolute_from_dh as tdh
from graphik_tpu_torch.solvers.local import LocalParams as TLocalParams
from graphik_tpu_torch.solvers.riemannian import TRParams as TTRParams

torch.set_num_threads(1)


def dh_chain(n, revolute_from_dh):
    """An n-DoF DH chain drawn from RandomState(n): a ~ U(0.1, 0.5),
    d ~ U(0, 0.3), alpha from {-pi/2, 0, pi/2}, limits +-pi/2."""
    rs = np.random.RandomState(n)
    a = rs.uniform(0.1, 0.5, n)
    d = rs.uniform(0.0, 0.3, n)
    alpha = rs.choice([-np.pi / 2, 0.0, np.pi / 2], n)
    return revolute_from_dh(a, alpha, d, np.zeros(n), lb=-np.pi / 2, ub=np.pi / 2)


@functools.lru_cache(maxsize=None)
def structures(robot):
    """(JAX structure, port structure) of planar<n> or dh<n>."""
    if robot.startswith("planar"):
        n = int(robot[6:])
        return (jlib.load_planar_chain(n, limits=np.pi / 2)[1],
                tlib.load_planar_chain(n, limits=np.pi / 2)[1])
    n = int(robot[2:])
    return JPS.from_template(dh_chain(n, jdh)), TPS.from_template(dh_chain(n, tdh))


def goals(tpl, seed, B):
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return np.asarray(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee], np.float32)


# ---------------------------------------------------------------------------
# K5's plain version past n = 64
# ---------------------------------------------------------------------------

def _symmetric_stack(n, dtype, seed):
    """Four matrices: spread eigenvalues in a random basis, a rank-3 Gram
    (MDS's case), and two random symmetric ones."""
    rs = np.random.RandomState(seed)
    Q = np.linalg.qr(rs.normal(size=(n, n)))[0]
    X = rs.normal(size=(n, 3))
    S = rs.normal(size=(2, n, n))
    return np.stack([(Q * np.linspace(-3.0, 5.0, n)) @ Q.T, X @ X.T,
                     *(S + np.swapaxes(S, 1, 2))]).astype(dtype)


@pytest.mark.parametrize("n", [67, 104, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_sym_eigh_reference_past_64(n, dtype):
    """Every matrix converged; the eigenvalues and the rebuilt matrix V
    diag(w) V^T against jnp.linalg.eigh's, and V^T V against I, within
    5e-4 (float32) or 1e-10 (float64) of the largest |eigenvalue|. (Vs
    are not compared: the Gram's repeated zero eigenvalue has no unique
    basis.)"""
    A = _symmetric_stack(n, dtype, n)
    w, V, conv = teigh.sym_eigh_reference(torch.from_numpy(A))
    assert bool(conv.all())
    w, V = w.numpy().astype(np.float64), V.numpy().astype(np.float64)
    wj, Vj = (np.asarray(x, np.float64) for x in jnp.linalg.eigh(jnp.asarray(A)))
    tol = 5e-4 if dtype == np.float32 else 1e-10
    scale = np.abs(wj).max(-1)[:, None]
    np.testing.assert_allclose(w / scale, wj / scale, rtol=0, atol=tol)
    G = (V * w[:, None, :]) @ np.swapaxes(V, 1, 2)
    Gj = (Vj * wj[:, None, :]) @ np.swapaxes(Vj, 1, 2)
    np.testing.assert_allclose(G / scale[:, :, None], Gj / scale[:, :, None], rtol=0, atol=tol)
    np.testing.assert_allclose(np.swapaxes(V, 1, 2) @ V, np.broadcast_to(np.eye(n), V.shape),
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# K6's plain version past m = 64
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_spd_compiled(shape_A, shape_b, dtype):
    A, b = jax.ShapeDtypeStruct(shape_A, dtype), jax.ShapeDtypeStruct(shape_b, dtype)
    return jax.jit(jlinalg.spd_solve_unrolled).lower(A, b).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _lm_systems(m, dtype, seed, B=16):
    """SPD systems (X X^T / m + I) and well-damped LM systems (J^T J + lam
    I, J 3 x m as planar100's pose rows, lam from 1e-3 to 1e-1), 8 each."""
    rs = np.random.RandomState(seed)
    X = rs.normal(size=(B // 2, m, m))
    J = rs.normal(size=(B // 2, 3, m))
    lam = np.logspace(-3, -1, B // 2)[:, None, None]
    A = np.concatenate([X @ np.swapaxes(X, 1, 2) / m + np.eye(m),
                        np.swapaxes(J, 1, 2) @ J + lam * np.eye(m)])
    return A.astype(dtype), rs.normal(size=(B, m)).astype(dtype)


@pytest.mark.parametrize("m", [65, 100, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_spd_solve_reference_past_64(m, dtype):
    """The plain version against spd_solve_unrolled at m = 65 and, at m =
    100 and 128 (where XLA's compile of the unrolled solve takes longer),
    against numpy's float64 solve: within m eps cond(A) of the largest
    entry of the step (tests/test_torch_spd.py's bound for two summation
    orders of a backward-stable solve)."""
    A, b = _lm_systems(m, dtype, seed=m)
    x = tlinalg.spd_solve_reference(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert x.dtype == dtype
    if m == 65:
        ref = np.asarray(_jax_spd_compiled(A.shape, b.shape, A.dtype)(jnp.asarray(A),
                                                                       jnp.asarray(b)))
    else:
        ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    cond = np.linalg.cond(A.astype(np.float64))
    bound = m * np.finfo(dtype).eps * cond * np.abs(ref).max(-1)
    assert np.isfinite(x).all()
    assert (np.abs(x - ref).max(-1) <= bound).all()


# ---------------------------------------------------------------------------
# The plain TR version past 64 nodes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tr_problem(robot):
    """4 goals; Y0 and the goal distances at float32 from the JAX package's
    prepare (full bound smoothing), handed to both packages."""
    jps, _ = structures(robot)
    tpl = jps.template
    omega, psi_L, psi_U = jps.masks()
    inst = jps.instance(jnp.asarray(goals(tpl, 0, 4)), smooth=True, smooth_iters=None)
    Y0 = np.array(jriem.generate_initialization(
        inst["lb"], inst["ub"], jnp.asarray(omega, jnp.float32), tpl.dim), np.float32)
    D = np.array(inst["D_goal"], np.float32)
    jep = jedge.build_edge_problem(omega, psi_L, psi_U, dim=tpl.dim)
    tep = tedge.build_edge_problem(omega, psi_L, psi_U, dim=tpl.dim)
    dg = np.array(jep.edge_values(jnp.asarray(D)))
    return (omega, psi_L, psi_U), jep, tep, Y0, D, dg


# the JAX package's TR backend for each robot: interpret mode stalls at d = 2,
# and past 256 edges
TR_BACKEND = {"planar64": "edge", "dh31": "pallas", "dh40": "edge"}


@pytest.mark.parametrize("robot,maxiter", [("planar64", 1), ("planar64", 3), ("dh31", 1),
                                           ("dh31", 3), ("dh40", 1), ("dh40", 3)])
def test_tr_reference_past_64_nodes(robot, maxiter):
    """The port's plain TR version against the JAX package at N = 67
    (planar64, d = 2, E = 137: the "edge" backend), N = 66 (dh31, d = 3,
    E = 184: the Pallas kernel in interpret mode) and N = 84 (dh40, d = 3,
    E = 272, the edge count past 256 that only the four-slot kernel takes on
    a card: the "edge" backend), with tests/test_torch_large.py's
    tolerances: cost rtol 2e-5, Y 1e-4, inner steps equal."""
    masks, jep, tep, Y0, D, dg = tr_problem(robot)
    assert tep.N > 64
    assert robot != "dh40" or tep.E > 256
    out = tr_solve.solve_tr_reference(tep, torch.from_numpy(Y0), torch.from_numpy(dg),
                                      maxiter=maxiter)
    out = {k: v.numpy() for k, v in out.items()}
    if TR_BACKEND[robot] == "edge":
        ref = jriem.solve(jnp.asarray(Y0), jnp.asarray(D), *masks,
                          params=jriem.TRParams(maxiter=maxiter, backend="edge"))
    else:
        ref = solve_tr_pallas(jep, jnp.asarray(Y0), jnp.asarray(dg), interpret=True,
                              maxiter=maxiter)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_allclose(out["cost"], ref["cost"], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(out["num_inner"], ref["num_inner"])
    np.testing.assert_allclose(out["Y"], ref["Y"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The whole solve on the CPU
# ---------------------------------------------------------------------------

def test_solve_ik_planar64_against_jax():
    """api.solve_ik at float32 on 4 planar64 goals (N = 67, m = 64 joints),
    3 TR iterations, no polish, against the JAX package's on its "edge"
    backend: the same iteration counts and limit verdicts, the cost and
    the pose errors within 2e-3, the 64 joint angles within 0.02 rad, Y's
    Gram within 2e-3 of its largest entry. The two MDS inits differ in
    their float32 rounding and by an orthogonal gauge (K5's sign rule is
    not LAPACK's); 3 iterations leave the costs 1e-4 apart, and the angles,
    each recovered from a 0.1-1 m link's end points, up to 0.0095 rad. (With
    the polish the verdicts part: from 3 iterations' Y, 10 LM steps on 64
    joints land on different goals' solutions in each package.)"""
    jps, tps = structures("planar64")
    T = goals(jps.template, 3, 4)
    jo = japi.solve_ik(jps, jnp.asarray(T), params=jriem.TRParams(maxiter=3, backend="edge"),
                       polish=False)
    to = tapi.solve_ik(tps, torch.from_numpy(T), params=TTRParams(maxiter=3), polish=False,
                       device="cpu")
    jo = {k: np.asarray(v) for k, v in jo.items()}
    to = {k: v.numpy() for k, v in to.items()}
    assert to["Y"].shape == jo["Y"].shape == (4, 67, 2) and to["q"].shape == (4, 64)
    np.testing.assert_array_equal(to["iterations"], jo["iterations"])
    np.testing.assert_array_equal(to["success"], jo["success"])
    for k in ("cost", "e_pos", "e_rot"):
        np.testing.assert_allclose(to[k], jo[k], rtol=2e-3, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(to["q"], jo["q"], rtol=0, atol=0.02)
    G, Gj = (y @ np.swapaxes(y, 1, 2) for y in (to["Y"].astype(np.float64), jo["Y"]))
    np.testing.assert_allclose(G, Gj, rtol=0, atol=2e-3 * np.abs(Gj).max())


def test_make_solver_on_the_cpu_planar100():
    """The compiled solver's CPU form on planar100 (N = 103, E = 209; the
    polish's LM systems m = 100; K5's n = 103): the path's parameters
    (full bound smoothing, the 10-step polish) at 3 TR iterations on 2
    goals run to the end with finite outputs of the path's shapes, no
    kernel launched, and the same outputs as api.solve_ik's eager
    stages."""
    _, tps = structures("planar100")
    T = torch.from_numpy(goals(structures("planar100")[0].template, 7, 2))
    params = TTRParams.production(maxiter=3, maxinner=24)
    polish = TLocalParams(maxiter=10, tol_grad=1e-8)
    counts = (tr_solve.solve_tr_cuda.launches, teigh.sym_eigh_cuda.launches,
              tlinalg.spd_solve_cuda.launches)
    solver = tapi.make_solver(tps, params=params, polish_params=polish, smooth_iters=None,
                              device="cpu")
    out = solver(T)
    assert (tr_solve.solve_tr_cuda.launches, teigh.sym_eigh_cuda.launches,
            tlinalg.spd_solve_cuda.launches) == counts
    assert out["Y"].shape == (2, 103, 2) and out["q"].shape == (2, 100)
    for k in ("q", "Y", "e_pos", "e_rot", "cost"):
        assert bool(torch.isfinite(out[k].double()).all()), k
    eager = tapi.solve_ik(tps, T, params=params, polish_params=polish, smooth_iters=None,
                          device="cpu")
    for k in ("q", "Y", "e_pos", "e_rot", "cost", "iterations"):
        assert torch.equal(out[k], eager[k]), k


def test_solve_ik_planar100_against_jax():
    """planar100 (N = 103, E = 209, m = 100 joints) at float32 on 2 goals, 3
    TR iterations, full bound smoothing, no polish, against the JAX
    package's api.solve_ik on its "edge" backend.

    From each package's own start, the port's api.solve_ik and its compiled
    solver's CPU form (`make_solver(device="cpu")`, bitwise the eager one)
    with test_solve_ik_planar64_against_jax's tolerances: the same iteration
    counts and verdicts, the cost and the pose errors within 2e-3, Y's Gram
    within 2e-3 of its largest entry. The joint angles are held from one
    start, the JAX package's own Y0 handed to both: after 3 iterations
    planar100's Y is far from a solution (cost 1e4-1e6), and the angles read
    from its shortest node gaps (0.11-0.16 m) carry the two MDS inits'
    float32 and gauge differences (up to 0.06 rad on 3 of 200 angles).
    From the shared start: the iterations equal, the cost within rtol 2e-5
    and Y within 1e-4 (tests/test_torch_large.py's TR tolerances), the pose
    errors within rtol 1e-4, the 100 angles within 1e-3 rad."""
    jps, tps = structures("planar100")
    T = goals(jps.template, 5, 2)
    jparams = jriem.TRParams(maxiter=3, backend="edge")
    jo = japi.solve_ik(jps, jnp.asarray(T), params=jparams, polish=False, smooth_iters=None)
    jo = {k: np.asarray(v) for k, v in jo.items()}
    params = TTRParams(maxiter=3)
    eager = tapi.solve_ik(tps, torch.from_numpy(T), params=params, polish=False,
                          smooth_iters=None, device="cpu")
    compiled = tapi.make_solver(tps, params=params, polish=False, smooth_iters=None,
                                device="cpu")(torch.from_numpy(T))
    for k in ("q", "Y", "e_pos", "e_rot", "cost", "iterations", "success"):
        assert torch.equal(compiled[k], eager[k]), k
    to = {k: v.numpy() for k, v in compiled.items()}
    assert to["Y"].shape == jo["Y"].shape == (2, 103, 2) and to["q"].shape == (2, 100)
    np.testing.assert_array_equal(to["iterations"], jo["iterations"])
    np.testing.assert_array_equal(to["success"], jo["success"])
    for k in ("cost", "e_pos", "e_rot"):
        np.testing.assert_allclose(to[k], jo[k], rtol=2e-3, atol=1e-5, err_msg=k)
    G, Gj = (y @ np.swapaxes(y, 1, 2) for y in (to["Y"].astype(np.float64), jo["Y"]))
    np.testing.assert_allclose(G, Gj, rtol=0, atol=2e-3 * np.abs(Gj).max())

    inst = jps.instance(jnp.asarray(T), smooth=True, smooth_iters=None)
    Y0 = jriem.generate_initialization(inst["lb"], inst["ub"],
                                       jnp.asarray(jps.masks()[0], jnp.float32), 2)
    js = japi.solve_ik(jps, jnp.asarray(T), params=jparams, polish=False, Y_init=Y0)
    js = {k: np.asarray(v) for k, v in js.items()}
    ts = tapi.solve_ik(tps, torch.from_numpy(T), params=params, polish=False,
                       Y_init=torch.from_numpy(np.array(Y0)), device="cpu")
    ts = {k: v.numpy() for k, v in ts.items()}
    np.testing.assert_array_equal(ts["iterations"], js["iterations"])
    np.testing.assert_array_equal(ts["success"], js["success"])
    np.testing.assert_allclose(ts["cost"], js["cost"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(ts["Y"], js["Y"], rtol=1e-4, atol=1e-5)
    for k in ("e_pos", "e_rot"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ts["q"], js["q"], rtol=0, atol=1e-3)
