"""K6's plain version, ops/linalg.py::spd_solve_reference (the LM's damped
solve), against the JAX package's graphik_tpu/ops/linalg.py
spd_solve_unrolled; the LM polish taking the reference's clamped-pivot
step; and the two other call sites of the same JAX solve (the Riemannian
projector and CIDGIK's Schur factor), which keep torch's Cholesky.

The kernel itself runs only on a card (tests/test_torch_cuda.py -k
spd_solve), where it is held bitwise to the plain version."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphik_tpu.ops import linalg as jlinalg
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import cidgik as jcd
from graphik_tpu.solvers import local as jlocal
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu_torch.ops import linalg as tlinalg
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import cidgik as tcd
from graphik_tpu_torch.solvers import local as tlocal
from graphik_tpu_torch.solvers import riemannian as triem

torch.set_num_threads(1)
EPS = {np.float32: float(np.finfo(np.float32).eps), np.float64: float(np.finfo(np.float64).eps)}


@functools.lru_cache(maxsize=None)
def _jax_spd_compiled(shape_A, shape_b, dtype):
    A, b = jax.ShapeDtypeStruct(shape_A, dtype), jax.ShapeDtypeStruct(shape_b, dtype)
    return jax.jit(jlinalg.spd_solve_unrolled).lower(A, b).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jax_spd(A, b):
    """spd_solve_unrolled, compiled by XLA without its LLVM optimisation,
    once a shape: the fully unrolled m = 64 solve then compiles in half the
    time, and the comparison below holds in any summation order."""
    return _jax_spd_compiled(A.shape, b.shape, A.dtype)(A, b)


def _systems(m, dt, seed):
    """(kind, A, b) stacks of 32: SPD (X X^T / m + I); LM systems J^T J +
    lam I with J 6 x m (a 3D pose residual) and lam from 1e-3 to 1e-12,
    as the polish's damping moves; the same with J 3 x m (planar40's
    rows); indefinite ones with one pivot far below zero, at the last
    column (the clamped pivot's step is huge but finite) or earlier (it
    overflows to inf or NaN)."""
    rs = np.random.RandomState(seed)
    B = 32
    X = rs.normal(size=(B, m, m))
    out = [("spd", X @ X.transpose(0, 2, 1) / m + np.eye(m))]
    lam = 10.0 ** -np.linspace(3, 12, B)[:, None, None]
    for rows in (6, 3):
        J = rs.normal(size=(B, rows, m))
        out.append((f"lm{rows}", J.transpose(0, 2, 1) @ J + lam * np.eye(m)))
    W = np.tril(rs.normal(size=(B, m, m)), -1) * 0.1 + np.eye(m)
    d = np.ones((B, m))
    d[: B // 2, -1] = -1.0
    d[B // 2:, rs.randint(0, m, size=B - B // 2)] = -1.0
    out.append(("indefinite", (W * d[:, None, :]) @ W.transpose(0, 2, 1)))
    return [(k, A.astype(dt), rs.normal(size=(B, m)).astype(dt)) for k, A in out]


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("m", [3, 6, 7, 10, 19, 40, 64])
def test_spd_solve_reference_matches_jax(m, dt):
    """The plain version against spd_solve_unrolled on the same inputs.
    Where A is numerically SPD in its type (m eps cond(A) <= 1, cond from
    float64: no rounding order can make a pivot non-positive), both steps
    are finite and within m eps cond(A) of each other, relative to the
    step's largest entry: the two sum their dot products in different
    orders (XLA's reduction against one add at a time), and a backward
    stable solve's forward error is bounded so. Where a pivot is far below
    zero (the indefinite systems) both clamp it: the same entries are
    finite, and those within 1e-3 (f32) / 1e-9 (f64) relative, the
    clamped pivot's 1e15 having amplified the two orders' rounding. The
    float32 LM systems of rank-deficient J at small lam lie between: their
    later pivots are rounding noise in any order, so only the kernel's
    bitwise check on the card (its plain version's order) holds them."""
    eps = EPS[dt]
    checked = 0
    for kind, A, b in _systems(m, dt, seed=m):
        x_j = np.asarray(_jax_spd(jnp.asarray(A), jnp.asarray(b)))
        x_t = tlinalg.spd_solve_reference(torch.from_numpy(A), torch.from_numpy(b)).numpy()
        assert x_t.dtype == dt
        if kind == "indefinite":
            assert (np.linalg.eigvalsh(A.astype(np.float64))[:, 0] < -0.1).all()
            np.testing.assert_array_equal(np.isfinite(x_t), np.isfinite(x_j))
            fin = np.isfinite(x_j).all(-1)
            scale = np.abs(x_j[fin]).max(-1, keepdims=True)
            tol = 1e-3 if dt == np.float32 else 1e-9
            assert (np.abs(x_t[fin] - x_j[fin]) <= tol * scale).all()
            checked += len(A)
            continue
        cond = np.linalg.cond(A.astype(np.float64))
        spd = m * eps * cond <= 1.0
        assert spd.any() or kind == "lm3"
        assert np.isfinite(x_j[spd]).all() and np.isfinite(x_t[spd]).all()
        err = np.abs(x_t[spd] - x_j[spd]).max(-1)
        assert (err <= m * eps * cond[spd] * np.abs(x_j[spd]).max(-1)).all(), kind
        checked += int(spd.sum())
    assert checked >= 64


def test_spd_solve_refuses_past_the_limit():
    """The kernel's wrapper refuses m = 129, naming the limit; the plain
    version takes it (the dispatcher runs it on CPU tensors); integers,
    mixed dtypes and mismatched shapes raise anywhere."""
    with pytest.raises(ValueError, match="m <= 128"):
        tlinalg.spd_solve_cuda(torch.eye(129).expand(2, 129, 129), torch.ones(2, 129))
    assert torch.equal(tlinalg.spd_solve(torch.eye(129).expand(2, 129, 129) * 2.0,
                                         torch.ones(2, 129)), torch.full((2, 129), 0.5))
    with pytest.raises(TypeError, match="float32 or float64"):
        tlinalg.spd_solve(torch.ones(2, 3, 3, dtype=torch.int64),
                          torch.ones(2, 3, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32 or float64"):
        tlinalg.spd_solve(torch.eye(3).expand(2, 3, 3), torch.ones(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(\.\.\., m\)"):
        tlinalg.spd_solve(torch.eye(3).expand(2, 3, 3), torch.ones(2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tlinalg.spd_solve_cuda(torch.eye(3).expand(2, 3, 3), torch.ones(2, 3))
    A = torch.eye(4, dtype=torch.float64).expand(3, 4, 4) * 4.0
    launches = tlinalg.spd_solve_cuda.launches
    assert torch.equal(tlinalg.spd_solve(A, torch.ones(3, 4, dtype=torch.float64)),
                       torch.full((3, 4), 0.25, dtype=torch.float64))
    assert tlinalg.spd_solve_cuda.launches == launches


@pytest.mark.parametrize("robot", ["ur10", "planar10"])
def test_lm_takes_the_clamped_step(robot):
    """One LM step whose float32 system H = J^T J + lam I is indefinite (a
    negative initial damping, lam = -10: a pivot far below zero, which no
    rounding order can make positive): the JAX package clamps the pivot,
    takes the huge step, clips it to the joint limits and keeps it where the
    residual falls; the port's solve_local gives JAX's q, cost and
    iterations on every lane. (A solve that takes no step where a library
    Cholesky fails moves none of the lanes JAX moves.)"""
    jps, tps = ((jlib.load_ur10()[1], tlib.load_ur10()[1]) if robot == "ur10" else
                (jlib.load_planar_chain(10, limits=np.pi / 2)[1],
                 tlib.load_planar_chain(10, limits=np.pi / 2)[1]))
    tpl = jps.template
    rs = np.random.RandomState(60)
    B = 64
    q_goal = rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    T = np.array(jkin.all_poses(tpl, jnp.asarray(q_goal))[:, tpl.ee]).astype(np.float32)
    q0 = rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n)).astype(np.float32)
    kw = dict(maxiter=1, tol_grad=1e-8, lm_init=-10.0)
    jo = jax.jit(lambda T, q: jlocal.solve_local(jps, T, q, jlocal.LocalParams(**kw)))(
        jnp.asarray(T), jnp.asarray(q0))
    to = tlocal.solve_local(tps, torch.from_numpy(T), torch.from_numpy(q0),
                            tlocal.LocalParams(**kw))
    q_j = np.asarray(jo["q"])
    moved = np.abs(q_j - q0).max(-1) > 0
    assert moved.sum() >= 8  # lanes where the clamped step was taken
    np.testing.assert_allclose(to["q"].numpy(), q_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(to["cost"].numpy(), np.asarray(jo["cost"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(to["iterations"].numpy(), np.asarray(jo["iterations"]))


def _near_singular_Y(rs, B, N, dt):
    """UR10-sized point sets (N = 16, d = 3): general, nearly coplanar
    (rank 2 up to 1e-7), collinear (rank 1), one point far off, and zero."""
    Y = rs.normal(size=(5, B, N, 3))
    Y[1, :, :, 2] *= 1e-7
    Y[2] = rs.normal(size=(B, N, 1)) * rs.normal(size=(B, 1, 3))
    Y[3, :, 0] *= 1e4
    Y[4] = 0.0
    return Y.reshape(5 * B, N, 3).astype(dt)


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_riemannian_projector_agrees_with_the_clamped_solve(dt):
    """The horizontal projection (graphik_tpu/solvers/riemannian.py
    manifold_proj, a 3 x 3 spd_solve_unrolled at d = 3) against the port's
    (torch's Cholesky) on general and nearly rank-deficient point sets:
    within 10 eps cond(M) of ||Z||, relative, M the reduced 3 x 3 system
    (float64). The Tikhonov shift 10 eps tr(X) keeps every pivot above the
    rounding in any order, so the clamp never engages except at Y = 0,
    where the right side is zero and both give Z. So this call site keeps
    torch's Cholesky."""
    rs = np.random.RandomState(61)
    Y = _near_singular_Y(rs, 16, 16, dt)
    Z = rs.normal(size=Y.shape).astype(dt)
    P_j = np.asarray(jax.jit(jriem.manifold_proj)(jnp.asarray(Y), jnp.asarray(Z)))
    P_t = triem.manifold_proj(torch.from_numpy(Y), torch.from_numpy(Z)).numpy()
    X = np.einsum("bki,bkj->bij", Y.astype(np.float64), Y.astype(np.float64))
    reg = 10 * EPS[dt] * (np.trace(X, axis1=1, axis2=2) + 1e-30)
    M = np.stack([X[:, 0, 0] + X[:, 1, 1], X[:, 1, 2], -X[:, 0, 2],
                  X[:, 1, 2], X[:, 0, 0] + X[:, 2, 2], X[:, 0, 1],
                  -X[:, 0, 2], X[:, 0, 1], X[:, 1, 1] + X[:, 2, 2]], -1).reshape(-1, 3, 3)
    cond = np.linalg.cond(M + reg[:, None, None] * np.eye(3))
    scale = np.abs(Z).max(axis=(1, 2))
    assert (np.abs(P_t - P_j).max(axis=(1, 2)) <= 10 * EPS[dt] * cond * scale).all()
    np.testing.assert_array_equal(P_t[-16:], Z[-16:])


@pytest.fixture(scope="module")
def ur10_split_operators():
    """UR10's structure, its CIDGIK anchors and both packages' split
    operators."""
    jps, tps = jlib.load_ur10()[1], tlib.load_ur10()[1]
    jc = jcd.compile_cidgik(jps)
    return (jps, jc.anchor_idx, jcd._build_split_operator(jc),
            tcd._build_split_operator(tcd.compile_cidgik(tps)))


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_cidgik_schur_factor_agrees_with_the_clamped_solve(ur10_split_operators, dt):
    """CIDGIK's Schur complement (graphik_tpu/solvers/cidgik.py _split_aux:
    chol_unrolled, then chol_solve_unrolled for its inverse) against the
    port's (cholesky_ex, cholesky_inverse) on UR10's goal rows, at FK goals
    of random and of folded configurations (q = 0: the goal anchors
    nearly on the static rows' span): S^-1 within 1e-3 (f32) / 1e-9 (f64)
    of ||S^-1||, relative, every port lane's schur_info 0, and no JAX pivot
    at its clamp. The shift 1e-7 tr(S) / m_d holds every pivot above the
    clamp, so this call site keeps torch's Cholesky."""
    jps, anchor_idx, jop, top = ur10_split_operators
    tpl = jps.template
    rs = np.random.RandomState(62)
    q = np.concatenate([rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(6, tpl.n)),
                        np.zeros((1, tpl.n)), 1e-4 * rs.normal(size=(1, tpl.n))])
    T = jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee]
    anc = np.asarray(jps.goal_positions(T))[:, anchor_idx].astype(dt)
    aux_j = jax.jit(lambda a: jcd._split_aux(jop, a, None, jnp.dtype(dt)))(jnp.asarray(anc))
    aux_t = tcd._split_aux(top, torch.from_numpy(anc))
    S_j, S_t = np.asarray(aux_j["Sinv"]), aux_t["Sinv"].numpy()
    tol = 1e-3 if dt == np.float32 else 1e-9
    scale = np.abs(S_j).max(axis=(1, 2))
    assert (np.abs(S_t - S_j).max(axis=(1, 2)) <= tol * scale).all()
    assert int(aux_t["schur_info"].abs().sum()) == 0
    piv = np.diagonal(np.asarray(aux_j["Ls_schur"]), axis1=1, axis2=2)
    assert (piv > 1e3 * np.sqrt(1e-30)).all()
