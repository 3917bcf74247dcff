"""Robots past 32 nodes: the port against the JAX package where a problem no
longer fits one node a lane of a warp (N > 32), and where K5's matrices are
larger than 32.

* `ops/edge.py::lane_sum`, the kernels' node order: lane l of the 32-lane
  layout adds values l, l + 32, ... in that order, then the butterfly; held
  to a numpy model at every width from 1 to 128, and unchanged at <= 32.
* The plain TR version (the port's float32 path on the CPU) against the JAX
  package's Pallas kernel in interpret mode on 15- and 19-DoF DH chains
  (N = 34 and 42), and against its "edge" backend on planar40 (N = 43: the
  Pallas kernel in interpret mode stalls at d = 2).
* `ops/eigh.py::sym_eigh_reference` at n = 33 ... 64 against
  jnp.linalg.eigh (eigenvalues, Grams, projectors), CIDGIK's Fantope step
  at planar40's size, and `api.solve_ik` on planar40 and dh19.
* The sizes the kernels refuse, each with its limit named.

The DH chains are drawn as tools/torch_parity.py's dh19 is: n = 19 is dh19.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphik_tpu import api as japi
from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.ops import edge as jedge
from graphik_tpu.ops.tr_pallas import solve_tr_pallas
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.robots.templates import revolute_from_dh as jdh
from graphik_tpu.solvers import cidgik as jcidgik
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.ops import eigh as teigh
from graphik_tpu_torch.ops import tr_solve
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.robots.templates import revolute_from_dh as tdh
from graphik_tpu_torch.solvers import cidgik as tcidgik
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


def structures(robot):
    """(JAX structure, port structure) of planar40, dh15 or dh19."""
    if robot == "planar40":
        return (jlib.load_planar_chain(40, limits=np.pi / 2)[1],
                tlib.load_planar_chain(40, limits=np.pi / 2)[1])
    n = int(robot[2:])
    return JPS.from_template(dh_chain(n, jdh)), TPS.from_template(dh_chain(n, tdh))


def goals(tpl, seed, B):
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return np.asarray(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee], np.float32)


# ---------------------------------------------------------------------------
# lane_sum: the node order past 32 nodes
# ---------------------------------------------------------------------------

def _butterfly(lanes):
    idx = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ m]
    return lanes[:, 0]


def _lane_sum_model(x):
    """numpy float32: lane l's partial x[l] + x[l + 32] + ... (+0 past the
    end), then the butterfly."""
    B, n = x.shape
    lanes = np.zeros((B, 32), np.float32)
    for lane in range(32):
        vals = [x[:, i] for i in range(lane, n, 32)]
        if vals:
            p = vals[0]
            for v in vals[1:]:
                p = p + v
            if n > 32 and len(vals) < -(-n // 32):
                p = p + np.float32(0.0)
            lanes[:, lane] = p
    return _butterfly(lanes)


@pytest.mark.parametrize("width", range(1, 129))
def test_lane_sum_order(width):
    x = np.random.RandomState(width).normal(size=(5, width)).astype(np.float32)
    out = tedge.lane_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, _lane_sum_model(x))
    if width <= 32:  # the order every kernel test and chip phase was held to
        np.testing.assert_array_equal(out, _butterfly(np.pad(x, ((0, 0), (0, 32 - width)))))


# ---------------------------------------------------------------------------
# The plain TR version past 32 nodes
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


@pytest.mark.parametrize("robot,maxiter", [
    ("dh15", 1), ("dh15", 5), ("dh19", 1), ("dh19", 5), ("planar40", 1), ("planar40", 3)])
def test_tr_reference_past_32_nodes(robot, maxiter):
    """The port's plain TR version against the JAX package at N = 34, 42
    and 43, with the tolerances of the UR10 one-step test
    (tests/test_torch_tr_solve.py). Before the node order was repaired the
    plain version dropped every node past the 32nd from its sums (its
    cost then missed JAX's by 0.9-7.6 times JAX's value here). DH chains: the Pallas kernel in interpret mode;
    planar40: the "edge" backend, the same algorithm summed in XLA's order,
    after 1 and 3 iterations: this chain's float32 trajectories part fast,
    and the JAX package's own "edge" and Pallas forms are already 1.6e-5
    apart in cost at the fourth iteration and 26% at the fifth (goal 0's
    step accepted by one, refused by the other)."""
    masks, jep, tep, Y0, D, dg = tr_problem(robot)
    assert tep.N > 32
    out = tr_solve.solve_tr_reference(tep, torch.from_numpy(Y0), torch.from_numpy(dg),
                                      maxiter=maxiter)
    out = {k: v.numpy() for k, v in out.items()}
    if robot == "planar40":
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
# K5's plain version past n = 32
# ---------------------------------------------------------------------------

def _spd_stack(n, dtype, seed):
    """Three matrices: spread eigenvalues in a random basis, a rank-3 Gram
    (MDS's case: a repeated zero eigenvalue), and a random symmetric one."""
    rs = np.random.RandomState(seed)
    Q = np.linalg.qr(rs.normal(size=(n, n)))[0]
    A = (Q * np.linspace(-3.0, 5.0, n)) @ Q.T
    X = rs.normal(size=(n, 3))
    S = rs.normal(size=(n, n))
    return np.stack([A, X @ X.T, S + S.T]).astype(dtype)


@pytest.mark.parametrize("n", [33, 42, 43, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sym_eigh_reference_past_32(n, dtype):
    """Eigenvalues, the Gram V diag(w) V^T and the projectors onto the
    lowest 3 and the highest 3 eigenvectors against jnp.linalg.eigh; V
    orthonormal; every matrix converged."""
    A = _spd_stack(n, dtype, n)
    w, V, conv = teigh.sym_eigh_reference(torch.from_numpy(A))
    assert bool(conv.all())
    w, V = w.numpy(), V.numpy()
    wj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    tol = 2e-4 if dtype == np.float32 else 1e-10
    scale = np.abs(wj).max(-1, keepdims=True)
    np.testing.assert_allclose(w / scale, wj / scale, rtol=0, atol=tol)
    np.testing.assert_allclose((V * w[:, None, :]) @ np.swapaxes(V, 1, 2) / scale[:, :, None],
                               A / scale[:, :, None], rtol=0, atol=tol)
    np.testing.assert_allclose(np.swapaxes(V, 1, 2) @ V, np.broadcast_to(np.eye(n), V.shape),
                               rtol=0, atol=tol)
    for sl in (slice(0, 3), slice(n - 3, n)):
        if sl.start == 0:  # the Gram's lowest eigenvalues are a repeated 0
            P, Pj = (x[[0, 2], :, sl] @ np.swapaxes(x[[0, 2], :, sl], 1, 2) for x in (V, Vj))
        else:
            P, Pj = (x[:, :, sl] @ np.swapaxes(x[:, :, sl], 1, 2) for x in (V, Vj))
        np.testing.assert_allclose(P, Pj, rtol=0, atol=50 * tol)


def test_fantope_at_planar40():
    """CIDGIK's Fantope step at planar40's size (s = d + free nodes): the
    port's projector and excess eigenvalue sum against the JAX package's
    (jnp.linalg.eigh, eigh_sweeps=0), float64."""
    s = tcidgik.compile_cidgik(structures("planar40")[1]).s
    assert s > 32
    rs = np.random.RandomState(40)
    X = rs.normal(size=(4, s, 2))
    Z = X @ np.swapaxes(X, 1, 2) + 0.05 * rs.normal(size=(4, s, s))
    Z = 0.5 * (Z + np.swapaxes(Z, 1, 2))
    C, ev = tcidgik._fantope(torch.from_numpy(Z), 2)
    Cj, evj = jcidgik._fantope(jnp.asarray(Z), 2, eigh_sweeps=0)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ev.numpy(), np.asarray(evj), rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# The whole solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("robot", ["planar40", "dh19"])
def test_solve_ik_past_32_nodes(robot):
    """api.solve_ik at float32 on 4 goals, 3 TR iterations, no polish,
    against the JAX package's (planar40 on its "edge" backend, dh19 on its
    Pallas kernel in interpret mode): the same iteration counts, the cost
    and the pose errors within 2e-3. The two MDS inits differ by an
    orthogonal gauge (K5's sign rule is not LAPACK's), so Y is compared
    through its Gram."""
    jps, tps = structures(robot)
    T = goals(jps.template, 3, 4)
    backend = "edge" if robot == "planar40" else "pallas"
    jo = japi.solve_ik(jps, jnp.asarray(T), params=jriem.TRParams(maxiter=3, backend=backend),
                       polish=False)
    to = tapi.solve_ik(tps, torch.from_numpy(T), params=TTRParams(maxiter=3), polish=False)
    jo = {k: np.asarray(v) for k, v in jo.items()}
    to = {k: v.numpy() for k, v in to.items()}
    assert to["Y"].shape == jo["Y"].shape == (4, tps.N, tps.dim)
    np.testing.assert_array_equal(to["iterations"], jo["iterations"])
    for k in ("cost", "e_pos", "e_rot"):
        np.testing.assert_allclose(to[k], jo[k], rtol=2e-3, atol=1e-5, err_msg=k)
    G, Gj = (y @ np.swapaxes(y, 1, 2) for y in (to["Y"].astype(np.float64), jo["Y"]))
    np.testing.assert_allclose(G, Gj, rtol=0, atol=2e-3 * np.abs(Gj).max())


@pytest.mark.parametrize("robot", ["planar40", "dh19"])
def test_two_squarings_start_is_shared(robot):
    """At the UR10 path's 2-squaring smoothing, which bounds paths of at
    most 4 edges, a long chain's far node pairs keep the unbounded
    placeholder (1e9) and the MDS init is set by it alone: in both packages
    every goal starts from one Y0, ~3e8 across, that the TR's iterations
    leave as it is. The port's Y0 is JAX's to 1e-4 of its size, which at
    that size is still hundreds of metres: each package's success count is
    one draw of the start (tools/torch_parity.py dh19_smooth2). From JAX's
    Y0, the port's solve gives JAX's Y and iteration counts, and its joint
    recovery JAX's angles within 1e-5."""
    jps, tps = structures(robot)
    T = goals(jps.template, 5, 4)
    omega, psi_L, psi_U = jps.masks()
    params = dataclasses.replace(jriem.TRParams.production(maxiter=100, maxinner=24),
                                 backend="edge")

    @jax.jit
    def jax_start(Tg):
        with jax.default_matmul_precision("highest"):
            inst = jps.instance(Tg, dtype=jnp.float32, smooth=True, smooth_iters=2)
            return inst["D_goal"], jriem.generate_initialization(
                inst["lb"], inst["ub"], jnp.asarray(omega), jps.dim)

    @jax.jit
    def jax_solve(Y0, D, Tg):
        with jax.default_matmul_precision("highest"):
            sol = japi.solve_reduced(jps, Y0, D, omega, psi_L, psi_U, params=params)
            return sol["Y"], sol["iterations"], jps.joint_variables(sol["Y"], Tg)

    Dj, Y0j = jax_start(jnp.asarray(T))
    Yj, itj, qj = (np.asarray(x) for x in jax_solve(Y0j, Dj, jnp.asarray(T)))
    Y0j = np.array(Y0j)
    solver = tapi.make_solver(tps, params=TTRParams.production(maxiter=100, maxinner=24),
                              smooth_iters=2, device="cpu")
    Dt, Y0t = solver.prepare(torch.from_numpy(T))
    np.testing.assert_array_equal(Dt.numpy(), np.asarray(Dj))
    for Y0 in (Y0j, Y0t.numpy()):
        assert np.abs(Y0).max() > 1e8
        np.testing.assert_array_equal(Y0, np.broadcast_to(Y0[:1], Y0.shape))
    np.testing.assert_array_equal(Yj, Y0j)

    def gram(Y):
        Y = Y.astype(np.float64) - Y.mean(-2, keepdims=True)
        return Y @ np.swapaxes(Y, -1, -2)

    Gj = gram(Y0j)
    np.testing.assert_allclose(gram(Y0t.numpy()), Gj, rtol=0, atol=1e-4 * np.abs(Gj).max())
    sol = solver.solve(torch.from_numpy(Y0j), Dt)
    np.testing.assert_array_equal(sol["Y"].numpy(), Yj)
    np.testing.assert_array_equal(sol["iterations"].numpy(), itj)
    qt = tps.joint_variables(sol["Y"], torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# What the kernels refuse
# ---------------------------------------------------------------------------

def test_eigh_refuses_past_64():
    """The kernel's wrapper refuses n = 129, naming its limit (128), before
    it looks at the device; the plain version, and sym_eigh on a CPU
    tensor, compute there."""
    A = torch.eye(129)
    with pytest.raises(ValueError, match="n <= 128"):
        teigh.sym_eigh_cuda(A)
    w, V, conv = teigh.sym_eigh_reference(A)
    assert torch.equal(w, torch.ones(129)) and torch.equal(V, A) and bool(conv)
    w, V = teigh.sym_eigh(A)
    assert torch.equal(w, torch.ones(129)) and torch.equal(V, A)


def _anchored(N, per_node, nodes):
    """An EdgeProblem on a chain of N nodes with `per_node` anchor rows on
    each of `nodes`."""
    omega = np.zeros((N, N))
    for i in range(N - 1):
        omega[i, i + 1] = omega[i + 1, i] = 1.0
    idx = np.repeat(nodes, per_node)
    anchors = dict(idx=idx, centers=np.ones((len(idx), 3)), psi_L=np.ones(len(idx)),
                   psi_U=np.zeros(len(idx)), L_mask=np.ones(len(idx)), U_mask=np.zeros(len(idx)))
    return tedge.build_edge_problem(omega, omega, omega, dim=3, anchors=anchors)


@pytest.mark.parametrize("case,match", [
    ("a_R", "a_R <= 1024"), ("A", "A <= 3072"), ("N", "N <= 128"), ("E", "E <= 512")])
def test_tr_kernel_refuses_past_its_limits(case, match):
    """The TR kernel's wrapper refuses, before it looks at the device: a
    group of more than 1024 anchor rows (its rows would not fit the lane's
    32-bit row masks), more than 3072 anchor rows (the tables would not fit
    the block's shared memory), N > 128 and E > 512."""
    if case == "a_R":
        ep = _anchored(8, 1032, [3])
    elif case == "A":
        ep = _anchored(8, 800, [1, 2, 3, 4])
    elif case == "N":
        ep = _anchored(129, 0, [])
    else:
        N = 33
        full = np.ones((N, N)) - np.eye(N)  # 528 edges
        ep = tedge.build_edge_problem(full, full, full, dim=3)
    Y = torch.zeros(2, ep.N, 3)
    with pytest.raises(ValueError, match=match):
        tr_solve.solve_tr_cuda(ep, Y, torch.zeros(2, ep.Ep))


@pytest.mark.parametrize("wrapper", ["cost_and_egrad_cuda", "ehess_cuda"])
@pytest.mark.parametrize("case,match", [
    ("N", "N <= 64"), ("E", "E <= 256"), ("stride", "dg_stride <= 256")])
def test_edge_kernels_refuse_past_their_limits(wrapper, case, match):
    """K1 / K2's wrappers refuse, before they look at the device: N > 64,
    E > 256, and goal distances read at a stride past 256 (E = 250, whose
    padded Ep is 256, with 264 columns)."""
    if case == "N":
        ep = _anchored(65, 0, [])
    else:
        N = 24
        full = np.ones((N, N)) - np.eye(N)  # 276 edges
        if case == "stride":
            full[np.triu_indices(N, 1)[0][250:], np.triu_indices(N, 1)[1][250:]] = 0.0
            full = np.minimum(full, full.T)
        ep = tedge.build_edge_problem(full, full, full, dim=3)
    assert (ep.N, ep.E) == {"N": (65, 64), "E": (24, 276), "stride": (24, 250)}[case]
    Y = torch.zeros(2, ep.N, 3)
    dg = torch.zeros(2, 264 if case == "stride" else ep.Ep)
    args = (ep, Y, dg) if wrapper == "cost_and_egrad_cuda" else (ep, Y, Y, dg)
    with pytest.raises(ValueError, match=match):
        getattr(tedge, wrapper)(*args)
