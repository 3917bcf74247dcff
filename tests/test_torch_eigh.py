"""K5's plain version (ops/eigh.py::sym_eigh_reference, the kernel's Jacobi
step for step) against the JAX package's jnp.linalg.eigh on the CPU, on
inputs made from a numpy seed, and the prepare stage that runs on it.

Eigenvectors are compared through projectors onto clusters of eigenvalues:
the sign and the basis inside a cluster are conventions (ops/eigh.py makes
each eigenvector's largest entry positive, LAPACK does not).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu.utils.environments import table_environment as jtable
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.ops import eigh as teigh
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import riemannian as triem
from graphik_tpu_torch.utils import dgp as tdgp
from graphik_tpu_torch.utils.environments import table_environment as ttable

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# eigenvalues against jnp.linalg.eigh, over ||A||_F of each matrix
EIG_TOL = {"f32": 1e-5, "f64": 1e-10}
# ||A - V diag(w) V^T||_F / ||A||_F and max |V^T V - I|
RES_TOL = {"f32": 2e-5, "f64": 1e-12}


def symmetric(rs, B, n):
    X = rs.normal(size=(B, n, n))
    return X + X.transpose(0, 2, 1)


def jax_eigh(A):
    w, V = jnp.linalg.eigh(jnp.asarray(A))
    return np.asarray(w), np.asarray(V)


def check_decomposition(A, w, V, conv, tol):
    """Ascending, the sign rule, every flag set, residual and orthogonality
    within tol."""
    A, w, V = (x.double().numpy() for x in (A, w, V))
    assert bool(conv.all())
    assert np.all(np.diff(w, axis=-1) >= 0)
    n = A.shape[-1]
    first = np.abs(V).argmax(axis=-2)  # argmax takes the first maximum
    assert np.all(np.take_along_axis(V, first[..., None, :], axis=-2) > 0)
    res = np.linalg.norm(A - (V * w[..., None, :]) @ np.swapaxes(V, -1, -2), axis=(-2, -1))
    assert np.all(res <= tol * np.linalg.norm(A, axis=(-2, -1))), res.max()
    assert np.abs(np.swapaxes(V, -1, -2) @ V - np.eye(n)).max() <= tol


def clusters(w, gap):
    """Index ranges of the ascending eigenvalues w split where two
    neighbours are more than `gap` apart."""
    cut = [0] + [i + 1 for i in range(len(w) - 1) if w[i + 1] - w[i] > gap] + [len(w)]
    return list(zip(cut[:-1], cut[1:]))


def check_projectors(w_ref, V_ref, V, gap, tol):
    """The projector onto each cluster of w_ref (neighbours `gap` apart)
    within tol of the reference's."""
    for b in range(V.shape[0]):
        for lo, hi in clusters(w_ref[b], gap[b]):
            P = V[b][:, lo:hi] @ V[b][:, lo:hi].T
            P_ref = V_ref[b][:, lo:hi] @ V_ref[b][:, lo:hi].T
            assert np.abs(P - P_ref).max() <= tol, (b, lo, hi)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 9, 13, 16, 18, 32])
def test_random_matches_jax(n, dt):
    """Random symmetric matrices: eigenvalues within 1e-10 ||A||_F (f64) or
    1e-5 ||A||_F (f32) of jnp.linalg.eigh; ascending; each eigenvector's
    largest entry positive; every matrix converged; residual and
    orthogonality within 1e-12 (f64) or 2e-5 (f32)."""
    rs = np.random.RandomState(n)
    A = symmetric(rs, 24, n).astype(np.float32 if dt == "f32" else np.float64)
    w, V, conv = teigh.sym_eigh_reference(torch.from_numpy(A))
    assert w.dtype == V.dtype == DTYPES[dt]
    w_ref, _ = jax_eigh(A)
    scale = np.linalg.norm(A.astype(np.float64), axis=(-2, -1))[:, None]
    assert np.all(np.abs(w.double().numpy() - w_ref) <= EIG_TOL[dt] * scale)
    check_decomposition(torch.from_numpy(A), w, V, conv, RES_TOL[dt])


@pytest.mark.parametrize("n", [9, 16, 32])
def test_repeated_eigenvalues(n):
    """Spectra with repeated eigenvalues (clusters of 1 to 4 equal values),
    float64: eigenvalues within 1e-10 ||A||_F of jnp.linalg.eigh and the
    projector onto each cluster within 1e-8 of JAX's."""
    rs = np.random.RandomState(100 + n)
    B = 8
    spec = np.sort(np.repeat(rs.normal(size=(B, n)), 1 + np.arange(n) % 4, axis=1)[:, :n], axis=1)
    Q = np.linalg.qr(rs.normal(size=(B, n, n)))[0]
    A = (Q * spec[:, None, :]) @ Q.transpose(0, 2, 1)
    A = 0.5 * (A + A.transpose(0, 2, 1))
    w, V, conv = teigh.sym_eigh_reference(torch.from_numpy(A))
    w_ref, V_ref = jax_eigh(A)
    scale = np.linalg.norm(A, axis=(-2, -1))
    assert np.all(np.abs(w.numpy() - w_ref) <= 1e-10 * scale[:, None])
    check_projectors(w_ref, V_ref, V.numpy(), 1e-6 * scale, 1e-8)
    check_decomposition(torch.from_numpy(A), w, V, conv, RES_TOL["f64"])


@pytest.mark.parametrize("n", [2, 9, 13])
def test_equal_diagonals(n):
    """Equal diagonal entries with off-diagonals of both signs, where a
    rotation's theta is +-0 (t then takes theta's sign bit), float64:
    eigenvalues within 1e-10 ||A||_F of jnp.linalg.eigh, and the
    decomposition's checks (residual and orthogonality 1e-12)."""
    rs = np.random.RandomState(200 + n)
    E = np.triu(rs.normal(size=(8, n, n)), 1)
    A = 2.0 * np.eye(n) + E + E.transpose(0, 2, 1)
    w, V, conv = teigh.sym_eigh_reference(torch.from_numpy(A))
    w_ref, _ = jax_eigh(A)
    scale = np.linalg.norm(A, axis=(-2, -1))[:, None]
    assert np.all(np.abs(w.numpy() - w_ref) <= 1e-10 * scale)
    check_decomposition(torch.from_numpy(A), w, V, conv, RES_TOL["f64"])


def goals(jps, B, seed):
    tpl = jps.template
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])


def structures(robot):
    if robot == "planar10":
        return (jlib.load_planar_chain(10, limits=np.pi / 2)[1],
                tlib.load_planar_chain(10, limits=np.pi / 2)[1])
    obstacles = (jtable(), ttable()) if robot == "table" else (None, None)
    return (JPS.from_template(jlib.load_ur10()[0], obstacles=obstacles[0]),
            TPS.from_template(tlib.load_ur10()[0], obstacles=obstacles[1]))


@pytest.fixture(scope="module", params=["ur10", "planar10", "table"])
def prepared(request):
    """The robot's float64 instances of 8 seeded goals (on the table's Nr
    robot nodes), from both packages, and the mask of its edges."""
    jps, tps = structures(request.param)
    T = goals(jps, 8, 3)
    spec = tps.reduced_spec()
    Nr = None if spec is None else spec["Nr"]
    ji = jps.instance(jnp.asarray(T), smooth=True, n_nodes=Nr, smooth_iters=2)
    ti = tps.instance(torch.from_numpy(T), smooth=True, n_nodes=Nr, smooth_iters=2)
    M = tps.N if Nr is None else Nr
    return ji, ti, tps.masks()[0][:M, :M], tps.dim


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_prepare_matrices_match_jax(prepared, dt):
    """The two matrices prepare decomposes - the MDS Gram G (rank-deficient:
    most eigenvalues near 0) and the edge scatter S of its factor - from the
    robot's instances: eigenvalues within 1e-10 ||A||_F (f64) or 1e-5
    ||A||_F (f32) of jnp.linalg.eigh; at f64 the projector onto each
    cluster of eigenvalues 1e-4 ||A||_F apart within 1e-8 of JAX's."""
    _, ti, omega, _ = prepared
    G = tdgp.gram_from_distance_matrix(tdgp.sample_distance_matrix(ti["lb"], ti["ub"]))
    G = 0.5 * (G + G.transpose(-1, -2))
    S = tdgp.edge_scatter(tdgp.mds(G, eps=1e-8), torch.as_tensor(omega))
    for A in (G, S):
        A = A.to(DTYPES[dt])
        w, V, conv = teigh.sym_eigh_reference(A)
        w_ref, V_ref = jax_eigh(A.numpy())
        scale = np.linalg.norm(A.double().numpy(), axis=(-2, -1))
        assert np.all(np.abs(w.double().numpy() - w_ref) <= EIG_TOL[dt] * scale[:, None])
        if dt == "f64":
            check_projectors(w_ref, V_ref, V.numpy(), 1e-4 * scale, 1e-8)
        check_decomposition(A, w, V, conv, RES_TOL[dt])


def test_prepare_gram_matches_jax(prepared):
    """Prepare's MDS init on K5's plain version: the Gram Y0 Y0^T within
    1e-8 of the JAX package's at float64 (tests/test_torch_prepare.py's
    bound), on UR10, planar10 and the table's Nr robot nodes."""
    ji, ti, omega, dim = prepared
    jY = np.asarray(jriem.generate_initialization(ji["lb"], ji["ub"], jnp.asarray(omega), dim))
    tY = triem.generate_initialization(ti["lb"], ti["ub"], omega, dim).numpy()
    assert tY.shape == jY.shape
    np.testing.assert_allclose(tY @ tY.transpose(0, 2, 1), jY @ jY.transpose(0, 2, 1),
                               rtol=0, atol=1e-8)


def test_padded_rows_are_left_alone():
    """A stack with exact-zero rows and columns (the sparse CIDGIK's padded
    clique blocks): every padded index keeps eigenvalue 0 and its unit
    eigenvector, no other eigenvector has weight there (both exactly),
    and the rest within 1e-10 ||A||_F (f64) of jnp.linalg.eigh on the
    unpadded blocks."""
    rs = np.random.RandomState(4)
    n, B = 9, 12
    A = symmetric(rs, B, n)
    pads = [(b, sorted(rs.choice(n, size=b % 3, replace=False))) for b in range(B)]
    for b, rows in pads:
        A[b, rows, :] = 0.0
        A[b, :, rows] = 0.0
    w, V, conv = teigh.sym_eigh_reference(torch.from_numpy(A))
    w, V = w.numpy(), V.numpy()
    assert bool(conv.all())
    for b, rows in pads:
        keep = [i for i in range(n) if i not in rows]
        unit = [int(np.flatnonzero(V[b][i] == 1.0)[0]) for i in rows]
        for i, j in zip(rows, unit):
            assert np.count_nonzero(V[b][:, j]) == 1 and w[b, j] == 0.0, (b, i)
        rest = [j for j in range(n) if j not in unit]
        assert np.count_nonzero(V[b][np.ix_(rows, rest)]) == 0, b
        w_ref = np.linalg.eigvalsh(A[b][np.ix_(keep, keep)])
        assert np.abs(w[b, rest] - w_ref).max() <= 1e-10 * np.linalg.norm(A[b])


def test_sym_eigh_on_the_cpu_is_the_plain_version():
    """On the CPU sym_eigh returns the plain version's (w, V) bit for bit
    and launches no kernel, at any n (past the kernel's 128 too); it
    refuses integer and non-square stacks, and sym_eigh_cuda refuses a CPU
    tensor (no fallback) and n > 128, naming the limit."""
    A = torch.from_numpy(symmetric(np.random.RandomState(5), 6, 13))
    before = teigh.sym_eigh_cuda.launches
    w, V = teigh.sym_eigh(A)
    w_ref, V_ref, _ = teigh.sym_eigh_reference(A)
    assert torch.equal(w, w_ref) and torch.equal(V, V_ref)
    assert teigh.sym_eigh_cuda.launches == before
    w, V = teigh.sym_eigh(torch.eye(129).expand(2, 129, 129))
    assert torch.equal(w, torch.ones(2, 129)) and torch.equal(V, torch.eye(129).expand(2, 129, 129))
    with pytest.raises(ValueError, match="n <= 128"):
        teigh.sym_eigh_cuda(torch.zeros(2, 129, 129))
    with pytest.raises(TypeError):
        teigh.sym_eigh(torch.zeros(2, 4, 4, dtype=torch.int64))
    with pytest.raises(ValueError, match="square"):
        teigh.sym_eigh(torch.zeros(2, 4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        teigh.sym_eigh_cuda(A)


def test_reads_the_lower_triangle_and_keeps_batch_dims():
    """Only the lower triangle is read (torch.linalg.eigh's default): a
    changed upper triangle changes nothing. Leading batch dims are kept,
    and each matrix's result does not depend on its batch: the first
    matrices alone give the same bits."""
    rs = np.random.RandomState(6)
    A = torch.from_numpy(symmetric(rs, 12, 10)).reshape(3, 4, 10, 10)
    w, V, conv = teigh.sym_eigh_reference(A)
    assert w.shape == (3, 4, 10) and V.shape == (3, 4, 10, 10) and conv.shape == (3, 4)
    junk = A + torch.triu(torch.from_numpy(rs.normal(size=(3, 4, 10, 10))), 1)
    w2, V2, _ = teigh.sym_eigh_reference(junk)
    assert torch.equal(w, w2) and torch.equal(V, V2)
    w1, V1, _ = teigh.sym_eigh_reference(A[0, :3])
    assert torch.equal(w1, w[0, :3]) and torch.equal(V1, V[0, :3])


def test_round_robin_covers_every_pair_once_a_sweep():
    """The plan's layouts pair every p < q once in each sweep of m - 1
    steps (m = n rounded up to even; the pairs with index n skipped for
    odd n), and the gathers move a state from each step's layout to the
    next one's, back to the first after a sweep."""
    for n in range(1, 33):
        plan = teigh._Plan(n, torch.device("cpu"))
        m, h = plan.m, plan.h
        state = torch.arange(2 * m * m).reshape(1, -1)
        start = state.gather(1, plan.into)
        cur, seen = start, []
        for to_next in plan.steps:
            rows = cur.view(2 * m, m)[:m, 0] // m  # each layout position's index
            seen += [(int(rows[k]), int(rows[h + k])) for k in range(h)]
            cur = cur.gather(1, to_next)
        assert torch.equal(cur, start)
        assert all(p < q for p, q in seen)
        want = {(p, q) for p in range(m) for q in range(p + 1, m)}
        assert sorted(seen) == sorted(want), n


def test_flags():
    """A matrix with a NaN stops unconverged after MAX_SWEEPS sweeps; its
    neighbours in the stack converge; empty stacks and 1 x 1 matrices
    work."""
    A = torch.from_numpy(symmetric(np.random.RandomState(8), 3, 5))
    A[1, 2, 3] = A[1, 3, 2] = float("nan")
    _, _, conv = teigh.sym_eigh_reference(A)
    assert conv.tolist() == [True, False, True]
    w, V, conv = teigh.sym_eigh_reference(torch.zeros(0, 4, 4))
    assert w.shape == (0, 4) and V.shape == (0, 4, 4) and conv.shape == (0,)
    w, V, conv = teigh.sym_eigh_reference(torch.full((2, 1, 1), -3.0))
    assert w.tolist() == [[-3.0], [-3.0]] and V.tolist() == [[[1.0]], [[1.0]]]
    assert bool(conv.all())


def test_sweeps_counted():
    """`sweeps=True` adds the sweeps each matrix ran without touching the
    results: 0 for a diagonal matrix, MAX_SWEEPS for one with a NaN, a few
    for random ones past n = 32, each equal to the count it gets alone."""
    A = torch.from_numpy(symmetric(np.random.RandomState(9), 4, 35))
    A[0] = torch.diag(torch.arange(35.0, dtype=A.dtype))
    A[2, 4, 7] = A[2, 7, 4] = float("nan")
    w, V, conv, ran = teigh.sym_eigh_reference(A, sweeps=True)
    w0, V0, conv0 = teigh.sym_eigh_reference(A)
    assert torch.equal(w[[0, 1, 3]], w0[[0, 1, 3]]) and torch.equal(V[[0, 1, 3]], V0[[0, 1, 3]])
    assert torch.equal(conv, conv0) and conv.tolist() == [True, True, False, True]
    assert ran[0] == 0 and ran[2] == teigh.MAX_SWEEPS and 3 <= ran[1] <= 15 and 3 <= ran[3] <= 15
    assert teigh.sym_eigh_reference(A[3:], sweeps=True)[3].tolist() == [ran[3]]
    assert teigh.sym_eigh_reference(A[:0], sweeps=True)[3].shape == (0,)
