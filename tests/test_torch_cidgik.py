"""Port vs JAX package, dense CIDGIK units (graphik_tpu/solvers/cidgik.py):
the compiled constraint tables, the split operator, the per-instance
constraint matrices, the Newton-Schulz PSD projection, the Fantope step, the
per-instance split data and the nearest-point SDP. float64 throughout; the
solves are in tests/test_torch_cidgik_solve.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.ops import linalg as jlinalg
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import cidgik as jcd
from graphik_tpu.utils.environments import table_environment as jtable
from graphik_tpu_torch import interop
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.ops import linalg as tlinalg
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import cidgik as tcd
from graphik_tpu_torch.utils.environments import table_environment as ttable

torch.set_num_threads(1)

OBSTACLE = (np.array([0.5, 0.0, 0.5]), 0.2)


def structures(name):
    """(JAX, port) ProblemStructure of one test configuration."""
    if name == "planar6":
        return (jlib.load_planar_chain(6, limits=np.pi / 2)[1],
                tlib.load_planar_chain(6, limits=np.pi / 2)[1])
    jtpl, ttpl = jlib.load_ur10()[0], tlib.load_ur10()[0]
    obstacles = {"ur10": (None, None), "floor": (None, None),
                 "ur10_obstacle": ([OBSTACLE], [OBSTACLE]),
                 "table": (jtable(), ttable())}[name]
    return (JPS.from_template(jtpl, obstacles=obstacles[0]),
            TPS.from_template(ttpl, obstacles=obstacles[1]))


@pytest.fixture(scope="module", params=["ur10", "ur10_obstacle", "table", "planar6", "floor"])
def compiled(request):
    jps, tps = structures(request.param)
    floor = request.param == "floor"
    return request.param, jcd.compile_cidgik(jps, floor_mode=floor), \
        tcd.compile_cidgik(tps, floor_mode=floor)


def anchor_positions(jps, jcomp, B, seed):
    """Per-instance anchor positions of B seeded FK goals (numpy)."""
    tpl = jps.template
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    T = jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee]
    return np.asarray(jps.goal_positions(T))[:, jcomp.anchor_idx]


def test_compile_tables_equal(compiled):
    """Every table of compile_cidgik: integers exactly, floats to 1e-12."""
    name, jc, tc = compiled
    for f in dataclasses.fields(jc):
        if f.name == "structure":
            continue
        a, b = np.asarray(getattr(jc, f.name)), np.asarray(getattr(tc, f.name))
        assert a.shape == b.shape, (name, f.name)
        if a.dtype.kind in "biu":
            assert b.dtype.kind == a.dtype.kind and np.array_equal(a, b), (name, f.name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=f"{name} {f.name}")
    assert (tc.s, tc.m_eq, tc.m_in) == (jc.s, jc.m_eq, jc.m_in)


def test_sizes():
    """The sizes the solvers run at: UR10, the table, floor_mode."""
    sizes = {}
    for name in ("ur10", "table", "floor"):
        tc = tcd.compile_cidgik(structures(name)[1], floor_mode=name == "floor")
        sizes[name] = (tc.structure.N, tc.n_free, tc.s, tc.m_eq, tc.m_in)
    assert sizes == {"ur10": (16, 10, 13, 45, 8), "table": (116, 10, 13, 45, 508),
                     "floor": (16, 12, 15, 48, 8)}
    op = tcd._build_split_operator(tcd.compile_cidgik(structures("table")[1]))
    assert (op.m_s, op.m_d) == (545, 8)


def test_interop_rebuilds_the_compiled_problem(compiled):
    """cidgik_from_numpy of JAX's fields gives the port's own compilation."""
    name, jc, tc = compiled
    rebuilt = interop.cidgik_from_numpy(dataclasses.asdict(jc))
    for f in dataclasses.fields(tc):
        if f.name != "structure":
            assert np.array_equal(getattr(rebuilt, f.name), getattr(tc, f.name)), (name, f.name)
    np.testing.assert_array_equal(rebuilt.structure.D_struct, tc.structure.D_struct)


def test_split_operator_equal(compiled):
    """The static rows, their Gram and its inverse factor, and the dynamic
    row tables, to 1e-10; cached on the compiled problem."""
    name, jc, tc = compiled
    jop, top = jcd._build_split_operator(jc), tcd._build_split_operator(tc)
    assert tcd._build_split_operator(tc) is top
    for f in dataclasses.fields(jop):
        a, b = np.asarray(getattr(jop, f.name)), np.asarray(getattr(top, f.name))
        assert a.shape == b.shape, (name, f.name)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-10, err_msg=f"{name} {f.name}")


def test_constraint_matrices_equal(compiled):
    """The vmap engine's per-instance constraint tensors, row-normalized,
    on 3 FK goals, to 1e-10; and the equalities hold at the FK points."""
    name, jc, tc = compiled
    anc = anchor_positions(jc.structure, jc, 3, seed=1)
    out_t = tcd._constraint_matrices(tc, torch.from_numpy(anc))
    for i in range(3):
        out_j = jcd._constraint_matrices(jc, jnp.asarray(anc[i]), jnp.float64)
        for a, b in zip(out_j, out_t):
            np.testing.assert_allclose(b[i].numpy(), np.asarray(a), rtol=0, atol=1e-10,
                                       err_msg=name)


@pytest.mark.parametrize("iters", [14, 16])
def test_psd_project_ns(iters):
    """Newton-Schulz PSD projection of seeded symmetric 13 x 13 matrices,
    to 1e-12 x ||W||."""
    rs = np.random.RandomState(iters)
    W = rs.normal(size=(6, 13, 13))
    W = W + W.transpose(0, 2, 1)
    ref = np.asarray(jlinalg.psd_project_ns(jnp.asarray(W), iters=iters))
    out = tlinalg.psd_project_ns(torch.from_numpy(W), iters=iters).numpy()
    err = np.abs(out - ref).max(axis=(1, 2))
    assert (err <= 1e-12 * np.linalg.norm(W, axis=(1, 2))).all(), err


def test_spd_inverse_factor():
    """Linv is lower triangular with Linv^T Linv = A^-1, for seeded SPD
    matrices."""
    rs = np.random.RandomState(2)
    M = rs.normal(size=(3, 20, 20))
    A = M @ M.transpose(0, 2, 1) + 20 * np.eye(20)
    Linv = tlinalg.spd_inverse_factor(torch.from_numpy(A)).numpy()
    np.testing.assert_array_equal(np.triu(Linv, 1), 0.0)
    np.testing.assert_allclose(Linv.transpose(0, 2, 1) @ Linv, np.linalg.inv(A), rtol=0, atol=1e-12)


@pytest.mark.parametrize("d,s", [(3, 13), (3, 15), (2, 9)])
def test_fantope(d, s):
    """The Fantope projector (all but the top d eigenvectors) and the sum of
    the small eigenvalues, against the JAX package's 8-sweep Jacobi, on
    seeded symmetric matrices with a gap at the d-th eigenvalue: projector
    to 1e-9, eig_sum to 1e-10."""
    rs = np.random.RandomState(s)
    B = 8
    Q = np.linalg.qr(rs.normal(size=(B, s, s)))[0]
    lam = np.concatenate([rs.uniform(-0.1, 0.1, size=(B, s - d)),
                          rs.uniform(1.0, 3.0, size=(B, d))], axis=1)
    Z = np.einsum("bik,bk,bjk->bij", Q, lam, Q)
    C_j, e_j = jcd._fantope(jnp.asarray(Z), d, 8)
    C_t, e_t = tcd._fantope(torch.from_numpy(Z), d)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-10)
    # and the exact answer
    np.testing.assert_allclose(e_t.numpy(), np.sort(lam, axis=1)[:, :s - d].sum(1), atol=1e-12)


def test_fantope_reads_both_triangles():
    """An asymmetric input is symmetrised first, as jnp.linalg.eigh does."""
    rs = np.random.RandomState(5)
    Z = rs.normal(size=(4, 13, 13))
    C_a, e_a = tcd._fantope(torch.from_numpy(Z), 3)
    C_s, e_s = tcd._fantope(torch.from_numpy(0.5 * (Z + Z.transpose(0, 2, 1))), 3)
    torch.testing.assert_close(C_a, C_s, rtol=0, atol=1e-12)
    torch.testing.assert_close(e_a, e_s, rtol=0, atol=1e-12)
    _, e_j = jcd._fantope(jnp.asarray(Z), 3, 0)  # jnp.linalg.eigh
    np.testing.assert_allclose(e_a.numpy(), np.asarray(e_j), rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["ur10", "table", "planar6", "floor"])
def test_split_aux(name):
    """Per-instance goal rows, G_sd, G_dd, the Schur factor and its inverse
    on 4 FK goals, to 1e-9."""
    jps, tps = structures(name)
    floor = name == "floor"
    jc, tc = jcd.compile_cidgik(jps, floor_mode=floor), tcd.compile_cidgik(tps, floor_mode=floor)
    anc = anchor_positions(jps, jc, 4, seed=3)
    aux_j = jcd._split_aux(jcd._build_split_operator(jc), jnp.asarray(anc), None, jnp.float64)
    aux_t = tcd._split_aux(tcd._build_split_operator(tc), torch.from_numpy(anc))
    for k, v in aux_j.items():
        np.testing.assert_allclose(aux_t[k].numpy(), np.asarray(v), rtol=0, atol=1e-9,
                                   err_msg=f"{name} {k}")
    assert int(aux_t["schur_info"].abs().sum()) == 0


@pytest.fixture(scope="module")
def nearest_inputs():
    """planar6 anchors of 6 FK goals (s = 6, 8 equality and 5 bound rows),
    and targets from other configurations."""
    jps, tps = structures("planar6")
    jc, tc = jcd.compile_cidgik(jps), tcd.compile_cidgik(tps)
    anc = anchor_positions(jps, jc, 6, seed=4)
    q = np.random.RandomState(5).uniform(-1.0, 1.0, size=(6, jps.template.n))
    tgt = np.asarray(jps.realization(jnp.asarray(q)))[:, jc.free_idx]
    return jc, tc, anc, tgt


@pytest.mark.parametrize("ranges", [False, True])
def test_nearest_point_sdp(nearest_inputs, ranges):
    """One nearest-point SDP per instance (the vmap engine), 150 ADMM
    iterations, with and without the bound rows: points, Z and feas to
    1e-9."""
    jc, tc, anc, tgt = nearest_inputs
    p = jcd.CidgikParams(admm_iters=150)
    out_j = jcd.solve_nearest_point_sdp(jc, anc, tgt, params=p, ranges=ranges)
    out_t = tcd.solve_nearest_point_sdp(tc, anc, tgt, params=tcd.CidgikParams(admm_iters=150),
                                        ranges=ranges, device="cpu")
    for k in ("points", "Z", "feas"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=0, atol=1e-9,
                                   err_msg=k)
    assert out_t["points"].shape == (6, tc.n_free, 2)
