"""Sparse (chordal) CIDGIK: the port against the JAX package
(graphik_tpu/solvers/cidgik_sparse.py) and the mirrors of
tests/test_cidgik_sparse.py.

Parity: the clique decomposition, the compiled stamp tables, the split
operator, the per-instance constraint tensors and split data (D_flat
included), the Fantope step and solve_cidgik_sparse on both engines and
with floor_mode, float64, goals from seeded numpy draws. Solves are held to
1e-6 in points, q, eig_sum and feas with status equal (measured: 3e-13 and
below); the float32 case's tolerances are stated at its test.
torch.linalg.eigh is held on stacks of zero-padded clique blocks, which the
JAX package decomposes by fixed-sweep Jacobi because XLA's batched eigh
returned NaN on them.

The mirrors hold the port to the JAX tests' own absolute criteria and
budgets, on the port alone; the two longest, the UR10 solve and the
rank-forcing run, are in tests/test_torch_cidgik_sparse_mirrors.py, so that
a run that spreads test files over workers spreads these two.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphik_tpu import api as japi
from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import cidgik as jcd
from graphik_tpu.solvers import cidgik_sparse as jcs
from graphik_tpu.utils import chordal as jchordal
from graphik_tpu.utils.environments import table_environment as jtable
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch import interop
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import cidgik as tcd
from graphik_tpu_torch.solvers import cidgik_sparse as tcs
from graphik_tpu_torch.utils import chordal as tchordal
from graphik_tpu_torch.utils.environments import table_environment as ttable
from tests.test_kinematics import ur10_template

torch.set_num_threads(1)

KEYS = ("q", "T_base", "points", "status", "eig_sum", "feas")


def structures(name):
    """(JAX, port) ProblemStructure of one test configuration."""
    if name == "planar6":
        return (jlib.load_planar_chain(6, limits=np.pi / 2)[1],
                tlib.load_planar_chain(6, limits=np.pi / 2)[1])
    obstacles = (jtable(), ttable()) if name == "table" else (None, None)
    return (JPS.from_template(jlib.load_ur10()[0], obstacles=obstacles[0]),
            TPS.from_template(tlib.load_ur10()[0], obstacles=obstacles[1]))


@pytest.fixture(scope="module", params=["ur10", "floor", "table", "planar6"])
def compiled(request):
    name = request.param
    jps, tps = structures("ur10" if name == "floor" else name)
    floor = name == "floor"
    return (name, jcs.compile_cidgik_sparse(jps, floor_mode=floor),
            tcs.compile_cidgik_sparse(tps, floor_mode=floor))


@pytest.fixture(scope="module")
def ur10():
    return structures("ur10")[1]


@pytest.fixture(scope="module")
def comp(ur10):
    return tcs.compile_cidgik_sparse(ur10)


def goals(tpl, B, seed):
    """FK poses (B, n_ee, 4, 4) of seeded joint angles within the limits."""
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    return np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])


def anchor_positions(jps, jcomp, B, seed):
    return np.asarray(jps.goal_positions(goals(jps.template, B, seed)))[:, jcomp.anchor_idx]


def lifted_blocks(comp, pos_free):
    """Stacked clique blocks (numpy) at given free-node positions."""
    return tcs.lifted_blocks(comp, torch.from_numpy(np.asarray(pos_free, np.float64))).numpy()


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_chordal_cliques_random_graphs(seed):
    """MCS-M triangulation, elimination order and maximal cliques identical
    on seeded random graphs of 5-14 nodes and densities 0.15-0.5."""
    rs = np.random.RandomState(seed)
    n = rs.randint(5, 15)
    adj = np.triu(rs.uniform(size=(n, n)) < rs.uniform(0.15, 0.5), 1)
    adj = adj | adj.T
    chordal_j, order_j = jchordal.complete_to_chordal(adj)
    chordal_t, order_t = tchordal.complete_to_chordal(adj)
    np.testing.assert_array_equal(chordal_t, chordal_j)
    assert order_t == order_j
    assert tchordal.chordal_cliques(adj) == jchordal.chordal_cliques(adj)


def test_compile_tables_equal(compiled):
    """Cliques identical; every stamp table: integers exactly, floats to
    1e-12."""
    name, jc, tc = compiled
    assert tc.cliques == jc.cliques and (tc.K, tc.smax, tc.ds) == (jc.K, jc.smax, jc.ds), name
    for f in dataclasses.fields(jc):
        if f.name in ("structure", "cliques"):
            continue
        a, b = np.asarray(getattr(jc, f.name)), np.asarray(getattr(tc, f.name))
        assert a.shape == b.shape, (name, f.name)
        if a.dtype.kind in "biu":
            assert b.dtype.kind == a.dtype.kind and np.array_equal(a, b), (name, f.name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=f"{name} {f.name}")


def test_sizes():
    """The sizes the split engine runs at on UR10 (the bench configuration)
    and on floor_mode."""
    sizes = {}
    for name, floor in (("ur10", False), ("floor", True)):
        tc = tcs.compile_cidgik_sparse(structures("ur10")[1], floor_mode=floor)
        op = tcs._build_sparse_split_operator(tc)
        sizes[name] = (tc.K, tc.smax, tc.ds, op.m_eq_s, op.m_in_s, op.m_d)
    assert sizes == {"ur10": (3, 6, 9, 86, 8, 8), "floor": (4, 6, 9, 117, 8, 8)}, sizes


def test_interop_rebuilds_the_compiled_problem(compiled):
    """cidgik_sparse_from_numpy of JAX's fields gives the port's own
    compilation."""
    name, jc, tc = compiled
    rebuilt = interop.cidgik_sparse_from_numpy(dataclasses.asdict(jc))
    for f in dataclasses.fields(tc):
        if f.name == "cliques":
            assert rebuilt.cliques == tc.cliques, name
        elif f.name != "structure":
            assert np.array_equal(getattr(rebuilt, f.name), getattr(tc, f.name)), (name, f.name)
    np.testing.assert_array_equal(rebuilt.structure.D_struct, tc.structure.D_struct)


def test_split_operator_equal(compiled):
    """The static rows, their Gram and inverse factor, and the goal-row
    tables, to 1e-10; cached on the compiled problem."""
    name, jc, tc = compiled
    jop, top = jcs._build_sparse_split_operator(jc), tcs._build_sparse_split_operator(tc)
    assert tcs._build_sparse_split_operator(tc) is top
    for f in dataclasses.fields(jop):
        a, b = np.asarray(getattr(jop, f.name)), np.asarray(getattr(top, f.name))
        assert a.shape == b.shape, (name, f.name)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-10, err_msg=f"{name} {f.name}")


def test_constraint_tensors_equal(compiled):
    """The vmap engine's per-instance constraint tensors, row-normalized,
    batched over 3 FK goals, against JAX's one instance at a time, to
    1e-10."""
    name, jc, tc = compiled
    anc = anchor_positions(jc.structure, jc, 3, seed=1)
    out_t = tcs._constraint_tensors(tc, torch.from_numpy(anc))
    for i in range(3):
        out_j = jcs._constraint_tensors(jc, jnp.asarray(anc[i]), jnp.float64)
        for a, b in zip(out_j, out_t):
            np.testing.assert_allclose(b[i].numpy(), np.asarray(a), rtol=0, atol=1e-10,
                                       err_msg=name)


def test_sparse_split_aux_equal(compiled):
    """Per-instance goal rows, G_sd, G_dd, the Schur factor and its inverse
    and D_flat (whose scatter moves the index dims in JAX) on 5 FK goals,
    to 1e-9."""
    name, jc, tc = compiled
    anc = anchor_positions(jc.structure, jc, 5, seed=3)
    aux_j = jcs._sparse_split_aux(jcs._build_sparse_split_operator(jc), jnp.asarray(anc),
                                  jnp.float64)
    aux_t = tcs._sparse_split_aux(tcs._build_sparse_split_operator(tc), torch.from_numpy(anc))
    assert aux_t["D_flat"].shape == (5, tc._split_op.m_d, tc.K * tc.ds ** 2)
    for k, v in aux_j.items():
        np.testing.assert_allclose(aux_t[k].numpy(), np.asarray(v), rtol=0, atol=1e-9,
                                   err_msg=f"{name} {k}")
    assert int(aux_t["schur_info"].abs().sum()) == 0


def padded_blocks(comp, B, seed, noise):
    """(B, K, ds, ds) lifted blocks at seeded points plus symmetric noise,
    with the padded rows and columns exactly zero."""
    rs = np.random.RandomState(seed)
    Z = lifted_blocks(comp, rs.normal(size=(B, comp.n_free, comp.d)))
    E = rs.normal(size=Z.shape)
    valid = tcs._valid_slots(comp.member, comp.d)
    return (Z + noise * (E + E.transpose(0, 1, 3, 2))) * (valid[:, :, None] * valid[:, None, :])


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_fantope_blocks_equal(comp, noise):
    """The per-clique Fantope cost and excess-rank sum against the JAX
    package's (30-sweep Jacobi, its float64 setting) on padded stacks: C
    and eig_sum to 1e-8; C is zero on the padded slots."""
    Z = padded_blocks(comp, 6, seed=4, noise=noise)
    C_t, e_t = tcs._fantope_blocks(torch.from_numpy(Z), comp.d, comp.member)
    C_j, e_j = jcs._fantope_blocks_batched(jnp.asarray(Z), comp.d, comp.member, eigh_sweeps=0)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=0, atol=1e-8)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-8)
    pad = tcs._valid_slots(comp.member, comp.d) == 0
    assert pad.any() and np.abs(C_t.numpy()[:, pad]).max() == 0.0


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_eigh_on_padded_clique_stacks(comp, dtype, tol):
    """torch.linalg.eigh on 1024 lanes of UR10's stacked clique blocks
    (K = 3, ds = 9, the middle block with an exact-zero padded row and
    column): every value finite, eigenvalues within tol x the block's
    Frobenius norm of numpy's float64 eigvalsh."""
    assert comp.smax == 6 and sorted(len(c) for c in comp.cliques) == [5, 6, 6]
    Z = padded_blocks(comp, 1024, seed=5, noise=0.05)
    lam, Q = torch.linalg.eigh(torch.from_numpy(Z).to(dtype))
    assert bool(torch.isfinite(lam).all() and torch.isfinite(Q).all())
    ref = np.linalg.eigvalsh(Z)
    scale = np.linalg.norm(Z, axis=(-2, -1))[..., None]
    err = np.abs(lam.double().numpy() - ref) / scale
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("name,engine,floor,kw,B,seed", [
    ("split_ns", "split", False,
     dict(admm_iters=100, admm_iters_rest=50, max_outer=3, cone_ns_iters=16, rho=10.0), 8, 0),
    ("split_eigh", "split", False, dict(admm_iters=60, admm_iters_rest=30, max_outer=3), 6, 1),
    ("floor", "split", True, dict(admm_iters=100, admm_iters_rest=50, max_outer=3), 6, 2),
    ("vmap_ns_tol", "vmap", False,
     dict(admm_iters=60, max_outer=2, admm_tol=5e-3, cone_ns_iters=16, rho=10.0), 6, 3),
    ("split_tol", "split", False, dict(admm_iters=300, max_outer=2, admm_tol=0.05), 6, 4),
])
def test_solve_matches_jax(name, engine, floor, kw, B, seed):
    """solve_cidgik_sparse against the JAX package at float64: status
    equal, q, T_base, points, eig_sum and feas within 1e-6."""
    jps, tps = structures("ur10")
    T = goals(jps.template, B, seed)
    out_j = jcs.solve_cidgik_sparse(jcs.compile_cidgik_sparse(jps, floor_mode=floor),
                                    jnp.asarray(T), params=jcd.CidgikParams(**kw), engine=engine)
    out_j = {k: np.asarray(v) for k, v in out_j.items()}
    out_t = tcs.solve_cidgik_sparse(tcs.compile_cidgik_sparse(tps, floor_mode=floor),
                                    torch.from_numpy(T), params=tcd.CidgikParams(**kw),
                                    engine=engine)
    assert sorted(out_t) == sorted(KEYS)
    for k in KEYS:
        assert tuple(out_t[k].shape) == out_j[k].shape, (name, k)
    np.testing.assert_array_equal(out_t["status"].numpy(), out_j["status"], err_msg=name)
    for k in ("q", "T_base", "points", "eig_sum", "feas"):
        np.testing.assert_allclose(out_t[k].numpy(), out_j[k], rtol=0, atol=1e-6,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("engine", ["vmap", "split"])
def test_early_stops_took_effect(engine):
    """admm_tol stops some lanes (vmap engine) or the whole batch (split
    engine) early: against admm_tol = 0, the stopped lanes differ and, on
    the vmap engine, the others are bitwise unchanged; the split engine ran
    fewer steps than its budget."""
    tps = structures("ur10")[1]
    comp = tcs.compile_cidgik_sparse(tps)
    T = torch.from_numpy(goals(tps.template, 6, 3 if engine == "vmap" else 4))
    kw = (dict(admm_iters=200, max_outer=2, admm_tol=1e-2) if engine == "vmap"
          else dict(admm_iters=300, max_outer=2, admm_tol=0.05))
    params = tcd.CidgikParams(**kw)
    tcd.solve_cidgik.admm_steps = 0
    a = tcs.solve_cidgik_sparse(comp, T, params=params, engine=engine)["points"]
    steps = tcd.solve_cidgik.admm_steps
    b = tcs.solve_cidgik_sparse(comp, T, engine=engine,
                                params=dataclasses.replace(params, admm_tol=0.0))["points"]
    same = int((a == b).flatten(1).all(1).sum())
    if engine == "vmap":
        assert 0 < same < len(T), same
    else:
        assert same == 0 and steps < 2 * params.admm_iters, (same, steps)


def test_float32():
    """float32 UR10 at the bench's production point (Newton-Schulz,
    rho = 10), short schedule, both packages in float32 on the CPU: status
    equal, points and eig_sum within 2e-4, feas within 1e-5, q within 2e-3
    (the dense solver's float32 bounds, tests/test_torch_cidgik_solve.py;
    measured here: points 4.0e-5, eig_sum 5.3e-5, feas 4.8e-7, q 4.1e-5)."""
    jps, tps = structures("ur10")
    T = goals(jps.template, 12, 6).astype(np.float32)
    kw = dict(admm_iters=200, admm_iters_rest=100, max_outer=3)
    out_j = jcs.solve_cidgik_sparse(jcs.compile_cidgik_sparse(jps), jnp.asarray(T),
                                    params=jcd.CidgikParams.production(**kw))
    out_t = tcs.solve_cidgik_sparse(tcs.compile_cidgik_sparse(tps), torch.from_numpy(T),
                                    params=tcd.CidgikParams.production(**kw))
    assert out_t["points"].dtype == torch.float32
    np.testing.assert_array_equal(out_t["status"].numpy(), np.asarray(out_j["status"]))
    for k, tol in (("points", 2e-4), ("eig_sum", 2e-4), ("feas", 1e-5), ("q", 2e-3)):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=0, atol=tol,
                                   err_msg=k)


def test_entry_point_defaults_to_the_card(comp):
    """Numpy goals with no device go to the card and raise without one;
    device="cpu" runs them on the CPU; a torch tensor stays where it is; an
    unknown engine raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    T = goals(comp.structure.template, 2, 5)
    p = tcd.CidgikParams(admm_iters=5, max_outer=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcs.solve_cidgik_sparse(comp, T, params=p)
    assert tcs.solve_cidgik_sparse(comp, T, params=p, device="cpu")["q"].device.type == "cpu"
    assert tcs.solve_cidgik_sparse(comp, torch.from_numpy(T), params=p)["q"].device.type == "cpu"
    with pytest.raises(ValueError, match="engine"):
        tcs.solve_cidgik_sparse(comp, T, params=p, device="cpu", engine="dense")


# ---------------------------------------------------------------------------
# Mirrors of tests/test_cidgik_sparse.py, on the port
#
# On that file's own inputs: its UR10 (tests/test_kinematics.py's template,
# given to the port through interop) and its goals (the JAX package's
# random_goals with its keys, handed over as numpy), since its absolute
# criteria were set on those draws. On other draws the same budgets can
# miss them in both packages alike: seeded numpy goals (RandomState(0))
# reach 1 cm on 0 of 3 at 800 x 8 iterations.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mirror():
    """(JAX structure, port structure, port compiled problem) of the JAX
    tests' UR10."""
    jps = JPS.from_template(ur10_template())
    tps = interop.structure_from_numpy(dataclasses.asdict(jps))
    return jps, tps, tcs.compile_cidgik_sparse(tps)


def jax_goals(jps, key, n):
    return np.asarray(japi.random_goals(jps, jax.random.PRNGKey(key), (n,))[0])


def test_cliques_cover_edges(mirror):
    """Every exact or bounded free-free edge lies in some clique."""
    _, ur10, comp = mirror
    free_slot = {int(n): i for i, n in enumerate(comp.free_idx)}
    for a in range(ur10.N):
        for b in range(a + 1, ur10.N):
            if a in free_slot and b in free_slot and (ur10.omega_struct[a, b]
                                                      or ur10.bounded_mask[a, b]):
                u, v = free_slot[a], free_slot[b]
                assert any(u in c and v in c for c in comp.cliques), (a, b)


def test_is_actually_sparse(mirror):
    """More than one clique, each smaller than the free-node set."""
    comp = mirror[2]
    assert comp.K > 1
    assert comp.smax < comp.n_free


def residuals_at_fk_points(ps, comp, seed, n):
    """Max |A_eq(Z) - b| and the worst bound violation of the lifted blocks
    at the FK points of n seeded configurations, float64."""
    q = np.random.RandomState(seed).uniform(-np.pi, np.pi, size=(n, ps.n))
    pos = ps.realization(torch.from_numpy(q)).numpy()
    A_eq, b_eq, A_in, lo, hi = tcs._constraint_tensors(
        comp, torch.from_numpy(pos[:, comp.anchor_idx]))
    r_eq, vio = 0.0, 0.0
    for i in range(n):
        Z = lifted_blocks(comp, pos[i, comp.free_idx])
        r = np.einsum("mkij,kij->m", A_eq[i].numpy(), Z) - b_eq[i].numpy()
        r_eq = max(r_eq, float(np.abs(r).max()))
        if A_in.shape[1]:
            v = np.einsum("mkij,kij->m", A_in[i].numpy(), Z)
            vio = max(vio, float(np.maximum(lo[i].numpy() - v, v - hi[i].numpy()).max()))
    return r_eq, vio


def test_residuals_zero_at_fk_points(mirror):
    _, ur10, comp = mirror
    r_eq, vio = residuals_at_fk_points(ur10, comp, seed=0, n=3)
    assert r_eq < 1e-8, r_eq
    assert vio <= 1e-6, vio


def pose_errors(ps, out, T):
    e_pos, e_rot = tapi.pose_error(ps, out["q"], torch.as_tensor(T))
    return e_pos.numpy(), e_rot.numpy()


def test_matches_dense_points(mirror):
    """Sparse and dense CIDGIK both solve instances of the same relaxation."""
    jps, ur10, comp = mirror
    T = jax_goals(jps, 5, 2)
    p = tcd.CidgikParams(admm_iters=800, max_outer=8)
    out_s = tcs.solve_cidgik_sparse(comp, torch.from_numpy(T), params=p)
    out_d = tcd.solve_cidgik(tcd.compile_cidgik(ur10), torch.from_numpy(T), params=p)
    assert (pose_errors(ur10, out_s, T)[0] < 2e-2).sum() >= 1
    assert (pose_errors(ur10, out_d, T)[0] < 2e-2).sum() >= 1


@pytest.fixture(scope="module")
def fcomp(mirror):
    return tcs.compile_cidgik_sparse(mirror[1], floor_mode=True)


def test_floor_compile_frees_base_and_adds_planar_rows(mirror, fcomp):
    ur10 = mirror[1]
    base = {int(ur10.idx_p(0)), int(ur10.idx_q(0))}
    assert base <= {int(i) for i in fcomp.free_idx}
    assert not base & {int(i) for i in fcomp.anchor_idx}
    assert len(fcomp.lin_u) == 2
    assert fcomp.n_free == 12  # p0..p5, q0..q5


def test_floor_residuals_zero_at_fk_points(mirror, fcomp):
    """The canonical configuration's base sits on the floor, so every
    constraint, the planar rows included, holds exactly."""
    r_eq, _ = residuals_at_fk_points(mirror[1], fcomp, seed=5, n=1)
    assert r_eq < 1e-8, r_eq


def test_floor_solve_keeps_base_on_planes(mirror, fcomp):
    """The returned iterate satisfies the planar rows (z(p0) ~ 0,
    z(q0) ~ 1); T_base is a rigid base pose on the floor and FK(q) reaches
    T_base^-1 T_goal."""
    jps, ur10, _ = mirror
    T = jax_goals(jps, 3, 2)
    out = tcs.solve_cidgik_sparse(fcomp, torch.from_numpy(T),
                                  params=tcd.CidgikParams(admm_iters=1000, max_outer=8))
    pts = out["points"].numpy()
    p0, q0 = pts[:, int(ur10.idx_p(0))], pts[:, int(ur10.idx_q(0))]
    assert np.abs(p0[:, 2]).max() < 2e-2, p0
    assert np.abs(q0[:, 2] - 1.0).max() < 2e-2, q0
    Tb = out["T_base"].numpy()
    R = Tb[:, :3, :3]
    assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() < 1e-6
    assert np.abs(Tb[:, 2, 3]).max() < 2e-2
    Tg_base = np.linalg.inv(Tb)[:, None] @ T
    e_pos, e_rot = pose_errors(ur10, out, Tg_base)
    assert ((e_pos < 2e-2) & (e_rot < 5e-2)).sum() >= 1, (e_pos, e_rot)
