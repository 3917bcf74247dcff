"""Port vs JAX package: the auxiliary modules - profiling, stats, checkpoint
(with the npz round trip between the two packages), geometry, the
constraint callables - and the single functions the solve paths do not
run (the lie maps, procrustes_align, normalize_positions,
jacobian_geometric, distance_bounds_from_sampling). Mirrors
tests/test_aux_subsystems.py, tests/test_utils_aux.py and
tests/test_constraints.py; inputs are made with numpy and handed to both
packages."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.graphs import constraints as jcon
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.utils import checkpoint as jck
from graphik_tpu.utils import dgp as jdgp
from graphik_tpu.utils import geometry as jgeo
from graphik_tpu.utils import lie as jlie
from graphik_tpu.utils import stats as jstats
from graphik_tpu_torch.graphs import constraints as tcon
from graphik_tpu_torch.robots import kinematics as tkin
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.utils import checkpoint as tck
from graphik_tpu_torch.utils import dgp as tdgp
from graphik_tpu_torch.utils import geometry as tgeo
from graphik_tpu_torch.utils import lie as tlie
from graphik_tpu_torch.utils import profiling
from graphik_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)


def close(t, j, atol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=atol)


# ---------------------------------------------------------------- profiling

def test_stage_timer_accumulates():
    t = profiling.StageTimer()
    with t.stage("a"):
        x = torch.arange(8) * 2.0
        t.sync(x)
    with t.stage("a"):
        pass
    with t.stage("b", sync_result={"y": torch.ones(4), "z": [torch.zeros(2)]}):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["b"]["count"] == 1
    assert s["a"]["total_s"] >= s["a"]["last_s"] >= 0.0
    if not torch.cuda.is_available():
        assert s["a"]["device_total_s"] == 0.0  # no card: no events
    t.reset()
    assert t.summary() == {}


def test_global_timer():
    profiling.reset()
    with profiling.timed("stage1"):
        pass
    assert profiling.global_summary()["stage1"]["count"] == 1


def test_fence_on_cpu_tensors():
    profiling.fence({"a": torch.ones(3), "b": (torch.zeros(1), [torch.ones(2)]), "c": 5})


def test_device_trace_noop():
    with profiling.device_trace(None) as prof:
        x = 1
    assert x == 1 and prof is None


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(16) @ torch.ones(16)
    assert prof is not None
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# ---------------------------------------------------------------- stats

@pytest.mark.parametrize("n,k", [(100, 90), (1000, 861), (16000, 15710), (50, 0), (50, 50)])
def test_stats_match_jax(n, k):
    assert tstats.wilson(n, k, 0.05) == jstats.wilson(n, k, 0.05)
    assert (tstats.bernoulli_confidence_normal_approximation(n, k)
            == jstats.bernoulli_confidence_normal_approximation(n, k))
    assert tstats.bernoulli_confidence_jeffreys(n, k) == jstats.bernoulli_confidence_jeffreys(n, k)


def test_stats_values():
    p, rad = tstats.bernoulli_confidence_normal_approximation(100, 90)
    assert p == pytest.approx(0.9) and 0.05 < rad < 0.07
    lo, hi = tstats.wilson(100, 90)
    assert 0.8 < lo < 0.9 < hi < 1.0
    p, rad = tstats.bernoulli_confidence_jeffreys(100, 99)
    assert 0.9 < p < 1.0 and 0.0 < rad < 0.05
    assert tstats._ndtri(0.975) == pytest.approx(1.959964, abs=1e-4)
    assert tstats._ndtri(0.5) == pytest.approx(0.0, abs=1e-9)


def test_measure_perturbation():
    rs = np.random.RandomState(0)
    p, q = rs.normal(size=(3, 7, 2)), rs.normal(size=(3, 7, 2))
    for a, b in zip(tstats.measure_perturbation(torch.from_numpy(p), torch.from_numpy(q)),
                    jstats.measure_perturbation(p, q)):
        close(a, b)


# ---------------------------------------------------------------- checkpoint

def _state():
    return {
        "cursor": np.asarray(17),
        "metrics": {"success": np.asarray([1.0, 0.0, 1.0]),
                    "e_pos": np.asarray([[1e-4, 2e-4]])},
        "q_last": np.arange(12.0).reshape(2, 6),
        "pair": [np.asarray(1), np.asarray([2.0, 3.0])],
    }


def test_checkpoint_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "ck", "sweep.npz")
    state = dict(_state(), y=torch.arange(4, dtype=torch.float32))
    tck.save_checkpoint(path, state, meta={"seed": 3, "config": "ur10"})
    loaded, meta = tck.load_checkpoint(path)
    assert meta == {"seed": 3, "config": "ur10"}
    assert int(loaded["cursor"]) == 17
    np.testing.assert_array_equal(loaded["q_last"], state["q_last"])
    np.testing.assert_array_equal(loaded["metrics"]["success"], state["metrics"]["success"])
    np.testing.assert_array_equal(loaded["pair"]["1"], [2.0, 3.0])
    assert loaded["y"].dtype == np.float32
    np.testing.assert_array_equal(torch.as_tensor(loaded["y"]), state["y"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_cross_package(tmp_path, writer):
    """A checkpoint written by either package loads in the other, with the
    same state and meta."""
    save, load = ((jck.save_checkpoint, tck.load_checkpoint) if writer == "jax"
                  else (tck.save_checkpoint, jck.load_checkpoint))
    path = str(tmp_path / f"{writer}.npz")
    save(path, _state(), {"writer": writer, "n": [1, 2]})
    st, meta = load(path)
    ref, ref_meta = (jck if writer == "jax" else tck).load_checkpoint(path)
    assert meta == ref_meta == {"writer": writer, "n": [1, 2]}

    def flat(d, pre=""):
        for k, v in sorted(d.items()):
            if isinstance(v, dict):
                yield from flat(v, pre + k + "/")
            else:
                yield pre + k, v

    a, b = dict(flat(st)), dict(flat(ref))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_checkpoint_reserved_savez_name(tmp_path):
    path = os.path.join(tmp_path, "f.npz")
    tck.save_checkpoint(path, {"file": np.asarray(5)}, {})
    st, _ = tck.load_checkpoint(path)
    assert int(st["file"]) == 5


def test_checkpoint_rejects_separator_keys(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        tck.save_checkpoint(os.path.join(tmp_path, "g.npz"), {"a/b": np.asarray(1)}, {})


def test_checkpoint_atomic_overwrite(tmp_path):
    path = os.path.join(tmp_path, "c.npz")
    tck.save_checkpoint(path, {"v": np.asarray(1)}, {"gen": 1})
    tck.save_checkpoint(path, {"v": torch.tensor(2)}, {"gen": 2})
    st, meta = tck.load_checkpoint(path)
    assert int(st["v"]) == 2 and meta["gen"] == 2
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


# ---------------------------------------------------------------- geometry

def test_geometry_matches_jax():
    rs = np.random.RandomState(2)
    P, C, N = rs.normal(size=(5, 3)), rs.normal(size=(5, 3)), rs.normal(size=(5, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    r = rs.uniform(0.1, 1.0, size=5)
    for a, b in zip(tgeo.max_min_distance_revolute(torch.from_numpy(r), P, C, N),
                    jgeo.max_min_distance_revolute(r, P, C, N)):
        close(a, b)
    close(tgeo.skew(P), jgeo.skew(jnp.asarray(P)))
    # a point on the circle's axis: every circle point lies at one distance
    d_max, d_min = tgeo.max_min_distance_revolute(0.5, [0.0, 0.0, 2.0], [0.0, 0.0, 0.0],
                                                  [0.0, 0.0, 1.0])
    assert float(d_max) == pytest.approx(float(d_min)) == pytest.approx(np.hypot(0.5, 2.0))


# ---------------------------------------------------------------- constraints

@pytest.fixture(scope="module")
def ur10():
    return jlib.load_ur10()[1], tlib.load_ur10()[1]


def test_constraints_match_jax(ur10):
    jps, tps = ur10
    jc = jcon.constraints_from_structure(jps)
    tc = tcon.constraints_from_structure(tps)
    assert [(c.name, c.kind) for c in tc] == [(c.name, c.kind) for c in jc]
    assert sum(c.kind == "eq" for c in tc) > 10
    rs = np.random.RandomState(0)
    pos = rs.standard_normal((3, tps.N, 3))
    jr, jv = jcon.violations(jc, jnp.asarray(pos))
    tr, tv = tcon.violations(tc, torch.from_numpy(pos))
    close(tr, jr)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert bool(tv.any())


def test_constraints_hold_at_fk(ur10):
    _, tps = ur10
    rs = np.random.RandomState(1)
    cons = tcon.constraints_from_structure(tps, include_bounds=True)
    for _ in range(3):
        pos = tps.realization(torch.from_numpy(rs.uniform(-np.pi, np.pi, 6)))
        res, viol = tcon.violations(cons, pos, tol=1e-6)
        assert not bool(viol.any()), float(res.abs().max())


def test_angular_constraints_planar():
    jps = jlib.load_planar_chain(5, limits=np.pi / 2)[1]
    tps = tlib.load_planar_chain(5, limits=np.pi / 2)[1]
    jc, tc = jcon.angular_constraints(jps), tcon.angular_constraints(tps)
    assert len(tc) == 4 and [c.name for c in tc] == [c.name for c in jc]
    rs = np.random.RandomState(3)
    q = rs.uniform(-np.pi / 2, np.pi / 2, size=(5, 5))
    pos = tps.realization(torch.from_numpy(q))
    res, viol = tcon.violations(tc, pos, tol=1e-6)
    assert not bool(viol.any())
    close(res, jcon.violations(jc, jps.realization(jnp.asarray(q)), tol=1e-6)[0])
    eq = tcon.angular_constraints(tps, as_equality=True)
    assert all(c.kind == "eq" for c in eq)


def test_nearest_neighbour_cost(ur10):
    jps, tps = ur10
    q = np.random.RandomState(4).uniform(-np.pi, np.pi, 6)
    pos = tcon.nearest_points_from_config(tps, q).numpy()
    close(pos, jcon.nearest_points_from_config(jps, jnp.asarray(q)))
    targets = pos.copy()
    targets[3] = np.nan
    cost = tcon.nearest_neighbour_cost(tps, targets)
    assert float(cost(torch.from_numpy(pos))) < 1e-12
    shifted = torch.from_numpy(pos + 0.1)
    np.testing.assert_allclose(float(cost(shifted)), (tps.N - 1) * 3 * 0.1 ** 2, rtol=1e-9)
    close(cost(shifted), jcon.nearest_neighbour_cost(jps, targets)(jnp.asarray(pos + 0.1)))


# ---------------------------------------------------------------- single functions

def test_lie_functions_match_jax():
    rs = np.random.RandomState(5)
    th = rs.uniform(-np.pi, np.pi, size=7)
    for t_fn, j_fn in ((tlie.rotx, jlie.rotx), (tlie.roty, jlie.roty), (tlie.rotz, jlie.rotz)):
        close(t_fn(torch.from_numpy(th)), j_fn(jnp.asarray(th)))
    w = rs.normal(size=(4, 3))
    W = tlie.so3_hat(torch.from_numpy(w))
    close(tlie.so3_vee(W), jlie.so3_vee(jnp.asarray(W.numpy())))
    close(tlie.so3_vee(W), w)
    T = tlie.se3_exp(torch.from_numpy(rs.normal(size=(4, 6))))
    close(tlie.se3_rot(T), jlie.se3_rot(jnp.asarray(T.numpy())))
    close(tlie.se3_trans(T), jlie.se3_trans(jnp.asarray(T.numpy())))
    close(tlie.se3_identity(), jlie.se3_identity())
    close(tlie.se2_identity(), jlie.se2_identity())
    assert tlie.se3_identity(torch.float32).dtype == torch.float32


def test_procrustes_and_normalize_match_jax():
    rs = np.random.RandomState(6)
    for d in (2, 3):
        X = rs.normal(size=(4, 9, d))
        R = np.linalg.qr(rs.normal(size=(4, d, d)))[0]
        R[np.linalg.det(R) < 0, :, 0] *= -1
        Y = np.einsum("bij,bnj->bni", R, X) + rs.normal(size=(4, 1, d))
        out = tdgp.procrustes_align(torch.from_numpy(X), torch.from_numpy(Y))
        close(out, jdgp.procrustes_align(jnp.asarray(X), jnp.asarray(Y)), atol=1e-10)
        close(out, Y, atol=1e-10)
        Z = tdgp.normalize_positions(torch.from_numpy(Y)).numpy()
        Zj = np.asarray(jdgp.normalize_positions(jnp.asarray(Y)))
        # eigenvectors are defined up to sign: compare column by column
        sign = np.sign((Z * Zj).sum(axis=-2, keepdims=True))
        close(Z * sign, Zj, atol=1e-10)
        C = np.einsum("bni,bnj->bij", Z, Z)
        close(C - np.eye(d) * np.diagonal(C, axis1=-2, axis2=-1)[:, None, :], 0.0, atol=1e-10)


def test_jacobian_geometric_matches_jax():
    jt, tt = jlib.load_ur10()[0], tlib.load_ur10()[0]
    q = np.random.RandomState(7).uniform(-np.pi, np.pi, size=(3, 6))
    for node in (3, 6):
        close(tkin.jacobian_geometric(tt, torch.from_numpy(q), node),
              jkin.jacobian_geometric(jt, jnp.asarray(q), node))
    with pytest.raises(ValueError, match="3D"):
        tkin.jacobian_geometric(tlib.load_planar_chain(3)[0], torch.zeros(3), 2)


def test_distance_bounds_from_sampling():
    """The bounds are the elementwise min / max distance over the sampled
    configurations (the same draws from the same generator), the compiled
    exact edges stay exact, and the edges that come out exact are the JAX
    package's (which draws its own 2000 configurations)."""
    jps, tps = jlib.load_planar_chain(4, limits=np.pi / 2)[1], tlib.load_planar_chain(
        4, limits=np.pi / 2)[1]
    t = tps.distance_bounds_from_sampling(torch.Generator().manual_seed(1), n_samples=2000)
    j = jps.distance_bounds_from_sampling(n_samples=2000)
    assert t.edge_mask.sum() == tps.N * (tps.N - 1) and not t.edge_mask.diagonal().any()
    np.testing.assert_array_equal(t.edge_mask, j.edge_mask)
    np.testing.assert_array_equal(t.omega_struct, j.omega_struct)
    assert (t.omega_struct >= tps.omega_struct).all()
    close(t.D_struct[tps.omega_struct], tps.D_struct[tps.omega_struct], atol=1e-9)
    q = tkin.random_configuration(tps.template, (2000,), torch.Generator().manual_seed(1),
                                  dtype=torch.float64, device="cpu")
    pos = tps.realization(q).numpy()
    D = np.sqrt(((pos[:, :, None] - pos[:, None]) ** 2).sum(-1))
    close(t.L_edges, D.min(0), atol=1e-12)
    close(t.U_edges, D.max(0), atol=1e-12)


def test_small_matmuls_are_products():
    """lie.matmul_small / matvec_small compute a @ b and a @ v (broadcast,
    transposed views), and a lane's result does not depend on its batch."""
    rs = np.random.RandomState(8)
    a, b = torch.from_numpy(rs.normal(size=(9, 7, 4, 4))), torch.from_numpy(rs.normal(size=(7, 4, 4)))
    close(tlie.matmul_small(a, b), a @ b)
    m, n = torch.from_numpy(rs.normal(size=(9, 6, 6))), torch.from_numpy(rs.normal(size=(9, 6, 10)))
    close(tlie.matmul_small(m, n), m @ n)
    v = torch.from_numpy(rs.normal(size=(9, 4)))
    close(tlie.matvec_small(a[:, 0].transpose(-1, -2), v), (a[:, 0].transpose(-1, -2) @ v[..., None])[..., 0])
    assert torch.equal(tlie.matmul_small(m[:3], n[:3]), tlie.matmul_small(m, n)[:3])
    assert torch.equal(tlie.matvec_small(m[:2, :, :4], v[:2]), tlie.matvec_small(m[:, :, :4], v)[:2])
