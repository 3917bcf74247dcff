"""The port's data-parallel sharded solve (parallel/mesh.py) against its
unsharded solver, on meshes of CPU devices (the card's checks are in
test_torch_cuda.py and chip_smoke.py phase 16), mirroring
tests/test_parallel.py: every lane within JAX's tolerance there (q rtol
1e-3, atol 1e-4, because batched eigh and matmul may round differently at
another batch size) and `success` equal on every lane."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.parallel import mesh as jmesh
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.parallel import mesh as tmesh
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers.riemannian import TRParams

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ur10():
    return tlib.load_ur10()[1]


@pytest.fixture(scope="module")
def goals():
    """13 UR10 goals (ragged over 2 and 3 shards) from a RandomState seed."""
    tpl = jlib.load_ur10()[0]
    q = np.random.RandomState(5).uniform(tpl.lb[1:], tpl.ub[1:], size=(13, tpl.n))
    return torch.from_numpy(np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee]))


def test_make_mesh():
    assert tmesh.make_mesh(devices=["cpu", "cpu", "cpu"]) == [CPU] * 3
    assert tmesh.make_mesh(2, devices=[CPU] * 3) == [CPU] * 2
    with pytest.raises(ValueError):
        tmesh.make_mesh(4, devices=[CPU] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_shard_batch_ragged():
    x = torch.arange(14.0).reshape(7, 2)
    parts = tmesh.shard_batch(x, [CPU] * 3)
    assert [p.shape[0] for p in parts] == [3, 2, 2]
    assert torch.equal(torch.cat(parts), x)
    d = tmesh.shard_batch({"a": x, "b": x[:, 0]}, [CPU] * 2)
    assert len(d) == 2 and torch.equal(d[1]["b"], x[4:, 0])


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_solve_matches_unsharded(ur10, goals, n_shards):
    params = TRParams(maxiter=25)
    out_s = tmesh.solve_ik_sharded(ur10, goals, [CPU] * n_shards, params=params)
    out_l = tapi.solve_ik(ur10, goals, params=params)
    assert set(out_s) == set(out_l)
    for k, v in out_s.items():
        assert tuple(v.shape) == tuple(out_l[k].shape) and v.device == CPU, k
    np.testing.assert_allclose(out_s["q"].numpy(), out_l["q"].numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(out_s["success"].numpy(), out_l["success"].numpy())


def test_sharded_pads_with_goal_zero(ur10, goals):
    """The padding lanes are copies of goal 0 and are cut off: 13 goals
    over 3 shards solve 15 instances and return 13."""
    calls = []
    real = tapi.Solver.__call__

    def spy(solver, T_goal, Y_init=None):
        calls.append(T_goal.clone())
        return real(solver, T_goal, Y_init)

    tapi.Solver.__call__ = spy
    try:
        out = tmesh.solve_ik_sharded(ur10, goals, [CPU] * 3, params=TRParams(maxiter=2))
    finally:
        tapi.Solver.__call__ = real
    assert [c.shape[0] for c in calls] == [5, 5, 5]
    assert torch.equal(calls[-1][-2:], goals[:1].expand(2, *goals.shape[1:]))
    assert out["q"].shape[0] == 13


def test_summarize_across_shards(ur10, goals):
    """summarize over the gathered shards equals summarize of the unsharded
    result on the same lanes, and the JAX package's summarize of the same
    numbers (which takes its means in float32: rtol 1e-6)."""
    out = tapi.solve_ik(ur10, goals, params=TRParams(maxiter=10))
    keys = ("e_pos", "e_rot", "success", "iterations")
    data = {k: out[k] for k in keys}
    parts = tmesh.shard_batch(data, [CPU] * 3)
    gathered = {k: torch.cat([p[k] for p in parts]) for k in keys}
    s_local = tmesh.summarize(data)
    s_sharded = tmesh.summarize(gathered)
    s_jax = jmesh.summarize({k: jnp.asarray(v.numpy()) for k, v in data.items()})
    for k in s_local:
        assert s_sharded[k] == s_local[k], k
        np.testing.assert_allclose(s_local[k], float(s_jax[k]), rtol=1e-6, err_msg=k)


def test_dryrun_multigpu_on_cpu_mesh():
    q, metrics = tmesh.dryrun_multigpu(devices=[CPU] * 2)
    assert tuple(q.shape) == (4, 6)
    assert 0.0 <= metrics["success_rate"] <= 1.0
