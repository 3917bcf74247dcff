"""Sparse (chordal) CIDGIK: the two longest mirrors of
tests/test_cidgik_sparse.py on the port (the UR10 solve and the
rank-forcing run), on that file's own UR10 and goals and at its budgets.
The rest of the port's sparse CIDGIK tests, and the helpers these share,
are in tests/test_torch_cidgik_sparse.py; these two live apart so that a
run that spreads test files over workers spreads them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu_torch import interop
from graphik_tpu_torch.solvers import cidgik as tcd
from graphik_tpu_torch.solvers import cidgik_sparse as tcs
from tests.test_kinematics import ur10_template
from tests.test_torch_cidgik_sparse import jax_goals, pose_errors

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mirror():
    """(JAX structure, port structure, port compiled problem) of the JAX
    tests' UR10."""
    jps = JPS.from_template(ur10_template())
    tps = interop.structure_from_numpy(dataclasses.asdict(jps))
    return jps, tps, tcs.compile_cidgik_sparse(tps)


def test_ur10_sparse_cidgik_solves(mirror):
    jps, ur10, comp = mirror
    T = jax_goals(jps, 0, 3)
    out = tcs.solve_cidgik_sparse(comp, torch.from_numpy(T),
                                  params=tcd.CidgikParams(admm_iters=800, max_outer=8))
    e_pos, e_rot = pose_errors(ur10, out, T)
    hits = (e_pos < 1e-2) & (e_rot < 1e-2)
    assert hits.sum() >= 2, (e_pos, e_rot, out["eig_sum"], out["feas"])


def test_rank_forcing_converges(mirror):
    """The excess-rank eigenvalue sum reaches ~0 on goals whose SDP solve is
    feasible: the convex iteration's convergence signal. Guards the padded
    slots, which without the pad mask park eig_sum at relax - 1 = 0.6."""
    jps, ur10, comp = mirror
    T = jax_goals(jps, 0, 4)
    out = tcs.solve_cidgik_sparse(
        comp, torch.from_numpy(T),
        params=tcd.CidgikParams(admm_iters=2000, max_outer=30, rel_tol=1e-5))
    eig = out["eig_sum"].numpy()
    feasible = out["status"].numpy() == tcs.FEASIBLE
    assert np.all(np.isfinite(eig)), eig
    assert feasible.sum() >= 3, (out["feas"], out["status"])
    assert np.all(eig[feasible] < 1e-6), (eig, feasible)
