"""The CUDA TR kernel against its plain torch version, on the card.

Every test here needs an NVIDIA GPU (and nvcc for the first build) and
skips itself elsewhere. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from graphik_tpu_torch import api
from graphik_tpu_torch.ops import edge as edge_ops
from graphik_tpu_torch.ops import tr_solve
from graphik_tpu_torch.robots.library import load_ur10
from graphik_tpu_torch.solvers.local import LocalParams
from graphik_tpu_torch.solvers.riemannian import TRParams

PROD = dict(maxinner=24, plateau_every=16, plateau_rtol=1e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ur10_inputs(cuda):
    """1000 UR10 goals (a ragged last block) prepared on the card."""
    _, ps = load_ur10()
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=3)
    T_goal, _ = api.random_goals(ps, (1000,), torch.Generator().manual_seed(1),
                                 dtype=torch.float32, device=cuda)
    D_goal, Y0 = api.make_solver(ps, smooth_iters=2).prepare(T_goal)
    return ep, Y0.contiguous(), ep.edge_values(D_goal).contiguous()


def _synthetic(N, d, n_edges, seed, device):
    """A random EDM-completion problem: exact edges, lower and upper hinges."""
    rs = np.random.RandomState(seed)
    P = rs.normal(size=(N, d))
    D = ((P[:, None] - P[None]) ** 2).sum(-1)
    iu = np.triu_indices(N, 1)
    pick = rs.choice(len(iu[0]), n_edges, replace=False)
    kind = rs.randint(0, 3, size=n_edges)
    omega, psi_L, psi_U = (np.zeros((N, N)) for _ in range(3))
    for (i, j), k in zip(zip(iu[0][pick], iu[1][pick]), kind):
        M, v = [(omega, 1.0), (psi_L, 0.8 * D[i, j]), (psi_U, 1.2 * D[i, j])][k]
        M[i, j] = M[j, i] = v
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=d)
    B = 300
    Y0 = torch.tensor(P[None] + 0.3 * rs.normal(size=(B, N, d)), dtype=torch.float32,
                      device=device)
    Dg = torch.tensor(np.broadcast_to(D, (B, N, N)).copy(), dtype=torch.float32,
                      device=device)
    return ep, Y0, ep.edge_values(Dg).contiguous()


def _one_step_matches(ep, Y0, dg):
    k = tr_solve.solve_tr_cuda(ep, Y0, dg, maxiter=1)
    p = tr_solve.solve_tr_reference(ep, Y0, dg, maxiter=1)
    torch.testing.assert_close(k["cost"], p["cost"], rtol=2e-5, atol=1e-6)
    assert torch.equal(k["num_inner"], p["num_inner"])
    torch.testing.assert_close(k["Y"], p["Y"], rtol=0, atol=1e-4)


def test_one_step_matches_plain(ur10_inputs):
    before = tr_solve.solve_tr_cuda.launches
    _one_step_matches(*ur10_inputs)
    assert tr_solve.solve_tr_cuda.launches == before + 1


def test_production_params_match_plain(ur10_inputs):
    ep, Y0, dg = ur10_inputs
    k = tr_solve.solve_tr_cuda(ep, Y0, dg, maxiter=100, **PROD)
    p = tr_solve.solve_tr_reference(ep, Y0, dg, maxiter=100, **PROD)
    for out in (k, p):
        assert all(bool(torch.isfinite(out[x]).all()) for x in ("Y", "cost", "gradnorm"))
    mk, mp = float(k["cost"].median()), float(p["cost"].median())
    assert mk < 10 * mp and mp < 10 * mk
    ik, ip = float(k["iterations"].double().mean()), float(p["iterations"].double().mean())
    assert abs(ik - ip) <= 0.05 * ip


@pytest.mark.parametrize("N,d,n_edges", [(10, 2, 20), (24, 2, 70), (32, 3, 100), (32, 3, 128)])
def test_other_shapes_match_plain(cuda, N, d, n_edges):
    """The planar (d = 2) build and 1, 3 and 4 edges per lane."""
    _one_step_matches(*_synthetic(N, d, n_edges, seed=N + n_edges, device=cuda))


def test_main_path_runs_the_kernel(cuda):
    _, ps = load_ur10()
    T_goal, _ = api.random_goals(ps, (512,), torch.Generator().manual_seed(2),
                                 dtype=torch.float32, device=cuda)
    solver = api.make_solver(ps, TRParams.production(maxiter=100, maxinner=24),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8),
                             smooth_iters=2)
    before = tr_solve.solve_tr_cuda.launches
    out = solver(T_goal)
    assert tr_solve.solve_tr_cuda.launches == before + 1
    assert api.summarize(out)["success_rate"] >= 0.8


def test_wrapper_refuses_float64_on_card(ur10_inputs):
    ep, Y0, dg = ur10_inputs
    with pytest.raises(TypeError, match="float32"):
        tr_solve.solve_tr(ep, Y0.double(), dg.double(), maxiter=1)
