"""The CUDA kernels against their plain torch versions, on the card: the
TR kernel (anchor-free and anchored) and the edge cost+grad / Hessian
kernels.

Every test here needs an NVIDIA GPU (and nvcc for the first build) and
skips itself elsewhere. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from graphik_tpu_torch import api
from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.ops import edge as edge_ops
from graphik_tpu_torch.ops import tr_solve
from graphik_tpu_torch.robots.library import load_ur10
from graphik_tpu_torch.solvers.local import LocalParams
from graphik_tpu_torch.solvers.riemannian import TRParams
from graphik_tpu_torch.utils.environments import table_environment

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


def _synthetic(N, d, n_edges, seed, device, B=300):
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


@pytest.mark.parametrize("B", [1, 33, 1001])
@pytest.mark.parametrize("N,d,n_edges", [(16, 3, 64), (12, 3, 40), (10, 2, 20)])
def test_two_per_warp_bitwise(cuda, N, d, n_edges, B):
    """Shapes with N <= 16 and E <= 64 share a warp between two instances;
    B = 1 and 33 leave a half warp idle, 1001 does not fill the last
    block. One step and 100 steps are bitwise equal to the plain version."""
    ep, Y0, dg = _synthetic(N, d, n_edges, seed=N + n_edges + B, device=cuda, B=B)
    assert tr_solve.kernel_shape(ep, B, d)["two_per_warp"]
    _bitwise(ep, Y0, dg, maxiter=1)
    _bitwise(ep, Y0, dg, maxiter=100, maxinner=d * N, plateau_every=16, plateau_rtol=1e-4)


def test_launch_shape(ur10_inputs):
    """UR10 runs two instances per warp, one per half warp, a 24-node
    problem one per warp."""
    ep, Y0, _ = ur10_inputs
    shape = tr_solve.kernel_shape(ep, 8192, 3)
    assert shape["two_per_warp"] and shape["instances_per_block"] == 8
    assert shape["blocks"] == 1024 and shape["blocks_resident"] >= 132
    big = _synthetic(24, 2, 70, seed=1, device=ur10_inputs[1].device)[0]
    shape = tr_solve.kernel_shape(big, 10, 2)
    assert not shape["two_per_warp"] and shape["blocks"] == 3


def test_repeat_calls_bitwise(ur10_inputs):
    """Two calls in a row give the same outputs, bitwise."""
    ep, Y0, dg = ur10_inputs
    a = tr_solve.solve_tr_cuda(ep, Y0, dg, maxiter=30, **PROD)
    b = tr_solve.solve_tr_cuda(ep, Y0, dg, maxiter=30, **PROD)
    for key in a:
        assert torch.equal(a[key], b[key]), key


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


@pytest.fixture(scope="module")
def table_inputs(cuda):
    """The table scene's reduced problem (16 nodes, 624 anchor rows) on
    1000 goals prepared on the card, and world-frame starts near random
    configurations, where the hinges meet the robot."""
    tpl, _ = load_ur10()
    ps = ProblemStructure.from_template(tpl, obstacles=table_environment())
    spec = ps.reduced_spec()
    Nr = spec["Nr"]
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega[:Nr, :Nr], psi_L[:Nr, :Nr], psi_U[:Nr, :Nr],
                                     dim=3, anchors=spec)
    gen = torch.Generator().manual_seed(4)
    T_goal, _ = api.random_goals(ps, (1000,), gen, dtype=torch.float32, device=cuda)
    D_goal, Y0 = api.make_solver(ps, smooth_iters=2).prepare(T_goal)
    _, q = api.random_goals(ps, (1000,), gen, dtype=torch.float32, device=cuda)
    Yw = ps.realization(q)[:, :Nr].contiguous()
    return ep, Y0.contiguous(), Yw, ep.edge_values(D_goal).contiguous()


def _bitwise(ep, Y0, dg, **kw):
    k = tr_solve.solve_tr_cuda(ep, Y0, dg, **kw)
    p = tr_solve.solve_tr_reference(ep, Y0, dg, **kw)
    for key in p:
        assert torch.equal(k[key], p[key]), key


@pytest.mark.parametrize("res_tol", [0.0, 0.05])
def test_anchored_one_step_bitwise(table_inputs, res_tol):
    ep, Y0, Yw, dg = table_inputs
    before = tr_solve.solve_tr_cuda.anchored_launches
    _bitwise(ep, Y0, dg, maxiter=1, maxinner=32, res_tol=res_tol)
    _bitwise(ep, Yw, dg, maxiter=1, maxinner=32, res_tol=res_tol)
    assert tr_solve.solve_tr_cuda.anchored_launches == before + 2


def test_anchored_production_params_bitwise(table_inputs):
    ep, Y0, _, dg = table_inputs
    _bitwise(ep, Y0, dg, maxiter=30, maxinner=32, plateau_every=16, plateau_rtol=1e-4)


def test_anchored_world_frame_bitwise(table_inputs):
    """100 steps from world-frame starts, where hinges turn on and off as
    the nodes move: the kernel's skipping of inactive anchor rows must
    leave every output bitwise equal."""
    ep, _, Yw, dg = table_inputs
    _bitwise(ep, Yw, dg, maxiter=100, maxinner=32, plateau_every=16, plateau_rtol=1e-4)


def test_table_main_path_runs_the_anchored_kernel(cuda):
    tpl, _ = load_ur10()
    ps = ProblemStructure.from_template(tpl, obstacles=table_environment())
    T_goal, _ = api.random_goals(ps, (256,), torch.Generator().manual_seed(5),
                                 dtype=torch.float32, device=cuda)
    solver = api.make_solver(ps, TRParams.production(maxiter=250, maxinner=32),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8),
                             smooth_iters=2)
    before = tr_solve.solve_tr_cuda.anchored_launches
    out = solver(T_goal)
    assert tr_solve.solve_tr_cuda.anchored_launches == before + 1
    assert out["Y"].shape == (256, ps.N, 3)
    assert api.summarize(out)["success_rate"] >= 0.7


def test_edge_kernels_match_plain(ur10_inputs):
    """K1 / K2 against ops/edge.py's cost_and_egrad / ehess (torch's own
    summation order, so a tolerance and not bitwise)."""
    ep, Y0, dg = ur10_inputs
    Z = torch.randn(Y0.shape, generator=torch.Generator(device=Y0.device).manual_seed(6),
                    device=Y0.device)
    f, g = edge_ops.cost_and_egrad_cuda(ep, Y0, dg)
    H = edge_ops.ehess_cuda(ep, Y0, Z, dg)
    dgp = torch.nn.functional.pad(dg, (0, ep.Ep - dg.shape[1]))
    fp, gp = edge_ops.cost_and_egrad(ep, Y0, dgp)
    Hp = edge_ops.ehess(ep, Y0, Z, dgp)
    torch.testing.assert_close(f, fp, rtol=1e-5, atol=0)
    assert float((g - gp).abs().max()) <= 1e-4 * float(gp.abs().max())
    assert float((H - Hp).abs().max()) <= 1e-4 * float(Hp.abs().max())
