"""The CUDA kernels against their plain torch versions, on the card: the
TR kernel (anchor-free and anchored) and the edge cost+grad / Hessian
kernels (bitwise against their kernel-order plain versions, at every robot
shape and segment width, and within a tolerance of torch's own order).

Every test here needs an NVIDIA GPU (and nvcc for the first build) and
skips itself elsewhere. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""

import dataclasses
import re

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


def _bench_structure(robot):
    from graphik_tpu_torch.robots.library import load_kuka, load_planar_chain, load_tree5

    if robot == "kuka_iiwa":
        return load_kuka()[1]
    if robot == "tree":
        return load_tree5()[1]
    return load_planar_chain(int(robot[6:]), limits=np.pi / 2)[1]


@pytest.mark.parametrize("B", [1, 33, 1001])
@pytest.mark.parametrize("robot,shape", [("planar6", (9, 2, 21)), ("planar10", (13, 2, 29)),
                                         ("kuka_iiwa", (18, 3, 76)), ("tree", (14, 3, 62))])
def test_bench_robot_shapes_bitwise(cuda, robot, shape, B):
    """The compiled (N, d, E) of the bench's planar chains, KUKA iiwa
    (LWA4D has KUKA's) and the two-end-effector tree, on goals prepared on
    the card: the planar chains and the tree (2 idle node lanes, 2 padded
    edge slots) share a warp between two instances, the 18-node arm takes a
    warp with 3 edges per lane. One step and 100 steps bitwise equal to the
    plain version."""
    ps = _bench_structure(robot)
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
    assert (ep.N, ps.dim, ep.E) == shape
    assert tr_solve.kernel_shape(ep, B, ps.dim)["two_per_warp"] == (ep.N <= 16)
    T_goal, _ = api.random_goals(ps, (B,), torch.Generator().manual_seed(B + ep.E),
                                 dtype=torch.float32, device=cuda)
    D_goal, Y0 = api.make_solver(ps, smooth_iters=2).prepare(T_goal)
    Y0, dg = Y0.contiguous(), ep.edge_values(D_goal).contiguous()
    _bitwise(ep, Y0, dg, maxiter=1, maxinner=24)
    _bitwise(ep, Y0, dg, maxiter=100, **PROD)


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


# Every segment width and edges-per-lane count the robots use, and the
# extremes the build covers: the bench's robots (W = 16: UR10, planar6,
# planar10, the tree; W = 32: KUKA iiwa, whose shape LWA4D shares), then
# synthetic (N, d, E) for EPL 1, 3, 6 and 8 at W = 16 and 1-4 at W = 32.
EDGE_CASES = ["ur10", "planar6", "planar10", "kuka_iiwa", "tree", (10, 2, 12), (12, 3, 40),
              (14, 2, 90), (16, 3, 120), (20, 3, 30), (24, 2, 50), (24, 2, 70), (32, 3, 128)]


def _edge_case(case, B, device):
    """An EdgeProblem, Y and dg (B, Ep) for the edge kernels: a robot's
    compiled problem on goals prepared on the card, or a synthetic one."""
    if isinstance(case, tuple):
        return _synthetic(*case, seed=sum(case) + B, device=device, B=B)
    ps = load_ur10()[1] if case == "ur10" else _bench_structure(case)
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
    T_goal, _ = api.random_goals(ps, (B,), torch.Generator().manual_seed(B + ep.E),
                                 dtype=torch.float32, device=device)
    D_goal, Y0 = api.make_solver(ps, smooth_iters=2).prepare(T_goal)
    return ep, Y0.contiguous(), ep.edge_values(D_goal).contiguous()


@pytest.mark.parametrize("B", [1, 33, 8191])
@pytest.mark.parametrize("case", EDGE_CASES, ids=str)
def test_edge_kernels_bitwise(cuda, case, B):
    """K1 / K2 bitwise equal to their kernel-order plain versions. B = 1 and
    33 leave segments of a tile idle; 8191 ends in a tile that is not full
    (plain loads), after full tiles (bulk copies). Goal distances with the
    padded stride Ep and, where it differs, with stride E."""
    ep, Y, dg = _edge_case(case, B, cuda)
    Z = torch.randn(Y.shape, generator=torch.Generator(device=cuda).manual_seed(B), device=cuda)
    before = (edge_ops.cost_and_egrad_cuda.launches, edge_ops.ehess_cuda.launches)
    for dg_ in {ep.Ep: dg, ep.E: dg[:, :ep.E].contiguous()}.values():
        f, g = edge_ops.cost_and_egrad_cuda(ep, Y, dg_)
        H = edge_ops.ehess_cuda(ep, Y, Z, dg_)
        fp, gp = edge_ops.cost_and_egrad_kernel_order(ep, Y, dg_)
        Hp = edge_ops.ehess_kernel_order(ep, Y, Z, dg_)
        assert torch.equal(f, fp) and torch.equal(g, gp) and torch.equal(H, Hp)
        assert bool(torch.isfinite(f).all() and torch.isfinite(g).all() and torch.isfinite(H).all())
    n = 1 if ep.E == ep.Ep else 2
    assert (edge_ops.cost_and_egrad_cuda.launches, edge_ops.ehess_cuda.launches) == (
        before[0] + n, before[1] + n)


@pytest.mark.parametrize("case", EDGE_CASES[:5])
def test_edge_kernel_shape_matches_plan(cuda, case):
    """The C side's launch shape is edge_launch_plan's, with a grid of at
    most the resident blocks; two instances a warp for N <= 16."""
    ep = _edge_case(case, 1, cuda)[0]
    for hess, B in ((False, 8192), (True, 8192), (False, 131072), (True, 1)):
        shape = edge_ops.edge_kernel_shape(ep, B, ep.Ep, hess)
        plan = edge_ops.edge_launch_plan(ep.N, ep.dim, ep.E, ep.Ep, B, hess)
        assert {k: shape[k] for k in plan} == plan
        assert shape["blocks"] == min(plan["tiles"], shape["blocks_resident"])
        assert shape["blocks_resident"] >= 132
        assert shape["two_per_warp"] == (ep.N <= 16)


def test_edge_tables_cached_on_card(ur10_inputs):
    """The wrappers' device tables are built once: the same tensors (data
    pointers) on every call, equal to a fresh build."""
    ep, Y0, dg = ur10_inputs
    edge_ops.cost_and_egrad_cuda(ep, Y0, dg)
    first = edge_ops.cached_edge_tables(ep, Y0.device)
    edge_ops.ehess_cuda(ep, Y0, Y0, dg)
    edge_ops.cost_and_egrad_cuda(ep, Y0, dg)
    again = edge_ops.cached_edge_tables(ep, Y0.device)
    assert [t.data_ptr() for t in first] == [t.data_ptr() for t in again]
    for a, b in zip(first, edge_ops.edge_kernel_tables(ep, Y0.device)):
        assert torch.equal(a, b)


def test_edge_kernels_not_on_the_ur10_path(cuda):
    """No path calls K1 or K2: the UR10 solver leaves their counters."""
    _, ps = load_ur10()
    T_goal, _ = api.random_goals(ps, (256,), torch.Generator().manual_seed(10),
                                 dtype=torch.float32, device=cuda)
    solver = api.make_solver(ps, TRParams.production(maxiter=100, maxinner=24),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8),
                             smooth_iters=2)
    before = (edge_ops.cost_and_egrad_cuda.launches, edge_ops.ehess_cuda.launches,
              tr_solve.solve_tr_cuda.launches)
    solver(T_goal)
    assert (edge_ops.cost_and_egrad_cuda.launches, edge_ops.ehess_cuda.launches,
            tr_solve.solve_tr_cuda.launches) == (before[0], before[1], before[2] + 1)


def test_edge_kernels_refuse_misaligned_views(ur10_inputs):
    """The bulk copies need 16-byte aligned rows: a view 4 bytes into its
    storage raises."""
    ep, Y0, dg = ur10_inputs
    buf = torch.empty(Y0.numel() + 1, device=Y0.device)
    Yv = buf[1:].view(Y0.shape)
    Yv.copy_(Y0)
    with pytest.raises(ValueError, match="aligned"):
        edge_ops.cost_and_egrad_cuda(ep, Yv, dg)
    with pytest.raises(ValueError, match="aligned"):
        edge_ops.ehess_cuda(ep, Y0, Yv, dg)


@pytest.mark.parametrize("table", [False, True])
def test_cidgik_card_matches_cpu(cuda, table):
    """Dense CIDGIK on 16 goals at a reduced budget (production, ADMM
    (200, 2 x 100)), float32, on the card and on the CPU from the same numpy
    goals: status equal on every lane, |d eig_sum| <= 5e-4 and |d feas| <=
    1e-4 on every lane (chip_smoke.py's EIG_TOL, FEAS_TOL), points within
    1e-3 on at least 15 of 16 lanes."""
    from graphik_tpu_torch.solvers import cidgik

    tpl, ps = load_ur10()
    if table:
        ps = ProblemStructure.from_template(tpl, obstacles=table_environment())
    comp = cidgik.compile_cidgik(ps)
    params = cidgik.CidgikParams.production(admm_iters=200, admm_iters_rest=100, max_outer=3)
    T = api.random_goals(ps, (16,), torch.Generator().manual_seed(7), dtype=torch.float32,
                         device="cpu")[0].numpy()
    o_g = cidgik.solve_cidgik(comp, T, params=params)  # no device: the card
    o_c = cidgik.solve_cidgik(comp, T, params=params, device="cpu")
    assert o_g["q"].device.type == "cuda" and o_c["q"].device.type == "cpu"
    assert torch.equal(o_g["status"].cpu(), o_c["status"])
    assert float((o_g["eig_sum"].cpu() - o_c["eig_sum"]).abs().max()) <= 5e-4
    assert float((o_g["feas"].cpu() - o_c["feas"]).abs().max()) <= 1e-4
    d_pts = (o_g["points"].cpu() - o_c["points"]).abs().flatten(1).amax(1)
    assert int((d_pts <= 1e-3).sum()) >= 15, d_pts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eigh_on_padded_clique_stacks(cuda, dtype):
    """torch.linalg.eigh on the card (cuSOLVER's batched small-matrix path)
    on 1024 lanes of UR10's sparse CIDGIK clique blocks (K = 3, ds = 9, the
    middle block with an exact-zero padded row and column): finite, and
    eigenvalues within 1e-5 x each block's Frobenius norm of the CPU's
    float64."""
    from graphik_tpu_torch.solvers import cidgik_sparse

    tpl, ps = load_ur10()
    comp = cidgik_sparse.compile_cidgik_sparse(ps)
    gen = torch.Generator().manual_seed(8)
    q = api.random_goals(ps, (1024,), gen, dtype=torch.float64, device="cpu")[1]
    Z = cidgik_sparse.lifted_blocks(comp, ps.realization(q)[:, comp.free_idx])
    E = 0.05 * torch.randn(Z.shape, generator=gen, dtype=torch.float64)
    valid = torch.as_tensor(cidgik_sparse._valid_slots(comp.member, comp.d))
    Z = (Z + E + E.transpose(-1, -2)) * (valid[:, :, None] * valid[:, None, :])
    assert float(Z[:, 1, -1].abs().max()) == 0.0  # the middle clique's padded row
    lam, Q = torch.linalg.eigh(Z.to(cuda, dtype))
    assert bool(torch.isfinite(lam).all() and torch.isfinite(Q).all())
    ref = torch.linalg.eigvalsh(Z)
    scale = torch.linalg.matrix_norm(Z)[..., None]
    assert float(((lam.cpu().double() - ref).abs() / scale).max()) <= 1e-5


def test_cidgik_sparse_card_matches_cpu(cuda):
    """Sparse CIDGIK on 16 goals at a reduced budget (production, ADMM
    (200, 2 x 100)), float32, on the card and on the CPU from the same numpy
    goals: status equal on every lane, on each lane |d eig_sum| <= 0.07
    max(|eig_sum|, 1e-3) and at most 2.5e-3, and |d feas| <= 1e-4
    (chip_smoke.py's SPARSE_EIG_RTOL, SPARSE_EIG_TOL, FEAS_TOL, with their
    derivation), points within 1e-3 on at least 15 of 16 lanes."""
    from graphik_tpu_torch.solvers import cidgik, cidgik_sparse

    ps = load_ur10()[1]
    comp = cidgik_sparse.compile_cidgik_sparse(ps)
    params = cidgik.CidgikParams.production(admm_iters=200, admm_iters_rest=100, max_outer=3)
    T = api.random_goals(ps, (16,), torch.Generator().manual_seed(9), dtype=torch.float32,
                         device="cpu")[0].numpy()
    o_g = cidgik_sparse.solve_cidgik_sparse(comp, T, params=params)  # no device: the card
    o_c = cidgik_sparse.solve_cidgik_sparse(comp, T, params=params, device="cpu")
    assert o_g["q"].device.type == "cuda" and o_c["q"].device.type == "cpu"
    assert torch.equal(o_g["status"].cpu(), o_c["status"])
    d_eig = (o_g["eig_sum"].cpu() - o_c["eig_sum"]).abs()
    bound = (0.07 * o_c["eig_sum"].abs().clamp(min=1e-3)).clamp(max=2.5e-3)
    assert bool((d_eig <= bound).all()), (d_eig, o_c["eig_sum"])
    assert float((o_g["feas"].cpu() - o_c["feas"]).abs().max()) <= 1e-4
    d_pts = (o_g["points"].cpu() - o_c["points"]).abs().flatten(1).amax(1)
    assert int((d_pts <= 1e-3).sum()) >= 15, d_pts


def test_cg_card_matches_cpu(cuda):
    """CG on 64 UR10 goals on the card and on the CPU. First solve_cg from
    the same prepared Y0: at float64, 20 iterations with per-lane plateau
    and stepsize stops, iterations equal per lane and Y and cost (over
    max(1, max cost)) within 1e-7; at float32, 5 iterations of the
    production params, within 1e-4 (chip_smoke.py's CG_TOL64 / CG_TOL32,
    with their derivation). Then make_solver with CGParams.production(),
    float32, the UR10 path's polish and smoothing: no TR kernel launch, and
    success counts within 9 goals (float32 CG trajectories part, so the two
    runs are two samples: 9 is the 95% limit 1.96 sqrt(2 n p (1 - p)) at
    n = 64, p = 0.79)."""
    from graphik_tpu_torch.solvers import riemannian
    from graphik_tpu_torch.solvers.riemannian import CGParams

    _, ps = load_ur10()
    solver = api.make_solver(ps, params=CGParams.production(),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    T = api.random_goals(ps, (64,), torch.Generator().manual_seed(10), dtype=torch.float32,
                         device="cpu")[0]
    D, Y0 = solver.prepare(T)
    for dt, kw, tol in ((torch.float64, dict(maxiter=20, plateau_every=4, plateau_rtol=0.08,
                                             minstepsize=1e-3), 1e-7),
                        (torch.float32, dict(maxiter=5), 1e-4)):
        o_g, o_c = (riemannian.solve_cg(Y0.to(d_, dt), D.to(d_, dt), solver.omega, solver.psi_L,
                                        solver.psi_U, params=CGParams.production(**kw))
                    for d_ in (cuda, torch.device("cpu")))
        assert torch.equal(o_g["iterations"].cpu(), o_c["iterations"]), dt
        assert float((o_g["Y"].cpu() - o_c["Y"]).abs().max()) <= tol, dt
        scale = max(1.0, float(o_c["cost"].abs().max()))
        assert float((o_g["cost"].cpu() - o_c["cost"]).abs().max()) <= tol * scale, dt
    before = tr_solve.solve_tr_cuda.launches
    o_g = solver(T.to(cuda))
    assert tr_solve.solve_tr_cuda.launches == before
    o_c = solver(T)
    assert o_g["Y"].device.type == "cuda" and o_c["Y"].device.type == "cpu"
    s_g, s_c = (api.summarize(o)["success_rate"] * 64 for o in (o_g, o_c))
    assert abs(s_g - s_c) <= 9, (s_g, s_c)


@pytest.fixture(scope="module")
def ring6_inputs(cuda):
    """planar10_ring6's reduced problem (13 nodes, 10 groups of 6 circle
    rows padded to 8) on 1000 goals prepared on the card, and world-frame
    starts near random configurations, where the hinges meet the chain."""
    from graphik_tpu_torch.robots.library import load_planar_chain
    from graphik_tpu_torch.utils.environments import ring_environment

    tpl = load_planar_chain(10, limits=np.pi / 2)[0]
    ps = ProblemStructure.from_template(tpl, obstacles=ring_environment())
    spec = ps.reduced_spec()
    Nr = spec["Nr"]
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega[:Nr, :Nr], psi_L[:Nr, :Nr], psi_U[:Nr, :Nr],
                                     dim=2, anchors=spec)
    gen = torch.Generator().manual_seed(7)
    T_goal, _ = api.random_goals(ps, (1000,), gen, dtype=torch.float32, device=cuda)
    D_goal, Y0 = api.make_solver(ps, smooth_iters=2).prepare(T_goal)
    _, q = api.random_goals(ps, (1000,), gen, dtype=torch.float32, device=cuda)
    Yw = ps.realization(q)[:, :Nr].contiguous()
    return ps, ep, Y0.contiguous(), Yw, ep.edge_values(D_goal).contiguous()


def test_planar_anchored_shape(ring6_inputs):
    """The <2, 2, 16, true> instance: two instances a warp."""
    _, ep, _, _, _ = ring6_inputs
    assert (ep.N, ep.dim, ep.E, ep.A, ep.a_nsel, ep.a_R) == (13, 2, 29, 80, 10, 8)
    shape = tr_solve.kernel_shape(ep, 8192, 2)
    assert shape["two_per_warp"] and shape["instances_per_block"] == 8


@pytest.mark.parametrize("res_tol", [0.0, 0.05])
def test_planar_anchored_bitwise(ring6_inputs, res_tol):
    """One step and 100 steps from the prepared starts and from world-frame
    starts, bitwise equal to the plain version."""
    _, ep, Y0, Yw, dg = ring6_inputs
    before = tr_solve.solve_tr_cuda.anchored_launches
    for Ys in (Y0, Yw):
        _bitwise(ep, Ys, dg, maxiter=1, maxinner=32, res_tol=res_tol)
        _bitwise(ep, Ys, dg, maxiter=100, maxinner=32, plateau_every=16, plateau_rtol=1e-4,
                 res_tol=res_tol)
    assert tr_solve.solve_tr_cuda.anchored_launches == before + 4


def test_planar_ring_main_path_runs_the_anchored_kernel(ring6_inputs, cuda):
    ps = ring6_inputs[0]
    T_goal, _ = api.random_goals(ps, (256,), torch.Generator().manual_seed(8),
                                 dtype=torch.float32, device=cuda)
    solver = api.make_solver(ps, TRParams.production(maxiter=250, maxinner=32),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8),
                             smooth_iters=2)
    before = tr_solve.solve_tr_cuda.anchored_launches
    out = solver(T_goal)
    assert tr_solve.solve_tr_cuda.anchored_launches == before + 1
    assert out["Y"].shape == (256, ps.N, 2)
    assert api.summarize(out)["success_rate"] >= 0.75


def test_sharded_solve_on_card(cuda):
    """solve_ik_sharded over two shards on the card: one TR launch a
    shard, and every lane as the unsharded solver's (JAX's tolerance of
    tests/test_parallel.py)."""
    from graphik_tpu_torch.parallel import mesh

    _, ps = load_ur10()
    T_goal, _ = api.random_goals(ps, (1001,), torch.Generator().manual_seed(9),
                                 dtype=torch.float32, device=cuda)
    kw = dict(params=TRParams.production(maxiter=100, maxinner=24),
              polish_params=LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    before = tr_solve.solve_tr_cuda.launches
    out_s = mesh.solve_ik_sharded(ps, T_goal, [cuda, cuda], **kw)
    assert tr_solve.solve_tr_cuda.launches == before + 2
    out_l = api.solve_ik(ps, T_goal, **kw)
    assert out_s["q"].shape == (1001, 6) and out_s["q"].device.type == "cuda"
    torch.testing.assert_close(out_s["q"], out_l["q"], rtol=1e-3, atol=1e-4)
    assert torch.equal(out_s["success"], out_l["success"])


def _hand_launches():
    return (tr_solve.solve_tr_cuda.launches + edge_ops.cost_and_egrad_cuda.launches
            + edge_ops.ehess_cuda.launches)


def test_dense_f64_card_matches_cpu(cuda):
    """The TR's "dense" backend at float64 (where "kernel" sends float64) on
    16 UR10 goals: from the same Y0, one iteration on the card and on the
    CPU gives equal inner steps per lane and Y within 1e-12 (chip_smoke.py
    phase 17's bound, with its derivation); the whole make_solver at
    float64 on the card launches no hand-written kernel and returns
    float64."""
    from graphik_tpu_torch.solvers import riemannian

    _, ps = load_ur10()
    solver = api.make_solver(ps, TRParams.production(maxiter=100, maxinner=24),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    T = api.random_goals(ps, (16,), torch.Generator().manual_seed(12), dtype=torch.float64,
                         device="cpu")[0]
    D, Y0 = solver.prepare(T)
    one = TRParams.production(maxiter=1, maxinner=24)
    o_g, o_c = (riemannian.solve(Y0.to(d_), D.to(d_), solver.omega, solver.psi_L, solver.psi_U,
                                 params=one) for d_ in (cuda, torch.device("cpu")))
    assert torch.equal(o_g["num_inner"].cpu(), o_c["num_inner"])
    assert float((o_g["Y"].cpu() - o_c["Y"]).abs().max()) <= 1e-12
    before = _hand_launches()
    out = solver(T.to(cuda))
    assert _hand_launches() == before
    assert out["q"].dtype == torch.float64 and out["Y"].device.type == "cuda"
    assert bool(torch.isfinite(out["q"]).all())


def test_edge_f32_card_matches_cpu(cuda):
    """The TR's "edge" backend at float32 on 16 planar10 goals: one step on
    the card and on the CPU from the same Y0 gives equal inner steps and Y
    within 1e-4 (the one-step bound of the TR kernel's tests), and no
    hand-written kernel is launched."""
    from graphik_tpu_torch.robots.library import load_planar_chain
    from graphik_tpu_torch.solvers import riemannian

    _, ps = load_planar_chain(10, limits=np.pi / 2)
    solver = api.make_solver(ps, TRParams.production(maxiter=100, maxinner=24, backend="edge"),
                             smooth_iters=2)
    T = api.random_goals(ps, (16,), torch.Generator().manual_seed(13), dtype=torch.float32,
                         device="cpu")[0]
    D, Y0 = solver.prepare(T)
    one = TRParams(maxiter=1, maxinner=24, backend="edge")
    before = _hand_launches()
    o_g, o_c = (riemannian.solve(Y0.to(d_), D.to(d_), solver.omega, solver.psi_L, solver.psi_U,
                                 params=one) for d_ in (cuda, torch.device("cpu")))
    assert _hand_launches() == before
    assert torch.equal(o_g["num_inner"].cpu(), o_c["num_inner"])
    assert float((o_g["Y"].cpu() - o_c["Y"]).abs().max()) <= 1e-4


def _compiled_and_eager(name):
    """(structure, the compiled solver, the same solver with every stage
    eager, restarts or 0) of a main path: UR10, the table, planar10, the
    tree with 3 restarts."""
    from graphik_tpu_torch.parallel import mesh
    from graphik_tpu_torch.robots.library import load_planar_chain, load_tree5

    polish = LocalParams(maxiter=10, tol_grad=1e-8)
    prod = TRParams.production(maxiter=100, maxinner=24)
    if name == "tree":
        ps = load_tree5()[1]
        params = TRParams.production(maxiter=300)
        return (ps, mesh.make_restart_solver(ps, n_restarts=3, params=params),
                mesh.RestartSolver(ps, params, n_restarts=3), 3)
    if name == "table":
        ps = ProblemStructure.from_template(load_ur10()[0], obstacles=table_environment())
        prod = TRParams.production(maxiter=250, maxinner=32)
    else:
        ps = load_ur10()[1] if name == "ur10" else load_planar_chain(10, limits=np.pi / 2)[1]
    kw = dict(params=prod, polish_params=polish, smooth_iters=2)
    return ps, api.make_solver(ps, **kw), api.Solver(ps, **kw), 0


@pytest.mark.parametrize("name", ["ur10", "table", "planar10", "tree"])
def test_compiled_equals_eager_bitwise(cuda, name):
    """The compiled solver's solve and finish (CUDA graphs) against the
    eager stages on the same prepared inputs, bitwise, over two calls at
    each of two batch shapes: the first call of a shape (warm-up and
    capture) and a replay. Every call launches the TR kernel once, and a
    kept result does not change on later calls."""
    ps, comp, eager, R = _compiled_and_eager(name)
    gen = torch.Generator().manual_seed(20)
    rgen = torch.Generator(device=cuda).manual_seed(21)
    kept = []
    for B in (256, 256, 128, 128):
        T_goal = api.random_goals(ps, (B // max(R, 1),), gen, dtype=torch.float32,
                                  device=cuda)[0]
        D, Y0 = eager.prepare(T_goal, *((rgen,) if R else ()))
        before = tr_solve.solve_tr_cuda.launches
        sol = comp.solve(Y0, D)
        out = comp.finish(sol, T_goal)
        assert tr_solve.solve_tr_cuda.launches == before + 1
        sol_e = eager.solve(Y0, D)
        out_e = eager.finish(sol_e, T_goal)
        for a, b in ((sol, sol_e), (out, out_e)):
            assert set(a) == set(b)
            for key in a:
                assert torch.equal(a[key], b[key]), (B, key)
        kept.append((out, {k: v.clone() for k, v in out.items()}))
    for out, copy in kept:  # outputs are not aliased across calls
        for key in out:
            assert torch.equal(out[key], copy[key]), key
    assert len(comp.graphs.graphs) == 4  # solve and finish at each shape


def test_compiled_replays_count_launches(cuda):
    """The launch counters count replays: three calls of the compiled UR10
    solver at one shape (the first warms up and captures) read one
    anchor-free launch each, and the table's one anchored launch each."""
    for name, attr in (("ur10", "launches"), ("table", "anchored_launches")):
        ps, comp, _, _ = _compiled_and_eager(name)
        T_goal = api.random_goals(ps, (64,), torch.Generator().manual_seed(22),
                                  dtype=torch.float32, device=cuda)[0]
        for _ in range(3):
            before = getattr(tr_solve.solve_tr_cuda, attr)
            comp(T_goal)
            assert getattr(tr_solve.solve_tr_cuda, attr) == before + 1, name


def test_capture_of_a_synchronising_op_raises(cuda):
    """A stage that synchronises with the host cannot be captured: the
    capture raises CaptureError naming the line that called the operator,
    keeps no graph and does not run the stage eagerly instead, at every
    call. Prepare's eigendecompositions (K5) read nothing back to the
    host, so prepare captures: its first call and its replay are the eager
    prepare bit for bit."""
    from graphik_tpu_torch.utils import compiled

    graphs = compiled.StageGraphs()
    x = torch.arange(8.0, device=cuda)
    for _ in range(2):
        with pytest.raises(compiled.CaptureError, match=r"float\(t\.sum\(\)\)"):
            graphs.run("sync", lambda t: {"y": t * float(t.sum())}, x)
    assert graphs.graphs == {}
    _, ps = load_ur10()
    solver = api.make_solver(ps, smooth_iters=2)
    eager = dataclasses.replace(solver, graphs=None)
    T_goal = api.random_goals(ps, (16,), torch.Generator().manual_seed(23),
                              dtype=torch.float32, device=cuda)[0]
    for _ in range(2):
        D, Y0 = solver.prepare(T_goal)
        D_e, Y0_e = eager.prepare(T_goal)
        assert torch.equal(D, D_e) and torch.equal(Y0, Y0_e)
    assert [k[0] for k in solver.graphs.graphs] == ["prepare"]
    assert float(torch.ones(4, device=cuda).sum()) == 4.0  # the card still works


# ---------------------------------------------------------------------------
# The TR kernel past 32 nodes and 128 edges
# ---------------------------------------------------------------------------

# (N, d, E): past 128 edges at one node a lane (EPL 5-8), and every EPL at
# two nodes a lane (N > 32)
LARGE_SHAPES = ([(32, d, 32 * e - 3) for e in range(5, 9) for d in (3, 2)]
                + [(33 + 3 * e, d, 32 * e - 5) for e in range(1, 9) for d in (3, 2)])


def _with_anchors(ep, Y0, rows=40):
    """ep plus 3 anchor groups of `rows` rows on nodes 0, N // 2 and N - 1
    (past the 32nd node when N > 32): centers scattered around each node's
    first start, lower hinges of radius 0.3 (distance kept above it), so
    some rows are active at the start and turn off as the solve goes."""
    N, d = ep.N, ep.dim
    rs = np.random.RandomState(N + rows)
    nodes = np.array([0, N // 2, N - 1])
    idx = np.repeat(nodes, rows)
    P = Y0[0].double().cpu().numpy()
    centers = np.zeros((len(idx), 3))
    centers[:, :d] = P[idx] + 0.5 * rs.normal(size=(len(idx), d))
    anchors = dict(idx=idx, centers=centers, psi_L=np.full(len(idx), 0.09),
                   psi_U=np.zeros(len(idx)), L_mask=np.ones(len(idx)), U_mask=np.zeros(len(idx)))
    # ep's edges back as dense (N, N) matrices
    dense = {k: np.zeros((N, N)) for k in ("omega", "psi_L", "psi_U", "L_mask", "U_mask")}
    for k, M in dense.items():
        M[ep.ei, ep.ej] = M[ep.ej, ep.ei] = np.asarray(getattr(ep, k))[:ep.E]
    return edge_ops.build_edge_problem(**dense, dim=d, anchors=anchors)


@pytest.mark.parametrize("anchored", [False, True], ids=["free", "anchored"])
@pytest.mark.parametrize("N,d,n_edges", LARGE_SHAPES)
def test_large_shapes_bitwise(cuda, N, d, n_edges, anchored):
    """Every instance past 32 nodes or 128 edges (NPL = 1 with 5-8 edges a
    lane, NPL = 2 with 1-8; anchor-free and anchored, the anchored nodes
    including one in a lane's second slot), 1001 instances (a ragged last
    block of 4): one step, and 20 steps with the production stops, bitwise
    equal to the plain version; one launch each."""
    ep, Y0, dg = _synthetic(N, d, n_edges, seed=N + n_edges, device=cuda, B=1001)
    if anchored:
        ep = _with_anchors(ep, Y0)
        assert ep.A == 3 * 40 and (ep.N - 1) in tr_solve._anchor_nodes(ep)
    assert (ep.N, ep.E) == (N, n_edges)
    assert not tr_solve.kernel_shape(ep, 1001, d)["two_per_warp"]
    before = tr_solve.solve_tr_cuda.launches
    _bitwise(ep, Y0, dg, maxiter=1, maxinner=24)
    _bitwise(ep, Y0, dg, maxiter=20, **PROD)
    assert tr_solve.solve_tr_cuda.launches == before + 2


@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("N,d,n_edges", [(42, 3, 126), (43, 2, 89), (64, 3, 256), (32, 3, 256)])
def test_large_shapes_small_batches_bitwise(cuda, N, d, n_edges, B):
    """dh19's and planar40's (N, d, E), and the largest shapes, at B = 1
    and 33 (warps of the block left without an instance), with res_tol > 0
    too: bitwise equal to the plain version."""
    ep, Y0, dg = _synthetic(N, d, n_edges, seed=N + B, device=cuda, B=B)
    _bitwise(ep, Y0, dg, maxiter=1, maxinner=24)
    _bitwise(ep, Y0, dg, maxiter=20, res_tol=0.05, **PROD)


def test_anchored_past_1024_rows_bitwise(cuda):
    """ur10_table192: UR10 and the 192-sphere table (A = 6 x 192 = 1152
    anchor rows, past the 1024 the build took before) on 1001 goals
    prepared on the card: 30 steps from the init and from world-frame
    starts bitwise equal to the plain version."""
    tpl, _ = load_ur10()
    ps = ProblemStructure.from_template(tpl, obstacles=table_environment(n_width=12, n_height=12))
    spec = ps.reduced_spec()
    Nr = spec["Nr"]
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega[:Nr, :Nr], psi_L[:Nr, :Nr], psi_U[:Nr, :Nr],
                                     dim=3, anchors=spec)
    assert (ep.A, ep.a_nsel, ep.a_R) == (1152, 6, 192)
    gen = torch.Generator().manual_seed(12)
    T_goal, _ = api.random_goals(ps, (1001,), gen, dtype=torch.float32, device=cuda)
    D_goal, Y0 = api.make_solver(ps, smooth_iters=2).prepare(T_goal)
    _, q = api.random_goals(ps, (1001,), gen, dtype=torch.float32, device=cuda)
    Yw = ps.realization(q)[:, :Nr].contiguous()
    dg = ep.edge_values(D_goal).contiguous()
    before = tr_solve.solve_tr_cuda.anchored_launches
    _bitwise(ep, Y0.contiguous(), dg, maxiter=30, maxinner=24, plateau_every=16, plateau_rtol=1e-4)
    _bitwise(ep, Yw, dg, maxiter=30, maxinner=24, plateau_every=16, plateau_rtol=1e-4)
    assert tr_solve.solve_tr_cuda.anchored_launches == before + 2


def test_tr_kernel_refuses_past_the_build(cuda):
    """N = 129, E = 520 and a group of 1032 anchor rows raise, naming the
    limit, on CUDA tensors too; no wrapper falls back to the plain
    version."""
    ep, Y0, dg = _synthetic(129, 3, 200, seed=1, device=cuda, B=4)
    with pytest.raises(ValueError, match="N <= 128"):
        tr_solve.solve_tr_cuda(ep, Y0, dg, maxiter=1)
    ep, Y0, dg = _synthetic(40, 3, 520, seed=1, device=cuda, B=4)
    with pytest.raises(ValueError, match="E <= 512"):
        tr_solve.solve_tr(ep, Y0, dg, maxiter=1)
    ep, Y0, dg = _synthetic(8, 3, 10, seed=1, device=cuda, B=4)
    big = _with_anchors(ep, Y0, rows=1032)
    with pytest.raises(ValueError, match="a_R <= 1024"):
        tr_solve.solve_tr_cuda(big, Y0, dg, maxiter=1)


def _symmetric(rs, B, n, dtype, device):
    X = rs.normal(size=(B, n, n))
    return torch.tensor(X + X.transpose(0, 2, 1), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", list(range(1, 129)))
def test_sym_eigh_kernel_matches_plain(cuda, dtype, n):
    """K5 (csrc/eigh.cu) against its plain version on the card at every n
    it takes (one kernel instance per even m = n rounded up and type, past
    n = 32 those of csrc/eigh_wide.cuh, past 64 those of
    csrc/eigh_block.cu, one kernel a type; odd n skips pair 0),
    301 random symmetric matrices (a ragged last block):
    eigenvalues, eigenvectors and flags bitwise equal, every matrix
    converged, one launch counted; eigenvalues within 1e-5 (f32) or 1e-12
    (f64) of ||A||_F from torch.linalg.eigh; and the first 77 matrices
    alone give the same bits (a matrix a segment of its warp:
    batch-invariant)."""
    from graphik_tpu_torch.ops import eigh

    A = _symmetric(np.random.RandomState(n), 301, n, dtype, cuda)
    before = eigh.sym_eigh_cuda.launches
    w, V, conv = eigh.sym_eigh_cuda(A)
    assert eigh.sym_eigh_cuda.launches == before + 1
    w_p, V_p, conv_p = eigh.sym_eigh_reference(A)
    assert torch.equal(w, w_p) and torch.equal(V, V_p) and torch.equal(conv, conv_p)
    assert bool(conv.all())
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    scale = torch.linalg.matrix_norm(A.double())[:, None]
    assert bool(((w.double() - torch.linalg.eigvalsh(A.double())).abs() <= tol * scale).all())
    w1, V1, _ = eigh.sym_eigh_cuda(A[:77])
    assert torch.equal(w1, w[:77]) and torch.equal(V1, V[:77])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sym_eigh_kernel_equal_diagonals(cuda, dtype):
    """Equal diagonal entries (theta = +-0 in a rotation, t taking its
    sign bit), n = 2, 9, 13, 20: K5 bitwise its plain version, every matrix
    converged."""
    from graphik_tpu_torch.ops import eigh

    rs = np.random.RandomState(5)
    for n in (2, 9, 13, 20):
        E = np.triu(rs.normal(size=(300, n, n)), 1)
        A = torch.tensor(2.0 * np.eye(n) + E + E.transpose(0, 2, 1), dtype=dtype, device=cuda)
        w, V, conv = eigh.sym_eigh_cuda(A)
        w_p, V_p, _ = eigh.sym_eigh_reference(A)
        assert torch.equal(w, w_p) and torch.equal(V, V_p) and bool(conv.all()), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [5, 9, 16, 18, 32])
def test_sym_eigh_kernel_lock_step_segments(cuda, dtype, n):
    """The matrices that share a warp (4 a warp for n <= 16, 2 above) stop
    after different numbers of sweeps: in each run of 4 one is diagonal
    (converged before its first sweep), one nearly so (off-diagonal 1e-6,
    then 1e-2 of the diagonal's spread: one or two sweeps) and one
    random. The finished segments idle while the others sweep, their data
    moving with the warp's: K5 bitwise its plain version, each matrix the
    same alone as in the batch, every flag set."""
    from graphik_tpu_torch.ops import eigh

    rs = np.random.RandomState(n + 40)
    B = 64
    X = rs.normal(size=(B, n, n))
    A = X + X.transpose(0, 2, 1)
    D = np.zeros((B, n, n))
    D[:, np.arange(n), np.arange(n)] = rs.normal(size=(B, n))
    A[0::4] = D[0::4]
    A[1::4] = D[1::4] + 1e-6 * A[1::4]
    A[2::4] = D[2::4] + 1e-2 * A[2::4]
    A = torch.tensor(A, dtype=dtype, device=cuda)
    w, V, conv = eigh.sym_eigh_cuda(A)
    w_p, V_p, conv_p = eigh.sym_eigh_reference(A)
    assert torch.equal(w, w_p) and torch.equal(V, V_p) and torch.equal(conv, conv_p)
    assert bool(conv.all())
    for i in (0, 1, 2, 3, 5, 62):
        w1, V1, _ = eigh.sym_eigh_cuda(A[i:i + 1].clone())
        assert torch.equal(w1[0], w[i]) and torch.equal(V1[0], V[i]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sym_eigh_kernel_leaves_padded_rows_alone(cuda, dtype):
    """The sparse CIDGIK's padded clique blocks (exact-zero rows and
    columns): K5 bitwise its plain version, each padded index keeping
    eigenvalue 0 and its unit eigenvector."""
    from graphik_tpu_torch.ops import eigh

    rs = np.random.RandomState(4)
    A = _symmetric(rs, 600, 9, dtype, cuda)
    A[::3, 7:, :] = 0.0
    A[::3, :, 7:] = 0.0
    w, V, conv = eigh.sym_eigh_cuda(A)
    w_p, V_p, _ = eigh.sym_eigh_reference(A)
    assert torch.equal(w, w_p) and torch.equal(V, V_p) and bool(conv.all())
    unit = (V[::3, 7:, :] == 1.0)
    assert bool((unit.sum(-1) == 1).all())
    cols = unit.float().argmax(-1)
    assert bool((w[::3].gather(1, cols) == 0.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [34, 43, 64, 66, 103, 128])
def test_sym_eigh_wide_matrices_stop_at_their_own_sweep(cuda, dtype, n):
    """Past n = 32 (and past 64, a block a matrix): diagonal matrices (no sweep) alternate with random ones
    (the most sweeps) and nearly diagonal ones, so that each block of the
    one-warp instances (two matrices a block) holds matrices that stop at
    different sweeps: K5 bitwise its plain version, every flag set, the
    sweeps as the plain version counts them, each matrix the same alone."""
    from graphik_tpu_torch.ops import eigh

    rs = np.random.RandomState(n + 70)
    B = 12
    X = rs.normal(size=(B, n, n))
    A = X + X.transpose(0, 2, 1)
    D = np.zeros((B, n, n))
    D[:, np.arange(n), np.arange(n)] = rs.normal(size=(B, n))
    A[0::2] = D[0::2]
    A[3::4] = D[3::4] + 1e-6 * A[3::4]
    A = torch.tensor(A, dtype=dtype, device=cuda)
    w, V, conv = eigh.sym_eigh_cuda(A)
    w_p, V_p, conv_p, ran = eigh.sym_eigh_reference(A, sweeps=True)
    assert torch.equal(w, w_p) and torch.equal(V, V_p) and torch.equal(conv, conv_p)
    assert bool(conv.all())
    assert bool((ran[0::2] == 0).all()) and bool((ran[1::4] > ran[3::4]).all())
    for i in (0, 1, 2, 3, 11):
        w1, V1, _ = eigh.sym_eigh_cuda(A[i:i + 1].clone())
        assert torch.equal(w1[0], w[i]) and torch.equal(V1[0], V[i]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sym_eigh_wide_leaves_padded_rows_alone(cuda, dtype):
    """Exact-zero rows and columns past n = 32 (n = 43, the last 5 zero on
    every third matrix): K5 bitwise its plain version, each padded index
    keeping eigenvalue 0 and its unit eigenvector."""
    from graphik_tpu_torch.ops import eigh

    A = _symmetric(np.random.RandomState(44), 300, 43, dtype, cuda)
    A[::3, 38:, :] = 0.0
    A[::3, :, 38:] = 0.0
    w, V, conv = eigh.sym_eigh_cuda(A)
    w_p, V_p, _ = eigh.sym_eigh_reference(A)
    assert torch.equal(w, w_p) and torch.equal(V, V_p) and bool(conv.all())
    unit = (V[::3, 38:, :] == 1.0)
    assert bool((unit.sum(-1) == 1).all())
    cols = unit.float().argmax(-1)
    assert bool((w[::3].gather(1, cols) == 0.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [33, 34, 63, 64, 65, 66, 127, 128])
@pytest.mark.parametrize("B", [1, 2, 3, 129])
def test_sym_eigh_wide_ends_at_every_batch(cuda, dtype, n, B):
    """The smallest and the largest m past 32 and past 64 (34, 64, 66, 128;
    odd n skips pair 0) in both types, whichever instances serve them (one
    warp a matrix, two a block, a matrix split over a block's two warps
    behind its named barrier, or past 64 a block of 5-8 warps a matrix), at
    batches that leave a block half full: bitwise the plain version, every
    flag set."""
    from graphik_tpu_torch.ops import eigh

    A = _symmetric(np.random.RandomState(1000 * n + B), B, n, dtype, cuda)
    w, V, conv = eigh.sym_eigh_cuda(A)
    w_p, V_p, conv_p = eigh.sym_eigh_reference(A)
    assert torch.equal(w, w_p) and torch.equal(V, V_p) and torch.equal(conv, conv_p)
    assert bool(conv.all())


@pytest.mark.parametrize("restarts", [1, 2])
def test_compiled_prepare_equals_eager(cuda, restarts):
    """The compiled solver's prepare on the card (make_solver, and
    make_restart_solver with its generator's draws taken before the stage)
    is one CUDA graph: its first call and its replays bitwise the eager
    prepare on the same goals and generator seed, at float32 and float64,
    with K5 launched twice a call (the Gram and the edge scatter, each
    stacked over the restarts) and counted on replay."""
    from graphik_tpu_torch.ops import eigh
    from graphik_tpu_torch.parallel import mesh

    _, ps = load_ur10()
    for dtype in (torch.float32, torch.float64):
        if restarts == 1:
            solver = api.make_solver(ps, smooth_iters=2)
            gen = ()
        else:
            solver = mesh.make_restart_solver(ps, n_restarts=restarts, smooth_iters=2)
        eager = dataclasses.replace(solver, graphs=None)
        T_goal = api.random_goals(ps, (64,), torch.Generator().manual_seed(24), dtype=dtype,
                                  device=cuda)[0]
        for call in range(3):
            if restarts > 1:
                gen = (torch.Generator().manual_seed(40 + call),)
            before = eigh.sym_eigh_cuda.launches
            D, Y0 = solver.prepare(T_goal, *gen)
            assert eigh.sym_eigh_cuda.launches == before + 2, (dtype, call)
            if restarts > 1:
                gen = (torch.Generator().manual_seed(40 + call),)
            D_e, Y0_e = eager.prepare(T_goal, *gen)
            assert Y0.shape == (restarts * 64, ps.N, 3)
            assert torch.equal(D, D_e) and torch.equal(Y0, Y0_e), (dtype, call)
        assert sum(k[0] == "prepare" for k in solver.graphs.graphs) == 1


def _same(a, b, what):
    assert set(a) == set(b), what
    for key in a:
        assert torch.equal(a[key], b[key]), (what, key)


def _cidgik_finish(ps):
    """The bench's CIDGIK finish (bench.py stage_finish): the raw pose
    error, the limits of the realization and the 30-step LM polish."""
    def finish(q, T_goal):
        e_pos, e_rot = api.pose_error(ps, q, T_goal)
        viol, ok = ps.check_distance_limits(ps.realization(q))
        keys = ("q", "e_pos", "e_rot", "limit_violation", "success")
        return dict(zip(keys, api.polish_solution(ps, q, T_goal, e_pos, e_rot, viol, ok)))
    return finish


@pytest.mark.parametrize("case", ["dense", "table", "sparse", "vmap"])
def test_cidgik_loop_graphs_equal_eager(cuda, case):
    """CIDGIK on the card runs its ADMM through its template's loop graphs:
    two calls (capture, then replays) bitwise equal to the eager pieces
    (compiled.eager_loops) on the same goals, with the same ADMM step
    count and no further capture on the second; then the finish through a
    StageGraphs, bitwise the eager finish, at float32 and float64. With
    the eigh cone projection (cone_ns_iters = 0) the pieces hold K5, and
    the ADMM captures and replays them the same way: bitwise the eager
    pieces over two calls."""
    from graphik_tpu_torch.solvers import cidgik, cidgik_sparse
    from graphik_tpu_torch.utils import compiled

    tpl, ps = load_ur10()
    if case == "table":
        ps = ProblemStructure.from_template(tpl, obstacles=table_environment())
    if case == "sparse":
        comp, solve = cidgik_sparse.compile_cidgik_sparse(ps), cidgik_sparse.solve_cidgik_sparse
    else:
        comp, solve = cidgik.compile_cidgik(ps), cidgik.solve_cidgik
    kw = dict(params=cidgik.CidgikParams.production(admm_iters=120, admm_iters_rest=60,
                                                    max_outer=3))
    if case == "vmap":
        kw = dict(engine="vmap", params=cidgik.CidgikParams(admm_iters=120, max_outer=2,
                                                            adapt_every=10, admm_tol=4e-3,
                                                            cone_ns_iters=16))
    for dtype in (torch.float32, torch.float64):
        T = api.random_goals(ps, (32,), torch.Generator().manual_seed(30), dtype=dtype,
                             device=cuda)[0]
        pieces = None
        for call in range(2):
            cidgik.solve_cidgik.admm_steps = 0
            before = _hand_launches()
            out = solve(comp, T, **kw)
            steps = cidgik.solve_cidgik.admm_steps
            loops = cidgik._graphs(comp).loops
            n_pieces = sum(len(b.pieces) for b in loops.values())
            assert n_pieces > 0 and (pieces is None or n_pieces == pieces), (case, call)
            pieces = n_pieces
            cidgik.solve_cidgik.admm_steps = 0
            with compiled.eager_loops():
                ref = solve(comp, T, **kw)
            assert cidgik.solve_cidgik.admm_steps == steps
            assert _hand_launches() == before
            _same(out, ref, (case, dtype, call))
        graphs = compiled.StageGraphs()
        finish = _cidgik_finish(comp.structure)
        for call in range(2):
            _same(graphs.run("finish", finish, out["q"], T), finish(out["q"], T),
                  (case, dtype, "finish", call))
    eigh = dict(kw, params=dataclasses.replace(kw["params"], cone_ns_iters=0, max_outer=1))
    from graphik_tpu_torch.ops.eigh import sym_eigh_cuda

    for call in range(2):
        n_pieces = sum(len(b.pieces) for b in cidgik._graphs(comp).loops.values())
        before = sym_eigh_cuda.launches
        out = solve(comp, T, **eigh)
        assert sym_eigh_cuda.launches > before
        with compiled.eager_loops():
            ref = solve(comp, T, **eigh)
        _same(out, ref, (case, "eigh", call))
        grown = sum(len(b.pieces) for b in cidgik._graphs(comp).loops.values()) - n_pieces
        assert grown > 0 if call == 0 else grown == 0, (case, call)


@pytest.mark.parametrize("case", ["ur10_f64", "table_f64", "planar10_edge", "cg", "cg_f64"])
def test_loop_graphs_of_the_compiled_solver_equal_eager(cuda, case):
    """The compiled solver's loop paths (the TR's "dense" / "edge" backends,
    so every float64 solve, and CG): solve (its loop's pieces as CUDA
    graphs) and finish (one graph) bitwise the eager stages on the same
    prepared inputs, over two calls (capture, then replays with no new
    capture), with the same host reads and no hand-written kernel."""
    from graphik_tpu_torch.robots.library import load_planar_chain
    from graphik_tpu_torch.solvers import riemannian
    from graphik_tpu_torch.solvers.riemannian import CGParams

    tpl, ps = load_ur10()
    dtype = torch.float64
    params = TRParams.production(maxiter=60, maxinner=24)
    if case == "table_f64":
        ps = ProblemStructure.from_template(tpl, obstacles=table_environment())
        params = TRParams.production(maxiter=60, maxinner=32)
    elif case == "planar10_edge":
        ps = load_planar_chain(10, limits=np.pi / 2)[1]
        params, dtype = TRParams.production(maxiter=60, maxinner=24, backend="edge"), torch.float32
    elif case.startswith("cg"):
        params = CGParams.production(maxiter=150)
        dtype = torch.float64 if case == "cg_f64" else torch.float32
    kw = dict(params=params, polish_params=LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    solver, eager = api.make_solver(ps, **kw), api.Solver(ps, **kw)
    counter = riemannian.solve_cg if case.startswith("cg") else riemannian.solve
    pieces = None
    for call in range(2):
        T = api.random_goals(ps, (64,), torch.Generator().manual_seed(31 + call), dtype=dtype,
                             device=cuda)[0]
        D, Y0 = eager.prepare(T)
        before = _hand_launches()
        counter.host_reads = 0
        sol = solver.solve(Y0, D)
        reads = counter.host_reads
        out = solver.finish(sol, T)
        counter.host_reads = 0
        sol_e = eager.solve(Y0, D)
        assert counter.host_reads == reads > 0
        out_e = eager.finish(sol_e, T)
        assert _hand_launches() == before
        _same(sol, sol_e, (case, call, "solve"))
        _same(out, out_e, (case, call, "finish"))
        n_pieces = sum(len(b.pieces) for b in solver.graphs.loops.values())
        assert n_pieces > 0 and (pieces is None or n_pieces == pieces), case
        assert len(solver.graphs.graphs) == 1  # the finish
        pieces = n_pieces


def test_compiled_solver_outlives_the_edge_problem_cache(cuda):
    """A compiled solver's graphs hold the EdgeProblem whose tables they
    read: after the module cache has let go of it, the solver still
    replays bitwise equal to its first call."""
    import gc
    import weakref

    from graphik_tpu_torch.solvers import riemannian

    tpl, _ = load_ur10()
    ps = ProblemStructure.from_template(tpl, obstacles=[(np.array([0.6, 0.3, 0.4]), 0.2)])
    solver = api.make_solver(ps, TRParams.production(maxiter=50, maxinner=24),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    T = api.random_goals(ps, (256,), torch.Generator().manual_seed(32), dtype=torch.float32,
                         device=cuda)[0]
    first = solver(T)
    held = [weakref.ref(o) for o in solver.graphs.owners if type(o) is edge_ops.EdgeProblem]
    assert held
    riemannian._EDGE_PROBLEMS.clear()
    riemannian._EDGE_PROBLEMS_RECENT.clear()
    gc.collect()
    assert all(r() is not None for r in held)
    for _ in range(2):
        _same(solver(T), first, "replay")


def test_evicted_sharded_solver_releases_its_pool(cuda, monkeypatch):
    """A sharded solver that falls out of the memo releases its graphs at
    once: torch.cuda.memory_reserved falls by its graph pool's size, within
    5%."""
    import collections

    from graphik_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "_SHARDED_SOLVERS", collections.OrderedDict())
    monkeypatch.setattr(mesh, "_SHARDED_SOLVERS_MAX", 1)
    _, ps = load_ur10()
    T = api.random_goals(ps, (8192,), torch.Generator().manual_seed(33), dtype=torch.float32,
                         device=cuda)[0]
    kw = dict(polish_params=LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)
    mesh.solve_ik_sharded(ps, T, [cuda], params=TRParams.production(maxiter=20), **kw)
    (solver,) = mesh._SHARDED_SOLVERS.values()
    # the graphs' static inputs live outside the pool: hold them, so that
    # only the pool's memory is given back
    inputs = [b for g in solver.graphs.graphs.values() for b in g.inputs]
    pools = {tuple(p) for p in solver.graphs.pools.values()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in pools)
    before = torch.cuda.memory_reserved()
    mesh._sharded_solver(ps, TRParams.production(maxiter=21), **kw)  # evicts the first
    fell = before - torch.cuda.memory_reserved()
    assert pool > 0 and abs(fell - pool) <= 0.05 * pool, (fell, pool)
    assert solver.graphs.graphs == {} and len(inputs) > 0


# ---------------------------------------------------------------------------
# K1 / K2 past 32 nodes and 128 edges
# ---------------------------------------------------------------------------

def _dh_chain(n):
    """tests/test_torch_large.py's n-DoF DH chain (n = 19 is dh19), without
    JAX: a ~ U(0.1, 0.5), d ~ U(0, 0.3), alpha from {-pi/2, 0, pi/2},
    drawn from RandomState(n), limits +-pi/2."""
    from graphik_tpu_torch.robots.templates import revolute_from_dh

    rs = np.random.RandomState(n)
    a = rs.uniform(0.1, 0.5, n)
    d = rs.uniform(0.0, 0.3, n)
    alpha = rs.choice([-np.pi / 2, 0.0, np.pi / 2], n)
    return revolute_from_dh(a, alpha, d, np.zeros(n), lb=-np.pi / 2, ub=np.pi / 2)


def _large_structure(robot):
    """planar40 (N = 43, d = 2, E = 89), dh15 (34 / 3 / 106) or dh19 (42 / 3
    / 126)."""
    from graphik_tpu_torch.robots.library import load_planar_chain

    if robot == "planar40":
        return load_planar_chain(40, limits=np.pi / 2)[1]
    return ProblemStructure.from_template(_dh_chain(int(robot[2:])))


# planar40, dh19 and dh15 on goals prepared on the card (full smoothing, as
# chip_smoke.py phase 20 runs them), and the largest instances, 64 nodes
# and 256 edges at d = 2 and 3
EDGE_WIDE_CASES = ["planar40", "dh19", "dh15", (64, 2, 256), (64, 3, 256)]


def _edge_wide_case(case, B, device):
    if isinstance(case, tuple):
        return _synthetic(*case, seed=sum(case) + B, device=device, B=B)
    ps = _large_structure(case)
    ep = edge_ops.build_edge_problem(*ps.masks(), dim=ps.dim)
    T_goal, _ = api.random_goals(ps, (B,), torch.Generator().manual_seed(B + ep.E),
                                 dtype=torch.float32, device=device)
    D_goal, Y0 = api.make_solver(ps, smooth_iters=None).prepare(T_goal)
    return ep, Y0.contiguous(), ep.edge_values(D_goal).contiguous()


def _edge_bitwise(ep, Y, dg):
    """K1 / K2 against their kernel-order plain versions, goal distances at
    stride Ep and, where it differs, E: bitwise and finite, one launch each
    a stride."""
    Z = torch.randn(Y.shape, generator=torch.Generator(device=Y.device).manual_seed(Y.shape[0]),
                    device=Y.device)
    before = (edge_ops.cost_and_egrad_cuda.launches, edge_ops.ehess_cuda.launches)
    for dg_ in {ep.Ep: dg, ep.E: dg[:, :ep.E].contiguous()}.values():
        f, g = edge_ops.cost_and_egrad_cuda(ep, Y, dg_)
        H = edge_ops.ehess_cuda(ep, Y, Z, dg_)
        fp, gp = edge_ops.cost_and_egrad_kernel_order(ep, Y, dg_)
        Hp = edge_ops.ehess_kernel_order(ep, Y, Z, dg_)
        assert torch.equal(f, fp) and torch.equal(g, gp) and torch.equal(H, Hp)
        assert bool(torch.isfinite(f).all() and torch.isfinite(g).all() and torch.isfinite(H).all())
    n = 1 if ep.E == ep.Ep else 2
    assert (edge_ops.cost_and_egrad_cuda.launches, edge_ops.ehess_cuda.launches) == (
        before[0] + n, before[1] + n)


@pytest.mark.parametrize("B", [1, 33, 1001, 8192])
@pytest.mark.parametrize("case", EDGE_WIDE_CASES, ids=str)
def test_edge_kernels_past_32_nodes_bitwise(cuda, case, B):
    """K1 / K2 at two node slots a lane (N > 32) with 3, 4 and 8 edges a
    lane, bitwise their kernel-order plain versions: B = 1 and 33 leave
    warps of a block idle, 1001 ends in a tile that is not full, 8192 is the
    paths' batch."""
    ep, Y, dg = _edge_wide_case(case, B, cuda)
    assert ep.N > 32
    _edge_bitwise(ep, Y, dg)


@pytest.mark.parametrize("N,d,n_edges", LARGE_SHAPES)
def test_edge_kernels_every_wide_instance_bitwise(cuda, N, d, n_edges):
    """Every instance past 32 nodes or 128 edges (one node slot with 5-8
    edges a lane, two with 1-8) at 1001 instances, bitwise."""
    ep, Y, dg = _synthetic(N, d, n_edges, seed=N + n_edges, device=cuda, B=1001)
    assert (ep.N, ep.E) == (N, n_edges)
    _edge_bitwise(ep, Y, dg)


@pytest.mark.parametrize("case", ["planar40", "dh19", (32, 3, 253), (64, 3, 256)], ids=str)
def test_edge_kernel_shape_past_32_nodes_matches_plan(cuda, case):
    """The C side's launch shape past 32 nodes or 128 edges is
    edge_launch_plan's: one instance a warp, EPL up to 8."""
    ep = _edge_wide_case(case, 1, cuda)[0]
    for hess, B in ((False, 8192), (True, 8192), (True, 131072)):
        shape = edge_ops.edge_kernel_shape(ep, B, ep.Ep, hess)
        plan = edge_ops.edge_launch_plan(ep.N, ep.dim, ep.E, ep.Ep, B, hess)
        assert {k: shape[k] for k in plan} == plan and not shape["two_per_warp"]
        assert shape["blocks"] == min(plan["tiles"], shape["blocks_resident"])
        assert shape["blocks_resident"] >= 132


def test_edge_wide_instances_do_not_spill(cuda):
    """No instance past 32 nodes or 128 edges spills (the build's ptxas
    log): 48 of them, K1 and K2 at d = 2, 3 with NPL = 2 and EPL 1-8 or
    NPL = 1 and EPL 5-8."""
    import re

    from graphik_tpu_torch.ops._build import library_path, load_library

    load_library()
    with open(library_path() + ".log") as f:
        entries = f.read().split("Compiling entry function '")[1:]
    wide = {}
    for entry in entries:
        name = re.match(
            r"_ZN7graphik4wide\d+(cost_grad_kernel|hess_kernel)ILi(\d)ELi(\d)ELi32ELi(\d)E", entry)
        if name:
            wide[name.groups()] = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
    assert len(wide) == 48 and not any(wide.values()), wide


def test_edge_kernels_refuse_past_the_build(cuda):
    """N = 65 raises, naming the limit, on CUDA tensors too."""
    ep, Y, dg = _synthetic(65, 3, 100, seed=1, device=cuda, B=4)
    with pytest.raises(ValueError, match="N <= 64"):
        edge_ops.cost_and_egrad_cuda(ep, Y, dg)
    with pytest.raises(ValueError, match="N <= 64"):
        edge_ops.ehess_cuda(ep, Y, Y, dg)


# ---------------------------------------------------------------------------
# Batch-position invariance: a goal's result does not depend on where it
# sits in the batch
# ---------------------------------------------------------------------------

# the single-init compiled paths of chip_smoke.py (its parameters; planar40
# at full smoothing and at the UR10 path's two squarings)
POSITION_PATHS = ["ur10", "kuka_iiwa", "lwa4d", "planar6", "planar10", "ur10_table",
                  "planar10_ring6", "planar40", "planar40_smooth2", "dh19", "ur10_table192"]
# the graphed-loop paths, and CG and the float32 "dense" TR on planar10, whose
# dense cost sums 13 x 13 values an instance (not a multiple of 16 bytes)
POSITION_LOOP_PATHS = ["ur10_cidgik", "ur10_cidgik_sparse", "ur10_cg", "ur10_f64",
                       "planar10_edge", "planar10_cg", "planar10_dense"]
B_POSITION = 8192
B_POSITION_LOOP = 256


def _position_path(name):
    """(structure, solver or CIDGIK call, goal dtype) of a path: solver(T)
    -> {name: (B, ...) tensor}, prepare's D_goal and Y0 beside the
    outputs."""
    from graphik_tpu_torch.robots.library import (
        load_kuka, load_planar_chain, load_schunk_lwa4d)
    from graphik_tpu_torch.solvers import cidgik, cidgik_sparse
    from graphik_tpu_torch.solvers.riemannian import CGParams
    from graphik_tpu_torch.utils.environments import ring_environment

    tpl, ps = load_ur10()
    prod = TRParams.production(maxiter=100, maxinner=24)
    long = TRParams.production(maxiter=250, maxinner=32)
    smooth, params, dtype = 2, prod, torch.float32
    if name in ("ur10_cidgik", "ur10_cidgik_sparse"):
        sparse = name.endswith("sparse")
        comp = (cidgik_sparse.compile_cidgik_sparse if sparse else cidgik.compile_cidgik)(ps)
        solve = cidgik_sparse.solve_cidgik_sparse if sparse else cidgik.solve_cidgik
        cp = cidgik.CidgikParams.production(admm_iters=700, admm_iters_rest=300)
        finish = _cidgik_finish(ps)

        def run(T):
            out = solve(comp, T, params=cp)
            return {**out, **{f"finish {k}": v for k, v in finish(out["q"], T).items()}}
        return ps, run, dtype
    if name == "kuka_iiwa":
        ps = load_kuka()[1]
    elif name == "lwa4d":
        ps = load_schunk_lwa4d()[1]
    elif name in ("planar6", "planar10", "planar10_edge", "planar10_cg", "planar10_dense"):
        ps = load_planar_chain(int(name[6:8].rstrip("_")), limits=np.pi / 2)[1]
        if name in ("planar10_edge", "planar10_dense"):
            params = TRParams.production(maxiter=100, maxinner=24, backend=name[9:])
        elif name == "planar10_cg":
            params = CGParams.production()
    elif name in ("ur10_table", "ur10_table192"):
        env = (table_environment() if name == "ur10_table"
               else table_environment(n_width=12, n_height=12))
        ps = ProblemStructure.from_template(tpl, obstacles=env)
        params = long if name == "ur10_table" else prod
    elif name == "planar10_ring6":
        ps = ProblemStructure.from_template(load_planar_chain(10, limits=np.pi / 2)[0],
                                            obstacles=ring_environment())
        params = long
    elif name.startswith("planar40") or name == "dh19":
        ps = _large_structure(name[:8] if name.startswith("planar40") else name)
        smooth = 2 if name.endswith("smooth2") else None
    elif name == "ur10_cg":
        params = CGParams.production()
    elif name == "ur10_f64":
        dtype = torch.float64
    solver = api.make_solver(ps, params=params, smooth_iters=smooth,
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8))

    def run(T):
        D_goal, Y0 = solver.prepare(T)
        return {"D_goal": D_goal, "Y0": Y0, **solver.finish(solver.solve(Y0, D_goal), T)}
    run.solver = solver
    return ps, run, dtype


def _position_check(name, B, device):
    """One seeded goal copied to every position of a B stack: every output
    bitwise one at every position; B distinct goals in reverse order: each
    goal's outputs bitwise its forward ones."""
    ps, run, dtype = _position_path(name)
    try:
        T = api.random_goals(ps, (B,), torch.Generator().manual_seed(16), dtype=dtype,
                             device=device)[0]
        copied = run(T[:1].expand(T.shape).contiguous())
        split = {k: int((v != v[:1]).reshape(B, -1).any(-1).sum()) for k, v in copied.items()
                 if not torch.equal(v, v[:1].expand_as(v))}
        fwd, rev = run(T), run(T.flip(0).contiguous())
        moved = {k: int((rev[k].flip(0) != v).reshape(B, -1).any(-1).sum())
                 for k, v in fwd.items() if not torch.equal(rev[k].flip(0), v)}
        assert not split and not moved, (name, split, moved)
        assert {"D_goal", "Y0", "Y", "q", "e_pos", "e_rot", "iterations"} <= set(copied) or (
            name.startswith("ur10_cidgik"))
    finally:
        if hasattr(run, "solver"):
            run.solver.graphs.release()


@pytest.mark.parametrize("name", POSITION_PATHS)
def test_one_goal_at_every_batch_position(cuda, name):
    """Every single-init compiled path: one goal at all 8192 positions gives
    bitwise one D_goal, Y0, Y, q, e_pos, e_rot, iterations (and every other
    output) at every position; a reversed stack gives each goal its
    forward result. (A restart path draws its fractions by position, so
    its goals' starts differ by design.)"""
    _position_check(name, B_POSITION, cuda)


@pytest.mark.parametrize("name", POSITION_LOOP_PATHS)
def test_loop_paths_one_goal_at_every_batch_position(cuda, name):
    """The graphed-loop paths (CIDGIK's ADMM, CG, the float64 "dense" TR and
    the "edge" TR), and CG and the float32 "dense" TR on planar10, at 256
    goals: the same two checks."""
    _position_check(name, B_POSITION_LOOP, cuda)


# ---------------------------------------------------------------------------
# K6, the LM's clamped-pivot SPD solve (csrc/spd_solve.cu)
# ---------------------------------------------------------------------------

# every path's n (UR10 and planar6 6, KUKA iiwa and LWA4D 7, the tree 5,
# planar10 10, dh19 19, planar40 40, dh40 40, planar100 100) and the
# instances' ends (a thread a system up to 8 and 10, a warp up to 32, 64
# and 128; float64 past 106 a warp a block, with the shared-memory opt-in)
SPD_SIZES = [1, 3, 5, 6, 7, 8, 10, 11, 16, 19, 32, 33, 40, 64, 65, 100, 106, 107, 128]


def _spd_systems(m, dtype, device, B=1001, seed=0):
    """B systems a quarter each: SPD (X X^T / m + I), LM systems J^T J +
    lam I with J 3 x m (planar40's residual rows) and lam from 1e-12 to
    1e-3, indefinite (X D X^T, D = +-1: the clamp engages), and the LM
    systems with a NaN in the lower triangle or the right-hand side."""
    rs = np.random.RandomState(seed * 100 + m)
    q = B // 4
    X = rs.normal(size=(B, m, m))
    J = rs.normal(size=(B, 3, m))
    lam = 10.0 ** rs.uniform(-12, -3, size=(B, 1, 1))
    D = np.where(rs.uniform(size=(B, 1, m)) < 0.3, -1.0, 1.0)
    A = np.concatenate([(X @ X.transpose(0, 2, 1) / m + np.eye(m))[:q],
                        (J.transpose(0, 2, 1) @ J + lam * np.eye(m))[q:2 * q],
                        ((X * D) @ X.transpose(0, 2, 1) / m)[2 * q:3 * q],
                        (J.transpose(0, 2, 1) @ J + lam * np.eye(m))[3 * q:]])
    b = rs.normal(size=(B, m))
    i = rs.randint(0, m, size=B)
    k = rs.randint(0, m, size=B)
    lo, hi = np.maximum(i, k), np.minimum(i, k)
    rows = np.arange(3 * q, B)
    A[rows[::2], lo[rows[::2]], hi[rows[::2]]] = np.nan
    b[rows[1::2], i[rows[1::2]]] = np.nan
    return (torch.tensor(A, dtype=dtype, device=device),
            torch.tensor(b, dtype=dtype, device=device))


def _bitwise_nan(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("m", SPD_SIZES)
def test_spd_solve_kernel_matches_plain(cuda, dtype, m):
    """K6 against its plain version on the card at every path's n and the
    instances' ends, on SPD, ill-conditioned LM, indefinite and NaN
    systems, 1001 of them (a ragged last block): bitwise, NaN where the
    plain version has NaN, one launch counted; the first 77 and the first
    501 systems alone give the same bits (a system a thread or a warp:
    batch-invariant)."""
    from graphik_tpu_torch.ops import linalg

    A, b = _spd_systems(m, dtype, cuda)
    before = linalg.spd_solve_cuda.launches
    x = linalg.spd_solve_cuda(A, b)
    assert linalg.spd_solve_cuda.launches == before + 1
    x_p = linalg.spd_solve_reference(A, b)
    assert _bitwise_nan(x, x_p)
    assert bool(torch.isfinite(x[:250]).all())  # the SPD quarter
    for n in (77, 501):
        assert _bitwise_nan(linalg.spd_solve_cuda(A[:n].clone(), b[:n].clone()), x[:n])
    assert _bitwise_nan(linalg.spd_solve(A, b), x)


def test_spd_solve_kernel_refuses(cuda):
    """Past m = 128 (through the dispatcher too: no fallback), a CPU
    tensor, an integer or a mixed dtype raise, naming the limit or the
    dtype; an empty batch launches nothing."""
    from graphik_tpu_torch.ops import linalg

    A = torch.eye(129, device=cuda).expand(2, 129, 129)
    for fn in (linalg.spd_solve_cuda, linalg.spd_solve):
        with pytest.raises(ValueError, match="m <= 128"):
            fn(A, torch.ones(2, 129, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        linalg.spd_solve_cuda(torch.eye(3).expand(2, 3, 3), torch.ones(2, 3))
    with pytest.raises(TypeError, match="float32 or float64"):
        linalg.spd_solve_cuda(torch.ones(2, 3, 3, dtype=torch.int32, device=cuda),
                              torch.ones(2, 3, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError, match="float32 or float64"):
        linalg.spd_solve_cuda(torch.eye(3, device=cuda).expand(2, 3, 3),
                              torch.ones(2, 3, dtype=torch.float64, device=cuda))
    before = linalg.spd_solve_cuda.launches
    assert linalg.spd_solve_cuda(torch.ones(0, 4, 4, device=cuda),
                                 torch.ones(0, 4, device=cuda)).shape == (0, 4)
    assert linalg.spd_solve_cuda.launches == before


def test_spd_solve_instances_do_not_spill(cuda):
    """K6's ten instances (float32 / float64; a thread a system up to m = 8
    and 10, a warp a system with one, two or four rows a lane) in the
    build's ptxas log, none spilling."""

    from graphik_tpu_torch.ops._build import library_path, load_library

    load_library()
    with open(library_path() + ".log") as f:
        entries = f.read().split("Compiling entry function '")[1:]
    spills = {}
    for entry in entries:
        name = re.search(r"(\w*)spd_solve_kernelI([fd])Li(\d+)E", entry.split("'", 1)[0])
        if name:
            spills[name.groups()] = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
    assert len(spills) == 10 and not any(spills.values()), spills


@pytest.mark.parametrize("name", ["ur10", "table"])
def test_compiled_finish_launches_spd_solve(cuda, name):
    """The compiled finish launches K6 once an LM step: 10 a call on UR10
    (LocalParams(maxiter=10)), 40 on the table (4 augmented-Lagrangian
    rounds), counted on the capture's call and on every replay; the LM
    runs no cuSOLVER or cuBLAS factor or triangular solve (profiler)."""
    from graphik_tpu_torch.ops import linalg

    ps, comp, _, _ = _compiled_and_eager(name)
    T_goal = api.random_goals(ps, (64,), torch.Generator().manual_seed(23),
                              dtype=torch.float32, device=cuda)[0]
    want = 10 * (4 if name == "table" else 1)
    for _ in range(3):
        before = linalg.spd_solve_cuda.launches
        comp(T_goal)
        assert linalg.spd_solve_cuda.launches == before + want, name
    D, Y0 = comp.prepare(T_goal)
    sol = comp.solve(Y0, D)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        comp.finish(sol, T_goal)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("spd_solve_kernel" in n for n in names) == want
    assert not [n for n in names if re.search("potrf|trsm|cholesky", n, re.I)]


# ---------------------------------------------------------------------------
# The finish's one rounding (utils/lie.py matmul_small and its kin): the
# card's bits are the CPU's
# ---------------------------------------------------------------------------

def _seeded(seed, *shape, dtype=torch.float32):
    return torch.tensor(np.random.RandomState(seed).normal(size=shape), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_small_products_round_as_on_the_cpu(cuda, dtype):
    """lie.matmul_small at k = 2, 3, 4, 6, J^T J of planar40's 3 x 40
    Jacobians, the Grams of planar40's and UR10's point sets, matvec_small,
    dot_small and mean_small at 8192 instances, and in float32 norm_small and
    sqrt_rn: the card's bits are the CPU's on the same seeded inputs (float64
    sqrt is torch's own, which on the CPU is not correctly rounded)."""
    from graphik_tpu_torch.utils import lie

    B = 8192
    cases = []
    for k in (2, 3, 4, 6):
        cases += [(lie.matmul_small, (_seeded(k, B, k, k, dtype=dtype),
                                      _seeded(k + 1, B, k, k, dtype=dtype))),
                  (lie.matvec_small, (_seeded(k + 2, B, k, k, dtype=dtype),
                                      _seeded(k + 3, B, k, dtype=dtype)))]
    J = _seeded(7, B, 3, 40, dtype=dtype)
    cases.append((lie.matmul_small, (J.transpose(-1, -2), J)))
    for n, d in ((43, 2), (16, 3)):
        Y = _seeded(n, B, n, d, dtype=dtype)
        cases += [(lie.matmul_small, (Y, Y.transpose(-1, -2))),
                  (lie.dot_small, (Y, Y.flip(-2))),
                  (lambda a: lie.mean_small(a, -2, keepdim=True), (Y[:, :3],))]
        if dtype == torch.float32:
            cases.append((lie.norm_small, (Y,)))
    if dtype == torch.float32:
        cases.append((lambda a: lie.sqrt_rn(a.abs()), (_seeded(9, B, 64),)))
    for fn, args in cases:
        assert torch.equal(fn(*[a.to(cuda) for a in args]).cpu(), fn(*args))


def test_addcmul_rounds_once_on_the_card(cuda):
    """torch.addcmul on float32 CUDA tensors is a fused multiply-add: on 2^22
    seeded triples it equals a * b + c taken in float64 and rounded once to
    float32 (the two can differ only where the float64 value is a float32
    midpoint, left out), and it is not the product rounded before the add."""
    a, b, c = (_seeded(s, 2 ** 22).to(cuda) for s in (1, 2, 3))
    fused = torch.addcmul(c, a, b)
    exact = a.double() * b.double() + c.double()
    r = exact.float()
    gap = exact - r.double()
    other = torch.nextafter(r, torch.where(gap > 0, float("inf"), -float("inf")))
    midpoint = (gap != 0) & (2 * gap.abs() == (other.double() - r.double()).abs())
    assert torch.equal(fused[~midpoint], r[~midpoint])
    assert not torch.equal(fused, a * b + c)


@pytest.mark.parametrize("name", ["planar40", "ur10"])
def test_check_distance_limits_rounds_as_on_the_cpu(cuda, name):
    """check_distance_limits (dgp.pair_distances, sqrt_rn) on 8192 seeded
    planar40 and UR10 configurations' positions with 1 mm of noise, and on
    a violating set: the card's violations and verdicts are the CPU's, bit
    for bit."""
    from graphik_tpu_torch.robots.library import load_planar_chain

    ps = load_planar_chain(40, limits=np.pi / 2)[1] if name == "planar40" else load_ur10()[1]
    tpl = ps.template
    rs = np.random.RandomState(41)
    q = torch.tensor(rs.uniform(tpl.lb[1:], tpl.ub[1:], size=(8192, tpl.n)), dtype=torch.float32)
    pos = ps.realization(q)
    pos = pos + torch.tensor(1e-3 * rs.normal(size=pos.shape), dtype=torch.float32)
    for P in (pos, 1.3 * pos):
        v, ok = ps.check_distance_limits(P)
        v_c, ok_c = ps.check_distance_limits(P.to(cuda))
        assert torch.equal(v_c.cpu(), v) and torch.equal(ok_c.cpu(), ok)


# ---------------------------------------------------------------------------
# Robots past 64 nodes: K3 / K4 at four node slots a lane, K5's block
# kernels (csrc/eigh_block.cu) and K6 at four rows a lane
# ---------------------------------------------------------------------------

# (N, d, E) at four node slots a lane: every EPL from 1 to 16 (N = 68 ...
# 128), and past 256 edges at N <= 64, which takes the same instances
PAST64_SHAPES = ([(64 + 4 * e, d, 32 * e - 5) for e in range(1, 17) for d in (3, 2)]
                 + [(60, 3, 300), (128, 3, 512), (128, 2, 512)])


def _past64_structure(robot):
    """planar100 (N = 103, d = 2, E = 209), dh40 (84 / 3 / 272), or
    planar100 with ring_environment's six circles (Nr = 103, A = 800)."""
    from graphik_tpu_torch.robots.library import load_planar_chain
    from graphik_tpu_torch.utils.environments import ring_environment

    if robot == "planar100":
        return load_planar_chain(100, limits=np.pi / 2)[1]
    if robot == "planar100_ring6":
        tpl = load_planar_chain(100, limits=np.pi / 2)[0]
        return ProblemStructure.from_template(tpl, obstacles=ring_environment())
    return ProblemStructure.from_template(_dh_chain(int(robot[2:])))


@pytest.mark.parametrize("anchored", [False, True], ids=["free", "anchored"])
@pytest.mark.parametrize("N,d,n_edges", PAST64_SHAPES)
def test_past_64_nodes_shapes_bitwise(cuda, N, d, n_edges, anchored):
    """Every instance at four node slots a lane (EPL 1-16, anchor-free and
    anchored, an anchored node in a lane's last slot), 1001 instances: one
    step and 20 steps with the production stops bitwise equal to the plain
    version; one launch each."""
    ep, Y0, dg = _synthetic(N, d, n_edges, seed=N + n_edges, device=cuda, B=1001)
    if anchored:
        ep = _with_anchors(ep, Y0)
        assert ep.A == 3 * 40 and (ep.N - 1) in tr_solve._anchor_nodes(ep)
    assert (ep.N, ep.E) == (N, n_edges)
    assert tr_solve.kernel_shape(ep, 1001, d)["instances_per_block"] == 4
    before = tr_solve.solve_tr_cuda.launches
    _bitwise(ep, Y0, dg, maxiter=1, maxinner=24)
    _bitwise(ep, Y0, dg, maxiter=20, **PROD)
    assert tr_solve.solve_tr_cuda.launches == before + 2


@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("N,d,n_edges", [(103, 2, 209), (84, 3, 272), (128, 3, 512),
                                         (128, 2, 512)])
def test_past_64_nodes_small_batches_bitwise(cuda, N, d, n_edges, B):
    """planar100's and dh40's (N, d, E) and the largest shapes at B = 1 and
    33, with res_tol > 0 too: bitwise equal to the plain version."""
    ep, Y0, dg = _synthetic(N, d, n_edges, seed=N + B, device=cuda, B=B)
    _bitwise(ep, Y0, dg, maxiter=1, maxinner=24)
    _bitwise(ep, Y0, dg, maxiter=20, res_tol=0.05, **PROD)


@pytest.mark.parametrize("robot,shape", [("planar100", (103, 2, 209, 0)),
                                         ("dh40", (84, 3, 272, 0)),
                                         ("planar100_ring6", (103, 2, 209, 800))])
def test_past_64_nodes_robots_bitwise(cuda, robot, shape):
    """planar100, dh40 (full bound smoothing, as chip_smoke.py phase 20 runs
    them) and planar100 with the six circles (the anchored instance, two
    squarings as planar10_ring6) on 1000 goals prepared on the card: one
    step and 100 steps with the production stops bitwise equal to the plain
    version, K3 (or K4) launched once each."""
    ps = _past64_structure(robot)
    omega, psi_L, psi_U = ps.masks()
    if ps.n_obstacles:
        spec = ps.reduced_spec()
        Nr = spec["Nr"]
        ep = edge_ops.build_edge_problem(omega[:Nr, :Nr], psi_L[:Nr, :Nr], psi_U[:Nr, :Nr],
                                         dim=ps.dim, anchors=spec)
        smooth, counter = 2, "anchored_launches"
    else:
        ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
        smooth, counter = None, "launches"
    assert (ep.N, ps.dim, ep.E, ep.A) == shape
    T_goal, _ = api.random_goals(ps, (1000,), torch.Generator().manual_seed(ep.E),
                                 dtype=torch.float32, device=cuda)
    D_goal, Y0 = api.make_solver(ps, smooth_iters=smooth).prepare(T_goal)
    Y0, dg = Y0.contiguous(), ep.edge_values(D_goal).contiguous()
    before = getattr(tr_solve.solve_tr_cuda, counter)
    _bitwise(ep, Y0, dg, maxiter=1, maxinner=24)
    _bitwise(ep, Y0, dg, maxiter=100, **PROD)
    assert getattr(tr_solve.solve_tr_cuda, counter) == before + 2


@pytest.mark.parametrize("robot", ["planar100", "dh40"])
def test_past_64_nodes_main_path_launches(cuda, robot):
    """make_solver at the path's parameters (production(100, 24), the
    10-step polish, full bound smoothing) on 64 goals: a call launches K3
    once, K5 twice and K6 ten times, on the capture's call and on a
    replay; finite outputs of the path's shapes."""
    from graphik_tpu_torch.ops import eigh, linalg

    ps = _past64_structure(robot)
    solver = api.make_solver(ps, TRParams.production(maxiter=100, maxinner=24),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8),
                             smooth_iters=None)
    T_goal = api.random_goals(ps, (64,), torch.Generator().manual_seed(19),
                              dtype=torch.float32, device=cuda)[0]
    for _ in range(2):
        counts = (tr_solve.solve_tr_cuda.launches, eigh.sym_eigh_cuda.launches,
                  linalg.spd_solve_cuda.launches)
        out = solver(T_goal)
        assert (tr_solve.solve_tr_cuda.launches - counts[0], eigh.sym_eigh_cuda.launches
                - counts[1], linalg.spd_solve_cuda.launches - counts[2]) == (1, 2, 10)
    assert out["Y"].shape == (64, ps.N, ps.dim)
    assert out["q"].shape == (64, ps.template.n) and bool(torch.isfinite(out["q"]).all())


def _ptxas_spills(pattern):
    """{template arguments: spill store bytes} of each kernel instance of
    the built library whose mangled name matches `pattern`."""
    from graphik_tpu_torch.ops._build import library_path, load_library

    load_library()
    with open(library_path() + ".log") as f:
        entries = f.read().split("Compiling entry function '")[1:]
    out = {}
    for entry in entries:
        name = re.search(pattern, entry.split("'", 1)[0])
        if name:
            out[name.groups()] = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
    return out


def test_past_64_nodes_instances_do_not_spill(cuda):
    """The TR kernel's 64 instances at four node slots a lane (d = 2, 3;
    EPL 1-16; anchor-free and anchored), K5's two block kernels (every m
    from 66 to 128, float32 and float64) and K6's two instances at four
    rows a lane: none spills."""
    tr = _ptxas_spills(r"tr_wide_kernelILi(\d)ELi(\d+)ELb([01])E")
    block = _ptxas_spills(r"sym_eigh_block_kernelI([fd])E")
    spd = _ptxas_spills(r"warp_spd_solve_kernelI([fd])Li4E")
    assert len(tr) == 64 and not any(tr.values()), tr
    assert len(block) == 2 and not any(block.values()), block
    assert len(spd) == 2 and not any(spd.values()), spd
