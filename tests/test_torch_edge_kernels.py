"""K1 / K2's plain versions in the kernels' summation order, against the JAX
package, and the host side of the edge kernels: the device-table cache and
the launch plan.

`cost_and_egrad_kernel_order` / `ehess_kernel_order` (ops/edge.py) are
what csrc/edge.cu computes, bit for bit at float32 (tests/test_torch_cuda.py
holds the kernels to them on the card). Here they meet JAX's Pallas
kernels in interpret mode at float32, as tests/test_edge_ops.py runs them
(2e-6 of the scale), and JAX's cost_and_egrad / ehess at float64 (1e-12 of
the scale), on UR10, planar6, KUKA iiwa and the two-end-effector tree, and
past 32 nodes on planar40 (N = 43, d = 2, E = 89) and the 15- and 19-DoF DH
chains of tests/test_torch_large.py (N = 34 / 42, E = 106 / 126), at
batches that are not multiples of any tile.
"""

import gc

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.ops import edge as jedge
from graphik_tpu.robots import library as jlib
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.utils import compiled
from tests.test_torch_large import structures
from tests.test_trees import tree_template

torch.set_num_threads(1)
ROBOTS = ["ur10", "planar6", "kuka_iiwa", "tree", "planar40", "dh15", "dh19"]


def _problems(robot):
    """(JAX EdgeProblem, port EdgeProblem) of a robot's compiled masks."""
    if robot == "ur10":
        js, ts = jlib.load_ur10()[1], tlib.load_ur10()[1]
    elif robot == "planar6":
        js = jlib.load_planar_chain(6, limits=np.pi / 2)[1]
        ts = tlib.load_planar_chain(6, limits=np.pi / 2)[1]
    elif robot == "kuka_iiwa":
        js, ts = jlib.load_kuka()[1], tlib.load_kuka()[1]
    elif robot == "tree":
        js, ts = JPS.from_template(tree_template()), tlib.load_tree5()[1]
    else:
        js, ts = structures(robot)
    jep = jedge.build_edge_problem(*js.masks(), dim=js.dim)
    tep = tedge.build_edge_problem(*ts.masks(), dim=ts.dim)
    np.testing.assert_array_equal(jep.ei, tep.ei)
    np.testing.assert_array_equal(jep.ej, tep.ej)
    return jep, tep


def _inputs(ep, B, seed):
    """Seeded Y, Z (B, N, d) and goal distances (B, Ep), the padding too."""
    rs = np.random.RandomState(seed)
    Y = rs.normal(size=(B, ep.N, ep.dim))
    Z = rs.normal(size=(B, ep.N, ep.dim))
    dg = rs.uniform(0.1, 2.0, size=(B, ep.Ep))
    return Y, Z, dg


def _close(got, ref, atol):
    """|got - ref| <= atol max(1, max |ref|), as tests/test_edge_ops.py."""
    ref = np.asarray(ref, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale, ref / scale, rtol=0,
                               atol=atol)


@pytest.mark.parametrize("B", [5, 37])
@pytest.mark.parametrize("robot", ROBOTS)
def test_kernel_order_matches_pallas_interpret(robot, B):
    """float32: K1 / K2's plain versions against cost_and_egrad_pallas /
    ehess_pallas in interpret mode."""
    jep, tep = _problems(robot)
    Y, Z, dg = _inputs(tep, B, seed=B + tep.E)
    f_j, g_j = jedge.cost_and_egrad_pallas(jep, jnp.asarray(Y, jnp.float32),
                                           jnp.asarray(dg, jnp.float32), 128, True)
    h_j = jedge.ehess_pallas(jep, jnp.asarray(Y, jnp.float32), jnp.asarray(Z, jnp.float32),
                             jnp.asarray(dg, jnp.float32), 128, True)
    t32 = lambda x: torch.tensor(x, dtype=torch.float32)
    f, g = tedge.cost_and_egrad_kernel_order(tep, t32(Y), t32(dg))
    h = tedge.ehess_kernel_order(tep, t32(Y), t32(Z), t32(dg))
    assert f.dtype == g.dtype == h.dtype == torch.float32
    assert f.shape == (B,) and g.shape == h.shape == (B, tep.N, tep.dim)
    _close(f.numpy(), f_j, 2e-6)
    _close(g.numpy(), g_j, 2e-6)
    _close(h.numpy(), h_j, 2e-6)


@pytest.mark.parametrize("robot", ROBOTS)
def test_kernel_order_matches_jax_float64(robot):
    """float64: against JAX's cost_and_egrad / ehess (its einsum order), and
    goal distances of stride E equal to those of stride Ep."""
    jep, tep = _problems(robot)
    Y, Z, dg = _inputs(tep, 37, seed=tep.E)
    f_j, g_j = jedge.cost_and_egrad(jep, jnp.asarray(Y), jnp.asarray(dg))
    h_j = jedge.ehess(jep, jnp.asarray(Y), jnp.asarray(Z), jnp.asarray(dg))
    t64 = lambda x: torch.tensor(x, dtype=torch.float64)
    f, g = tedge.cost_and_egrad_kernel_order(tep, t64(Y), t64(dg))
    h = tedge.ehess_kernel_order(tep, t64(Y), t64(Z), t64(dg))
    _close(f.numpy(), f_j, 1e-12)
    _close(g.numpy(), g_j, 1e-12)
    _close(h.numpy(), h_j, 1e-12)
    f_e, g_e = tedge.cost_and_egrad_kernel_order(tep, t64(Y), t64(dg[:, :tep.E]))
    assert torch.equal(f_e, f) and torch.equal(g_e, g)
    assert torch.equal(tedge.ehess_kernel_order(tep, t64(Y), t64(Z), t64(dg[:, :tep.E])), h)


def test_lane_sum_is_the_butterfly():
    """lane_sum is a 32-lane xor butterfly: lane 0 of the rounds 16 ... 1,
    checked against index arithmetic; edge_sum takes edges l, l + 32, ...
    on lane l first."""
    x = torch.tensor(np.random.RandomState(0).normal(size=(3, 32)), dtype=torch.float32)
    ref = x.clone()
    lanes = torch.arange(32)
    for m in (16, 8, 4, 2, 1):
        ref = ref + ref[:, lanes ^ m]
    assert torch.equal(tedge.lane_sum(x), ref[:, 0])
    e = torch.tensor(np.random.RandomState(1).normal(size=(3, 70)), dtype=torch.float32)
    parts = torch.nn.functional.pad(e, (0, 26)).reshape(3, 3, 32)
    assert torch.equal(tedge.edge_sum(e), tedge.lane_sum(parts[:, 0] + parts[:, 1] + parts[:, 2]))


def test_edge_tables_cache():
    """The wrappers' device tables: the same tensors on a second call, a
    separate entry per device, contents equal to a fresh build, and no
    entry kept past its EdgeProblem."""
    tep = _problems("ur10")[1]
    cpu, meta = torch.device("cpu"), torch.device("meta")
    first = tedge.cached_edge_tables(tep, cpu)
    again = tedge.cached_edge_tables(tep, cpu)
    assert all(a is b for a, b in zip(first, again))
    fresh = tedge.edge_kernel_tables(tep, cpu)
    assert [t.dtype for t in first] == [torch.int32, torch.int32, torch.float32, torch.int32,
                                        torch.int32, torch.int32]
    assert len(first) == len(fresh) == 6
    for a, b in zip(first, fresh):
        assert torch.equal(a, b)
    # the scatter codes: each node's incident edges in ascending order, at
    # their slots, with the sign of C
    codes, slots = first[4].numpy(), first[5].numpy()
    assert codes.shape == (9, tep.N)  # UR10's largest degree is 9
    for i, lst in enumerate(tedge.incidence(tep)):
        assert codes[:len(lst), i].tolist() == [2 * slots[c >> 1] + (c & 1) for c in lst]
        assert (codes[len(lst):, i] == 2 * 64).all()  # the zero place, W EPL = 64
    on_meta = tedge.cached_edge_tables(tep, meta)
    assert all(t.device == meta for t in on_meta)
    assert {k[1] for k in compiled._CACHE[tep] if k[0] == "edge_tables"} == {cpu, meta}
    other = _problems("ur10")[1]  # equal arrays, another problem: its own entry
    assert tedge.cached_edge_tables(other, cpu)[0] is not first[0]
    n = len(compiled._CACHE)
    del other
    gc.collect()
    assert len(compiled._CACHE) == n - 1


@pytest.mark.parametrize("robot", ROBOTS)
def test_scatter_slots(robot):
    """Each edge gets its own place, inside the W places of its group of W
    edges; the q-th incident edges of the nodes (one read of the scatter)
    fall on distinct residues mod W far more often than edge order alone
    would put them."""
    tep = _problems(robot)[1]
    W = 16 if tep.N <= 16 else 32
    slots = tedge.scatter_slots(tep)
    assert slots.dtype == np.int32 and sorted(slots // W) == sorted(np.arange(tep.E) // W)
    assert len(set(slots.tolist())) == tep.E

    def clashes(place):  # reads with a repeated residue, over the rows of the incidence
        inc = tedge.incidence(tep)
        rows = [{x[q] >> 1 for x in inc if q < len(x)} for q in range(max(map(len, inc)))]
        return sum(len(r) - len({place[e] % W for e in r}) for r in rows)

    assert clashes(slots) <= clashes(np.arange(tep.E)) // 2


def test_launch_plan():
    """edge_launch_plan's arithmetic: the segment width, edges per lane,
    tile, tiles and shared memory of the bench's robot shapes, and the
    bulk copies' invariant that every full tile's rows are whole 16-byte
    units (so tile slabs start and end 16-byte aligned)."""
    plan = tedge.edge_launch_plan
    # UR10: stages of 16 x 48 Y floats (and Z) and 16 x 64 goal distances;
    # a warp's two scatter buffers of 3 x 65 floats, padded to 208 (16 mod 32)
    assert plan(16, 3, 64, 64, 8192, False) == {
        "W": 16, "epl": 4, "two_per_warp": True, "tile": 16, "tiles": 512,
        "smem_bytes": 4 * (2 * (768 + 1024) + 2 * 768 + 8 * 2 * 208)}
    assert plan(16, 3, 64, 64, 131072, True)["smem_bytes"] == 4 * (
        2 * (2 * 768 + 1024) + 2 * 768 + 8 * 2 * 208)
    # a small problem: the edge tables (1188 floats) outweigh slabs and buffers
    assert plan(2, 2, 1, 8, 5, False)["smem_bytes"] == 4 * (2 * (64 + 128) + 1188)
    assert plan(16, 3, 64, 64, 8191, True)["tiles"] == 512
    assert plan(16, 3, 64, 64, 1, True)["tiles"] == 1
    kuka = plan(18, 3, 76, 80, 8192, False)
    assert (kuka["W"], kuka["epl"], kuka["two_per_warp"], kuka["tile"], kuka["tiles"]) == (
        32, 3, False, 8, 1024)
    assert plan(9, 2, 21, 24, 100, False)["epl"] == 2
    assert plan(16, 3, 120, 120, 100, False)["epl"] == 8
    assert plan(32, 3, 128, 128, 100, True)["epl"] == 4
    for N in range(1, 33):
        for d in (2, 3):
            for E in range(1, 129):
                for stride in {E, -(-E // 8) * 8}:
                    p = plan(N, d, E, stride, 10**6, True)
                    assert p["epl"] <= (8 if N <= 16 else 4)
                    assert (p["tile"] * N * d * 4) % 16 == 0
                    assert (p["tile"] * stride * 4) % 16 == 0
                    # under the 227 KB a block may take, with the ~4.7 KB
                    # of static edge tables
                    assert p["smem_bytes"] <= 200 * 1024


def test_launch_plan_past_32_nodes():
    """The plan past 32 nodes or 128 edges: one instance a warp (W = 32),
    EPL = ceil(E / 32) up to 8, the instance's edge tables (2372 floats at
    two node slots and 256 edges: 9 x 256 + 65, rounded up to 4), and
    within the shared memory a block may take beside the 16 KB static code
    table of 64 x 64 codes."""
    plan = tedge.edge_launch_plan
    # planar40 (N = 43, E = 89, Ep = 96) and dh19 (N = 42, E = 126, Ep = 128)
    # at B = 8192: 8 instances a tile, 1024 tiles
    p40 = plan(43, 2, 89, 96, 8192, False)
    assert p40 == {"W": 32, "epl": 3, "two_per_warp": False, "tile": 8, "tiles": 1024,
                   "smem_bytes": 4 * (2 * (688 + 768) + 2 * 688 + 8 * 2 * 97)}
    assert plan(42, 3, 126, 128, 8192, True)["smem_bytes"] == 4 * (
        2 * (2 * 1008 + 1024) + 2 * 1008 + 8 * 3 * 129)
    # the largest instance: 64 nodes, 256 edges, stride 256
    assert plan(64, 3, 256, 256, 8192, True) == {
        "W": 32, "epl": 8, "two_per_warp": False, "tile": 8, "tiles": 1024,
        "smem_bytes": 4 * (2 * (2 * 1536 + 2048) + 2 * 1536 + 8 * 3 * 257)}
    # one node slot past 128 edges; two at a few edges a lane
    assert plan(32, 3, 200, 200, 5, False)["smem_bytes"] == 4 * (
        2 * (768 + 1600) + 2 * 768 + 8 * 3 * 225)
    assert plan(33, 2, 40, 40, 3, False)["smem_bytes"] == 4 * (
        2 * (528 + 320) + 2 * 528 + 8 * 2 * 65)
    # the instances' edge tables: EdgeTablesT<32 NPL, max(128, 32 EPL)>
    assert [tedge._table_floats(*k) for k in ((1, 128), (1, 224), (2, 128), (2, 256))] == [
        1188, 2052, 1220, 2372]
    for N in (17, 32, 33, 43, 64):
        for d in (2, 3):
            for E in range(1, 257):
                for stride in {E, -(-E // 8) * 8}:
                    p = plan(N, d, E, stride, 10**6, True)
                    assert p["W"] == 32 and p["epl"] == -(-E // 32) <= 8
                    assert (p["tile"] * N * d * 4) % 16 == 0
                    assert (p["tile"] * stride * 4) % 16 == 0
                    assert p["smem_bytes"] + 4 * 64 * 64 <= 227 * 1024


def _largest():
    """An EdgeProblem at the build's limits: 64 nodes, 256 edges (a chain
    and 193 seeded chords)."""
    rs = np.random.RandomState(64)
    M = np.zeros((64, 64))
    M[np.arange(63), np.arange(1, 64)] = 1.0
    iu = np.triu_indices(64, 2)
    pick = rs.choice(len(iu[0]), 256 - 63, replace=False)
    M[iu[0][pick], iu[1][pick]] = 1.0
    M = M + M.T
    return tedge.build_edge_problem(M, M, M, dim=3)


@pytest.mark.parametrize("robot", ["planar40", "dh19", "n64_e256"])
def test_tables_past_32_nodes(robot):
    """The host tables of a robot past 32 nodes, and of a problem at the
    limits (N = 64, E = 256): codes (max degree, N) with every node's
    incident edges at their slots and the zero place 2 x 32 EPL past its
    degree; slots inside their groups of 32 edges, each its own."""
    tep = _largest() if robot == "n64_e256" else _problems(robot)[1]
    ei, ej, epar, rowptr, codes, slots = (t.numpy() for t in tedge.edge_kernel_tables(tep, "cpu"))
    epl = -(-tep.E // 32)
    inc = tedge.incidence(tep)
    assert codes.shape == (max(map(len, inc)), tep.N) and tep.N > 32
    for i, lst in enumerate(inc):
        assert codes[:len(lst), i].tolist() == [2 * slots[c >> 1] + (c & 1) for c in lst]
        assert (codes[len(lst):, i] == 2 * 32 * epl).all()
    assert (slots // 32 == np.arange(tep.E) // 32).all() and slots.max() < 32 * epl
    assert len(set(slots.tolist())) == tep.E
    assert rowptr[-1] == 2 * tep.E and epar.shape == (tep.E, 5)
