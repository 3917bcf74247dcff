"""The solver loops as compiled.Loop pieces (utils/compiled.py), on the CPU.

Each loop - dense and sparse CIDGIK's ADMM, the trust region's tCG on its
"dense" and "edge" backends, CG's line search - advances its state by
pieces between the host reads it makes, a finished lane kept by its flag,
so its result does not depend on how many steps a piece takes. On the card
each piece is a CUDA graph (tests/test_torch_cuda.py holds those to the
eager pieces); here the same pieces run eagerly, and every path gives the
same bits at one step a piece (a read after every step: the plain
while_loop), at 7 and at the production length. The paths' agreement
with the JAX package is held by test_torch_cidgik_solve.py,
test_torch_cidgik_sparse.py, test_torch_tr_backends.py and
test_torch_cg.py, which run these loops.

Also the three faults of the port's memory and defaults: the EdgeProblem
cache is bounded, an evicted sharded solver releases its graphs, and the
goal generators draw in torch's default dtype, as the JAX package draws in
its default float.
"""

import collections
import gc
import weakref

import numpy as np
import pytest
import torch

from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.ops import edge as tedge
from graphik_tpu_torch.parallel import mesh as tmesh
from graphik_tpu_torch.robots import kinematics as tkin
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import cidgik as tcd
from graphik_tpu_torch.solvers import cidgik_sparse as tcs
from graphik_tpu_torch.solvers import riemannian as triem
from graphik_tpu_torch.solvers.local import LocalParams
from graphik_tpu_torch.utils import compiled

torch.set_num_threads(1)

# path -> (module, the constant that sets its piece length)
CHUNK = {"cidgik_split": (tcd, "SYNC_EVERY"), "cidgik_vmap_adapt": (tcd, "SYNC_EVERY"),
         "cidgik_sparse": (tcd, "SYNC_EVERY"), "tr_dense": (triem, "TR_READ_EVERY"),
         "tr_edge": (triem, "TR_READ_EVERY"), "cg": (triem, "LS_READ_EVERY")}
PRODUCTION = {path: getattr(mod, name) for path, (mod, name) in CHUNK.items()}


def _goals(ps, B, seed):
    return tapi.random_goals(ps, (B,), torch.Generator().manual_seed(seed),
                             dtype=torch.float64, device="cpu")[0]


def _run(path):
    """One small seeded solve of the path at float64 on the CPU, with the
    counters it moves: (outputs, counts)."""
    _, ps = tlib.load_ur10()
    tcd.solve_cidgik.admm_steps = 0
    triem.solve.host_reads = triem.solve_cg.host_reads = 0
    if path.startswith("cidgik"):
        # batch-wide and per-lane early stops, so that pieces run past them
        if path == "cidgik_split":
            comp, solve = tcd.compile_cidgik(ps), tcd.solve_cidgik
            kw = dict(params=tcd.CidgikParams(admm_iters=150, admm_iters_rest=60, max_outer=3,
                                              admm_tol=0.05, cone_ns_iters=16, rho=10.0))
        elif path == "cidgik_vmap_adapt":
            comp, solve = tcd.compile_cidgik(ps), tcd.solve_cidgik
            kw = dict(engine="vmap", params=tcd.CidgikParams(
                admm_iters=120, max_outer=2, adapt_every=10, admm_tol=4e-3))
        else:
            comp, solve = tcs.compile_cidgik_sparse(ps), tcs.solve_cidgik_sparse
            kw = dict(params=tcd.CidgikParams(admm_iters=150, admm_iters_rest=60, max_outer=3,
                                              admm_tol=0.05, cone_ns_iters=16, rho=10.0))
        out = solve(comp, _goals(ps, 6, 0), **kw)
        return out, {"admm_steps": tcd.solve_cidgik.admm_steps}
    if path == "cg":
        params = triem.CGParams.production(maxiter=60)
    else:
        params = triem.TRParams.production(maxiter=30, maxinner=24, backend=path[3:])
    out = tapi.solve_ik(ps, _goals(ps, 6, 1), params=params, smooth_iters=2,
                        polish_params=LocalParams(maxiter=3, tol_grad=1e-8))
    return out, {"tr_reads": triem.solve.host_reads, "cg_reads": triem.solve_cg.host_reads}


_REFERENCE = {}


def _reference(path):
    if path not in _REFERENCE:
        _REFERENCE[path] = _run(path)
    return _REFERENCE[path]


@pytest.mark.parametrize("chunk", [1, 7, "production"])
@pytest.mark.parametrize("path", list(CHUNK))
def test_loop_pieces_give_the_same_bits_at_any_length(path, chunk, monkeypatch):
    """The path's outputs at `chunk` steps a piece, bitwise its outputs at
    the production length. A piece runs all its steps, so one step a piece
    (a read after every step) runs no step past a stop and reads the host
    at least as often: at most the production length's ADMM steps, and at
    least its host reads."""
    ref, ref_counts = _reference(path)
    mod, name = CHUNK[path]
    monkeypatch.setattr(mod, name, PRODUCTION[path] if chunk == "production" else chunk)
    out, counts = _run(path)
    assert set(out) == set(ref)
    for k in out:
        assert torch.equal(out[k], ref[k]), (path, chunk, k)
    if chunk == 1:
        if path.startswith("cidgik"):
            assert 0 < counts["admm_steps"] <= ref_counts["admm_steps"]
        else:
            key = "cg_reads" if path == "cg" else "tr_reads"
            assert counts[key] >= ref_counts[key] > 0


def test_loop_runs_pieces_on_its_state():
    """compiled.Loop on CPU tensors: each piece updates the keys it returns,
    `take` hands the values back, and a piece that changes a value's shape
    or dtype, or returns a key the state lacks, raises."""
    graphs = compiled.StageGraphs()
    loop = compiled.Loop(graphs, "count", {"x": torch.zeros(3), "n": torch.zeros((), dtype=torch.long)},
                         {"step": torch.ones(3)})

    def add(state, consts, times):
        x = state["x"]
        for _ in range(times):
            x = x + consts["step"]
        return {"x": x, "n": state["n"] + times}

    loop.run(add, 2)
    loop.run(add, 3)
    x, n = loop.take("x", "n")
    assert torch.equal(x, torch.full((3,), 5.0)) and int(n) == loop.read("n") == 5
    assert graphs.loops == {} and graphs.graphs == {}  # nothing is captured on the CPU
    with pytest.raises(ValueError, match="'x'"):
        loop.run(lambda state, consts: {"x": state["x"].double()})
    with pytest.raises(ValueError, match="'y'"):
        loop.run(lambda state, consts: {"y": state["x"]})


@pytest.mark.parametrize("params", [triem.CGParams.production(maxiter=20),
                                    triem.TRParams.production(maxiter=10, maxinner=24)])
def test_compiled_solver_loop_paths_equal_solve_ik(params):
    """make_solver on the paths whose solve is a loop of pieces (CG, and the
    TR at float64): on CPU tensors, solve_ik's results bit for bit."""
    _, ps = tlib.load_ur10()
    T = _goals(ps, 4, 2)
    kw = dict(params=params, smooth_iters=2, polish_params=LocalParams(maxiter=2, tol_grad=1e-8))
    ref = tapi.solve_ik(ps, T, **kw)
    solver = tapi.make_solver(ps, **kw)
    out = solver(T)
    assert set(out) == set(ref) and all(torch.equal(out[k], ref[k]) for k in out)
    assert solver.graphs.loops == {} and solver.graphs.graphs == {}


def test_cidgik_template_owns_its_loop_graphs():
    """The template's loop graphs are one StageGraphs, made on first use
    and freed with the template."""
    _, ps = tlib.load_ur10()
    comp = tcd.compile_cidgik(ps)
    graphs = tcd._graphs(comp)
    assert tcd._graphs(comp) is graphs
    ref = weakref.ref(graphs)
    del comp, graphs
    gc.collect()
    assert ref() is None


def test_stage_graphs_release_drops_everything():
    graphs = compiled.StageGraphs()
    graphs.run("stage", lambda a: {"y": a + 1}, torch.zeros(2))
    graphs.owners.add(tlib.load_ur10()[0])
    graphs.release()
    assert graphs.graphs == {} and graphs.loops == {} and graphs.pools == {}
    assert graphs.owners == set()


def _live_edge_problems():
    gc.collect()
    return sum(type(o) is tedge.EdgeProblem for o in gc.get_objects())


def test_edge_problem_cache_stays_bounded():
    """22 distinct one-sphere UR10 scenes through solve_ik at float32, each
    structure dropped after its solve: the EdgeProblems left alive and the
    owners of cached device constants grow by at most the recently used
    ones the cache keeps (_EDGE_PROBLEMS_KEPT), not by one a scene."""
    tpl, _ = tlib.load_ur10()
    live0, owners0 = _live_edge_problems(), len(compiled._CACHE)
    for i in range(22):
        a = 2 * np.pi * i / 22
        ps = TPS.from_template(tpl, obstacles=[(np.array([0.9 * np.cos(a), 0.9 * np.sin(a), 0.5]),
                                                0.15)])
        T = tapi.random_goals(ps, (2,), torch.Generator().manual_seed(i), dtype=torch.float32,
                              device="cpu")[0]
        out = tapi.solve_ik(ps, T, params=triem.TRParams(maxiter=2), polish=False)
        assert out["q"].dtype == torch.float32
        del ps, T, out
    kept = triem._EDGE_PROBLEMS_KEPT
    assert _live_edge_problems() - live0 <= kept
    assert len(compiled._CACHE) - owners0 <= kept


def test_sharded_solvers_evict_the_least_recent_and_release_it(monkeypatch):
    """The memo of sharded solvers keeps the _SHARDED_SOLVERS_MAX used last:
    a hit moves a solver to the back, and the solver that falls out
    releases its graphs and pools at once."""
    released = []
    monkeypatch.setattr(tmesh, "_SHARDED_SOLVERS", collections.OrderedDict())
    monkeypatch.setattr(tmesh, "_SHARDED_SOLVERS_MAX", 2)
    monkeypatch.setattr(compiled.StageGraphs, "release", lambda self: released.append(self))
    _, ps = tlib.load_ur10()

    def solver(n):
        return tmesh._sharded_solver(ps, triem.TRParams(maxiter=n), smooth_iters=2)

    a, b = solver(1), solver(2)
    assert solver(1) is a  # a hit: b is now the least recent
    c = solver(3)
    assert released == [b.graphs] and list(tmesh._SHARDED_SOLVERS.values()) == [a, c]
    d = solver(4)
    assert released == [b.graphs, a.graphs]
    assert list(tmesh._SHARDED_SOLVERS.values()) == [c, d]


@pytest.mark.parametrize("default", [torch.float32, torch.float64])
def test_goal_generators_draw_in_the_default_dtype(default):
    """random_goals and random_configuration with no dtype draw in
    torch.get_default_dtype(), as the JAX package draws in its default
    float; a dtype given is kept."""
    _, ps = tlib.load_ur10()
    before = torch.get_default_dtype()
    torch.set_default_dtype(default)
    try:
        T, q = tapi.random_goals(ps, (3,), torch.Generator().manual_seed(0), device="cpu")
        q2 = tkin.random_configuration(ps.template, (3,), torch.Generator().manual_seed(0),
                                       device="cpu")
    finally:
        torch.set_default_dtype(before)
    assert T.dtype == q.dtype == q2.dtype == default
    assert tapi.random_goals(ps, (3,), dtype=torch.float64, device="cpu")[0].dtype == torch.float64
