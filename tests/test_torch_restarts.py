"""Port vs JAX package: the sampled MDS init and the restart solver
(graphik_tpu/parallel/mesh.py) - sampling inside the bounds, the sampled
init's Gram at float64, the pick of the best restart, restart 0 against the
single-init solver, and the two-end-effector tree solved with 3 restarts."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.parallel import mesh as jmesh
from graphik_tpu.robots import kinematics as jkin
from graphik_tpu.robots import library as jlib
from graphik_tpu.solvers import riemannian as jriem
from graphik_tpu.utils import dgp as jdgp
from graphik_tpu_torch import api as tapi
from graphik_tpu_torch.parallel import mesh as tmesh
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.solvers import riemannian as triem
from graphik_tpu_torch.solvers.local import LocalParams
from graphik_tpu_torch.solvers.riemannian import TRParams
from graphik_tpu_torch.utils import dgp as tdgp
from tests.test_trees import tree_template

torch.set_num_threads(1)


def robots():
    """(name, JAX structure, port structure): UR10 and the planar 6-chain."""
    return [("ur10", jlib.load_ur10()[1], tlib.load_ur10()[1]),
            ("planar6", jlib.load_planar_chain(6, limits=np.pi / 2)[1],
             tlib.load_planar_chain(6, limits=np.pi / 2)[1])]


def bounds(jps, tps, seed, B=6):
    tpl = jps.template
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(B, tpl.n))
    T = np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])
    ji = jps.instance(jnp.asarray(T), smooth=True, smooth_iters=2)
    ti = tps.instance(torch.from_numpy(T), smooth=True, smooth_iters=2)
    return ji, ti, T


def test_sample_distance_matrix():
    """A given frac gives the JAX package's sample; frac=None is the
    deterministic 0.9; a generator draws one frac per entry in [0, 1)."""
    _, jps, tps = robots()[0]
    ji, ti, _ = bounds(jps, tps, 1)
    key = jax.random.PRNGKey(3)
    frac = np.array(jax.random.uniform(key, ji["lb"].shape, dtype=ji["lb"].dtype))
    D_j = jdgp.sample_distance_matrix(ji["lb"], ji["ub"], key=key)
    D_t = tdgp.sample_distance_matrix(ti["lb"], ti["ub"], frac=torch.from_numpy(frac))
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tdgp.sample_distance_matrix(ti["lb"], ti["ub"]).numpy(),
                               np.asarray(jdgp.sample_distance_matrix(ji["lb"], ji["ub"])),
                               rtol=0, atol=1e-12)
    g = torch.Generator().manual_seed(0)
    D_g = tdgp.sample_distance_matrix(ti["lb"], ti["ub"], generator=g)
    s = D_g.sqrt()
    assert bool(((s >= ti["lb"] - 1e-12) & (s <= ti["ub"] + 1e-12)).all())
    again = tdgp.sample_distance_matrix(ti["lb"], ti["ub"],
                                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(D_g, again)
    assert not torch.equal(D_g, D_g.transpose(-1, -2))


@pytest.mark.parametrize("name,jps,tps", robots(), ids=lambda x: x if isinstance(x, str) else "")
def test_sampled_init_gram(name, jps, tps):
    """A sampled D is not symmetric; the port symmetrises its Gram matrix as
    jnp.linalg.eigh does, so the Grams Y Y^T of the two inits agree (the
    eigenvector signs need not). Without that step they would not."""
    ji, ti, _ = bounds(jps, tps, 2)
    omega = jps.masks()[0]
    key = jax.random.PRNGKey(5)
    frac = np.array(jax.random.uniform(key, ji["lb"].shape, dtype=ji["lb"].dtype))
    jY = np.asarray(jriem.generate_initialization(ji["lb"], ji["ub"], jnp.asarray(omega),
                                                  jps.dim, key=key))
    tY = triem.generate_initialization(ti["lb"], ti["ub"], omega, tps.dim,
                                       frac=torch.from_numpy(frac)).numpy()
    assert tY.shape == jY.shape == (6, tps.N, tps.dim)
    gram_j = jY @ jY.transpose(0, 2, 1)
    np.testing.assert_allclose(tY @ tY.transpose(0, 2, 1), gram_j, rtol=0, atol=1e-8)
    # the trap: torch.linalg.eigh on the unsymmetrised Gram reads one triangle
    D = tdgp.sample_distance_matrix(ti["lb"], ti["ub"], frac=torch.from_numpy(frac))
    G = tdgp.gram_from_distance_matrix(D)
    assert float((G - G.transpose(-1, -2)).abs().max()) > 1e-3
    Yraw = tdgp.linear_projection(tdgp.mds(G), torch.as_tensor(omega), tps.dim).numpy()
    assert np.abs(Yraw @ Yraw.transpose(0, 2, 1) - gram_j).max() > 1e-6


@pytest.mark.parametrize("name,jps,tps", robots(), ids=lambda x: x if isinstance(x, str) else "")
def test_deterministic_init_gram(name, jps, tps):
    """With no generator and no frac the init is the deterministic one
    (frac 0.9, Gram symmetrised as jnp.linalg.eigh does, MDS, projection):
    its Gram Y Y^T matches the JAX package's to 1e-8 at float64, and the
    float32 init is that pipeline's, bit for bit."""
    ji, ti, _ = bounds(jps, tps, 4)
    omega = tps.masks()[0]
    jY = np.asarray(jriem.generate_initialization(ji["lb"], ji["ub"], jnp.asarray(omega),
                                                  jps.dim))
    tY = triem.generate_initialization(ti["lb"], ti["ub"], omega, tps.dim).numpy()
    np.testing.assert_allclose(tY @ tY.transpose(0, 2, 1), jY @ jY.transpose(0, 2, 1),
                               rtol=0, atol=1e-8)
    lb, ub = ti["lb"].float(), ti["ub"].float()
    G = tdgp.gram_from_distance_matrix((lb + 0.9 * (ub - lb)) ** 2)
    ref = tdgp.linear_projection(tdgp.mds((G + G.transpose(-1, -2)) / 2.0, eps=1e-8),
                                 torch.as_tensor(omega), tps.dim)
    assert torch.equal(triem.generate_initialization(lb, ub, omega, tps.dim), ref)


def test_select_best_restart_matches_jax():
    """The same arrays through both selections, with ties (equal scores:
    the first restart wins) and infeasible restarts."""
    rs = np.random.RandomState(9)
    R, B, n = 3, 64, 6
    e_pos = 10.0 ** rs.uniform(-7, -1, size=(R, B))
    e_rot = 10.0 ** rs.uniform(-7, -1, size=(R, B))
    e_pos[1, :16], e_rot[1, :16] = e_pos[0, :16], e_rot[0, :16]   # ties 0 / 1
    e_pos[2, 8:24], e_rot[2, 8:24] = e_pos[1, 8:24], e_rot[1, 8:24]  # ties 1 / 2
    success = rs.rand(R, B) < 0.7
    success[:, 40:44] = False  # no feasible restart
    out = {"e_pos": e_pos, "e_rot": e_rot, "success": success,
           "q": rs.normal(size=(R, B, n)), "Y": rs.normal(size=(R, B, 16, 3)),
           "iterations": rs.randint(1, 100, size=(R, B)).astype(np.int32)}
    j = jmesh._select_best_restart({k: jnp.asarray(v) for k, v in out.items()})
    t = tmesh._select_best_restart({k: torch.from_numpy(v) for k, v in out.items()})
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    assert int((t["restart_index"] == 0).sum()) > 0 and int((t["restart_index"] == 2).sum()) > 0


@pytest.mark.parametrize("robot", ["ur10", "planar6"])
def test_restart_zero_is_make_solver(robot):
    """Restart 0 of the folded batch is the single-init solver's run, bit
    for bit: its prepared inputs, the TR solve and the finish on its lanes.
    With one restart the whole output is make_solver's."""
    _, tps = tlib.load_ur10() if robot == "ur10" else tlib.load_planar_chain(6, limits=np.pi / 2)
    T = tapi.random_goals(tps, (8,), torch.Generator().manual_seed(11), dtype=torch.float32,
                          device="cpu")[0]
    kw = dict(params=TRParams.production(maxiter=30, maxinner=24),
              polish_params=LocalParams(maxiter=5, tol_grad=1e-8), smooth_iters=2)
    single = tapi.make_solver(tps, **kw)
    rsolver = tmesh.make_restart_solver(tps, n_restarts=2, **kw)
    D1, Y1 = single.prepare(T)
    D2, Y2 = rsolver.prepare(T, torch.Generator().manual_seed(12))
    assert Y2.shape == (16,) + Y1.shape[1:]
    assert torch.equal(D2[:8], D1) and torch.equal(D2[8:], D1) and torch.equal(Y2[:8], Y1)
    sol1, sol2 = single.solve(Y1, D1), rsolver.solve(Y2, D2)
    for k in sol1:
        assert torch.equal(sol2[k][:8], sol1[k]), k
    out1 = single.finish(sol1, T)
    out2 = tapi.Solver.finish(rsolver, sol2, T.repeat(2, 1, 1, 1))
    for k in out1:
        assert torch.equal(out2[k][:8], out1[k]), k
    one = tmesh.make_restart_solver(tps, n_restarts=1, **kw)(T)
    assert torch.equal(one["restart_index"], torch.zeros(8, dtype=torch.long))
    for k in out1:
        assert torch.equal(one[k], out1[k]), k


def test_prepare_replays_fracs():
    """Fractions given to prepare in place of a generator give the inits
    that generator would have drawn (restarts 1.., in order), bit for bit."""
    _, tps = tlib.load_planar_chain(6, limits=np.pi / 2)
    T = tapi.random_goals(tps, (4,), torch.Generator().manual_seed(3), dtype=torch.float32,
                          device="cpu")[0]
    rsolver = tmesh.make_restart_solver(tps, n_restarts=3, smooth_iters=2)
    D1, Y1 = rsolver.prepare(T, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    fracs = torch.stack([torch.rand((4, tps.N, tps.N), generator=g) for _ in range(2)])
    D2, Y2 = rsolver.prepare(T, fracs=fracs)
    assert torch.equal(D1, D2) and torch.equal(Y1, Y2)


def test_restarts_need_a_generator():
    _, tps = tlib.load_planar_chain(6, limits=np.pi / 2)
    T = tapi.random_goals(tps, (2,), torch.Generator().manual_seed(1), dtype=torch.float64,
                         device="cpu")[0]
    with pytest.raises(ValueError, match="Generator"):
        tmesh.make_restart_solver(tps, n_restarts=2)(T)


def test_tree_end_to_end_restarts():
    """The two-end-effector tree with 3 restarts: at least 7 of 8 goals
    reached below 1 mm on both end effectors (tests/test_trees.py:71-90);
    the JAX package on the same goals for comparison."""
    jps = JPS.from_template(tree_template())
    tps = tlib.load_tree5()[1]
    tpl = jps.template
    q = np.random.RandomState(2).uniform(tpl.lb[1:], tpl.ub[1:], size=(8, tpl.n))
    T = np.array(jkin.all_poses(tpl, jnp.asarray(q))[:, tpl.ee])
    assert T.shape == (8, 2, 4, 4)
    out = tmesh.make_restart_solver(tps, n_restarts=3, params=TRParams.production(maxiter=300))(
        torch.from_numpy(T), torch.Generator().manual_seed(0))
    e_pos = out["e_pos"].numpy()
    assert (e_pos < 1e-3).sum() >= 7, e_pos
    assert out["restart_index"].shape == (8,)
    jout = jmesh.make_restart_solver(jps, n_restarts=3, params=jriem.TRParams.production(
        maxiter=300))(jnp.asarray(T), jax.random.PRNGKey(0))
    assert abs(int((e_pos < 1e-3).sum()) - int((np.asarray(jout["e_pos"]) < 1e-3).sum())) <= 1
