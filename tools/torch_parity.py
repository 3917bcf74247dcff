#!/usr/bin/env python3
"""Per-goal success parity of the PyTorch port against the JAX package on
one configuration at its bench parameters, float32:

  single init (api.make_solver), a 10-step LM polish, 2-squaring smoothing:
    ur10_table (default) UR10 + the 100-sphere table scene, production(250, 32);
    planar10_ring6: load_planar_chain(10, limits=pi/2) + six circles of radius
        0.5 on a ring of radius 4 (the port's utils/environments.py
        ring_environment), production(250, 32);
    ur10, kuka_iiwa, lwa4d, planar6, planar10 (load_planar_chain(n, limits=pi/2)):
        production(100, 24);
    robots past 32 nodes, production(100, 24), 10-step polish: planar40
        (load_planar_chain(40, limits=pi/2): N = 43, E = 89) and dh19 (a
        19-DoF DH chain drawn from RandomState(19), limits +-pi/2: N = 42,
        E = 126; `dh_template`) with full bound smoothing, and
        ur10_table192 (UR10 + table_environment(n_width=12, n_height=12):
        192 spheres, A = 1152 anchor rows) with 2-squaring smoothing;
    robots past 64 nodes, as planar40 and dh19 (full bound smoothing):
        planar100 (load_planar_chain(100, limits=pi/2): N = 103, E = 209)
        and dh40 (dh19's recipe at 40 joints, drawn from RandomState(40):
        N = 84, E = 272);
    planar40_smooth2, dh19_smooth2: planar40 and dh19 with 2-squaring
        smoothing, the UR10 path's. Two squarings bound paths of at most 4
        edges, so a long chain's far pairs keep the unbounded placeholder
        (1e9) and the MDS init is set by it alone: in both packages every
        goal starts from the same Y0, ~3e8 across, and the pre-polish joint
        angles are one configuration for all goals. The count is then one
        draw of that start, not n independent trials. For these the JAX
        half also saves its Y0, and the port half solves from it as well
        ("replay_init"); `--init-noise K` adds K solves from Y0 (1 + 1e-6
        g_k), one g_k ~ N(0, 1) per (node, coordinate) shared by every
        goal, drawn from RandomState(k), in both halves, each half
        perturbing its own Y0 (the port half also solves from the same
        K perturbations of JAX's Y0, reported as
        `port_counts_from_jax_starts`, outside the verdict). Where both Y0
        have zero spread over the goals (the tool reads it from the data)
        and K >= PERTURBED_MIN, the verdict is on the perturbed starts
        (see below);
    planar40_perturbed, dh40_perturbed: planar40 and dh40 (full
        smoothing) with their Y0 saved and, with `--init-noise K`, K
        perturbed starts in each half as above; every goal has its own Y0
        there, so the verdict is the single-init test and the perturbed
        counts only show how far one start's count moves;
  restarts (parallel.make_restart_solver, restart key / generator seed 7):
    ur10_restarts4, planar6_restarts2, planar10_restarts2: production(100, 24),
        10-step polish, 2-squaring smoothing;
    ur10_table_restarts2: production(250, 32), as above;
    tree_restarts3: the 5-joint, two-end-effector tree of tests/test_trees.py,
        3 restarts, production(maxiter=300), the default polish and smoothing;
  the trust region's XLA backends (TRParams.backend), each half on its own
  backend of that name:
    ur10_f64_dense: UR10 at float64 (goals, prepare, solve and finish),
        "dense" (the JAX package runs every float64 solve there), the ur10
        config's goals, production(100, 24), 10-step polish, 2-squaring
        smoothing;
    planar10_edge: planar10 at float32 on "edge", the planar10 config's
        goals and parameters (the JAX half is planar10's);
  Riemannian conjugate gradient (api.make_solver with CGParams, the dense
  cost backend):
    ur10_cg: UR10, CGParams.production(), 10-step polish, 2-squaring
        smoothing;
  CIDGIK (the bench's path: solve_cidgik, then pose_error,
  check_distance_limits and polish_solution's 30-step LM):
    ur10_cidgik: UR10, dense (solvers/cidgik.py),
        CidgikParams.production(admm_iters=700, admm_iters_rest=300);
    ur10_table_cidgik: UR10 + the table, dense, CidgikParams.production();
    ur10_cidgik_sparse: UR10, sparse (solvers/cidgik_sparse.py,
        solve_cidgik_sparse), CidgikParams.production(admm_iters=700,
        admm_iters_rest=300).

Two halves, because the machine with the GPU has no JAX:

    # 1. JAX package on the CPU: make the goals, solve them, save both
    python tools/torch_parity.py jax --config ur10_table --n 1000
    #    (ur10_f64_dense: about 2 min; planar10_edge: about 30 s)

    # 2. the port (on the GPU, or --device cpu): solve the same goals
    python3 tools/torch_parity.py torch --goals build/parity/ur10_table.npz

Goals are FK poses of joint angles drawn uniformly within the limits from
numpy's RandomState(seed). Success is the JAX package's summarize()
criterion: position error < 1 mm, rotation error < 1 degree (the max over
end effectors), and limit/obstacle feasible. The torch half prints one
JSON line with both counts and exits 1 when they disagree:
  * single init (both packages start from the same deterministic init):
    the port's count must fall inside the JAX count's Wilson 95% interval;
  * a goal-independent start (a shared-start config whose saved JAX Y0 and
    the port's own Y0 are each one for every goal, with K >= PERTURBED_MIN
    perturbed starts): each half's count is one draw of that start, so the
    verdict is a two-sided permutation test (PERM_RESAMPLES resamples from
    RandomState(PERM_SEED)) of the difference between the mean of JAX's K
    perturbed counts and the port's K from the same perturbations of its
    own Y0; it passes at p >= PERM_ALPHA (0.05 over the three seeds a
    config is run on: 56, 156, 256). The own-start counts and the Wilson
    interval stay printed, labelled as one draw;
  * restarts (the sampled inits of restarts 1.. come from different random
    streams): each half solves the goals RESTART_DRAWS times, with restart
    keys (JAX) and generator seeds (port) RESTART_SEED, RESTART_SEED + 1,
    ...; over the n = RESTART_DRAWS x goals trials of each half,
    |port - JAX| <= 1.96 sqrt(2 n p (1 - p)), p the pooled rate. One draw is
    not enough: the JAX package alone gives 991, 982, 980 and 982 of 1000
    on ur10_restarts4 with keys 7, 1, 2 and 3.
    The JAX half also saves the interpolation fractions its first
    REPLAY_DRAWS draws sampled; the port half replays them
    (RestartSolver(fracs=)), so that both start from the same inits, and
    reports per-goal agreement of that replay beside the test (no verdict
    rests on it).

The JAX half solves with the JAX package's production TR backend, the fused
Pallas kernel (interpret mode on the CPU), except on the planar chains (with
or without obstacles): there
it uses the package's "edge" XLA backend, the same algorithm, because at
d = 2 the Pallas kernel in interpret mode stalls near convergence and
succeeds less often (`--backend pallas` shows it: 936 of planar6's 1000
goals and 872 of planar10's, against 967 and 953 on "edge").
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CRIT_POS, CRIT_ROT = 1e-3, math.pi / 180
RESTART_SEED = 7
RESTART_DRAWS = 16
REPLAY_DRAWS = 4
# the perturbed-start verdict of a goal-independent start: at least
# PERTURBED_MIN starts a half; a two-sided permutation test at PERM_ALPHA,
# 0.05 Bonferroni-split over the three seeds each such config is run on
PERTURBED_MIN = 16
PERM_RESAMPLES = 20000
PERM_SEED = 0
PERM_ALPHA = 0.05 / 3
BENCH = dict(maxiter=100, maxinner=24, polish=10, smooth=2)
TABLE = dict(BENCH, maxiter=250, maxinner=32)
# config -> robot, restarts, TR budget (maxinner None: N d), LM polish steps
# (None: the solver's default 30), smoothing squarings (None: full), seed,
# and the JAX half's TR backend where it is not the Pallas kernel
CONFIGS = {
    "ur10_table": dict(TABLE, robot="ur10_table", restarts=0, seed=7),
    "ur10": dict(BENCH, robot="ur10", restarts=0, seed=2026),
    "kuka_iiwa": dict(BENCH, robot="kuka_iiwa", restarts=0, seed=41),
    "lwa4d": dict(BENCH, robot="lwa4d", restarts=0, seed=42),
    "planar6": dict(BENCH, robot="planar6", restarts=0, seed=43, backend="edge"),
    "planar10": dict(BENCH, robot="planar10", restarts=0, seed=44, backend="edge"),
    "planar10_ring6": dict(TABLE, robot="planar10_ring6", restarts=0, seed=54, backend="edge"),
    "planar40": dict(BENCH, robot="planar40", restarts=0, seed=55, backend="edge", smooth=None),
    "dh19": dict(BENCH, robot="dh19", restarts=0, seed=56, backend="edge", smooth=None),
    "planar40_smooth2": dict(BENCH, robot="planar40", restarts=0, seed=55, backend="edge",
                             shared_start=True),
    "dh19_smooth2": dict(BENCH, robot="dh19", restarts=0, seed=56, backend="edge",
                         shared_start=True),
    # planar40 with its Y0 saved and perturbed: every goal has its own start,
    # so the verdict stays planar40's single-init test; the perturbed counts
    # of both halves show how far one start's count moves
    "planar40_perturbed": dict(BENCH, robot="planar40", restarts=0, seed=55, backend="edge",
                               smooth=None, shared_start=True),
    "ur10_table192": dict(BENCH, robot="ur10_table192", restarts=0, seed=57),
    "planar100": dict(BENCH, robot="planar100", restarts=0, seed=58, backend="edge", smooth=None),
    "dh40": dict(BENCH, robot="dh40", restarts=0, seed=59, backend="edge", smooth=None),
    # dh40 with its Y0 saved and perturbed, as planar40_perturbed
    "dh40_perturbed": dict(BENCH, robot="dh40", restarts=0, seed=59, backend="edge",
                           smooth=None, shared_start=True),
    "ur10_restarts4": dict(BENCH, robot="ur10", restarts=4, seed=45),
    "ur10_table_restarts2": dict(TABLE, robot="ur10_table", restarts=2, seed=46),
    "planar6_restarts2": dict(BENCH, robot="planar6", restarts=2, seed=47, backend="edge"),
    "planar10_restarts2": dict(BENCH, robot="planar10", restarts=2, seed=48, backend="edge"),
    "tree_restarts3": dict(robot="tree", restarts=3, seed=49, maxiter=300, maxinner=None,
                           polish=None, smooth=None),
    # dense CIDGIK at the bench's parameters (bench.py:391-393,526-539)
    "ur10_cidgik": dict(robot="ur10", restarts=0, seed=50,
                        cidgik=dict(admm_iters=700, admm_iters_rest=300)),
    "ur10_table_cidgik": dict(robot="ur10_table", restarts=0, seed=51, cidgik={}),
    # sparse CIDGIK at the bench's parameters (bench.py:398-400,518-524)
    "ur10_cidgik_sparse": dict(robot="ur10", restarts=0, seed=52, sparse=True,
                               cidgik=dict(admm_iters=700, admm_iters_rest=300)),
    # UR10's production path with the solver switched to CG (its dense backend)
    "ur10_cg": dict(BENCH, robot="ur10", restarts=0, seed=53, cg=True, backend="dense"),
    # the TR's XLA backends on both halves (the port's TRParams.backend too)
    "ur10_f64_dense": dict(BENCH, robot="ur10", restarts=0, seed=2026, backend="dense",
                           port_backend="dense", dtype="float64"),
    "planar10_edge": dict(BENCH, robot="planar10", restarts=0, seed=44, backend="edge",
                          port_backend="edge"),
}


def dh_template(templates, n=19):
    """The n-DoF DH chain dh<n> (dh19, dh40) from either package's templates
    module: a ~ U(0.1, 0.5), d ~ U(0, 0.3), alpha from {-pi/2, 0, pi/2},
    drawn in that order from RandomState(n); theta = 0, joint limits
    +-pi/2."""
    rs = np.random.RandomState(n)
    a = rs.uniform(0.1, 0.5, n)
    d = rs.uniform(0.0, 0.3, n)
    alpha = rs.choice([-np.pi / 2, 0.0, np.pi / 2], n)
    return templates.revolute_from_dh(a, alpha, d, np.zeros(n), lb=-np.pi / 2, ub=np.pi / 2)


def structure(robot, library, ProblemStructure, table_environment, tree):
    """The config's ProblemStructure, from either package's modules (they
    share the names); `tree` makes the tree's. The ring of circles is the
    port's numpy list, handed to either package's structure."""
    if robot in ("ur10", "ur10_table", "ur10_table192"):
        tpl = library.load_ur10()[0]
        obstacles = {"ur10": None, "ur10_table": table_environment(),
                     "ur10_table192": table_environment(n_width=12, n_height=12)}[robot]
        return ProblemStructure.from_template(tpl, obstacles=obstacles)
    if robot in ("dh19", "dh40"):
        templates = importlib.import_module(f"{library.__package__}.templates")
        return ProblemStructure.from_template(dh_template(templates, int(robot[2:])))
    if robot == "kuka_iiwa":
        return library.load_kuka()[1]
    if robot == "lwa4d":
        return library.load_schunk_lwa4d()[1]
    if robot in ("planar6", "planar10", "planar40", "planar100"):
        return library.load_planar_chain(int(robot[6:]), limits=np.pi / 2)[1]
    if robot == "planar10_ring6":
        from graphik_tpu_torch.utils.environments import ring_environment

        tpl = library.load_planar_chain(10, limits=np.pi / 2)[0]
        return ProblemStructure.from_template(tpl, obstacles=ring_environment())
    if robot == "tree":
        return tree()
    raise ValueError(robot)


def wilson95(n, k):
    """Wilson score 95% interval of k successes in n trials."""
    z = 1.959963984540054
    p = k / n
    den = 1 + z * z / n
    centre = p + z * z / (2 * n)
    rad = z * math.sqrt((p * (1 - p) + z * z / (4 * n)) / n)
    return (centre - rad) / den, (centre + rad) / den


def two_sample_limit(n, k_a, k_b):
    """1.96 sqrt(2 n p (1 - p)), p the pooled rate: the 95% limit on the
    difference of two success counts over n goals each."""
    p = (k_a + k_b) / (2 * n)
    return 1.96 * math.sqrt(2 * n * p * (1 - p))


def permutation_p(a, b, resamples=PERM_RESAMPLES, seed=PERM_SEED):
    """Two-sided permutation p-value of the difference in means of the
    samples a and b: the share of `resamples` random relabellings of the
    pooled values (numpy RandomState(seed)) whose |mean difference| reaches
    the observed one, counting the observed labelling, (hits + 1) /
    (resamples + 1)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    pooled = np.concatenate([a, b])
    observed = abs(a.mean() - b.mean())
    order = np.argsort(np.random.RandomState(seed).random_sample((resamples, pooled.size)), 1)
    draws = pooled[order]
    diff = np.abs(draws[:, :a.size].mean(1) - draws[:, a.size:].mean(1))
    # relabellings whose difference equals the observed one count as hits:
    # a tolerance absorbs the means' rounding
    hits = int((diff >= observed - 1e-9 * max(1.0, observed)).sum())
    return (hits + 1) / (resamples + 1)


def shared_start_verdict(jax_stats, port_spread, port_counts, n, k_jax, k_port):
    """The verdict of a shared-start config: (passes, record). When the
    JAX half's saved Y0 and the port's own Y0 each have zero spread over
    the goals (goal-independent) and each half has at least PERTURBED_MIN
    perturbed counts, the permutation test of their means at PERM_ALPHA;
    else the single-init test, the port's own-start count inside JAX's
    Wilson interval. The own-start counts are reported either way."""
    jax_counts = list(jax_stats.get("init_noise_counts", []))
    independent = jax_stats.get("Y0_spread_over_goals") == 0.0 and port_spread == 0.0
    lo, hi = wilson95(n, k_jax)
    inside = lo <= k_port / n <= hi
    record = {"goal_independent_start": independent,
              "own_start": {"jax": k_jax, "port": k_port, "jax_wilson95": [lo, hi],
                            "port_inside_jax_interval": inside,
                            "note": "one draw of the shared start" if independent else
                            "the single-init verdict"}}
    if not (independent and min(len(jax_counts), len(port_counts)) >= PERTURBED_MIN):
        record["verdict"] = "single init"
        return inside, record
    p = permutation_p(jax_counts, port_counts)
    record.update(verdict="perturbed starts", jax_mean=float(np.mean(jax_counts)),
                  port_mean=float(np.mean(port_counts)), permutation_p=p, alpha=PERM_ALPHA,
                  resamples=PERM_RESAMPLES, port_agrees=p >= PERM_ALPHA)
    return p >= PERM_ALPHA, record


def cidgik_path(api, cidgik, ps, T_goal, overrides, stage=lambda f: f, sparse=None):
    """The bench's CIDGIK path in either package (their functions share
    names and signatures): solve_cidgik (with `sparse`, the package's
    cidgik_sparse module: solve_cidgik_sparse) at CidgikParams.production(
    **overrides), then the finish stage - the raw pose error,
    check_distance_limits of the realization, and polish_solution's 30-step
    LM. `stage` wraps each of the two stages (jax.jit for JAX). Returns
    numpy (e_pos0, e_rot0, e_pos, e_rot, ok, eig_sum, feas)."""
    params = cidgik.CidgikParams.production(**overrides)
    if sparse is None:
        comp = cidgik.compile_cidgik(ps)
        solve = cidgik.solve_cidgik
    else:
        comp = sparse.compile_cidgik_sparse(ps)
        solve = sparse.solve_cidgik_sparse

    def admm(Tg):
        out = solve(comp, Tg, params=params)
        return out["q"], out["eig_sum"], out["feas"]

    def finish(q0, Tg):
        e_pos0, e_rot0 = api.pose_error(ps, q0, Tg)
        viol, ok = ps.check_distance_limits(ps.realization(q0))
        _, e_pos, e_rot, _, ok = api.polish_solution(ps, q0, Tg, e_pos0, e_rot0, viol, ok)
        return e_pos0, e_rot0, e_pos, e_rot, ok

    q0, eig, feas = stage(admm)(T_goal)
    out = stage(finish)(q0, T_goal) + (eig, feas)
    return tuple(np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in out)


def cidgik_summary(out):
    """Per-goal success (1 mm / 1 deg, limit- and obstacle-feasible) and the
    raw-ADMM rate at 1 cm, median |eig_sum| and median feas."""
    e_pos0, e_rot0, e_pos, e_rot, ok, eig, feas = out
    success = (e_pos < CRIT_POS) & (e_rot < CRIT_ROT) & ok
    raw = float(((e_pos0 < 1e-2) & (e_rot0 < 1e-2)).mean())
    return success, {"raw_admm_rate_1cm": raw, "median_eig_sum": float(np.median(np.abs(eig))),
                     "median_feas": float(np.median(feas))}


def solver_kwargs(cfg, TRParams, LocalParams, CGParams):
    if cfg.get("cg"):
        kw = dict(params=CGParams.production())
    else:
        kw = dict(params=TRParams.production(maxiter=cfg["maxiter"], maxinner=cfg["maxinner"]))
    if cfg["polish"] is not None:
        kw["polish_params"] = LocalParams(maxiter=cfg["polish"], tol_grad=1e-8)
    if cfg["smooth"] is not None:
        kw["smooth_iters"] = cfg["smooth"]
    return kw


def init_noise(k, shape):
    """The k-th perturbation factor of a shared start, 1 + 1e-6 g, g ~ N(0,
    1) of `shape` from RandomState(k), as float32."""
    g = np.random.RandomState(k).standard_normal(shape)
    return (1.0 + 1e-6 * g).astype(np.float32)


def jax_from_init(api, ps, riemannian, kw, dtype):
    """The JAX package's make_solver stages (graphik_tpu/api.py) for a
    structure without obstacles, split so that a solve can start from a
    given Y0: (prepare(T) -> (D_goal, Y0), success(Y0, D_goal, T) ->
    per-goal success)."""
    import jax
    import jax.numpy as jnp

    omega, psi_L, psi_U = ps.masks()

    @jax.jit
    def prepare(T_goal):
        with jax.default_matmul_precision("highest"):
            inst = ps.instance(T_goal, dtype=dtype, smooth=True,
                               smooth_iters=kw.get("smooth_iters"))
            Y0 = riemannian.generate_initialization(inst["lb"], inst["ub"],
                                                    jnp.asarray(omega), ps.dim)
            return inst["D_goal"], Y0

    @jax.jit
    def success(Y0, D_goal, T_goal):
        with jax.default_matmul_precision("highest"):
            sol = api.solve_reduced(ps, Y0, D_goal, omega, psi_L, psi_U, params=kw["params"])
            q = ps.joint_variables(sol["Y"], T_goal)
            viol, ok = ps.check_distance_limits(ps.realization(q), tol=1e-6)
            e_pos, e_rot = api.pose_error(ps, q, T_goal)
            _, e_pos, e_rot, _, ok = api.polish_solution(ps, q, T_goal, e_pos, e_rot, viol, ok,
                                                         limit_tol=1e-6,
                                                         params=kw.get("polish_params"))
            return (e_pos < CRIT_POS) & (e_rot < CRIT_ROT) & ok

    return prepare, success


def run_jax(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    cfg = CONFIGS[args.config]
    dtype = cfg.get("dtype", "float32")
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from graphik_tpu import api
    from graphik_tpu.graphs.problem import ProblemStructure
    from graphik_tpu.parallel.mesh import make_restart_solver
    from graphik_tpu.robots import kinematics, library
    from graphik_tpu.solvers.local import LocalParams
    from graphik_tpu.solvers.riemannian import CGParams, TRParams
    from graphik_tpu.utils.environments import table_environment

    seed = cfg["seed"] if args.seed is None else args.seed
    from tests.test_trees import tree_template

    ps = structure(cfg["robot"], library, ProblemStructure, table_environment,
                   lambda: ProblemStructure.from_template(tree_template()))
    tpl = ps.template
    q = np.random.RandomState(seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(args.n, tpl.n))
    T_goal = np.asarray(kinematics.all_poses(tpl, jnp.asarray(q))[:, tpl.ee], dtype)
    t0 = time.perf_counter()
    arrays, extra = {}, {}
    if "cidgik" in cfg:
        from graphik_tpu.solvers import cidgik, cidgik_sparse

        backend = "cidgik"
        out = cidgik_path(api, cidgik, ps, jnp.asarray(T_goal), cfg["cidgik"], stage=jax.jit,
                          sparse=cidgik_sparse if cfg.get("sparse") else None)
        outs = [dict(zip(("e_pos", "e_rot", "success"), out[2:5]))]
        extra = cidgik_summary(out)[1]
    else:
        kw = solver_kwargs(cfg, TRParams, LocalParams, CGParams)
        backend = args.backend or cfg.get("backend", "pallas")
        kw["params"] = dataclasses.replace(kw["params"], backend=backend)
    if cfg["restarts"]:
        R = cfg["restarts"]
        solver = make_restart_solver(ps, n_restarts=R, dtype=jnp.float32, **kw)
        outs = [solver(jnp.asarray(T_goal), jax.random.PRNGKey(RESTART_SEED + i))
                for i in range(args.draws)]
        # the fractions generate_initialization drew: restart r of draw i
        # samples from split(key_i, R)[r], one value per entry of lb
        M = ps.N if ps.reduced_spec() is None else ps.reduced_spec()["Nr"]
        arrays["fracs"] = np.stack([np.stack([
            np.asarray(jax.random.uniform(k, (args.n, M, M), dtype=jnp.float32))
            for k in jax.random.split(jax.random.PRNGKey(RESTART_SEED + i), R)[1:]])
            for i in range(min(REPLAY_DRAWS, args.draws))])  # (draws, R - 1, n, M, M)
    elif "cidgik" not in cfg:
        outs = [api.make_solver(ps, dtype=getattr(jnp, dtype), **kw)(jnp.asarray(T_goal))]
    outs = jax.block_until_ready(outs)
    wall = time.perf_counter() - t0
    if cfg.get("shared_start"):
        from graphik_tpu.solvers import riemannian

        prepare, success = jax_from_init(api, ps, riemannian, kw, getattr(jnp, dtype))
        D_goal, Y0 = prepare(jnp.asarray(T_goal))
        arrays["Y0"] = np.asarray(Y0)
        extra["Y0_spread_over_goals"] = float(np.abs(arrays["Y0"] - arrays["Y0"][:1]).max())
        extra["Y0_max_abs"] = float(np.abs(arrays["Y0"]).max())
        counts = [int(np.asarray(success(Y0 * jnp.asarray(init_noise(k, Y0.shape[-2:])),
                                         D_goal, jnp.asarray(T_goal))).sum())
                  for k in range(args.init_noise)]
        if counts:
            extra["init_noise_counts"] = counts
    e_pos = np.stack([np.asarray(o["e_pos"]) for o in outs])
    e_rot = np.stack([np.asarray(o["e_rot"]) for o in outs])
    ok = (e_pos < CRIT_POS) & (e_rot < CRIT_ROT) & np.stack([np.asarray(o["success"])
                                                             for o in outs])
    if not cfg["restarts"]:
        ok, e_pos, e_rot = ok[0], e_pos[0], e_rot[0]
    path = args.out or f"build/parity/{args.config}.npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, T_goal=T_goal, q_goal=q, seed=seed, config=args.config, backend=backend,
             success=ok, e_pos=e_pos, e_rot=e_rot, jax_stats=json.dumps(extra), **arrays)
    lo, hi = wilson95(ok.size, int(ok.sum()))
    print(json.dumps({"half": "jax", "config": args.config, "device": jax.default_backend(),
                      "backend": backend, "n": ok.size, "seed": seed, "success": int(ok.sum()),
                      "per_draw": ok.reshape(-1, args.n).sum(1).tolist(),
                      "wilson95": [lo, hi], "floor": lo - 0.02, "wall_s": wall, "out": path,
                      **extra}))
    return 0


def ok_of(out):
    """Per-goal success of a port result, as a numpy bool array."""
    return ((out["e_pos"] < CRIT_POS) & (out["e_rot"] < CRIT_ROT) & out["success"]).cpu().numpy()


def run_torch(args):
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda
    from graphik_tpu_torch.parallel.mesh import make_restart_solver
    from graphik_tpu_torch.robots import library
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import CGParams, TRParams
    from graphik_tpu_torch.utils.environments import table_environment

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_parity: no CUDA device (pass --device cpu for the plain version)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = np.load(args.goals)
    config = str(ref["config"]) if "config" in ref else "ur10_table"
    cfg = CONFIGS[config]
    ps = structure(cfg["robot"], library, ProblemStructure, table_environment,
                   lambda: library.load_tree5()[1])
    dtype = getattr(torch, cfg.get("dtype", "float32"))
    T_goal = torch.as_tensor(ref["T_goal"], dtype=dtype, device=dev)
    ok_j = ref["success"].astype(bool)
    launches = solve_tr_cuda.launches
    t0 = time.perf_counter()
    stats, iters = {}, None
    if "cidgik" in cfg:
        from graphik_tpu_torch.solvers import cidgik, cidgik_sparse

        ok_c, port_stats = cidgik_summary(cidgik_path(
            api, cidgik, ps, T_goal, cfg["cidgik"],
            sparse=cidgik_sparse if cfg.get("sparse") else None))
        stats = {"jax_stats": json.loads(str(ref["jax_stats"])), "port_stats": port_stats}
        oks = [ok_c]
    else:
        kw = solver_kwargs(cfg, TRParams, LocalParams, CGParams)
        if "port_backend" in cfg:
            kw["params"] = dataclasses.replace(kw["params"], backend=cfg["port_backend"])
        if cfg["restarts"]:
            solver = make_restart_solver(ps, n_restarts=cfg["restarts"], device=dev, **kw)
            outs = [solver(T_goal, torch.Generator(device=dev).manual_seed(RESTART_SEED + i))
                    for i in range(len(ok_j))]
        else:
            solver = api.make_solver(ps, device=dev, dtype=dtype, **kw)
            outs = [solver(T_goal)]
        oks = [ok_of(o) for o in outs]
        iters = float(torch.stack([o["iterations"] for o in outs]).double().mean())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = solve_tr_cuda.launches - launches
    ok_t = np.stack(oks).reshape(ok_j.shape)
    replay = {}
    if "Y0" in ref:  # a shared start: the JAX half's own Y0, then perturbed ones
        D_goal, Y0 = solver.prepare(T_goal)

        def count(Y):
            return ok_of(solver.finish(solver.solve(Y.contiguous(), D_goal), T_goal))

        ok_r = count(torch.as_tensor(ref["Y0"], device=dev))
        jax_stats = json.loads(str(ref["jax_stats"]))
        K = len(jax_stats.get("init_noise_counts", []))
        port_counts = [
            int(count(Y0 * torch.as_tensor(init_noise(k, Y0.shape[-2:]), device=dev)).sum())
            for k in range(K)]
        # the same K perturbations of JAX's Y0: the JAX half's starts
        Y0_j = torch.as_tensor(ref["Y0"], device=dev)
        counts_from_jax = [
            int(count(Y0_j * torch.as_tensor(init_noise(k, Y0.shape[-2:]), device=dev)).sum())
            for k in range(K)]
        port_spread = float((Y0 - Y0[:1]).abs().max())
        replay = {"replay_init": {
            "port_success": int(ok_r.sum()), "both": int((ok_j & ok_r).sum()),
            "port_only": int((ok_r & ~ok_j).sum()), "jax_only": int((ok_j & ~ok_r).sum()),
            "port_Y0_spread_over_goals": port_spread,
            "port_Y0_max_abs": float(Y0.abs().max()), "jax": jax_stats,
            "port_init_noise_counts": port_counts,
            "port_counts_from_jax_starts": counts_from_jax}}
    if "fracs" in ref:  # the JAX half's own inits, draw by draw
        ok_r = np.stack([ok_of(solver(T_goal, fracs=torch.as_tensor(f, device=dev)))
                         for f in ref["fracs"]])
        ok_jr = ok_j[:len(ok_r)]
        replay = {"replay": {
            "draws": len(ok_r), "jax_per_draw": ok_jr.sum(1).tolist(),
            "port_per_draw": ok_r.sum(1).tolist(), "both": int((ok_jr & ok_r).sum()),
            "port_only": int((ok_r & ~ok_jr).sum()), "jax_only": int((ok_jr & ~ok_r).sum())}}
    n, k_j, k_t = ok_j.size, int(ok_j.sum()), int(ok_t.sum())
    lo, hi = wilson95(n, k_j)
    if cfg["restarts"]:
        limit = two_sample_limit(n, k_j, k_t)
        agree = abs(k_t - k_j) <= limit
        test = {"two_sample_limit": limit, "port_within_limit": agree}
    elif "Y0" in ref:
        agree, test = shared_start_verdict(jax_stats, port_spread, port_counts, n, k_j, k_t)
    else:
        agree = lo <= k_t / n <= hi
        test = {"port_inside_jax_interval": agree}
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "half": "torch", "config": config, "device": device, "n": n,
        "seed": int(ref["seed"]), "restarts": cfg["restarts"],
        "jax_success": k_j, "jax_wilson95": [lo, hi], "port_success": k_t,
        "jax_per_draw": ok_j.reshape(len(oks), -1).sum(1).tolist(),
        "port_per_draw": ok_t.reshape(len(oks), -1).sum(1).tolist(),
        "both": int((ok_j & ok_t).sum()), "port_only": int((ok_t & ~ok_j).sum()),
        "jax_only": int((ok_j & ~ok_t).sum()),
        "port_mean_iterations": iters,
        "kernel_launches": launches, "wall_s": wall, **test,
        **replay, **stats,
    }))
    return 0 if agree else 1


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="half", required=True)
    pj = sub.add_parser("jax", help="make goals and solve them with the JAX package (CPU)")
    pj.add_argument("--config", choices=sorted(CONFIGS), default="ur10_table")
    pj.add_argument("--n", type=int, default=1000)
    pj.add_argument("--seed", type=int, default=None, help="default: the config's")
    pj.add_argument("--out", default=None, help="default: build/parity/<config>.npz")
    pj.add_argument("--draws", type=int, default=RESTART_DRAWS,
                    help="restart configurations: solves of the goals, one restart key each")
    pj.add_argument("--backend", choices=["pallas", "edge", "dense"], default=None,
                    help="the JAX package's TR backend (default: the config's)")
    pj.add_argument("--init-noise", type=int, default=0,
                    help="shared-start configurations: solves from K perturbed inits")
    pt = sub.add_parser("torch", help="solve the saved goals with the port")
    pt.add_argument("--goals", default="build/parity/ur10_table.npz")
    pt.add_argument("--device", default="cuda")
    args = p.parse_args()
    return run_jax(args) if args.half == "jax" else run_torch(args)


if __name__ == "__main__":
    sys.exit(main())
