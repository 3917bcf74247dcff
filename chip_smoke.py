#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an exception):
  0. card name and power limit (nvidia-smi), torch and CUDA versions;
  1. build the CUDA kernels from graphik_tpu_torch/csrc (one nvcc per
     source, sm_90a) and print each kernel's registers, shared memory and
     spills;
  2. the TR kernel (anchor-free, two instances per warp) vs its plain
     torch version on the card, UR10, B = 1000 (a ragged last block): one
     TR step (cost rtol 2e-5 / atol 1e-6, Y atol 1e-4, num_inner equal),
     then the production params: every lane's outputs bitwise equal
     (1000/1000), all finite;
  3. the UR10 path - api.make_solver (the compiled solver: prepare, solve
     and finish as CUDA graphs, utils/compiled.py) on UR10 at B = 8192 with
     TRParams.production(maxiter=100, maxinner=24), a 10-step LM polish and
     2-squaring bound smoothing: the first call (warm-up and capture, its
     stage walls logged), then 3 timed calls (replays) with per-stage
     walls; success >= 0.85 (1 mm / 1 deg, limit-feasible), all
     outputs finite, the TR kernel launched on every call and K5 twice
     (prepare's two eigendecompositions), inside the graphs; plus a 64-goal
     batch on the card against the same solver on the CPU (plain version);
  4. the TR kernel's and its plain version's times at the UR10 path's
     shapes (CUDA events);
  5. the anchored TR kernel vs its plain version on the table scene's
     reduced problem (16 nodes, 624 anchor rows), B = 1000, inputs from
     Solver.prepare: one step bitwise equal (and from world-frame starts,
     where the hinges are active), then maxiter=100, maxinner=32 with the
     plateau stop: every lane's outputs bitwise equal (1000/1000); times;
  6. the table path - make_solver on UR10 + the 100-sphere table at
     B = 8192 with TRParams.production(maxiter=250, maxinner=32): one warm
     call, 3 timed calls with per-stage walls and the prepare stage's peak
     memory; the anchored kernel launched once per call (K5 twice);
     success >= 0.78
     on each call; every successful lane keeps p1..p6 at least
     radius - 1e-3 from every center; outputs finite, of the right shapes;
     one anchored TR step bitwise equal to the plain version at B = 8192,
     then the kernel's time there; a 64-goal batch on the card against
     the same solver on the CPU;
  7. the edge kernels K1 (cost+grad) and K2 (Hessian-vector product),
     which no path launches (`edge_phase`): bitwise equal to their
     kernel-order plain versions (ops/edge.py cost_and_egrad_kernel_order,
     ehess_kernel_order) on 1000 goals prepared for UR10, planar6,
     planar10, KUKA iiwa and the tree, at B = 8192 on the Y the UR10 path
     hands to the solve and a seeded Z, where torch's own order
     (cost_and_egrad, ehess) is held to f rtol 1e-5, g and H max abs error
     <= 1e-4 x max |plain|, and at B = 8192 on planar40's and dh19's
     prepared inputs (N = 43 / 42: two node slots a lane, csrc/edge_wide.cu),
     each shape's two instances free of spills in the build's ptxas log;
     each kernel's device time (profiler, the L2 flushed by a 256 MB read
     before each launch) and call time (CUDA events over 100 back-to-back
     calls) at B = 8192 and 131,072 (the UR10 inputs repeated: 84 MB and
     109 MB, past the L2) and on planar40's and dh19's inputs at B = 8192,
     beside its bounds and its plain version's time;
  8. the other robots of the bench - planar6 and planar10
     (load_planar_chain(n, limits=pi/2)), KUKA iiwa and LWA4D - each with
     the UR10 path's parameters: the TR kernel vs its plain version on the
     robot's prepared inputs at B = 1000 (one step, then the production
     params, every lane bitwise equal), its launch shape (two instances per
     warp for the planar chains, one for the 18-node arms), make_solver at
     B = 8192 (one warm call, 2 timed calls with per-stage walls, one
     launch a call, success at or above the floor), the kernel's time;
  9. the restart paths (parallel.make_restart_solver, R restarts of
     B / R goals folded into one batch of 8192): ur10_restarts4,
     ur10_table_restarts2 (production(250, 32)), planar6_restarts2 and
     planar10_restarts2; one warm and 2 timed calls, one TR launch a call
     (anchored on the table), success at or above the floor and at least
     the single-init solver's on the same goals less 0.005;
 10. the two-end-effector tree (robots.library.load_tree5) with 3
     restarts and production(maxiter=300) on 1000 goals: the TR kernel vs
     its plain version on the path's prepared 3000 instances (one step,
     then the path's parameters, every lane bitwise equal), then both end
     effectors reached at or above the floor;
 11. dense CIDGIK on UR10 (ur10_cidgik): solvers/cidgik.solve_cidgik at
     B = 1024 with CidgikParams.production(admm_iters=700,
     admm_iters_rest=300), then the bench's finish (pose error, limits,
     30-step LM polish); none of K1-K4. Compiled - the ADMM's
     50-step pieces as CUDA graphs of the template (compiled.Loop), the
     finish through a StageGraphs, as bench.py jits stage_finish - against
     eager (compiled.eager_loops(), the finish eager) on the same goals:
     the first compiled call (warm-up + capture), then for each form the
     kernel launches, host launches and device-busy share of each stage
     from one profiled call and the ADMM and finish walls of one timed
     call, every output bitwise equal, ADMM steps and host reads equal;
     success at or above the floor, the raw-ADMM rate at 1 cm, median
     |eig_sum| and feas, finite outputs of the right shapes, the graph
     pools' memory; a 16-goal batch on the card
     against the same call on the CPU (ADMM (200, 2 x 100)): status equal,
     eig_sum and feas within EIG_TOL and FEAS_TOL, points within 1e-3 on at
     least 15 lanes;
 12. the same on UR10 + the table (ur10_table_cidgik), B = 512,
     CidgikParams.production(), and every successful lane's p1..p6 at
     least radius - 1e-3 from every center;
 13. sparse (chordal) CIDGIK on UR10 (ur10_cidgik_sparse):
     solvers/cidgik_sparse.solve_cidgik_sparse at B = 1024 with
     production(700, 300), then the bench's finish, as phase 11 but with
     eig_sum held per lane to sparse_eig_bound; and K5 on the card on the
     path's stacked clique blocks (the middle block zero-padded): bitwise
     its plain version, against the CPU's float64 eigenvalues within 1e-5
     x each block's norm. Phases 11-13 run the Fantope step on K5 once a
     round; phase 11 also runs the ADMM with the eigh cone projection
     (cone_ns_iters = 0, K5 every step) at B = 64, compiled against eager
     (`eigh_cone_check`): bitwise, its pieces captured, then replayed;
 14. Riemannian conjugate gradient on UR10 (ur10_cg): make_solver with
     CGParams.production() at B = 8192, the UR10 path's polish and
     smoothing; compiled (the loop's pieces between host reads and the
     finish as CUDA graphs) against the same solver eager on the same
     prepared inputs (`compiled_vs_eager`): the first compiled call
     (warm-up + capture), then for each form the solve's launches, host
     launches and device-busy share from one profiled call and one timed
     solve and finish, every output bitwise equal, host reads equal;
     success at or above the floor, no TR kernel launched, the graph
     pools' memory, and 64 goals on the card against the CPU: solve_cg from the
     same Y0 at float64 (20 iterations) and float32 (5), iterations equal
     per lane and Y and cost within CG_TOL64 / CG_TOL32, then the whole
     solver's success counts;
 15. planar10_ring6 (load_planar_chain(10, limits=pi/2) and the six circles
     of utils/environments.py ring_environment): the anchored TR kernel's
     <2, 2, 16, true> instance against its plain version on the path's
     prepared inputs at B = 1000 (one step, then production(250, 32): every
     lane bitwise equal), its launch shape, registers and spills;
     make_solver at B = 8192 with production(250, 32), the 10-step polish
     and 2-squaring smoothing: one warm and 2 timed calls with per-stage
     walls, one anchored launch a call, success at or above the floor,
     every successful lane's p1..p10 at least radius - 1e-3 from every
     centre; the kernel's time and bound; 64 goals on the card against
     the CPU;
 16. the data-parallel solve on the card: parallel.solve_ik_sharded on
     UR10 at B = 8191 with the main path's parameters over make_mesh() and
     over [cuda:0, cuda:0] (two shards, one padded), each against the
     unsharded solver lane for lane (q within rtol 1e-3 / atol 1e-4,
     success equal), one TR launch a shard, walls beside the unsharded
     one's; parallel.distributed.solve_ik_global at world size 1 over NCCL
     (its metrics equal to summarize of its own solve); and
     dryrun_multigpu over every card;
 17. the trust region's "dense" and "edge" backends (`tr_backends_phase`;
     none of K1-K4 launched on any of them), each compiled (the
     loop's pieces between host reads and the finish as CUDA graphs)
     against the same solver eager on the same prepared inputs
     (`compiled_vs_eager`: every output bitwise equal, host reads equal,
     walls, graph pools): make_solver on UR10 at float64 (its "kernel"
     runs "dense") at B = 8192 with the UR10 path's parameters, with the
     launches, host launches and device-busy share of each form's solve
     from one profiled call, then 2 compiled calls with per-stage walls,
     success >= 0.85, float64 finite outputs; 64 goals on the card against the CPU (one
     iteration from the same Y0: inner steps equal, Y within 1e-12; then
     the whole solver: per-goal success equal on >= 61); the table at
     float64 on "dense", B = 4096, production(250, 32): success >= 0.78,
     every successful lane clear of every sphere (radius - 1e-3); planar10
     at float32 on "edge", B = 1024: success within 0.03 of the kernel
     path's on the same goals.

 18. the compiled solver against the eager stages (`compiled_phase`): for
     each f32 kernel path above (UR10, ur10_table, planar6, planar10, KUKA
     iiwa, LWA4D, the four restart configurations, tree_restarts3,
     planar10_ring6, planar40, dh19, ur10_table192; the solvers of phases
     3, 6, 8-10, 15 and 20, which ran compiled there) the same solver with every stage eager
     (api.solve_ik's) on the same prepared inputs at the path's batch:
     every output of the solve and the finish bitwise equal; per-stage
     walls compiled and eager; the finish's host launches, device
     activities and busy share (one profiled call each); the first call's
     walls (warm-up + capture); the memory the graphs' pools hold and each
     finish's peak; and for each of those paths and ur10_f64 (phase 17)
     the compiled prepare against the eager prepare on the same goals and
     generator state (`prepare_vs_eager`): D_goal and Y0 bitwise equal,
     both walls, K5's two launches a call counted inside the graph, the
     host launches of one replayed prepare. Then batch-position invariance
     (`position_check`) at each path's batch: for every single-init path
     of these (a restart path draws its sampled fractions by position), one
     goal copied to every position must give bitwise one D_goal, Y0 and
     output of the solve and finish at every position, and the stack in
     reverse order each goal's forward outputs bitwise; the same on the
     graphed-loop paths ur10_cidgik and ur10_cidgik_sparse (B = 1024),
     ur10_cg and ur10_f64 (8192) and planar10_edge (1024), from phases 11,
     13, 14 and 17 (ur10_table_cidgik and ur10_table_f64 are left out: a
     call takes 3-9 s).
 19. K5, the eigendecomposition (`eigh_phase`, run after phase 2, before
     the paths): on the card, against its plain version bitwise, every
     matrix, with every converged flag set, the residual and orthogonality
     under EIGH_RES and the eigenvalues within EIGH_EIG of torch.linalg.eigh
     (both past n = 64 in proportion to n)
     on the card: UR10's prepare Gram and edge scatter at B = 8192 (float32
     and float64), planar6, planar10, KUKA iiwa, the tree and the table's
     Nr = 16 at B = 1000, dense CIDGIK's lifted Z (s = 13) and the sparse
     path's padded clique blocks at B = 1024 (float32 and float64), and
     seeded random matrices at n = 2, 3, 31, 32, 42, 43, 64 (past 32 the
     wide instances, csrc/eigh_wide.cuh), 84, 103, 128 (past 64 the block
     kernel, csrc/eigh_block.cu; B = 300) and with equal diagonals at n =
     13, and
     each path's matrices at the batch it launches (`eigh_path_inputs`:
     UR10, planar6, planar10, KUKA iiwa, planar40 (n = 43), dh19 (n = 42),
     planar100 (n = 103), dh40 (n = 84) at B = 8192, the tree's 3 x 1000,
     CIDGIK's Fantope inputs at B = 1024; float32 and float64; past n = 64
     torch.linalg.eigh's eigenvalues and time on the first EIGH_LIB_B
     matrices, the time scaled to the batch); UR10's first 501
     Grams bitwise the same alone; K5's, torch.linalg.eigh's and the plain
     version's times at UR10's shape beside the bound, K5's on the first
     1024-8192 of UR10's and planar40's Grams (occupancy), and K5's and
     torch.linalg.eigh's on each path's matrices beside their bounds, past
     n = 32 with the mean sweeps a matrix (the plain version's) and, in the log
     only, the Jacobi's own operation count (`jacobi_ms`).
 20. robots past 32 nodes and anchor rows past 1024 (run after phase 17,
     before phase 18; `large_structures`): planar40 (N = 43, d = 2, E = 89:
     the TR kernel at two nodes a lane, 3 edges a lane), dh19 (a 19-DoF DH
     chain, N = 42, E = 126: two nodes a lane, 4 edges a lane), both with
     full bound smoothing, and ur10_table192 (UR10 + a 192-sphere table:
     A = 1152 anchor rows), and past 64 nodes planar100 (N = 103, d = 2, E
     = 209: four nodes a lane, 7 edges a lane) and dh40 (a 40-DoF DH chain,
     N = 84, d = 3, E = 272: four nodes a lane, 9 edges a lane) with full
     bound smoothing, each with the UR10 path's other parameters: the
     kernel instance's registers and spills; the TR kernel against its plain version on the path's
     prepared inputs at B = 1000 (one step, then the production params'
     100 steps, every lane bitwise equal) and one step at
     B = 8192; make_solver at B = 8192 (one warm call, 2 timed calls with
     per-stage walls, one launch a call, K5 twice, success at or above the
     floor); the kernel's time beside its bound. Phase 18 holds each
     compiled solver to its eager stages. Then planar40 at the UR10 path's
     two squarings (every goal starts from one goal-independent Y0) at
     B = 8192, compiled: one goal at every position, and the stack
     reversed, as phase 18 checks the other paths.

 21. K6, the LM polish's clamped-pivot SPD solve (`spd_phase`, run after
     phase 19, before the paths): on the card, against its plain version
     bitwise (NaN where the plain version has NaN) on each path's LM
     systems at the batch its polish hands K6 (`lm_systems`: UR10, KUKA
     iiwa, LWA4D, planar6, planar10, the tree's 3 x 1000, planar40, dh19
     at float32, UR10 at float64, dense CIDGIK's finish at B = 1024) and on
     random SPD, ill-conditioned (J^T J + 1e-12 I, J 3 x m), indefinite and
     NaN systems at m = 3, 33, 64, 128 (`spd_random`, float32 and float64),
     with planar100's (m = 100) and dh40's (m = 40) LM systems among the
     paths';
     K6's time beside its bound (`spd_bound`) and beside cholesky_ex and
     two solve_triangular on the same inputs (what the port ran before);
     the plain version's time and batch invariance at UR10's shape. Every
     path's timed calls (phases 3, 6, 8-10, 15, 20) count K6 once an LM
     step (`lm_launches`: the polish's maxiter, times its
     augmented-Lagrangian rounds with obstacles), phases 11-14 and 17 over
     their finishes, and phase 18's profiled finishes, compiled and eager,
     hold K6's kernel count and show no cuSOLVER potrf or cuBLAS trsm
     (`lm_kernels`).

Phases 3, 6, 8-10, 15, 16 and 20 run the compiled solver (make_solver,
make_restart_solver, solve_ik_sharded): the warm call is the first call
at the batch shape, which runs prepare, solve and finish eagerly and
captures them; the timed calls replay the graphs, and each launches the
TR kernel once and K5 twice, inside the graphs. Phases 11-14 and 17 run
the compiled forms of the paths without K1-K4 (CIDGIK, CG, the float64
and "edge" solves): their loops replay CUDA graphs of the steps between
two host reads, their finishes one graph; each is held bitwise to its
eager form.

A floor is the lower end of the JAX package's 95% Wilson interval on that
configuration's 1000 goals (tools/torch_parity.py jax --config <name>), less
0.02.

The records of phases 11-14, 16 and 17 are logged as JSON lines before the
total. The last lines are the kernels' JSON record (K5 first, K6 last, with each
kernel's bound: the larger of its flops over the peak of its type and its
bytes over the memory rate, counted from the shapes and this run's
iteration counts), the
card's name and power limit, and {"ok": true, "device": {...}}. Without a
CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
B_CHECK = 1000
B_MAIN = 8192
B_SMALL = 64
TABLE_SUCCESS_MIN = 0.78  # JAX f32 pipeline: 0.809 [0.796, 0.820] (PARITY.md:27)
# Success floors: the JAX package's success on 1000 goals, float32 on the CPU
# (tools/torch_parity.py jax --config <name>; the planar chains on its "edge"
# backend; the restart configurations over its 16 draws of restart keys,
# 16000 trials), the lower end of its Wilson 95% interval, less 0.02.
FLOORS = {
    "planar6": 0.934,               # 967 / 1000 [0.9540, 0.9764]
    "planar10": 0.918,              # 953 / 1000 [0.9381, 0.9645]
    "kuka_iiwa": 0.894,             # 932 / 1000 [0.9147, 0.9460]
    "lwa4d": 0.838,                 # 880 / 1000 [0.8584, 0.8987]
    "ur10_restarts4": 0.959,        # 15710 / 16000 [0.9797, 0.9838]
    "ur10_table_restarts2": 0.853,  # 14065 / 16000 [0.8739, 0.8840]
    "planar6_restarts2": 0.969,     # 15856 / 16000 [0.9894, 0.9924]
    "planar10_restarts2": 0.970,    # 15869 / 16000 [0.9903, 0.9931]
    "tree_restarts3": 0.833,        # 13738 / 16000 [0.8531, 0.8639]
    "ur10_cidgik": 0.839,           # 881 / 1000 [0.8595, 0.8996]
    "ur10_table_cidgik": 0.736,     # 783 / 1000 [0.7564, 0.8074]
    "ur10_cidgik_sparse": 0.906,    # 943 / 1000 [0.9269, 0.9557]
    "ur10_cg": 0.740,               # 787 / 1000 [0.7606, 0.8113]
    "planar10_ring6": 0.818,        # 861 / 1000 [0.8382, 0.8811] ("edge" backend)
    # phase 20, at the UR10 path's parameters; planar40 and dh19 with full
    # bound smoothing (large_structures)
    "planar40": 0.350,              # 400 / 1000 [0.3701, 0.4307] ("edge" backend)
    # dh19: 28 / 1000 [0.0194, 0.0402] ("edge"); the rule's 0.02 exceeds
    # the rate itself (-0.0006, a floor that cannot fail), so here the lower
    # end less the 95% sampling error of that rate over B_MAIN = 8192 goals,
    # 1.96 sqrt(0.0194 (1 - 0.0194) / 8192) = 0.0030
    "dh19": 0.016,
    "ur10_table192": 0.757,         # 803 / 1000 [0.7772, 0.8265]
    # past 64 nodes, full bound smoothing (large_structures)
    "planar100": 0.043,             # 79 / 1000 [0.0638, 0.0974] ("edge" backend)
    # dh40: 13 / 1000 [0.0076, 0.0221] ("edge"); as dh19, the lower end less
    # 1.96 sqrt(0.0076 (1 - 0.0076) / 8192) = 0.0019
    "dh40": 0.005,
}
B_TREE = 1000
# the edge kernels' second batch: the UR10 inputs repeated 16 times, so that
# their working set (84 MB for K1, 109 MB for K2) passes the 50 MB L2
B_EDGE_BIG = 16 * B_MAIN
# dense CIDGIK: the bench's batches and schedules (bench.py:391-393,526-539)
B_CIDGIK, B_CIDGIK_TABLE = 1024, 512
CIDGIK_UR10 = dict(admm_iters=700, admm_iters_rest=300)
# the card against the CPU on 16 goals, float32: |d eig_sum| and |d feas|
# over every lane. Both move with the lane's Z: the constraint rows have
# unit norm, so |d feas| <= ||dZ||_F, and |d eig_sum| <= 10 ||dZ||_2 (Weyl,
# 10 small eigenvalues); at the points' observed 2.5e-5 agreement that is
# ~1e-4 and ~3e-4.
EIG_TOL, FEAS_TOL = 5e-4, 1e-4
# The sparse solver's eig_sum sums the 6 small eigenvalues of each of its 3
# blocks, |d eig_sum| <= 6 sum_k ||dZ_k||_2, and at this budget some lanes'
# Z moves more with rounding, so its bound is per lane, relative to the
# lane's own eig_sum: SPARSE_EIG_RTOL max(|eig_sum|, 1e-3), and at most
# SPARSE_EIG_TOL. On 512 goals (tools/cidgik_f32_spread.py --config
# ur10_cidgik_sparse --goals 256, seeds 11 and 12) the CPU's float32 lies
# up to 1.1e-3 from its float64 in eig_sum (a lane at eig_sum 0.59), and
# up to 0.035 of max(|eig_sum|, 1e-3) (a lane at 2.3e-4, 3.5e-5 apart);
# two float32 runs may lie twice that apart. feas moved by at most 1.1e-5
# there, inside FEAS_TOL.
SPARSE_EIG_TOL, SPARSE_EIG_RTOL = 2.5e-3, 0.07
# Riemannian CG on UR10 (ur10_cg): UR10's production path with the solver
# switched, at the UR10 path's batch
B_CG = 8192
# the 64-goal card-vs-CPU CG check. First riemannian.solve_cg from the same
# prepared Y0 on both: iterations equal per lane, and Y and cost (over
# max(1, max cost)) within a bound. float64, 20 iterations with the per-lane
# stops of tests/test_torch_cg.py (plateau every 4 at rtol 0.08, stepsize
# floor 1e-3): 1e-7, the bound tests/test_torch_cg.py holds the port to
# against the JAX package over 20 iterations (past ~25 float64
# trajectories part). float32, 5 iterations of the production
# params: twice the CPU's own float32-vs-float64 spread, 2.2e-5 in Y and
# 4.0e-5 in cost on 512 goals (tools/cg_f32_spread.py --iters 5, seeds
# 0-7), rounded up; by 20 iterations float32 trajectories have parted
# (0.3 in Y). Then the whole solver: the two success counts are two
# samples, and 1.96 sqrt(2 n p (1 - p)) at n = 64 and p = 0.79 (the JAX
# package's ur10_cg rate) is 9 goals.
CG_TRAJ64 = dict(maxiter=20, plateau_every=4, plateau_rtol=0.08, minstepsize=1e-3)
CG_TRAJ32 = dict(maxiter=5)
CG_TOL64, CG_TOL32 = 1e-7, 1e-4
CG_CARD_CPU_GOALS = 9
# The trust region's XLA backends (TRParams.backend), eager PyTorch: UR10 at
# float64 ("kernel" runs "dense" there, as the JAX package routes float64),
# the table at float64 on "dense", planar10 at float32 on "edge", each at its
# bench parameters. The batches make each call's success a firm test of its
# floor: UR10's rate is ~0.864 (phase 3), so at B = 1024 one call's success
# has a standard deviation of 0.0107 and falls below 0.85 about one call in
# ten; at 8192, 0.0038 (as phase 3). The table's ~0.80 has 0.025 at
# B = 256, under 0.78 one call in five; 0.0063 at 4096. The path is
# launch-bound, so the larger batches cost little more time.
# The card against the CPU on 64 UR10 goals at float64: one iteration from
# the same Y0 gives equal inner steps per lane and Y within 1e-12 (moving
# each entry of Y0 by about an ulp moves Y by at most 1.1e-15 after one
# iteration on 256 goals, but by up to 2.9e-3 after five, where the
# inner-step counts part too: tools/tr_f64_spread.py). Then the whole solver
# (each side prepares its own Y0): per-goal success equal on at least 61 of
# the 64. An ulp's move of Y0 alone changes the success of 5 of 768 goals on
# the CPU (tools/tr_f64_spread.py --finish, seeds 0-11), and the card
# differed from the CPU on 2 of 256 (tools/torch_f64_card_cpu.py, seeds
# 0-3) and on 1 of 64 in each of two runs of this phase; at ~0.8% a goal,
# 2 or more of 64 differ in ~9% of runs and 4 or more in 0.2%.
# planar10's "edge" success within 0.03 of the kernel path's on the same
# goals.
B_F64, B_F64_TABLE, B_EDGE = 8192, 4096, 1024
F64_TOL, F64_SAME_GOALS, EDGE_GAP = 1e-12, 61, 0.03
# The H100 SXM's published peaks: f32 and f64 outside the tensor cores,
# and HBM3 (NVIDIA's data sheet).
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12
# K5 (phase 19): ||A - V diag(w) V^T||_F / ||A||_F and max |V^T V - I|, and
# the eigenvalues' distance from torch.linalg.eigh's over ||A||_F. Jacobi
# stops once every |a_pq| <= eps max |a_ij|, so the residual is a few ulps
# times n; the CPU's float64 runs of the plain version stay within 1.3e-14
# and float32 within 5.5e-6 at n = 32 (tests/test_torch_eigh.py holds
# 1e-12 and 2e-5); cuSOLVER's own error adds to the eigenvalue gap.
EIGH_RES = {"f32": 2e-5, "f64": 1e-12}
EIGH_EIG = {"f32": 2e-5, "f64": 1e-12}
# K5's occupancy sweep: the first B of a path's 8192 prepare Grams, from
# about one warp a scheduler to eight at UR10's n = 16 (the first kernel's
# blocks, one wave), and at planar40's n = 43 (the wide instances); the
# paths by their tags in `eigh_path_inputs`, each float32 and float64
EIGH_OCCUPANCY_B = (1024, 2048, 4096, 8192)
EIGH_OCCUPANCY_PATHS = ("ur10 G", "planar40 G")
# past n = 64, torch.linalg.eigh's eigenvalues and time on the first this
# many matrices of a stack (it takes ~1.2-1.8 ms a matrix at n = 66-128)
EIGH_LIB_B = 1024
# the CUDA API calls (runtime cuda*, low-level cu*) by which the host starts device work
HOST_LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync"}


def eigh_res_tol(key, n):
    """EIGH_RES past n = 64 in proportion to n, as the residual grows: the
    plain version's float32 residual and orthogonality reach 2.4e-5 and
    2.7e-5 at n = 128 on the CPU (8 random matrices, n = 84 / 103: up to
    1.6e-5 / 2.1e-5); the bound stays EIGH_RES[key] at n <= 64."""
    return EIGH_RES[key] * max(1.0, n / 64)


def eigh_eig_tol(key, n):
    """EIGH_EIG past n = 64 in proportion to n, on the same basis as
    `eigh_res_tol` (two float32 eigensolvers each a few ulps times n of
    ||A||_F apart from the exact values; on the card planar40's Gram, n =
    43, is 1.28e-5 from torch.linalg.eigh's and planar100's, n = 103,
    2.70e-5); the bound stays EIGH_EIG[key] at n <= 64."""
    return EIGH_EIG[key] * max(1.0, n / 64)


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_op, t_b = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def edge_flops(N, d, E):
    """Flops of the edge cost+gradient (or Hessian-vector product) of one
    instance: the edge differences, ~20 per edge for the terms, and the
    scatter's 2 E d adds and N d scalings."""
    return E * d + 20 * E + 2 * E * d + N * d


def tr_flops(N, d, E, out, anchored_nodes=0):
    """Flops of a TR solve from its outputs' iteration counts: per tCG step
    the Hessian-vector product (edge differences, 16 per edge and
    coordinate-set, the scatter, the anchored 2 (K Z - sigma Z) on each
    anchored node, the projection) and the tCG updates; per outer
    iteration the Hessian setup and the trial point's cost and gradient.
    Anchor rows count only where a hinge is active: ~0.02% of them (PERF.md
    section 6), so none."""
    nd = N * d
    hvp = E * d + 16 * E + 2 * E * d + nd + 27 * anchored_nodes + 15 * nd + 20
    step = hvp + 6 * nd + 20
    outer = E * d + 15 * E + 6 * 2 * N + 20 + edge_flops(N, d, E) + 6 * nd + 30
    iters = float(out["iterations"].double().sum())
    inner = float(out["num_inner"].double().sum())
    return inner * step + (iters + out["iterations"].numel()) * outer


def tr_bytes(N, d, E, B):
    """Y0 and the goal distances in, Y and four per-instance scalars out."""
    return B * (2 * N * d * 4 + E * 4 + 16)


def dh_template(n):
    """dh<n> (dh19, dh40), the n-DoF DH chain of tools/torch_parity.py: a ~
    U(0.1, 0.5), d ~ U(0, 0.3), alpha from {-pi/2, 0, pi/2}, drawn in that
    order from RandomState(n); theta = 0, joint limits +-pi/2."""
    from graphik_tpu_torch.robots.templates import revolute_from_dh

    rs = np.random.RandomState(n)
    a = rs.uniform(0.1, 0.5, n)
    d = rs.uniform(0.0, 0.3, n)
    alpha = rs.choice([-np.pi / 2, 0.0, np.pi / 2], n)
    return revolute_from_dh(a, alpha, d, np.zeros(n), lb=-np.pi / 2, ub=np.pi / 2)


def large_structures():
    """(tag, ProblemStructure, smooth_iters) of the paths past 32 nodes or
    1024 anchor rows: planar40 (load_planar_chain(40, limits=pi/2): N = 43,
    E = 89) and dh19 (N = 42, E = 126) with full bound smoothing (None: at
    two squarings, which bound paths of up to 4 edges, a long chain's far
    pairs keep the unbounded placeholder and the MDS init is far off
    scale), ur10_table192 (UR10 + the table at n_width = n_height = 12:
    192 spheres, 6 x 192 = 1152 anchor rows) with two, as UR10's path;
    past 64 nodes, with full bound smoothing, planar100
    (load_planar_chain(100, limits=pi/2): N = 103, E = 209, 100 joints)
    and dh40 (N = 84, E = 272, 40 joints)."""
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.robots.library import load_planar_chain, load_ur10
    from graphik_tpu_torch.utils.environments import table_environment

    return [("planar40", load_planar_chain(40, limits=np.pi / 2)[1], None),
            ("dh19", ProblemStructure.from_template(dh_template(19)), None),
            ("ur10_table192", ProblemStructure.from_template(
                load_ur10()[0], obstacles=table_environment(n_width=12, n_height=12)), 2),
            ("planar100", load_planar_chain(100, limits=np.pi / 2)[1], None),
            ("dh40", ProblemStructure.from_template(dh_template(40)), None)]


def past32_structures():
    """large_structures' anchor-free paths: planar40, dh19, planar100,
    dh40."""
    return [s for s in large_structures() if s[1].n_obstacles == 0]


def sparse_eig_bound(eig_sum):
    """Per-lane bound on |d eig_sum| between two float32 sparse CIDGIK runs."""
    return (SPARSE_EIG_RTOL * eig_sum.abs().clamp(min=1e-3)).clamp(max=SPARSE_EIG_TOL)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cidgik_flops(op, blocks, B, steps):
    """Flops of `steps` split-ADMM iterations at batch B: per iteration the
    shared-weight products, 9 of (B, m_s) x (m_s, m_s) (two factor products
    per G_ss solve, four solves with the refinement step, and the
    refinement's G_ss product) and 2 of (B, n) x (n, m_s), n the flattened
    Z's size, and the 16 Newton-Schulz steps' 2 (s, s) products per block;
    blocks: (K, s), K blocks of s x s (the dense solver's one). The sparse
    solver's goal rows add 2 (m_d, n) products per instance (D_flat)."""
    m_s = op.m_s
    K, s = blocks
    n = K * s * s
    m_d = op.m_d if K > 1 else 0
    return steps * (18.0 * B * m_s * m_s + 4.0 * B * n * m_s + 4.0 * B * m_d * n
                    + 64.0 * B * K * s ** 3)


def sync(dev):
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize()


def cidgik_finish(ps_c):
    """The bench's CIDGIK finish (bench.py:379-453, its stage_finish): the
    raw pose error, the limits of the realization and polish_solution's
    30-step LM, as a stage function of (q, T_goal)."""
    from graphik_tpu_torch import api

    def finish(q, T_goal):
        e_pos0, e_rot0 = api.pose_error(ps_c, q, T_goal)
        viol, ok = ps_c.check_distance_limits(ps_c.realization(q))
        q, e_pos, e_rot, viol, ok = api.polish_solution(ps_c, q, T_goal, e_pos0, e_rot0, viol, ok)
        return {"q_polished": q, "e_pos0": e_pos0, "e_rot0": e_rot0, "e_pos": e_pos,
                "e_rot": e_rot, "ok": ok}
    return finish


def cidgik_call(solve, comp, ps_c, T_goal, params, graphs):
    """One call of the bench's CIDGIK path: `solve` (solve_cidgik or
    solve_cidgik_sparse; its ADMM through the template's loop graphs unless
    inside compiled.eager_loops()), then the finish, through `graphs` (a
    StageGraphs, as bench.py:418-426 jits stage_finish) or eagerly (None).
    Returns (ADMM wall, finish wall, outputs)."""
    sync(T_goal.device)
    t0 = time.perf_counter()
    out = solve(comp, T_goal, params=params)
    sync(T_goal.device)
    t1 = time.perf_counter()
    finish = cidgik_finish(ps_c)
    fin = finish(out["q"], T_goal) if graphs is None else graphs.run("finish", finish, out["q"],
                                                                     T_goal)
    sync(T_goal.device)
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, dict(out, **fin)


def pool_bytes(stage_graphs):
    """Bytes held by the memory pools of the StageGraphs in `stage_graphs`:
    the caching allocator's segments of those pools (one snapshot)."""
    import torch

    segs = torch.cuda.memory_snapshot()
    check(all("segment_pool_id" in seg for seg in segs), "memory_snapshot has no segment_pool_id")
    pools = {tuple(p) for g in stage_graphs for p in g.pools.values()}
    return sum(seg["total_size"] for seg in segs if tuple(seg["segment_pool_id"]) in pools)


def differing(a, b):
    """{key: lanes that differ} of two output dicts (empty: bitwise equal)."""
    import torch

    check(set(a) == set(b), f"output keys differ: {sorted(set(a) ^ set(b))}")
    return {k: int((a[k] != b[k]).reshape(a[k].shape[0], -1).any(-1).sum())
            for k in a if not torch.equal(a[k], b[k])}


def profiled(fn, dev):
    """Device activities of one run of fn (torch.profiler): (kernel
    launches, other device activities - copies and sets -, device-busy ms,
    host launches - the CUDA API calls by which the host starts device
    work, a graph launch counting one -, the device kernels' names). The
    profiler's raw events are read directly: building its per-event Python
    objects takes ~50 us an event, minutes for a CIDGIK call."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    dev_ev = [e for e in events if e.device_type() == cuda]
    copies = sum(1 for e in dev_ev if e.name().startswith(("Memcpy", "Memset")))
    busy_ms = sum(e.duration_ns() for e in dev_ev) / 1e6
    host = sum(1 for e in events if e.device_type() != cuda and e.name() in HOST_LAUNCH_CALLS)
    kernels = [e.name() for e in dev_ev if not e.name().startswith(("Memcpy", "Memset"))]
    return len(kernels), copies, busy_ms, host, kernels


def lm_launches(solver):
    """K6 launches of one finish of `solver` (an api.Solver or
    RestartSolver): one an LM step, the polish's maxiter steps
    (api.polish_solution's 30 by default) in each of its
    augmented-Lagrangian rounds where the structure has obstacles."""
    from graphik_tpu_torch.solvers.local import LocalParams

    if not solver.polish:
        return 0
    pp = solver.polish_params or LocalParams(maxiter=30, tol_grad=1e-8)
    return pp.maxiter * (pp.al_iters if solver.structure.n_obstacles else 1)


def lm_kernels(tag, names, want):
    """Check a finish's device kernels (profiler names): K6 `want` times,
    and no library Cholesky factor or triangular solve (cuSOLVER potrf,
    cuBLAS trsm) beside it. Returns K6's count."""
    k6 = sum("spd_solve_kernel" in n for n in names)
    lib = sorted({n for n in names if re.search("potrf|trsm|cholesky", n, re.I)})
    check(k6 == want, f"{tag}: the finish launched K6 {k6} times, not {want}")
    check(not lib, f"{tag}: the finish launched a library factor or solve: {lib}")
    return k6


def flushed_kernel_ms(fn, name, reps):
    """Median device duration (ms) of the kernel named `name` (profiler
    events) over `reps` runs of fn, each after a read of 256 MB that
    flushes the L2: the kernel finds its inputs cold, as a caller does, and
    evicts only clean lines."""
    import torch

    flush = torch.ones(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ms = sorted(e.duration_ns() / 1e6 for e in prof.profiler.kineto_results.events()
                if e.device_type() == cuda and name in e.name())
    check(2 * len(ms) >= reps, f"the profiler saw {len(ms)} of {reps} {name} launches")
    return ms[len(ms) // 2]


def edge_bytes(N, d, E, B, hess):
    """Bytes K1 (hess False) or K2 must move: Y (and Z) and the goal
    distances in, g and f (or H) out."""
    return B * ((3 if hess else 2) * N * d + E + (0 if hess else 1)) * 4


def edge_phase(dev, ep, Y0, dg):
    """Phase 7: the edge kernels K1 (cost_and_egrad_cuda) and K2
    (ehess_cuda). Bitwise against their kernel-order plain versions on
    B_CHECK goals prepared for UR10, planar6, planar10, KUKA iiwa and the
    tree, at B_MAIN on the UR10 path's Y0 / dg, which are also held to
    torch's own order (cost_and_egrad / ehess) within a tolerance, and at
    B_MAIN on planar40's and dh19's prepared inputs (past 32 nodes: two node
    slots a lane); then each kernel's device time (profiler, L2 flushed)
    and call time (CUDA events over back-to-back calls) at B_MAIN and
    B_EDGE_BIG (the UR10 inputs repeated), and at planar40's and dh19's
    B_MAIN, beside its bounds. Returns the two kernel records."""
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.robots.library import (
        load_kuka, load_planar_chain, load_tree5, load_ur10)

    t_phase = time.perf_counter()
    K1, K2 = edge_ops.cost_and_egrad_cuda, edge_ops.ehess_cuda
    zgen = torch.Generator(device=dev).manual_seed(SEED)
    ptxas = ptxas_lines()

    def bitwise(tag, ep_, Y_, Z_, dg_):
        f_k, g_k = K1(ep_, Y_, dg_)
        h_k = K2(ep_, Y_, Z_, dg_)
        f_p, g_p = edge_ops.cost_and_egrad_kernel_order(ep_, Y_, dg_)
        h_p = edge_ops.ehess_kernel_order(ep_, Y_, Z_, dg_)
        torch.cuda.synchronize()
        same = [int(torch.equal(x, y)) for x, y in ((f_k, f_p), (g_k, g_p), (h_k, h_p))]
        err = max(float((x - y).abs().max()) for x, y in ((f_k, f_p), (g_k, g_p), (h_k, h_p)))
        finite = all(bool(torch.isfinite(x).all()) for x in (f_k, g_k, h_k))
        shape = edge_ops.edge_kernel_shape(ep_, Y_.shape[0], dg_.shape[1], True, dev)
        # the two instances at this shape: registers, static shared memory
        # and spill stores from the build's ptxas log
        args = f"{ep_.dim},{shape['epl']},{shape['W']},{2 if ep_.N > 32 else 1}"
        regs = {k: ptxas[f"{k}_kernel<{args}>"] for k in ("cost_grad", "hess")}
        log(f"[7] {tag} (N={ep_.N}, d={ep_.dim}, E={ep_.E}), B={Y_.shape[0]}: f, g, H bitwise "
            f"equal to the kernel-order plain versions {same}, max |diff| {err:.1e}; W "
            f"{shape['W']}, EPL {shape['epl']}, {shape['blocks']} blocks of {shape['tile']}; "
            f"<{args}> registers, static smem, spill stores: {regs}")
        check(all(same) and finite, f"{tag}: edge kernels differ from their plain versions")
        check(all(r[2] == 0 for r in regs.values()), f"{tag}: an edge kernel instance spills")
        return {"robot": tag, "N": ep_.N, "d": ep_.dim, "E": ep_.E, "B": Y_.shape[0],
                "bitwise": True, "W": shape["W"], "epl": shape["epl"],
                "ptxas": regs}, (f_k, g_k, h_k), err

    robots = {"ur10": load_ur10, "planar6": lambda: load_planar_chain(6, limits=np.pi / 2),
              "planar10": lambda: load_planar_chain(10, limits=np.pi / 2),
              "kuka_iiwa": load_kuka, "tree": load_tree5}
    shapes, err_max = [], 0.0
    for tag, load in robots.items():
        ps_r = load()[1]
        ep_r = edge_ops.build_edge_problem(*ps_r.masks(), dim=ps_r.dim)
        T_r = api.random_goals(ps_r, (B_CHECK,), torch.Generator().manual_seed(SEED),
                               dtype=torch.float32, device=dev)[0]
        D_r, Y_r = api.make_solver(ps_r, smooth_iters=2).prepare(T_r)
        Y_r = Y_r.contiguous()
        Z_r = torch.randn(Y_r.shape, generator=zgen, device=dev)
        rec, _, err = bitwise(tag, ep_r, Y_r, Z_r, ep_r.edge_values(D_r).contiguous())
        shapes.append(rec)
        err_max = max(err_max, err)

    # The UR10 path's Y0 (prepare's, cost O(1)) at B_MAIN. At the Y the
    # solve returns the cost is ~1e-7, a sum of squared differences of O(1)
    # squared lengths: f32 cancellation puts any two summation orders ~1e-2
    # apart in f and ~1e-5 apart in g there, so torch's order is compared
    # at Y0.
    Z = torch.randn(Y0.shape, generator=zgen, device=dev)
    K1.launches = K2.launches = 0
    rec, (f_k, g_k, h_k), err = bitwise("ur10 path", ep, Y0, Z, dg)
    launches = (K1.launches, K2.launches)
    check(launches == (1, 1), "the edge entry points did not launch once each")
    shapes.append(rec)
    err_max = max(err_max, err)
    f_p, g_p = edge_ops.cost_and_egrad(ep, Y0, dg)
    h_p = edge_ops.ehess(ep, Y0, Z, dg)
    f_rel = float(((f_k - f_p).abs() / f_p.abs().clamp(min=1e-30)).max())
    err_g, err_h = float((g_k - g_p).abs().max()), float((h_k - h_p).abs().max())
    g_scale, h_scale = float(g_p.abs().max()), float(h_p.abs().max())
    log(f"[7] B={B_MAIN}, against torch's order: f max rel err {f_rel:.3e} (<= 1e-5), g max "
        f"abs err {err_g:.3e} (<= 1e-4 x {g_scale:.3e}), H max abs err {err_h:.3e} (<= 1e-4 x "
        f"{h_scale:.3e})")
    check(f_rel <= 1e-5, "edge cost mismatch")
    check(err_g <= 1e-4 * g_scale and err_h <= 1e-4 * h_scale, "edge gradient/Hessian mismatch")

    # past 32 nodes: planar40's and dh19's prepared inputs at the paths'
    # batch, full smoothing as phase 20 runs them
    wide = {}
    for tag, ps_l, smooth in large_structures()[:2]:
        ep_l = edge_ops.build_edge_problem(*ps_l.masks(), dim=ps_l.dim)
        T_l = api.random_goals(ps_l, (B_MAIN,), torch.Generator().manual_seed(SEED),
                               dtype=torch.float32, device=dev)[0]
        D_l, Y_l = api.Solver(ps_l, smooth_iters=smooth).prepare(T_l)
        Y_l, dg_l = Y_l.contiguous(), ep_l.edge_values(D_l).contiguous()
        Z_l = torch.randn(Y_l.shape, generator=zgen, device=dev)
        rec, _, err = bitwise(tag, ep_l, Y_l, Z_l, dg_l)
        shapes.append(rec)
        err_max = max(err_max, err)
        wide[tag] = (ep_l, Y_l, Z_l, dg_l)

    # (tag, B): the EdgeProblem and inputs each kernel is timed on
    inputs = {("ur10", B): (ep, *(x.repeat(B // B_MAIN, *[1] * (x.dim() - 1)) for x in (Y0, Z, dg)))
              for B in (B_MAIN, B_EDGE_BIG)}
    inputs.update({(tag, B_MAIN): v for tag, v in wide.items()})
    cases = {}
    for (tag, B), (ep_c, Yb, Zb, dgb) in inputs.items():
        cases["cost_grad", tag, B] = ("cost_grad_kernel",
                                      lambda e=ep_c, Yb=Yb, dgb=dgb: K1(e, Yb, dgb), False)
        cases["hess", tag, B] = ("hess_kernel",
                                 lambda e=ep_c, Yb=Yb, Zb=Zb, dgb=dgb: K2(e, Yb, Zb, dgb), True)
    # every call time before the first profiler session of the process
    timed = {key: {"call_ms": event_ms(fn, 100)} for key, (_, fn, _) in cases.items()}
    for (name, tag, B), (kern, fn, hess) in cases.items():
        ep_c = inputs[tag, B][0]
        N, d, E = ep_c.N, ep_c.dim, ep_c.E
        b = bound(B * (edge_flops(N, d, E) + (E * d if hess else 0)), edge_bytes(N, d, E, B, hess))
        t = timed[name, tag, B]
        t.update(device_ms=flushed_kernel_ms(fn, kern, 20), bound_ms=b[0], bound_by=b[1])
        log(f"[7] {name}, {tag} (N={N}, d={d}, E={E}) at B={B}: device "
            f"{t['device_ms'] * 1e3:.2f} us (L2 flushed), call {t['call_ms'] * 1e3:.2f} us, bound "
            f"{b[0] * 1e3:.2f} us ({b[1]}), {t['device_ms'] / b[0]:.2f}x")
    del cases
    plain = {(name, tag): event_ms(
        (lambda e=e_, Y_=Y_, dg_=dg_: edge_ops.cost_and_egrad_kernel_order(e, Y_, dg_))
        if name == "cost_grad" else
        (lambda e=e_, Y_=Y_, Z_=Z_, dg_=dg_: edge_ops.ehess_kernel_order(e, Y_, Z_, dg_)), 5)
        for name in ("cost_grad", "hess")
        for tag, (e_, Y_, Z_, dg_) in [("ur10", (ep, Y0, Z, dg)), *wide.items()]}
    shape = edge_ops.edge_kernel_shape(ep, B_MAIN, dg.shape[1], False, dev)
    log(f"[7] kernel-order plain versions at B={B_MAIN}: "
        + ", ".join(f"{name} {tag} {ms:.4f} ms" for (name, tag), ms in plain.items())
        + f"; UR10 launch shape {shape}; phase took {time.perf_counter() - t_phase:.1f} s")
    records = []
    for name, line, n, tol in (
            ("cost_grad", 302, launches[0], {"f_max_rel": f_rel, "g_max_abs": err_g}),
            ("hess", 325, launches[1], {"H_max_abs": err_h})):
        t8, tb = timed[name, "ur10", B_MAIN], timed[name, "ur10", B_EDGE_BIG]
        paths = []
        for tag, (ep_l, *_) in wide.items():
            t = timed[name, tag, B_MAIN]
            paths.append({"path": tag, "N": ep_l.N, "d": ep_l.dim, "E": ep_l.E, "B": B_MAIN,
                          "bitwise": True, "ms": t["device_ms"], "call_ms": t["call_ms"],
                          "plain_ms": plain[name, tag], "bound_ms": t["bound_ms"],
                          "bound_by": t["bound_by"],
                          "launch_shape": edge_ops.edge_kernel_shape(ep_l, B_MAIN, ep_l.Ep,
                                                                     name == "hess", dev)})
        records.append({
            "name": f"edge_{name}", "route": "cuda", "source": "graphik_tpu_torch/csrc/edge.cu",
            "replaces": f"graphik_tpu/ops/edge.py:{line}", "launches": n,
            "max_abs_err": err_max, "ms": t8["device_ms"], "plain_ms": plain[name, "ur10"],
            "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"], "library_ms": None,
            "at": f"UR10, B={B_MAIN}, device time with the L2 flushed",
            "two_per_warp": shape["two_per_warp"], "blocks_resident": shape["blocks_resident"],
            "device_ms": {str(B_MAIN): t8["device_ms"], str(B_EDGE_BIG): tb["device_ms"]},
            "call_ms": {str(B_MAIN): t8["call_ms"], str(B_EDGE_BIG): tb["call_ms"]},
            "bounds_ms": {str(B_MAIN): t8["bound_ms"], str(B_EDGE_BIG): tb["bound_ms"]},
            "sources": ["graphik_tpu_torch/csrc/edge_kernel.cuh",
                        "graphik_tpu_torch/csrc/edge_wide.cu"],
            "paths": paths, "against_torch_order": tol, "bitwise_shapes": shapes})
    return records


def ptxas_lines():
    """Each kernel instance of the built library, from its ptxas log:
    {"name<template args>": (registers, static shared memory bytes, spill
    store bytes)}."""
    from graphik_tpu_torch.ops._build import library_path

    with open(library_path() + ".log") as f:
        return parse_ptxas(f.read())


def parse_ptxas(ptxas):
    """{"name<template args>": (registers, static shared memory bytes, spill
    store bytes)} of each kernel instance in nvcc's `-Xptxas -v` output."""
    out = {}
    for entry in ptxas.split("Compiling entry function '")[1:]:
        name = re.search(r"([a-z][a-z_]*_kernel)I((?:[fd]|L[ib]\d+E)+)E", entry)
        args = ",".join(num or {"f": "float", "d": "double"}[t]
                        for num, t in re.findall(r"L[ib](\d+)E|([fd])", name.group(2)))
        regs = re.search(r"Used (\d+) registers", entry).group(1)
        # a kernel with no static shared memory has no "bytes smem" entry
        smem = re.search(r"Used \d+ registers[^\n]*?(\d+) bytes smem", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry).group(1)
        out[f"{name.group(1)}<{args}>"] = (int(regs), int(smem.group(1)) if smem else 0,
                                           int(spill))
    return out


def lanes_equal(k, p):
    """Lanes whose Y, cost, gradnorm, iterations and num_inner are all
    bitwise equal."""
    same = (k["Y"] == p["Y"]).flatten(1).all(1)
    for key in ("cost", "gradnorm", "iterations", "num_inner"):
        same &= k[key] == p[key]
    return int(same.sum())


def event_ms(fn, reps, warm=True):
    """Mean ms of fn over reps runs after a warm run (CUDA events); with
    warm=False the caller has warmed it."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps, replays=3):
    """Mean device ms of fn a run: `reps` runs captured into one CUDA graph
    (after a warm run), its replays timed by CUDA events, so that the host's
    pace of launches does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del g
    return ms


def staged(solver, T_goal, *gen):
    """One call of the path, stage by stage: (prepare, solve, finish walls
    in s, peak device memory of prepare in bytes, out). A restart
    solver's prepare takes its generator."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    D_goal, Y0m = solver.prepare(T_goal, *gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    sol = solver.solve(Y0m, D_goal)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = solver.finish(sol, T_goal)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return t1 - t0, t2 - t1, t3 - t2, peak, out


def first_call(tag, solver, T_goal, *gen):
    """The first call of a compiled solver at the path's shape, stage by
    stage: its prepare, solve and finish run eagerly once (the warm-up) and
    are captured into CUDA graphs (utils/compiled.py). Logs and returns the
    stage walls (s)."""
    tp, ts, tf, _, _ = staged(solver, T_goal, *gen)
    log(f"[{tag}] first call (warm-up + capture of the prepare, solve and finish graphs): prepare "
        f"{tp * 1e3:.1f} ms, solve {ts * 1e3:.1f} ms, finish {tf * 1e3:.1f} ms")
    return tp, ts, tf


def graph_pool_bytes(solvers):
    """Bytes held by the memory pools of each compiled solver's CUDA
    graphs (one snapshot each)."""
    return [pool_bytes([s.graphs]) for s in solvers]


def prepare_vs_eager(tag, dev, solver, T_goal, gen):
    """A compiled solver's prepare (one CUDA graph, captured on the path's
    first call) against the same solver's eager prepare on the same goals
    and the same generator state: D_goal and Y0 bitwise equal; the walls of
    one call each; K5's launches a call, counted inside the graph on
    replay; the host launches and device activities of one replayed
    prepare (profiled). Returns the record."""
    from graphik_tpu_torch.ops.eigh import sym_eigh_cuda

    eager = dataclasses.replace(solver, graphs=None)
    states = [g.get_state() for g in gen]

    def restored():
        for g, s in zip(gen, states):
            g.set_state(s)
        return gen

    outs, walls, k5 = {}, {}, {}
    for name, s in (("compiled", solver), ("eager", eager)):
        s.prepare(T_goal, *restored())  # warm: the compiled one replays
        sync(dev)
        before = sym_eigh_cuda.launches
        t0 = time.perf_counter()
        outs[name] = s.prepare(T_goal, *restored())
        sync(dev)
        walls[name] = (time.perf_counter() - t0) * 1e3
        k5[name] = sym_eigh_cuda.launches - before
    kernels, copies, busy, host, _ = profiled(lambda: solver.prepare(T_goal, *restored()), dev)
    same = all(bool(a.equal(b)) for a, b in zip(outs["compiled"], outs["eager"]))
    rec = {"bitwise": same, "compiled_ms": walls["compiled"], "eager_ms": walls["eager"],
           "k5_launches": k5["compiled"], "k5_launches_eager": k5["eager"],
           "host_launches": host, "device_activities": kernels + copies, "busy_ms": busy}
    log(f"[18] {tag} prepare, {tuple(T_goal.shape)} goals: compiled {walls['compiled']:.2f} ms / "
        f"eager {walls['eager']:.2f} ms; D_goal and Y0 bitwise equal {same}; K5 launches a call "
        f"{k5['compiled']} (in the graph) / {k5['eager']}; one replayed prepare: {host} host "
        f"launches, {kernels} kernels + {copies} copies/sets, device busy {busy:.2f} ms")
    check(same, f"{tag}: the compiled prepare differs from the eager one")
    check(k5["compiled"] == k5["eager"] == 2, f"{tag}: prepare did not launch K5 twice")
    return rec


def path_outputs(solver, T_goal):
    """One call of a solver, stage by stage: prepare's D_goal and Y0 beside
    every output of the finish (the solve's among them)."""
    D_goal, Y0 = solver.prepare(T_goal)
    return {"D_goal": D_goal, "Y0": Y0, **solver.finish(solver.solve(Y0, D_goal), T_goal)}


def position_check(phase, tag, run, T_goal, fwd=None):
    """Whether a goal's result depends on its position in the batch: run(T)
    -> {name: (B, ...) tensor} on goal 0 of T_goal copied to every position
    (every output must be bitwise one at every position) and on T_goal in
    reverse order (each goal's outputs bitwise its forward ones: run's on
    T_goal, or `fwd` where the path's phase has it). Logs the lanes that
    split or move, output by output in run's order (the first is the
    earliest stage), with the split lanes' batch positions mod 4; fails
    the run on either. Returns the record."""
    import torch

    t0 = time.perf_counter()
    B = T_goal.shape[0]
    copied = run(T_goal[:1].expand(T_goal.shape).contiguous())
    split = {}
    for k, v in copied.items():
        lanes = (v != v[:1]).reshape(B, -1).any(-1)
        if bool(lanes.any()):
            split[k] = [int(lanes[r::4].sum()) for r in range(4)]
    fwd = run(T_goal) if fwd is None else fwd
    rev = run(T_goal.flip(0).contiguous())
    check(set(fwd) == set(rev), f"{tag}: output keys differ")
    moved = {k: int((rev[k].flip(0) != v).reshape(B, -1).any(-1).sum())
             for k, v in fwd.items() if not torch.equal(rev[k].flip(0), v)}
    rec = {"path": tag, "B": B, "outputs": list(copied), "copied_goal_split": split,
           "reversed_moved": moved, "invariant": not split and not moved,
           "seconds": time.perf_counter() - t0}
    log(f"[{phase}] {tag}: batch position, {B} goals: one goal at every position gives one "
        f"value of each of {len(copied)} outputs {not split}"
        + (f" (lanes that split, by position mod 4: {split})" if split else "")
        + f"; reversed stack gives each goal its forward outputs {not moved}"
        + (f" (lanes that moved: {moved})" if moved else "")
        + f" ({rec['seconds']:.1f} s)")
    check(not split and not moved, f"{tag}: a goal's result depends on its batch position")
    return rec


def compiled_phase(dev, paths, prepare_paths=(), position_runs=()):
    """Phase 18: each f32 kernel path's compiled solver (CUDA graphs, as
    the earlier phases ran it) against the same solver with every stage
    eager (api.solve_ik's), on the same prepared inputs at the path's
    batch: every output of the solve and of the finish bitwise equal; the
    stages' walls; the compiled finish's host launches, device activities
    and device-busy share (one profiled call, busy over the unprofiled
    wall), and K6's launches in each form's finish (its counter; the eager
    finish is not profiled: its tens of thousands of host launches made the
    profiler the phase's largest cost); the first call's walls (warm-up + capture, from the path's
    phase) and, less the eager stage's wall, the capture's; the memory
    the solver's graph pools hold and each finish's peak. Before that,
    the path's prepare compiled against eager (`prepare_vs_eager`), and
    so for each of prepare_paths (the float64 path of phase 17). Then each
    single-init path's batch-position invariance at its batch
    (`position_check`: one goal at every position, the stack reversed;
    a restart path draws its sampled fractions by position, so its goals'
    starts differ by design), and so for each of position_runs (the
    graphed-loop paths of phases 11, 13, 14 and 17). paths: [(tag,
    compiled solver, T_goal, generator args, first-call walls)];
    prepare_paths: [(tag, compiled solver, T_goal, generator args)];
    position_runs: [(tag, run, T_goal, forward outputs or None)]. Returns the records and the position records."""
    import torch

    from graphik_tpu_torch.ops.linalg import spd_solve_cuda

    t_phase = time.perf_counter()
    records = []
    prepares = {tag: prepare_vs_eager(tag, dev, s, T, g) for tag, s, T, g in prepare_paths}
    for tag, solver, T_goal, gen, first in paths:
        prepares[tag] = prepare_vs_eager(tag, dev, solver, T_goal, gen)
        eager = dataclasses.replace(solver, graphs=None)
        D, Y0 = eager.prepare(T_goal, *gen)
        walls, outs, peaks, k6 = {}, {}, {}, {}
        for name, s in (("compiled", solver), ("eager", eager)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = s.solve(Y0, D)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = spd_solve_cuda.launches
            out = s.finish(sol, T_goal)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            k6[name] = spd_solve_cuda.launches - before
            peaks[name] = torch.cuda.max_memory_allocated() - base
            walls[name] = (t1 - t0, t2 - t1)
            outs[name] = (sol, out)
        differ = {k: int((a[k] != b[k]).reshape(a[k].shape[0], -1).any(-1).sum())
                  for a, b in zip(outs["compiled"], outs["eager"]) for k in a
                  if not torch.equal(a[k], b[k])}
        sol_c = outs["compiled"][0]
        t_prof = time.perf_counter()
        kernels, copies, busy, host, names = profiled(lambda: solver.finish(sol_c, T_goal), dev)
        t_prof = time.perf_counter() - t_prof
        # K6 once an LM step in both forms, no library factor or solve
        lm_kernels(f"{tag} compiled finish", names, lm_launches(solver))
        for name in k6:
            check(k6[name] == lm_launches(solver),
                  f"{tag}: the {name} finish launched K6 {k6[name]} times")
        B = Y0.shape[0]
        # the first call ran each stage eagerly (the warm-up), then captured it
        rec = {"path": tag, "B": B, "bitwise": not differ, "lanes_differ": differ,
               "prepare": prepares[tag],
               "first_call_ms": {"prepare": first[0] * 1e3, "solve": first[1] * 1e3,
                                 "finish": first[2] * 1e3},
               "capture_ms": {"solve": (first[1] - walls["eager"][0]) * 1e3,
                              "finish": (first[2] - walls["eager"][1]) * 1e3}}
        for name in ("compiled", "eager"):
            ts, tf = walls[name]
            rec[name] = {"solve_ms": ts * 1e3, "finish_ms": tf * 1e3,
                         "finish_k6_launches": k6[name], "finish_peak_mib": peaks[name] / 2**20}
        c, e = rec["compiled"], rec["eager"]
        c.update(finish_host_launches=host, finish_device_activities=kernels + copies,
                 finish_busy_ms=busy, finish_busy_share=busy / c["finish_ms"])
        log(f"[18] {tag}, {B} instances: solve {c['solve_ms']:.1f} ms compiled / "
            f"{e['solve_ms']:.1f} eager; finish {c['finish_ms']:.1f} / {e['finish_ms']:.1f} ms "
            f"({e['finish_ms'] / c['finish_ms']:.1f}x); compiled finish host launches "
            f"{c['finish_host_launches']}, device activities {c['finish_device_activities']}, busy "
            f"{100 * c['finish_busy_share']:.1f}%; K6 {c['finish_k6_launches']} / "
            f"{e['finish_k6_launches']}; first "
            f"call (warm-up + capture) solve {first[1] * 1e3:.1f} ms, finish "
            f"{first[2] * 1e3:.1f} ms, less the eager stage: capture "
            f"{rec['capture_ms']['solve']:.1f} / {rec['capture_ms']['finish']:.1f} ms; finish peak {c['finish_peak_mib']:.1f} / "
            f"{e['finish_peak_mib']:.1f} MiB; outputs bitwise equal {not differ} {differ or ''}; "
            f"the profiled finish took {t_prof:.1f} s")
        check(not differ, f"{tag}: the compiled solver's outputs differ from the eager ones")
        records.append(rec)
    pools = graph_pool_bytes([p[1] for p in paths])
    for rec, pool in zip(records, pools):
        rec["graph_pool_mib"] = pool / 2**20
    per_path = ", ".join("%s %.1f" % (r["path"], r["graph_pool_mib"]) for r in records)
    log(f"[18] graph pools (MiB): {per_path}; {sum(pools) / 2**20:.1f} in all; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    records += [{"path": tag, "prepare": prepares[tag]} for tag, *_ in prepare_paths]
    t_pos = time.perf_counter()
    positions = [position_check("18", tag, lambda T, s=solver: path_outputs(s, T), T_goal)
                 for tag, solver, T_goal, gen, _ in paths if not gen]
    positions += [position_check("18", tag, run, T_goal, fwd)
                  for tag, run, T_goal, fwd in position_runs]
    log(f"[18] batch-position checks took {time.perf_counter() - t_pos:.1f} s")
    return records, positions


def eigh_bound(n, B, dtype):
    """(ms, "operations" or "bytes") of B symmetric n x n eigendecompositions:
    9 n^3 flops a matrix (Golub & Van Loan's count for the symmetric QR
    algorithm with eigenvectors) over the card's non-tensor rate of the
    type, against n^2 read and n^2 + n written a matrix over the memory
    rate."""
    import torch

    size = 8 if dtype == torch.float64 else 4
    peak = PEAK_F64 if dtype == torch.float64 else PEAK_F32
    t_op, t_b = 9 * n ** 3 * B / peak * 1e3, (2 * n * n + n) * size * B / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def jacobi_ms(n, B, dtype, mean_sweeps):
    """The Jacobi's own operation count for B matrices at `mean_sweeps`
    sweeps a matrix over the card's non-tensor rate of the type: 9 m^2 (m -
    1) flops a sweep (18 m a lane a step over m / 2 lanes, m - 1 steps;
    separate multiplies and adds, no FMA). A floor of the algorithm, not
    of the function, so phase 19 only logs it beside bound_ms."""
    import torch

    m = n + (n & 1)
    peak = PEAK_F64 if dtype == torch.float64 else PEAK_F32
    return 9 * m * m * (m - 1) * mean_sweeps * B / peak * 1e3


def prepare_matrices(solver, T_goal):
    """The two matrices the MDS init of `solver`'s prepare decomposes, as
    riemannian.generate_initializations forms them: the symmetrised Gram G
    of the deterministic distance matrix and the edge scatter S of its
    factor."""
    from graphik_tpu_torch.utils import dgp

    inst, omega = solver._instance(T_goal)
    G = dgp.gram_from_distance_matrix(dgp.sample_distance_matrix(inst["lb"], inst["ub"]))
    G = (G + G.transpose(-1, -2)) / 2.0
    return G, dgp.edge_scatter(dgp.mds(G, eps=1e-8), omega)


def eigh_path_inputs(dev, gen):
    """(tag, stack) of each matrix shape K5 meets on a path, at the batch
    the path launches it, float32 and float64: prepare's Gram (B = 8192:
    UR10 n = 16, planar6 n = 9, planar10 n = 13, KUKA iiwa n = 18, planar40
    n = 43, dh19 n = 42, planar100 n = 103 and dh40 n = 84 (these two
    float32 only); the tree's 3 restarts of 1000 goals, n = 14) and
    CIDGIK's Fantope inputs at B_CIDGIK (dense Z, n = 13; the sparse path's
    3 clique blocks a goal, n = 9)."""
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import (
        load_kuka, load_planar_chain, load_tree5, load_ur10)

    ps = load_ur10()[1]
    out = []
    for dt in (torch.float32, torch.float64):
        key = "f64" if dt == torch.float64 else "f32"
        for tag, ps_e, B, sm in (("ur10", ps, B_MAIN, 2),
                                 ("planar6", load_planar_chain(6, limits=np.pi / 2)[1], B_MAIN, 2),
                                 ("planar10", load_planar_chain(10, limits=np.pi / 2)[1], B_MAIN, 2),
                                 ("tree_restarts3", load_tree5()[1], 3 * B_TREE, 2),
                                 ("kuka_iiwa", load_kuka()[1], B_MAIN, 2),
                                 *((tag, ps_l, B_MAIN, sm) for tag, ps_l, sm in past32_structures())):
            if dt == torch.float64 and ps_e.N > 64:
                continue  # float32 paths; the random stacks hold K5's float64 past 64
            T_e = api.random_goals(ps_e, (B,), gen, dtype=dt, device=dev)[0]
            out.append((f"{tag} G {key}", prepare_matrices(api.Solver(ps_e, smooth_iters=sm),
                                                           T_e)[0]))
        q = api.random_goals(ps, (B_CIDGIK,), gen, dtype=dt, device=dev)[1]
        Zs = lifted_noisy(ps, q, True, gen)
        out += [(f"ur10_cidgik Z {key}", lifted_noisy(ps, q, False, gen)),
                (f"ur10_cidgik_sparse blocks {key}", Zs.reshape(-1, *Zs.shape[-2:]))]
    return out


def lifted_noisy(ps_c, q, sparse, gen):
    """CIDGIK's rank-forcing inputs at realistic points: the lifted Z =
    [[I, X^T], [X, X X^T]] of the free nodes of the realizations of q (dense:
    (B, s, s); sparse: the (B, K, ds, ds) clique blocks, padded slots exactly
    zero), plus symmetric noise of 1e-2 on the valid slots."""
    import torch

    from graphik_tpu_torch.solvers import cidgik, cidgik_sparse

    if sparse:
        comp = cidgik_sparse.compile_cidgik_sparse(ps_c)
        pts = ps_c.realization(q)[:, torch.as_tensor(comp.free_idx, device=q.device)]
        Z = cidgik_sparse.lifted_blocks(comp, pts)
        valid = torch.as_tensor(cidgik_sparse._valid_slots(comp.member, comp.d), dtype=q.dtype,
                                device=q.device)
        mask = valid[:, :, None] * valid[:, None, :]
    else:
        comp = cidgik.compile_cidgik(ps_c)
        X = ps_c.realization(q)[:, torch.as_tensor(comp.free_idx, device=q.device)]
        d = X.shape[-1]
        eye = torch.eye(d, dtype=q.dtype, device=q.device).expand(X.shape[0], d, d)
        Z = torch.cat([torch.cat([eye, X.transpose(-1, -2)], -1),
                       torch.cat([X, X @ X.transpose(-1, -2)], -1)], -2)
        mask = torch.ones(Z.shape[-2:], dtype=q.dtype, device=q.device)
    E = 1e-2 * torch.randn(Z.shape, generator=gen, dtype=q.dtype, device=gen.device).to(q.device)
    return (Z + E + E.transpose(-1, -2)) * mask


def eigh_phase(dev, cases, ur10_G, path_inputs):
    """Phase 19: K5 (csrc/eigh.cu) on the card. For each (tag, A) of
    `cases` and `path_inputs`: K5 against its plain version (ops/eigh.py
    sym_eigh_reference) bitwise, every matrix (eigenvalues, eigenvectors,
    flags), every flag set; ||A - V diag(w) V^T||_F / ||A||_F and max
    |V^T V - I| under EIGH_RES (past n = 64 in proportion to n,
    `eigh_res_tol`); the eigenvalues within EIGH_EIG ||A||_F of
    torch.linalg.eigh on the card (past n = 64 in proportion to n,
    `eigh_eig_tol`). On UR10's Gram at B = 8192 (ur10_G,
    float32 and float64): its first 501 matrices bitwise the same alone,
    the times of K5 (CUDA events), torch.linalg.eigh and the plain version
    beside the bound. On each of `path_inputs` (each path's matrices at the
    batch it launches, `eigh_path_inputs`): K5's and torch.linalg.eigh's
    times beside the bound; past n = 32 the sweeps a matrix, and in the log
    beside them the Jacobi's own count (`jacobi_ms`); on the paths of
    EIGH_OCCUPANCY_PATHS K5's time on their first 1024, 2048, 4096 and
    8192 matrices (the occupancy sweep: a kernel bound by its issue slots
    takes time in proportion, one bound by the latency of its steps about
    the same time). Returns the phase's record (K5's time at the main
    path's shape, float32, heads the kernels' record)."""
    import torch

    from graphik_tpu_torch.ops.eigh import sym_eigh_cuda, sym_eigh_reference

    t_phase = time.perf_counter()
    shapes = []
    err = 0.0
    sweeps = {}  # the plain version's sweeps a matrix past n = 32, by stack
    for tag, A in cases + path_inputs:
        key = "f64" if A.dtype == torch.float64 else "f32"
        w, V, conv = sym_eigh_cuda(A)
        w_p, V_p, conv_p, ran = sym_eigh_reference(A, sweeps=True)
        sync(dev)
        if A.shape[-1] > 32:
            ran = ran.reshape(-1)
            sweeps[id(A)] = {"mean_sweeps": float(ran.double().mean()),
                             "max_sweeps": int(ran.max())}
        same = bool(torch.equal(w, w_p) and torch.equal(V, V_p) and torch.equal(conv, conv_p))
        err = max(err, float((w - w_p).abs().max()), float((V - V_p).abs().max()))
        n = A.shape[-1]
        Ad, wd, Vd = A.double(), w.double(), V.double()
        scale = torch.linalg.matrix_norm(Ad)
        res = float((torch.linalg.matrix_norm(Ad - (Vd * wd[..., None, :]) @ Vd.transpose(-1, -2))
                     / scale).max())
        orth = float((Vd.transpose(-1, -2) @ Vd - torch.eye(n, dtype=torch.float64, device=dev))
                     .abs().max())
        # past n = 64 torch.linalg.eigh takes ~1.5 ms a matrix: the first
        # EIGH_LIB_B matrices
        nl = EIGH_LIB_B if n > 64 else A.shape[0]
        d_lib = float(((wd[:nl] - torch.linalg.eigvalsh(A[:nl]).double()).abs()
                       / scale[:nl][..., None]).max())
        n_conv = int(conv.sum())
        log(f"[19] {tag}: {tuple(A.shape)} {key}: K5 bitwise its plain version {same}; converged "
            f"{n_conv}/{conv.numel()}; residual {res:.2e}, max |V^T V - I| {orth:.2e} (<= "
            f"{eigh_res_tol(key, n):.1e}); eigenvalues against torch.linalg.eigh "
            f"{d_lib:.2e} of "
            f"||A||_F (<= {eigh_eig_tol(key, n):.1e}, the first {nl})")
        check(same, f"{tag}: K5 differs from its plain version")
        check(n_conv == conv.numel(), f"{tag}: a matrix did not converge")
        check(res <= eigh_res_tol(key, n) and orth <= eigh_res_tol(key, n),
              f"{tag}: residual or orthogonality")
        check(d_lib <= eigh_eig_tol(key, n), f"{tag}: eigenvalues apart from torch.linalg.eigh's")
        shapes.append({"case": tag, "shape": list(A.shape), "dtype": key, "bitwise": same,
                       "residual": res, "orthogonality": orth, "eig_vs_library": d_lib})
    timing = {}
    for G in ur10_G:
        key = "f64" if G.dtype == torch.float64 else "f32"
        B, n = G.shape[0], G.shape[-1]
        w, V, _ = sym_eigh_cuda(G)
        w1, V1, _ = sym_eigh_cuda(G[:501].clone())
        alone = bool(torch.equal(w1, w[:501]) and torch.equal(V1, V[:501]))
        log(f"[19] UR10 Gram {key}: the first 501 of {B} matrices alone bitwise as in the batch: "
            f"{alone}")
        check(alone, "K5 is not batch-invariant")
        ms = event_ms(lambda: sym_eigh_cuda(G), 20)
        ms_lib = event_ms(lambda: torch.linalg.eigh(G), 5)
        ms_plain = event_ms(lambda: sym_eigh_reference(G), 1)
        b = eigh_bound(n, B, G.dtype)
        timing[key] = {"B": B, "n": n, "ms": ms, "library_ms": ms_lib, "plain_ms": ms_plain,
                       "bound_ms": b[0], "bound_by": b[1]}
        log(f"[19] UR10 Gram, B = {B}, n = {n}, {key}: K5 {ms:.3f} ms, torch.linalg.eigh "
            f"{ms_lib:.3f} ms, plain version {ms_plain:.1f} ms, bound {b[0] * 1e3:.2f} us "
            f"({b[1]})")
    paths = []
    for tag, A in path_inputs:
        B, n = A.shape[0], A.shape[-1]
        ms = event_ms(lambda: sym_eigh_cuda(A), 20 if n <= 64 else 3)
        # past n = 32 torch.linalg.eigh takes seconds a call at B = 8192: one
        # timed call, warmed by the eigenvalue check's torch.linalg.eigvalsh
        # on this stack above; past 64 on the first EIGH_LIB_B matrices
        # (~1.5 ms a matrix), its time at B scaled by B / EIGH_LIB_B
        if n <= 32:
            ms_lib = event_ms(lambda: torch.linalg.eigh(A), 5)
        elif n <= 64:
            ms_lib = event_ms(lambda: torch.linalg.eigh(A), 1, warm=False)
        else:
            A_l = A[:EIGH_LIB_B].contiguous()
            ms_lib = event_ms(lambda: torch.linalg.eigh(A_l), 1, warm=False) * B / EIGH_LIB_B
        b = eigh_bound(n, B, A.dtype)
        rec = {"case": tag, "B": B, "n": n, "ms": ms, "library_ms": ms_lib, "bound_ms": b[0],
               "bound_by": b[1]}
        if n > 64:
            rec["library_B"] = EIGH_LIB_B
        if n > 32:
            rec.update(sweeps[id(A)])
        if tag.rsplit(" ", 1)[0] in EIGH_OCCUPANCY_PATHS:
            rec["occupancy_ms"] = {
                B_o: event_ms(lambda X=A[:B_o].contiguous(): sym_eigh_cuda(X), 20)
                for B_o in EIGH_OCCUPANCY_B}
        paths.append(rec)
        log(f"[19] path {tag}: B = {B}, n = {n}: K5 {ms:.4f} ms, torch.linalg.eigh "
            f"{ms_lib:.3f} ms, bound {b[0] * 1e3:.2f} us ({b[1]})"
            + (f"; {rec['mean_sweeps']:.3f} sweeps a matrix (max {rec['max_sweeps']}), the "
               f"Jacobi's own count "
               f"{jacobi_ms(n, B, A.dtype, rec['mean_sweeps']):.3f} ms" if n > 32 else "")
            + ("; on the first B matrices: " + ", ".join(
                f"B = {B_o}: {t:.4f} ms" for B_o, t in rec["occupancy_ms"].items())
               if "occupancy_ms" in rec else ""))
    log(f"[19] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"shapes": shapes, "timing": timing, "paths": paths, "max_abs_err": err}


def spd_bound(m, B, dtype):
    """(ms, "operations" or "bytes") of B clamped-pivot solves of size m,
    counted from csrc/spd_solve.cu: column j of the factor takes m - j dots
    of j products and j adds and a subtract each, a square root and
    m - j - 1 divisions; each substitution m subtracts and divisions and
    m (m - 1) / 2 products and adds; A's lower triangle (m (m + 1) / 2,
    the only part the kernel and the function it replaces read) and b (m)
    read and x (m) written a system. Over the card's non-tensor rate of the
    type and its memory rate."""
    import torch

    size = 8 if dtype == torch.float64 else 4
    peak = PEAK_F64 if dtype == torch.float64 else PEAK_F32
    flops = (sum((m - j) * (2 * j + 1) + 1 + (m - j - 1) for j in range(m))
             + 2 * (2 * m + m * (m - 1)))
    t_op, t_b = flops * B / peak * 1e3, (m * (m + 1) // 2 + 2 * m) * size * B / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def lm_systems(ps_, B, dtype, gen, dev):
    """The LM's damped systems (H = J^T J + lam I, g = J^T r, as
    solvers/local.py forms them) of B random goals of `ps_` at other
    random configurations, lam from 1e-12 to 1e-3 (log-uniform): the
    shape and the content the polish hands K6 at that path's batch."""
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.solvers import local

    T_goal = api.random_goals(ps_, (B,), gen, dtype=dtype, device=dev)[0]
    q = api.random_goals(ps_, (B,), gen, dtype=dtype, device=dev)[1]
    r, J = local._pose_residuals(ps_.template, T_goal, q)
    lam = 10.0 ** (-12.0 + 9.0 * torch.rand((B, 1, 1), generator=gen, dtype=dtype).to(dev))
    n = ps_.template.n
    H = J.transpose(-1, -2) @ J + lam * torch.eye(n, dtype=dtype, device=dev)
    return H, (J * r[..., :, None]).sum(-2)


def spd_random(m, B, dtype, gen, dev):
    """B random systems of size m, a quarter each: SPD (X X^T / m + I),
    ill-conditioned (J^T J + 1e-12 I, J 3 x m: planar40's LM systems at the
    damping's floor), indefinite (X D X^T / m, D = +-1: the clamp engages),
    and the ill-conditioned ones with a NaN in A's lower triangle or in b."""
    import torch

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64).to(dev)

    q = B // 4
    X, J = normal(B, m, m), normal(B, 3, m)
    D = torch.where(torch.rand((B, 1, m), generator=gen, dtype=torch.float64).to(dev) < 0.3,
                    -1.0, 1.0)
    eye = torch.eye(m, dtype=torch.float64, device=dev)
    A = torch.cat([(X @ X.transpose(1, 2) / m + eye)[:q],
                   (J.transpose(1, 2) @ J + 1e-12 * eye)[q:2 * q],
                   ((X * D) @ X.transpose(1, 2) / m)[2 * q:3 * q],
                   (J.transpose(1, 2) @ J + 1e-12 * eye)[3 * q:]])
    b = normal(B, m)
    rows = torch.arange(3 * q, B, device=dev)
    A[rows[::2], m - 1, 0] = float("nan")
    b[rows[1::2], m // 2] = float("nan")
    return A.to(dtype), b.to(dtype)


def spd_cases(dev, gen):
    """(tag, A, b) of phase 21: each path's LM systems at the batch its
    polish hands K6 (`lm_systems`: UR10, KUKA iiwa, LWA4D, planar6,
    planar10, the tree's 3 x 1000 restarts, planar40, dh19, planar100,
    dh40 at float32, UR10 at float64, dense CIDGIK's finish at B_CIDGIK),
    then random systems at m = 3, 33, 64, 128 (`spd_random`, B_MAIN,
    float32 and float64)."""
    import torch

    from graphik_tpu_torch.robots.library import (
        load_kuka, load_planar_chain, load_schunk_lwa4d, load_tree5, load_ur10)

    ps_u = load_ur10()[1]
    cases = [("ur10", *lm_systems(ps_u, B_MAIN, torch.float32, gen, dev)),
             ("kuka_iiwa", *lm_systems(load_kuka()[1], B_MAIN, torch.float32, gen, dev)),
             ("lwa4d", *lm_systems(load_schunk_lwa4d()[1], B_MAIN, torch.float32, gen, dev)),
             ("planar6", *lm_systems(load_planar_chain(6, limits=np.pi / 2)[1], B_MAIN,
                                     torch.float32, gen, dev)),
             ("planar10", *lm_systems(load_planar_chain(10, limits=np.pi / 2)[1], B_MAIN,
                                      torch.float32, gen, dev)),
             ("tree_restarts3", *lm_systems(load_tree5()[1], 3 * B_TREE, torch.float32, gen,
                                            dev)),
             *((tag, *lm_systems(ps_l, B_MAIN, torch.float32, gen, dev))
               for tag, ps_l, _ in past32_structures()),
             ("ur10_f64", *lm_systems(ps_u, B_F64, torch.float64, gen, dev)),
             ("ur10_cidgik", *lm_systems(ps_u, B_CIDGIK, torch.float32, gen, dev))]
    for m in (3, 33, 64, 128):
        for dt in (torch.float32, torch.float64):
            cases.append((f"random m={m}", *spd_random(m, B_MAIN, dt, gen, dev)))
    return cases


def spd_phase(dev, gen):
    """Phase 21: K6 (csrc/spd_solve.cu), the LM's clamped-pivot solve, on
    the card. For each path's LM systems at the batch its polish hands
    K6 (`lm_systems`: UR10, KUKA iiwa, LWA4D, planar6, planar10, the tree's
    3 x 1000 restarts, planar40, dh19, planar100, dh40 at float32, UR10 at
    float64, dense CIDGIK's finish at B_CIDGIK) and for random systems at
    m = 3, 33, 64, 128 (`spd_random`, B_MAIN, float32 and float64): K6
    against its plain version (ops/linalg.py spd_solve_reference) bitwise,
    NaN where the
    plain version has NaN; K6's time (CUDA events) beside its bound and
    beside the library's cholesky_ex and two solve_triangular on the same
    inputs (what the port ran before: not the same function, its pivots
    are not clamped); the plain version's time at UR10's shape; UR10's
    first 501 systems bitwise the same alone. Returns the phase's record
    (UR10's float32 shape heads K6's kernels entry)."""
    import torch

    from graphik_tpu_torch.ops.linalg import spd_solve_cuda, spd_solve_reference

    def library(A, b):
        L = torch.linalg.cholesky_ex(A)[0]
        w = torch.linalg.solve_triangular(L, b[..., None], upper=False)
        return torch.linalg.solve_triangular(L.transpose(-1, -2), w, upper=True)[..., 0]

    t_phase = time.perf_counter()
    cases = spd_cases(dev, gen)
    records, err = [], 0.0
    for tag, A, b in cases:
        key = "f64" if A.dtype == torch.float64 else "f32"
        B, m = b.shape
        x = spd_solve_cuda(A, b)
        x_p = spd_solve_reference(A, b)
        sync(dev)
        nan_k, nan_p = torch.isnan(x), torch.isnan(x_p)
        same = bool(torch.equal(nan_k, nan_p)
                    and torch.equal(torch.nan_to_num(x, nan=0.0), torch.nan_to_num(x_p, nan=0.0)))
        fin = torch.isfinite(x) & torch.isfinite(x_p)
        err = max(err, float((x - x_p)[fin].abs().max()) if bool(fin.any()) else 0.0)
        call = event_ms(lambda: spd_solve_cuda(A, b), 20)
        ms = graph_ms(lambda: spd_solve_cuda(A, b), 20)
        ms_lib = event_ms(lambda: library(A, b), 5)
        bd = spd_bound(m, B, A.dtype)
        rec = {"case": tag, "B": B, "m": m, "dtype": key, "bitwise": same,
               "nan_systems": int(nan_k.any(-1).sum()), "ms": ms, "call_ms": call,
               "library_ms": ms_lib, "bound_ms": bd[0], "bound_by": bd[1]}
        if tag == "ur10":
            rec["plain_ms"] = event_ms(lambda: spd_solve_reference(A, b), 3)
            x1 = spd_solve_cuda(A[:501].clone(), b[:501].clone())
            alone = torch.equal(x1, x[:501])
            log(f"[21] ur10: the first 501 of {B} systems alone bitwise as in the batch: {alone}")
            check(alone, "K6 is not batch-invariant")
        log(f"[21] {tag}: B = {B}, m = {m}, {key}: K6 bitwise its plain version {same} "
            f"({rec['nan_systems']} systems with NaN); K6 {ms:.4f} ms device (a graph of "
            f"20 launches), {call:.4f} ms a wrapper call, cholesky_ex + 2 "
            f"solve_triangular {ms_lib:.4f} ms, bound {bd[0] * 1e3:.2f} us ({bd[1]})"
            + (f", plain version {rec['plain_ms']:.2f} ms" if "plain_ms" in rec else ""))
        check(same, f"{tag}: K6 differs from its plain version")
        records.append(rec)
    log(f"[21] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"cases": records, "max_abs_err": err}


def finish_rounding_phase(dev, gen, params, polish):
    """Phase 22: the finish's one rounding (utils/lie.py matmul_small and
    its kin). On 64 planar40 goals (full smoothing) and 64 UR10 goals at the
    UR10 path's parameters, solved on the card eagerly: each stage of the
    finish before the polish from the card's own input to it, on the card
    and on the CPU (joint_variables from Y, realization from the card's q,
    check_distance_limits from the card's positions, pose_error from the
    card's q); then the polish (api.polish_solution) from the card's
    values before it, on the card and on the CPU. Every entry of every stage
    and of the polish's q, pose errors, violation and verdict must be the
    same bits on both, and so must the verdicts (1 mm, 1 degree, the limits)
    before the polish and after it: UR10's goals succeed only after it.
    (sin, cos and atan2 are taken in float64 and rounded once, lie.sin_rn
    and kin, which could part only where a float64 value lies within its own
    error of a float32 rounding boundary, about 2^-28 of them.) Returns the
    phase's record."""
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import load_planar_chain, load_ur10

    def verdict(e_pos, e_rot, ok):
        return (e_pos < 1e-3) & (e_rot < np.pi / 180) & ok

    t_phase = time.perf_counter()
    record = {}
    for tag, ps_, smooth in (("planar40", load_planar_chain(40, limits=np.pi / 2)[1], None),
                             ("ur10", load_ur10()[1], 2)):
        solver = api.Solver(ps_, params=params, polish_params=polish, smooth_iters=smooth)
        T_goal = api.random_goals(ps_, (B_SMALL,), gen, dtype=torch.float32, device=dev)[0]
        Y = solver.solve(*reversed(solver.prepare(T_goal)))["Y"]

        def both(fn, *args):
            card = fn(*args)
            cards = card if isinstance(card, tuple) else (card,)
            cpu = fn(*[a.cpu() for a in args])
            cpus = cpu if isinstance(cpu, tuple) else (cpu,)
            return card, sum(int((a.cpu() != b).sum()) for a, b in zip(cards, cpus)), cpu

        q, d_q, _ = both(ps_.joint_variables, Y, T_goal)
        pos, d_pos, _ = both(ps_.realization, q)
        (viol, ok), d_viol, _ = both(ps_.check_distance_limits, pos)
        (e_pos, e_rot), d_err, _ = both(lambda a, b: api.pose_error(ps_, a, b), q, T_goal)
        pre = (q, e_pos, e_rot, viol, ok)
        post, d_post, post_cpu = both(lambda T, *v: api.polish_solution(
            ps_, v[0], T, *v[1:], limit_tol=solver.limit_tol, params=polish), T_goal, *pre)
        q_c = ps_.joint_variables(Y.cpu(), T_goal.cpu())
        v_c, ok_c = ps_.check_distance_limits(ps_.realization(q_c))
        ep_c, er_c = api.pose_error(ps_, q_c, T_goal.cpu())
        ok_pre = verdict(e_pos, e_rot, ok).cpu()
        ok_post = verdict(post[1], post[2], post[4]).cpu()
        ok_post_c = verdict(post_cpu[1], post_cpu[2], post_cpu[4])
        rec = {"B": B_SMALL, "differing_entries": {
            "joint_variables": d_q, "realization": d_pos, "check_distance_limits": d_viol,
            "pose_error": d_err, "polish": d_post},
            "verdicts_differ": int((ok_pre != verdict(ep_c, er_c, ok_c)).sum()),
            "verdicts_differ_after_polish": int((ok_post != ok_post_c).sum()),
            "card_successes": int(ok_pre.sum()), "card_successes_after_polish": int(ok_post.sum())}
        record[tag] = rec
        log(f"[22] {tag}: the finish, card against CPU from the card's own inputs, "
            f"{B_SMALL} goals: differing entries {rec['differing_entries']}; verdicts that "
            f"differ between the card's finish and the CPU's finish of the card's Y: "
            f"{rec['verdicts_differ']} before the polish ({rec['card_successes']} successes), "
            f"{rec['verdicts_differ_after_polish']} after it "
            f"({rec['card_successes_after_polish']} successes)")
        for stage, n in rec["differing_entries"].items():
            check(n == 0, f"{tag}: {stage} rounds otherwise on the card ({n} entries)")
        check(rec["verdicts_differ"] == 0 and rec["verdicts_differ_after_polish"] == 0,
              f"{tag}: the card's verdicts differ from the CPU's")
    log(f"[22] phase took {time.perf_counter() - t_phase:.1f} s")
    return record


def cidgik_phases(dev, gen, cfgs, position_runs=None):
    """The CIDGIK paths: for each (tag, phase, structure, B, production
    overrides, sparse), the compiled form - the ADMM through the
    template's loop graphs (SYNC_EVERY steps a graph between two host
    reads), the finish through a StageGraphs - and the eager form
    (compiled.eager_loops(), the finish eager) on the same goals: a first
    compiled call (warm-up and capture), one profiled call of each form
    (the launches, host launches and device-busy share of each stage) and
    one timed call of each, whose outputs must be bitwise equal, with equal
    ADMM steps and host reads; success at or above the floor, finite
    outputs of the right shapes (and, with obstacles, successful lanes
    clear of every sphere), the graph pools' memory, and a 16-goal batch on
    `dev` against the same call on the CPU; on the sparse path, also K5 on
    its clique blocks on `dev` (`eigh_check`), and on the dense UR10 path
    an ADMM with the eigh cone projection at B = 64, compiled against eager
    (`eigh_cone_check`). The Fantope step runs on K5 once a round; none of
    K1-K4 may launch. Appends each path without obstacles, as a compiled
    call on its goals, to position_runs (phase 18's batch-position check;
    the table's calls take ~3 s each). Returns one record per path."""
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.ops.linalg import spd_solve_cuda
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda
    from graphik_tpu_torch.solvers import cidgik, cidgik_sparse
    from graphik_tpu_torch.utils import compiled

    records = []
    for tag, phase, ps_c, B_c, overrides, sparse in cfgs:
        t_phase = time.perf_counter()
        params = cidgik.CidgikParams.production(**overrides)
        if sparse:
            comp = cidgik_sparse.compile_cidgik_sparse(ps_c)
            op = cidgik_sparse._build_sparse_split_operator(comp)
            solve = cidgik_sparse.solve_cidgik_sparse
            blocks = (comp.K, comp.ds)
            log(f"[{phase}] {tag}: N = {ps_c.N}, {comp.K} cliques of {[len(c) for c in comp.cliques]} "
                f"free nodes, blocks ds = {comp.ds}, static rows m_s = {op.m_s} ({op.m_eq_s} "
                f"equalities, {op.m_in_s} bounds), goal rows m_d = {op.m_d}; B = {B_c}; {params}")
        else:
            comp = cidgik.compile_cidgik(ps_c)
            op = cidgik._build_split_operator(comp)
            solve = cidgik.solve_cidgik
            blocks = (1, comp.s)
            log(f"[{phase}] {tag}: N = {ps_c.N}, s = {comp.s}, m_eq = {comp.m_eq}, m_in = "
                f"{comp.m_in}, static rows m_s = {op.m_s}, goal rows m_d = {op.m_d}; B = {B_c}; "
                f"{params}")

        def goals_c(B, device=dev, ps_=ps_c):
            return api.random_goals(ps_, (B,), gen, dtype=torch.float32, device=device)[0]

        T_goal = goals_c(B_c)
        fin_graphs = compiled.StageGraphs()
        forms = {"compiled": (contextlib.nullcontext, fin_graphs),
                 "eager": (compiled.eager_loops, None)}
        # the first compiled call: each ADMM piece and the finish run once
        # eagerly (the warm-up) and are captured
        t_cap = cidgik_call(solve, comp, ps_c, T_goal, params, fin_graphs)[:2]
        log(f"[{phase}] {tag} first compiled call (warm-up + capture): ADMM {t_cap[0] * 1e3:.1f} "
            f"ms, finish {t_cap[1] * 1e3:.1f} ms")
        # the launches and device-busy share of each compiled stage from one
        # profiled call (the eager form's hundreds of thousands of host
        # launches made its profile the phase's largest cost), then one
        # timed call of each form, the eager one after a warm-up call (one
        # ADMM round cut to 50 steps, then the finish)
        counters = (solve_tr_cuda, edge_ops.cost_and_egrad_cuda, edge_ops.ehess_cuda)
        for f in counters:
            f.launches = 0
        spd_solve_cuda.launches = 0
        finish = cidgik_finish(ps_c)
        prof, timed = {}, {}
        for name, (mode, graphs) in forms.items():
            out_p = {}
            with mode():
                if graphs is not None:
                    p_a = profiled(lambda: out_p.update(solve(comp, T_goal, params=params)), dev)
                    q0 = out_p["q"]
                    p_f = profiled(lambda: graphs.run("finish", finish, q0, T_goal), dev)
                    prof[name] = (p_a, p_f)
                else:
                    warm = solve(comp, T_goal, params=dataclasses.replace(
                        params, max_outer=1, admm_iters=50))
                    finish(warm["q"], T_goal)
                cidgik.solve_cidgik.admm_steps = cidgik.solve_cidgik.host_reads = 0
                t_admm, t_fin, o = cidgik_call(solve, comp, ps_c, T_goal, params, graphs)
            timed[name] = (t_admm, t_fin, o, cidgik.solve_cidgik.admm_steps,
                           cidgik.solve_cidgik.host_reads)
        hand = sum(f.launches for f in counters)
        # the finish's polish_solution: K6 once an LM step, four finishes
        k6_want = 4 * lm_launches(api.Solver(ps_c))  # polish_solution's default polish
        log(f"[{phase}] {tag}: K1-K4 launches during the phase's calls: {hand}; K6 "
            f"{spd_solve_cuda.launches} (4 finishes, {k6_want // 4} each)")
        check(hand == 0, f"{tag}: the CIDGIK path launched one of K1-K4")
        check(spd_solve_cuda.launches == k6_want, f"{tag}: the finish did not launch K6 once an "
              "LM step")
        t_admm, t_fin, o, steps, reads = timed["compiled"]
        differ = differing(o, timed["eager"][2])
        log(f"[{phase}] {tag}: compiled against eager on the same goals: outputs bitwise equal "
            f"{not differ} {differ or ''}; ADMM steps {steps} / {timed['eager'][3]}, host reads "
            f"{reads} / {timed['eager'][4]}")
        check(not differ, f"{tag}: the compiled CIDGIK outputs differ from the eager ones")
        check(steps == timed["eager"][3] and reads == timed["eager"][4],
              f"{tag}: the compiled CIDGIK path's steps or host reads differ from the eager ones")
        shapes = {"q": (B_c, ps_c.n), "T_base": (B_c, 4, 4), "points": (B_c, ps_c.N, 3),
                  "status": (B_c,), "eig_sum": (B_c,), "feas": (B_c,), "q_polished": (B_c, ps_c.n),
                  "e_pos": (B_c,), "e_rot": (B_c,)}
        for k, shape in shapes.items():
            check(tuple(o[k].shape) == shape, f"{tag}: {k} has shape {tuple(o[k].shape)}")
            check(bool(torch.isfinite(o[k].double()).all()), f"{tag}: non-finite {k}")
        hit = (o["e_pos"] < 1e-3) & (o["e_rot"] < np.deg2rad(1.0)) & o["ok"]
        rate = float(hit.double().mean())
        raw = float(((o["e_pos0"] < 1e-2) & (o["e_rot0"] < 1e-2)).double().mean())
        anc = ps_c.goal_positions(T_goal)[:, torch.as_tensor(comp.anchor_idx, device=dev)]
        aux = cidgik_sparse._sparse_split_aux(op, anc) if sparse else cidgik._split_aux(op, anc)
        n_schur = int(aux["schur_info"].ne(0).sum())
        b_ms = cidgik_flops(op, blocks, B_c, steps) / PEAK_F32 * 1e3
        pool = pool_bytes([cidgik._graphs(comp), fin_graphs]) / 2**20
        log(f"[{phase}] {tag} timed compiled call: ADMM {t_admm * 1e3:.1f} ms ({steps} "
            f"iterations), finish {t_fin * 1e3:.1f} ms, total {(t_admm + t_fin) * 1e3:.1f} ms, "
            f"{B_c / (t_admm + t_fin):.1f} solves/s (eager: ADMM {timed['eager'][0] * 1e3:.1f} ms, "
            f"finish {timed['eager'][1] * 1e3:.1f} ms, {B_c / sum(timed['eager'][:2]):.1f} "
            f"solves/s); success {rate:.4f} (floor {FLOORS[tag]}), raw ADMM @1cm {raw:.4f}, median "
            f"|eig_sum| {float(o['eig_sum'].abs().median()):.3e}, median feas "
            f"{float(o['feas'].median()):.3e}, status INFEASIBLE on "
            f"{int(o['status'].ne(cidgik.FEASIBLE).sum())}; ADMM flop bound (products and "
            f"Newton-Schulz) {b_ms:.3f} ms at {PEAK_F32 / 1e12:.0f} TFLOP/s; lanes whose goal-row "
            f"Schur complement failed its Cholesky: {n_schur}; graph pools {pool:.1f} MiB")
        check(rate >= FLOORS[tag], f"{tag}: success below its floor")
        if ps_c.n_obstacles:
            centers = torch.tensor(np.stack([c for c, _ in ps_c.obstacles]), dtype=torch.float32,
                                   device=dev)
            radii = torch.tensor([r for _, r in ps_c.obstacles], dtype=torch.float32, device=dev)
            p = ps_c.realization(o["q_polished"])[:, 1:ps_c.n + 1]
            clear = torch.linalg.norm(p[:, :, None, :] - centers, dim=-1) - radii
            worst = float(clear[hit].min())
            log(f"[{phase}] {tag}: least clearance over successful lanes {worst:.3e} m (>= -1e-3)")
            check(worst >= -1e-3, f"{tag}: a successful lane enters an obstacle")

        stats = {}
        for name in forms:
            ta, tf = timed[name][:2]
            stats[name] = {"admm_ms": ta * 1e3, "finish_ms": tf * 1e3,
                           "solves_per_s": B_c / (ta + tf), "host_reads": timed[name][4]}
            if name not in prof:
                continue
            (k_a, c_a, busy_a, h_a, _), (k_f, c_f, busy_f, h_f, _) = prof[name]
            stats[name].update(
                launches_admm=k_a, launches_per_iteration=k_a / steps, host_launches_admm=h_a,
                host_launches_per_iteration=h_a / steps, launches_finish=k_f,
                host_launches_finish=h_f, busy_admm=busy_a / (ta * 1e3),
                busy_finish=busy_f / (tf * 1e3))
            st = stats[name]
            log(f"[{phase}] {tag} {name}: ADMM {k_a} kernel launches + {c_a} copies/sets "
                f"({st['launches_per_iteration']:.1f} an iteration), {h_a} host launches "
                f"({st['host_launches_per_iteration']:.2f} an iteration), device busy "
                f"{busy_a:.1f} ms = {st['busy_admm']:.3f} of the timed ADMM wall; finish {k_f} "
                f"launches + {c_f} copies/sets, {h_f} host launches, busy {busy_f:.1f} ms = "
                f"{st['busy_finish']:.3f} of the timed finish wall; host reads {st['host_reads']}")

        # a 16-goal batch on the card against the same call on the CPU, at a
        # reduced budget shared by both
        small = dataclasses.replace(params, admm_iters=200, admm_iters_rest=100, max_outer=3)
        T16 = goals_c(16, device=torch.device("cpu")).numpy()
        o_g = solve(comp, T16, params=small, device=dev)
        o_c = solve(comp, T16, params=small, device="cpu")
        check(o_g["points"].device == dev and o_c["points"].device.type == "cpu",
              f"{tag}: the 16-goal calls ran on the wrong devices")
        d_pts = (o_g["points"].cpu() - o_c["points"]).abs().flatten(1).amax(1)
        d_eig_l = (o_g["eig_sum"].cpu() - o_c["eig_sum"]).abs()
        eig_tol = (sparse_eig_bound(o_c["eig_sum"]) if sparse
                   else torch.full_like(d_eig_l, EIG_TOL))
        d_eig, w = float(d_eig_l.max()), int((d_eig_l / eig_tol).argmax())
        dfe = (o_g["feas"].cpu() - o_c["feas"]).abs()
        d_feas, worst = float(dfe.max()), int(dfe.argmax())
        same_status = bool(torch.equal(o_g["status"].cpu(), o_c["status"]))
        n_close = int((d_pts <= 1e-3).sum())
        log(f"[{phase}] {tag} 16 goals, {dev.type} vs CPU at admm (200, 2 x 100): status equal "
            f"{same_status}; points within 1e-3 on {n_close}/16 lanes (max {float(d_pts.max()):.3e}); "
            f"max |d eig_sum| {d_eig:.3e}, nearest its bound on lane {w}: {float(d_eig_l[w]):.3e} "
            f"(<= {float(eig_tol[w]):.3e}, eig_sum {float(o_c['eig_sum'][w]):.3e}); max |d feas| "
            f"{d_feas:.3e} (<= {FEAS_TOL}; lane {worst}: {float(o_g['feas'][worst]):.3e} against "
            f"{float(o_c['feas'][worst]):.3e})")
        check(same_status and n_close >= 15 and bool((d_eig_l <= eig_tol).all())
              and d_feas <= FEAS_TOL, f"{tag}: the card and the CPU disagree on the 16-goal batch")
        record = {"path": tag, "B": B_c, "admm_ms": t_admm * 1e3, "finish_ms": t_fin * 1e3,
                  "solves_per_s": B_c / (t_admm + t_fin), "success": rate,
                  "admm_iterations": steps, "admm_bound_ms": b_ms, "host_reads": reads,
                  "first_call_ms": {"admm": t_cap[0] * 1e3, "finish": t_cap[1] * 1e3},
                  "graph_pool_mib": pool, "bitwise_vs_eager": not differ,
                  "compiled": stats["compiled"], "eager": stats["eager"],
                  "schur_failed": n_schur,
                  "card_vs_cpu": {"points_close": n_close, "d_eig_sum": d_eig,
                                  "d_eig_sum_over_bound": float(d_eig_l[w] / eig_tol[w]),
                                  "d_feas": d_feas}}
        if sparse:
            record["eigh_padded_blocks"] = eigh_check(phase, comp, ps_c, o, dev)
        elif not ps_c.n_obstacles:
            record["eigh_cone"] = eigh_cone_check(phase, tag, dev, comp, solve, goals_c(B_SMALL),
                                                  params)
        records.append(record)
        if position_runs is not None and not ps_c.n_obstacles:
            position_runs.append((tag, lambda T, s=solve, c=comp, p=ps_c, pa=params, g=fin_graphs:
                                  cidgik_call(s, c, p, T, pa, g)[2], T_goal, o))
        log(f"[{phase}] {tag}: phase took {time.perf_counter() - t_phase:.1f} s")
    return records


def eigh_cone_check(phase, tag, dev, comp, solve, T_goal, params):
    """The ADMM with the eigh cone projection (cone_ns_iters = 0: K5 every
    iteration) at a small batch, compiled - its pieces captured into the
    template's loop graphs, K5 inside them - against eager
    (compiled.eager_loops()) on the same goals, two calls each: outputs
    bitwise equal, equal ADMM steps, pieces captured on the first call and
    replayed on the second, K5 launched (and counted) on every call.
    Returns the record."""
    from graphik_tpu_torch.ops.eigh import sym_eigh_cuda
    from graphik_tpu_torch.solvers import cidgik
    from graphik_tpu_torch.utils import compiled

    params = dataclasses.replace(params, cone_ns_iters=0, admm_iters=100, admm_iters_rest=50,
                                 max_outer=2)
    rec = {"B": int(T_goal.shape[0]), "calls": []}
    for call in range(2):
        pieces = sum(len(b.pieces) for b in cidgik._graphs(comp).loops.values())
        runs = {}
        for name, mode in (("compiled", contextlib.nullcontext), ("eager", compiled.eager_loops)):
            with mode():
                cidgik.solve_cidgik.admm_steps = 0
                before = sym_eigh_cuda.launches
                sync(dev)
                t0 = time.perf_counter()
                out = solve(comp, T_goal, params=params)
                sync(dev)
                runs[name] = (out, time.perf_counter() - t0, cidgik.solve_cidgik.admm_steps,
                              sym_eigh_cuda.launches - before)
        grown = sum(len(b.pieces) for b in cidgik._graphs(comp).loops.values()) - pieces
        differ = differing(runs["compiled"][0], runs["eager"][0])
        c, e = runs["compiled"], runs["eager"]
        log(f"[{phase}] {tag}, eigh cone projection, B = {rec['B']}, call {call}: compiled "
            f"{c[1] * 1e3:.1f} ms / eager {e[1] * 1e3:.1f} ms, ADMM steps {c[2]} / {e[2]}, K5 "
            f"launches {c[3]} / {e[3]}, pieces captured {grown}; outputs bitwise equal "
            f"{not differ} {differ or ''}")
        check(not differ and c[2] == e[2], f"{tag}: the eigh-cone ADMM differs from its eager form")
        check(c[3] == e[3] and c[3] >= c[2], f"{tag}: K5 was not launched every ADMM step")
        check(grown > 0 if call == 0 else grown == 0,
              f"{tag}: the eigh-cone ADMM did not capture and replay its pieces")
        rec["calls"].append({"compiled_ms": c[1] * 1e3, "eager_ms": e[1] * 1e3,
                             "admm_steps": c[2], "k5_launches": c[3], "pieces_captured": grown,
                             "bitwise": not differ})
    return rec


def eigh_check(phase, comp, ps_c, out, dev):
    """K5 on `dev` on the sparse path's stacked clique blocks at its batch:
    the blocks of its solved points, plus symmetric noise (1e-2) on the
    valid slots, the padded rows and columns exactly zero; float32 and
    float64, bitwise its plain version, against the CPU's float64
    eigenvalues. Checks finite values and |d lambda| <= 1e-5 x the block's
    Frobenius norm."""
    import torch

    from graphik_tpu_torch.ops.eigh import sym_eigh_cuda, sym_eigh_reference
    from graphik_tpu_torch.solvers import cidgik_sparse

    pts = out["points"].double().cpu()[:, torch.as_tensor(comp.free_idx)]
    Z = cidgik_sparse.lifted_blocks(comp, pts)
    E = 1e-2 * torch.randn(Z.shape, generator=torch.Generator().manual_seed(SEED),
                           dtype=torch.float64)
    valid = torch.as_tensor(cidgik_sparse._valid_slots(comp.member, comp.d))
    Z = (Z + E + E.transpose(-1, -2)) * (valid[:, :, None] * valid[:, None, :])
    n_pad = int((valid == 0).sum())
    ref = torch.linalg.eigvalsh(Z)
    scale = torch.linalg.matrix_norm(Z)[..., None]
    errs = {}
    for dt in (torch.float32, torch.float64):
        lam, Q, conv = sym_eigh_cuda(Z.to(dev, dt))
        lam_p, Q_p, _ = sym_eigh_reference(Z.to(dev, dt))
        sync(dev)
        same = bool(torch.equal(lam, lam_p) and torch.equal(Q, Q_p))
        finite = bool(torch.isfinite(lam).all() and torch.isfinite(Q).all() and conv.all())
        err = float(((lam.double().cpu() - ref).abs() / scale).max())
        errs[str(dt).split(".")[-1]] = err
        log(f"[{phase}] K5 on {dev.type} of {tuple(Z.shape)} clique blocks ({n_pad} padded "
            f"slots a lane), {dt}: bitwise its plain version {same}, finite and converged "
            f"{finite}, max |d lambda| / ||Z_k||_F against the CPU's float64 {err:.3e} (<= 1e-5)")
        check(same and finite and err <= 1e-5, f"K5 on the padded clique blocks ({dt})")
    return errs


def compiled_vs_eager(phase, tag, dev, solver, T_goal, counter, profile=True):
    """A compiled solver whose solve is a loop of CUDA-graphed pieces (CG,
    the TR's "dense" / "edge" backends; utils/compiled.py Loop) and whose
    finish is one graph, against the same solver eager on the same
    prepared inputs: the first compiled call (warm-up and capture), then
    one profiled compiled solve (with `profile`: launches, host launches,
    device-busy share) and for each form one timed solve and finish, the
    eager one after a warm-up solve cut to 2 iterations. Checks every output
    bitwise equal and the host reads (`counter.host_reads`) equal. Returns
    (record, the compiled call's (sol, out))."""
    eager = dataclasses.replace(solver, graphs=None)
    solver.prepare(T_goal)  # the first call at this shape captures prepare
    sync(dev)
    t0 = time.perf_counter()
    D_goal, Y0 = solver.prepare(T_goal)
    sync(dev)
    t_prep = time.perf_counter() - t0
    first = []
    sol = solver.solve(Y0, D_goal)
    sync(dev)
    first.append(time.perf_counter() - t0 - t_prep)
    solver.finish(sol, T_goal)
    sync(dev)
    first.append(time.perf_counter() - t0 - t_prep - first[0])
    log(f"[{phase}] {tag} first compiled call (warm-up + capture of the loop's pieces and the "
        f"finish): solve {first[0] * 1e3:.1f} ms, finish {first[1] * 1e3:.1f} ms")
    rec = {"B": int(Y0.shape[0]), "prepare_ms": t_prep * 1e3,
           "first_call_ms": {"solve": first[0] * 1e3, "finish": first[1] * 1e3}}
    from graphik_tpu_torch.ops.linalg import spd_solve_cuda

    outs = {}
    spd_solve_cuda.launches = 0
    for name, s in (("compiled", solver), ("eager", eager)):
        # the eager solve is not profiled: its hundreds of thousands of host
        # launches made the profiler the phase's largest cost
        prof_solve = profile and name == "compiled"
        if prof_solve:
            k_s, c_s, busy, host, _ = profiled(lambda: s.solve(Y0, D_goal), dev)
        if name == "eager":
            dataclasses.replace(s, params=dataclasses.replace(s.params, maxiter=2)).solve(
                Y0, D_goal)
        counter.host_reads = 0
        sync(dev)
        t0 = time.perf_counter()
        sol = s.solve(Y0, D_goal)
        sync(dev)
        t1 = time.perf_counter()
        reads = counter.host_reads
        out = s.finish(sol, T_goal)
        sync(dev)
        t2 = time.perf_counter()
        outs[name] = (sol, out)
        n_it = int(sol["iterations"].max())  # the iterations the batch ran
        r = rec[name] = {"solve_ms": (t1 - t0) * 1e3, "finish_ms": (t2 - t1) * 1e3,
                         "solves_per_s": rec["B"] / (t_prep + t2 - t0), "host_reads": reads,
                         "iterations": n_it}
        msg = ""
        if prof_solve:
            r.update(launches_solve=k_s, launches_per_iteration=k_s / n_it, host_launches_solve=host,
                     host_launches_per_iteration=host / n_it, busy_solve=busy / r["solve_ms"])
            msg = (f"; profiled solve: {k_s} kernel launches + {c_s} copies/sets "
                   f"({k_s / n_it:.1f} an iteration), {host} host launches ({host / n_it:.2f} an "
                   f"iteration), device busy {busy:.1f} ms = {busy / r['solve_ms']:.3f} of the "
                   f"solve wall")
        log(f"[{phase}] {tag} {name}: solve {r['solve_ms']:.1f} ms ({n_it} iterations, {reads} "
            f"host reads), finish {r['finish_ms']:.1f} ms{msg}")
    check(spd_solve_cuda.launches == 2 * lm_launches(solver),
          f"{tag}: the two finishes launched K6 {spd_solve_cuda.launches} times, not once an LM "
          "step")
    differ = dict(differing(outs["compiled"][0], outs["eager"][0]),
                  **differing(outs["compiled"][1], outs["eager"][1]))
    pool = pool_bytes([solver.graphs]) / 2**20
    rec.update(bitwise_vs_eager=not differ, graph_pool_mib=pool)
    log(f"[{phase}] {tag}: compiled against eager on the same inputs: every output of solve and "
        f"finish bitwise equal {not differ} {differ or ''}; host reads "
        f"{rec['compiled']['host_reads']} / {rec['eager']['host_reads']}; solve "
        f"{rec['eager']['solve_ms'] / rec['compiled']['solve_ms']:.2f}x, finish "
        f"{rec['eager']['finish_ms'] / rec['compiled']['finish_ms']:.2f}x faster compiled; "
        f"graph pools {pool:.1f} MiB")
    check(not differ, f"{tag}: the compiled solver's outputs differ from the eager ones")
    check(rec["compiled"]["host_reads"] == rec["eager"]["host_reads"],
          f"{tag}: the compiled solve's host reads differ from the eager ones")
    return rec, outs["compiled"]


def cg_phase(dev, gen, ps, polish, position_runs=None):
    """The CG path (ur10_cg): make_solver with CGParams.production() at
    B_CG, compiled (its loop's pieces and the finish as CUDA graphs) against
    eager on the same inputs (compiled_vs_eager: walls, launches, host reads,
    busy share, every output bitwise), success at or above the floor, no TR
    kernel launched, and 64 goals on `dev` against the CPU: solve_cg's
    trajectories from the same Y0 at float64 and float32, then the whole
    solver. Appends the compiled solver on its goals to position_runs
    (phase 18). Returns its record."""
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda
    from graphik_tpu_torch.solvers import riemannian
    from graphik_tpu_torch.solvers.riemannian import CGParams

    t_phase = time.perf_counter()
    tag = "ur10_cg"
    params = CGParams.production()
    solver = api.make_solver(ps, params=params, polish_params=polish, smooth_iters=2)
    log(f"[14] {tag}: UR10, B = {B_CG}; {params}")

    def goals(B, device=dev):
        return api.random_goals(ps, (B,), gen, dtype=torch.float32, device=device)[0]

    T_goal = goals(B_CG)
    solve_tr_cuda.launches = 0
    rec, (_, out) = compiled_vs_eager("14", tag, dev, solver, T_goal, riemannian.solve_cg)
    fwd = dict(zip(("D_goal", "Y0"), solver.prepare(T_goal)), **out)
    tr = solve_tr_cuda.launches
    log(f"[14] {tag}: TR kernel launches during the phase's calls: {tr}")
    check(tr == 0, f"{tag}: the CG path launched the TR kernel")
    for k in ("q", "Y", "e_pos", "e_rot", "cost", "iterations"):
        check(out[k].shape[0] == B_CG and bool(torch.isfinite(out[k].double()).all()),
              f"{tag}: {k} has the wrong shape or is not finite")
    check(not bool(out["num_inner"].any()), f"{tag}: num_inner is not zero")
    summ = api.summarize(out)
    it = out["iterations"].double()
    c = rec["compiled"]
    log(f"[14] {tag} compiled call: prepare {rec['prepare_ms']:.1f} ms, solve {c['solve_ms']:.1f} "
        f"ms ({c['host_reads']} host reads; iterations mean {float(it.mean()):.1f}, max "
        f"{int(it.max())}), finish {c['finish_ms']:.1f} ms, {c['solves_per_s']:.1f} solves/s "
        f"(eager {rec['eager']['solves_per_s']:.1f}); success {summ['success_rate']:.4f} (floor "
        f"{FLOORS[tag]}), pose only {summ['pose_only_rate']:.4f}, median e_pos "
        f"{summ['median_pos_err']:.3e} m")
    check(summ["success_rate"] >= FLOORS[tag], f"{tag}: success below its floor")

    T64 = goals(64, device=torch.device("cpu"))
    D64, Y64 = solver.prepare(T64)
    traj = {}
    for dt, kw, tol in ((torch.float64, CG_TRAJ64, CG_TOL64), (torch.float32, CG_TRAJ32, CG_TOL32)):
        o_g, o_c = (riemannian.solve_cg(Y64.to(d_, dt), D64.to(d_, dt), solver.omega, solver.psi_L,
                                        solver.psi_U, params=CGParams.production(**kw))
                    for d_ in (dev, torch.device("cpu")))
        same_it = bool(torch.equal(o_g["iterations"].cpu(), o_c["iterations"]))
        d_Y = float((o_g["Y"].cpu() - o_c["Y"]).abs().max())
        d_cost = float((o_g["cost"].cpu() - o_c["cost"]).abs().max()
                       / max(1.0, float(o_c["cost"].abs().max())))
        name = str(dt).split(".")[-1]
        traj[name] = {"d_Y": d_Y, "d_cost": d_cost}
        log(f"[14] {tag} 64 goals, solve_cg from the same Y0 on {dev.type} and the CPU, {name}, "
            f"{kw}: iterations equal {same_it} (counts {sorted(set(o_c['iterations'].tolist()))}), "
            f"max |d Y| {d_Y:.3e}, max |d cost| / max(1, cost) {d_cost:.3e} (<= {tol})")
        check(same_it and d_Y <= tol and d_cost <= tol,
              f"{tag}: the card's CG trajectory leaves the CPU's ({name})")
    s_g = api.summarize(solver(T64.to(dev)))["success_rate"] * 64
    o_c = solver(T64)
    check(o_c["Y"].device.type == "cpu", f"{tag}: the CPU call ran on {o_c['Y'].device}")
    s_c = api.summarize(o_c)["success_rate"] * 64
    log(f"[14] {tag} 64 goals: successes on the card {s_g:.0f}, on the CPU {s_c:.0f} "
        f"(|d| <= {CG_CARD_CPU_GOALS})")
    check(abs(s_g - s_c) <= CG_CARD_CPU_GOALS, f"{tag}: card and CPU success differ")
    log(f"[14] {tag}: phase took {time.perf_counter() - t_phase:.1f} s")
    rec.update(path=tag, success=summ["success_rate"], mean_iterations=float(it.mean()),
               card_vs_cpu_successes=[s_g, s_c], card_vs_cpu_trajectory=traj)
    if position_runs is not None:
        position_runs.append((tag, lambda T: path_outputs(solver, T), T_goal, fwd))
    return rec


def ring_phase(dev, gen, polish, graphed):
    """Phase 15, planar10_ring6 (load_planar_chain(10, limits=pi/2) and the
    six circles of ring_environment): the anchored TR kernel's <2, 2, 16,
    true> instance against its plain version on the path's prepared inputs
    at B_CHECK (one step, then production(250, 32): every lane bitwise
    equal), its launch shape, registers and spills; make_solver at B_MAIN
    with production(250, 32), the polish and 2-squaring smoothing: one warm
    and 2 timed calls with per-stage walls, one anchored launch a call,
    success at or above the floor on each, every successful lane's
    p1..p10 at least radius - 1e-3 from every centre; the kernel's and the
    plain version's times; 64 goals on the card against the CPU. Appends
    the compiled path to `graphed` (phase 18). Returns the kernel's
    record."""
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.ops import tr_solve
    from graphik_tpu_torch.ops.linalg import spd_solve_cuda
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda, solve_tr_reference
    from graphik_tpu_torch.robots.library import load_planar_chain
    from graphik_tpu_torch.solvers.riemannian import TRParams
    from graphik_tpu_torch.utils.environments import ring_environment

    t_phase = time.perf_counter()
    tag = "planar10_ring6"
    tpl = load_planar_chain(10, limits=np.pi / 2)[0]
    ps = ProblemStructure.from_template(tpl, obstacles=ring_environment())
    spec = ps.reduced_spec()
    Nr = spec["Nr"]
    om, pl, pu = ps.masks()
    ep = edge_ops.build_edge_problem(om[:Nr, :Nr], pl[:Nr, :Nr], pu[:Nr, :Nr], dim=2,
                                     anchors=spec)
    params = TRParams.production(maxiter=250, maxinner=32)
    kw = dict(maxiter=250, maxinner=32, plateau_every=16, plateau_rtol=params.plateau_rtol)
    solver = api.make_solver(ps, params=params, polish_params=polish, smooth_iters=2)
    shape = tr_solve.kernel_shape(ep, B_MAIN, 2)
    inst = "tr_kernel<2,2,16,1,1>"
    regs, smem, spill = ptxas_lines()[inst]
    live = int(np.count_nonzero(np.asarray(ep.aL_mask)) + np.count_nonzero(np.asarray(ep.aU_mask)))
    log(f"[15] {tag}: N = {ps.N}, Nr = {Nr}, E = {ep.E}, anchor rows A = {ep.A} ({live} live; "
        f"{ep.a_nsel} groups of {ep.a_R}); {inst}: {regs} registers, {smem} B static smem, "
        f"{spill} B spill stores; kernel_shape at B={B_MAIN}: {shape}")
    check(shape["two_per_warp"], f"{tag}: the instances do not share a warp")

    def goals(B, device=dev):
        return api.random_goals(ps, (B,), gen, dtype=torch.float32, device=device)[0]

    D_c, Y0_c = solver.prepare(goals(B_CHECK))
    Y0_c, dg_c = Y0_c.contiguous(), ep.edge_values(D_c).contiguous()
    k1 = solve_tr_cuda(ep, Y0_c, dg_c, maxiter=1, maxinner=32)
    p1 = solve_tr_reference(ep, Y0_c, dg_c, maxiter=1, maxinner=32)
    torch.cuda.synchronize()
    same1 = lanes_equal(k1, p1)
    err = float((k1["Y"] - p1["Y"]).abs().max())
    log(f"[15] {tag} one step, B={B_CHECK}: lanes bitwise equal {same1}/{B_CHECK}, max|dY| {err:.3e}")
    check(same1 == B_CHECK, f"{tag}: one-step kernel/plain outputs not bitwise equal")
    kk = solve_tr_cuda(ep, Y0_c, dg_c, **kw)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    pp = solve_tr_reference(ep, Y0_c, dg_c, **kw)
    end.record()
    torch.cuda.synchronize()
    ms_plain = start.elapsed_time(end)
    for name, o in (("kernel", kk), ("plain", pp)):
        check(all(bool(torch.isfinite(o[k]).all()) for k in ("Y", "cost", "gradnorm")),
              f"{tag}: {name} has non-finite lanes")
    same = lanes_equal(kk, pp)
    err = max(err, float((kk["Y"] - pp["Y"]).abs().max()))
    log(f"[15] {tag} production(250, 32), B={B_CHECK}: lanes bitwise equal {same}/{B_CHECK}; mean "
        f"iterations {float(kk['iterations'].double().mean()):.2f}, mean num_inner "
        f"{float(kk['num_inner'].double().mean()):.1f}")
    check(same == B_CHECK, f"{tag}: production kernel/plain outputs not bitwise equal")
    ms_kernel = event_ms(lambda: solve_tr_cuda(ep, Y0_c, dg_c, **kw), 5)
    b = bound(tr_flops(ep.N, 2, ep.E, kk, anchored_nodes=ep.a_nsel),
              tr_bytes(ep.N, 2, ep.E, B_CHECK))
    log(f"[15] {tag} at B={B_CHECK}: kernel {ms_kernel:.3f} ms, plain torch {ms_plain:.3f} ms, "
        f"bound {b[0]:.4f} ms ({b[1]})")

    first = first_call("15", solver, goals(B_MAIN))
    calls = []
    sets = [goals(B_MAIN) for _ in range(2)]
    solve_tr_cuda.launches = solve_tr_cuda.anchored_launches = spd_solve_cuda.launches = 0
    for T_goal in sets:
        tp, ts, tf, peak, o = staged(solver, T_goal)
        calls.append((tp, ts, tf, peak, api.summarize(o), o))
    graphed.append((tag, solver, sets[-1], (), first))
    launches = solve_tr_cuda.anchored_launches
    log(f"[15] {tag}: TR launches during the 2 timed calls: {solve_tr_cuda.launches} "
        f"(anchored {launches}); K6 {spd_solve_cuda.launches}")
    check(launches == 2 and solve_tr_cuda.launches == 2,
          f"{tag}: the anchored TR kernel did not launch once per call")
    check(spd_solve_cuda.launches == 2 * lm_launches(solver),
          f"{tag}: the finish did not launch K6 once an LM step")
    centers = torch.tensor(np.stack([c[:2] for c, _ in ps.obstacles]), dtype=torch.float32,
                           device=dev)
    radii = torch.tensor([r for _, r in ps.obstacles], dtype=torch.float32, device=dev)
    walls = []
    for i, (tp, ts, tf, peak, summ, o) in enumerate(calls):
        wall = tp + ts + tf
        walls.append(wall)
        log(f"[15] {tag} call {i}: prepare {tp * 1e3:.1f} ms (peak {peak / 2**20:.1f} MiB), solve "
            f"{ts * 1e3:.1f} ms, finish {tf * 1e3:.1f} ms, total {wall * 1e3:.1f} ms, "
            f"{B_MAIN / wall:.1f} solves/s; success {summ['success_rate']:.4f} (floor "
            f"{FLOORS[tag]}), pose only {summ['pose_only_rate']:.4f}, median e_pos "
            f"{summ['median_pos_err']:.3e} m, mean iterations {summ['mean_iterations']:.2f}")
        for k, shp in {"q": (B_MAIN, 10), "Y": (B_MAIN, ps.N, 2), "e_pos": (B_MAIN,),
                       "e_rot": (B_MAIN,), "cost": (B_MAIN,), "iterations": (B_MAIN,)}.items():
            check(tuple(o[k].shape) == shp, (tag, k, tuple(o[k].shape)))
            check(bool(torch.isfinite(o[k].double()).all()), f"{tag}: non-finite {k}")
        check(summ["success_rate"] >= FLOORS[tag], f"{tag}: success below its floor")
        p = ps.realization(o["q"])[:, 1:11]  # (B, 10, 2)
        clear = torch.linalg.norm(p[:, :, None, :] - centers, dim=-1) - radii
        worst = float(clear[o["success"]].min())
        log(f"[15] {tag} call {i}: least clearance over successful lanes {worst:.3e} (>= -1e-3)")
        check(worst >= -1e-3, f"{tag}: a successful lane enters a circle")
    D_m, Y0_m = solver.prepare(goals(B_MAIN))
    Y0_m, dg_m = Y0_m.contiguous(), ep.edge_values(D_m).contiguous()
    k_m = solve_tr_cuda(ep, Y0_m, dg_m, **kw)
    ms_path = event_ms(lambda: solve_tr_cuda(ep, Y0_m, dg_m, **kw), 2)
    b_path = bound(tr_flops(ep.N, 2, ep.E, k_m, anchored_nodes=ep.a_nsel),
                   tr_bytes(ep.N, 2, ep.E, B_MAIN))
    log(f"[15] {tag} kernel at the path's shapes (B={B_MAIN}): {ms_path:.3f} ms, bound "
        f"{b_path[0]:.4f} ms ({b_path[1]}), {ms_path / b_path[0]:.0f}x")

    T_small = goals(B_SMALL, device=torch.device("cpu"))
    # eager stages on the card: a first compiled call at a new shape would
    # run them eagerly too, then capture graphs that nothing replays
    s_gpu = api.summarize(dataclasses.replace(solver, graphs=None)(T_small.to(dev)))["success_rate"]
    o_cpu = solver(T_small)
    check(o_cpu["Y"].device.type == "cpu", f"{tag}: the CPU call ran on {o_cpu['Y'].device}")
    s_cpu = api.summarize(o_cpu)["success_rate"]
    log(f"[15] {tag} {B_SMALL} goals: success on the card {s_gpu:.4f}, on the CPU {s_cpu:.4f}")
    check(abs(s_gpu - s_cpu) * B_SMALL <= 6, f"{tag}: card and CPU success differ by more than 6")
    log(f"[15] {tag}: phase took {time.perf_counter() - t_phase:.1f} s")
    return {"name": "tr_solve_anchored_planar", "route": "cuda",
            "source": "graphik_tpu_torch/csrc/tr_solve.cu",
            "replaces": "graphik_tpu/ops/tr_pallas.py:77", "launches": launches,
            "max_abs_err": err, "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": None, "instance": inst, "registers": regs,
            "spill_stores": spill, "blocks_resident": shape["blocks_resident"],
            "at": f"{tag}, B={B_CHECK}, production(250, 32)",
            "paths": [{"path": tag, "launches": launches, "ms": ms_path, "bound_ms": b_path[0],
                       "bound_by": b_path[1], "N": ep.N, "d": 2, "E": ep.E, "A": ep.A,
                       "A_live": live, "B": B_MAIN, "kernel_shape": shape,
                       "success": [c[4]["success_rate"] for c in calls],
                       "walls_ms": [w * 1e3 for w in walls]}]}


def sharded_phase(dev, gen, ps, params, polish):
    """Phase 16, the data-parallel solve on the card: solve_ik_sharded on
    UR10 at B_MAIN - 1 goals with the main path's parameters over
    make_mesh() and over [dev, dev] (two shards, one padded), each lane for
    lane against the unsharded solver (q within rtol 1e-3 / atol 1e-4,
    success equal), one TR launch a shard; solve_ik_global at world size 1
    over NCCL, its metrics equal to summarize of its own solve; and
    dryrun_multigpu over every card. Returns the phase's record."""
    import socket

    import torch
    import torch.distributed as dist

    from graphik_tpu_torch import api
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda
    from graphik_tpu_torch.parallel import distributed
    from graphik_tpu_torch.parallel.mesh import dryrun_multigpu, make_mesh, solve_ik_sharded

    t_phase = time.perf_counter()
    B = B_MAIN - 1
    kw = dict(params=params, polish_params=polish, smooth_iters=2)
    T_goal = api.random_goals(ps, (B,), gen, dtype=torch.float32, device=dev)[0]

    def timed(fn):
        torch.cuda.synchronize()
        solve_tr_cuda.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, solve_tr_cuda.launches

    api.solve_ik(ps, T_goal, **kw)  # warm call
    ref, ms_ref, n_ref = timed(lambda: api.solve_ik(ps, T_goal, **kw))
    check(n_ref == 1, "the unsharded solve did not launch the TR kernel once")
    record = {"B": B, "unsharded_ms": ms_ref, "meshes": []}
    for mesh in (make_mesh(), [dev, dev]):
        solve_ik_sharded(ps, T_goal, mesh, **kw)  # the first call of a shard shape captures
        out, ms, n = timed(lambda: solve_ik_sharded(ps, T_goal, mesh, **kw))
        dq = (out["q"] - ref["q"]).abs()
        over = int((dq > 1e-4 + 1e-3 * ref["q"].abs()).any(-1).sum())
        n_succ = int((out["success"] != ref["success"]).sum())
        log(f"[16] solve_ik_sharded over {[str(d) for d in mesh]}, B={B}: {ms:.1f} ms, compiled "
            f"(unsharded eager solve_ik {ms_ref:.1f} ms), TR launches {n}; lanes with q outside "
            f"rtol 1e-3 / atol 1e-4 "
            f"{over}, max |dq| {float(dq.max()):.3e}, success differs on {n_succ} lanes; success "
            f"{api.summarize(out)['success_rate']:.4f}")
        check(n == len(mesh), "solve_ik_sharded did not launch the TR kernel once a shard")
        check(tuple(out["q"].shape) == (B, 6) and out["q"].device == ref["q"].device,
              "sharded q has the wrong shape or device")
        check(over == 0 and n_succ == 0, "the sharded solve leaves the unsharded one")
        record["meshes"].append({"mesh": [str(d) for d in mesh], "ms": ms, "launches": n,
                                 "max_dq": float(dq.max())})

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    gdev = distributed.initialize("cuda", init_method=f"tcp://localhost:{port}", world_size=1,
                                  rank=0)
    try:
        backend = dist.get_backend()
        out, metrics = distributed.solve_ik_global(ps, T_goal, params=params, polish_params=polish,
                                                   smooth_iters=2)
        summ = api.summarize(out)
    finally:
        dist.destroy_process_group()
    log(f"[16] solve_ik_global, world size 1, backend {backend} on {gdev}: {metrics} "
        f"({(time.perf_counter() - t0) * 1e3:.0f} ms with the group's set-up)")
    check(backend == "nccl", f"solve_ik_global ran over {backend}")
    check(metrics["global_batch"] == B and metrics["num_processes"] == 1, "global metrics' sizes")
    for k in ("success_rate", "pose_only_rate", "mean_iterations", "mean_pos_err"):
        check(abs(metrics[k] - summ[k]) <= 1e-12 * max(1.0, abs(summ[k])),
              f"solve_ik_global's {k} {metrics[k]} is not summarize's {summ[k]}")
    q, m = dryrun_multigpu(torch.cuda.device_count())
    log(f"[16] dryrun_multigpu({torch.cuda.device_count()}): q {tuple(q.shape)} on {q.device}, "
        f"success {m['success_rate']:.3f}")
    log(f"[16] phase took {time.perf_counter() - t_phase:.1f} s")
    record["global_metrics"] = metrics
    return record


def tr_backends_phase(dev, gen, ps, ps_t, polish, prepare_paths, position_runs=None):
    """Phase 17: the trust region's "dense" and "edge" backends on the card
    (none of K1-K4; prepare's K5), compiled against eager. Appends the
    float64 UR10 solver and goals to prepare_paths, and it and planar10 on
    "edge" to position_runs (the table's float64 calls take ~9 s each), for
    phase 18. Returns the phase's record."""
    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda
    from graphik_tpu_torch.robots.library import load_planar_chain
    from graphik_tpu_torch.solvers import riemannian
    from graphik_tpu_torch.solvers.riemannian import TRParams

    t_phase = time.perf_counter()
    counters = (solve_tr_cuda, edge_ops.cost_and_egrad_cuda, edge_ops.ehess_cuda)
    cpu = torch.device("cpu")

    def zero_counts():
        for f in counters:
            f.launches = 0
        riemannian.solve.host_reads = 0

    def no_kernel(tag):
        hand = sum(f.launches for f in counters)
        log(f"[17] {tag}: K1-K4 launches: {hand}")
        check(hand == 0, f"{tag}: one of K1-K4 was launched")

    def goals(ps_, B, dtype, device=dev):
        return api.random_goals(ps_, (B,), gen, dtype=dtype, device=device)[0]

    def hits(o):
        return (o["e_pos"] < 1e-3) & (o["e_rot"] < np.deg2rad(1.0)) & o["success"]

    def checked(tag, o, B, dtype):
        for k in ("q", "Y", "e_pos", "e_rot", "cost", "gradnorm", "iterations"):
            check(o[k].shape[0] == B and bool(torch.isfinite(o[k].double()).all()),
                  f"{tag}: {k} has the wrong shape or is not finite")
        for k in ("q", "Y", "e_pos", "cost"):
            check(o[k].dtype == dtype, f"{tag}: {k} is {o[k].dtype}")
        return api.summarize(o)

    def walls(tag, i, tp, ts, tf, summ, B):
        wall = tp + ts + tf
        log(f"[17] {tag} call {i}: prepare {tp * 1e3:.1f} ms, solve {ts * 1e3:.1f} ms, finish "
            f"{tf * 1e3:.1f} ms, total {wall * 1e3:.1f} ms, {B / wall:.1f} solves/s; success "
            f"{summ['success_rate']:.4f}, median e_pos {summ['median_pos_err']:.3e} m, mean "
            f"iterations {summ['mean_iterations']:.2f}")
        return {"prepare_ms": tp * 1e3, "solve_ms": ts * 1e3, "finish_ms": tf * 1e3,
                "solves_per_s": B / wall, "success": summ["success_rate"]}

    # (a) UR10 at float64: compiled against eager on the same inputs, then
    # two compiled calls of their own goals
    tag = "ur10_f64"
    prod = TRParams.production(maxiter=100, maxinner=24)
    solver = api.make_solver(ps, params=prod, polish_params=polish, smooth_iters=2)
    log(f"[17] {tag}: UR10, float64, B = {B_F64}; {prod}")
    zero_counts()
    T_f64 = goals(ps, B_F64, torch.float64)
    rec, (sol, out) = compiled_vs_eager("17", tag, dev, solver, T_f64, riemannian.solve)
    prepare_paths.append((tag, solver, T_f64, ()))
    if position_runs is not None:
        fwd = dict(zip(("D_goal", "Y0"), solver.prepare(T_f64)), **out)
        position_runs.append((tag, lambda T: path_outputs(solver, T), T_f64, fwd))
    calls = []
    for i in range(2):
        tp, ts, tf, _, o = staged(solver, goals(ps, B_F64, torch.float64))
        summ = checked(tag, o, B_F64, torch.float64)
        calls.append(walls(tag, i, tp, ts, tf, summ, B_F64))
        check(summ["success_rate"] >= 0.85, f"{tag}: success below 0.85")
    no_kernel(tag)
    log(f"[17] {tag}: mean iterations {float(sol['iterations'].double().mean()):.1f}, inner steps "
        f"a lane {float(sol['num_inner'].double().mean()):.1f}")
    rec["calls"] = calls

    # (b) the same solver on 64 goals, on the card and on the CPU
    log(f"[17] {tag}: took {time.perf_counter() - t_phase:.1f} s")
    t_b = time.perf_counter()
    T64 = goals(ps, 64, torch.float64, device=cpu)
    D64, Y64 = solver.prepare(T64)
    one = TRParams.production(maxiter=1, maxinner=24)
    o_g, o_c = (riemannian.solve(Y64.to(d_), D64.to(d_), solver.omega, solver.psi_L,
                                 solver.psi_U, params=one) for d_ in (dev, cpu))
    same = bool(torch.equal(o_g["num_inner"].cpu(), o_c["num_inner"]))
    d_Y = float((o_g["Y"].cpu() - o_c["Y"]).abs().max())
    log(f"[17] {tag} 64 goals, one iteration from the same Y0 on {dev.type} and the CPU: "
        f"inner steps equal {same}, max |d Y| {d_Y:.3e} (<= {F64_TOL})")
    check(same and d_Y <= F64_TOL, f"{tag}: the card's trajectory leaves the CPU's")
    out_g, out_c = solver(T64.to(dev)), solver(T64)
    check(out_c["Y"].device.type == "cpu", f"{tag}: the CPU call ran on {out_c['Y'].device}")
    h_g, h_c = hits(out_g).cpu(), hits(out_c)
    n_same = int((h_g == h_c).sum())
    for lane in torch.nonzero(h_g != h_c).flatten().tolist():
        log(f"[17] {tag} goal {lane}: success on the card {bool(h_g[lane])}, on the CPU "
            f"{bool(h_c[lane])}; cost {float(out_g['cost'][lane]):.3e} / "
            f"{float(out_c['cost'][lane]):.3e}, e_pos {float(out_g['e_pos'][lane]):.3e} / "
            f"{float(out_c['e_pos'][lane]):.3e}")
    log(f"[17] {tag} 64 goals: per-goal success equal on {n_same} (>= {F64_SAME_GOALS}); "
        f"successes {int(h_g.sum())} on the card, {int(h_c.sum())} on the CPU")
    check(n_same >= F64_SAME_GOALS, f"{tag}: card and CPU success differ per goal")
    log(f"[17] {tag}: 64-goal comparison took {time.perf_counter() - t_b:.1f} s")
    rec["card_vs_cpu"] = {"d_Y_one_iteration": d_Y, "goals_same": n_same,
                          "successes": [int(h_g.sum()), int(h_c.sum())]}

    # (c) the table at float64 on "dense": compiled against eager on the
    # same inputs
    tag = "ur10_table_f64"
    tparams = TRParams.production(maxiter=250, maxinner=32)
    solver_t = api.make_solver(ps_t, params=tparams, polish_params=polish, smooth_iters=2)
    zero_counts()
    rec_t, (_, o) = compiled_vs_eager("17", tag, dev, solver_t,
                                      goals(ps_t, B_F64_TABLE, torch.float64), riemannian.solve,
                                      profile=False)
    no_kernel(tag)
    summ = checked(tag, o, B_F64_TABLE, torch.float64)
    c = rec_t["compiled"]
    rec_t.update(walls(tag, 0, rec_t["prepare_ms"] / 1e3, c["solve_ms"] / 1e3,
                       c["finish_ms"] / 1e3, summ, B_F64_TABLE))
    check(summ["success_rate"] >= TABLE_SUCCESS_MIN, f"{tag}: success below {TABLE_SUCCESS_MIN}")
    centers = torch.tensor(np.stack([c for c, _ in ps_t.obstacles]), dtype=torch.float64,
                           device=dev)
    radii = torch.tensor([r for _, r in ps_t.obstacles], dtype=torch.float64, device=dev)
    p = ps_t.realization(o["q"])[:, 1:ps_t.n + 1]
    clear = torch.linalg.norm(p[:, :, None, :] - centers, dim=-1) - radii
    worst = float(clear[o["success"]].min())
    log(f"[17] {tag}: least clearance over successful lanes {worst:.3e} m (>= -1e-3)")
    check(worst >= -1e-3, f"{tag}: a successful lane enters an obstacle")
    rec_t.update(B=B_F64_TABLE, clearance=worst)

    # (d) planar10 on "edge", float32, against the kernel path on the same goals
    tag = "planar10_edge"
    _, ps_p = load_planar_chain(10, limits=np.pi / 2)
    solvers = {b: api.make_solver(ps_p, params=TRParams.production(maxiter=100, maxinner=24,
                                                                  backend=b),
                                  polish_params=polish, smooth_iters=2)
               for b in ("edge", "kernel")}
    T_p = goals(ps_p, B_EDGE, torch.float32)
    zero_counts()
    rec_e, (_, o_e) = compiled_vs_eager("17", tag, dev, solvers["edge"], T_p, riemannian.solve,
                                        profile=False)
    no_kernel(tag)
    s_e = checked(tag, o_e, B_EDGE, torch.float32)
    c = rec_e["compiled"]
    rec_e.update(walls(tag, 0, rec_e["prepare_ms"] / 1e3, c["solve_ms"] / 1e3,
                       c["finish_ms"] / 1e3, s_e, B_EDGE))
    s_k = api.summarize(solvers["kernel"](T_p))["success_rate"]
    log(f"[17] {tag}: success {s_e['success_rate']:.4f}, the kernel path's on the same goals "
        f"{s_k:.4f} (|d| <= {EDGE_GAP})")
    check(abs(s_e["success_rate"] - s_k) <= EDGE_GAP, f"{tag}: success apart from the kernel's")
    rec_e.update(B=B_EDGE, kernel_success=s_k)
    if position_runs is not None:
        fwd = dict(zip(("D_goal", "Y0"), solvers["edge"].prepare(T_p)), **o_e)
        position_runs.append((tag, lambda T, s=solvers["edge"]: path_outputs(s, T), T_p, fwd))
    log(f"[17] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"ur10_f64": rec, "ur10_table_f64": rec_t, "planar10_edge": rec_e}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.ops import tr_solve
    from graphik_tpu_torch.ops._build import library_path, load_library
    from graphik_tpu_torch.ops.eigh import sym_eigh_cuda
    from graphik_tpu_torch.ops.linalg import spd_solve_cuda
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda, solve_tr_reference
    from graphik_tpu_torch.parallel.mesh import make_restart_solver
    from graphik_tpu_torch.robots.library import (
        load_kuka, load_planar_chain, load_schunk_lwa4d, load_tree5, load_ur10)
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import TRParams
    from graphik_tpu_torch.utils.environments import table_environment

    dev = torch.device("cuda:0")
    # f32 means true f32: no TF32 in any matmul of the path.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 0: the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[0] card: {smi}")
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    load_library()
    log(f"[1] kernel build+load: {time.perf_counter() - t0:.2f} s -> {library_path()}")
    ptxas = ptxas_lines()
    for inst, (regs, smem, spill) in ptxas.items():
        log(f"[1] ptxas: {inst}: {regs} registers, {smem} B static smem, {spill} B spill stores")

    tpl, ps = load_ur10()
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    prod = TRParams.production(maxiter=100, maxinner=24)
    polish = LocalParams(maxiter=10, tol_grad=1e-8)
    solver = api.make_solver(ps, params=prod, polish_params=polish, smooth_iters=2)
    tr_kw = dict(maxinner=24, plateau_every=16, plateau_rtol=prod.plateau_rtol)

    def goals(B, device=dev):
        return api.random_goals(ps, (B,), gen, dtype=torch.float32, device=device)[0]

    def kernel_inputs(T_goal):
        D_goal, Y0 = solver.prepare(T_goal)
        return Y0.contiguous(), ep.edge_values(D_goal).contiguous()

    # ---- phase 2: kernel vs plain version on the card ----
    Y0, dg = kernel_inputs(goals(B_CHECK))
    k1 = solve_tr_cuda(ep, Y0, dg, maxiter=1, maxinner=24)
    p1 = solve_tr_reference(ep, Y0, dg, maxiter=1, maxinner=24)
    torch.cuda.synchronize()
    err_y = float((k1["Y"] - p1["Y"]).abs().max())
    err_c = float(((k1["cost"] - p1["cost"]).abs() / (1e-6 + 2e-5 * p1["cost"].abs())).max())
    n_diff = int((k1["num_inner"] != p1["num_inner"]).sum())
    log(f"[2] one step, B={B_CHECK}: max|dY| {err_y:.3e} (tol 1e-4), cost err/tol "
        f"{err_c:.3f} (<= 1), num_inner mismatches {n_diff}")
    check(err_y <= 1e-4 and err_c <= 1.0 and n_diff == 0, "one-step kernel/plain mismatch")

    kp = solve_tr_cuda(ep, Y0, dg, maxiter=100, **tr_kw)
    pp = solve_tr_reference(ep, Y0, dg, maxiter=100, **tr_kw)
    torch.cuda.synchronize()
    for name, out in (("kernel", kp), ("plain", pp)):
        check(all(bool(torch.isfinite(out[k]).all()) for k in ("Y", "cost", "gradnorm")), name)
    same = lanes_equal(kp, pp)
    log(f"[2] production, B={B_CHECK}: lanes whose outputs are bitwise equal: "
        f"{same}/{B_CHECK} (the plain version sums in the kernel's order)")
    check(same == B_CHECK, "production-params kernel/plain outputs not bitwise equal")
    med_k, med_p = float(kp["cost"].median()), float(pp["cost"].median())
    it_k = float(kp["iterations"].double().mean())
    it_p = float(pp["iterations"].double().mean())
    log(f"[2] production, B={B_CHECK}: median cost kernel {med_k:.4e} plain {med_p:.4e}; "
        f"mean iterations kernel {it_k:.3f} plain {it_p:.3f}; mean num_inner kernel "
        f"{float(kp['num_inner'].double().mean()):.2f} plain "
        f"{float(pp['num_inner'].double().mean()):.2f}")

    # ---- phase 19 (run here, before the paths): K5, the eigendecomposition ----
    def eigh_cases():
        """(tag, stack) of the matrices K5 meets on the paths, and seeded
        random ones at n = 2, 3, 31, 32."""
        T_u = goals(B_MAIN)
        G32, S32 = prepare_matrices(solver, T_u)
        G64, S64 = prepare_matrices(solver, T_u.double())
        cases = [("ur10 G", G32), ("ur10 S", S32), ("ur10 G", G64), ("ur10 S", S64)]
        ps_tab = ProblemStructure.from_template(tpl, obstacles=table_environment())
        for tag, ps_e in (("planar6", load_planar_chain(6, limits=np.pi / 2)[1]),
                          ("planar10", load_planar_chain(10, limits=np.pi / 2)[1]),
                          ("kuka_iiwa", load_kuka()[1]), ("tree", load_tree5()[1]),
                          ("ur10_table", ps_tab)):
            T_e = api.random_goals(ps_e, (B_CHECK,), gen, dtype=torch.float32, device=dev)[0]
            G, S = prepare_matrices(api.Solver(ps_e, smooth_iters=2), T_e)
            cases += [(f"{tag} G", G), (f"{tag} S", S)]
        rs = np.random.RandomState(SEED)
        for dt in (torch.float32, torch.float64):
            q = api.random_goals(ps, (B_CIDGIK,), gen, dtype=dt, device=dev)[1]
            cases += [("ur10_cidgik Z", lifted_noisy(ps, q, False, gen)),
                      ("ur10_cidgik_sparse blocks", lifted_noisy(ps, q, True, gen))]
            for n in (2, 3, 31, 32, 42, 43, 64, 84, 103, 128):
                # past 64, 300 matrices: the plain version takes seconds there
                X = rs.normal(size=(B_CHECK if n <= 64 else 300, n, n))
                cases.append((f"random n={n}", torch.tensor(X + X.transpose(0, 2, 1), dtype=dt,
                                                            device=dev)))
            # equal diagonals: a rotation's theta is +-0 (t takes its sign bit)
            E = np.triu(rs.normal(size=(B_CHECK, 13, 13)), 1)
            cases.append(("equal diagonals n=13", torch.tensor(
                2.0 * np.eye(13) + E + E.transpose(0, 2, 1), dtype=dt, device=dev)))
        return cases, (G32, G64)

    # the paths' own shapes, from a generator of their own (the later
    # phases' goals stay as they were)
    eigh_rec = eigh_phase(dev, *eigh_cases(), eigh_path_inputs(
        dev, torch.Generator(device="cpu").manual_seed(SEED + 19)))
    # ---- phase 21 (run here too): K6, the LM's clamped-pivot solve ----
    spd_rec = spd_phase(dev, torch.Generator(device="cpu").manual_seed(SEED + 21))
    # ---- phase 22 (run here too): the finish rounds as on the CPU ----
    rounding_rec = finish_rounding_phase(dev, torch.Generator(device="cpu").manual_seed(SEED + 22),
                                         prod, polish)

    # ---- phase 3: the main path ----
    graphed = []  # the compiled f32 kernel paths, for phase 18
    first = first_call("3", solver, goals(B_MAIN))
    goal_sets = [goals(B_MAIN) for _ in range(3)]
    calls = []
    solve_tr_cuda.launches = solve_tr_cuda.anchored_launches = sym_eigh_cuda.launches = 0
    spd_solve_cuda.launches = 0
    for T_goal in goal_sets:
        tp, ts, tf, _, out = staged(solver, T_goal)
        calls.append((tp, ts, tf, api.summarize(out), out))
    launches, launches_eigh = solve_tr_cuda.launches, sym_eigh_cuda.launches
    launches_spd = spd_solve_cuda.launches
    log(f"[3] kernel launches during the 3 timed main-path calls: TR {launches} "
        f"(anchored {solve_tr_cuda.anchored_launches}), K5 {launches_eigh}, K6 {launches_spd}")
    check(launches == 3 and solve_tr_cuda.anchored_launches == 0,
          "the UR10 path did not launch the anchor-free TR kernel once per call")
    check(launches_eigh == 6, "the UR10 path's prepare did not launch K5 twice per call")
    check(launches_spd == 3 * lm_launches(solver),
          "the UR10 path's polish did not launch K6 once an LM step")
    shapes = {"q": (B_MAIN, tpl.n), "Y": (B_MAIN, ps.N, ps.dim), "e_pos": (B_MAIN,),
              "e_rot": (B_MAIN,), "cost": (B_MAIN,), "iterations": (B_MAIN,)}
    for i, (tp, ts, tf, summ, o) in enumerate(calls):
        wall = tp + ts + tf
        log(f"[3] call {i}: prepare {tp * 1e3:.1f} ms, solve {ts * 1e3:.1f} ms, finish "
            f"{tf * 1e3:.1f} ms, total {wall * 1e3:.1f} ms, {B_MAIN / wall:.1f} solves/s; "
            f"success {summ['success_rate']:.4f}, median e_pos "
            f"{summ['median_pos_err']:.3e} m, mean iterations {summ['mean_iterations']:.2f}")
        for k, shape in shapes.items():
            check(tuple(o[k].shape) == shape, (k, tuple(o[k].shape)))
            check(bool(torch.isfinite(o[k].double()).all()), f"non-finite {k}")
        check(summ["success_rate"] >= 0.85, "UR10 success below 0.85")
    walls = [sum(c[:3]) for c in calls]
    log(f"[3] mean over the timed calls: {B_MAIN / (sum(walls) / 3):.1f} solves/s")
    graphed.append(("ur10", solver, goal_sets[-1], (), first))

    # the same solver on a small batch, on the card and on the CPU (plain version)
    T_small = goals(B_SMALL, device=torch.device("cpu"))
    # eager stages on the card: a first compiled call at a new shape would
    # run them eagerly too, then capture graphs that nothing replays
    s_gpu = api.summarize(dataclasses.replace(solver, graphs=None)(T_small.to(dev)))["success_rate"]
    s_cpu = api.summarize(solver(T_small))["success_rate"]
    log(f"[3] {B_SMALL} goals: success on the card {s_gpu:.4f}, on the CPU {s_cpu:.4f}")
    check(abs(s_gpu - s_cpu) * B_SMALL <= 6, "card and CPU success differ by more than 6 goals")

    # ---- phase 4: kernel vs plain time at the main path's shapes ----
    Y0, dg = kernel_inputs(goals(B_MAIN))
    k_main = solve_tr_cuda(ep, Y0, dg, maxiter=100, **tr_kw)
    ms_kernel = event_ms(lambda: solve_tr_cuda(ep, Y0, dg, maxiter=100, **tr_kw), 5)
    ms_plain = event_ms(lambda: solve_tr_reference(ep, Y0, dg, maxiter=100, **tr_kw), 1)
    log(f"[4] TR solve at B={B_MAIN}, production params: kernel {ms_kernel:.3f} ms, "
        f"plain torch {ms_plain:.3f} ms")

    # ---- phase 5: the anchored TR kernel vs its plain version ----
    ps_t = ProblemStructure.from_template(tpl, obstacles=table_environment())
    spec = ps_t.reduced_spec()
    Nr = spec["Nr"]
    om_t, pl_t, pu_t = ps_t.masks()
    ep_t = edge_ops.build_edge_problem(om_t[:Nr, :Nr], pl_t[:Nr, :Nr], pu_t[:Nr, :Nr],
                                       dim=ps_t.dim, anchors=spec)
    table_params = TRParams.production(maxiter=250, maxinner=32)
    solver_t = api.make_solver(ps_t, params=table_params, polish_params=polish, smooth_iters=2)
    log(f"[5] table scene: N = {ps_t.N}, Nr = {Nr}, E = {ep_t.E}, anchor rows A = {ep_t.A} "
        f"({ep_t.a_nsel} groups of {ep_t.a_R})")

    def goals_t(B, device=dev):
        return api.random_goals(ps_t, (B,), gen, dtype=torch.float32, device=device)[0]

    D_t, Y0_t = solver_t.prepare(goals_t(B_CHECK))
    Y0_t, dg_t = Y0_t.contiguous(), ep_t.edge_values(D_t).contiguous()
    # world-frame starts near random configurations: the hinges meet the robot
    Yw_t = ps_t.realization(
        api.random_goals(ps_t, (B_CHECK,), gen, dtype=torch.float32, device=dev)[1]
    )[:, :Nr].contiguous()
    err_a = 0.0
    for name, Ys in (("prepare", Y0_t), ("world-frame", Yw_t)):
        k1 = solve_tr_cuda(ep_t, Ys, dg_t, maxiter=1, maxinner=32)
        p1 = solve_tr_reference(ep_t, Ys, dg_t, maxiter=1, maxinner=32)
        torch.cuda.synchronize()
        e = float((k1["Y"] - p1["Y"]).abs().max())
        nd = int((k1["num_inner"] != p1["num_inner"]).sum())
        same_cost = bool(torch.equal(k1["cost"], p1["cost"]))
        log(f"[5] one step from {name} starts, B={B_CHECK}: max|dY| {e:.3e}, cost bitwise "
            f"equal {same_cost}, num_inner mismatches {nd}")
        check(e == 0.0 and nd == 0 and same_cost, f"anchored one-step mismatch ({name})")
        err_a = max(err_a, e)
    t_kw = dict(maxinner=32, plateau_every=16, plateau_rtol=table_params.plateau_rtol)
    ka = solve_tr_cuda(ep_t, Y0_t, dg_t, maxiter=100, **t_kw)
    # the plain version is launch-bound (tens of seconds): time its one run
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    pa = solve_tr_reference(ep_t, Y0_t, dg_t, maxiter=100, **t_kw)
    end.record()
    torch.cuda.synchronize()
    ms_a_plain = start.elapsed_time(end)
    for name, o in (("kernel", ka), ("plain", pa)):
        check(all(bool(torch.isfinite(o[k]).all()) for k in ("Y", "cost", "gradnorm")),
              f"anchored {name}: non-finite lanes")
    same_a = lanes_equal(ka, pa)
    log(f"[5] maxiter=100, maxinner=32, plateau stop, B={B_CHECK}: lanes whose outputs are "
        f"bitwise equal: {same_a}/{B_CHECK}; mean iterations kernel "
        f"{float(ka['iterations'].double().mean()):.3f} plain "
        f"{float(pa['iterations'].double().mean()):.3f}")
    check(same_a == B_CHECK, "anchored kernel/plain outputs not bitwise equal at maxiter=100")
    ms_a_kernel = event_ms(lambda: solve_tr_cuda(ep_t, Y0_t, dg_t, maxiter=100, **t_kw), 5)
    log(f"[5] anchored TR at B={B_CHECK}, maxiter=100: kernel {ms_a_kernel:.3f} ms, plain "
        f"torch {ms_a_plain:.3f} ms")

    # ---- phase 6: the table path ----
    first = first_call("6", solver_t, goals_t(B_MAIN))
    goal_sets = [goals_t(B_MAIN) for _ in range(3)]
    calls_t = []
    solve_tr_cuda.launches = solve_tr_cuda.anchored_launches = sym_eigh_cuda.launches = 0
    spd_solve_cuda.launches = 0
    for T_goal in goal_sets:
        tp, ts, tf, peak, o = staged(solver_t, T_goal)
        calls_t.append((tp, ts, tf, peak, api.summarize(o), o))
    launches_a = solve_tr_cuda.anchored_launches
    log(f"[6] TR kernel launches during the 3 timed table-path calls: "
        f"{solve_tr_cuda.launches}, anchored {launches_a}; K5 {sym_eigh_cuda.launches}; K6 "
        f"{spd_solve_cuda.launches}")
    check(launches_a == 3 and solve_tr_cuda.launches == 3,
          "the table path did not launch the anchored TR kernel once per call")
    check(sym_eigh_cuda.launches == 6, "the table path's prepare did not launch K5 twice a call")
    check(spd_solve_cuda.launches == 3 * lm_launches(solver_t),
          "the table path's polish did not launch K6 once an LM step in each round")
    centers = torch.tensor(np.stack([c for c, _ in ps_t.obstacles]), dtype=torch.float32,
                           device=dev)
    radii = torch.tensor([r for _, r in ps_t.obstacles], dtype=torch.float32, device=dev)
    shapes_t = {"q": (B_MAIN, tpl.n), "Y": (B_MAIN, ps_t.N, 3), "e_pos": (B_MAIN,),
                "e_rot": (B_MAIN,), "cost": (B_MAIN,), "iterations": (B_MAIN,)}
    for i, (tp, ts, tf, peak, summ, o) in enumerate(calls_t):
        wall = tp + ts + tf
        log(f"[6] call {i}: prepare {tp * 1e3:.1f} ms (peak {peak / 2**20:.1f} MiB), solve "
            f"{ts * 1e3:.1f} ms, finish {tf * 1e3:.1f} ms, total {wall * 1e3:.1f} ms, "
            f"{B_MAIN / wall:.1f} solves/s; success {summ['success_rate']:.4f}, pose only "
            f"{summ['pose_only_rate']:.4f}, median e_pos {summ['median_pos_err']:.3e} m, mean "
            f"iterations {summ['mean_iterations']:.2f}, p90 {summ['p90_iterations']:.0f}")
        for k, shape in shapes_t.items():
            check(tuple(o[k].shape) == shape, (k, tuple(o[k].shape)))
            check(bool(torch.isfinite(o[k].double()).all()), f"non-finite {k}")
        check(summ["success_rate"] >= TABLE_SUCCESS_MIN,
              f"table success below {TABLE_SUCCESS_MIN}")
        p = ps_t.realization(o["q"])[:, 1:tpl.n + 1]  # (B, n, 3)
        clear = torch.linalg.norm(p[:, :, None, :] - centers, dim=-1) - radii  # (B, n, n_obs)
        worst = float(clear[o["success"]].min())
        log(f"[6] call {i}: least clearance over successful lanes {worst:.3e} m (>= -1e-3)")
        check(worst >= -1e-3, "a successful lane enters an obstacle")
    walls_t = [sum(c[:3]) for c in calls_t]
    log(f"[6] mean over the timed calls: {B_MAIN / (sum(walls_t) / 3):.1f} solves/s")
    graphed.append(("ur10_table", solver_t, goal_sets[-1], (), first))
    D_m, Y0_m = solver_t.prepare(goal_sets[-1])
    Y0_m, dg_m = Y0_m.contiguous(), ep_t.edge_values(D_m).contiguous()
    # one step at the table path's own shapes, against the plain version
    k1 = solve_tr_cuda(ep_t, Y0_m, dg_m, maxiter=1, maxinner=32)
    p1 = solve_tr_reference(ep_t, Y0_m, dg_m, maxiter=1, maxinner=32)
    torch.cuda.synchronize()
    e = float((k1["Y"] - p1["Y"]).abs().max())
    nd = int((k1["num_inner"] != p1["num_inner"]).sum())
    log(f"[6] anchored one step at B={B_MAIN}: max|dY| {e:.3e}, num_inner mismatches {nd}")
    check(e == 0.0 and nd == 0, "anchored one-step mismatch at the table path's shapes")
    err_a = max(err_a, e)
    k_tab = solve_tr_cuda(ep_t, Y0_m, dg_m, maxiter=250, **t_kw)
    ms_a_main = event_ms(lambda: solve_tr_cuda(ep_t, Y0_m, dg_m, maxiter=250, **t_kw), 3)
    log(f"[6] anchored TR kernel at the table path's shapes (B={B_MAIN}, maxiter=250, "
        f"maxinner=32): {ms_a_main:.3f} ms")

    T_small = goals_t(B_SMALL, device=torch.device("cpu"))
    s_gpu = api.summarize(dataclasses.replace(solver_t, graphs=None)(T_small.to(dev)))[
        "success_rate"]
    s_cpu = api.summarize(solver_t(T_small))["success_rate"]
    log(f"[6] {B_SMALL} table goals: success on the card {s_gpu:.4f}, on the CPU {s_cpu:.4f}")
    check(abs(s_gpu - s_cpu) * B_SMALL <= 6, "card and CPU success differ by more than 6 goals")

    # ---- phase 7: the edge cost+grad (K1) and Hessian (K2) kernels ----
    edge_records = edge_phase(dev, ep, Y0, dg)

    # ---- phase 8: the other robots of the bench ----
    def edge_problem(ps_):
        om_, pl_, pu_ = ps_.masks()
        return edge_ops.build_edge_problem(om_, pl_, pu_, dim=ps_.dim)

    def path_calls(tag, solver_, goal_sets_, *gen, anchored=False):
        """The timed calls of one path, with the counts set to 0 just before
        and read just after: [(prepare, solve, finish, summary, out)], and
        the launches. Checks one launch a call, shapes, finite outputs and
        the success floor."""
        out_calls = []
        solve_tr_cuda.launches = solve_tr_cuda.anchored_launches = sym_eigh_cuda.launches = 0
        spd_solve_cuda.launches = 0
        for T_goal in goal_sets_:
            tp, ts, tf, _, o = staged(solver_, T_goal, *gen)
            out_calls.append((tp, ts, tf, api.summarize(o), o))
        n_launch = solve_tr_cuda.anchored_launches if anchored else solve_tr_cuda.launches
        log(f"[{tag}] TR launches during the {len(goal_sets_)} timed calls: "
            f"{solve_tr_cuda.launches} (anchored {solve_tr_cuda.anchored_launches}); K5 "
            f"{sym_eigh_cuda.launches}; K6 {spd_solve_cuda.launches}")
        check(n_launch == len(goal_sets_) and solve_tr_cuda.launches == len(goal_sets_),
              f"{tag}: the TR kernel did not launch once per call")
        check(sym_eigh_cuda.launches == 2 * len(goal_sets_),
              f"{tag}: prepare did not launch K5 twice per call")
        check(spd_solve_cuda.launches == len(goal_sets_) * lm_launches(solver_),
              f"{tag}: the polish did not launch K6 once an LM step")
        for i, (tp, ts, tf, summ, o) in enumerate(out_calls):
            B_ = o["e_pos"].shape[0]
            wall = tp + ts + tf
            log(f"[{tag}] call {i}: prepare {tp * 1e3:.1f} ms, solve {ts * 1e3:.1f} ms, finish "
                f"{tf * 1e3:.1f} ms, total {wall * 1e3:.1f} ms, {B_ / wall:.1f} solves/s; success "
                f"{summ['success_rate']:.4f} (floor {FLOORS[tag]}), pose only "
                f"{summ['pose_only_rate']:.4f}, median e_pos {summ['median_pos_err']:.3e} m, "
                f"mean iterations {summ['mean_iterations']:.2f}")
            for k in ("q", "Y", "e_pos", "e_rot", "cost", "iterations"):
                check(o[k].shape[0] == B_ and bool(torch.isfinite(o[k].double()).all()),
                      f"{tag}: {k} has the wrong shape or is not finite")
            check(summ["success_rate"] >= FLOORS[tag], f"{tag}: success below its floor")
        return out_calls, n_launch

    def bitwise_check(phase, tag, ep_, Y0_, D_, *kws):
        """The TR kernel against its plain version on one path's prepared
        inputs, at each set of parameters: every lane bitwise equal."""
        Y0_, dg_ = Y0_.contiguous(), ep_.edge_values(D_).contiguous()
        B_ = Y0_.shape[0]
        for kw in kws:
            kr = solve_tr_cuda(ep_, Y0_, dg_, **kw)
            pr_ = solve_tr_reference(ep_, Y0_, dg_, **kw)
            torch.cuda.synchronize()
            same_r = lanes_equal(kr, pr_)
            log(f"[{phase}] {tag} (N={ep_.N}, d={ep_.dim}, E={ep_.E}), {kw}, B={B_}: lanes "
                f"bitwise equal {same_r}/{B_}; mean iterations "
                f"{float(kr['iterations'].double().mean()):.2f}")
            check(same_r == B_, f"{tag}: kernel/plain outputs not bitwise equal ({kw})")

    def sub_record(tag, ep_, Y0_, dg_, kw_, launches_, B_, **extra):
        """The TR kernel's time on one path's prepared inputs (CUDA events)
        with its bound and launch shape."""
        k_out = solve_tr_cuda(ep_, Y0_, dg_, **kw_)
        ms = event_ms(lambda: solve_tr_cuda(ep_, Y0_, dg_, **kw_), 2)
        b = bound(tr_flops(ep_.N, ep_.dim, ep_.E, k_out, anchored_nodes=ep_.a_nsel),
                  tr_bytes(ep_.N, ep_.dim, ep_.E, B_))
        shape = tr_solve.kernel_shape(ep_, B_, ep_.dim)
        log(f"[{tag}] TR kernel at B={B_}: {ms:.3f} ms (bound {b[0]:.3f} ms, {b[1]}); "
            f"N={ep_.N}, d={ep_.dim}, E={ep_.E}, A={ep_.A}; kernel_shape {shape}")
        return {"path": tag, "launches": launches_, "ms": ms, "bound_ms": b[0],
                "bound_by": b[1], "N": ep_.N, "d": ep_.dim, "E": ep_.E, "A": ep_.A, "B": B_,
                "kernel_shape": shape, **extra}

    b_ur10 = bound(tr_flops(ps.N, ps.dim, ep.E, k_main), tr_bytes(ps.N, ps.dim, ep.E, B_MAIN))
    tr_paths = [{"path": "ur10", "launches": launches, "ms": ms_kernel, "bound_ms": b_ur10[0],
                 "bound_by": b_ur10[1], "N": ps.N, "d": ps.dim, "E": ep.E, "B": B_MAIN,
                 "kernel_shape": tr_solve.kernel_shape(ep, B_MAIN, ps.dim)}]
    robots = {"planar6": lambda: load_planar_chain(6, limits=np.pi / 2),
              "planar10": lambda: load_planar_chain(10, limits=np.pi / 2),
              "kuka_iiwa": load_kuka, "lwa4d": load_schunk_lwa4d}
    for tag, load in robots.items():
        tpl_r, ps_r = load()
        ep_r = edge_problem(ps_r)
        solver_r = api.make_solver(ps_r, params=prod, polish_params=polish, smooth_iters=2)

        def goals_r(B, ps_=ps_r):
            return api.random_goals(ps_, (B,), gen, dtype=torch.float32, device=dev)[0]

        D_r, Y0_r = solver_r.prepare(goals_r(B_CHECK))
        bitwise_check("8", tag, ep_r, Y0_r, D_r, dict(maxiter=1, maxinner=24),
                      dict(maxiter=100, **tr_kw))
        two = tr_solve.kernel_shape(ep_r, B_MAIN, ps_r.dim)["two_per_warp"]
        check(two == (ps_r.dim == 2), f"{tag}: two_per_warp is {two}")
        first = first_call(tag, solver_r, goals_r(B_MAIN))
        sets = [goals_r(B_MAIN) for _ in range(2)]
        calls_r, n_r = path_calls(tag, solver_r, sets)
        graphed.append((tag, solver_r, sets[-1], (), first))
        D_m, Y0_m = solver_r.prepare(goals_r(B_MAIN))
        tr_paths.append(sub_record(tag, ep_r, Y0_m.contiguous(), ep_r.edge_values(D_m).contiguous(),
                                   dict(maxiter=100, **tr_kw), n_r, B_MAIN, lanes_bitwise=B_CHECK,
                                   success=[c[3]["success_rate"] for c in calls_r]))

    # ---- phase 9: the restart paths ----
    rgen = torch.Generator(device=dev).manual_seed(SEED)
    anchored_paths = []
    restart_cfgs = [("ur10_restarts4", ps, 4, prod),
                    ("ur10_table_restarts2", ps_t, 2, table_params),
                    ("planar6_restarts2", load_planar_chain(6, limits=np.pi / 2)[1], 2, prod),
                    ("planar10_restarts2", load_planar_chain(10, limits=np.pi / 2)[1], 2, prod)]
    for tag, ps_r, R, params_r in restart_cfgs:
        B_r = B_MAIN // R
        table = ps_r.n_obstacles > 0
        rsolver = make_restart_solver(ps_r, n_restarts=R, params=params_r, polish_params=polish,
                                      smooth_iters=2)
        # the single-init reference runs eagerly (api.solve_ik's stages): two
        # calls cost less than a capture
        single = api.Solver(ps_r, params=params_r, polish_params=polish, smooth_iters=2)

        def goals_rr(B, ps_=ps_r):
            return api.random_goals(ps_, (B,), gen, dtype=torch.float32, device=dev)[0]

        first = first_call(tag, rsolver, goals_rr(B_r), rgen)
        sets = [goals_rr(B_r) for _ in range(2)]
        calls_r, n_r = path_calls(tag, rsolver, sets, rgen, anchored=table)
        graphed.append((tag, rsolver, sets[-1], (rgen,), first))
        for i, (T_goal, c) in enumerate(zip(sets, calls_r)):
            s_single = api.summarize(single(T_goal))["success_rate"]
            s_rest = c[3]["success_rate"]
            used = torch.bincount(c[4]["restart_index"], minlength=R).tolist()
            log(f"[9] {tag} call {i}: {B_r} goals x {R} restarts: success {s_rest:.4f}, single "
                f"init on the same goals {s_single:.4f}; goals per chosen restart {used}")
            check(s_rest >= s_single - 0.005, f"{tag}: restarts below the single init")
        if table:
            spec_r = ps_r.reduced_spec()
            Nr_ = spec_r["Nr"]
            om_r, pl_r, pu_r = ps_r.masks()
            ep_r = edge_ops.build_edge_problem(om_r[:Nr_, :Nr_], pl_r[:Nr_, :Nr_], pu_r[:Nr_, :Nr_],
                                               dim=ps_r.dim, anchors=spec_r)
            kw = dict(maxiter=250, **t_kw)
        else:
            ep_r = edge_problem(ps_r)
            kw = dict(maxiter=100, **tr_kw)
        D_m, Y0_m = rsolver.prepare(sets[-1], rgen)
        rec = sub_record(tag, ep_r, Y0_m.contiguous(), ep_r.edge_values(D_m).contiguous(), kw,
                         n_r, B_MAIN, restarts=R, success=[c[3]["success_rate"] for c in calls_r])
        (anchored_paths if table else tr_paths).append(rec)

    # ---- phase 10: the two-end-effector tree with 3 restarts ----
    ps_tree = load_tree5()[1]
    ep_tree = edge_problem(ps_tree)
    tree_params = TRParams.production(maxiter=300)
    tree_kw = dict(maxiter=300, plateau_every=16, plateau_rtol=tree_params.plateau_rtol)
    tsolver = make_restart_solver(ps_tree, n_restarts=3, params=tree_params)
    T_tree = api.random_goals(ps_tree, (B_TREE,), gen, dtype=torch.float32, device=dev)[0]
    check(T_tree.shape == (B_TREE, 2, 4, 4), "the tree has two end effectors")
    # the path's own inputs: 3 restarts of B_TREE goals, 2 idle node lanes
    # and 2 padded edge slots in each half warp
    D_m, Y0_m = tsolver.prepare(T_tree, rgen)
    bitwise_check("10", "tree_restarts3", ep_tree, Y0_m, D_m, dict(maxiter=1), tree_kw)
    first = first_call("tree_restarts3", tsolver, T_tree, rgen)
    sets = [api.random_goals(ps_tree, (B_TREE,), gen, dtype=torch.float32, device=dev)[0]]
    calls_tree, n_tree = path_calls("tree_restarts3", tsolver, sets, rgen)
    graphed.append(("tree_restarts3", tsolver, sets[-1], (rgen,), first))
    tr_paths.append(sub_record("tree_restarts3", ep_tree, Y0_m.contiguous(),
                               ep_tree.edge_values(D_m).contiguous(), tree_kw,
                               n_tree, 3 * B_TREE, restarts=3, lanes_bitwise=3 * B_TREE,
                               success=[c[3]["success_rate"] for c in calls_tree]))

    # ---- phases 11-13: dense and sparse CIDGIK (K5 only) ----
    position_runs = []  # the graphed-loop paths, for phase 18's batch-position check
    cidgik_paths = cidgik_phases(dev, gen, [
        ("ur10_cidgik", "11", ps, B_CIDGIK, CIDGIK_UR10, False),
        ("ur10_table_cidgik", "12", ps_t, B_CIDGIK_TABLE, {}, False)], position_runs)
    t_new = time.perf_counter()
    cidgik_paths += cidgik_phases(dev, gen, [
        ("ur10_cidgik_sparse", "13", ps, B_CIDGIK, CIDGIK_UR10, True)], position_runs)

    # ---- phase 14: Riemannian CG on UR10 (K5 in prepare only) ----
    cg_path = cg_phase(dev, gen, ps, polish, position_runs)
    log(f"[14] phases 13 and 14 took {time.perf_counter() - t_new:.1f} s")

    # ---- phase 15: planar10_ring6, the anchored TR kernel at d = 2 ----
    t_new = time.perf_counter()
    ring_kernel = ring_phase(dev, gen, polish, graphed)
    # ---- phase 16: the data-parallel solve on the card ----
    sharded_path = sharded_phase(dev, gen, ps, prod, polish)
    log(f"[16] phases 15 and 16 took {time.perf_counter() - t_new:.1f} s")
    # ---- phase 17: the trust region's "dense" and "edge" backends ----
    prepare_paths = []
    backend_paths = tr_backends_phase(dev, gen, ps, ps_t, polish, prepare_paths, position_runs)
    # ---- phase 20: robots past 32 nodes, anchor rows past 1024 ----
    t_new = time.perf_counter()
    large = large_structures()
    for tag, ps_l, smooth in large:
        anchored = ps_l.n_obstacles > 0
        if anchored:
            spec_l = ps_l.reduced_spec()
            Nr_ = spec_l["Nr"]
            om_l, pl_l, pu_l = ps_l.masks()
            ep_l = edge_ops.build_edge_problem(om_l[:Nr_, :Nr_], pl_l[:Nr_, :Nr_],
                                               pu_l[:Nr_, :Nr_], dim=ps_l.dim, anchors=spec_l)
        else:
            ep_l = edge_problem(ps_l)
        solver_l = api.make_solver(ps_l, params=prod, polish_params=polish, smooth_iters=smooth)
        shape_l = tr_solve.kernel_shape(ep_l, B_MAIN, ps_l.dim)
        W_l = 16 if shape_l["two_per_warp"] else 32
        # node slots a lane: 1 up to 32 nodes, 2 up to 64 (at most 256
        # edges), else 4 (csrc/tr_solve.cu dispatch)
        npl = 1 if ep_l.N <= 32 and ep_l.E <= 256 else (
            2 if ep_l.N <= 64 and ep_l.E <= 256 else 4)
        epl = -(-ep_l.E // W_l)
        inst = (f"tr_wide_kernel<{ps_l.dim},{epl},{int(anchored)}>" if npl == 4 else
                f"tr_kernel<{ps_l.dim},{epl},{W_l},{npl},{int(anchored)}>")
        regs, smem, spill = ptxas[inst]
        log(f"[20] {tag}: N = {ps_l.N}, solve nodes {ep_l.N}, d = {ps_l.dim}, E = {ep_l.E}, "
            f"A = {ep_l.A} ({ep_l.a_nsel} groups of {ep_l.a_R}); {inst}: {regs} registers, "
            f"{smem} B static smem, {spill} B spill stores; kernel_shape at B={B_MAIN}: "
            f"{shape_l}")

        def goals_l(B, ps_=ps_l):
            return api.random_goals(ps_, (B,), gen, dtype=torch.float32, device=dev)[0]

        D_l, Y0_l = solver_l.prepare(goals_l(B_CHECK))
        bitwise_check("20", tag, ep_l, Y0_l, D_l, dict(maxiter=1, maxinner=24),
                      dict(maxiter=100, **tr_kw))
        first = first_call(tag, solver_l, goals_l(B_MAIN))
        sets = [goals_l(B_MAIN) for _ in range(2)]
        calls_l, n_l = path_calls(tag, solver_l, sets, anchored=anchored)
        graphed.append((tag, solver_l, sets[-1], (), first))
        D_m, Y0_m = solver_l.prepare(goals_l(B_MAIN))
        Y0_m, dg_m = Y0_m.contiguous(), ep_l.edge_values(D_m).contiguous()
        # one step at the path's own shapes, against the plain version
        bitwise_check("20", tag, ep_l, Y0_m, D_m, dict(maxiter=1, maxinner=24))
        rec = sub_record(tag, ep_l, Y0_m, dg_m, dict(maxiter=100, **tr_kw), n_l, B_MAIN,
                         lanes_bitwise=B_CHECK, instance=inst, registers=regs, static_smem=smem,
                         spill_stores=spill, success=[c[3]["success_rate"] for c in calls_l],
                         walls_ms=[[1e3 * t for t in c[:3]] for c in calls_l])
        (anchored_paths if anchored else tr_paths).append(rec)
    # planar40 at the UR10 path's two squarings, where every goal starts from
    # one goal-independent Y0: one goal at every position of the batch, and
    # the batch reversed (phase 18 checks the other single-init paths)
    # (the first run, one goal at every position, is the capture)
    solver_40 = api.make_solver(large[0][1], params=prod, polish_params=polish, smooth_iters=2)
    T_40 = api.random_goals(large[0][1], (B_MAIN,), gen, dtype=torch.float32, device=dev)[0]
    position_20 = position_check("20", "planar40_smooth2",
                                 lambda T: path_outputs(solver_40, T), T_40)
    solver_40.graphs.release()
    del solver_40
    log(f"[20] phase took {time.perf_counter() - t_new:.1f} s")

    # ---- phase 18: the compiled solver against the eager stages ----
    compiled_paths, positions = compiled_phase(dev, graphed, prepare_paths, position_runs)
    positions.insert(0, position_20)

    # Bounds: counted from the shapes and, for the TR kernels, from the
    # iteration counts of the runs that were timed. No single PyTorch call
    # computes K1-K4, so they have no library time; K5's is
    # torch.linalg.eigh's (phase 19).
    N, d, E = ps.N, ps.dim, ep.E
    b_tr = bound(tr_flops(N, d, E, k_main), tr_bytes(N, d, E, B_MAIN))
    b_ta = bound(tr_flops(ep_t.N, 3, ep_t.E, ka, anchored_nodes=ep_t.a_nsel),
                 tr_bytes(ep_t.N, 3, ep_t.E, B_CHECK))
    b_tab = bound(tr_flops(ep_t.N, 3, ep_t.E, k_tab, anchored_nodes=ep_t.a_nsel),
                  tr_bytes(ep_t.N, 3, ep_t.E, B_MAIN))
    shape_tr = tr_solve.kernel_shape(ep, B_MAIN, d)
    shape_ta = tr_solve.kernel_shape(ep_t, B_MAIN, 3)
    log(f"[kernels] TR launch shapes at B={B_MAIN}: UR10 {shape_tr}; table {shape_ta}")
    t_e = eigh_rec["timing"]["f32"]
    t_s = spd_rec["cases"][0]
    record = {"kernels": [
        {"name": "sym_eigh", "route": "cuda", "source": "graphik_tpu_torch/csrc/eigh.cu",
         "replaces": "graphik_tpu/utils/dgp.py:62", "launches": launches_eigh,
         "max_abs_err": eigh_rec["max_abs_err"], "ms": t_e["ms"], "plain_ms": t_e["plain_ms"],
         "bound_ms": t_e["bound_ms"], "bound_by": t_e["bound_by"],
         "library_ms": t_e["library_ms"],
         "at": f"UR10's prepare Gram, B={t_e['B']}, n={t_e['n']}, float32; jnp.linalg.eigh "
               "in the JAX package's jitted prepare, not a Pallas kernel",
         "float64": eigh_rec["timing"]["f64"],
         "occupancy_ms": next(r["occupancy_ms"] for r in eigh_rec["paths"]
                              if r["case"] == "ur10 G f32"),
         "paths": eigh_rec["paths"], "cases": eigh_rec["shapes"]},
        {"name": "tr_solve", "route": "cuda", "source": "graphik_tpu_torch/csrc/tr_solve.cu",
         "replaces": "graphik_tpu/ops/tr_pallas.py:59", "launches": launches,
         "max_abs_err": err_y, "ms": ms_kernel, "plain_ms": ms_plain,
         "bound_ms": b_tr[0], "bound_by": b_tr[1], "library_ms": None,
         "blocks_resident": shape_tr["blocks_resident"],
         "at": f"UR10, B={B_MAIN}, maxiter=100, maxinner=24", "paths": tr_paths},
        {"name": "tr_solve_anchored", "route": "cuda",
         "source": "graphik_tpu_torch/csrc/tr_solve.cu",
         "replaces": "graphik_tpu/ops/tr_pallas.py:77", "launches": launches_a,
         "max_abs_err": err_a, "ms": ms_a_kernel, "plain_ms": ms_a_plain,
         "bound_ms": b_ta[0], "bound_by": b_ta[1], "library_ms": None,
         "blocks_resident": shape_ta["blocks_resident"],
         "at": f"table, B={B_CHECK}, maxiter=100, maxinner=32",
         "ms_table_path": ms_a_main, "bound_ms_table_path": b_tab[0],
         "paths": [{"path": "ur10_table", "launches": launches_a, "ms": ms_a_main,
                    "bound_ms": b_tab[0], "bound_by": b_tab[1], "N": ep_t.N, "d": 3,
                    "E": ep_t.E, "A": ep_t.A, "B": B_MAIN, "kernel_shape": shape_ta}]
         + anchored_paths},
        *edge_records,
        ring_kernel,
        {"name": "spd_solve", "route": "cuda", "source": "graphik_tpu_torch/csrc/spd_solve.cu",
         "replaces": "graphik_tpu/ops/linalg.py:55", "launches": launches_spd,
         "max_abs_err": spd_rec["max_abs_err"], "ms": t_s["ms"], "plain_ms": t_s["plain_ms"],
         "bound_ms": t_s["bound_ms"], "bound_by": t_s["bound_by"],
         "library_ms": t_s["library_ms"], "call_ms": t_s["call_ms"],
         "at": f"UR10's LM systems, B={t_s['B']}, m={t_s['m']}, float32; spd_solve_unrolled in "
               "the JAX package's LM step, not a Pallas kernel; ms is the device time (a CUDA "
               "graph of 20 launches), call_ms the wrapper's call; library_ms is cholesky_ex + "
               "2 solve_triangular (pivots not clamped)",
         "paths": spd_rec["cases"]},
    ]}
    log(f"[11-13] CIDGIK paths: {json.dumps(cidgik_paths)}")
    log(f"[14] CG path: {json.dumps(cg_path)}")
    log(f"[16] sharded paths: {json.dumps(sharded_path)}")
    log(f"[17] TR backend paths: {json.dumps(backend_paths)}")
    log(f"[18] compiled paths: {json.dumps(compiled_paths)}")
    log(f"[18, 20] batch-position checks: {json.dumps(positions)}")
    log(f"[22] finish rounding: {json.dumps(rounding_rec)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
