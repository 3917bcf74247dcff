"""CIDGIK: the convex-iteration SDP relaxation of the distance program, batched.

Port of graphik_tpu/solvers/cidgik.py (dense CIDGIK). The lifted variable is

    Z = [[ I_d , X^T ],      X (n_free, d): the free node positions,
         [ X   , G   ]]      G = X X^T at a rank-d solution.

Anchored nodes (p0, q0, the goal anchors, obstacle centres) enter the
constraints linearly through their per-instance positions; the base nodes
x, y are left out. Each SDP is solved by a two-block ADMM over the product
of the affine set and the cone PSD x [lo, hi]; rank d is forced by the
closed-form Fantope projection C = U_{d:} U_{d:}^T, once per outer round.

Two ADMM engines, as in the JAX package:
* "split" (the default): the constraint rows shared by the whole batch
  (the identity block, structure edges, base-anchor edges, obstacle rows)
  are factored once on the host in float64; only the ~8 rows that touch the
  goal anchors are per instance, through an m_d x m_d Schur complement.
  Each iteration is a few shared-weight (B, m_s) x (m_s, m_s) products.
  The batch stops together, once the largest primal residual is at most
  `admm_tol`.
* "vmap": the per-instance engine (the oracle, and the nearest-point SDP):
  each instance has its own Gram factor and stops on its own residual.

Both loops keep their stop flags on the device: a stopped lane (or batch)
keeps its state through `torch.where`, and the host reads the flag only
every `SYNC_EVERY` iterations to leave the loop early, so the iterate is
the JAX package's while_loop's. The SYNC_EVERY steps between two reads
are one piece of a compiled.Loop: on a card a CUDA graph, captured once
per template and shape and replayed (the template owns its graphs, and
they go with it), as the JAX package's loops run as one device program
whether or not their caller jits them; on the CPU, eager.

Eigendecompositions (the Fantope step, and the cone projection when
cone_ns_iters = 0) are ops/eigh.py::sym_eigh of the symmetrised matrix -
K5, a hand-written Jacobi kernel, on a card, which reads nothing back to
the host, so the eigh cone projection replays inside the ADMM's graphs as
the Newton-Schulz one does; the Fantope step runs eagerly once a round.
The JAX package's fixed-sweep Jacobi is a TPU workaround; `eigh_sweeps` is
kept as a field and selects nothing here. Status codes: 0 = FEASIBLE,
1 = INFEASIBLE (the primal residual did not reach `feas_tol`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.ops.eigh import sym_eigh
from graphik_tpu_torch.ops.linalg import psd_project_ns, rowwise_sum, spd_inverse_factor
from graphik_tpu_torch.robots import kinematics
from graphik_tpu_torch.utils import compiled

FEASIBLE = 0
INFEASIBLE = 1

# ADMM iterations between two host reads of the device-side stop flag.
SYNC_EVERY = 50


@dataclasses.dataclass(eq=False)
class CidgikCompiled:
    """Static (per robot + environment) CIDGIK problem template.

    SDP nodes are the problem-graph nodes minus x, y. `free_idx` /
    `anchor_idx` map into the ProblemStructure node order. Constraint
    tables are dense, with per-edge node slots; the per-instance anchor
    positions are gathered at solve time.
    """

    structure: ProblemStructure
    free_idx: np.ndarray  # (n_free,) problem-node indices of free points
    anchor_idx: np.ndarray  # (n_anchor,) problem-node indices of anchors

    # equality edges free-free: (m_ff, 2) free slots; b = d^2
    eq_ff: np.ndarray
    eq_ff_b: np.ndarray
    # equality edges free-anchor: (m_fa, 2) = (free slot, anchor slot)
    eq_fa: np.ndarray
    eq_fa_d2: np.ndarray  # squared edge length
    eq_fa_dynamic: np.ndarray  # bool: the anchor is a goal anchor

    # inequality edges: slots and squared box bounds
    in_ff: np.ndarray
    in_ff_lo: np.ndarray
    in_ff_hi: np.ndarray
    in_fa: np.ndarray
    in_fa_lo: np.ndarray
    in_fa_hi: np.ndarray

    # floor_mode planar rows n . x_u = c on free nodes; empty otherwise
    lin_u: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))
    lin_n: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3)))
    lin_c: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))

    @property
    def d(self) -> int:
        return self.structure.dim

    @property
    def n_free(self) -> int:
        return len(self.free_idx)

    @property
    def s(self) -> int:  # lifted matrix size
        return self.d + self.n_free

    @property
    def m_eq(self) -> int:
        d = self.d
        return d * (d + 1) // 2 + len(self.lin_u) + len(self.eq_ff) + len(self.eq_fa)

    @property
    def m_in(self) -> int:
        return len(self.in_ff) + len(self.in_fa)


def _goal_anchors(ps: ProblemStructure) -> set:
    """Nodes a goal pose positions: each end effector's p and q (3D), or
    its p and its parent's p (planar)."""
    nodes = set()
    for ee in ps.template.ee:
        nodes.add(ps.idx_p(int(ee)))
        if ps.dim == 3:
            nodes.add(ps.idx_q(int(ee)))
        else:
            nodes.add(ps.idx_p(int(ps.template.parents[int(ee)])))
    return nodes


def compile_cidgik(ps: ProblemStructure, floor_mode: bool = False) -> CidgikCompiled:
    """Host-side constraint assembly, for 3D revolute and planar problems.

    floor_mode frees the base nodes p0, q0 from anchoring and holds each on
    its canonical horizontal plane instead (linear equalities
    n . x_u = c with n = e_z): the base may slide and yaw on the floor while
    the goal anchors still pin the end effector.
    """
    dim = ps.dim
    sdp_nodes = [i for i in range(ps.N) if i not in (ps.idx_x, ps.idx_y)]
    anchor = {i for i in sdp_nodes if ps.anchor_mask[i]}
    floor_nodes = []
    if floor_mode:
        if dim != 3:
            raise ValueError("floor_mode requires a 3D problem")
        floor_nodes = [ps.idx_p(0), ps.idx_q(0)]
        anchor -= set(floor_nodes)
    free = [i for i in sdp_nodes if i not in anchor]
    anchor = sorted(anchor)
    free_slot = {node: k for k, node in enumerate(free)}
    anchor_slot = {node: k for k, node in enumerate(anchor)}
    goal_anchor = _goal_anchors(ps)

    eq_ff, eq_ff_b = [], []
    eq_fa, eq_fa_d2, eq_fa_dyn = [], [], []
    in_ff, in_ff_lo, in_ff_hi = [], [], []
    in_fa, in_fa_lo, in_fa_hi = [], [], []
    for a in range(ps.N):
        for b in range(a + 1, ps.N):
            if a not in free_slot and a not in anchor_slot:
                continue
            if b not in free_slot and b not in anchor_slot:
                continue
            if a in anchor_slot and b in anchor_slot:
                continue  # constant constraints carry no information
            both_free = a in free_slot and b in free_slot
            f, anc = (a, b) if a in free_slot else (b, a)
            if ps.omega_struct[a, b]:
                d2 = float(ps.D_struct[a, b])
                if both_free:
                    eq_ff.append((free_slot[a], free_slot[b]))
                    eq_ff_b.append(d2)
                else:
                    eq_fa.append((free_slot[f], anchor_slot[anc]))
                    eq_fa_d2.append(d2)
                    eq_fa_dyn.append(anc in goal_anchor)
            elif ps.bounded_mask[a, b]:
                lo = float(ps.check_L[a, b]) ** 2
                hi = float(ps.check_U[a, b]) ** 2
                if both_free:
                    in_ff.append((free_slot[a], free_slot[b]))
                    in_ff_lo.append(lo)
                    in_ff_hi.append(hi)
                else:
                    in_fa.append((free_slot[f], anchor_slot[anc]))
                    in_fa_lo.append(lo)
                    in_fa_hi.append(hi)

    # floor rows: n . x_u = c, c = n . pos_fixed[u] (z(p0) = 0, z(q0) = 1
    # for the standard templates)
    lin_u, lin_n, lin_c = [], [], []
    if floor_nodes:
        pos_fixed = np.asarray(ps.pos_fixed, np.float64)
        n_vec = np.zeros(dim)
        n_vec[-1] = 1.0
        for node in floor_nodes:
            lin_u.append(free_slot[node])
            lin_n.append(n_vec.copy())
            lin_c.append(float(n_vec @ pos_fixed[node, :dim]))

    def pairs(x):
        return np.asarray(x, np.int64).reshape(len(x), 2) if x else np.zeros((0, 2), np.int64)

    return CidgikCompiled(
        structure=ps,
        free_idx=np.asarray(free, np.int64),
        anchor_idx=np.asarray(anchor, np.int64),
        eq_ff=pairs(eq_ff),
        eq_ff_b=np.asarray(eq_ff_b, float),
        eq_fa=pairs(eq_fa),
        eq_fa_d2=np.asarray(eq_fa_d2, float),
        eq_fa_dynamic=np.asarray(eq_fa_dyn, bool),
        in_ff=pairs(in_ff),
        in_ff_lo=np.asarray(in_ff_lo, float),
        in_ff_hi=np.asarray(in_ff_hi, float),
        in_fa=pairs(in_fa),
        in_fa_lo=np.asarray(in_fa_lo, float),
        in_fa_hi=np.asarray(in_fa_hi, float),
        lin_u=np.asarray(lin_u, np.int64),
        lin_n=np.asarray(lin_n, float) if lin_u else np.zeros((0, dim)),
        lin_c=np.asarray(lin_c, float),
    )


def _graphs(comp):
    """The StageGraphs that hold the template's loop graphs: made on first
    use, and freed with the template."""
    graphs = getattr(comp, "_loop_graphs", None)
    if graphs is None:
        graphs = comp._loop_graphs = compiled.StageGraphs()
    return graphs


def _dev(owner, key, build, dtype, device):
    """build() (host numpy) as a tensor of dtype on device, made once per
    (owner, key, dtype, device) (compiled.cached): a template's constants
    are copied from the host once."""
    return compiled.cached(owner, (key, dtype, device),
                           lambda: torch.as_tensor(np.asarray(build()), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Constraint matrices (numpy builders shared by both engines)
# ---------------------------------------------------------------------------

def _static_eq_rows(comp: CidgikCompiled):
    """The homogenizing identity block Z[i, j] = delta_ij (i <= j < d) and
    the floor rows tr(A Z) = n . x_u = c: (list of (s, s), list of rhs)."""
    d, s = comp.d, comp.s
    mats, rhs = [], []
    for i in range(d):
        for j in range(i, d):
            A = np.zeros((s, s))
            A[i, j] += 0.5
            A[j, i] += 0.5
            mats.append(A)
            rhs.append(1.0 if i == j else 0.0)
    for k in range(len(comp.lin_u)):
        u = int(comp.lin_u[k])
        A = np.zeros((s, s))
        A[d + u, :d] = 0.5 * comp.lin_n[k]
        A[:d, d + u] = 0.5 * comp.lin_n[k]
        mats.append(A)
        rhs.append(float(comp.lin_c[k]))
    return mats, rhs


def _ff_mat(u, v, d, s):
    """tr(A Z) = G_uu + G_vv - 2 G_uv = ||x_u - x_v||^2."""
    A = np.zeros((s, s))
    A[d + u, d + u] = 1.0
    A[d + v, d + v] = 1.0
    A[d + u, d + v] = -1.0
    A[d + v, d + u] = -1.0
    return A


def _fa_mat(u, a, d, s):
    """tr(A Z) = G_uu - 2 a^T x_u (the ||a||^2 constant goes to the rhs)."""
    A = np.zeros((s, s))
    A[d + u, d + u] = 1.0
    A[d + u, :d] = -a
    A[:d, d + u] = -a
    return A


def _constraint_matrices(comp: CidgikCompiled, anchors_pos):
    """The symmetric constraint tensors and right-hand sides of each
    instance, row-normalized.

    anchors_pos: (..., n_anchor, d) per-instance anchor positions; the
    leading dims batch. Returns (A_eq (..., m_eq, s, s), b_eq (..., m_eq),
    A_in (..., m_in, s, s), lo, hi (..., m_in)), in anchors_pos's dtype.
    """
    d, s = comp.d, comp.s
    batch = anchors_pos.shape[:-2]
    dt, dev = anchors_pos.dtype, anchors_pos.device

    def const(key, build, tail):
        return _dev(comp, key, build, dt, dev).expand(batch + tail)

    def ff_mats(key, pairs):
        return const(key, lambda: np.stack([_ff_mat(u, v, d, s) for u, v in pairs]),
                     (len(pairs), s, s))

    def fa_mats(key, pairs):
        # G_uu - 2 a^T x_u, a the instance's anchor; returns (A, ||a||^2)
        m = len(pairs)
        a_pos = anchors_pos[..., _dev(comp, (key, "anchor"), lambda: pairs[:, 1], torch.long,
                                      dev), :]  # (..., m, d)
        k = torch.arange(m, device=dev)
        u = _dev(comp, (key, "u"), lambda: d + pairs[:, 0], torch.long, dev)
        j = torch.arange(d, device=dev)
        out = torch.zeros(batch + (m, s, s), dtype=dt, device=dev)
        out[..., k, u, u] = 1.0
        out[..., k[:, None], u[:, None], j[None, :]] = -a_pos
        out[..., k[:, None], j[None, :], u[:, None]] = -a_pos
        return out, (a_pos**2).sum(-1)

    n_static = len(_static_eq_rows(comp)[1])
    A_eq = [const("eq_static", lambda: np.stack(_static_eq_rows(comp)[0]), (n_static, s, s))]
    b_eq = [const("eq_static_b", lambda: _static_eq_rows(comp)[1], (n_static,))]
    if len(comp.eq_ff):
        A_eq.append(ff_mats("eq_ff", comp.eq_ff))
        b_eq.append(const("eq_ff_b", lambda: comp.eq_ff_b, (len(comp.eq_ff),)))
    if len(comp.eq_fa):
        # a structure edge to a goal anchor keeps its rigid length (the goal
        # only moves the anchor): b = d^2 - ||a||^2 for every one
        A, a2 = fa_mats("eq_fa", comp.eq_fa)
        A_eq.append(A)
        b_eq.append(const("eq_fa_d2", lambda: comp.eq_fa_d2, (len(comp.eq_fa),)) - a2)
    A_eq, b_eq = torch.cat(A_eq, dim=-3), torch.cat(b_eq, dim=-1)

    A_in, lo, hi = [], [], []
    if len(comp.in_ff):
        A_in.append(ff_mats("in_ff", comp.in_ff))
        lo.append(const("in_ff_lo", lambda: comp.in_ff_lo, (len(comp.in_ff),)))
        hi.append(const("in_ff_hi", lambda: comp.in_ff_hi, (len(comp.in_ff),)))
    if len(comp.in_fa):
        A, a2 = fa_mats("in_fa", comp.in_fa)
        A_in.append(A)
        lo.append(const("in_fa_lo", lambda: comp.in_fa_lo, (len(comp.in_fa),)) - a2)
        hi.append(const("in_fa_hi", lambda: comp.in_fa_hi, (len(comp.in_fa),)) - a2)
    if A_in:
        A_in, lo, hi = torch.cat(A_in, dim=-3), torch.cat(lo, dim=-1), torch.cat(hi, dim=-1)
    else:
        A_in = torch.zeros(batch + (0, s, s), dtype=dt, device=dev)
        lo = hi = torch.zeros(batch + (0,), dtype=dt, device=dev)

    # SCS-style row normalization: unit-Frobenius constraint matrices keep
    # the ADMM operator well conditioned across edge length scales
    def rownorm(A):
        return torch.sqrt(torch.clamp(rowwise_sum(A * A, 2), min=1e-12))

    n_eq = rownorm(A_eq)
    A_eq, b_eq = A_eq / n_eq[..., None, None], b_eq / n_eq
    if A_in.shape[-3]:
        n_in = rownorm(A_in)
        A_in, lo, hi = A_in / n_in[..., None, None], lo / n_in, hi / n_in
    return A_eq, b_eq, A_in, lo, hi


# ---------------------------------------------------------------------------
# Batched conic ADMM:  min <C,Z>  s.t. A_eq(Z)=b, lo <= A_in(Z) <= hi, Z >= 0
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CidgikParams:
    max_outer: int = 10  # convex-iteration rounds
    admm_iters: int = 2000  # per SDP solve (a cap; stops early on admm_tol)
    # iterations of rounds 1.. (None: admm_iters); warm-started rounds need
    # far fewer than the cold first one (split engine only)
    admm_iters_rest: Optional[int] = None
    admm_tol: float = 1e-7  # primal residual target per solve
    relax: float = 1.6  # over-relaxation
    rho: float = 1.0  # penalty
    abs_tol: float = 1e-6  # cost-change stops of the convex iteration
    rel_tol: float = 1e-3
    feas_tol: float = 1e-4  # primal residual -> FEASIBLE / INFEASIBLE
    # The JAX package's Jacobi sweeps (0: its jnp.linalg.eigh). Kept for
    # the same fields; the port always uses ops/eigh.py::sym_eigh.
    eigh_sweeps: int = 8
    # > 0: the per-iteration PSD cone projection is that many Newton-Schulz
    # steps (batched matmuls) instead of an eigendecomposition. The Fantope
    # projection (once per round) always uses eigh.
    cone_ns_iters: int = 0
    # iterative-refinement steps of the affine projection's Gram solve (in
    # float32 the raw solve biases the ADMM fixed point by ~cm)
    refine_steps: int = 1
    # residual-balancing rho adaptation every adapt_every iterations (vmap
    # engine; 0 disables): rho x adapt_tau when the primal residual exceeds
    # adapt_mu x the dual one (and / adapt_tau the other way), clipped to
    # [adapt_lo, adapt_hi] when it fires
    adapt_every: int = 0
    adapt_mu: float = 10.0
    adapt_tau: float = 2.0
    adapt_lo: float = 0.3
    adapt_hi: float = 3.0

    @classmethod
    def production(cls, **overrides) -> "CidgikParams":
        """The tuned serving point of the JAX package: rho = 10, the
        (1000, 9 x 500) warm-start schedule and the Newton-Schulz cone
        projection."""
        kw = dict(admm_iters=1000, admm_iters_rest=500, max_outer=10, cone_ns_iters=16, rho=10.0)
        kw.update(overrides)
        return cls(**kw)


def _bmv(M, v):
    """Batched matrix-vector product: (B, m, n) x (B, n) -> (B, m)."""
    return (M @ v[..., None])[..., 0]


def _select(mask, new, old):
    """`new` where mask, else `old`; mask (B,) or () against (B, ...)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim)), new, old)


def _sym_eigh(W):
    """ops/eigh.py::sym_eigh (K5 on a card) of (W + W^T) / 2, as
    jnp.linalg.eigh factors it (sym_eigh reads one triangle only)."""
    return sym_eigh(0.5 * (W + W.transpose(-1, -2)))


def _cone_project(W, t, lo, hi, params, pad_mask=None):
    """PSD x box projection of (W, t). W may stack blocks (..., s, s), each
    projected on its own; pad_mask (a 0/1 tensor broadcast against W) zeroes
    padded rows and columns before and after the projection."""
    if pad_mask is not None:
        W = W * pad_mask
    if params.cone_ns_iters:
        Wp = psd_project_ns(W, iters=params.cone_ns_iters)
    else:
        lam, Q = _sym_eigh(W)
        Wp = (Q * torch.clamp(lam, min=0.0)[..., None, :]) @ Q.transpose(-1, -2)
    if pad_mask is not None:
        Wp = Wp * pad_mask
    return Wp, torch.clamp(t, min=lo, max=hi)


def _admm_chunk(state, consts, make_step, static, ks):
    """ADMM steps, one for each entry of ks (the step's index modulo the
    period the step depends on), as a compiled.Loop piece. The state holds
    the engine's carry (x0, x1, ...), the last residual `res`, the stop
    flag `running` taken from it and `flag`, whether any lane still runs.
    A step is kept only where the flag is set."""
    step, running_of = make_step(consts, *static)
    n = sum(1 for k in state if k.startswith("x"))
    carry = tuple(state[f"x{i}"] for i in range(n))
    res, running = state["res"], state["running"]
    for k in ks:
        new, pri = step(carry, k)
        carry = tuple(_select(running, a, b) for a, b in zip(new, carry))
        res = _select(running, pri, res)
        running = running_of(res)
    out = {f"x{i}": v for i, v in enumerate(carry)}
    out.update(res=res, running=running, flag=running.any())
    return out


def _run_admm(make_step, static, consts, carry, iters, graphs, period=1):
    """Up to `iters` ADMM steps with a device-side stop flag.

    make_step(consts, *static) -> (step, running_of): step(carry, k) ->
    (new_carry, res), running_of(res) -> bool tensor, per lane (B,) or for
    the batch (). A step is kept only where the flag, taken from the
    previous residual, is set (res starts at inf), so the result is a
    while_loop's; the host reads the flag every SYNC_EVERY steps, and the
    steps between two reads are one piece of a compiled.Loop over `graphs`
    (static: what make_step depends on besides the consts, hashable; the
    step sees its index modulo `period`). Each step taken adds one to
    `solve_cidgik.admm_steps` (the sparse solver's steps too), each read to
    `solve_cidgik.host_reads`. Returns the carry.
    """
    res = torch.full(carry[0].shape[:1], math.inf, dtype=carry[0].dtype,
                     device=carry[0].device)
    running = make_step(consts, *static)[1](res)
    state = {f"x{i}": v for i, v in enumerate(carry)}
    state.update(res=res, running=running, flag=running.any())
    loop = compiled.Loop(graphs, "admm", state, consts)
    k = 0
    while k < iters:
        if k:
            solve_cidgik.host_reads += 1
            if not loop.read("flag"):
                break
        n = min(SYNC_EVERY, iters - k)
        loop.run(_admm_chunk, make_step, static, tuple(j % period for j in range(k, k + n)))
        solve_cidgik.admm_steps += n
        k += n
    return loop.take(*(f"x{i}" for i in range(len(carry))))


def _admm_params(params):
    """params without the iteration cap, which no step reads: the rounds of
    one solve share their loop graphs."""
    return dataclasses.replace(params, admm_iters=0, admm_iters_rest=None)


def _per_lane(v, like):
    """A per-lane (B,) tensor shaped to broadcast against `like` (B, ...)."""
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def _vmap_step(consts, params):
    """The vmap engine's step over its consts (A_all, Gmm, Linv, b_eq, lo,
    hi, C and, for stacked blocks, pad_mask): (step, running_of)."""
    A_all, Gmm, Linv, b_eq, C = (consts[k] for k in ("A_all", "Gmm", "Linv", "b_eq", "C"))
    lo, hi, pad_mask = consts["lo"], consts["hi"], consts.get("pad_mask")
    B, m_eq = b_eq.shape
    dt = C.dtype
    zdims = tuple(range(1, C.ndim))
    A_allT = A_all.transpose(1, 2)
    LinvT = Linv.transpose(1, 2)

    def solve_gram(r):
        y = _bmv(LinvT, _bmv(Linv, r))
        for _ in range(params.refine_steps):
            y = y + _bmv(LinvT, _bmv(Linv, r - _bmv(Gmm, y)))
        return y

    def affine_project(Z, t):
        v = _bmv(A_all, Z.reshape(B, -1))
        y = solve_gram(v - torch.cat([b_eq, t], dim=1))
        return Z - _bmv(A_allT, y).reshape(Z.shape), t + y[:, m_eq:]

    alpha = params.relax

    def step(state, k):
        Z, t, Uz, ut, rho_c = state
        # prox of <C,Z> + the affine indicator at (W - U): shift by C/rho
        Z1, t1 = affine_project(Z - Uz - C / _per_lane(rho_c, C), t - ut)
        Zr = alpha * Z1 + (1.0 - alpha) * Z
        tr_ = alpha * t1 + (1.0 - alpha) * t
        Z2, t2 = _cone_project(Zr + Uz, tr_ + ut, lo, hi, params, pad_mask)
        Uz_new = Uz + Zr - Z2
        ut_new = ut + tr_ - t2
        pri = torch.sqrt(rowwise_sum((Z1 - Z2) ** 2, len(zdims)) + ((t1 - t2) ** 2).sum(-1))
        rho_new = rho_c
        if params.adapt_every:
            # residual balancing; the scaled duals rescale with 1/rho so the
            # unscaled dual variable is continuous
            dua = rho_c * torch.sqrt(rowwise_sum((Z2 - Z) ** 2, len(zdims))
                                     + ((t2 - t) ** 2).sum(-1))
            up = pri > params.adapt_mu * dua
            down = dua > params.adapt_mu * pri
            if k % params.adapt_every == params.adapt_every - 1:
                scale = torch.where(up, params.adapt_tau, 1.0 / params.adapt_tau).to(dt)
                rho_new = torch.where(
                    up | down,
                    torch.clamp(rho_c * scale, params.adapt_lo, params.adapt_hi), rho_c)
            adj = rho_c / rho_new
            Uz_new = Uz_new * _per_lane(adj, Uz_new)
            ut_new = ut_new * adj[:, None]
        return (Z2, t2, Uz_new, ut_new, rho_new), pri

    return step, lambda r: r > params.admm_tol


def _solve_sdp_admm(A_eq, b_eq, A_in, lo, hi, C, Z0, t0, U0, params, pad_mask=None,
                    graphs=None):
    """One linear-cost SDP per instance by two-block ADMM (the vmap engine).

    Batched over the leading dim B: A_eq (B, m_eq, *z), A_in (B, m_in, *z),
    C, Z0 (B, *z), t0 (B, m_in), U0 = (Uz, ut), where z is (s, s), or
    (K, ds, ds) for the sparse solver's stacked clique blocks (its cone is
    their product, with `pad_mask` as in _cone_project). Splitting: P =
    (Z, t) with the affine set {A_eq(Z) = b, A_in(Z) - t = 0} and the cone
    PSD x [lo, hi]; the affine projection solves with the Cholesky of the
    constraint Gram, formed once per call. Each lane stops on its own
    primal residual; the loop runs over `graphs` (_run_admm). Returns (Z,
    t, (Uz, ut), feas).
    """
    B, m_eq = A_eq.shape[0], A_eq.shape[1]
    m_in = A_in.shape[1]
    dt, dev = Z0.dtype, Z0.device
    m = m_eq + m_in
    A_all = torch.cat([A_eq, A_in], dim=1).reshape(B, m, -1)
    eye_m = torch.eye(m, dtype=dt, device=dev)
    Gmm = A_all @ A_all.transpose(1, 2)
    Gmm[:, m_eq:, m_eq:] += eye_m[m_eq:, m_eq:]
    tr = torch.diagonal(Gmm, dim1=-2, dim2=-1).sum(-1)
    Gmm = Gmm + (1e-9 * tr / m)[:, None, None] * eye_m
    consts = {"A_all": A_all, "Gmm": Gmm, "Linv": spd_inverse_factor(Gmm), "b_eq": b_eq,
              "lo": lo, "hi": hi, "C": C}
    if pad_mask is not None:
        consts["pad_mask"] = pad_mask
    carry = (Z0, t0, U0[0], U0[1], torch.full((B,), params.rho, dtype=dt, device=dev))
    Z, t, Uz, ut, _ = _run_admm(_vmap_step, (_admm_params(params),), consts, carry,
                                params.admm_iters, graphs,
                                period=params.adapt_every or 1)

    # primal feasibility of the returned cone-feasible iterate
    v = _bmv(A_all, Z.reshape(B, -1))
    feas = (v[:, :m_eq] - b_eq).abs().amax(-1)
    if m_in:
        vi = v[:, m_eq:]
        vio = torch.clamp(lo - vi, min=0.0) + torch.clamp(vi - hi, min=0.0)
        feas = torch.maximum(feas, vio.amax(-1))
    return Z, t, (Uz, ut), feas


# ---------------------------------------------------------------------------
# Split (static / dynamic) batched ADMM engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class _SplitOperator:
    """Host-side (numpy, float64) static data of the split ADMM."""

    # static rows, ordered [eq_s | in_s], row-normalized
    A_flat: np.ndarray  # (m_s, s*s)
    b_eq_s: np.ndarray  # (m_eq_s,)
    lo_s: np.ndarray  # (m_in_s,)
    hi_s: np.ndarray
    G_ss: np.ndarray  # (m_s, m_s) static Gram (+ slack identity on in rows)
    Linv_ss: np.ndarray  # G_ss^-1 = Linv^T Linv
    As_diag: np.ndarray  # (m_s, nf): A_i[d+u, d+u]
    As_rowvec: np.ndarray  # (m_s, nf, d): A_i[d+u, :d]
    # dynamic rows, ordered [eq_d | in_d] (raw; normalized per instance)
    u_d: np.ndarray  # (m_d,) free slots
    g_d: np.ndarray  # (m_d,) anchor slots (goal anchors)
    d2_d: np.ndarray  # (m_d,) squared edge length (eq rows; 0 on in rows)
    lo_d: np.ndarray  # (m_d,) raw bounds (in rows; 0 on eq rows)
    hi_d: np.ndarray
    m_eq_d: int
    m_in_d: int

    @property
    def m_s(self) -> int:
        return self.A_flat.shape[0]

    @property
    def m_eq_s(self) -> int:
        return len(self.b_eq_s)

    @property
    def m_in_s(self) -> int:
        return len(self.lo_s)

    @property
    def m_d(self) -> int:
        return len(self.u_d)


def _build_split_operator(comp: CidgikCompiled) -> _SplitOperator:
    """Assemble the static / dynamic split, cached on the compiled problem."""
    cached = getattr(comp, "_split_op", None)
    if cached is not None:
        return cached
    ps = comp.structure
    d, s, nf = comp.d, comp.s, comp.n_free
    goal_anchor = _goal_anchors(ps)
    anchor_is_goal = np.asarray([int(n) in goal_anchor for n in comp.anchor_idx])
    anc_pos = np.asarray(ps.pos_fixed, np.float64)[comp.anchor_idx]  # valid off the goals

    eq_mats, eq_b = _static_eq_rows(comp)  # batch-static, floor rows too
    for k in range(len(comp.eq_ff)):
        u, v = comp.eq_ff[k]
        eq_mats.append(_ff_mat(u, v, d, s))
        eq_b.append(comp.eq_ff_b[k])
    dyn = []  # (u, g, d2, lo, hi, is_eq)
    for k in range(len(comp.eq_fa)):
        u, g = comp.eq_fa[k]
        if anchor_is_goal[g]:
            dyn.append((u, g, comp.eq_fa_d2[k], 0.0, 0.0, True))
        else:
            a = anc_pos[g, :d]
            eq_mats.append(_fa_mat(u, a, d, s))
            eq_b.append(comp.eq_fa_d2[k] - a @ a)

    in_mats, in_lo, in_hi = [], [], []
    for k in range(len(comp.in_ff)):
        u, v = comp.in_ff[k]
        in_mats.append(_ff_mat(u, v, d, s))
        in_lo.append(comp.in_ff_lo[k])
        in_hi.append(comp.in_ff_hi[k])
    for k in range(len(comp.in_fa)):
        u, g = comp.in_fa[k]
        if anchor_is_goal[g]:
            dyn.append((u, g, 0.0, comp.in_fa_lo[k], comp.in_fa_hi[k], False))
        else:
            a = anc_pos[g, :d]
            in_mats.append(_fa_mat(u, a, d, s))
            in_lo.append(comp.in_fa_lo[k] - a @ a)
            in_hi.append(comp.in_fa_hi[k] - a @ a)

    A_s = np.stack(eq_mats + in_mats)  # (m_s, s, s)
    m_eq_s, m_in_s = len(eq_mats), len(in_mats)
    nrm = np.sqrt(np.maximum((A_s**2).sum(axis=(1, 2)), 1e-12))
    A_s = A_s / nrm[:, None, None]
    b_eq_s = np.asarray(eq_b) / nrm[:m_eq_s]
    lo_s = np.asarray(in_lo) / nrm[m_eq_s:] if m_in_s else np.zeros(0)
    hi_s = np.asarray(in_hi) / nrm[m_eq_s:] if m_in_s else np.zeros(0)

    A_flat = A_s.reshape(len(A_s), s * s)
    G_ss = A_flat @ A_flat.T
    if m_in_s:
        G_ss[m_eq_s:, m_eq_s:] += np.eye(m_in_s)
    G_ss += 1e-9 * np.trace(G_ss) / len(G_ss) * np.eye(len(G_ss))
    Linv_ss = np.linalg.inv(np.linalg.cholesky(G_ss))

    ui = d + np.arange(nf)
    dyn_eq = [t for t in dyn if t[5]]
    dyn_in = [t for t in dyn if not t[5]]
    dyn = dyn_eq + dyn_in
    op = _SplitOperator(
        A_flat=A_flat, b_eq_s=b_eq_s, lo_s=lo_s, hi_s=hi_s, G_ss=G_ss, Linv_ss=Linv_ss,
        As_diag=A_s[:, ui, ui], As_rowvec=A_s[:, ui, :d],
        u_d=np.asarray([t[0] for t in dyn], np.int64),
        g_d=np.asarray([t[1] for t in dyn], np.int64),
        d2_d=np.asarray([t[2] for t in dyn], np.float64),
        lo_d=np.asarray([t[3] for t in dyn], np.float64),
        hi_d=np.asarray([t[4] for t in dyn], np.float64),
        m_eq_d=len(dyn_eq), m_in_d=len(dyn_in),
    )
    comp._split_op = op
    return op


def _goal_row_data(op, anchors_pos, As_diag, As_rowvec, same):
    """The per-instance goal rows of a split operator (dense or sparse): the
    row data, their Gram blocks G_sd, G_dd and the Schur complement's
    Cholesky factor and explicit inverse, and the static data in the
    solve's dtype and device.

    op: the operator (g_d, d2_d, lo_d, hi_d, m_eq_d, m_in_d, Linv_ss, G_ss,
    b_eq_s, lo_s, hi_s); As_diag (m_s, m_d) and As_rowvec (m_s, m_d, d): the
    static rows' coefficients at each goal row's diagonal and row-vector
    entries; same (m_d, m_d): goal-row pairs that stamp the same entries;
    each a function of op alone, given as a function that builds it.
    anchors_pos: (B, n_anchor, d). The static data is copied from the host
    once per operator, dtype and device.
    """
    dt, dev = anchors_pos.dtype, anchors_pos.device
    m_d, m_eq_d = op.m_d, op.m_eq_d

    def const(key, build, dtype=dt):
        return _dev(op, key, build, dtype, dev)

    a_d = anchors_pos[:, const("g_d", lambda: op.g_d, torch.long), :]  # (B, m_d, d)
    a2 = (a_d * a_d).sum(-1)
    nrm_d = torch.sqrt(1.0 + 2.0 * a2)
    is_eq = torch.arange(m_d, device=dev) < m_eq_d
    b_d = torch.where(is_eq, const("d2_d", lambda: op.d2_d) - a2, 0.0) / nrm_d
    lo_d = (const("lo_d", lambda: op.lo_d[m_eq_d:]) - a2[:, m_eq_d:]) / nrm_d[:, m_eq_d:]
    hi_d = (const("hi_d", lambda: op.hi_d[m_eq_d:]) - a2[:, m_eq_d:]) / nrm_d[:, m_eq_d:]

    G_sd = (const("As_diag", As_diag)[None]
            - 2.0 * torch.einsum("bjk,ijk->bij", a_d, const("As_rowvec", As_rowvec))
            ) / nrm_d[:, None, :]  # (B, m_s, m_d)
    G_dd = const("same", same) * (1.0 + 2.0 * a_d @ a_d.transpose(1, 2)) / (nrm_d[:, :, None] * nrm_d[:, None, :])
    G_dd = G_dd + torch.diag(const("slack", lambda: np.concatenate([np.zeros(m_eq_d),
                                                                  np.ones(op.m_in_d)])))

    Linv = const("Linv_ss", lambda: op.Linv_ss)
    W = Linv.T @ (Linv @ G_sd)  # G_ss^-1 G_sd
    S = G_dd - G_sd.transpose(1, 2) @ W
    tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
    S = S + (1e-7 * tr / max(m_d, 1))[:, None, None] * torch.eye(m_d, dtype=dt, device=dev)
    # cholesky_ex: a lane whose complement is not positive definite in this
    # precision gets a non-zero schur_info, not an exception for the batch
    Ls, info = torch.linalg.cholesky_ex(S)
    Sinv = torch.cholesky_inverse(Ls)
    B = anchors_pos.shape[0]
    return {
        "a_d": a_d, "nrm_d": nrm_d, "b_d": b_d, "lo_d": lo_d, "hi_d": hi_d,
        "G_sd": G_sd, "G_dd": G_dd, "Ls_schur": Ls, "Sinv": Sinv, "schur_info": info,
        "Linv": Linv, "G_ssT": const("G_ssT", lambda: op.G_ss.T),
        "b_eq_s": const("b_eq_s", lambda: op.b_eq_s),
        "lo": torch.cat([const("lo_s", lambda: op.lo_s).expand(B, op.m_in_s), lo_d], dim=1),
        "hi": torch.cat([const("hi_s", lambda: op.hi_s).expand(B, op.m_in_s), hi_d], dim=1),
    }


def _split_aux(op: _SplitOperator, anchors_pos):
    """Per-solve device data: the static operator in the solve's dtype, the
    per-instance dynamic rows, their Gram blocks G_sd, G_dd, and the Schur
    complement's Cholesky factor and explicit inverse.

    anchors_pos: (B, n_anchor, d); the dtype and device of the solve.
    """
    u_d = np.asarray(op.u_d)
    aux = _goal_row_data(op, anchors_pos, lambda: op.As_diag[:, u_d],
                         lambda: op.As_rowvec[:, u_d, :], lambda: u_d[:, None] == u_d[None, :])
    dt, dev = anchors_pos.dtype, anchors_pos.device
    aux["A_extT"] = _dev(op, "A_extT", lambda: _split_reads(op)[0].T, dt, dev)
    aux["A_adj"] = _dev(op, "A_adj", lambda: _split_reads(op)[1], dt, dev)
    return aux


def _split_reads(op: _SplitOperator):
    """(A_ext, A_adj): the static rows and the dynamic rows' reads of Z
    (Z[d+u, d+u], Z[d+u, :d]) and writes to dZ (the same entries and their
    transposes), as 0/1 matrices over the flattened Z, so that apply_A and
    the adjoint are one product each with the static rows."""
    d = op.As_rowvec.shape[-1]
    s = math.isqrt(op.A_flat.shape[1])
    m_d = op.m_d
    u_d = np.asarray(op.u_d)
    k = np.arange(m_d)
    P_diag = np.zeros((m_d, s * s))
    P_diag[k, (d + u_d) * (s + 1)] = 1.0
    P_row = np.zeros((m_d, d, s * s))
    P_sym = np.zeros((m_d, d, s * s))
    for j in range(d):
        P_row[k, j, (d + u_d) * s + j] = 1.0
        P_sym[k, j, (d + u_d) * s + j] += 1.0
        P_sym[k, j, j * s + d + u_d] += 1.0
    return (np.concatenate([op.A_flat, P_diag, P_row.reshape(-1, s * s)]),
            np.concatenate([op.A_flat, P_diag, P_sym.reshape(-1, s * s)]))


def _gram_solver(aux, refine_steps: int):
    """solve_gram(r_s, r_d) -> (y_s, y_d): the full Gram system of a split
    operator, by block elimination through the Schur complement, plus
    `refine_steps` rounds of iterative refinement. aux: _goal_row_data's."""
    G_sd, G_dd, Sinv = aux["G_sd"], aux["G_dd"], aux["Sinv"]
    G_sdT = G_sd.transpose(1, 2)
    Linv, G_ssT = aux["Linv"], aux["G_ssT"]
    LinvT = Linv.T

    def gss_inv(r):  # G_ss^-1 r: two products with the shared factor
        return (r @ LinvT) @ Linv

    def gram_solve(r_s, r_d):
        z_s = gss_inv(r_s)
        y_d = _bmv(Sinv, r_d - _bmv(G_sdT, z_s))
        return gss_inv(r_s - _bmv(G_sd, y_d)), y_d

    def solve_gram(r_s, r_d):
        y_s, y_d = gram_solve(r_s, r_d)
        for _ in range(refine_steps):
            # residual of the full Gram system, then one more solve
            e_s = r_s - (y_s @ G_ssT + _bmv(G_sd, y_d))
            e_d = r_d - (_bmv(G_sdT, y_s) + _bmv(G_dd, y_d))
            dy_s, dy_d = gram_solve(e_s, e_d)
            y_s, y_d = y_s + dy_s, y_d + dy_d
        return y_s, y_d

    return solve_gram


def _split_feas(op, v_s, v_d, lo, hi):
    """Primal feasibility of a split solve's returned iterate from the raw
    constraint values (b subtracted on the equality rows only): the largest
    equality residual or bound violation."""
    feas = v_s[:, :op.m_eq_s].abs().amax(-1)
    if op.m_eq_d:
        feas = torch.maximum(feas, v_d[:, :op.m_eq_d].abs().amax(-1))
    if lo.shape[1]:
        v_in = torch.cat([v_s[:, op.m_eq_s:], v_d[:, op.m_eq_d:]], dim=1)
        vio = torch.clamp(lo - v_in, min=0.0) + torch.clamp(v_in - hi, min=0.0)
        feas = torch.maximum(feas, vio.amax(-1))
    return feas


# the per-solve data a split engine's step reads (_goal_row_data's), and
# the dense engine's products with the flattened Z
_SPLIT_CONSTS = ("a_d", "nrm_d", "b_d", "lo", "hi", "b_eq_s", "G_sd", "G_dd", "Sinv", "Linv",
                 "G_ssT")
_DENSE_SPLIT_CONSTS = _SPLIT_CONSTS + ("A_extT", "A_adj")


def _dense_split_ops(consts, op: _SplitOperator, d: int):
    """(apply_A, affine_project) of the dense split engine over its consts
    (_DENSE_SPLIT_CONSTS): Z (B, s, s), t (B, m_in)."""
    B = consts["a_d"].shape[0]
    s = math.isqrt(consts["A_extT"].shape[0])
    m_s, m_eq_s, m_in_s = op.m_s, op.m_eq_s, op.m_in_s
    m_d, m_eq_d = op.m_d, op.m_eq_d
    a_d, nrm_d = consts["a_d"], consts["nrm_d"]
    A_extT, A_adj = consts["A_extT"], consts["A_adj"]
    b_eq_s = consts["b_eq_s"].expand(B, m_eq_s)
    b_eq_d = consts["b_d"][:, :m_eq_d]

    def apply_A(Z, t):
        """Residuals r = [A(Z) - b; A_in(Z) - t], ordered [eq_s | in_s] and
        [eq_d | in_d]."""
        V = Z.reshape(B, s * s) @ A_extT
        r_s = V[:, :m_s] - torch.cat([b_eq_s, t[:, :m_in_s]], dim=1)
        row_v = V[:, m_s + m_d:].reshape(B, m_d, d)
        v_d = (V[:, m_s:m_s + m_d] - 2.0 * (a_d * row_v).sum(-1)) / nrm_d
        # b_d is 0 on the in rows, where the slack is subtracted instead
        return r_s, v_d - torch.cat([b_eq_d, t[:, m_in_s:]], dim=1)

    def adjoint(y_s, y_d):
        """dZ = sum_m y_m A_m, and the slack part +y on the in rows."""
        w = y_d / nrm_d
        coef = torch.cat([y_s, w, (-w[..., None] * a_d).reshape(B, m_d * d)], dim=1)
        dZ = (coef @ A_adj).reshape(B, s, s)
        return dZ, torch.cat([y_s[:, m_eq_s:], y_d[:, m_eq_d:]], dim=1)

    def affine_project(Z, t, solve_gram):
        y_s, y_d = solve_gram(*apply_A(Z, t))
        dZ, dt_vec = adjoint(y_s, y_d)
        return Z - dZ, t + dt_vec

    return apply_A, affine_project


def _dense_split_step(consts, params, op: _SplitOperator, d: int):
    """The dense split engine's step over its consts (and C_rho = C / rho):
    (step, running_of), the batch stopping together."""
    _, affine_project = _dense_split_ops(consts, op, d)
    solve_gram = _gram_solver(consts, params.refine_steps)
    lo, hi, C_rho = consts["lo"], consts["hi"], consts["C_rho"]
    alpha = params.relax

    def step(state, k):
        Z, t, Uz, ut = state
        Z1, t1 = affine_project(Z - Uz - C_rho, t - ut, solve_gram)
        Zr = alpha * Z1 + (1.0 - alpha) * Z
        tr_ = alpha * t1 + (1.0 - alpha) * t
        Z2, t2 = _cone_project(Zr + Uz, tr_ + ut, lo, hi, params)
        pri = torch.sqrt(rowwise_sum((Z1 - Z2) ** 2, 2) + ((t1 - t2) ** 2).sum(-1))
        return (Z2, t2, Uz + Zr - Z2, ut + tr_ - t2), pri

    return step, lambda r: r.amax() > params.admm_tol


def _solve_sdp_admm_split(op: _SplitOperator, aux, C, Z0, t0, U0, params, d: int,
                          graphs=None):
    """Batched linear-cost SDP solve over the split operator.

    aux: _split_aux's dict. Z0, C (B, s, s), t0 (B, m_in), U0 = (Uz, ut).
    The batch stops together once the largest primal residual is at most
    admm_tol; the loop runs over `graphs` (_run_admm). Returns (Z, t, (Uz,
    ut), feas), batched.
    """
    consts = {k: aux[k] for k in _DENSE_SPLIT_CONSTS}
    consts["C_rho"] = C / params.rho
    Z, t, Uz, ut = _run_admm(_dense_split_step, (_admm_params(params), op, d), consts,
                             (Z0, t0, U0[0], U0[1]), params.admm_iters,
                             graphs)

    # primal feasibility of the returned cone-feasible iterate: with t = 0,
    # apply_A gives the raw constraint values (b subtracted on eq rows only)
    v_s, v_d = _dense_split_ops(consts, op, d)[0](Z, torch.zeros_like(t))
    return Z, t, (Uz, ut), _split_feas(op, v_s, v_d, aux["lo"], aux["hi"])


def _fantope(Z, d):
    """Closed-form Fantope projection C = U_{d:} U_{d:}^T (U: all but the
    top-d eigenvectors) and the excess-rank eigenvalue sum."""
    lam, Q = _sym_eigh(Z)  # ascending
    n_small = Z.shape[-1] - d
    U = Q[..., :n_small]
    return U @ U.transpose(-1, -2), lam[..., :n_small].sum(-1)


# ---------------------------------------------------------------------------
# Joint extraction
# ---------------------------------------------------------------------------

def realign_floor_solution(ps, points, T_goal):
    """Gauge realignment of floor_mode solutions (batched).

    floor_mode lets the base slide and yaw on the floor, so a solved point
    set carries an arbitrary rigid base displacement. It is re-expressed in
    its own solved base frame: origin at the solved p0, z along q0 - p0 and
    a deterministic horizontal x (the yaw goes into the first joint angle).
    The goal poses are mapped by the same base pose.

    points: (..., N, 3) solved node positions; T_goal: (..., 4, 4), or with
    further axes (e.g. one per end effector) after the batch dims.
    Returns (points_base, T_goal_base, T_base), T_base (..., 4, 4): the
    world pose of q's FK is T_base @ fk(q).
    """
    ip0, iq0 = int(ps.idx_p(0)), int(ps.idx_q(0))
    dt, dev = points.dtype, points.device
    p0 = points[..., ip0, :]
    z = points[..., iq0, :] - p0
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev)
    r = torch.where(z[..., :1].abs() > 0.9, ey, ex)
    x = r - (r * z).sum(-1, keepdim=True) * z
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    R = torch.stack([x, y, z], dim=-1)  # columns: base axes in the world frame
    P = (points - p0[..., None, :]) @ R
    pos_fixed = compiled.device_const(ps, "pos_fixed", ps.pos_fixed, dt, dev)
    P[..., ps.idx_x, :] = pos_fixed[ps.idx_x]
    P[..., ps.idx_y, :] = pos_fixed[ps.idx_y]
    bd = points.shape[:-2]
    T_base = torch.zeros(bd + (4, 4), dtype=dt, device=dev)
    T_base[..., :3, :3] = R
    T_base[..., :3, 3] = p0
    T_base[..., 3, 3] = 1.0
    # broadcast the per-instance base pose over T_goal's extra axes
    extra = T_goal.ndim - 2 - len(bd)
    Rt = R.transpose(-1, -2).reshape(bd + (1,) * extra + (3, 3))
    p0b = p0.reshape(bd + (1,) * extra + (3,))
    Rg = T_goal[..., :3, :3].to(dt)
    tg = T_goal[..., :3, 3].to(dt)
    Tg = torch.zeros(T_goal.shape[:-2] + (4, 4), dtype=dt, device=dev)
    Tg[..., :3, :3] = Rt @ Rg
    Tg[..., :3, 3] = (Rt @ (tg - p0b)[..., None])[..., 0]
    Tg[..., 3, 3] = 1.0
    return P, Tg, T_base


def _extract_joints(ps, comp, points, T_goal):
    """joint_variables, with the floor_mode gauge fix where it applies.
    Returns (q, T_base); T_base is the identity for anchored problems."""
    if len(comp.lin_u):
        P, Tg, T_base = realign_floor_solution(ps, points, T_goal)
        return ps.joint_variables(P, Tg), T_base
    eye = torch.eye(4, dtype=points.dtype, device=points.device)
    return ps.joint_variables(points, T_goal), eye.expand(points.shape[:-2] + (4, 4)).clone()


# ---------------------------------------------------------------------------
# The convex iteration
# ---------------------------------------------------------------------------

def _rounds(params: CidgikParams, engine: str):
    """Each round's ADMM parameters: the split engine's (long, short)
    schedule - round 0 solves cold, the warm-started rounds reuse the
    primal / dual point and run admm_iters_rest - or admm_iters in every
    round of the vmap engine."""
    rest = params
    if engine == "split" and params.admm_iters_rest is not None:
        rest = dataclasses.replace(params, admm_iters=params.admm_iters_rest)
    return [params] + [rest] * (params.max_outer - 1)


def _convex_iteration(admm, fantope, rounds, Z, C, lo, hi, params: CidgikParams):
    """The rounds of the convex iteration (dense or sparse): an ADMM solve
    of min <C, Z> from the previous round's point, then the Fantope step's
    new C and excess-rank sum. A lane is done once its cost stops changing
    (abs_tol, rel_tol) or reaches abs_tol, and keeps its state from then on.

    admm(C, Z, t, U, round_params) -> (Z, t, U, feas); fantope(Z) ->
    (C, eig_sum). Returns (Z, feas, eig_sum), batched over Z's first dim.
    """
    B, dt, dev = Z.shape[0], Z.dtype, Z.device
    zdims = tuple(range(1, Z.ndim))
    t = torch.clamp(torch.zeros_like(lo), min=lo, max=hi)
    U = (torch.zeros_like(Z), torch.zeros_like(t))
    last_cost = torch.full((B,), 1e6, dtype=dt, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    feas = torch.full((B,), math.inf, dtype=dt, device=dev)
    eig_sum = torch.full((B,), math.inf, dtype=dt, device=dev)
    for r, round_params in enumerate(rounds):
        if r:
            solve_cidgik.host_reads += 1
            if bool(done.all()):  # every lane is frozen: the rest change nothing
                break
        Z_new, t_new, U_new, feas_new = admm(C, Z, t, U, round_params)
        C_new, eig_new = fantope(Z_new)
        cost = rowwise_sum(C * Z_new, len(zdims))
        change = (last_cost - cost).abs()
        rel = change / torch.clamp(last_cost.abs(), min=1e-30)
        # lanes done before this round keep their state
        go = ~done
        Z, t = _select(go, Z_new, Z), _select(go, t_new, t)
        U = (_select(go, U_new[0], U[0]), _select(go, U_new[1], U[1]))
        C = _select(go, C_new, C)
        last_cost = _select(go, cost, last_cost)
        feas = _select(go, feas_new, feas)
        eig_sum = _select(go, eig_new, eig_sum)
        done = done | (change <= params.abs_tol) | (cost <= params.abs_tol) | (rel < params.rel_tol)
    return Z, feas, eig_sum


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _on_device(x, dtype, device):
    """x as a tensor: a torch tensor stays where it is, anything else (numpy)
    goes to `device` (None: the card, which raises when there is none)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=kinematics.entry_device(device))
    return x if dtype is None else x.to(dtype)


def nearest_point_cost_matrix(comp: CidgikCompiled, targets, dtype=None):
    """Linear cost C with tr(C Z) = sum_u (G_uu - 2 p_u^T x_u): up to a
    constant, the nearest-point objective sum_u ||x_u - p_u||^2.
    targets: (..., n_free, d), cast to `dtype` when one is given."""
    targets = torch.as_tensor(targets, dtype=dtype)
    d, nf = comp.d, comp.n_free
    batch = targets.shape[:-2]
    C = torch.zeros(batch + (comp.s, comp.s), dtype=targets.dtype, device=targets.device)
    C[..., d:, d:] += torch.eye(nf, dtype=targets.dtype, device=targets.device)
    C[..., d:, :d] -= targets
    C[..., :d, d:] -= targets.transpose(-1, -2)
    return C


def solve_nearest_point_sdp(comp: CidgikCompiled, anchors_pos, targets,
                            params: CidgikParams = CidgikParams(), ranges: bool = False,
                            dtype=None, device=None):
    """Nearest-point SDP: project target points onto the constraint set.

    One linear-cost SDP (no convex iteration) minimizing
    sum_u ||x_u - p_u||^2 subject to the distance equalities and, with
    ranges=True, the bound inequalities; the vmap engine.

    anchors_pos: (..., n_anchor, d); targets: (..., n_free, d); the leading
    dims batch. Tensors stay on their device, numpy inputs go to `device`
    (None: the card). Returns dict(points (..., n_free, d), Z, feas).
    """
    anchors_pos = _on_device(anchors_pos, dtype, device)
    targets = torch.as_tensor(targets, dtype=anchors_pos.dtype, device=anchors_pos.device)
    d, s = comp.d, comp.s
    batch = anchors_pos.shape[:-2]
    B = math.prod(batch)
    anc = anchors_pos.reshape((B,) + anchors_pos.shape[-2:])
    tgt = targets.reshape((B,) + targets.shape[-2:])
    A_eq, b_eq, A_in, lo, hi = _constraint_matrices(comp, anc)
    if not ranges:
        A_in, lo, hi = A_in[:, :0], lo[:, :0], hi[:, :0]
    C = nearest_point_cost_matrix(comp, tgt)
    Z = torch.zeros((B, s, s), dtype=anc.dtype, device=anc.device)
    Z[:, :d, :d] = torch.eye(d, dtype=anc.dtype, device=anc.device)
    Z[:, d:, :d] = tgt
    Z[:, :d, d:] = tgt.transpose(1, 2)
    Z[:, d:, d:] = tgt @ tgt.transpose(1, 2)
    m_in = A_in.shape[1]
    t = _bmv(A_in.reshape(B, m_in, s * s), Z.reshape(B, s * s))
    t = torch.clamp(t, min=lo, max=hi)
    U = (torch.zeros_like(Z), torch.zeros_like(t))
    Z, _, _, feas = _solve_sdp_admm(A_eq, b_eq, A_in, lo, hi, C, Z, t, U, params,
                                    graphs=_graphs(comp))
    Z = Z.reshape(batch + (s, s))
    return {"points": Z[..., d:, :d], "Z": Z, "feas": feas.reshape(batch)}


def solve_cidgik(comp: CidgikCompiled, T_goal, params: CidgikParams = CidgikParams(),
                 dtype=None, engine: str = "split", device=None):
    """Batched CIDGIK solve.

    T_goal: (..., 4, 4) or (..., n_ee, 4, 4), the leading dims batch. A
    torch tensor runs on its own device; goals with no device (numpy) run
    on `device` (None: the card, which raises when there is none). dtype:
    None keeps the goals' dtype.

    Returns dict: q, points (all problem nodes), status, eig_sum, feas,
    T_base. T_base is the identity for anchored problems; under floor_mode
    it is the solved base pose on the floor and q is extracted in that base
    frame, so the world pose of q's FK is T_base @ fk(q).

    engine: "split" (default) or "vmap" (the per-instance oracle). On a
    card each ADMM runs through the template's loop graphs (_run_admm).

    `solve_cidgik.admm_steps` counts the ADMM iterations that every solve
    of this module has run (a stopped lane or batch still counts until the
    host reads its flag), `solve_cidgik.host_reads` the reads of the host
    (the ADMM's stop flag, and the convex iteration's once a round); set
    them to 0 to start a count.
    """
    if engine not in ("split", "vmap"):
        raise ValueError(f"unknown engine {engine!r}")
    ps = comp.structure
    T_goal = _on_device(T_goal, dtype, device)
    pos_all = ps.goal_positions(T_goal)  # (..., N, d)
    dt, dev = pos_all.dtype, pos_all.device
    d, s = comp.d, comp.s
    batch = pos_all.shape[:-2]
    B = math.prod(batch)
    anc = pos_all[..., _dev(comp, "anchor_idx", lambda: comp.anchor_idx, torch.long, dev), :]
    anc = anc.reshape(B, -1, d)
    graphs = _graphs(comp)

    Z = torch.zeros((B, s, s), dtype=dt, device=dev)
    Z[:, :d, :d] = torch.eye(d, dtype=dt, device=dev)
    C = torch.eye(s, dtype=dt, device=dev).expand(B, s, s)  # identity init

    if engine == "split":
        op = _build_split_operator(comp)
        aux = _split_aux(op, anc)
        lo, hi = aux["lo"], aux["hi"]

        def admm(C, Z, t, U, round_params):
            return _solve_sdp_admm_split(op, aux, C, Z, t, U, round_params, d, graphs)
    else:
        A_eq, b_eq, A_in, lo, hi = _constraint_matrices(comp, anc)

        def admm(C, Z, t, U, round_params):
            return _solve_sdp_admm(A_eq, b_eq, A_in, lo, hi, C, Z, t, U, round_params,
                                   graphs=graphs)

    Z, feas, eig_sum = _convex_iteration(admm, lambda Z: _fantope(Z, d),
                                         _rounds(params, engine), Z, C, lo, hi, params)

    points = pos_all.reshape(B, ps.N, d).clone()
    points[:, _dev(comp, "free_idx", lambda: comp.free_idx, torch.long, dev), :] = Z[:, d:, :d]
    status = torch.where(feas <= params.feas_tol, FEASIBLE, INFEASIBLE)
    points = points.reshape(batch + (ps.N, d))
    q, T_base = _extract_joints(ps, comp, points, T_goal)
    return {
        "q": q,
        "T_base": T_base,
        "points": points,
        "status": status.reshape(batch),
        "eig_sum": eig_sum.reshape(batch),
        "feas": feas.reshape(batch),
    }


solve_cidgik.admm_steps = 0
solve_cidgik.host_reads = 0
