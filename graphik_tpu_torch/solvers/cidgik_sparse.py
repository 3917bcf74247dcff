"""Sparse (chordal clique-decomposed) CIDGIK, batched.

Port of graphik_tpu/solvers/cidgik_sparse.py. The free-node graph (exact
and bounded edges) is chordally completed (utils/chordal.py, MCS-M) and
each maximal clique S_k gets its own small lifted PSD block

    Z_k = [[ I_d  , X_k^T ],      X_k (|S_k|, d): the clique's free nodes
           [ X_k  , G_k   ]]

with each distance constraint stamped into a clique that holds the edge and
overlap equalities tying the rows and diagonals that cliques share. All
blocks are padded to the largest clique size and stacked, (K, ds, ds) per
instance, so the cone is a product of small PSD cones. Padded rows and
columns carry no constraint and no cost; a 0/1 pad mask zeroes them before
and after every cone projection (without it the over-relaxed iteration
parks them at relax - 1, a phantom excess-rank eigenvalue).

Two ADMM engines, as in the JAX package and the dense solver
(solvers/cidgik.py, whose loop, stop flag and Gram solve they share):
* "split" (the default): the rows shared by the whole batch are flattened
  over the stacked blocks, R^{K ds^2}, and factored once on the host in
  float64; the rows that touch the goal anchors are per instance, through
  an m_d x m_d Schur complement, with their stamps materialized once per
  solve as a dense (B, m_d, K ds^2) operator (D_flat). The batch stops
  together once its largest primal residual is at most admm_tol.
* "vmap": the per-instance engine (the oracle): each instance has its own
  Gram factor and stops on its own residual; every round runs admm_iters.

Block eigendecompositions are ops/eigh.py::sym_eigh (K5 on a card) of the
symmetrised blocks. The JAX package uses fixed-sweep Jacobi there because
XLA's batched eigh returned NaN on stacks with exact-zero padded rows; K5's
Jacobi leaves an exact-zero row and column alone (never rotated, its unit
eigenvector kept), held on such stacks by the tests (on the CPU, and on the
card by tests/test_torch_cuda.py and chip_smoke.py). `eigh_sweeps` selects
nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.ops.linalg import rowwise_sum
from graphik_tpu_torch.solvers.cidgik import (
    FEASIBLE,
    INFEASIBLE,
    CidgikParams,
    _bmv,
    _cone_project,
    _admm_params,
    _convex_iteration,
    _dev,
    _extract_joints,
    _goal_anchors,
    _goal_row_data,
    _graphs,
    _gram_solver,
    _on_device,
    _rounds,
    _run_admm,
    _solve_sdp_admm,
    _split_feas,
    _sym_eigh,
)
from graphik_tpu_torch.utils.chordal import chordal_cliques


@dataclasses.dataclass(eq=False)
class CidgikSparseCompiled:
    """Static sparse CIDGIK template.

    Stamp tables describe every constraint as entries into the stacked
    block tensor (K, ds, ds); anchored coefficients are finalized per
    instance from the anchor positions.
    """

    structure: ProblemStructure
    free_idx: np.ndarray          # (n_free,) problem-node index per free slot
    anchor_idx: np.ndarray        # (n_anchor,)
    cliques: List[List[int]]      # free-slot members per clique
    member: np.ndarray            # (K, smax) free slots, -1 padding
    K: int
    smax: int

    # static constraint stamps: A_static (m_static, K, ds, ds), b (m_static,)
    A_eq_static: np.ndarray
    b_eq_static: np.ndarray
    # anchored equality edges: (m_fa,) tables
    fa_clique: np.ndarray         # clique index
    fa_row: np.ndarray            # local row (0-based within clique)
    fa_anchor: np.ndarray         # anchor slot
    fa_d2: np.ndarray             # squared edge length
    # inequality stamps
    A_in_static: np.ndarray
    in_lo: np.ndarray
    in_hi: np.ndarray
    ina_clique: np.ndarray
    ina_row: np.ndarray
    ina_anchor: np.ndarray
    ina_lo: np.ndarray
    ina_hi: np.ndarray
    # floor_mode planar rows n . x_u = c (free slots; the rows themselves
    # are stamped into A_eq_static - they are batch-static)
    lin_u: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def d(self) -> int:
        return self.structure.dim

    @property
    def ds(self) -> int:
        return self.d + self.smax

    @property
    def n_free(self) -> int:
        return len(self.free_idx)


def compile_cidgik_sparse(ps: ProblemStructure, floor_mode: bool = False) -> CidgikSparseCompiled:
    """Host-side clique decomposition and constraint stamping.

    floor_mode, as in the dense compiler: p0 and q0 are freed from
    anchoring and held on their canonical horizontal planes by linear
    equalities stamped into their host cliques.
    """
    dim = ps.dim
    sdp_nodes = [i for i in range(ps.N) if i not in (ps.idx_x, ps.idx_y)]
    anchor = sorted(i for i in sdp_nodes if ps.anchor_mask[i])
    floor_nodes = []
    if floor_mode:
        if dim != 3:
            raise ValueError("floor_mode requires a 3D problem")
        floor_nodes = [int(ps.idx_p(0)), int(ps.idx_q(0))]
        anchor = [a for a in anchor if a not in floor_nodes]
    free = [i for i in sdp_nodes if i not in set(anchor)]
    free_slot = {node: k for k, node in enumerate(free)}
    anchor_slot = {node: k for k, node in enumerate(anchor)}
    nf = len(free)

    # adjacency over free slots: exact OR bounded edges, so that every range
    # constraint has a host clique
    adj = np.zeros((nf, nf), dtype=bool)
    for a in range(ps.N):
        for b in range(a + 1, ps.N):
            if a in free_slot and b in free_slot and (ps.omega_struct[a, b] or ps.bounded_mask[a, b]):
                adj[free_slot[a], free_slot[b]] = True
                adj[free_slot[b], free_slot[a]] = True
    cliques = chordal_cliques(adj)
    K = len(cliques)
    smax = max(len(c) for c in cliques)
    ds = dim + smax
    member = -np.ones((K, smax), dtype=np.int64)
    local = [dict() for _ in range(K)]
    for k, c in enumerate(cliques):
        for j, u in enumerate(c):
            member[k, j] = u
            local[k][u] = j

    def host_clique(u, v=None):
        for k in range(K):
            if u in local[k] and (v is None or v in local[k]):
                return k
        return None

    A_eq, b_eq = [], []
    A_in, lo_l, hi_l = [], [], []
    fa_rows = []
    ina_rows = []

    # identity blocks per clique: Z_k[i, j] = delta_ij, i <= j < d
    for k in range(K):
        for i in range(dim):
            for j in range(i, dim):
                A = np.zeros((K, ds, ds))
                A[k, i, j] += 0.5
                A[k, j, i] += 0.5
                A_eq.append(A)
                b_eq.append(1.0 if i == j else 0.0)

    # floor_mode planar rows: tr(A Z_k) = n . x_u = c in the node's host
    # clique; batch-static, so both engines carry them as static rows
    lin_u = []
    if floor_nodes:
        pos_fixed = np.asarray(ps.pos_fixed, np.float64)
        n_vec = np.zeros(dim)
        n_vec[-1] = 1.0
        for node in floor_nodes:
            u = free_slot[node]
            k = host_clique(u)
            r = dim + local[k][u]
            A = np.zeros((K, ds, ds))
            A[k, r, :dim] += 0.5 * n_vec
            A[k, :dim, r] += 0.5 * n_vec
            A_eq.append(A)
            b_eq.append(float(n_vec @ pos_fixed[node, :dim]))
            lin_u.append(u)

    # overlap equalities: for every free slot in more than one clique, chain
    # consecutive host cliques - the X rows (d scalars) and the G diagonal;
    # for pairs shared by cliques, the G off-diagonal too
    hosts = [[k for k in range(K) if u in local[k]] for u in range(nf)]
    for u in range(nf):
        hs = hosts[u]
        for k1, k2 in zip(hs[:-1], hs[1:]):
            r1 = dim + local[k1][u]
            r2 = dim + local[k2][u]
            for i in range(dim):  # X^k1_u = X^k2_u
                A = np.zeros((K, ds, ds))
                A[k1, r1, i] += 0.5
                A[k1, i, r1] += 0.5
                A[k2, r2, i] -= 0.5
                A[k2, i, r2] -= 0.5
                A_eq.append(A)
                b_eq.append(0.0)
            A = np.zeros((K, ds, ds))  # G^k1_uu = G^k2_uu
            A[k1, r1, r1] += 1.0
            A[k2, r2, r2] -= 1.0
            A_eq.append(A)
            b_eq.append(0.0)
    for u in range(nf):
        for v in range(u + 1, nf):
            shared = [k for k in range(K) if u in local[k] and v in local[k]]
            for k1, k2 in zip(shared[:-1], shared[1:]):
                A = np.zeros((K, ds, ds))
                ru1, rv1 = dim + local[k1][u], dim + local[k1][v]
                ru2, rv2 = dim + local[k2][u], dim + local[k2][v]
                A[k1, ru1, rv1] += 0.5
                A[k1, rv1, ru1] += 0.5
                A[k2, ru2, rv2] -= 0.5
                A[k2, rv2, ru2] -= 0.5
                A_eq.append(A)
                b_eq.append(0.0)

    def edge_stamp(k, u, v):
        """||x_u - x_v||^2 inside clique k."""
        A = np.zeros((K, ds, ds))
        ru, rv = dim + local[k][u], dim + local[k][v]
        A[k, ru, ru] += 1.0
        A[k, rv, rv] += 1.0
        A[k, ru, rv] -= 1.0
        A[k, rv, ru] -= 1.0
        return A

    for a in range(ps.N):
        for b in range(a + 1, ps.N):
            in_f_a, in_f_b = a in free_slot, b in free_slot
            if not ((in_f_a or a in anchor_slot) and (in_f_b or b in anchor_slot)):
                continue
            if not in_f_a and not in_f_b:
                continue  # anchor-anchor: constant
            if ps.omega_struct[a, b]:
                d2 = float(ps.D_struct[a, b])
                if in_f_a and in_f_b:
                    u, v = free_slot[a], free_slot[b]
                    A_eq.append(edge_stamp(host_clique(u, v), u, v))
                    b_eq.append(d2)
                else:
                    f, anc = (a, b) if in_f_a else (b, a)
                    u = free_slot[f]
                    k = host_clique(u)
                    fa_rows.append((k, local[k][u], anchor_slot[anc], d2))
            elif ps.bounded_mask[a, b]:
                lo = float(ps.check_L[a, b]) ** 2
                hi = float(ps.check_U[a, b]) ** 2
                if in_f_a and in_f_b:
                    u, v = free_slot[a], free_slot[b]
                    A_in.append(edge_stamp(host_clique(u, v), u, v))
                    lo_l.append(lo)
                    hi_l.append(hi)
                else:
                    f, anc = (a, b) if in_f_a else (b, a)
                    u = free_slot[f]
                    k = host_clique(u)
                    ina_rows.append((k, local[k][u], anchor_slot[anc], lo, hi))

    def stack(lst):
        return np.stack(lst) if lst else np.zeros((0, K, ds, ds))

    fa = np.asarray(fa_rows, dtype=float).reshape(len(fa_rows), 4) if fa_rows else np.zeros((0, 4))
    ina = np.asarray(ina_rows, dtype=float).reshape(len(ina_rows), 5) if ina_rows else np.zeros((0, 5))

    return CidgikSparseCompiled(
        structure=ps,
        free_idx=np.asarray(free, dtype=np.int64),
        anchor_idx=np.asarray(anchor, dtype=np.int64),
        cliques=cliques,
        member=member,
        K=K,
        smax=smax,
        A_eq_static=stack(A_eq),
        b_eq_static=np.asarray(b_eq, dtype=float),
        fa_clique=fa[:, 0].astype(np.int64),
        fa_row=fa[:, 1].astype(np.int64),
        fa_anchor=fa[:, 2].astype(np.int64),
        fa_d2=fa[:, 3],
        A_in_static=stack(A_in),
        in_lo=np.asarray(lo_l, dtype=float),
        in_hi=np.asarray(hi_l, dtype=float),
        ina_clique=ina[:, 0].astype(np.int64),
        ina_row=ina[:, 1].astype(np.int64),
        ina_anchor=ina[:, 2].astype(np.int64),
        ina_lo=ina[:, 3],
        ina_hi=ina[:, 4],
        lin_u=np.asarray(lin_u, dtype=np.int64),
    )


# ---------------------------------------------------------------------------
# Per-instance constraint tensors (the vmap engine)
# ---------------------------------------------------------------------------

def _anchored_stamps(comp: CidgikSparseCompiled, cl, row, anc, anchors_pos):
    """(..., m, K, ds, ds) coefficients of anchored edges, G_uu - 2 a^T x_u,
    and ||a||^2 (..., m); anchors_pos (..., n_anchor, d)."""
    m = len(cl)
    K, ds, d = comp.K, comp.ds, comp.d
    batch = anchors_pos.shape[:-2]
    dt, dev = anchors_pos.dtype, anchors_pos.device
    A = torch.zeros(batch + (m, K, ds, ds), dtype=dt, device=dev)
    if m == 0:
        return A, torch.zeros(batch + (0,), dtype=dt, device=dev)
    def idx(name, x):
        x = np.asarray(x, np.int64)
        return _dev(comp, (name, x.tobytes()), lambda: x, torch.long, dev)

    r = idx("stamp_rows", np.asarray(row) + d)
    k = idx("stamp_cliques", cl)
    a_pos = anchors_pos[..., idx("stamp_anchors", anc), :]  # (..., m, d)
    mi = torch.arange(m, device=dev)
    j = torch.arange(d, device=dev)
    A[..., mi, k, r, r] = 1.0
    A[..., mi[:, None], k[:, None], r[:, None], j[None, :]] = -a_pos
    A[..., mi[:, None], k[:, None], j[None, :], r[:, None]] = -a_pos
    return A, (a_pos * a_pos).sum(-1)


def _constraint_tensors(comp: CidgikSparseCompiled, anchors_pos):
    """The row-normalized constraint tensors of each instance:
    (A_eq (..., m_eq, K, ds, ds), b_eq, A_in (..., m_in, K, ds, ds), lo, hi)
    in anchors_pos's dtype and device; anchors_pos (..., n_anchor, d)."""
    batch = anchors_pos.shape[:-2]
    dt, dev = anchors_pos.dtype, anchors_pos.device

    def const(name):
        x = _dev(comp, name, lambda: getattr(comp, name), dt, dev)
        return x.expand(batch + x.shape)

    A_fa, a2 = _anchored_stamps(comp, comp.fa_clique, comp.fa_row, comp.fa_anchor, anchors_pos)
    A_eq = torch.cat([const("A_eq_static"), A_fa], dim=-4)
    b_eq = torch.cat([const("b_eq_static"), const("fa_d2") - a2], dim=-1)
    A_ina, a2i = _anchored_stamps(comp, comp.ina_clique, comp.ina_row, comp.ina_anchor,
                                  anchors_pos)
    A_in = torch.cat([const("A_in_static"), A_ina], dim=-4)
    lo = torch.cat([const("in_lo"), const("ina_lo") - a2i], dim=-1)
    hi = torch.cat([const("in_hi"), const("ina_hi") - a2i], dim=-1)

    def rownorm(A):
        return torch.sqrt(torch.clamp(rowwise_sum(A * A, 3), min=1e-12))

    n_eq = rownorm(A_eq)
    A_eq, b_eq = A_eq / n_eq[..., None, None, None], b_eq / n_eq
    if A_in.shape[-4]:
        n_in = rownorm(A_in)
        A_in, lo, hi = A_in / n_in[..., None, None, None], lo / n_in, hi / n_in
    return A_eq, b_eq, A_in, lo, hi


def _solve_sdp_admm_blocks(A_eq, b_eq, A_in, lo, hi, C, Z0, t0, U0, params, pad_mask=None,
                           graphs=None):
    """The per-lane engine over the product of the clique cones: the dense
    vmap engine (cidgik._solve_sdp_admm) on stacked blocks, batched over
    lanes (A_eq (B, m_eq, K, ds, ds), Z0 (B, K, ds, ds), ...), each lane
    stopping on its own residual. pad_mask (K, ds, ds) zeroes the padded
    rows and columns before and after each cone projection. The JAX
    package's sparse engine has no rho adaptation, so adapt_every is
    ignored. The loop runs over `graphs`. Returns (Z, t, (Uz, ut), feas)."""
    params = dataclasses.replace(params, adapt_every=0)
    return _solve_sdp_admm(A_eq, b_eq, A_in, lo, hi, C, Z0, t0, U0, params, pad_mask=pad_mask,
                           graphs=graphs)


def _fantope_blocks(Z, d, member, diag_valid=None):
    """Per-clique Fantope projection and the excess-rank eigenvalue sum, for
    both engines (the JAX package's _fantope_blocks and
    _fantope_blocks_batched).

    Z: (..., K, ds, ds). Pad-safe: within each block's valid subspace the
    rank-d-complement projector is C_k = diag(valid_k) - U_d U_d^T, U_d the
    top-d eigenvectors (the last d columns of the ascending eigh; the I_d
    corner keeps them in the valid subspace), so padded rows receive no
    cost. eig_sum = sum_k (tr Z_k - the top-d eigenvalues). diag_valid:
    `_valid_slots(member, d)` on Z's device and in its dtype, when the
    caller holds it (a copy from the host synchronises). Returns
    (C (..., K, ds, ds), eig_sum (...)).
    """
    lam, Q = _sym_eigh(Z)
    ds = Z.shape[-1]
    top = Q[..., ds - d:]
    if diag_valid is None:
        diag_valid = torch.as_tensor(_valid_slots(member, d), dtype=Z.dtype, device=Z.device)
    C = torch.diag_embed(diag_valid) - top @ top.transpose(-1, -2)
    eig_sum = rowwise_sum(lam, 2) - rowwise_sum(lam[..., ds - d:], 2)
    return C, eig_sum


def lifted_blocks(comp: CidgikSparseCompiled, pos_free):
    """The stacked clique blocks of free-node positions pos_free
    (..., n_free, d): Z_k = [[I_d, X_k^T], [X_k, X_k X_k^T]], X_k the
    clique's rows, zero on the padded slots. Returns (..., K, ds, ds)."""
    d = comp.d
    batch = pos_free.shape[:-2]
    Z = torch.zeros(batch + (comp.K, comp.ds, comp.ds), dtype=pos_free.dtype,
                    device=pos_free.device)
    for k, c in enumerate(comp.cliques):
        X = pos_free[..., c, :]
        n = len(c)
        Z[..., k, :d, :d] = torch.eye(d, dtype=pos_free.dtype, device=pos_free.device)
        Z[..., k, d:d + n, :d] = X
        Z[..., k, :d, d:d + n] = X.transpose(-1, -2)
        Z[..., k, d:d + n, d:d + n] = X @ X.transpose(-1, -2)
    return Z


def _valid_slots(member, d):
    """(K, ds) 0/1: the d identity rows and each clique's member rows."""
    return np.concatenate([np.ones((len(member), d)), (np.asarray(member) >= 0)], axis=1)


# ---------------------------------------------------------------------------
# Split (static / dynamic) batched sparse ADMM engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class _SparseSplitOperator:
    """Host-side (numpy, float64) static data of the split sparse ADMM."""

    # static rows, ordered [eq_s | in_s], row-normalized, flattened over the
    # stacked clique blocks
    A_flat: np.ndarray  # (m_s, K*ds*ds)
    b_eq_s: np.ndarray  # (m_eq_s,)
    lo_s: np.ndarray  # (m_in_s,)
    hi_s: np.ndarray
    G_ss: np.ndarray  # (m_s, m_s) static Gram (+ slack identity on in rows)
    Linv_ss: np.ndarray  # G_ss^-1 = Linv^T Linv
    # static-row coefficients at each dynamic row's stamp location
    As_diag: np.ndarray  # (m_s, m_d): A_i[k_j, d+r_j, d+r_j]
    As_rowvec: np.ndarray  # (m_s, m_d, d): A_i[k_j, d+r_j, :d]
    # dynamic rows, ordered [eq_d | in_d] (raw; normalized per instance)
    k_d: np.ndarray  # (m_d,) host clique
    r_d: np.ndarray  # (m_d,) local row within the clique
    g_d: np.ndarray  # (m_d,) goal-anchor slots
    d2_d: np.ndarray  # (m_d,) squared edge length (eq rows; 0 on in rows)
    lo_d: np.ndarray  # (m_d,) raw bounds (in rows; 0 on eq rows)
    hi_d: np.ndarray
    m_eq_d: int
    m_in_d: int
    K_ds: tuple = (0, 0)  # (K, ds) block geometry of the flattened space

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
        return len(self.k_d)


def _build_sparse_split_operator(comp: CidgikSparseCompiled) -> _SparseSplitOperator:
    """Assemble the static / dynamic split, cached on the compiled problem."""
    cached = getattr(comp, "_split_op", None)
    if cached is not None:
        return cached
    ps = comp.structure
    d = comp.d
    K, ds = comp.K, comp.ds
    goal_anchor = _goal_anchors(ps)
    anchor_is_goal = np.asarray([int(n) in goal_anchor for n in comp.anchor_idx])
    anc_pos = np.asarray(ps.pos_fixed, np.float64)[comp.anchor_idx]  # valid off the goals

    def fa_stamp(k, r, a):
        """G_uu - 2 a^T x_u inside clique k, local row r."""
        A = np.zeros((K, ds, ds))
        A[k, d + r, d + r] = 1.0
        A[k, d + r, :d] = -a
        A[k, :d, d + r] = -a
        return A

    eq_mats = list(comp.A_eq_static)
    eq_b = list(comp.b_eq_static)
    dyn = []  # (k, r, g, d2, lo, hi, is_eq)
    for i in range(len(comp.fa_clique)):
        k, r, g = int(comp.fa_clique[i]), int(comp.fa_row[i]), int(comp.fa_anchor[i])
        if anchor_is_goal[g]:
            dyn.append((k, r, g, float(comp.fa_d2[i]), 0.0, 0.0, True))
        else:
            a = anc_pos[g, :d]
            eq_mats.append(fa_stamp(k, r, a))
            eq_b.append(float(comp.fa_d2[i]) - a @ a)

    in_mats = list(comp.A_in_static)
    in_lo = list(comp.in_lo)
    in_hi = list(comp.in_hi)
    for i in range(len(comp.ina_clique)):
        k, r, g = int(comp.ina_clique[i]), int(comp.ina_row[i]), int(comp.ina_anchor[i])
        if anchor_is_goal[g]:
            dyn.append((k, r, g, 0.0, float(comp.ina_lo[i]), float(comp.ina_hi[i]), False))
        else:
            a = anc_pos[g, :d]
            in_mats.append(fa_stamp(k, r, a))
            in_lo.append(float(comp.ina_lo[i]) - a @ a)
            in_hi.append(float(comp.ina_hi[i]) - a @ a)

    A_s = np.stack(eq_mats + in_mats)  # (m_s, K, ds, ds)
    m_eq_s, m_in_s = len(eq_mats), len(in_mats)
    nrm = np.sqrt(np.maximum((A_s**2).sum(axis=(1, 2, 3)), 1e-12))
    A_s = A_s / nrm[:, None, None, None]
    b_eq_s = np.asarray(eq_b) / nrm[:m_eq_s]
    lo_s = np.asarray(in_lo) / nrm[m_eq_s:] if m_in_s else np.zeros(0)
    hi_s = np.asarray(in_hi) / nrm[m_eq_s:] if m_in_s else np.zeros(0)

    A_flat = A_s.reshape(len(A_s), K * ds * ds)
    G_ss = A_flat @ A_flat.T
    if m_in_s:
        G_ss[m_eq_s:, m_eq_s:] += np.eye(m_in_s)
    G_ss += 1e-9 * np.trace(G_ss) / len(G_ss) * np.eye(len(G_ss))
    Linv_ss = np.linalg.inv(np.linalg.cholesky(G_ss))

    dyn_eq = [t for t in dyn if t[6]]
    dyn_in = [t for t in dyn if not t[6]]
    dyn = dyn_eq + dyn_in
    k_d = np.asarray([t[0] for t in dyn], np.int64)
    r_d = np.asarray([t[1] for t in dyn], np.int64)
    op = _SparseSplitOperator(
        A_flat=A_flat, b_eq_s=b_eq_s, lo_s=lo_s, hi_s=hi_s, G_ss=G_ss, Linv_ss=Linv_ss,
        As_diag=A_s[:, k_d, d + r_d, d + r_d], As_rowvec=A_s[:, k_d, d + r_d, :d],
        k_d=k_d, r_d=r_d,
        g_d=np.asarray([t[2] for t in dyn], np.int64),
        d2_d=np.asarray([t[3] for t in dyn], np.float64),
        lo_d=np.asarray([t[4] for t in dyn], np.float64),
        hi_d=np.asarray([t[5] for t in dyn], np.float64),
        m_eq_d=len(dyn_eq), m_in_d=len(dyn_in), K_ds=(K, ds),
    )
    comp._split_op = op
    return op


def _sparse_split_aux(op: _SparseSplitOperator, anchors_pos):
    """Per-solve device data: the goal rows, their Gram blocks G_sd, G_dd,
    the Schur complement's Cholesky factor (schur_info: lanes where it
    failed) and explicit inverse (cidgik._goal_row_data), and D_flat
    (B, m_d, K*ds*ds), the goal rows' row-normalized stamps (unit diagonal
    at (k_j, d+r_j) and the -a row and column copies), materialized once so
    that the loop's reads and writes of them are products.

    anchors_pos: (B, n_anchor, d); the dtype and device of the solve.
    """
    aux = _goal_row_data(op, anchors_pos, lambda: op.As_diag, lambda: op.As_rowvec,
                         lambda: ((op.k_d[:, None] == op.k_d[None, :])
                                  & (op.r_d[:, None] == op.r_d[None, :])))
    dt, dev = anchors_pos.dtype, anchors_pos.device
    B, m_d = anchors_pos.shape[0], op.m_d
    d = op.As_rowvec.shape[-1]
    K, ds = op.K_ds
    k_d = _dev(op, "k_d", lambda: op.k_d, torch.long, dev)
    r = _dev(op, "r_d", lambda: op.r_d + d, torch.long, dev)
    mi = torch.arange(m_d, device=dev)
    j = torch.arange(d, device=dev)
    a_d = aux["a_d"]
    D = torch.zeros((B, m_d, K, ds, ds), dtype=dt, device=dev)
    D[:, mi, k_d, r, r] = 1.0
    D[:, mi[:, None], k_d[:, None], r[:, None], j[None, :]] = -a_d
    D[:, mi[:, None], k_d[:, None], j[None, :], r[:, None]] = -a_d
    aux["D_flat"] = (D / aux["nrm_d"][:, :, None, None, None]).reshape(B, m_d, K * ds * ds)
    aux["A_flat"] = _dev(op, "A_flat", lambda: op.A_flat, dt, dev)
    return aux


_SPARSE_SPLIT_CONSTS = ("a_d", "nrm_d", "b_d", "lo", "hi", "b_eq_s", "G_sd", "G_dd", "Sinv",
                        "Linv", "G_ssT", "A_flat", "D_flat")


def _sparse_split_ops(consts, op: _SparseSplitOperator):
    """(apply_A, affine_project) of the sparse split engine over its consts
    (_SPARSE_SPLIT_CONSTS): the flattened Z (B, K*ds*ds), t (B, m_in)."""
    B = consts["a_d"].shape[0]
    m_eq_s, m_in_s, m_eq_d = op.m_eq_s, op.m_in_s, op.m_eq_d
    A_flat, D_flat = consts["A_flat"], consts["D_flat"]
    A_flatT = A_flat.T
    b_eq_s = consts["b_eq_s"].expand(B, m_eq_s)
    b_eq_d = consts["b_d"][:, :m_eq_d]

    def apply_A(Zf, t):
        """Residuals r = [A(Z) - b; A_in(Z) - t] of the flattened Z, ordered
        [eq_s | in_s] and [eq_d | in_d]."""
        r_s = Zf @ A_flatT - torch.cat([b_eq_s, t[:, :m_in_s]], dim=1)
        # b_d is 0 on the in rows, where the slack is subtracted instead
        r_d = _bmv(D_flat, Zf) - torch.cat([b_eq_d, t[:, m_in_s:]], dim=1)
        return r_s, r_d

    def affine_project(Zf, t, solve_gram):
        y_s, y_d = solve_gram(*apply_A(Zf, t))
        dZ = y_s @ A_flat + (y_d[:, None, :] @ D_flat)[:, 0]
        return Zf - dZ, t + torch.cat([y_s[:, m_eq_s:], y_d[:, m_eq_d:]], dim=1)

    return apply_A, affine_project


def _sparse_split_step(consts, params, op: _SparseSplitOperator, shape):
    """The sparse split engine's step over its consts (and Cf_rho, the
    flattened C / rho, and pad_mask): (step, running_of), the batch
    stopping together; shape: the stacked blocks' (B, K, ds, ds)."""
    _, affine_project = _sparse_split_ops(consts, op)
    solve_gram = _gram_solver(consts, params.refine_steps)
    lo, hi, Cf_rho, pad_mask = consts["lo"], consts["hi"], consts["Cf_rho"], consts["pad_mask"]
    B = shape[0]
    alpha = params.relax

    def step(state, k):
        Zf, t, Uz, ut = state
        Z1, t1 = affine_project(Zf - Uz - Cf_rho, t - ut, solve_gram)
        Zr = alpha * Z1 + (1.0 - alpha) * Zf
        tr_ = alpha * t1 + (1.0 - alpha) * t
        W2, t2 = _cone_project((Zr + Uz).reshape(shape), tr_ + ut, lo, hi, params, pad_mask)
        Z2 = W2.reshape(B, -1)
        pri = torch.sqrt(rowwise_sum(((Z1 - Z2) ** 2).reshape(shape), 3)
                         + ((t1 - t2) ** 2).sum(-1))
        return (Z2, t2, Uz + Zr - Z2, ut + tr_ - t2), pri

    return step, lambda r: r.amax() > params.admm_tol


def _solve_sdp_admm_sparse_split(op: _SparseSplitOperator, aux, C, Z0, t0, U0, params,
                                 pad_mask, graphs=None):
    """Batched linear-cost SDP solve over the split sparse operator.

    aux: _sparse_split_aux's dict. Z0, C (B, K, ds, ds), t0 (B, m_in),
    U0 = (Uz, ut), pad_mask (K, ds, ds). The batch stops together once its
    largest primal residual is at most admm_tol; the loop runs over
    `graphs` (cidgik._run_admm). Returns (Z, t, (Uz, ut), feas), batched.
    """
    B = Z0.shape[0]
    shape = tuple(Z0.shape)
    consts = {k: aux[k] for k in _SPARSE_SPLIT_CONSTS}
    consts.update(Cf_rho=C.reshape(B, -1) / params.rho, pad_mask=pad_mask)
    Zf, t, Uz, ut = _run_admm(_sparse_split_step, (_admm_params(params), op, shape), consts,
                              (Z0.reshape(B, -1), t0, U0[0].reshape(B, -1), U0[1]),
                              params.admm_iters, graphs)

    # primal feasibility of the returned cone-feasible iterate: with t = 0,
    # apply_A gives the raw constraint values (b subtracted on eq rows only)
    v_s, v_d = _sparse_split_ops(consts, op)[0](Zf, torch.zeros_like(t))
    return (Zf.reshape(shape), t, (Uz.reshape(shape), ut),
            _split_feas(op, v_s, v_d, aux["lo"], aux["hi"]))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def solve_cidgik_sparse(comp: CidgikSparseCompiled, T_goal,
                        params: CidgikParams = CidgikParams(), dtype=None,
                        engine: str = "split", device=None):
    """Batched sparse CIDGIK solve.

    T_goal: (..., 4, 4) or (..., n_ee, 4, 4), the leading dims batch. A
    torch tensor runs on its own device; goals with no device (numpy) run
    on `device` (None: the card, which raises when there is none). dtype:
    None keeps the goals' dtype.

    Returns dict: q, points (all problem nodes; a free node shared by
    several cliques is the mean of its rows), status, eig_sum, feas,
    T_base. T_base is the identity for anchored problems; under floor_mode
    it is the solved base pose on the floor and q is extracted in that base
    frame, so the world pose of q's FK is T_base @ fk(q).

    engine: "split" (default; the (admm_iters, admm_iters_rest) schedule)
    or "vmap" (the per-instance oracle; admm_iters every round). Its ADMM
    steps count in `cidgik.solve_cidgik.admm_steps`.
    """
    if engine not in ("split", "vmap"):
        raise ValueError(f"unknown engine {engine!r}")
    ps = comp.structure
    T_goal = _on_device(T_goal, dtype, device)
    pos_all = ps.goal_positions(T_goal)  # (..., N, d)
    dt, dev = pos_all.dtype, pos_all.device
    d, K, ds = comp.d, comp.K, comp.ds
    batch = pos_all.shape[:-2]
    B = math.prod(batch)
    anc = pos_all[..., _dev(comp, "anchor_idx", lambda: comp.anchor_idx, torch.long, dev), :]
    anc = anc.reshape(B, -1, d)
    graphs = _graphs(comp)

    valid = _valid_slots(comp.member, d)
    pad_mask = _dev(comp, "pad_mask", lambda: valid[:, :, None] * valid[:, None, :], dt, dev)
    Z = torch.zeros((B, K, ds, ds), dtype=dt, device=dev)
    Z[:, :, :d, :d] = torch.eye(d, dtype=dt, device=dev)
    # the initial rank-forcing cost: the identity on the valid slots only, so
    # that no dual charge builds up against padded coordinates
    diag_valid = _dev(comp, "valid_slots", lambda: valid, dt, dev)
    C = torch.diag_embed(diag_valid).expand(B, K, ds, ds)

    if engine == "split":
        op = _build_sparse_split_operator(comp)
        aux = _sparse_split_aux(op, anc)
        lo, hi = aux["lo"], aux["hi"]

        def admm(C, Z, t, U, round_params):
            return _solve_sdp_admm_sparse_split(op, aux, C, Z, t, U, round_params, pad_mask,
                                                graphs)
    else:
        A_eq, b_eq, A_in, lo, hi = _constraint_tensors(comp, anc)

        def admm(C, Z, t, U, round_params):
            return _solve_sdp_admm_blocks(A_eq, b_eq, A_in, lo, hi, C, Z, t, U, round_params,
                                          pad_mask=pad_mask, graphs=graphs)

    Z, feas, eig_sum = _convex_iteration(admm, lambda Z: _fantope_blocks(Z, d, comp.member,
                                                                         diag_valid),
                                         _rounds(params, engine), Z, C, lo, hi, params)

    # free positions: the mean of each node's rows over its cliques
    X = torch.zeros((B, comp.n_free, d), dtype=dt, device=dev)
    for k, c in enumerate(comp.cliques):
        X[:, c] += Z[:, k, d:d + len(c), :d]
    count = np.bincount(np.concatenate(comp.cliques), minlength=comp.n_free)
    X = X / _dev(comp, "clique_count", lambda: count, dt, dev)[:, None]
    points = pos_all.reshape(B, ps.N, d).clone()
    points[:, _dev(comp, "free_idx", lambda: comp.free_idx, torch.long, dev), :] = X
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
