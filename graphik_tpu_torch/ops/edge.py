"""Edge-list (incidence) formulation of the EDM-completion cost.

Port of graphik_tpu/ops/edge.py: the active edge set of a template is
compiled once, host-side, into numpy arrays (`EdgeProblem`), and the cost,
gradient, Hessian-vector product and residual are plain torch functions
over that form. They are the reference math for the TR kernel
(ops/tr_solve.py) and the parity oracle against the JAX package.

    diff  = C Y            (E, d)   edge difference vectors
    dist  = ||diff||^2     (E,)     squared edge lengths
    grad  = -2 C^T (s * diff)       scatter-add as a matmul

`cost_and_egrad_cuda` and `ehess_cuda` wrap the hand-written CUDA kernels
csrc/edge.cu (K1, K2; the template csrc/edge_kernel.cuh, the instances past
32 nodes or 128 edges in csrc/edge_wide.cu), the counterparts of the JAX
package's per-op Pallas kernels (cost_and_egrad_pallas, ehess_pallas). Their exact plain versions
are `cost_and_egrad_kernel_order` and `ehess_kernel_order`, which sum in
the kernels' order; `cost_and_egrad` and `ehess` compute the same in
torch's own. No solve path calls the kernels: the TR kernel fuses the same
math.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections import Counter

import numpy as np
import torch

from graphik_tpu_torch.ops.linalg import rowwise_sum
from graphik_tpu_torch.solvers.costs import make_masks
from graphik_tpu_torch.utils.compiled import cached, device_const

_SUBLANE = 8  # edge and anchor-block counts pad to a multiple of this

# Shapes the build of K1 / K2 covers (csrc/edge_kernel.cuh kEdgeMaxN /
# kEdgeMaxE: two node slots a lane past 32 nodes, up to 8 edges a lane at
# W = 32; the TR kernel takes more, ops/tr_solve.py MAX_N / MAX_E). Goal
# distances are read at a stride of at most MAX_E.
MAX_N = 64
MAX_E = 256


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeProblem:
    """Static compiled edge set for one (robot, environment) template.

    Arrays are host numpy, the same layout as the JAX package's:
      ei, ej        (E,) int32 upper-triangular edge endpoints
      C             (Ep, N) signed incidence (+1 at ei, -1 at ej), zero-padded
      omega, psi_L, psi_U, L_mask, U_mask   (Ep,) per-edge parameters

    Anchored hinge terms (node vs constant point - the obstacle reduction):
    zero-length arrays when absent. Rows are grouped node-major: group g
    holds the a_R rows of distinct node g, so Ap = a_nsel * a_R; aPsel is
    the (pad8(a_nsel), N) distinct-node one-hot.
      aP                       (Ap, N) one-hot node selection
      acenters                 (Ap, dim) constant anchor points
      apsi_L, apsi_U, aL_mask, aU_mask  (Ap,) squared hinge bounds/masks
    """

    ei: np.ndarray
    ej: np.ndarray
    C: np.ndarray
    omega: np.ndarray
    psi_L: np.ndarray
    psi_U: np.ndarray
    L_mask: np.ndarray
    U_mask: np.ndarray
    N: int
    dim: int
    aP: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0)))
    acenters: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    apsi_L: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    apsi_U: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    aL_mask: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    aU_mask: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    a_nsel: int = 0
    a_R: int = 0
    aPsel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0)))

    @property
    def E(self) -> int:
        return len(self.ei)

    @property
    def Ep(self) -> int:
        return self.C.shape[0]

    @property
    def A(self) -> int:
        return self.aP.shape[0]

    def edge_values(self, M):
        """Gather per-edge values from a dense (..., N, N) tensor, padded."""
        ei = device_const(self, "ei", self.ei, torch.long, M.device)
        ej = device_const(self, "ej", self.ej, torch.long, M.device)
        vals = M[..., ei, ej]
        pad = self.Ep - self.E
        if pad:
            vals = torch.nn.functional.pad(vals, (0, pad))
        return vals


def build_edge_problem(omega, psi_L, psi_U, L_mask=None, U_mask=None,
                       dim: int = 3, anchors=None) -> EdgeProblem:
    """Compile dense (N, N) masks into the padded edge/incidence form.

    Keeps every unordered pair where the equality or either hinge term is
    active.
    """
    omega = np.asarray(omega, np.float64)
    N = omega.shape[-1]
    default_L, default_U = make_masks(omega, psi_L, psi_U)
    L_mask = default_L if L_mask is None else L_mask
    U_mask = default_U if U_mask is None else U_mask
    active = (omega != 0) | (np.asarray(L_mask) != 0) | (np.asarray(U_mask) != 0)
    iu = np.triu_indices(N, k=1)
    keep = active[iu]
    ei = iu[0][keep].astype(np.int32)
    ej = iu[1][keep].astype(np.int32)
    E = len(ei)
    Ep = max(_SUBLANE, -(-E // _SUBLANE) * _SUBLANE)

    C = np.zeros((Ep, N), np.float64)
    C[np.arange(E), ei] = 1.0
    C[np.arange(E), ej] = -1.0

    def sel(M):
        out = np.zeros(Ep, np.float64)
        out[:E] = np.asarray(M, np.float64)[ei, ej]
        return out

    akw = {}
    if anchors is not None and len(anchors["idx"]):
        idx = np.asarray(anchors["idx"], np.int64)
        centers = np.asarray(anchors["centers"], np.float64)[:, :dim]
        vals = {k: np.asarray(anchors[k], np.float64)
                for k in ("psi_L", "psi_U", "L_mask", "U_mask")}

        # Node-major grid: one padded row-block per distinct anchored node.
        sel_nodes = np.unique(idx)
        n_sel = len(sel_nodes)
        max_cnt = max(int((idx == u).sum()) for u in sel_nodes)
        R = max(_SUBLANE, -(-max_cnt // _SUBLANE) * _SUBLANE)
        Ap = n_sel * R
        P = np.zeros((Ap, N), np.float64)
        cen = np.zeros((Ap, dim), np.float64)
        pads = {k: np.zeros(Ap, np.float64) for k in vals}
        for g, u in enumerate(sel_nodes):
            rows = np.nonzero(idx == u)[0]
            dst = g * R + np.arange(len(rows))
            P[dst, u] = 1.0
            cen[dst] = centers[rows]
            for k in vals:
                pads[k][dst] = vals[k][rows]
        n_sel_p = max(_SUBLANE, -(-n_sel // _SUBLANE) * _SUBLANE)
        Psel = np.zeros((n_sel_p, N), np.float64)
        Psel[np.arange(n_sel), sel_nodes] = 1.0

        akw = dict(
            aP=P, acenters=cen,
            apsi_L=pads["psi_L"], apsi_U=pads["psi_U"],
            aL_mask=pads["L_mask"], aU_mask=pads["U_mask"],
            a_nsel=n_sel, a_R=R, aPsel=Psel,
        )

    return EdgeProblem(
        ei=ei, ej=ej, C=C,
        omega=sel(omega), psi_L=sel(psi_L), psi_U=sel(psi_U),
        L_mask=sel(L_mask), U_mask=sel(U_mask), N=N, dim=dim, **akw,
    )


# ---------------------------------------------------------------------------
# Plain torch functions over the edge form (any dtype and device)
# ---------------------------------------------------------------------------

def _t(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _edge_terms(ep: EdgeProblem, Y, dgoal_e):
    diff = torch.einsum("en,...nd->...ed", _t(ep.C, Y), Y)
    dist = (diff * diff).sum(dim=-1)
    s0 = _t(ep.omega, Y) * (dgoal_e - dist)
    e1 = _t(ep.L_mask, Y) * torch.clamp(_t(ep.psi_L, Y) - dist, min=0.0)
    e2 = _t(ep.U_mask, Y) * torch.clamp(dist - _t(ep.psi_U, Y), min=0.0)
    return diff, dist, s0, e1, e2


def _anchor_terms(ep: EdgeProblem, Y):
    """Hinge terms against constant anchor points (obstacle reduction)."""
    diff = torch.einsum("an,...nd->...ad", _t(ep.aP, Y), Y) - _t(ep.acenters, Y)
    dist = (diff * diff).sum(dim=-1)
    e1 = _t(ep.aL_mask, Y) * torch.clamp(_t(ep.apsi_L, Y) - dist, min=0.0)
    e2 = _t(ep.aU_mask, Y) * torch.clamp(dist - _t(ep.apsi_U, Y), min=0.0)
    return diff, e1, e2


def cost(ep: EdgeProblem, Y, dgoal_e):
    """f(Y); dgoal_e = per-edge squared goal distances (see edge_values)."""
    _, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    f = rowwise_sum(s0 * s0 + e1 * e1 + e2 * e2)
    if ep.A:
        _, a1, a2 = _anchor_terms(ep, Y)
        f = f + rowwise_sum(a1 * a1 + a2 * a2)
    return f


def cost_and_egrad(ep: EdgeProblem, Y, dgoal_e):
    diff, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    f = rowwise_sum(s0 * s0 + e1 * e1 + e2 * e2)
    s = s0 + e1 - e2
    g = -2.0 * torch.einsum("en,...ed->...nd", _t(ep.C, Y), s[..., None] * diff)
    if ep.A:
        adiff, a1, a2 = _anchor_terms(ep, Y)
        f = f + rowwise_sum(a1 * a1 + a2 * a2)
        sa = a1 - a2
        g = g - 2.0 * torch.einsum("an,...ad->...nd", _t(ep.aP, Y), sa[..., None] * adiff)
    return f, g


def egrad(ep: EdgeProblem, Y, dgoal_e):
    return cost_and_egrad(ep, Y, dgoal_e)[1]


def residual_max(ep: EdgeProblem, Y, dgoal_e):
    """Max relative edge residual: |D_goal - D| over the edge's squared
    length, hinge violations over their bound, floored at the mean
    equality-edge scale."""
    _, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    om = _t(ep.omega, Y)
    eq_cnt = torch.clamp(om.sum(), min=1.0)  # on the device: no read of the host
    fl = (rowwise_sum(om * dgoal_e) / eq_cnt)[..., None]
    r = s0.abs() / torch.maximum(dgoal_e, fl)
    r = torch.maximum(r, e1 / torch.maximum(_t(ep.psi_L, Y), fl))
    r = torch.maximum(r, e2 / torch.maximum(_t(ep.psi_U, Y), fl))
    rmax = torch.amax(r, dim=-1)
    if ep.A:
        _, a1, a2 = _anchor_terms(ep, Y)
        ra = torch.maximum(
            a1 / torch.maximum(_t(ep.apsi_L, Y), fl),
            a2 / torch.maximum(_t(ep.apsi_U, Y), fl),
        )
        rmax = torch.maximum(rmax, torch.amax(ra, dim=-1))
    return rmax


def ehess(ep: EdgeProblem, Y, Z, dgoal_e):
    """Euclidean Hessian-vector product 2 C^T (m dD dY - s dZ)."""
    return hessian_at(ep, Y, dgoal_e)(Z)


def hessian_at(ep: EdgeProblem, Y, dgoal_e):
    """Z -> ehess(ep, Y, Z, dgoal_e), with the terms that depend on Y alone
    computed once."""
    diff, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    C = _t(ep.C, Y)
    s = s0 + e1 - e2
    m = (_t(ep.omega, Y)
         + _t(ep.L_mask, Y) * (e1 > 0).to(Y.dtype)
         + _t(ep.U_mask, Y) * (e2 > 0).to(Y.dtype))
    if ep.A:
        adiff, a1, a2 = _anchor_terms(ep, Y)
        P = _t(ep.aP, Y)
        sa = a1 - a2
        ma = (_t(ep.aL_mask, Y) * (a1 > 0).to(Y.dtype)
              + _t(ep.aU_mask, Y) * (a2 > 0).to(Y.dtype))

    def hvp(Z):
        diffZ = torch.einsum("en,...nd->...ed", C, Z)
        dD = 2.0 * (diff * diffZ).sum(dim=-1)
        h_e = (m * dD)[..., None] * diff - s[..., None] * diffZ
        H = 2.0 * torch.einsum("en,...ed->...nd", C, h_e)
        if ep.A:
            adiffZ = torch.einsum("an,...nd->...ad", P, Z)
            adD = 2.0 * (adiff * adiffZ).sum(dim=-1)
            h_a = (ma * adD)[..., None] * adiff - sa[..., None] * adiffZ
            H = H + 2.0 * torch.einsum("an,...ad->...nd", P, h_a)
        return H

    return hvp


_ARRAYS = ("C", "omega", "psi_L", "psi_U", "L_mask", "U_mask",
           "aP", "acenters", "apsi_L", "apsi_U", "aL_mask", "aU_mask")


def on_device(ep: EdgeProblem, dtype, device) -> EdgeProblem:
    """ep with the arrays the plain functions above read as tensors of
    `dtype` on `device`: those functions then copy nothing from the host at
    each call. The results are the same."""
    return dataclasses.replace(ep, **{k: torch.as_tensor(getattr(ep, k), dtype=dtype, device=device)
                                      for k in _ARRAYS})


# ---------------------------------------------------------------------------
# Kernel-order plain versions (csrc/edge_warp.cuh's summation order)
# ---------------------------------------------------------------------------
#
# The CUDA kernels sum in a fixed order, and these functions repeat it to
# the last bit (the build passes -fmad=false): a per-lane partial over the
# 32-lane layout (lane l holds edges l, l + 32, ... and nodes l, l + 32),
# then a 32-lane butterfly; sums over the d coordinates in order; and the
# scatter C^T w summed per node over its incident edges in ascending edge
# order. They are the exact plain versions of K1 and K2
# (`cost_and_egrad_kernel_order`, `ehess_kernel_order`) and the edge terms
# of the TR kernel's (ops/tr_solve.py::solve_tr_reference).

WARP = 32


@dataclasses.dataclass(frozen=True, eq=False)
class KernelOrderTables:
    """An EdgeProblem's edge tables as tensors of one dtype and device:
    endpoints ei, ej (E,); parameters om, psiL, psiU, Lm, Um (E,); each
    node's incident edges nbr (N, width), ascending and padded with E (a
    zero row), with signs sgn (+1 at ei, -1 at ej)."""

    ei: torch.Tensor
    ej: torch.Tensor
    om: torch.Tensor
    psiL: torch.Tensor
    psiU: torch.Tensor
    Lm: torch.Tensor
    Um: torch.Tensor
    nbr: torch.Tensor
    sgn: torch.Tensor
    N: int
    d: int


def kernel_order_tables(ep: EdgeProblem, dtype, device) -> KernelOrderTables:
    E = ep.E

    def t(x):
        return torch.as_tensor(np.asarray(x)[:E], dtype=dtype, device=device)

    inc = incidence(ep)
    width = max(len(x) for x in inc)
    nbr = torch.full((ep.N, width), E, dtype=torch.long)
    sgn = torch.ones((ep.N, width), dtype=dtype)
    for i, lst in enumerate(inc):
        for q, code in enumerate(lst):
            nbr[i, q] = code >> 1
            sgn[i, q] = -1.0 if code & 1 else 1.0
    return KernelOrderTables(
        ei=torch.as_tensor(ep.ei, dtype=torch.long, device=device),
        ej=torch.as_tensor(ep.ej, dtype=torch.long, device=device),
        om=t(ep.omega), psiL=t(ep.psi_L), psiU=t(ep.psi_U), Lm=t(ep.L_mask), Um=t(ep.U_mask),
        nbr=nbr.to(device), sgn=sgn.to(device), N=ep.N, d=ep.dim)


def lane_sum(x):
    """(B, n) values -> (B,). Lane l of the 32-lane layout holds values l,
    l + 32, ... (the TR kernel's nodes a lane when n > 32) and adds them in
    that order, a lane past the end adding +0; then the 32-lane butterfly
    (rounds xor 16, 8, 4, 2, 1), lane 0's value. For n <= 32 the partials
    are the values themselves."""
    k = -(-x.shape[-1] // WARP)
    x = torch.nn.functional.pad(x, (0, k * WARP - x.shape[-1])).reshape(-1, k, WARP)
    acc = x[:, 0]
    for j in range(1, k):
        acc = acc + x[:, j]
    x = acc
    for m in (16, 8, 4, 2, 1):
        # lane i gains lane i ^ m's value
        x = x + x.reshape(-1, WARP // (2 * m), 2, m).flip(-2).reshape(-1, WARP)
    return x[:, 0]


def edge_sum(x):
    """(B, E) -> (B,): per-lane partials over edges l, l + 32, ..., then
    `lane_sum`."""
    E = x.shape[-1]
    epl = -(-E // WARP)
    x = torch.nn.functional.pad(x, (0, epl * WARP - E)).reshape(-1, epl, WARP)
    acc = torch.zeros_like(x[:, 0])
    for j in range(epl):
        acc = acc + x[:, j]
    return lane_sum(acc)


def dot_d(a, b):
    """(..., d) x (..., d) -> (...), summed over d in order."""
    s = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        s = s + a[..., k] * b[..., k]
    return s


def scatter(kt: KernelOrderTables, w, scale):
    """scale * C^T w: (B, E, d) -> (B, N, d), each node's incident edges
    summed in ascending order."""
    w = torch.nn.functional.pad(w, (0, 0, 0, 1))
    acc = torch.zeros((w.shape[0], kt.N, kt.d), dtype=w.dtype, device=w.device)
    for q in range(kt.nbr.shape[1]):
        acc = acc + kt.sgn[:, q, None] * w[:, kt.nbr[:, q], :]
    return scale * acc


def edge_terms(kt: KernelOrderTables, Y, dg):
    """Edge differences dY (B, E, d) and the terms s0, e1, e2 (B, E);
    dg: (B, E) goal distances."""
    dY = Y[:, kt.ei] - Y[:, kt.ej]
    dist = dot_d(dY, dY)
    s0 = kt.om * (dg - dist)
    e1 = kt.Lm * torch.clamp(kt.psiL - dist, min=0.0)
    e2 = kt.Um * torch.clamp(dist - kt.psiU, min=0.0)
    return dY, s0, e1, e2


def hvp_weights(kt: KernelOrderTables, s0, e1, e2):
    """The Hessian's per-edge weights: s = s0 + e1 - e2 and the active
    mask m = omega + L_mask [e1 > 0] + U_mask [e2 > 0]."""
    s = s0 + e1 - e2
    m = kt.om + kt.Lm * (e1 > 0).to(s.dtype) + kt.Um * (e2 > 0).to(s.dtype)
    return s, m


def edge_hvp(kt: KernelOrderTables, dY, s, m, Z):
    """The Euclidean edge Hessian-vector product 2 C^T (m dD dY - s dZ)."""
    dZ = Z[:, kt.ei] - Z[:, kt.ej]
    mdD = m * (2.0 * dot_d(dY, dZ))
    return scatter(kt, mdD[..., None] * dY - s[..., None] * dZ, 2.0)


def cost_and_egrad_kernel_order(ep: EdgeProblem, Y, dgoal_e):
    """K1's plain version: (f, g) as `cost_and_egrad_cuda` computes them,
    bitwise at float32; edge terms only. Any dtype and device."""
    kt = kernel_order_tables(ep, Y.dtype, Y.device)
    dY, s0, e1, e2 = edge_terms(kt, Y, dgoal_e[:, :ep.E].to(Y.dtype))
    f = edge_sum(s0 * s0 + e1 * e1 + e2 * e2)
    s = s0 + e1 - e2
    return f, scatter(kt, s[..., None] * dY, -2.0)


def ehess_kernel_order(ep: EdgeProblem, Y, Z, dgoal_e):
    """K2's plain version: H as `ehess_cuda` computes it, bitwise at
    float32; edge terms only, no projection. Any dtype and device."""
    kt = kernel_order_tables(ep, Y.dtype, Y.device)
    dY, s0, e1, e2 = edge_terms(kt, Y, dgoal_e[:, :ep.E].to(Y.dtype))
    return edge_hvp(kt, dY, *hvp_weights(kt, s0, e1, e2), Z)


# ---------------------------------------------------------------------------
# CUDA kernels over the edge form (csrc/edge.cu)
# ---------------------------------------------------------------------------

def incidence(ep: EdgeProblem):
    """Per node, its incident edges in ascending order, each coded as
    2 * edge + (1 if the node is the edge's ej, i.e. the -1 of C)."""
    inc = [[] for _ in range(ep.N)]
    for e in range(ep.E):
        inc[int(ep.ei[e])].append(2 * e)
        inc[int(ep.ej[e])].append(2 * e + 1)
    return inc


def kernel_edge_tables(ep: EdgeProblem, device):
    """Edge list, packed parameters and the signed node->edge incidence CSR
    as device tensors for the kernels."""
    epar = np.stack([ep.omega, ep.psi_L, ep.psi_U, ep.L_mask, ep.U_mask], axis=1)[:ep.E]
    inc = incidence(ep)
    rowptr = np.cumsum([0] + [len(x) for x in inc])
    flat = np.concatenate([np.asarray(x, np.int64) for x in inc])
    as_i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    return (as_i32(ep.ei), as_i32(ep.ej),
            torch.as_tensor(epar, dtype=torch.float32, device=device),
            as_i32(rowptr), as_i32(flat))


def scatter_slots(ep: EdgeProblem) -> np.ndarray:
    """Each edge's place in csrc/edge.cu's per-segment scatter buffer, (E,)
    int32: edge e stays in the W places of its group e // W (the edges one
    slot of the segment's W lanes writes, W = 16 when N <= 16, else 32), at
    a residue mod W chosen greedily so that the other edges of its rows of
    the node-major incidence (the q-th incident edge of every node, which
    the node lanes read together) seldom share it. Equal residues in one
    read are shared-memory bank conflicts; the stores of a group never
    conflict. Where a value sits changes no sum."""
    W = 16 if ep.N <= 16 else 32
    rows, edge_rows = {}, [[] for _ in range(ep.E)]
    for lst in incidence(ep):
        for q, code in enumerate(lst):
            rows.setdefault(q, set()).add(code >> 1)
            edge_rows[code >> 1].append(q)
    residue = [-1] * ep.E
    for g in range(-(-ep.E // W)):
        free = set(range(W))
        for e in range(g * W, min(ep.E, (g + 1) * W)):
            taken = Counter(residue[x] for q in edge_rows[e] for x in rows[q] if x != e)
            residue[e] = min(free, key=lambda r: (taken[r], r))
            free.remove(residue[e])
    return np.array([(e // W) * W + residue[e] for e in range(ep.E)], np.int32)


def edge_kernel_tables(ep: EdgeProblem, device):
    """csrc/edge.cu's tables as device tensors: ei, ej, the packed
    parameters and rowptr of `kernel_edge_tables`; the scatter codes (max
    degree, N) int32, node i's q-th incident edge (ascending) at [q, i]
    coded as 2 slot + (1 where i is the edge's ej), and past its degree
    2 W EPL, the scatter buffer's zero place; and `scatter_slots`."""
    ei, ej, epar, rowptr, _ = kernel_edge_tables(ep, device)
    slots = scatter_slots(ep)
    inc = incidence(ep)
    W = 16 if ep.N <= 16 else 32
    codes = np.full((max(len(x) for x in inc), ep.N), 2 * W * -(-ep.E // W), np.int32)
    for i, lst in enumerate(inc):
        for q, code in enumerate(lst):
            codes[q, i] = 2 * slots[code >> 1] + (code & 1)
    return (ei, ej, epar, rowptr, torch.as_tensor(codes, device=device),
            torch.as_tensor(slots, device=device))


def cached_edge_tables(ep: EdgeProblem, device):
    """`edge_kernel_tables(ep, device)`, built on the first call for this
    (EdgeProblem, device) and the same tensors on every later one, for as
    long as the EdgeProblem lives (utils/compiled.py::cached). The tables
    never change: an EdgeProblem is frozen."""
    device = torch.device(device)
    return cached(ep, ("edge_tables", device), lambda: edge_kernel_tables(ep, device))


def check_kernel_inputs(what: str, ep: EdgeProblem, Ys, dgoal_e, max_n=MAX_N, max_e=MAX_E):
    """Raise unless every (B, N, d) tensor of Ys and dgoal_e ((B, E) or
    (B, Ep)) is a contiguous float32 CUDA tensor on one device, within the
    build's bounds (N <= max_n, E <= max_e)."""
    ts = (*Ys, dgoal_e)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{what} takes float32, got {[t.dtype for t in ts]}")
    if any(t.device.type != "cuda" or t.device != ts[0].device for t in ts):
        raise ValueError(f"{what} takes CUDA tensors on one device, got {[str(t.device) for t in ts]}")
    B, N, d = Ys[0].shape
    if (N != ep.N or d != ep.dim or d not in (2, 3) or N > max_n or not 0 < ep.E <= max_e
            or any(Y.shape != Ys[0].shape for Y in Ys)):
        raise ValueError(f"unsupported shape: {[tuple(Y.shape) for Y in Ys]}, N={ep.N}, "
                         f"dim={ep.dim}, E={ep.E} ({what} takes N <= {max_n}, E <= {max_e})")
    if dgoal_e.shape not in ((B, ep.E), (B, ep.Ep)):
        raise ValueError(f"dgoal_e must be ({B}, {ep.E}) or ({B}, {ep.Ep}), got {tuple(dgoal_e.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous tensors")


def check_edge_limits(ep: EdgeProblem, dgoal_e):
    """Raise, naming the limit, unless K1 / K2's build takes `ep`'s sizes
    and dgoal_e's stride (its last dimension); it looks at no device."""
    stride = dgoal_e.shape[-1]
    if ep.N > MAX_N or not 0 < ep.E <= MAX_E or stride > MAX_E:
        raise ValueError(f"the edge kernels take N <= {MAX_N}, 0 < E <= {MAX_E} and goal "
                         f"distances of dg_stride <= {MAX_E}, not N = {ep.N}, E = {ep.E}, "
                         f"dg_stride = {stride}")


def _no_anchors(ep: EdgeProblem):
    # The Pallas wrappers read only C and the edge parameters, so they
    # silently drop anchor terms; these refuse them instead.
    if ep.A:
        raise ValueError("the edge kernels take no anchor terms (A > 0): use "
                         "cost_and_egrad / ehess")


def _check_aligned(what: str, ts):
    # The bulk copies of csrc/edge.cu read 16-byte aligned rows; the caching
    # allocator aligns every tensor it allocates, a view at an offset may
    # not be.
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what} takes 16-byte aligned tensors (a view at an offset is not: "
                         f"pass a copy)")


# Warps a block and stages of instance slabs of csrc/edge_kernel.cuh
# (kEdgeWarps, kStages).
EDGE_WARPS = 8
EDGE_STAGES = 2


def _table_floats(npl: int, me: int) -> int:
    """The floats of an instance's edge tables (csrc/edge_warp.cuh
    EdgeTablesT<32 NPL, ME>: ei, ej (ME each), inc (2 ME), rowptr (32 NPL +
    1) and the parameters (5 ME)), rounded up to 4: 1188 up to 32 nodes and
    128 edges."""
    return -(-(9 * me + 32 * npl + 1) // 4) * 4


def edge_launch_plan(N: int, d: int, E: int, dg_stride: int, B: int, hess: bool) -> dict:
    """How csrc/edge_kernel.cuh lays out K1 (hess False) or K2 for B
    instances: the segment width W (16, two instances a warp, when N <= 16,
    else 32; past 32 nodes two node slots a lane), edges per lane
    EPL = ceil(E / W), instances a tile (8 warps of 32 / W), tiles, and the
    dynamic shared memory a block takes in bytes: two stages of a tile's Y,
    Z for K2 and goal-distance rows, then two output slabs and the warps'
    scatter buffers (a segment's [d][W EPL + 1], padded to 16 mod 32 floats
    at W = 16), or the instance's edge tables (`_table_floats`) if larger,
    which sit there before the first tile; each piece rounded up to 4
    floats. The kernel launches min(tiles, blocks resident) blocks."""
    W = 16 if N <= 16 else 32
    epl = -(-E // W)
    tables = _table_floats(2 if N > 32 else 1, max(128, epl * W))
    tile = EDGE_WARPS * (32 // W)
    y = -(-tile * N * d // 4) * 4
    stage = (2 if hess else 1) * y + -(-tile * dg_stride // 4) * 4
    seg = d * (W * epl + 1) + ((48 - d * (W * epl + 1) % 32) % 32 if W == 16 else 0)
    work = 2 * y + EDGE_WARPS * (32 // W) * seg
    floats = EDGE_STAGES * stage + max(work, tables)
    return {"W": W, "epl": epl, "two_per_warp": W == 16, "tile": tile,
            "tiles": -(-B // tile), "smem_bytes": 4 * floats}


def edge_kernel_shape(ep: EdgeProblem, B: int, dg_stride: int, hess: bool, device=None) -> dict:
    """The launch shape csrc/edge.cu reports for these sizes on the card:
    `edge_launch_plan`'s fields as the C side computes them, the blocks
    resident on the card and the blocks launched. Needs the card (it builds
    the library)."""
    from graphik_tpu_torch.ops._build import load_library

    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    info = (ctypes.c_int * 7)()
    rc = load_library().graphik_edge_shape(B, ep.N, ep.dim, ep.E, dg_stride, int(hess), index,
                                           info)
    if rc != 0:
        raise RuntimeError(f"edge kernel shape query failed: cudaError {rc}")
    return {"W": info[0], "epl": info[1], "two_per_warp": info[0] == 16, "tile": info[2],
            "tiles": info[3], "smem_bytes": info[4], "blocks_resident": info[5],
            "blocks": info[6]}


def _launch(what, fn, args, device):
    # the current stream's handle as torch's own launchers read it: ~0.2 us,
    # where torch.cuda.current_stream(device).cuda_stream builds a Stream
    # object (~5 us on the card's host)
    rc = fn(*args, device.index, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def cost_and_egrad_cuda(ep: EdgeProblem, Y, dgoal_e):
    """Launch csrc/edge.cu's cost+gradient kernel (K1): Y (B, N, d),
    dgoal_e (B, E) or (B, Ep), contiguous, 16-byte aligned float32 CUDA
    tensors -> (f (B,), g (B, N, d)); N <= 64, E <= 256, else it raises
    naming the limit (`check_edge_limits`). Edge terms only: an EdgeProblem with
    anchors (A > 0) raises, where JAX's cost_and_egrad_pallas drops them
    silently. The device tables are built once per (EdgeProblem, device).
    Counts its launches in `cost_and_egrad_cuda.launches`."""
    _no_anchors(ep)
    check_edge_limits(ep, dgoal_e)
    check_kernel_inputs("the edge cost+grad kernel", ep, (Y,), dgoal_e)
    _check_aligned("the edge cost+grad kernel", (Y, dgoal_e))
    B, N, d = Y.shape
    f = torch.empty(B, dtype=torch.float32, device=Y.device)
    g = torch.empty_like(Y)
    if B == 0:
        return f, g
    from graphik_tpu_torch.ops._build import load_library

    tables = cached_edge_tables(ep, Y.device)
    _launch("edge cost+grad kernel", load_library().graphik_edge_cost_grad,
            (Y.data_ptr(), dgoal_e.data_ptr(), dgoal_e.shape[1], *[t.data_ptr() for t in tables],
             tables[4].numel(), f.data_ptr(), g.data_ptr(), B, N, d, ep.E), Y.device)
    cost_and_egrad_cuda.launches += 1
    return f, g


cost_and_egrad_cuda.launches = 0


def ehess_cuda(ep: EdgeProblem, Y, Z, dgoal_e):
    """Launch csrc/edge.cu's Hessian-vector kernel (K2): the Euclidean
    2 C^T (m dD dY - s dZ), no projection, for Y, Z (B, N, d) and dgoal_e
    (B, E) or (B, Ep), contiguous, 16-byte aligned float32 CUDA tensors,
    within `cost_and_egrad_cuda`'s limits. Edge terms only: anchors (A > 0)
    raise, as in `cost_and_egrad_cuda`.
    Counts its launches in `ehess_cuda.launches`."""
    _no_anchors(ep)
    check_edge_limits(ep, dgoal_e)
    check_kernel_inputs("the edge Hessian kernel", ep, (Y, Z), dgoal_e)
    _check_aligned("the edge Hessian kernel", (Y, Z, dgoal_e))
    B, N, d = Y.shape
    H = torch.empty_like(Y)
    if B == 0:
        return H
    from graphik_tpu_torch.ops._build import load_library

    tables = cached_edge_tables(ep, Y.device)
    _launch("edge Hessian kernel", load_library().graphik_edge_hess,
            (Y.data_ptr(), Z.data_ptr(), dgoal_e.data_ptr(), dgoal_e.shape[1],
             *[t.data_ptr() for t in tables], tables[4].numel(), H.data_ptr(), B, N, d, ep.E),
            Y.device)
    ehess_cuda.launches += 1
    return H


ehess_cuda.launches = 0
