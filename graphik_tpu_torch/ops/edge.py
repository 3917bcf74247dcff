"""Edge-list (incidence) formulation of the EDM-completion cost.

Port of graphik_tpu/ops/edge.py: the active edge set of a template is
compiled once, host-side, into numpy arrays (`EdgeProblem`), and the cost,
gradient, Hessian-vector product and residual are plain torch functions
over that form. They are the reference math for the TR kernel
(ops/tr_solve.py) and the parity oracle against the JAX package.

    diff  = C Y            (E, d)   edge difference vectors
    dist  = ||diff||^2     (E,)     squared edge lengths
    grad  = -2 C^T (s * diff)       scatter-add as a matmul

The JAX package's per-op Pallas kernels (cost+grad, Hessian-vector) are
not on the main path and are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphik_tpu_torch.solvers.costs import make_masks

_SUBLANE = 8  # edge and anchor-block counts pad to a multiple of this


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
        ei = torch.as_tensor(self.ei, dtype=torch.long, device=M.device)
        ej = torch.as_tensor(self.ej, dtype=torch.long, device=M.device)
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
    f = (s0 * s0 + e1 * e1 + e2 * e2).sum(dim=-1)
    if ep.A:
        _, a1, a2 = _anchor_terms(ep, Y)
        f = f + (a1 * a1 + a2 * a2).sum(dim=-1)
    return f


def cost_and_egrad(ep: EdgeProblem, Y, dgoal_e):
    diff, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    f = (s0 * s0 + e1 * e1 + e2 * e2).sum(dim=-1)
    s = s0 + e1 - e2
    g = -2.0 * torch.einsum("en,...ed->...nd", _t(ep.C, Y), s[..., None] * diff)
    if ep.A:
        adiff, a1, a2 = _anchor_terms(ep, Y)
        f = f + (a1 * a1 + a2 * a2).sum(dim=-1)
        sa = a1 - a2
        g = g - 2.0 * torch.einsum("an,...ad->...nd", _t(ep.aP, Y), sa[..., None] * adiff)
    return f, g


def residual_max(ep: EdgeProblem, Y, dgoal_e):
    """Max relative edge residual: |D_goal - D| over the edge's squared
    length, hinge violations over their bound, floored at the mean
    equality-edge scale."""
    _, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    om = _t(ep.omega, Y)
    eq_cnt = max(float(np.sum(ep.omega)), 1.0)
    fl = ((om * dgoal_e).sum(dim=-1) / eq_cnt)[..., None]
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
    diff, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    C = _t(ep.C, Y)
    diffZ = torch.einsum("en,...nd->...ed", C, Z)
    dD = 2.0 * (diff * diffZ).sum(dim=-1)
    s = s0 + e1 - e2
    m = (_t(ep.omega, Y)
         + _t(ep.L_mask, Y) * (e1 > 0).to(Y.dtype)
         + _t(ep.U_mask, Y) * (e2 > 0).to(Y.dtype))
    h_e = (m * dD)[..., None] * diff - s[..., None] * diffZ
    H = 2.0 * torch.einsum("en,...ed->...nd", C, h_e)
    if ep.A:
        adiff, a1, a2 = _anchor_terms(ep, Y)
        P = _t(ep.aP, Y)
        adiffZ = torch.einsum("an,...nd->...ad", P, Z)
        adD = 2.0 * (adiff * adiffZ).sum(dim=-1)
        sa = a1 - a2
        ma = (_t(ep.aL_mask, Y) * (a1 > 0).to(Y.dtype)
              + _t(ep.aU_mask, Y) * (a2 > 0).to(Y.dtype))
        h_a = (ma * adD)[..., None] * adiff - sa[..., None] * adiffZ
        H = H + 2.0 * torch.einsum("an,...ad->...nd", P, h_a)
    return H
