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
csrc/edge.cu, the counterparts of the JAX package's per-op Pallas kernels
(cost_and_egrad_pallas, ehess_pallas); their plain versions are
`cost_and_egrad` and `ehess`. No solve path calls them: the TR kernel
fuses the same math.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphik_tpu_torch.solvers.costs import make_masks

_SUBLANE = 8  # edge and anchor-block counts pad to a multiple of this

# Shapes the CUDA build covers (csrc/edge_warp.cuh kMaxN / kMaxE).
MAX_N = 32
MAX_E = 128


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


def egrad(ep: EdgeProblem, Y, dgoal_e):
    return cost_and_egrad(ep, Y, dgoal_e)[1]


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


def check_kernel_inputs(what: str, ep: EdgeProblem, Ys, dgoal_e):
    """Raise unless every (B, N, d) tensor of Ys and dgoal_e ((B, E) or
    (B, Ep)) is a contiguous float32 CUDA tensor on one device, within the
    build's bounds."""
    ts = (*Ys, dgoal_e)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{what} takes float32, got {[t.dtype for t in ts]}")
    if any(t.device.type != "cuda" or t.device != ts[0].device for t in ts):
        raise ValueError(f"{what} takes CUDA tensors on one device, got {[str(t.device) for t in ts]}")
    B, N, d = Ys[0].shape
    if (N != ep.N or d != ep.dim or d not in (2, 3) or N > MAX_N or not 0 < ep.E <= MAX_E
            or any(Y.shape != Ys[0].shape for Y in Ys)):
        raise ValueError(f"unsupported shape: {[tuple(Y.shape) for Y in Ys]}, N={ep.N}, "
                         f"dim={ep.dim}, E={ep.E}")
    if dgoal_e.shape not in ((B, ep.E), (B, ep.Ep)):
        raise ValueError(f"dgoal_e must be ({B}, {ep.E}) or ({B}, {ep.Ep}), got {tuple(dgoal_e.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous tensors")


def _no_anchors(ep: EdgeProblem):
    # The Pallas wrappers read only C and the edge parameters, so they
    # silently drop anchor terms; these refuse them instead.
    if ep.A:
        raise ValueError("the edge kernels take no anchor terms (A > 0): use "
                         "cost_and_egrad / ehess")


def cost_and_egrad_cuda(ep: EdgeProblem, Y, dgoal_e):
    """Launch csrc/edge.cu's cost+gradient kernel: Y (B, N, d), dgoal_e
    (B, E) or (B, Ep), contiguous float32 CUDA tensors -> (f (B,),
    g (B, N, d)). Edge terms only: an EdgeProblem with anchors (A > 0)
    raises, where JAX's cost_and_egrad_pallas drops them silently. Counts
    its launches in `cost_and_egrad_cuda.launches`."""
    _no_anchors(ep)
    check_kernel_inputs("the edge cost+grad kernel", ep, (Y,), dgoal_e)
    B, N, d = Y.shape
    f = torch.empty(B, dtype=torch.float32, device=Y.device)
    g = torch.empty_like(Y)
    if B == 0:
        return f, g
    from graphik_tpu_torch.ops._build import load_library

    lib = load_library()
    ei, ej, epar, rowptr, inc = kernel_edge_tables(ep, Y.device)
    with torch.cuda.device(Y.device):  # the launch goes to the current device
        rc = lib.graphik_edge_cost_grad(
            Y.data_ptr(), dgoal_e.data_ptr(), dgoal_e.shape[1], ei.data_ptr(), ej.data_ptr(),
            epar.data_ptr(), rowptr.data_ptr(), inc.data_ptr(), f.data_ptr(), g.data_ptr(),
            B, N, d, ep.E, torch.cuda.current_stream(Y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edge cost+grad kernel launch failed: cudaError {rc}")
    cost_and_egrad_cuda.launches += 1
    return f, g


cost_and_egrad_cuda.launches = 0


def ehess_cuda(ep: EdgeProblem, Y, Z, dgoal_e):
    """Launch csrc/edge.cu's Hessian-vector kernel: the Euclidean
    2 C^T (m dD dY - s dZ), no projection, for Y, Z (B, N, d) and dgoal_e
    (B, E) or (B, Ep), contiguous float32 CUDA tensors. Edge terms only:
    anchors (A > 0) raise, as in `cost_and_egrad_cuda`. Counts its launches
    in `ehess_cuda.launches`."""
    _no_anchors(ep)
    check_kernel_inputs("the edge Hessian kernel", ep, (Y, Z), dgoal_e)
    B, N, d = Y.shape
    H = torch.empty_like(Y)
    if B == 0:
        return H
    from graphik_tpu_torch.ops._build import load_library

    lib = load_library()
    ei, ej, epar, rowptr, inc = kernel_edge_tables(ep, Y.device)
    with torch.cuda.device(Y.device):
        rc = lib.graphik_edge_hess(
            Y.data_ptr(), Z.data_ptr(), dgoal_e.data_ptr(), dgoal_e.shape[1], ei.data_ptr(),
            ej.data_ptr(), epar.data_ptr(), rowptr.data_ptr(), inc.data_ptr(), H.data_ptr(),
            B, N, d, ep.E, torch.cuda.current_stream(Y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edge Hessian kernel launch failed: cudaError {rc}")
    ehess_cuda.launches += 1
    return H


ehess_cuda.launches = 0
