"""Dense masked EDM-completion costs: f, Euclidean gradient, Hessian-vector.

Port of graphik_tpu/solvers/costs.py: plain torch functions on (..., N, d)
point sets, batched over the leading dims. The masks omega, psi_L, psi_U,
L_mask, U_mask are (N, N), shared by the batch or given per instance; they
and the anchors' host arrays are cast to Y's dtype and device.

  D(Y)   = K(Y Y^T),  K(G) = diag(G) 1^T + 1 diag(G)^T - 2 G  (squared EDM)
  f(Y)   = 1/2 ( ||omega o (D_goal - D)||_F^2
               + ||max(psi_L - D, 0) o L_mask||_F^2
               + ||max(D - psi_U, 0) o U_mask||_F^2 )
  egrad  = 2 adj(S) Y,  S = S0 + E1 - E2,  adj(X) = X - Diag(X 1)
  ehess(Z) = 2 ( adj(-M o K(YZ^T + ZY^T)) Y + adj(S) Z ),
             M = omega + L_mask o 1[E1>0] + U_mask o 1[E2>0]

Anchored hinges (the obstacle reduction, ProblemStructure.reduced_spec)
hold rows of Y against constant points. This dense form is the CG solver's
default backend (solvers/riemannian.py::solve_cg).
"""

from __future__ import annotations

import numpy as np
import torch

from graphik_tpu_torch.ops.linalg import rowwise_sum
from graphik_tpu_torch.utils.dgp import distance_matrix_from_gram, distance_matrix_from_pos


def _t(x, like):
    """x (a tensor, or host numpy) in like's dtype and device."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _idx(x, like):
    """Node indices (a tensor, or host numpy) as a long tensor on like's device."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.long, device=like.device)


def _adj(X):
    """adj(X) = X - Diag(row sums): the adjoint of G -> K(G) for symmetric X."""
    return X - torch.diag_embed(X.sum(-1))


def _adj_mv(X, Y):
    """adj(X) @ Y without forming the diagonal subtraction."""
    return X @ Y - X.sum(-1)[..., :, None] * Y


def residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask):
    """(D, S0, E1, E2): the squared EDM of Y, the equality residual and the
    lower and upper hinge violations."""
    D = distance_matrix_from_pos(Y)
    S0 = _t(omega, Y) * (D_goal - D)
    E1 = _t(L_mask, Y) * torch.clamp(_t(psi_L, Y) - D, min=0.0)
    E2 = _t(U_mask, Y) * torch.clamp(D - _t(psi_U, Y), min=0.0)
    return D, S0, E1, E2


def _anchor_residuals(Y, anchors):
    """Hinge residuals of rows of Y against constant points. anchors: the
    host dict of ProblemStructure.reduced_spec() (idx (A,), centers (A, d),
    psi_L, psi_U, L_mask, U_mask (A,)). Returns (adiff (..., A, d), a1, a2)."""
    adiff = Y[..., _idx(anchors["idx"], Y), :] - _t(anchors["centers"], Y)
    adist = (adiff * adiff).sum(-1)
    a1 = _t(anchors["L_mask"], Y) * torch.clamp(_t(anchors["psi_L"], Y) - adist, min=0.0)
    a2 = _t(anchors["U_mask"], Y) * torch.clamp(adist - _t(anchors["psi_U"], Y), min=0.0)
    return adiff, a1, a2


def _anchor_scatter(Y, idx, vals):
    """Scatter-add (..., A, d) rows back to (..., N, d) at idx, as the
    product with the (A, N) one-hot of idx: the same order of summation at
    every call (index_add_ on a card adds in the order its atomics land)."""
    idx = _idx(idx, Y)
    onehot = (idx[:, None] == torch.arange(Y.shape[-2], device=Y.device)).to(Y.dtype)
    return onehot.transpose(0, 1) @ vals


def cost(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None):
    return cost_and_egrad(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors, grad=False)


def egrad(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None):
    return cost_and_egrad(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors)[1]


def cost_and_egrad(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None,
                   grad: bool = True):
    """(f (...,), g (..., N, d)); with grad=False, f alone."""
    _, S0, E1, E2 = residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
    f = 0.5 * (rowwise_sum(S0 * S0, 2) + rowwise_sum(E1 * E1, 2) + rowwise_sum(E2 * E2, 2))
    if anchors is not None:
        adiff, a1, a2 = _anchor_residuals(Y, anchors)
        f = f + rowwise_sum(a1 * a1 + a2 * a2)
    if not grad:
        return f
    g = 2.0 * _adj_mv(S0 + E1 - E2, Y)
    if anchors is not None:
        g = g - 2.0 * _anchor_scatter(Y, anchors["idx"], (a1 - a2)[..., None] * adiff)
    return f, g


def ehess(Y, Z, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None):
    """The Euclidean Hessian of f at Y applied to Z (..., N, d)."""
    return hessian_at(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors)(Z)


def hessian_at(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None):
    """Z -> ehess(Y, Z, ...), with the terms that depend on Y alone computed
    once (a truncated-CG solve applies one Hessian many times)."""
    _, S0, E1, E2 = residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
    M = _t(omega, Y) + _t(L_mask, Y) * (E1 > 0) + _t(U_mask, Y) * (E2 > 0)
    S = S0 + E1 - E2
    if anchors is not None:
        idx = _idx(anchors["idx"], Y)
        adiff, a1, a2 = _anchor_residuals(Y, anchors)
        ma = _t(anchors["L_mask"], Y) * (a1 > 0) + _t(anchors["U_mask"], Y) * (a2 > 0)
        sa = a1 - a2

    def hvp(Z):
        G_dot = Y @ Z.transpose(-1, -2)
        dD = distance_matrix_from_gram(G_dot + G_dot.transpose(-1, -2))
        H = 2.0 * (_adj_mv(-M * dD, Y) + _adj_mv(S, Z))
        if anchors is not None:
            adiffZ = Z[..., idx, :]
            adD = 2.0 * (adiff * adiffZ).sum(-1)
            H = H + 2.0 * _anchor_scatter(
                Y, idx, (ma * adD)[..., None] * adiff - sa[..., None] * adiffZ)
        return H

    return hvp


def residual_max(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None):
    """The max relative edge residual: |D_goal - D| over the edge's squared
    length, each hinge's violation over its bound, anchored hinges alike,
    each floored at the instance's mean equality-edge squared length."""
    _, S0, E1, E2 = residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
    om = _t(omega, Y)
    eq_cnt = torch.clamp(om.sum(), min=1.0)
    floor = rowwise_sum(om * D_goal, 2) / eq_cnt
    fl = floor[..., None, None]
    r = S0.abs() / torch.maximum(D_goal, fl)
    r = torch.maximum(r, E1 / torch.maximum(_t(psi_L, Y), fl))
    r = torch.maximum(r, E2 / torch.maximum(_t(psi_U, Y), fl))
    rmax = r.amax(dim=(-2, -1))
    if anchors is not None:
        _, a1, a2 = _anchor_residuals(Y, anchors)
        flv = floor[..., None]
        ra = torch.maximum(a1 / torch.maximum(_t(anchors["psi_L"], Y), flv),
                           a2 / torch.maximum(_t(anchors["psi_U"], Y), flv))
        rmax = torch.maximum(rmax, ra.amax(-1))
    return rmax


def make_masks(omega, psi_L, psi_U):
    """Hinge activity masks: an edge carries a lower (upper) hinge when its
    bounds differ and its lower (upper) bound is positive. Host numpy: the
    masks are static template constants."""
    psi_L = np.asarray(psi_L, np.float64)
    psi_U = np.asarray(psi_U, np.float64)
    diff = psi_L != psi_U
    L_mask = (diff & (psi_L > 0)).astype(np.float64)
    U_mask = (diff & (psi_U > 0)).astype(np.float64)
    return L_mask, U_mask
