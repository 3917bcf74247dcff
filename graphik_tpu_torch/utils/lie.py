"""Batched SO(3)/SE(3) operations in PyTorch.

Port of the SO(3)/SE(3) subset of graphik_tpu/utils/lie.py that the main
path uses (FK, joint recovery, pose error, the joint-space polish).

Conventions
-----------
* Poses are homogeneous matrices: SE(3) -> (..., 4, 4).
* Twists are ``[v, omega]`` (translation part first): (..., 6).
* All functions broadcast over leading batch dimensions and keep the
  input's dtype and device.
* Small-angle branches use Taylor expansions selected with `torch.where`.
"""

from __future__ import annotations

import math

import torch

# Guard against literal division by zero only (value-level, dtype-safe).
_TINY = 1e-9


def _taylor_threshold(dtype):
    """Angle below which Taylor series replace trig closed forms.

    The cancellation error of forms like (theta - sin theta)/theta^3 grows
    as eps/theta^2, so in float32 the switch happens at theta ~ 1; in
    float64 the closed forms are accurate to ~1e-11 relative at 0.1, where
    the theta^6-order series are exact to eps.
    """
    return 1.0 if torch.finfo(dtype).eps > 1e-10 else 0.1


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def _sinc(theta):
    """sin(theta)/theta, stable at 0 (only the 0/0 guard)."""
    small = theta.abs() < _TINY
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, torch.ones_like(theta), torch.sin(safe) / safe)


def _cosc(theta):
    """(1 - cos(theta))/theta^2 = 2 sin^2(theta/2)/theta^2 (no cancellation)."""
    small = theta.abs() < _TINY
    safe = torch.where(small, torch.ones_like(theta), theta)
    s = torch.sin(safe / 2.0)
    return torch.where(small, torch.full_like(theta, 0.5),
                       2.0 * (s / safe) * (s / safe))


def _one_minus_sinc_over_sq(theta):
    """(1 - sinc(theta))/theta^2 = (theta - sin theta)/theta^3, stable at 0."""
    t2 = theta * theta
    small = theta.abs() < _taylor_threshold(theta.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    series = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0 - t2 * t2 * t2 / 362880.0
    return torch.where(small, series, (safe - torch.sin(safe)) / safe**3)


def so3_exp(w):
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye(3, w) + a * W + b * W2


def quat_from_rotation(R):
    """Unit quaternion (w, x, y, z) from (..., 3, 3) rotation matrices.

    Branchless Shepperd extraction: all four pivot candidates are formed
    and the numerically dominant one selected per element.
    """
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    a01, a02, a12 = (
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    )
    s01, s02, s12 = (
        R[..., 2, 1] + R[..., 1, 2],
        R[..., 0, 2] + R[..., 2, 0],
        R[..., 1, 0] + R[..., 0, 1],
    )
    pivots = torch.stack(
        [1.0 + t, 1.0 + 2.0 * r00 - t, 1.0 + 2.0 * r11 - t, 1.0 + 2.0 * r22 - t],
        dim=-1,
    )
    cands = torch.stack(
        [
            torch.stack([1.0 + t, a01, a02, a12], dim=-1),
            torch.stack([a01, 1.0 + 2.0 * r00 - t, s12, s02], dim=-1),
            torch.stack([a02, s12, 1.0 + 2.0 * r11 - t, s01], dim=-1),
            torch.stack([a12, s02, s01, 1.0 + 2.0 * r22 - t], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4 components)
    k = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    piv = torch.gather(pivots, -1, k[..., None])[..., 0]
    q = q / (2.0 * torch.sqrt(torch.clamp(piv, min=1e-30)))[..., None]
    # canonical sign: w >= 0
    sign = torch.where(q[..., 0] < 0, -1.0, 1.0).to(q.dtype)
    return q * sign[..., None]


def so3_log(R):
    """(..., 3, 3) rotation -> (..., 3) axis-angle, via quaternions.

    ||v|| = sin(theta/2), w = cos(theta/2); log = 2 v * (theta/2) / ||v||,
    well-conditioned for all angles including near pi.
    """
    q = quat_from_rotation(R)
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    half = torch.atan2(vn, q[..., 0])
    small = vn < 1e-9
    factor = torch.where(
        small, torch.full_like(vn, 2.0),
        2.0 * half / torch.where(small, torch.ones_like(vn), vn),
    )
    return v * factor[..., None]


def so3_left_jacobian(w):
    """Left Jacobian of SO(3), (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    W2 = W @ W
    b = _cosc(theta)[..., None, None]
    c = _one_minus_sinc_over_sq(theta)[..., None, None]
    return _eye(3, w) + b * W + c * W2


def so3_inv_left_jacobian(w):
    """Closed-form inverse of the SO(3) left Jacobian."""
    theta = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    W2 = W @ W
    small = theta < _taylor_threshold(theta.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    # coefficient of W2: (1/theta^2)(1 - sinc/(2 cosc)) with stable limit 1/12
    t2 = theta * theta
    series = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0 + t2 * t2 * t2 / 1209600.0
    cot_term = torch.where(
        small,
        series,
        (1.0 / safe**2) * (1.0 - (_sinc(safe) / (2.0 * _cosc(safe)))),
    )
    return _eye(3, w) - 0.5 * W + cot_term[..., None, None] * W2


def rotz(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zero], dim=-1),
            torch.stack([s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_make(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_inv(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_make(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def se3_exp(xi):
    """(..., 6) twist [v, w] -> (..., 4, 4)."""
    v = xi[..., :3]
    w = xi[..., 3:]
    R = so3_exp(w)
    J = so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", J, v)
    return se3_make(R, t)


def se3_log(T):
    """(..., 4, 4) -> (..., 6) twist [v, w]."""
    w = so3_log(T[..., :3, :3])
    Jinv = so3_inv_left_jacobian(w)
    v = torch.einsum("...ij,...j->...i", Jinv, T[..., :3, 3])
    return torch.cat([v, w], dim=-1)


def se3_adjoint(T):
    """(..., 4, 4) -> (..., 6, 6) adjoint for [v, w]-ordered twists."""
    R = T[..., :3, :3]
    tR = so3_hat(T[..., :3, 3]) @ R
    z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([z, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_rotz(theta):
    """Pure z-rotation SE(3)."""
    return se3_make(rotz(theta), torch.zeros(theta.shape + (3,), dtype=theta.dtype,
                                             device=theta.device))


def se3_trans_axis(d, axis=2, dtype=torch.float64, device=None):
    """Pure translation by the float `d` along a principal axis."""
    T = torch.eye(4, dtype=dtype, device=device)
    T[axis, 3] = d
    return T


def se3_inv_left_jacobian(xi):
    """Inverse left Jacobian of SE(3) for [v, w] twists."""
    v = xi[..., :3]
    w = xi[..., 3:]
    Jw_inv = so3_inv_left_jacobian(w)
    Q = _se3_curlyQ(v, w)
    top = torch.cat([Jw_inv, -Jw_inv @ Q @ Jw_inv], dim=-1)
    bottom = torch.cat([torch.zeros_like(Jw_inv), Jw_inv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _se3_curlyQ(rho, w):
    """The Q matrix in the SE(3) left Jacobian (Barfoot, eq. 7.86)."""
    th = torch.linalg.norm(w, dim=-1)
    W = so3_hat(w)
    V = so3_hat(rho)
    WV = W @ V
    VW = V @ W
    WVW = WV @ W
    th2 = th * th
    small = th < _taylor_threshold(th.dtype)
    safe = torch.where(small, torch.ones_like(th), th)
    th4 = th2 * th2
    c2 = _one_minus_sinc_over_sq(th)  # a3 = (th - sin)/th^3, limit 1/6
    # c3 = (th^2/2 + cos - 1)/th^4 = -a4, limit 1/24
    c3 = torch.where(
        small,
        1.0 / 24.0 - th2 / 720.0 + th4 / 40320.0 - th4 * th2 / 3628800.0,
        (th2 / 2.0 + torch.cos(safe) - 1.0) / safe**4,
    )
    # c4 = a5 = (th - sin - th^3/6)/th^5, limit -1/120
    c4 = torch.where(
        small,
        -1.0 / 120.0 + th2 / 5040.0 - th4 / 362880.0 + th4 * th2 / 39916800.0,
        (safe - torch.sin(safe) - safe**3 / 6.0) / safe**5,
    )
    c2 = c2[..., None, None]
    c3 = c3[..., None, None]
    c4 = c4[..., None, None]
    # Q = V/2 + a3(WV+VW+WVW) - a4(W^2V+VW^2-3WVW) - (a4-3a5)/2 (WVW^2+W^2VW)
    return (
        0.5 * V
        + c2 * (WV + VW + WVW)
        + c3 * (W @ WV + VW @ W - 3.0 * WVW)
        + 0.5 * (c3 + 3.0 * c4) * (WVW @ W + W @ WVW)
    )


def wraptopi(theta):
    """Wrap angles to [-pi, pi)."""
    return torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi
