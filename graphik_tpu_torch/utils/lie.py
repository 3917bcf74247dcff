"""Batched SO(3)/SE(3) and SO(2)/SE(2) operations in PyTorch.

Port of graphik_tpu/utils/lie.py: the maps of FK, joint recovery, pose
error and the joint-space polish, and the batch-invariant small products
they use (`matmul_small`, `matvec_small`).

Conventions
-----------
* Poses are homogeneous matrices: SE(3) -> (..., 4, 4), SE(2) -> (..., 3, 3).
* Twists are ``[v, omega]`` (translation part first): (..., 6) or (..., 3).
* All functions broadcast over leading batch dimensions and keep the
  input's dtype and device.
* Small-angle branches use Taylor expansions selected with `torch.where`.
"""

from __future__ import annotations

import math

import torch

# Guard against literal division by zero only (value-level, dtype-safe).
_TINY = 1e-9


def matmul_small(a, b):
    """a @ b for small matrices, broadcast over the leading dims, with one
    rounding on the CPU and on a card: each entry starts as a_i0 b_0j and
    takes a_ik b_kj for k = 1, 2, ... in order, each by one fused
    multiply-add (torch.addcmul, fused on both devices). That is the
    rounding of the JAX package's float32 products on the CPU (jnp.matmul
    at "highest", jnp.einsum, J.T @ J) bit for bit. It is elementwise, so
    every lane's result is independent of the batch: a batched GEMM or GEMV
    chooses its kernel, and so its rounding, by the batch count and shape,
    and on a card cuBLAS's rounding is not the CPU's."""
    cols = a.unsqueeze(-1).unbind(-2)  # a[..., :, k, None]: one dispatch for all k
    rows = b.unsqueeze(-3).unbind(-2)  # b[..., None, k, :]
    out = cols[0] * rows[0]
    for c, r in zip(cols[1:], rows[1:]):
        out = torch.addcmul(out, c, r)
    return out


def matvec_small(a, v):
    """a @ v for small matrices and vectors, (..., m, k) x (..., k) ->
    (..., m), rounded as matmul_small."""
    return matmul_small(a, v[..., None])[..., 0]


# A tensor is divided by a Python number only where the number is a power of
# two. A card takes x / c as x * (1 / c), with 1 / c rounded to x's type, and
# so does the JAX package's jit; torch's CPU divides. Elsewhere the finish
# writes the reciprocal out, x * (1.0 / c), which rounds the same on both
# devices and as the JAX package's jitted code (1 / c in float64, then in
# float32, is the float32 1 / c for every constant here).


def _rn(fn, *xs):
    """fn of float32 tensors taken in float64 and rounded once to float32:
    the correctly rounded value but where the float64 one lies within its
    own error of a float32 rounding boundary (about 2^-28 of the inputs), so
    the same bits on the CPU and on a card, whose float32 sqrt, sin, cos and
    atan2 round otherwise (torch's own float32 sqrt is not correctly rounded
    on the CPU either). float64 tensors take fn itself."""
    if xs[0].dtype == torch.float32:
        return fn(*[x.double() for x in xs]).to(torch.float32)
    return fn(*xs)


def sqrt_rn(x):
    """sqrt(x) by _rn (jnp.sqrt's bits on the CPU in float32)."""
    return _rn(torch.sqrt, x)


def sin_rn(x):
    """sin(x) by _rn."""
    return _rn(torch.sin, x)


def cos_rn(x):
    """cos(x) by _rn."""
    return _rn(torch.cos, x)


def atan2_rn(y, x):
    """atan2(y, x) by _rn."""
    return _rn(torch.atan2, y, x)


def dot_small(a, b):
    """The dot product over the last (short) dim, summed as matmul_small
    sums."""
    xs, ys = a.unbind(-1), b.unbind(-1)
    s = xs[0] * ys[0]
    for x, y in zip(xs[1:], ys[1:]):
        s = torch.addcmul(s, x, y)
    return s


def norm_small(v, keepdim: bool = False):
    """The Euclidean norm over the last (short) dim: dot_small(v, v), then
    sqrt_rn (jnp.linalg.norm's bits on the CPU)."""
    s = sqrt_rn(dot_small(v, v))
    return s[..., None] if keepdim else s


def mean_small(x, dim: int, keepdim: bool = False):
    """The mean over a short dim: the values added in order, then times 1 / n
    in x's dtype (jnp.mean's bits on the CPU; torch divides on the CPU and
    sums in another order on a card)."""
    n = x.shape[dim]
    parts = x.unbind(dim)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    s = s * (1.0 / n)
    return s.unsqueeze(dim) if keepdim else s


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


def so3_vee(W):
    """(..., 3, 3) -> (..., 3), the inverse of so3_hat."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(theta):
    """sin(theta)/theta, stable at 0 (only the 0/0 guard)."""
    small = theta.abs() < _TINY
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, torch.ones_like(theta), sin_rn(safe) / safe)


def _cosc(theta):
    """(1 - cos(theta))/theta^2 = 2 sin^2(theta/2)/theta^2 (no cancellation)."""
    small = theta.abs() < _TINY
    safe = torch.where(small, torch.ones_like(theta), theta)
    s = sin_rn(safe / 2.0)
    return torch.where(small, torch.full_like(theta, 0.5),
                       2.0 * (s / safe) * (s / safe))


def _one_minus_sinc_over_sq(theta):
    """(1 - sinc(theta))/theta^2 = (theta - sin theta)/theta^3, stable at 0."""
    t2 = theta * theta
    small = theta.abs() < _taylor_threshold(theta.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    series = (1.0 / 6.0 - t2 * (1.0 / 120.0) + t2 * t2 * (1.0 / 5040.0)
              - t2 * t2 * t2 * (1.0 / 362880.0))
    return torch.where(small, series, (safe - sin_rn(safe)) / (safe * safe * safe))


def so3_exp(w):
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta = norm_small(w)
    W = so3_hat(w)
    W2 = matmul_small(W, W)
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
    q = q / (2.0 * sqrt_rn(torch.clamp(piv, min=1e-30)))[..., None]
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
    vn = norm_small(v)
    half = atan2_rn(vn, q[..., 0])
    small = vn < 1e-9
    factor = torch.where(
        small, torch.full_like(vn, 2.0),
        2.0 * half / torch.where(small, torch.ones_like(vn), vn),
    )
    return v * factor[..., None]


def so3_left_jacobian(w):
    """Left Jacobian of SO(3), (..., 3) -> (..., 3, 3)."""
    theta = norm_small(w)
    W = so3_hat(w)
    W2 = matmul_small(W, W)
    b = _cosc(theta)[..., None, None]
    c = _one_minus_sinc_over_sq(theta)[..., None, None]
    return _eye(3, w) + b * W + c * W2


def so3_inv_left_jacobian(w):
    """Closed-form inverse of the SO(3) left Jacobian."""
    theta = norm_small(w)
    W = so3_hat(w)
    W2 = matmul_small(W, W)
    small = theta < _taylor_threshold(theta.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    # coefficient of W2: (1/theta^2)(1 - sinc/(2 cosc)) with stable limit 1/12
    t2 = theta * theta
    series = (1.0 / 12.0 + t2 * (1.0 / 720.0) + t2 * t2 * (1.0 / 30240.0)
              + t2 * t2 * t2 * (1.0 / 1209600.0))
    cot_term = torch.where(
        small,
        series,
        (1.0 / (safe * safe)) * (1.0 - (_sinc(safe) / (2.0 * _cosc(safe)))),
    )
    return _eye(3, w) - 0.5 * W + cot_term[..., None, None] * W2


def rotx(theta):
    c, s = cos_rn(theta), sin_rn(theta)
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    return torch.stack(
        [
            torch.stack([one, zero, zero], dim=-1),
            torch.stack([zero, c, -s], dim=-1),
            torch.stack([zero, s, c], dim=-1),
        ],
        dim=-2,
    )


def roty(theta):
    c, s = cos_rn(theta), sin_rn(theta)
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    return torch.stack(
        [
            torch.stack([c, zero, s], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([-s, zero, c], dim=-1),
        ],
        dim=-2,
    )


def rotz(theta):
    c, s = cos_rn(theta), sin_rn(theta)
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
    bottom[..., 0, 3].fill_(1.0)  # a fill: setitem would copy the scalar from the host
    return torch.cat([top, bottom], dim=-2)


def se3_identity(dtype=torch.float64, device=None):
    return torch.eye(4, dtype=dtype, device=device)


def se3_rot(T):
    return T[..., :3, :3]


def se3_trans(T):
    return T[..., :3, 3]


def se3_inv(T):
    R = se3_rot(T)
    t = se3_trans(T)
    Rt = R.transpose(-1, -2)
    return se3_make(Rt, -matvec_small(Rt, t))


def se3_exp(xi):
    """(..., 6) twist [v, w] -> (..., 4, 4)."""
    v = xi[..., :3]
    w = xi[..., 3:]
    R = so3_exp(w)
    J = so3_left_jacobian(w)
    t = matvec_small(J, v)
    return se3_make(R, t)


def se3_log(T):
    """(..., 4, 4) -> (..., 6) twist [v, w]."""
    w = so3_log(T[..., :3, :3])
    Jinv = so3_inv_left_jacobian(w)
    v = matvec_small(Jinv, T[..., :3, 3])
    return torch.cat([v, w], dim=-1)


def se3_adjoint(T):
    """(..., 4, 4) -> (..., 6, 6) adjoint for [v, w]-ordered twists."""
    R = T[..., :3, :3]
    tR = matmul_small(so3_hat(T[..., :3, 3]), R)
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
    T[axis, 3].fill_(d)  # a fill: setitem would copy the scalar from the host
    return T


def se3_inv_left_jacobian(xi):
    """Inverse left Jacobian of SE(3) for [v, w] twists."""
    v = xi[..., :3]
    w = xi[..., 3:]
    Jw_inv = so3_inv_left_jacobian(w)
    Q = _se3_curlyQ(v, w)
    top = torch.cat([Jw_inv, -matmul_small(matmul_small(Jw_inv, Q), Jw_inv)], dim=-1)
    bottom = torch.cat([torch.zeros_like(Jw_inv), Jw_inv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _se3_curlyQ(rho, w):
    """The Q matrix in the SE(3) left Jacobian (Barfoot, eq. 7.86)."""
    th = norm_small(w)
    W = so3_hat(w)
    V = so3_hat(rho)
    WV = matmul_small(W, V)
    VW = matmul_small(V, W)
    WVW = matmul_small(WV, W)
    th2 = th * th
    small = th < _taylor_threshold(th.dtype)
    safe = torch.where(small, torch.ones_like(th), th)
    th4 = th2 * th2
    c2 = _one_minus_sinc_over_sq(th)  # a3 = (th - sin)/th^3, limit 1/6
    # c3 = (th^2/2 + cos - 1)/th^4 = -a4, limit 1/24
    c3 = torch.where(
        small,
        1.0 / 24.0 - th2 * (1.0 / 720.0) + th4 * (1.0 / 40320.0)
        - th4 * th2 * (1.0 / 3628800.0),
        (th2 / 2.0 + cos_rn(safe) - 1.0) / ((safe * safe) * (safe * safe)),
    )
    # c4 = a5 = (th - sin - th^3/6)/th^5, limit -1/120
    c4 = torch.where(
        small,
        -1.0 / 120.0 + th2 * (1.0 / 5040.0) - th4 * (1.0 / 362880.0)
        + th4 * th2 * (1.0 / 39916800.0),
        (safe - sin_rn(safe) - safe * safe * safe * (1.0 / 6.0))
        / ((safe * safe) * (safe * safe) * safe),
    )
    c2 = c2[..., None, None]
    c3 = c3[..., None, None]
    c4 = c4[..., None, None]
    # Q = V/2 + a3(WV+VW+WVW) - a4(W^2V+VW^2-3WVW) - (a4-3a5)/2 (WVW^2+W^2VW)
    return (
        0.5 * V
        + c2 * (WV + VW + WVW)
        + c3 * (matmul_small(W, WV) + matmul_small(VW, W) - 3.0 * WVW)
        + 0.5 * (c3 + 3.0 * c4) * (matmul_small(WVW, W) + matmul_small(W, WVW))
    )


# ---------------------------------------------------------------------------
# SO(2) / SE(2)
# ---------------------------------------------------------------------------

def rot2(theta):
    c, s = cos_rn(theta), sin_rn(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def se2_make(R, t):
    """(..., 2, 2), (..., 2) -> (..., 3, 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (2, 2))
    t = t.expand(batch + (2,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 3), dtype=R.dtype, device=R.device)
    bottom[..., 0, 2].fill_(1.0)  # a fill: setitem would copy the scalar from the host
    return torch.cat([top, bottom], dim=-2)


def se2_identity(dtype=torch.float64, device=None):
    return torch.eye(3, dtype=dtype, device=device)


def se2_rot(T):
    return T[..., :2, :2]


def se2_trans(T):
    return T[..., :2, 2]


def se2_angle(T):
    return atan2_rn(T[..., 1, 0], T[..., 0, 0])


def se2_inv(T):
    Rt = se2_rot(T).transpose(-1, -2)
    return se2_make(Rt, -matvec_small(Rt, se2_trans(T)))


def _se2_v(w):
    """The SE(2) left Jacobian's rotation block [[a, -b], [b, a]]:
    a = sin(w)/w, b = (1 - cos w)/w."""
    return _sinc(w), w * _cosc(w)


def se2_exp(xi):
    """(..., 3) twist [v1, v2, w] -> (..., 3, 3)."""
    v = xi[..., :2]
    w = xi[..., 2]
    a, b = _se2_v(w)
    J = torch.stack([torch.stack([a, -b], dim=-1), torch.stack([b, a], dim=-1)], dim=-2)
    return se2_make(rot2(w), matvec_small(J, v))


def se2_log(T):
    """(..., 3, 3) -> (..., 3) twist [v1, v2, w]."""
    w = se2_angle(T)
    a, b = _se2_v(w)
    det = a * a + b * b
    Jinv = torch.stack([torch.stack([a, b], dim=-1), torch.stack([-b, a], dim=-1)],
                       dim=-2) / det[..., None, None]
    v = matvec_small(Jinv, se2_trans(T))
    return torch.cat([v, w[..., None]], dim=-1)


def se2_log_dangle(w):
    """d/dw of the diagonal of se2_log's inverse Jacobian: its diagonal is
    alpha(w) = (w/2) cot(w/2) and its off-diagonal +-w/2, so this is
    alpha'(w) = (sin w - w) / (2 (1 - cos w)), limit -w/6 at 0."""
    w2 = w * w
    small = w.abs() < _taylor_threshold(w.dtype)
    safe = torch.where(small, torch.ones_like(w), w)
    series = -w * (1.0 / 6.0 + w2 * (1.0 / 180.0) + w2 * w2 * (1.0 / 5040.0)
                   + w2 * w2 * w2 * (1.0 / 151200.0))
    s = sin_rn(safe / 2.0)
    return torch.where(small, series, (sin_rn(safe) - safe) / (4.0 * s * s))


def se2_adjoint(T):
    """(..., 3, 3) -> (..., 3, 3) adjoint for [v, w]-ordered SE(2) twists."""
    t = se2_trans(T)
    col = torch.stack([t[..., 1], -t[..., 0]], dim=-1)
    top = torch.cat([se2_rot(T), col[..., :, None]], dim=-1)
    bottom = torch.zeros(T.shape[:-2] + (1, 3), dtype=T.dtype, device=T.device)
    bottom[..., 0, 2].fill_(1.0)  # a fill: setitem would copy the scalar from the host
    return torch.cat([top, bottom], dim=-2)


def wraptopi(theta):
    """Wrap angles to [-pi, pi)."""
    return torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi
