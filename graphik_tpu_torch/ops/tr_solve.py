"""The batched Riemannian trust-region solve over the compiled edge form.

Port of graphik_tpu/ops/tr_pallas.py (`_tr_kernel`, both its anchor-free
and its has_anchors branch, driven by `solve_tr_pallas`). Three functions:

* `solve_tr_cuda` - wrapper of the hand-written CUDA kernel
  csrc/tr_solve.cu: f32 CUDA tensors only, counts its launches in
  `solve_tr_cuda.launches` and, of those, the anchored ones (the
  obstacle reduction) in `solve_tr_cuda.anchored_launches`. It hands the
  kernel the reach of its anchor skip bound; `kernel_shape` says how the
  kernel is launched.
* `solve_tr_reference` - the plain torch version: a batched transcription
  of `_tr_kernel` with (B,) per-lane masks and `torch.where` freezing, in
  the kernel's statement order; any dtype, any device.
* `solve_tr` - dispatch: the kernel for CUDA tensors (which raises unless
  they are f32), the plain version for CPU tensors. There is no fallback.

Outer loop: rho-regularized trust region, radius /4 or x2 up to Delta_bar,
stops on gradnorm, maxiter, the cost plateau and res_tol. Inner loop:
Steihaug-Toint truncated CG. HVP: the edge-form Hessian, the anchored
terms as 2 (K_u Z_u - sigma_u Z_u) per anchored node u (see csrc/
tr_kernel.cuh), plus the horizontal projection as a reduced 3x3 Lyapunov
Cholesky (scalar for d = 2). Sums over nodes follow the kernel's node
slots past 32 nodes (ops/edge.py lane_sum: lane l adds nodes l, l + 32,
l + 64, ... in order).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graphik_tpu_torch.ops.edge import (
    WARP as _WARP, EdgeProblem, check_kernel_inputs, dot_d, edge_hvp, edge_sum, edge_terms,
    hvp_weights, kernel_edge_tables, kernel_order_tables, lane_sum, scatter)
from graphik_tpu_torch.utils.compiled import cached

# tCG stop reasons (graphik_tpu/ops/tr_pallas.py:41-44)
_NEGATIVE_CURVATURE = 0
_EXCEEDED_TR = 1
_REACHED_TARGET = 2
_MAX_INNER_ITER = 4

# Sizes the kernel build covers (csrc/tr_kernel.cuh kMaxNodes, kMaxEdges,
# kMaxA, kMaxGroupRows): nodes (two a lane past 32, four past 64), edges
# (16 a lane), anchor rows (their tables must fit a block's shared memory
# next to the largest instance's edge tables) and the rows of one anchor
# group (a lane's row masks are 32 bits: 32 rows a lane). The plain
# version takes any size.
MAX_N = 128
MAX_E = 512
_MAX_A = 3072
_MAX_A_R = 1024


def _defaults(N, d, maxinner, mingradnorm, Delta_bar, Delta0, dtype):
    if maxinner is None:
        maxinner = d * N
    if mingradnorm is None:
        mingradnorm = 2e-6 if dtype == torch.float32 else 0.5e-9
    if Delta_bar is None:
        Delta_bar = 10.0 + d
    if Delta0 is None:
        Delta0 = Delta_bar / 8.0
    return maxinner, mingradnorm, Delta_bar, Delta0


def _anchor_nodes(ep: EdgeProblem):
    """The node of each anchor group (rows g * a_R .. (g + 1) * a_R - 1)."""
    return np.argmax(np.asarray(ep.aPsel)[:ep.a_nsel], axis=1)


def solve_tr_reference(
    ep: EdgeProblem,
    Y0,
    dgoal_e,
    *,
    maxiter: int = 3000,
    maxinner: int | None = None,
    mingradnorm: float | None = None,
    kappa: float = 0.1,
    theta: float = 1.0,
    rho_prime: float = 0.1,
    rho_regularization: float = 1e3,
    Delta_bar: float | None = None,
    Delta0: float | None = None,
    mininner: int = 1,
    plateau_every: int = 0,
    plateau_rtol: float = 0.0,
    plateau_atol: float = 0.0,
    res_tol: float = 0.0,
):
    """Plain torch TR solve. Y0: (B, N, d); dgoal_e: (B, E) or (B, Ep).

    Returns dict(Y (B, N, d), cost, gradnorm, iterations, num_inner) in
    Y0's dtype (counters int32).
    """
    B, N, d = Y0.shape
    dt, dev = Y0.dtype, Y0.device
    maxinner, mingradnorm, Delta_bar, Delta0 = _defaults(
        N, d, maxinner, mingradnorm, Delta_bar, Delta0, dt)
    eps = torch.finfo(dt).eps
    E = ep.E
    dg = dgoal_e[:, :E].to(dt)
    # The edge terms, sums and scatter are ops/edge.py's kernel-order plain
    # functions, which follow csrc/edge_warp.cuh's order so that the kernel
    # and this version agree to the last bit: a warp-butterfly sum over 32
    # per-lane partials (lane l holds nodes l, l + 32 and edges l, l + 32,
    # ..., each lane adding its own in that order), sequential sums over
    # the d coordinates, and the scatter C^T w summed per node in ascending
    # edge order.
    kt = cached(ep, ("kernel_order_tables", dt, dev), lambda: kernel_order_tables(ep, dt, dev))
    om, psiL, psiU = kt.om, kt.psiL, kt.psiU

    def inner(a, b):
        return lane_sum(dot_d(a, b))

    def col(x):  # (B,) lane scalar -> broadcastable over (B, N, d)
        return x[:, None, None]

    # Anchor rows, laid out as the kernel's lanes see them: group g's row
    # l + 32 t sits at [g, t, l] (zero-padded past a_R, masked by `avalid`);
    # per-lane partials run over g, then t, and one butterfly sums a group.
    A = ep.A
    if A:
        G, R = ep.a_nsel, ep.a_R
        T = -(-R // _WARP)

        def lanes(x):  # (Ap, ...) rows -> (G, T, 32, ...)
            x = np.asarray(x, np.float64).reshape((G, R) + np.shape(x)[1:])
            out = np.zeros((G, T * _WARP) + x.shape[2:])
            out[:, :R] = x
            return torch.as_tensor(out.reshape((G, T, _WARP) + x.shape[2:]), dtype=dt, device=dev)

        anode, acen, apsiL, apsiU, aLm, aUm, avalid = cached(
            ep, ("anchor_lanes", dt, dev), lambda: (
                torch.as_tensor(_anchor_nodes(ep), dtype=torch.long, device=dev),
                lanes(np.asarray(ep.acenters)[:, :d]),
                *(lanes(x) for x in (ep.apsi_L, ep.apsi_U, ep.aL_mask, ep.aU_mask)),
                lanes(np.ones(A)) > 0))
        zero = torch.zeros((), dtype=dt, device=dev)

        def anchor_terms(Y):  # -> adY (B, G, T, 32, d), a1, a2 (B, G, T, 32)
            adY = Y[:, anode, None, None, :] - acen
            adist = dot_d(adY, adY)
            a1 = torch.where(avalid, aLm * torch.clamp(apsiL - adist, min=0.0), zero)
            a2 = torch.where(avalid, aUm * torch.clamp(adist - apsiU, min=0.0), zero)
            return adY, a1, a2

        def lane_partials(x, groups):  # (B, G, T, 32) -> (B, 32), over g then t
            x = torch.where(avalid, x, zero)
            acc = torch.zeros((x.shape[0], _WARP), dtype=dt, device=dev)
            for g in groups:
                for t in range(T):
                    acc = acc + x[:, g, t]
            return acc

        def group_sum(x):  # (B, G, T, 32) -> (B, G): one butterfly per group
            return torch.stack([lane_sum(lane_partials(x, (g,))) for g in range(G)], dim=1)

    if res_tol > 0.0:
        # per-lane floor of the relative residual: the mean equality-edge
        # squared length
        r_floor = (edge_sum(om * dg) / torch.clamp(edge_sum(om.expand_as(dg)), min=1.0))[:, None]

    def cost_and_grad(Y):
        dY, s0, e1, e2 = edge_terms(kt, Y, dg)
        f = edge_sum(s0 * s0 + e1 * e1 + e2 * e2)
        s = s0 + e1 - e2
        g = scatter(kt, s[..., None] * dY, -2.0)
        if res_tol > 0.0:
            r = s0.abs() / torch.maximum(dg, r_floor)
            r = torch.maximum(r, e1 / torch.maximum(psiL, r_floor))
            r = torch.maximum(r, e2 / torch.maximum(psiU, r_floor))
            rmax = torch.amax(r, dim=-1)
        else:
            rmax = torch.zeros_like(f)
        if A:
            adY, a1, a2 = anchor_terms(Y)
            sa = a1 - a2
            Ga = torch.stack([group_sum(sa * adY[..., k]) for k in range(d)], dim=-1)
            g = g.clone()
            g[:, anode] = g[:, anode] - 2.0 * Ga
            f = f + lane_sum(lane_partials(a1 * a1 + a2 * a2, range(G)))
            if res_tol > 0.0:
                fl = r_floor[:, :, None, None]
                ra = torch.maximum(a1 / torch.maximum(apsiL, fl), a2 / torch.maximum(apsiU, fl))
                ra = torch.where(avalid, ra, zero)
                rmax = torch.maximum(rmax, torch.amax(ra.flatten(1), dim=-1))
        return f, g, rmax

    def make_hvp(Y):
        dY, s0, e1, e2 = edge_terms(kt, Y, dg)
        s, m = hvp_weights(kt, s0, e1, e2)

        def gram(i, j):  # entry (i, j) of Y^T Y, (B,)
            return lane_sum(Y[..., i] * Y[..., j])

        if d == 2:
            x11, x22 = gram(0, 0), gram(1, 1)
            fac = (x11 + x22 + 10.0 * eps * (x11 + x22 + 1e-30),)
        else:
            x11, x22, x33 = gram(0, 0), gram(1, 1), gram(2, 2)
            x12, x13, x23 = gram(0, 1), gram(0, 2), gram(1, 2)
            reg = 10.0 * eps * (x11 + x22 + x33 + 1e-30)
            fac = _chol3(x11 + x22 + reg, x23, -x13, x11 + x33 + reg, x12, x22 + x33 + reg)

        if A:
            # per anchored node u: K_u = sum_r 2 ma_r adY_r adY_r^T (upper
            # triangle) and sigma_u = sum_r sa_r
            adY, a1, a2 = anchor_terms(Y)
            v = 2.0 * (aLm * (a1 > 0).to(dt) + aUm * (a2 > 0).to(dt))
            K = {(i, j): group_sum((v * adY[..., i]) * adY[..., j])
                 for i in range(d) for j in range(i, d)}
            sig = group_sum(a1 - a2)

        def hvp(Z):
            H = edge_hvp(kt, dY, s, m, Z)
            if A:
                Zu = Z[:, anode]
                Kz = []
                for i in range(d):
                    acc = K[min(i, 0), max(i, 0)] * Zu[..., 0]
                    for j in range(1, d):
                        acc = acc + K[min(i, j), max(i, j)] * Zu[..., j]
                    Kz.append(acc - sig * Zu[..., i])
                H = H.clone()
                H[:, anode] = H[:, anode] + 2.0 * torch.stack(Kz, dim=-1)
            return _proj(Y, H, fac, lane_sum)

        return hvp

    def tcg(hvp, grad, Delta, outer_done):
        r = grad
        r_r0 = inner(r, r)
        norm_r0 = torch.sqrt(r_r0)
        pow_r0 = norm_r0 if theta == 1.0 else norm_r0 ** theta
        target = norm_r0 * torch.clamp(pow_r0, max=kappa)
        eta = torch.zeros_like(grad)
        Heta = torch.zeros_like(grad)
        delta = -r
        e_Pe = torch.zeros_like(r_r0)
        e_Pd = torch.zeros_like(r_r0)
        d_Pd = r_r0
        z_r = r_r0
        stop = torch.full_like(r_r0, _MAX_INNER_ITER)
        tdone = outer_done.clone()
        nsteps = torch.zeros_like(r_r0)
        j = 0
        while j < maxinner and not bool(tdone.all()):
            upd = ~tdone
            Hdelta = hvp(delta)
            d_Hd = inner(delta, Hdelta)
            alpha = z_r / d_Hd
            e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd
            Dsq = Delta * Delta
            hit = (d_Hd <= 0) | (e_Pe_new >= Dsq) | ~torch.isfinite(alpha) | ~torch.isfinite(e_Pe_new)
            disc = torch.clamp(e_Pd * e_Pd + d_Pd * (Dsq - e_Pe), min=0.0)
            tau = (-e_Pd + torch.sqrt(disc)) / d_Pd
            stop_b = torch.where(d_Hd <= 0, float(_NEGATIVE_CURVATURE), float(_EXCEEDED_TR))

            new_eta = eta + col(alpha) * delta
            new_Heta = Heta + col(alpha) * Hdelta
            r_new = r + col(alpha) * Hdelta
            r_r = inner(r_new, r_new)
            reached = (j >= mininner) & (torch.sqrt(r_r) <= target)

            beta = r_r / z_r
            delta_new = -r_new + col(beta) * delta
            e_Pd_new = beta * (e_Pd + alpha * d_Pd)
            d_Pd_new = r_r + beta * beta * d_Pd

            take_b = upd & hit
            take_t = upd & ~hit & reached
            eta = torch.where(col(take_b), eta + col(tau) * delta,
                              torch.where(col(upd), new_eta, eta))
            Heta = torch.where(col(take_b), Heta + col(tau) * Hdelta,
                               torch.where(col(upd), new_Heta, Heta))
            stop = torch.where(take_b, stop_b, torch.where(take_t, float(_REACHED_TARGET), stop))
            done_now = take_b | take_t
            tdone = tdone | done_now
            cont = upd & ~done_now
            r = torch.where(col(cont), r_new, r)
            delta = torch.where(col(cont), delta_new, delta)
            e_Pe = torch.where(cont, e_Pe_new, e_Pe)
            e_Pd = torch.where(cont, e_Pd_new, e_Pd)
            d_Pd = torch.where(cont, d_Pd_new, d_Pd)
            z_r = torch.where(cont, r_r, z_r)
            nsteps = nsteps + upd.to(dt)
            j += 1
        return eta, Heta, stop, nsteps

    # ---------------- outer TR loop ----------------
    Y = Y0
    fx, grad, rmax = cost_and_grad(Y)
    norm_g = torch.sqrt(inner(grad, grad))
    done = norm_g < mingradnorm
    if res_tol > 0.0:
        done = done | (rmax < res_tol)
    Delta = torch.full_like(fx, Delta0)
    iters = torch.zeros_like(fx)
    ninner = torch.zeros_like(fx)
    fx_ref = fx
    k = 0
    while k < maxiter and not bool(done.all()):
        upd = ~done
        eta, Heta, stop, nsteps = tcg(make_hvp(Y), grad, Delta, done)
        Y_prop = Y + eta
        fx_prop, g_prop, rmax_prop = cost_and_grad(Y_prop)

        rho_reg = torch.clamp(fx.abs(), min=1.0) * eps * rho_regularization
        rhonum = fx - fx_prop + rho_reg
        rhoden = -inner(grad, eta) - 0.5 * inner(eta, Heta) + rho_reg
        model_decreased = rhoden >= 0.0
        rho = rhonum / rhoden
        shrink = (rho < 0.25) | ~model_decreased | torch.isnan(rho)
        grow = ~shrink & (rho > 0.75) & ((stop == _NEGATIVE_CURVATURE) | (stop == _EXCEEDED_TR))
        Delta_new = torch.where(
            shrink, Delta / 4.0,
            torch.where(grow, torch.clamp(2.0 * Delta, max=Delta_bar), Delta))

        take = upd & model_decreased & (rho > rho_prime)
        Y = torch.where(col(take), Y_prop, Y)
        fx = torch.where(take, fx_prop, fx)
        grad = torch.where(col(take), g_prop, grad)
        norm_g = torch.where(take, torch.sqrt(inner(g_prop, g_prop)), norm_g)
        Delta = torch.where(upd, Delta_new, Delta)
        done_new = done | (upd & (norm_g < mingradnorm))
        if res_tol > 0.0:
            rmax = torch.where(take, rmax_prop, rmax)
            done_new = done_new | (upd & (rmax < res_tol))
        if plateau_every and (k + 1) % plateau_every == 0:
            stalled = (fx_ref - fx) <= (plateau_rtol * fx + plateau_atol)
            done_new = done_new | (upd & stalled)
            fx_ref = fx
        done = done_new
        iters = iters + upd.to(dt)
        ninner = ninner + torch.where(upd, nsteps, torch.zeros_like(nsteps))
        k += 1

    return {
        "Y": Y,
        "cost": fx,
        "gradnorm": norm_g,
        "iterations": iters.to(torch.int32),
        "num_inner": ninner.to(torch.int32),
    }


def _chol3(m11, m12, m13, m22, m23, m33):
    """Unrolled 3x3 Cholesky over (B,) lane scalars."""
    l11 = torch.sqrt(torch.clamp(m11, min=1e-30))
    l21 = m12 / l11
    l31 = m13 / l11
    l22 = torch.sqrt(torch.clamp(m22 - l21 * l21, min=1e-30))
    l32 = (m23 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(m33 - l31 * l31 - l32 * l32, min=1e-30))
    return l11, l21, l31, l22, l32, l33


def _proj(Y, H, fac, node_sum):
    """Horizontal projection H - Y Om, Om antisymmetric from the reduced
    Lyapunov system factored in `fac`; node_sum reduces (B, N) -> (B,)."""
    Y0, Y1 = Y[..., 0], Y[..., 1]
    H0, H1 = H[..., 0], H[..., 1]
    c12 = node_sum(Y0 * H1 - H0 * Y1)
    if Y.shape[-1] == 2:
        a = (c12 / fac[0])[:, None]
        return torch.stack([H0 + a * Y1, H1 - a * Y0], dim=-1)
    Y2, H2 = Y[..., 2], H[..., 2]
    c13 = node_sum(Y0 * H2 - H0 * Y2)
    c23 = node_sum(Y1 * H2 - H1 * Y2)
    l11, l21, l31, l22, l32, l33 = fac
    y1 = c12 / l11
    y2 = (c13 - l21 * y1) / l22
    y3 = (c23 - l31 * y1 - l32 * y2) / l33
    c = y3 / l33
    b = (y2 - l32 * c) / l22
    a = (y1 - l21 * b - l31 * c) / l11
    a, b, c = a[:, None], b[:, None], c[:, None]
    # Om = [[0, a, b], [-a, 0, c], [-b, -c, 0]]; P = H - Y Om
    return torch.stack(
        [H0 + a * Y1 + b * Y2, H1 - a * Y0 + c * Y2, H2 - b * Y0 - c * Y1], dim=-1)


def _anchor_near(ep: EdgeProblem) -> float:
    """The reach of the kernel's anchor skip bound: the least hinge radius
    sqrt(psi) over the rows that have a hinge (the table scene: its spheres'
    0.1 m), or 0 (every row evaluated) when there is none."""
    if not ep.A:
        return 0.0
    radii = np.concatenate([np.sqrt(np.asarray(psi, np.float64))[np.asarray(mask) != 0]
                            for psi, mask in ((ep.apsi_L, ep.aL_mask), (ep.apsi_U, ep.aU_mask))])
    return float(radii.min()) if radii.size else 0.0


def _anchor_tables(ep: EdgeProblem, device):
    """Anchor centers (d, A), parameters (4, A) and group nodes (a_nsel,)
    as device tensors for the kernel (one-element dummies when A == 0)."""
    if not ep.A:
        return (torch.zeros(1, dtype=torch.float32, device=device),
                torch.zeros(1, dtype=torch.float32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
    cen = np.ascontiguousarray(np.asarray(ep.acenters)[:, :ep.dim].T)
    par = np.stack([ep.apsi_L, ep.apsi_U, ep.aL_mask, ep.aU_mask])
    return (torch.as_tensor(cen, dtype=torch.float32, device=device),
            torch.as_tensor(par, dtype=torch.float32, device=device),
            torch.as_tensor(_anchor_nodes(ep).astype(np.int32), device=device))


def kernel_tables(ep: EdgeProblem, device):
    """The TR kernel's tables on `device` - `kernel_edge_tables` (edge
    list, packed parameters, incidence CSR), `_anchor_tables` and the
    anchor skip's reach `_anchor_near` - built on the first call for this
    (EdgeProblem, device) and the same on every later one: a launch copies
    nothing from the host, so it can be captured in a CUDA graph."""
    return cached(ep, ("tr_kernel_tables", torch.device(device)),
                  lambda: (*kernel_edge_tables(ep, device), *_anchor_tables(ep, device),
                           _anchor_near(ep)))


def check_limits(ep: EdgeProblem):
    """Raise, naming the limit, unless the kernel build takes `ep`'s sizes."""
    if ep.N > MAX_N or not 0 < ep.E <= MAX_E:
        raise ValueError(f"the TR kernel takes N <= {MAX_N} and 0 < E <= {MAX_E}, "
                         f"not N = {ep.N}, E = {ep.E}")
    if ep.A > _MAX_A or ep.a_R > _MAX_A_R or (ep.A and ep.a_nsel * ep.a_R != ep.A):
        raise ValueError(f"unsupported anchor layout: the TR kernel takes A <= {_MAX_A} rows "
                         f"in groups of a_R <= {_MAX_A_R}, not A = {ep.A}, "
                         f"a_nsel = {ep.a_nsel}, a_R = {ep.a_R}")


def solve_tr_cuda(
    ep: EdgeProblem,
    Y0,
    dgoal_e,
    *,
    maxiter: int = 3000,
    maxinner: int | None = None,
    mingradnorm: float | None = None,
    kappa: float = 0.1,
    theta: float = 1.0,
    rho_prime: float = 0.1,
    rho_regularization: float = 1e3,
    Delta_bar: float | None = None,
    Delta0: float | None = None,
    mininner: int = 1,
    plateau_every: int = 0,
    plateau_rtol: float = 0.0,
    plateau_atol: float = 0.0,
    res_tol: float = 0.0,
):
    """Launch csrc/tr_solve.cu on f32 CUDA tensors; same contract as
    `solve_tr_reference`. Raises on anything the kernel does not take."""
    check_limits(ep)
    check_kernel_inputs("the TR kernel", ep, (Y0,), dgoal_e, MAX_N, MAX_E)
    B, N, d = Y0.shape
    E = ep.E
    maxinner, mingradnorm, Delta_bar, Delta0 = _defaults(
        N, d, maxinner, mingradnorm, Delta_bar, Delta0, torch.float32)

    dev = Y0.device
    out = {
        "Y": torch.empty_like(Y0),
        "cost": torch.empty(B, dtype=torch.float32, device=dev),
        "gradnorm": torch.empty(B, dtype=torch.float32, device=dev),
        "iterations": torch.empty(B, dtype=torch.int32, device=dev),
        "num_inner": torch.empty(B, dtype=torch.int32, device=dev),
    }
    if B == 0:
        return out
    from graphik_tpu_torch.ops._build import load_library

    lib = load_library()
    ei, ej, epar, rowptr, inc, acen, apar, anode, anchor_near = kernel_tables(ep, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = lib.graphik_tr_solve(
            Y0.data_ptr(), dgoal_e.data_ptr(), dgoal_e.shape[1],
            ei.data_ptr(), ej.data_ptr(), epar.data_ptr(), rowptr.data_ptr(), inc.data_ptr(),
            acen.data_ptr(), apar.data_ptr(), anode.data_ptr(),
            out["Y"].data_ptr(), out["cost"].data_ptr(), out["gradnorm"].data_ptr(),
            out["iterations"].data_ptr(), out["num_inner"].data_ptr(),
            B, N, d, E, ep.A, ep.a_nsel, ep.a_R,
            int(maxiter), int(maxinner), int(mininner), int(plateau_every),
            float(mingradnorm), float(kappa), float(theta), float(rho_prime),
            float(rho_regularization), float(Delta_bar), float(Delta0),
            float(plateau_rtol), float(plateau_atol), float(res_tol), anchor_near,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"TR kernel launch failed: cudaError {rc}")
    solve_tr_cuda.launches += 1
    if ep.A:
        solve_tr_cuda.anchored_launches += 1
    return out


solve_tr_cuda.launches = 0
solve_tr_cuda.anchored_launches = 0


def kernel_shape(ep: EdgeProblem, B: int, d: int) -> dict:
    """The launch shape `solve_tr_cuda` uses for B instances of `ep` on the
    current card: blocks launched, blocks resident on the card at once,
    instances per block (one per warp, or two when they share a warp) and
    whether they share one. Needs the card (it builds the library)."""
    from graphik_tpu_torch.ops._build import load_library

    info = (ctypes.c_int * 4)()
    rc = load_library().graphik_tr_shape(B, ep.N, d, ep.E, ep.A, ep.a_nsel, ep.a_R, info)
    if rc != 0:
        raise RuntimeError(f"TR kernel shape query failed: cudaError {rc}")
    return {"blocks": info[0], "blocks_resident": info[1], "instances_per_block": info[2],
            "two_per_warp": bool(info[3])}


def solve_tr(ep: EdgeProblem, Y0, dgoal_e, **kwargs):
    """The kernel for CUDA tensors (f32 only - anything else raises), the
    plain version for CPU tensors."""
    if Y0.device.type == "cuda":
        return solve_tr_cuda(ep, Y0, dgoal_e, **kwargs)
    return solve_tr_reference(ep, Y0, dgoal_e, **kwargs)
