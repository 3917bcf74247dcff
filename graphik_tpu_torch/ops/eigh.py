"""K5: the batched symmetric eigendecomposition of small matrices (n <= 128
on a card, any n on the CPU).

The JAX package calls jnp.linalg.eigh inside its jitted prepare stage
(graphik_tpu/utils/dgp.py, the MDS init) and inside CIDGIK's Fantope step
and eigh cone projection. torch.linalg.eigh checks its `info` on the host,
so on a card it synchronises and cannot be captured into a CUDA graph. The
port's eigendecompositions go through this module instead:

* `sym_eigh_cuda(A)` - wrapper of the hand-written CUDA kernel csrc/eigh.cu
  (cyclic Jacobi, a lane a rotation pair: m/2 lanes a matrix, m = n rounded
  up to even, one kernel instance per m and type; A's rows in registers,
  past n = 32 (csrc/eigh_wide.cuh) with V^T in shared memory and, where
  the rows would not fit, a matrix's columns split over two warps; past
  n = 64 (csrc/eigh_block.cu) a block a matrix, two pairs a lane, the
  columns split over its warps, one kernel a type for every m): float32 or float64 CUDA tensors,
  n <= 128; counts its launches in `sym_eigh_cuda.launches`.
  Returns (eigenvalues, eigenvectors, converged), the flags on the device.
* `sym_eigh_reference(A)` - the plain torch version: the kernel's Jacobi
  step for step (the same pairs, rotations, stop test, sort and sign), on
  any device and at any n. On a card its results are the kernel's bit for bit (torch's
  CUDA sqrt and division are correctly rounded, as the kernel's are; its
  CPU sqrt is not always, so CPU results may differ from the card's in the
  last bit).
* `sym_eigh(A)` - (eigenvalues, eigenvectors): the kernel for CUDA tensors,
  the plain version for CPU tensors. On a card it raises for n > 128, and
  anywhere for another dtype, or when the build or the launch fails; it
  never falls back.

The contract is torch.linalg.eigh's on a stack (..., n, n): eigenvalues
ascending (ties in index order, NaN last), the orthonormal eigenvectors as
columns. Only the lower triangle is read (torch.linalg.eigh's default);
nothing is symmetrised, so the callers keep their own symmetrisation. Each
eigenvector's entry of largest magnitude (the first on a tie) is made
positive: a convention of this module, not LAPACK's, so compare Grams or
projectors with another eigh, never V.

The algorithm (csrc/eigh.cu has the details): thr = eps * max |a_ij|;
sweeps of m - 1 round-robin steps (m = n rounded up to even), each
applying m / 2 disjoint rotations, a pair rotating only when |a_pq| > thr
and every pair's a_pq set to 0 after the step; a matrix stops once every
|a_pq| <= thr at the start of a sweep (converged) or after MAX_SWEEPS
sweeps (not converged). For finite inputs; a NaN gives an unconverged
matrix.
"""

from __future__ import annotations

import functools
from typing import List

import torch

# the largest n the kernel takes (a lane a rotation pair up to 64, two
# pairs a lane of a block's warps up to 128)
MAX_N = 128
# sweeps before a matrix stops unconverged (csrc/eigh.cu kMaxSweeps)
MAX_SWEEPS = 30


def _check(A, max_n=None):
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sym_eigh takes float32 or float64, not {A.dtype}")
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"sym_eigh takes a stack of square matrices, not {tuple(A.shape)}")
    if max_n is not None and A.shape[-1] > max_n:
        raise ValueError(f"sym_eigh's kernel takes n <= {max_n}, not n = {A.shape[-1]}")


def _empty(A, batch, n):
    return (A.new_empty(batch + (n,)), A.new_empty(batch + (n, n)),
            torch.ones(batch, dtype=torch.bool, device=A.device))


def sym_eigh_cuda(A):
    """csrc/eigh.cu on a float32 / float64 CUDA stack A (..., n, n), n <=
    128: (eigenvalues (..., n), eigenvectors (..., n, n), converged (...)
    bool), all on A's device; one launch, added to
    `sym_eigh_cuda.launches`."""
    _check(A, MAX_N)
    if A.device.type != "cuda":
        raise ValueError(f"sym_eigh_cuda takes a CUDA tensor, not one on {A.device}")
    batch, n = A.shape[:-2], A.shape[-1]
    Af = A.reshape(-1, n, n).contiguous()
    B = Af.shape[0]
    if B == 0 or n == 0:
        return _empty(A, batch, n)
    from graphik_tpu_torch.ops._build import load_library

    lib = load_library()
    w = torch.empty((B, n), dtype=A.dtype, device=A.device)
    V = torch.empty((B, n, n), dtype=A.dtype, device=A.device)
    conv = torch.empty((B,), dtype=torch.int32, device=A.device)
    with torch.cuda.device(A.device):  # the launch goes to the current device
        rc = lib.graphik_sym_eigh(Af.data_ptr(), w.data_ptr(), V.data_ptr(), conv.data_ptr(),
                                  B, n, int(A.dtype == torch.float64),
                                  torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eigh kernel launch failed: cudaError {rc}")
    sym_eigh_cuda.launches += 1
    return w.reshape(batch + (n,)), V.reshape(batch + (n, n)), (conv != 0).reshape(batch)


sym_eigh_cuda.launches = 0


class _Plan:
    """The index tables of the plain version for one n on one device.

    The plain version keeps a state S (B, 2m, m): A's rows on top, V's
    below, in the layout of the current step - A's rows and columns and
    V's columns ordered [p_0 .. p_{h-1}, q_0 .. q_{h-1}] by that step's
    pairs, V's rows in index order - so that each step's rotations act on
    two contiguous halves. A permutation is exact, so every entry carries
    the kernel's value."""

    def __init__(self, n, device):
        m = n + (n & 1)
        r, h = m - 1, m // 2
        orders = []
        for s in range(r):
            pairs = [(s, r) if k == 0 else ((s + k) % r, (s - k + r) % r) for k in range(h)]
            orders.append([min(a, b) for a, b in pairs] + [max(a, b) for a, b in pairs])

        def gather(src, dst):  # flat indices taking a state from layout src to dst
            pos = [src.index(i) for i in dst]
            return torch.tensor([[row * m + col for row in pos + list(range(m, 2 * m))
                                  for col in pos]], device=device)

        natural = list(range(m))
        self.m, self.h = m, h
        self.into = gather(natural, orders[0])
        self.steps = [gather(orders[s], orders[(s + 1) % r]) for s in range(r)]
        self.back = gather(orders[0], natural)
        # entries (a, b) of layout 0 that the stop test skips: not p < q
        self.skip = torch.tensor([[not orders[0][a] < orders[0][b] for b in range(m)]
                                  for a in range(m)], device=device)
        self.lower = torch.ones((n, n), dtype=torch.bool, device=device).tril()
        self.before_index = torch.arange(n, device=device)[None, :] < torch.arange(
            n, device=device)[:, None]  # [i, j]: j < i


@functools.lru_cache(maxsize=None)
def _plan(n, device):
    return _Plan(n, device)


def _sweep(S, thr, steps: List[torch.Tensor], m: int, h: int):
    """The m - 1 steps of one sweep on the states S (B, 2m, m), layout 0
    in, layout 0 out, with the matrices' thresholds thr (B, 1) and each
    step's gather into the next layout. The plain version is bound by the
    count of operators it issues, not by their work: each operator writes
    into a buffer allocated once a sweep."""
    B = S.shape[0]
    S = S.clone()
    S2, T = torch.empty_like(S), torch.empty_like(S)
    R, U = S.new_empty([B, h, m]), S.new_empty([B, 2 * m, h])
    th, t, c, s, tmp = (S.new_empty([B, h]), S.new_empty([B, h]), S.new_empty([B, h]),
                        S.new_empty([B, h]), S.new_empty([B, h]))
    rot = torch.empty([B, h], dtype=torch.bool, device=S.device)
    zero = S.new_zeros([])
    fix = S.new_zeros([B, 2, 2, h])  # each pair's new 2x2 block
    d0, d1 = fix[:, 0, 0], fix[:, 1, 1]
    cr, sr, cc, sc = c[:, :, None], s[:, :, None], c[:, None, :], s[:, None, :]
    A = S[:, :m]
    app, apq, aqq = (A[:, :h, :h].diagonal(0, 1, 2), A[:, :h, h:].diagonal(0, 1, 2),
                     A[:, h:, h:].diagonal(0, 1, 2))
    AP, AQ, TP, TQ, VS, VT = A[:, :h], A[:, h:], T[:, :h], T[:, h:m], S[:, m:], T[:, m:]
    CP, CQ, OP, OQ = T[:, :, :h], T[:, :, h:], S2[:, :, :h], S2[:, :, h:]
    blk = S2[:, :m].view([B, 2, h, 2, h]).diagonal(0, 2, 4)
    flat, flat2 = S.view([B, -1]), S2.view([B, -1])
    for to_next in steps:
        # the rotation of each pair (|a_pq| > thr), else c = 1, s = t = 0
        torch.abs(apq, out=tmp)
        torch.gt(tmp, thr, out=rot)
        torch.sub(aqq, app, out=th)
        torch.add(apq, apq, out=tmp)
        th.div_(tmp)
        torch.abs(th, out=tmp)
        torch.mul(tmp, tmp, out=t)
        t.add_(1.0).sqrt_().add_(tmp).reciprocal_().copysign_(th)
        torch.where(rot, t, zero, out=t)
        torch.mul(t, t, out=c)
        c.add_(1.0).sqrt_().reciprocal_()
        torch.mul(t, c, out=s)
        torch.mul(t, apq, out=tmp)
        torch.sub(app, tmp, out=d0)
        torch.add(aqq, tmp, out=d1)
        # rows p, q of A (into T; V's rows copied), then columns p, q of A
        # and V (into S2), the pairs' blocks, and the next step's layout
        torch.mul(cr, AP, out=TP)
        torch.mul(sr, AQ, out=R)
        TP.sub_(R)
        torch.mul(sr, AP, out=TQ)
        torch.mul(cr, AQ, out=R)
        TQ.add_(R)
        VT.copy_(VS)
        torch.mul(cc, CP, out=OP)
        torch.mul(sc, CQ, out=U)
        OP.sub_(U)
        torch.mul(sc, CP, out=OQ)
        torch.mul(cc, CQ, out=U)
        OQ.add_(U)
        blk.copy_(fix)
        torch.gather(flat2, 1, to_next, out=flat)
    return S


@functools.cache
def _scripted_sweep():
    return torch.jit.script(_sweep)


def sym_eigh_reference(A, sweeps=False):
    """The plain torch version of csrc/eigh.cu on A (..., n, n), float32
    or float64, any n, any device: (eigenvalues (..., n), eigenvectors
    (..., n, n), converged (...) bool), the kernel's results step for
    step; with `sweeps`, also the sweeps each matrix ran (...) int64."""
    _check(A)
    batch, n = A.shape[:-2], A.shape[-1]
    dt, dev = A.dtype, A.device
    A = A.reshape(-1, n, n)
    B = A.shape[0]
    if B == 0 or n == 0:
        out = _empty(A, batch, n)
        return out + (torch.zeros(batch, dtype=torch.int64, device=dev),) if sweeps else out
    plan = _plan(n, dev)
    m, h = plan.m, plan.h
    A = torch.where(plan.lower, A, A.transpose(-1, -2))  # the lower triangle, mirrored
    thr = (torch.finfo(dt).eps * A.abs().amax(dim=(-2, -1)))[:, None]
    if m != n:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    S = torch.cat((A, torch.eye(m, dtype=dt, device=dev).expand(B, m, m)), 1)
    S = S.reshape(B, -1).gather(1, plan.into.expand(B, -1)).view(B, 2 * m, m)
    # on the CPU the sweep runs through TorchScript's interpreter: the same
    # operators, issued without Python's overhead (the CPU's plain version
    # is bound by that overhead); on a card, eagerly, so that no fuser
    # touches the arithmetic the kernel is held to
    sweep = _scripted_sweep() if dev.type == "cpu" else _sweep
    ran = torch.zeros(B, dtype=torch.int64, device=dev)
    for k in range(MAX_SWEEPS + 1):
        # the stop test of each matrix, on its state at the start of the sweep
        conv = ((S[:, :m].abs() <= thr[:, :, None]) | plan.skip).flatten(1).all(1)
        live = (~conv).nonzero()[:, 0]
        if k == MAX_SWEEPS or live.numel() == 0:
            break
        ran += ~conv
        # a matrix that stopped does no more steps, as in the kernel
        sub, sub_thr = (S, thr) if live.numel() == B else (S[live], thr[live])
        with torch.inference_mode():
            sub = sweep(sub, sub_thr, [i.expand(len(live), -1) for i in plan.steps], m, h)
        S = sub if live.numel() == B else S.index_copy(0, live, sub)
    S = S.reshape(B, -1).gather(1, plan.back.expand(B, -1)).view(B, 2 * m, m)
    d = S[:, :m].diagonal(0, 1, 2)[:, :n]
    V = S[:, m:m + n, :n]
    # sign: each column's first entry of largest magnitude made positive
    x = V.abs()
    at = (x == x.amax(1, keepdim=True)).to(torch.uint8).argmax(1, keepdim=True)
    V = torch.where(V.gather(1, at) < 0, -V, V)
    # rank of each eigenvalue: ascending, NaN last, ties in index order
    dj, di = d[:, None, :], d[:, :, None]
    nj, ni = dj != dj, di != di
    earlier = plan.before_index
    before = torch.where(nj != ni, ni, torch.where(nj, earlier, (dj < di) | ((dj == di) & earlier)))
    rank = before.sum(-1)
    w = torch.empty_like(d).scatter_(1, rank, d)
    V = torch.empty_like(V).scatter_(2, rank[:, None, :].expand(B, n, n), V)
    out = w.reshape(batch + (n,)), V.reshape(batch + (n, n)), conv.reshape(batch)
    return out + (ran.reshape(batch),) if sweeps else out


def sym_eigh(A):
    """(eigenvalues ascending, eigenvectors as columns) of the symmetric
    stack A (..., n, n), float32 or float64, from its lower triangle:
    csrc/eigh.cu for a CUDA tensor (n <= 128), the plain version for a CPU
    one (any n). The converged flags stay on the device (sym_eigh_cuda /
    sym_eigh_reference return them)."""
    if A.device.type == "cuda":
        w, V, _ = sym_eigh_cuda(A)
    else:
        w, V, _ = sym_eigh_reference(A)
    return w, V
