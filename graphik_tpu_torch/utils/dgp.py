"""Distance-geometry core: Gram <-> EDM <-> positions, MDS, bound smoothing.

Port of graphik_tpu/utils/dgp.py. All
functions broadcast over leading batch dims. Eigendecompositions go
through ops/eigh.py::sym_eigh (K5, a hand-written Jacobi kernel, on a card;
its plain version on the CPU), which reads the lower triangle and never
reads the host, so prepare runs inside a CUDA graph; the JAX package's
fixed-sweep Jacobi and subspace iterations are TPU workarounds and are not
ported.

Distance matrices ``D`` hold *squared* distances; bound matrices
``lb``/``ub`` hold *unsquared* distances.
"""

from __future__ import annotations

import math

import torch

from graphik_tpu_torch.ops.eigh import sym_eigh
from graphik_tpu_torch.utils import lie

# Sentinel for "no edge" in min-plus shortest paths. Large but far from
# overflow so sums of two stay representable in float32.
BIG = 1e9


# ---------------------------------------------------------------------------
# Gram / EDM / positions
# ---------------------------------------------------------------------------

def gram_from_distance_matrix(D):
    """Double-centered Gram matrix from a squared EDM.

    The whole mean is the mean of the row means: a reduction over the
    merged (N, N) extent rounds, on a card, by each matrix's address (torch
    vectorises the loads of a contiguous extent past 128 elements and
    starts each at its own misalignment), so a goal's start would depend on
    its batch position; a row holds N <= 128 values and is summed in one
    order wherever it sits."""
    row = D.mean(dim=-1, keepdim=True)
    col = D.mean(dim=-2, keepdim=True)
    tot = row.mean(dim=-2, keepdim=True)
    return -0.5 * (D - row - col + tot)


def distance_matrix_from_gram(X):
    """Squared EDM from a Gram matrix."""
    d = torch.diagonal(X, dim1=-2, dim2=-1)
    return d[..., :, None] + d[..., None, :] - 2.0 * X


def distance_matrix_from_pos(Y):
    """Squared EDM of an (..., N, d) point set."""
    return distance_matrix_from_gram(Y @ Y.transpose(-1, -2))


def pair_distances(Y, i, j):
    """Squared distances of the point pairs (i[p], j[p]) of an (..., N, d)
    point set, (..., P): each the entry of distance_matrix_from_pos,
    |p_i|^2 + |p_j|^2 - 2 p_i . p_j from the Gram, with the Gram's dots
    rounded as lie.matmul_small rounds (the JAX package's einsum on the CPU,
    on every device), and only the pairs asked for."""
    Yi, Yj = Y[..., i, :], Y[..., j, :]
    return (lie.dot_small(Yi, Yi) + lie.dot_small(Yj, Yj)) - 2.0 * lie.dot_small(Yi, Yj)


# ---------------------------------------------------------------------------
# Spectral factorization / MDS init
# ---------------------------------------------------------------------------

def factor_psd(A, eps=0.0):
    """Return X with XX^T ~= closest-PSD(A), eigenvalues in descending order.

    Eigendecompose, clamp eigenvalues <= eps to 0, scale eigenvectors by
    sqrt(eigval), order columns by descending eigenvalue; all N columns are
    kept (trailing ones are ~0).
    """
    evals, evecs = sym_eigh(A)  # ascending
    evals = torch.where(evals > eps, evals, torch.zeros_like(evals))
    X = evecs * torch.sqrt(evals)[..., None, :]
    return torch.flip(X, dims=(-1,))


def mds(B, eps=1e-8):
    """Classic multidimensional scaling of a Gram matrix."""
    return factor_psd(B, eps=eps)


def edge_scatter(P, F):
    """S = sum over nonzero (i, j) of F of outer(P_i - P_j), for points P
    (..., N, k) and a dense (N, N) mask F."""
    mask = (F != 0).to(P.dtype)
    deg_i = mask.sum(dim=-1)  # (..., N)
    deg_j = mask.sum(dim=-2)
    PtP_i = torch.einsum("...i,...ik,...il->...kl", deg_i, P, P)
    PtP_j = torch.einsum("...j,...jk,...jl->...kl", deg_j, P, P)
    cross = torch.einsum("...ij,...ik,...jl->...kl", mask, P, P)
    return PtP_i + PtP_j - cross - cross.transpose(-1, -2)


def top_basis(S, dim):
    """The eigenvectors of the `dim` largest eigenvalues of S, largest
    first: (..., k, dim)."""
    _, eigvec = sym_eigh(S)  # ascending
    return torch.flip(eigvec, dims=(-1,))[..., :, :dim]


def linear_projection(P, F, dim):
    """Project points onto the dominant `dim`-dim subspace of the edge scatter.

    S = sum over nonzero (i, j) of F of outer(P_i - P_j); P is projected
    onto the top-`dim` eigenvectors of S. `F` is a dense (N, N) mask.
    """
    return P @ top_basis(edge_scatter(P, F), dim)


def sample_distance_matrix(lb, ub, generator=None, frac=None):
    """Squared EDM inside [lb, ub]: D = (lb + frac (ub - lb))^2.

    With no `generator` and no `frac` this is the deterministic
    initialization of the Riemannian solver, frac = 0.9. With a
    `torch.Generator`, frac is uniform in [0, 1), one draw per entry of
    lb.shape (made on the generator's device, then moved to lb's): D is then
    not symmetric. A given `frac` (float or tensor) is used as it is.
    """
    if generator is not None:
        frac = draw_fractions(lb.shape, lb.dtype, lb.device, generator)
    elif frac is None:
        frac = 0.9
    return (lb + frac * (ub - lb)) ** 2


def draw_fractions(shape, dtype, device, generator):
    """Interpolation fractions uniform in [0, 1), one per entry of
    `shape`, drawn on the generator's device and then moved to `device`:
    the draw of `sample_distance_matrix`. A copy from the CPU cannot be
    captured into a CUDA graph, so a captured stage takes them drawn."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=generator.device).to(device)


def best_fit_transform(A, B):
    """Least-squares rigid transform (R, t) with B ~= R A + t, for (..., n,
    dim) point sets. Like the JAX package's, it does not correct the det < 0
    reflection case: the planar joint recovery depends on that.

    At dim = 2 it takes the closed form of the SVD's R = V U^T, with no
    SVD (which synchronises with the host on a card): R maximises tr(R H)
    over O(2), H the cross-covariance; a rotation by atan2(H01 - H10, H00 +
    H11) reaches |(H00 + H11, H01 - H10)| and a reflection [[c, s], [s, -c]]
    at atan2(H01 + H10, H00 - H11) reaches |(H00 - H11, H01 + H10)|, and the
    squares of the two differ by 4 det H, so the SVD's R is the rotation
    when det H > 0 and the reflection when det H < 0."""
    ca = lie.mean_small(A, -2, keepdim=True)
    cb = lie.mean_small(B, -2, keepdim=True)
    H = lie.matmul_small((A - ca).transpose(-1, -2), B - cb)
    if A.shape[-1] == 2:
        h00, h01, h10, h11 = H[..., 0, 0], H[..., 0, 1], H[..., 1, 0], H[..., 1, 1]
        rot = h00 * h11 - h01 * h10 >= 0
        ang = torch.where(rot, lie.atan2_rn(h01 - h10, h00 + h11),
                          lie.atan2_rn(h01 + h10, h00 - h11))
        c, s = lie.cos_rn(ang), lie.sin_rn(ang)
        R = torch.stack([torch.stack([c, torch.where(rot, -s, s)], dim=-1),
                         torch.stack([s, torch.where(rot, c, -c)], dim=-1)], dim=-2)
    else:
        U, _, Vt = torch.linalg.svd(H)
        R = Vt.transpose(-1, -2) @ U.transpose(-1, -2)
    t = cb[..., 0, :] - lie.matvec_small(R, ca[..., 0, :])
    return R, t


def procrustes_align(X, Y):
    """Rigidly align point set X onto Y; returns the transformed X."""
    R, t = best_fit_transform(X, Y)
    return torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]


def normalize_positions(Y):
    """Center points and rotate them into their principal axes (the
    eigenvectors of their scatter, in eigh's ascending order)."""
    Yc = Y - Y.mean(dim=-2, keepdim=True)
    C = Yc.transpose(-1, -2) @ Yc
    _, v = sym_eigh(0.5 * (C + C.transpose(-1, -2)))  # sym_eigh reads one triangle
    return Yc @ v


# ---------------------------------------------------------------------------
# Bound smoothing (triangle-inequality propagation)
# ---------------------------------------------------------------------------

# Most elements a min-plus product's broadcast sum may hold at once (2^27:
# 0.5 GB in float32). Larger products are taken in slices of the leading
# batch dim: on the table scene at B = 8192 one unsliced product would hold
# (B, 16, 100, 100) floats, 5.2 GB.
MINPLUS_ELEMS = 1 << 27


def _minplus(A, B):
    """Min-plus (tropical) product C_ij = min_k A_ik + B_kj, as a broadcast
    min over a (..., N, K, P) sum, sliced over the leading batch dim so
    that no sum holds more than MINPLUS_ELEMS elements."""
    M, K = A.shape[-2:]
    P = B.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    per = math.prod(batch[1:]) * M * K * P
    if not batch or batch[0] * per <= MINPLUS_ELEMS:
        return torch.amin(A[..., :, :, None] + B[..., None, :, :], dim=-2)
    A = A.expand(batch + (M, K))
    B = B.expand(batch + (K, P))
    step = max(1, MINPLUS_ELEMS // per)
    return torch.cat([
        torch.amin(A[i:i + step, ..., :, :, None] + B[i:i + step, ..., None, :, :], dim=-2)
        for i in range(0, batch[0], step)
    ])


def _minplus_closure(A, n_iter):
    """Shortest-path closure of A (zero diagonal) via repeated squaring."""
    for _ in range(n_iter):
        A = torch.minimum(A, _minplus(A, A))
    return A


def bound_smoothing(L, U, edge_mask, n_iter=None):
    """Propagate distance bounds through the doubled (bipartite) graph.

    With A_uv = U(u, v), B_uv = -L(u, v) (zero diagonals, BIG off-edge),
    every original->shadow path crosses the B block once, so
    upper = A* (min-plus closure) and lower = max(0, -(A* x B x A*)).
    Partial closures (smaller n_iter) remain valid, looser bounds.

    L, U : (..., N, N) unsquared bounds; edge_mask : (..., N, N) bool.
    Returns (lb, ub), zero diagonal.
    """
    n = L.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=L.device)
    big = torch.full_like(L, BIG)
    zero = torch.zeros_like(L)

    A = torch.where(eye, zero, torch.where(edge_mask, U, big))
    B = torch.where(eye, zero, torch.where(edge_mask, -L, big))

    if n_iter is None:
        n_iter = max(1, math.ceil(math.log2(n)) + 1)
    Astar = _minplus_closure(A, n_iter)
    cross = _minplus(_minplus(Astar, B), Astar)

    lb = torch.where(eye, zero, torch.clamp(-cross, min=0.0))
    ub = torch.where(eye, zero, Astar)
    return lb, ub


def bound_smoothing_anchored(L, U, edge_mask, U_ro, L_ro, D_oo, n_iter=None):
    """Bound smoothing with fixed-position side nodes folded in closed form.

    Equal to `bound_smoothing` on the (M + no)-node graph of the M reduced
    nodes plus `no` side nodes at known positions (obstacles), restricted
    to the reduced block, without its (M + no)^3 cost:
    * upper bounds: a detour through a side node never beats the direct
      reduced path (triangle inequality through the anchors), so ub is the
      reduced closure;
    * lower bounds: the -L crossing lies inside the reduced block, between
      a reduced and a side node (T1 and its transpose), or between two
      side nodes (T3) - three extra min-plus products over the (M, no)
      blocks.

    U_ro, L_ro : (..., M, no) reduced->side upper / lower bounds (BIG / 0
    where there is no edge); D_oo : (no, no) exact side-side distances.
    Returns (lb, ub) over the M reduced nodes.
    """
    n = L.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=L.device)
    big = torch.full_like(L, BIG)
    zero = torch.zeros_like(L)

    A = torch.where(eye, zero, torch.where(edge_mask, U, big))
    B = torch.where(eye, zero, torch.where(edge_mask, -L, big))

    if n_iter is None:
        n_iter = max(1, math.ceil(math.log2(n)) + 1)
    Astar = _minplus_closure(A, n_iter)
    cross = _minplus(_minplus(Astar, B), Astar)

    U_ro = U_ro.to(L.dtype)
    Astar_ro = _minplus(Astar, U_ro)  # (..., M, no) reduced->side uppers
    Aor = Astar_ro.transpose(-1, -2)
    B_ro = torch.where(L_ro > 0, -L_ro, torch.full_like(L_ro, BIG))
    B_oo = -D_oo.to(L.dtype)
    T1 = _minplus(_minplus(Astar, B_ro), Aor)
    T3 = _minplus(_minplus(Astar_ro, B_oo), Aor)
    cross = torch.minimum(cross, torch.minimum(T1, T1.transpose(-1, -2)))
    cross = torch.minimum(cross, T3)

    ub = torch.where(eye, zero, Astar)
    lb = torch.where(eye, zero, torch.clamp(-cross, min=0.0))
    return lb, ub
