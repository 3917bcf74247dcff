"""Distance-geometry core: Gram <-> EDM <-> positions, MDS, bound smoothing.

Port of graphik_tpu/utils/dgp.py (the parts the main path runs). All
functions broadcast over leading batch dims. Eigendecompositions use
`torch.linalg.eigh`; the JAX package's fixed-sweep Jacobi and subspace
iterations are TPU workarounds and are not ported.

Distance matrices ``D`` hold *squared* distances; bound matrices
``lb``/``ub`` hold *unsquared* distances.
"""

from __future__ import annotations

import math

import torch

# Sentinel for "no edge" in min-plus shortest paths. Large but far from
# overflow so sums of two stay representable in float32.
BIG = 1e9


# ---------------------------------------------------------------------------
# Gram / EDM / positions
# ---------------------------------------------------------------------------

def gram_from_distance_matrix(D):
    """Double-centered Gram matrix from a squared EDM."""
    row = D.mean(dim=-1, keepdim=True)
    col = D.mean(dim=-2, keepdim=True)
    tot = D.mean(dim=(-2, -1), keepdim=True)
    return -0.5 * (D - row - col + tot)


def distance_matrix_from_gram(X):
    """Squared EDM from a Gram matrix."""
    d = torch.diagonal(X, dim1=-2, dim2=-1)
    return d[..., :, None] + d[..., None, :] - 2.0 * X


def distance_matrix_from_pos(Y):
    """Squared EDM of an (..., N, d) point set."""
    return distance_matrix_from_gram(Y @ Y.transpose(-1, -2))


# ---------------------------------------------------------------------------
# Spectral factorization / MDS init
# ---------------------------------------------------------------------------

def factor_psd(A, eps=0.0):
    """Return X with XX^T ~= closest-PSD(A), eigenvalues in descending order.

    Eigendecompose, clamp eigenvalues <= eps to 0, scale eigenvectors by
    sqrt(eigval), order columns by descending eigenvalue; all N columns are
    kept (trailing ones are ~0).
    """
    evals, evecs = torch.linalg.eigh(A)  # ascending
    evals = torch.where(evals > eps, evals, torch.zeros_like(evals))
    X = evecs * torch.sqrt(evals)[..., None, :]
    return torch.flip(X, dims=(-1,))


def mds(B, eps=1e-8):
    """Classic multidimensional scaling of a Gram matrix."""
    return factor_psd(B, eps=eps)


def linear_projection(P, F, dim):
    """Project points onto the dominant `dim`-dim subspace of the edge scatter.

    S = sum over nonzero (i, j) of F of outer(P_i - P_j); P is projected
    onto the top-`dim` eigenvectors of S. `F` is a dense (N, N) mask.
    """
    mask = (F != 0).to(P.dtype)
    deg_i = mask.sum(dim=-1)  # (..., N)
    deg_j = mask.sum(dim=-2)
    PtP_i = torch.einsum("...i,...ik,...il->...kl", deg_i, P, P)
    PtP_j = torch.einsum("...j,...jk,...jl->...kl", deg_j, P, P)
    cross = torch.einsum("...ij,...ik,...jl->...kl", mask, P, P)
    S = PtP_i + PtP_j - cross - cross.transpose(-1, -2)
    _, eigvec = torch.linalg.eigh(S)  # ascending
    basis = torch.flip(eigvec, dims=(-1,))[..., :, :dim]
    return P @ basis


def sample_distance_matrix(lb, ub, frac=0.9):
    """Squared EDM inside [lb, ub]: D = (lb + frac (ub - lb))^2 (the
    deterministic initialization of the Riemannian solver)."""
    return (lb + frac * (ub - lb)) ** 2


# ---------------------------------------------------------------------------
# Bound smoothing (triangle-inequality propagation)
# ---------------------------------------------------------------------------

def _minplus(A, B):
    """Min-plus (tropical) product C_ij = min_k A_ik + B_kj, as a broadcast
    min over a (..., N, N, N) sum."""
    return torch.amin(A[..., :, :, None] + B[..., None, :, :], dim=-2)


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
