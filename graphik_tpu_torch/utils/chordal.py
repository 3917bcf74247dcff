"""Chordal completion and maximal cliques for sparse SDP decompositions.

Copy of graphik_tpu/utils/chordal.py (host numpy, no networkx): an MCS-M
minimal triangulation and the maximal cliques of the chordal graph from its
elimination order. Used by the sparse CIDGIK solver
(solvers/cidgik_sparse.py).
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np


def complete_to_chordal(adj: np.ndarray) -> Tuple[np.ndarray, List[int]]:
    """MCS-M minimal triangulation (chordal.py:4-66).

    adj: (N, N) bool symmetric adjacency (no self loops).
    Returns (chordal adjacency including fill edges, elimination order alpha
    from N-1 down to 0 position).
    """
    adj = adj.copy().astype(bool)
    N = adj.shape[0]
    H = adj.copy()
    weight = np.zeros(N, dtype=np.int64)
    unnumbered: Set[int] = set(range(N))
    order = [0] * N

    for i in range(N - 1, -1, -1):
        # pick unnumbered vertex of maximal weight
        z = max(unnumbered, key=lambda v: (weight[v], -v))
        unnumbered.remove(z)
        order[i] = z

        update_nodes = []
        for y in unnumbered:
            if H[y, z]:
                update_nodes.append(y)
            else:
                # path y ~ z through unnumbered vertices of strictly
                # smaller weight than weight[y]
                lower = {
                    v for v in unnumbered if v != y and weight[v] < weight[y]
                }
                # BFS from y through `lower` to z
                frontier = [y]
                seen = {y}
                found = False
                while frontier and not found:
                    nxt = []
                    for u in frontier:
                        for v in range(N):
                            if not H[u, v] or v in seen:
                                continue
                            if v == z:
                                found = True
                                break
                            if v in lower:
                                seen.add(v)
                                nxt.append(v)
                        if found:
                            break
                    frontier = nxt
                if found:
                    update_nodes.append(y)

        for y in update_nodes:
            weight[y] += 1
            if not adj[y, z]:
                adj[y, z] = adj[z, y] = True  # fill edge
    return adj, order


def maximal_cliques_chordal(adj: np.ndarray, order: List[int]) -> List[List[int]]:
    """Maximal cliques of a chordal graph from a perfect elimination order."""
    N = adj.shape[0]
    pos = {v: i for i, v in enumerate(order)}
    cliques: List[Set[int]] = []
    for v in order:
        later = {u for u in range(N) if adj[v, u] and pos[u] > pos[v]}
        cand = later | {v}
        if not any(cand <= c for c in cliques):
            cliques.append(cand)
    return [sorted(c) for c in cliques]


def chordal_cliques(adj: np.ndarray) -> List[List[int]]:
    """Triangulate + extract maximal cliques (sdp_snl.py:270-314 pipeline)."""
    chordal_adj, order = complete_to_chordal(adj)
    return maximal_cliques_chordal(chordal_adj, order)
