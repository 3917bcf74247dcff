"""Robot templates: host-side compilation of robot models into static arrays.

Numpy-only copy of graphik_tpu/robots/templates.py (the two packages must
compile byte-identical templates; tests/test_torch_model.py checks it). A
robot is compiled once, host-side, into a `RobotTemplate` of plain numpy
arrays; everything downstream (FK, Jacobians, problem graphs, solvers)
turns those arrays into tensors on the caller's device.

Node indexing: joints are integer nodes ``0..n`` standing for the reference's
``p0..pn``. Joint angle ``q[i-1]`` actuates node ``i`` (rotating about the
axis attached to node ``parents[i]``), matching the reference's
product-of-exponentials convention (robot_revolute.py:85-103).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def _rotx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _se3(R, t):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def dh_to_se3(a, alpha, d, theta):
    """Standard DH: TransZ(d) RotZ(theta) TransX(a) RotX(alpha).

    Matches reference kinematics.py:42-57.
    """
    Tz = _se3(np.eye(3), [0, 0, d])
    Rz = _se3(_rotz(theta), np.zeros(3))
    Tx = _se3(np.eye(3), [a, 0, 0])
    Rx = _se3(_rotx(alpha), np.zeros(3))
    return Tz @ Rz @ Tx @ Rx


def modified_dh_to_se3(a, alpha, d, theta):
    """Modified DH: TransX(a) RotX(alpha) TransZ(d) RotZ(theta).

    Matches reference kinematics.py:60-82.
    """
    Tz = _se3(np.eye(3), [0, 0, d])
    Rz = _se3(_rotz(theta), np.zeros(3))
    Tx = _se3(np.eye(3), [a, 0, 0])
    Rx = _se3(_rotx(alpha), np.zeros(3))
    return Tx @ Rx @ Tz @ Rz


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash
class RobotTemplate:
    """Static description of a revolute (3D) or planar (2D) robot tree.

    Attributes
    ----------
    dim : workspace dimension (2 or 3).
    n : number of actuated joints; joint nodes are 0..n (n+1 of them).
    parents : (n+1,) int; parents[0] == -1. Topologically ordered
        (parents[i] < i for all i >= 1).
    T0 : (n+1, dim+1, dim+1) zero-config frames, base-relative
        (reference node attr "T0", robot_revolute.py:29).
    S : (n+1, 6|3) screw axis of the rotation at each node's frame at zero
        config, [v, w] order (robot_revolute.py:40-44).
    T_rel : (n+1, dim+1, dim+1) relative transform parent->node at zero
        config; identity at the root (edge attr TRANSFORM, robot_revolute.py:47-51).
    lb, ub : (n+1,) joint limits for the angle actuating node i (entry 0
        unused, set to 0).
    paths : (n_ee, max_depth+1) padded root->end-effector node paths,
        -1 padded. Row e covers end effector ee[e].
    ee : (n_ee,) end-effector node indices (out-degree zero).
    link_lengths : (n+1,) planar only - link length of the edge into node i
        (entry 0 unused); None for 3D robots.
    """

    dim: int
    n: int
    parents: np.ndarray
    T0: np.ndarray
    S: np.ndarray
    T_rel: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    paths: np.ndarray
    ee: np.ndarray
    link_lengths: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return self.n + 1

    @property
    def depth(self) -> np.ndarray:
        d = np.zeros(self.n + 1, dtype=np.int64)
        for i in range(1, self.n + 1):
            d[i] = d[self.parents[i]] + 1
        return d

    def with_limits(self, lb, ub) -> "RobotTemplate":
        lb_full = np.zeros(self.n + 1)
        ub_full = np.zeros(self.n + 1)
        lb_full[1:] = np.asarray(lb, dtype=float)
        ub_full[1:] = np.asarray(ub, dtype=float)
        return dataclasses.replace(self, lb=lb_full, ub=ub_full)


def _paths_from_parents(parents: np.ndarray):
    """End-effector list and padded root->ee paths from a parent array."""
    n_nodes = len(parents)
    children = [[] for _ in range(n_nodes)]
    for i in range(1, n_nodes):
        children[parents[i]].append(i)
    ee = np.array([i for i in range(n_nodes) if not children[i]], dtype=np.int64)

    paths = []
    for e in ee:
        path = [int(e)]
        while parents[path[-1]] >= 0:
            path.append(int(parents[path[-1]]))
        paths.append(path[::-1])
    max_len = max(len(p) for p in paths)
    padded = -np.ones((len(paths), max_len), dtype=np.int64)
    for r, p in enumerate(paths):
        padded[r, : len(p)] = p
    return ee, padded


def _finish_template(dim, n, parents, T0, lb, ub, link_lengths=None):
    """Derive screws, relative transforms, and paths; build the template."""
    parents = np.asarray(parents, dtype=np.int64)
    assert parents[0] == -1
    assert np.all(parents[1:] < np.arange(1, n + 1)), "nodes must be topo-ordered"

    hd = dim + 1
    T0 = np.asarray(T0, dtype=float).reshape(n + 1, hd, hd)

    if dim == 3:
        # Screw axis [v, w] with w = frame z-axis, v = -w x p
        # (robot_revolute.py:40-44).
        S = np.zeros((n + 1, 6))
        for i in range(n + 1):
            w = T0[i, :3, 2]
            p = T0[i, :3, 3]
            S[i, :3] = np.cross(-w, p)
            S[i, 3:] = w
    else:
        # Planar: rotation about +z through the frame origin
        # (robot_planar.py:38-42): S = [p_y, -p_x, 1].
        S = np.zeros((n + 1, 3))
        for i in range(n + 1):
            p = T0[i, :2, 2]
            S[i] = [p[1], -p[0], 1.0]

    T_rel = np.tile(np.eye(hd), (n + 1, 1, 1))
    for i in range(1, n + 1):
        T_rel[i] = np.linalg.inv(T0[parents[i]]) @ T0[i]

    lb_full = np.zeros(n + 1)
    ub_full = np.zeros(n + 1)
    lb_full[1:] = np.asarray(lb, dtype=float) if lb is not None else -np.pi
    ub_full[1:] = np.asarray(ub, dtype=float) if ub is not None else np.pi

    ee, paths = _paths_from_parents(parents)
    return RobotTemplate(
        dim=dim,
        n=n,
        parents=parents,
        T0=T0,
        S=S,
        T_rel=T_rel,
        lb=lb_full,
        ub=ub_full,
        paths=paths,
        ee=ee,
        link_lengths=link_lengths,
    )


def revolute_from_dh(
    a: Sequence[float],
    alpha: Sequence[float],
    d: Sequence[float],
    theta: Sequence[float],
    lb=None,
    ub=None,
    modified_dh: bool = False,
) -> RobotTemplate:
    """Chain revolute robot from DH parameters (robot_revolute.py:53-83)."""
    n = len(a)
    to_se3 = modified_dh_to_se3 if modified_dh else dh_to_se3
    T0 = np.zeros((n + 1, 4, 4))
    T0[0] = np.eye(4)
    for i in range(n):
        T0[i + 1] = T0[i] @ to_se3(a[i], alpha[i], d[i], theta[i])
    parents = np.concatenate([[-1], np.arange(n)])
    return _finish_template(3, n, parents, T0, lb, ub)


def revolute_from_t_zero(
    T0: np.ndarray,
    parents: Optional[Sequence[int]] = None,
    lb=None,
    ub=None,
) -> RobotTemplate:
    """Revolute robot (chain or tree) from explicit zero-config frames.

    ``T0`` is (n+1, 4, 4), base-relative (T0[0] need not be identity but
    usually is after normalization, cf. roboturdf.py:250-253).
    """
    T0 = np.asarray(T0, dtype=float)
    n = T0.shape[0] - 1
    if parents is None:
        parents = np.concatenate([[-1], np.arange(n)])
    return _finish_template(3, n, np.asarray(parents), T0, lb, ub)


def planar_from_links(
    link_lengths: Sequence[float],
    parents: Optional[Sequence[int]] = None,
    lb=None,
    ub=None,
) -> RobotTemplate:
    """Planar robot from link lengths (robot_planar.py:51-60).

    Zero config lays links along +x cumulatively down each tree path.
    ``link_lengths[i-1]`` is the length of the link into node i.
    """
    link_lengths = np.asarray(link_lengths, dtype=float)
    n = len(link_lengths)
    if parents is None:
        parents = np.concatenate([[-1], np.arange(n)])
    parents = np.asarray(parents, dtype=np.int64)

    T0 = np.zeros((n + 1, 3, 3))
    T0[0] = np.eye(3)
    for i in range(1, n + 1):
        step = np.eye(3)
        step[0, 2] = link_lengths[i - 1]
        T0[i] = T0[parents[i]] @ step

    ll_full = np.zeros(n + 1)
    ll_full[1:] = link_lengths
    return _finish_template(2, n, parents, T0, lb, ub, link_lengths=ll_full)
