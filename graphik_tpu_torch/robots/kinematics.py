"""Batched forward kinematics and Jacobians over robot templates.

Port of graphik_tpu/robots/kinematics.py (3D revolute robots). The JAX
version scans over the topologically ordered joint tree and vmaps over the
instance batch; here the scan is a Python loop over the n joints, batched
over the leading dims of ``q``.

Functions take a `RobotTemplate` and a joint-angle tensor ``q`` of shape
(..., n); constants follow ``q``'s dtype and device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graphik_tpu_torch.robots.templates import RobotTemplate
from graphik_tpu_torch.utils import lie


def _const(x, like):
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def prefix_products(template: RobotTemplate, q):
    """Accumulated exponential products A_i for every node.

    A_0 = T0[0]; A_i = A_{parent(i)} @ exp(S[parent(i)] * q_i), so that
    pose(node i) = A_i @ T0[i].

    q: (..., n) -> (..., n+1, 4, 4).
    """
    tpl = template
    if tpl.dim != 3:
        raise NotImplementedError("planar robots: slice 3")
    S = _const(tpl.S, q)
    A = [_const(tpl.T0[0], q).expand(q.shape[:-1] + (4, 4))]
    for i in range(1, tpl.n + 1):
        p = int(tpl.parents[i])
        A.append(A[p] @ lie.se3_exp(S[p] * q[..., i - 1, None]))
    return torch.stack(A, dim=-3)


def all_poses(template: RobotTemplate, q):
    """Poses of every joint frame: (..., n) -> (..., n+1, 4, 4)."""
    return prefix_products(template, q) @ _const(template.T0, q)


def pose(template: RobotTemplate, q, node: int):
    """Pose of one node: (..., n) -> (..., 4, 4)."""
    return all_poses(template, q)[..., node, :, :]


def joint_positions(template: RobotTemplate, q, axis_length: float = 1.0):
    """Positions of the main (p) and auxiliary (q) points of every joint.

    Returns (p_pos, q_pos), each (..., n+1, 3); the aux point is the frame
    origin translated by axis_length along the frame z-axis.
    """
    T = all_poses(template, q)
    p_pos = T[..., :3, 3]
    return p_pos, p_pos + axis_length * T[..., :3, 2]


def _path_membership(template: RobotTemplate, node: int):
    on = np.zeros(template.n + 1, dtype=bool)
    i = node
    while i > 0:
        on[i] = True
        i = int(template.parents[i])
    return on


def jacobian(template: RobotTemplate, q, node: int, A: Optional[torch.Tensor] = None):
    """Spatial Jacobian of `node` in [v, w] twist coordinates.

    Column i-1 (joint angle q_i on the path) is Ad_{A_{parent(i)}}
    S[parent(i)]; columns for joints off the path are zero. Pass the
    prefix products `A` when the caller already has them.

    q: (..., n) -> (..., 6, n).
    """
    tpl = template
    if A is None:
        A = prefix_products(tpl, q)
    par = torch.as_tensor(tpl.parents[1:], device=q.device)
    S = _const(tpl.S, q)[par]  # (n, 6)
    Ad = lie.se3_adjoint(A[..., par, :, :])  # (..., n, 6, 6)
    cols = torch.einsum("...nij,nj->...ni", Ad, S)
    on_path = torch.as_tensor(_path_membership(tpl, node)[1:], device=q.device)
    cols = torch.where(on_path[:, None], cols, torch.zeros_like(cols))
    return cols.transpose(-1, -2)


def linear_jacobians(template: RobotTemplate, q, T=None):
    """World-frame position Jacobians of every node in one pass.

    (..., n) -> (..., n+1, 3, n): entry [j, :, i-1] is the velocity of node
    j per unit rate of joint i, z_{parent(i)} x (p_j - p_{parent(i)}), zero
    when joint i does not move node j. Pass the poses `T` (all_poses) when
    the caller already has them.
    """
    tpl = template
    if T is None:
        T = all_poses(tpl, q)
    parents = torch.as_tensor(tpl.parents[1:], device=q.device)
    p = T[..., :3, 3]                              # (..., n+1, 3)
    Tp = T[..., parents, :, :]
    rel = p[..., :, None, :] - Tp[..., None, :, :3, 3]  # (..., n+1, n, 3)
    z = Tp[..., :3, 2].unsqueeze(-3).expand_as(rel)
    vel = torch.linalg.cross(z, rel, dim=-1)
    anc = torch.as_tensor(_ancestor_matrix(tpl), device=q.device)
    vel = torch.where(anc[:, :, None], vel, torch.zeros_like(vel))
    return vel.transpose(-1, -2)


def _ancestor_matrix(template: RobotTemplate):
    """(n+1, n) bool: [j, i-1] = joint i is on the path root -> node j."""
    n = template.n
    anc = np.zeros((n + 1, n), dtype=bool)
    for j in range(1, n + 1):
        i = j
        while i > 0:
            anc[j, i - 1] = True
            i = int(template.parents[i])
    return anc


def entry_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or the card when the
    caller names none. Raises when that is a CUDA device and there is none:
    the CPU runs only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def random_configuration(template: RobotTemplate, batch_shape=(),
                         generator: Optional[torch.Generator] = None,
                         dtype=torch.float64, device=None):
    """Uniform joint angles within limits, on `device` (default: the card).

    The draw happens on `generator`'s own device (so one seed gives the
    same goals whatever `device` is) and the result moves to `device`.
    """
    device = entry_device(device)
    lb = torch.as_tensor(template.lb[1:], dtype=dtype, device=device)
    ub = torch.as_tensor(template.ub[1:], dtype=dtype, device=device)
    gen_device = generator.device if generator is not None else device
    u = torch.rand(tuple(batch_shape) + (template.n,), generator=generator,
                   dtype=dtype, device=gen_device).to(device)
    return lb + u * (ub - lb)
