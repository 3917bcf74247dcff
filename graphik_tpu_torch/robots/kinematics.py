"""Batched forward kinematics and Jacobians over robot templates.

Port of graphik_tpu/robots/kinematics.py (3D revolute robots and planar,
d = 2, robots). The JAX version scans over the topologically ordered joint
tree and vmaps over the instance batch; here the scan is a Python loop over
the n joints, batched over the leading dims of ``q``. Poses are
(hd, hd) homogeneous matrices with hd = dim + 1.

Functions take a `RobotTemplate` and a joint-angle tensor ``q`` of shape
(..., n); constants follow ``q``'s dtype and device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graphik_tpu_torch.robots.templates import RobotTemplate
from graphik_tpu_torch.utils import lie
from graphik_tpu_torch.utils.compiled import device_const


def _const(template, key, x, like):
    """Host data x of `template` in like's dtype on like's device, made
    once (compiled.device_const)."""
    return device_const(template, key, x, like.dtype, like.device)



def _exp(template: RobotTemplate, xi):
    return lie.se3_exp(xi) if template.dim == 3 else lie.se2_exp(xi)


def _adjoint(template: RobotTemplate, T):
    return lie.se3_adjoint(T) if template.dim == 3 else lie.se2_adjoint(T)


def prefix_products(template: RobotTemplate, q):
    """Accumulated exponential products A_i for every node.

    A_0 = T0[0]; A_i = A_{parent(i)} @ exp(S[parent(i)] * q_i), so that
    pose(node i) = A_i @ T0[i].

    q: (..., n) -> (..., n+1, hd, hd).
    """
    tpl = template
    hd = tpl.dim + 1
    S = _const(tpl, "S", tpl.S, q)
    A = [_const(tpl, "T0", tpl.T0, q)[0].expand(q.shape[:-1] + (hd, hd))]
    for i in range(1, tpl.n + 1):
        p = int(tpl.parents[i])
        A.append(lie.matmul_small(A[p], _exp(tpl, S[p] * q[..., i - 1, None])))
    return torch.stack(A, dim=-3)


def all_poses(template: RobotTemplate, q):
    """Poses of every joint frame: (..., n) -> (..., n+1, hd, hd)."""
    return lie.matmul_small(prefix_products(template, q), _const(template, "T0", template.T0, q))


def pose(template: RobotTemplate, q, node: int):
    """Pose of one node: (..., n) -> (..., hd, hd)."""
    return all_poses(template, q)[..., node, :, :]


def joint_positions(template: RobotTemplate, q, axis_length: float = 1.0):
    """Positions of the main (p) and auxiliary (q) points of every joint.

    Returns (p_pos, q_pos), each (..., n+1, dim). For dim == 3 the aux point
    is the frame origin translated by axis_length along the frame z-axis;
    for dim == 2 ``q_pos`` is None.
    """
    T = all_poses(template, q)
    dim = template.dim
    p_pos = T[..., :dim, dim]
    if dim == 2:
        return p_pos, None
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

    q: (..., n) -> (..., 6, n), or (..., 3, n) for a planar robot.
    """
    tpl = template
    if A is None:
        A = prefix_products(tpl, q)
    par = device_const(tpl, "joint_parents", tpl.parents[1:], device=q.device)
    S = _const(tpl, "S", tpl.S, q)[par]  # (n, tw)
    Ad = _adjoint(tpl, A[..., par, :, :])  # (..., n, tw, tw)
    # elementwise (lie.matvec_small), not an einsum: einsum folds the batch
    # into a GEMM's rows, whose rounding then depends on the batch size
    cols = lie.matvec_small(Ad, S)
    on_path = device_const(tpl, ("on_path", node), _path_membership(tpl, node)[1:],
                           device=q.device)
    cols = torch.where(on_path[:, None], cols, torch.zeros_like(cols))
    return cols.transpose(-1, -2)


def linear_jacobians(template: RobotTemplate, q, T=None):
    """World-frame position Jacobians of every node in one pass.

    (..., n) -> (..., n+1, dim, n): entry [j, :, i-1] is the velocity of
    node j per unit rate of joint i - z_{parent(i)} x (p_j - p_{parent(i)})
    in 3D, the in-plane perpendicular in 2D - zero when joint i does not
    move node j. Pass the poses `T` (all_poses) when the caller already has
    them.
    """
    tpl = template
    dim = tpl.dim
    if T is None:
        T = all_poses(tpl, q)
    parents = device_const(tpl, "joint_parents", tpl.parents[1:], device=q.device)
    p = T[..., :dim, dim]                          # (..., n+1, dim)
    Tp = T[..., parents, :, :]
    rel = p[..., :, None, :] - Tp[..., None, :, :dim, dim]  # (..., n+1, n, dim)
    if dim == 3:
        z = Tp[..., :3, 2].unsqueeze(-3).expand_as(rel)
        vel = torch.linalg.cross(z, rel, dim=-1)
    else:
        vel = torch.stack([-rel[..., 1], rel[..., 0]], dim=-1)
    anc = device_const(tpl, "ancestors", _ancestor_matrix(tpl), device=q.device)
    vel = torch.where(anc[:, :, None], vel, torch.zeros_like(vel))
    return vel.transpose(-1, -2)


def jacobian_geometric(template: RobotTemplate, q, node: int):
    """World-frame geometric Jacobian of `node`: column i-1 (joint q_i on
    the path to `node`) is [z_{parent(i)} x (p_node - p_{parent(i)});
    z_{parent(i)}], z and p from the parent frame's current world pose;
    off-path columns are zero. 3D only. q: (..., n) -> (..., 6, n)."""
    tpl = template
    if tpl.dim != 3:
        raise ValueError("the geometric Jacobian is defined for 3D robots")
    T = all_poses(tpl, q)                                  # (..., n+1, 4, 4)
    Tp = T[..., device_const(tpl, "joint_parents", tpl.parents[1:], device=q.device), :, :]
    z = Tp[..., :3, 2]                                     # (..., n, 3)
    lin = torch.linalg.cross(z, T[..., node, None, :3, 3] - Tp[..., :3, 3], dim=-1)
    cols = torch.cat([lin, z], dim=-1)                     # (..., n, 6)
    on_path = device_const(tpl, ("on_path", node), _path_membership(tpl, node)[1:],
                           device=q.device)
    cols = torch.where(on_path[:, None], cols, torch.zeros_like(cols))
    return cols.transpose(-1, -2)


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
                         dtype=None, device=None):
    """Uniform joint angles within limits, in `dtype` (None:
    torch.get_default_dtype(), the JAX package's default float) on `device`
    (default: the card).

    The draw happens on `generator`'s own device (so one seed gives the
    same goals whatever `device` is) and the result moves to `device`.
    """
    device = entry_device(device)
    dtype = torch.get_default_dtype() if dtype is None else dtype
    lb = torch.as_tensor(template.lb[1:], dtype=dtype, device=device)
    ub = torch.as_tensor(template.ub[1:], dtype=dtype, device=device)
    gen_device = generator.device if generator is not None else device
    u = torch.rand(tuple(batch_shape) + (template.n,), generator=generator,
                   dtype=dtype, device=gen_device).to(device)
    return lb + u * (ub - lb)
