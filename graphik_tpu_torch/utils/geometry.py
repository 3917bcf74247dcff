"""Geometric primitives for limit-edge construction.

Port of graphik_tpu/utils/geometry.py: batched torch functions that also
take numpy arrays (as float64 CPU tensors).
"""

from __future__ import annotations

import torch

from graphik_tpu_torch.utils.lie import so3_hat


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def skew(x):
    """Skew-symmetric matrix of a 3-vector: (..., 3) -> (..., 3, 3)."""
    return so3_hat(_t(x))


def max_min_distance_revolute(r, P, C, N):
    """(d_max, d_min): the largest and least distance from point(s) P to
    the circle of radius r, centre C and unit normal N, the primitive
    behind the joint-limit -> distance-bound conversion. All arguments
    broadcast."""
    P, C, N, r = _t(P), _t(C), _t(N), _t(r)
    delta = P - C
    axial = (N * delta).sum(dim=-1)
    radial = torch.linalg.norm(torch.linalg.cross(N.expand_as(delta), delta, dim=-1), dim=-1)
    d_min = torch.sqrt(torch.clamp(axial ** 2 + (radial - r) ** 2, min=0.0))
    d_max = torch.sqrt(torch.clamp(axial ** 2 + (radial + r) ** 2, min=0.0))
    return d_max, d_min
