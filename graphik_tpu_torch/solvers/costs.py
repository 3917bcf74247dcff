"""Masks shared by the solver cost forms.

Port of graphik_tpu/solvers/costs.py::make_masks. The masks are static
template constants, so they stay host-side numpy arrays.
"""

from __future__ import annotations

import numpy as np


def make_masks(omega, psi_L, psi_U):
    """Hinge activity masks: an edge carries a lower (upper) hinge when its
    bounds differ and its lower (upper) bound is positive."""
    psi_L = np.asarray(psi_L, np.float64)
    psi_U = np.asarray(psi_U, np.float64)
    diff = psi_L != psi_U
    L_mask = (diff & (psi_L > 0)).astype(np.float64)
    U_mask = (diff & (psi_U > 0)).astype(np.float64)
    return L_mask, U_mask
