"""Canonical benchmark obstacle environments.

Port of graphik_tpu/utils/environments.py (numpy only, identical values).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def table_environment(
    height: float = 0.9,
    width: float = 0.8,
    n_height: int = 9,
    n_width: int = 8,
    obs_inflation: float = 2.0,
) -> List[Tuple[np.ndarray, float]]:
    """Table top (n_width^2 spheres) plus 4 legs (n_height spheres each):
    100 (center, radius) pairs at the defaults, for
    ProblemStructure.from_template(obstacles=...)."""
    radius = 0.5 * height / n_height
    tabletop = [
        (
            np.asarray([2 * (i + 0.5) * radius, 2 * (j + 0.5) * radius, height + radius]),
            obs_inflation * radius,
        )
        for i in range(-n_width // 2, n_width // 2)
        for j in range(-n_width // 2, n_width // 2)
    ]
    legs = []
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            legs += [
                (
                    np.asarray(
                        [sx * (width / 2 - radius), sy * (width / 2 - radius), (2 * i + 1) * radius]
                    ),
                    obs_inflation * radius,
                )
                for i in range(0, n_height)
            ]
    return tabletop + legs


def ring_environment(
    n: int = 6,
    ring_radius: float = 4.0,
    radius: float = 0.5,
    first_angle: float = np.pi / 6,
) -> List[Tuple[np.ndarray, float]]:
    """n circles of `radius` centred on a ring about the base, at angles
    first_angle + 2 pi k / n: the planar10_ring6 scene at the defaults (six
    circles of radius 0.5 at 4 (cos a, sin a, 0), a = 30, 90, ..., 330
    degrees), a planar analogue of the table. The centres are 3-vectors; a
    planar structure keeps their first two coordinates."""
    angles = first_angle + 2.0 * np.pi * np.arange(n) / n
    return [(np.asarray([ring_radius * np.cos(a), ring_radius * np.sin(a), 0.0]), radius)
            for a in angles]
