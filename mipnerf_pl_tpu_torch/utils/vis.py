"""Camera paths (numpy), counterpart of mipnerf_pl_tpu/utils/vis.py."""

from __future__ import annotations

import numpy as np


def create_spheric_poses(radius: float, n_poses: int = 120) -> np.ndarray:
    """Circular orbit of [n, 3, 4] camera-to-world poses looking at the
    origin: cameras on a circle of radius `radius * cos(pi/5)` at height
    `radius * sin(pi/5)` (36 degrees elevation), +z up."""
    elev = np.pi / 5.0
    t = np.linspace(0.0, 2.0 * np.pi, n_poses + 1)[:-1]
    st, ct = np.sin(t), np.cos(t)
    zeros, ones = np.zeros_like(t), np.ones_like(t)
    se, ce = np.sin(elev), np.cos(elev)
    right = np.stack([-ct, st, zeros], axis=-1)
    up = np.stack([-st * se, -ct * se, ce * ones], axis=-1)
    forward = np.stack([st * ce, ct * ce, se * ones], axis=-1)
    return np.stack([right, up, forward, radius * forward], axis=-1)
