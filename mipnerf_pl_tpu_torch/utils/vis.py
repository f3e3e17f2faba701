"""Depth colormaps, image saving and camera paths (numpy), counterpart of
mipnerf_pl_tpu/utils/vis.py.  Images are float arrays in [0, 1], HWC (or HW
for scalar maps).  PIL and cv2 are imported inside the functions that need
them: nothing here needs either at import time."""

from __future__ import annotations

import os

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
            * 255).astype(np.uint8)


def visualize_depth(depth, cmap=None) -> np.ndarray:
    """Scalar map -> JET-colormapped RGB float image [H, W, 3] in [0, 1]."""
    import cv2
    x = np.nan_to_num(np.squeeze(np.asarray(depth, dtype=np.float32)))
    mi, ma = np.min(x), np.max(x)
    x8 = (255 * (x - mi) / max(ma - mi, 1e-8)).astype(np.uint8)
    colored = cv2.applyColorMap(x8, cv2.COLORMAP_JET if cmap is None else cmap)
    return cv2.cvtColor(colored, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def save_image(img: np.ndarray, save_path: str) -> None:
    """Save an HWC (or HW) float image in [0, 1] as PNG."""
    from PIL import Image
    Image.fromarray(to_uint8(np.squeeze(np.asarray(img)))).save(save_path)


def save_images(rgb, dist, acc, out_dir: str, idx: int) -> None:
    """Write {idx:05d}_{rgb,dist,acc}.png, the JAX package's artifact
    names."""
    os.makedirs(out_dir, exist_ok=True)
    rgb = np.asarray(rgb)
    if rgb.ndim == 4:
        rgb = rgb[0]
    save_image(rgb, os.path.join(out_dir, f'{idx:05d}_rgb.png'))
    save_image(visualize_depth(dist),
               os.path.join(out_dir, f'{idx:05d}_dist.png'))
    save_image(visualize_depth(acc),
               os.path.join(out_dir, f'{idx:05d}_acc.png'))


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
