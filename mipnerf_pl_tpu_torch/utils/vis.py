"""Depth colormaps, image saving, TensorBoard panels, camera paths and the
LR plot (numpy), counterpart of mipnerf_pl_tpu/utils/vis.py.  Images are
float arrays in [0, 1], HWC (or HW for scalar maps).  PIL, cv2, scipy and
matplotlib are imported inside the functions that need them: nothing here
needs any of them at import time."""

from __future__ import annotations

import os

import numpy as np


def normalize(v):
    """v / its norm."""
    return v / np.linalg.norm(v)


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


def stack_rgb(rgb_gt, coarse_rgb, fine_rgb) -> np.ndarray:
    """(GT, coarse, fine) -> a [3, 3, H, W] stack for TensorBoard's
    add_images."""
    def chw(x):
        return np.transpose(np.squeeze(np.asarray(x)), (2, 0, 1))
    return np.stack([chw(rgb_gt), chw(coarse_rgb), chw(fine_rgb)])


def _look_at_poses(centers: np.ndarray, targets: np.ndarray,
                   up_hint) -> np.ndarray:
    """[n, 3, 4] camera-to-world poses at `centers` looking at `targets`:
    columns [right, up, forward] with forward = center - target (cameras
    look along -forward, the OpenGL / NeRF convention)."""
    fwd = centers - targets
    fwd = fwd / np.linalg.norm(fwd, axis=-1, keepdims=True)
    right = np.cross(np.broadcast_to(up_hint, fwd.shape), fwd)
    right = right / np.linalg.norm(right, axis=-1, keepdims=True)
    up = np.cross(fwd, right)
    return np.stack([right, up, fwd, centers], axis=-1)


def create_spiral_poses(radii, focus_depth, n_poses: int = 120) -> np.ndarray:
    """Spiral path of [n_poses, 3, 4] camera-to-world poses: two turns in
    the plane with one vertical oscillation (t in [0, 4 pi), z at half
    rate), scaled per axis by `radii`, every camera looking at (0, 0,
    -focus_depth) with +y up."""
    t = np.linspace(0.0, 4.0 * np.pi, n_poses + 1)[:-1, None]
    centers = np.concatenate(
        [np.cos(t), -np.sin(t), -np.sin(0.5 * t)], axis=-1) * radii
    return _look_at_poses(centers,
                          targets=np.array([0.0, 0.0, -focus_depth]),
                          up_hint=np.array([0.0, 1.0, 0.0]))


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


def gen_render_path(c2ws: np.ndarray, n_views: int = 30) -> np.ndarray:
    """A closed loop through keyframe poses, [*, 4, 4]: positions and xyz
    Euler angles interpolated linearly (the angles unwrapped to within 180
    degrees of the first keyframe), n_views // 3 steps a segment, the last
    segment back to the first pose."""
    from scipy.spatial.transform import Rotation as R
    n = len(c2ws)
    eulers = R.from_matrix(c2ws[:, :3, :3]).as_euler('xyz', degrees=True)
    eulers += 360.0 * (np.abs(eulers - eulers[0]) > 180.0)
    positions = c2ws[:, :3, 3]

    # [n, k] weights: segment i runs from keyframe i to i + 1 (mod n).
    w = np.linspace(1.0, 0.0, n_views // 3, endpoint=False)[None, :, None]
    nxt = np.roll(np.arange(n), -1)
    e_path = (w * eulers[:, None] + (1 - w) * eulers[nxt][:, None])
    p_path = (w * positions[:, None] + (1 - w) * positions[nxt][:, None])
    e_path, p_path = e_path.reshape(-1, 3), p_path.reshape(-1, 3)

    out = np.broadcast_to(np.eye(4), (len(e_path), 4, 4)).copy()
    out[:, :3, :3] = R.from_euler('xyz', e_path, degrees=True).as_matrix()
    out[:, :3, 3] = p_path
    return out


def vis_lr(lr_fn, max_steps: int, out_path: str = None):
    """Plot a learning-rate schedule on log-log axes (into out_path when
    given)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    steps = np.arange(1, max_steps, max(1, max_steps // 10000))
    lrs = [float(lr_fn(s)) for s in steps]
    plt.figure()
    plt.plot(steps, lrs)
    plt.xscale('log')
    plt.yscale('log')
    if out_path:
        plt.savefig(out_path)
    plt.close()
