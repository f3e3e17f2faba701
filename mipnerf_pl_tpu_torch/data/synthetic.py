"""Synthetic multi-view-consistent scenes (no dataset downloads).

Counterpart of mipnerf_pl_tpu/data/synthetic.py: analytic scenes ray-traced
in numpy, and a writer of the Blender transforms_{split}.json layout, so
that train / eval can be driven, and their convergence checked, with no
NeRF-synthetic data on disk.  PIL is imported inside the writer only: the
renderers need numpy alone.

Two scenes:
  * 'spheres': three flat-shaded spheres.  Easy; proves plumbing.
  * 'hard': checker/stripe/ring-textured spheres over a checkered ground
    disk.  High-frequency content that aliases at coarse scales, the regime
    the integrated positional encoding exists for.  Ground-truth images are
    supersampled (box downsample) so the targets are anti-aliased.

`make_sphere_scene` writes the Blender transforms_{split}.json layout;
`make_llff_sphere_capture` writes an LLFF / COLMAP capture of the same
scene (images_1/, poses_bounds.npy, sparse/0/cameras.bin), the input of
the `real360` dataset and of the unbounded-360 path.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

CAMERA_ANGLE_X = 0.6911112070083618  # matches NeRF-synthetic

# (center, radius, color) — flat-shaded.
DEFAULT_SPHERES: List[Tuple[np.ndarray, float, np.ndarray]] = [
    (np.array([0.0, 0.0, 0.0]), 0.7, np.array([0.9, 0.2, 0.2])),
    (np.array([0.9, 0.0, 0.3]), 0.35, np.array([0.2, 0.8, 0.3])),
    (np.array([-0.6, 0.7, -0.2]), 0.3, np.array([0.2, 0.3, 0.9])),
]

# (center, radius, color, texture_kind, texture_freq) — procedural textures
# in object space (multi-view consistent by construction).
HARD_SPHERES: List[Tuple[np.ndarray, float, np.ndarray, str, float]] = [
    (np.array([0.0, 0.0, 0.1]), 0.7, np.array([0.95, 0.3, 0.25]),
     'checker', 9.0),
    (np.array([0.95, 0.0, -0.1]), 0.35, np.array([0.2, 0.85, 0.35]),
     'stripes', 22.0),
    (np.array([-0.65, 0.7, -0.2]), 0.3, np.array([0.3, 0.4, 0.95]),
     'checker', 16.0),
    (np.array([0.1, -0.95, -0.25]), 0.32, np.array([0.95, 0.8, 0.25]),
     'rings', 18.0),
]

# Ground disk under the hard scene: (z, disk_radius, color, kind, freq).
HARD_GROUND = (-0.65, 2.8, np.array([0.82, 0.82, 0.85]), 'checker', 2.5)


def _texture(pt: np.ndarray, kind: str, freq: float) -> np.ndarray:
    """Procedural surface albedo multiplier in [0.2, 1.0] at 3-D point pt."""
    if kind == 'solid':
        return np.ones(pt.shape[:-1], np.float32)
    if kind == 'checker':
        parity = np.sum(np.floor(pt * freq), axis=-1) % 2
    elif kind == 'stripes':
        parity = np.floor(pt[..., 2] * freq) % 2
    elif kind == 'rings':
        parity = np.floor(np.hypot(pt[..., 0], pt[..., 1]) * freq) % 2
    else:
        raise ValueError(f'unknown texture kind {kind!r}')
    return (0.2 + 0.8 * parity).astype(np.float32)


def _camera_dirs(c2w: np.ndarray, size: int,
                 focal: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    focal = focal or 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    x, y = np.meshgrid(np.arange(size) + 0.5, np.arange(size) + 0.5,
                       indexing='xy')
    cam_dirs = np.stack([(x - size / 2) / focal, -(y - size / 2) / focal,
                         -np.ones_like(x)], -1)
    return cam_dirs @ c2w[:3, :3].T, c2w[:3, 3]


def _trace_spheres(dirs: np.ndarray, o: np.ndarray, spheres: Sequence,
                   size: int):
    """Shared sphere ray-tracer: returns ([H, W, 4] RGBA, [H, W] tmin)."""
    rgba = np.zeros((size, size, 4), np.float32)
    tmin = np.full((size, size), np.inf)
    light = np.array([0.5, 0.5, 0.7])
    for entry in spheres:
        c, r, col = entry[0], entry[1], entry[2]
        kind, freq = (entry[3], entry[4]) if len(entry) > 3 else ('solid', 1.0)
        oc = o - c
        b = np.sum(dirs * oc, -1)
        dd = np.sum(dirs * dirs, -1)
        disc = b * b - dd * (np.dot(oc, oc) - r * r)
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0))) / dd
        closer = hit & (t > 0) & (t < tmin)
        tmin = np.where(closer, t, tmin)
        pt = o + dirs * t[..., None]
        nrm = (pt - c) / r
        shade = 0.4 + 0.6 * np.clip(nrm @ light, 0, 1)
        shade = shade * _texture(pt - c, kind, freq)
        for k in range(3):
            rgba[..., k] = np.where(closer, col[k] * shade, rgba[..., k])
        rgba[..., 3] = np.where(closer, 1.0, rgba[..., 3])
    return np.clip(rgba, 0, 1), tmin


def render_sphere_view(c2w: np.ndarray, size: int,
                       spheres: Optional[Sequence] = None,
                       focal: Optional[float] = None) -> np.ndarray:
    """Analytically ray-trace shaded spheres: returns [H, W, 4] RGBA.

    Sphere entries are (center, radius, color) for flat shading or
    (center, radius, color, texture_kind, texture_freq) for textured.
    """
    spheres = DEFAULT_SPHERES if spheres is None else spheres
    dirs, o = _camera_dirs(c2w, size, focal)
    rgba, _ = _trace_spheres(dirs, o, spheres, size)
    return rgba


def render_hard_view(c2w: np.ndarray, size: int, supersample: int = 2,
                     focal: Optional[float] = None) -> np.ndarray:
    """Ray-trace the 'hard' scene (textured spheres + checkered ground disk)
    at `supersample`x resolution, box-downsampled to [size, size, 4] —
    anti-aliased ground truth, the analog of a real renderer's pixel
    sampling.  Returns STRAIGHT (non-premultiplied) RGBA: the box average
    of hit/miss subpixels is premultiplied color, which must be divided by
    the averaged alpha before a downstream `rgb * a + (1 - a) * bkgd`
    composite (data/datasets.py) — otherwise every silhouette pixel is
    alpha-attenuated twice and no 3-D-consistent radiance field can fit it."""
    ss = max(1, int(supersample))
    hi = size * ss
    f_hi = (focal * ss) if focal else None
    dirs, o = _camera_dirs(c2w, hi, f_hi)
    rgba, tmin = _trace_spheres(dirs, o, HARD_SPHERES, hi)

    # Ground disk (z = const), textured; composited where nearer than the
    # nearest sphere hit (tmin from the shared tracer).
    z0, disk_r, g_col, g_kind, g_freq = HARD_GROUND
    dz = dirs[..., 2]
    with np.errstate(divide='ignore', invalid='ignore'):
        t_pl = (z0 - o[2]) / dz
    pt = o + dirs * t_pl[..., None]
    in_disk = np.hypot(pt[..., 0], pt[..., 1]) < disk_r
    hit_pl = (np.abs(dz) > 1e-9) & (t_pl > 0) & in_disk & (t_pl < tmin)
    tex = _texture(pt, g_kind, g_freq)
    for k in range(3):
        rgba[..., k] = np.where(hit_pl, g_col[k] * tex, rgba[..., k])
    rgba[..., 3] = np.where(hit_pl, 1.0, rgba[..., 3])
    rgba = np.clip(rgba, 0, 1)

    if ss > 1:
        rgba = rgba.reshape(size, ss, size, ss, 4).mean(axis=(1, 3))
        # Un-premultiply: averaged rgb already carries the alpha weighting.
        a = rgba[..., 3:]
        rgba = np.concatenate(
            [np.where(a > 1e-8, rgba[..., :3] / np.maximum(a, 1e-8), 0.0), a],
            axis=-1)
    return rgba.astype(np.float32)


def make_llff_sphere_capture(root: str, n_images: int = 16, size: int = 64,
                             radius: float = 4.0,
                             scene: str = 'hard') -> str:
    """Write an LLFF / COLMAP capture of the analytic scene from orbit
    cameras: images_1/ (on black: real360 configs composite on no white
    background), poses_bounds.npy and sparse/0/cameras.bin (one PINHOLE
    camera).  The LLFF pose rows store [down, right, back] axes: the
    inverse of the loader's axis fix is applied, so that loading lands on
    the render cameras."""
    import struct

    from PIL import Image

    from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses

    os.makedirs(os.path.join(root, 'images_1'), exist_ok=True)
    focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    poses = create_spheric_poses(radius, n_poses=n_images)
    rows = []
    for i, p in enumerate(poses):
        c2w = np.eye(4)
        c2w[:3, :4] = p
        if scene == 'hard':
            rgba = render_hard_view(c2w, size, supersample=2)
        else:
            rgba = render_sphere_view(c2w, size)
        rgb = rgba[..., :3] * rgba[..., 3:]
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            os.path.join(root, 'images_1', f'{i:03d}.png'))
        hwf = np.array([size, size, focal]).reshape(3, 1)
        m = np.concatenate([p, hwf], axis=1)               # [3, 5]
        llff = np.concatenate([-m[:, 1:2], m[:, 0:1], m[:, 2:]], axis=1)
        rows.append(np.concatenate([llff.reshape(-1),
                                    [radius - 1.5, radius + 1.5]]))
    np.save(os.path.join(root, 'poses_bounds.npy'), np.stack(rows))

    os.makedirs(os.path.join(root, 'sparse', '0'), exist_ok=True)
    with open(os.path.join(root, 'sparse', '0', 'cameras.bin'), 'wb') as f:
        f.write(struct.pack('<Q', 1))
        f.write(struct.pack('<iiQQ', 1, 1, size, size))    # PINHOLE
        f.write(struct.pack('<dddd', focal, focal, size / 2, size / 2))
    return root


def make_sphere_scene(root: str, n_train: int = 24, n_val: int = 2,
                      n_test: int = 2, size: int = 64,
                      radius: float = 4.0, scene: str = 'spheres',
                      supersample: int = 2) -> str:
    """Write a Blender-layout scene (orbit cameras).

    scene='spheres' (flat-shaded, easy) or 'hard' (textured, aliasing-prone;
    ground truth supersampled `supersample`x).
    """
    from PIL import Image

    from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses

    os.makedirs(root, exist_ok=True)
    for split, n in (('train', n_train), ('val', n_val), ('test', n_test)):
        # stride val/test around the orbit so views differ from train
        poses = create_spheric_poses(radius, n_poses=max(n * 3, n_train))
        stride = max(1, len(poses) // max(n, 1))
        poses = poses[::stride][:n]
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i, p in enumerate(poses):
            c2w = np.eye(4)
            c2w[:3, :4] = p
            if scene == 'hard':
                rgba = render_hard_view(c2w, size, supersample=supersample)
            else:
                rgba = render_sphere_view(c2w, size)
            Image.fromarray((rgba * 255).astype(np.uint8)).save(
                os.path.join(root, split, f'r_{i}.png'))
            frames.append({'file_path': f'{split}/r_{i}',
                           'transform_matrix': c2w.tolist()})
        with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
            json.dump({'camera_angle_x': CAMERA_ANGLE_X, 'frames': frames}, f)
    return root
