"""The orbit video's cameras and rays: `n_poses` poses on the spheric orbit
at `scales` resolution levels, scale-major (every full-resolution frame
first), each level's rays through its own pix2cam.

Counterpart of mipnerf_pl_tpu/data/render_path.py.  The camera form feeds
`MipNeRFSystem.render_camera` (rays built on the device); the ray form is
the same frames as host arrays, and the two agree to f32 rounding.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mipnerf_pl_tpu_torch.data.datasets import pixel_radii
from mipnerf_pl_tpu_torch.rays import Rays
from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses


def _level(base_focal: float, base_size: Tuple[int, int], i: int):
    """(w, h, pix2cam) of level i: the size and focal halved i times; the
    pix2cam takes pixel centres (x + .5, y + .5, 1)."""
    w = int(base_size[0] / 2 ** i)
    h = int(base_size[1] / 2 ** i)
    focal = base_focal / 2 ** i
    fx = fy = focal
    cx, cy = w * 0.5, h * 0.5
    return w, h, np.array([
        [1.0 / fx, 0.0, -cx / fx],
        [0.0, -1.0 / fy, cy / fy],
        [0.0, 0.0, -1.0],
    ], dtype=np.float32)


def spheric_render_cameras(base_focal: float, base_size: Tuple[int, int],
                           scales: int = 1, radius: float = 4.0,
                           n_poses: int = 120, near: float = 2.0,
                           far: float = 6.0):
    """[(Camera, (h, w))] of the orbit, scale-major: the camera form of
    `spheric_render_rays`."""
    from mipnerf_pl_tpu_torch.ops.camera import Camera, fold_pixel_center
    cam2world = create_spheric_poses(radius, n_poses)
    out = []
    for i in range(scales):
        w, h, pix2cam = _level(base_focal, base_size, i)
        pix2cam = fold_pixel_center(pix2cam)
        for c2w in cam2world:
            cam = Camera(c2w=c2w[:3, :4].astype(np.float32),
                         pix2cam=pix2cam, near=np.float32(near),
                         far=np.float32(far), lossmult=np.float32(1.0))
            out.append((cam, (h, w)))
    return out


def spheric_render_rays(base_focal: float, base_size: Tuple[int, int],
                        scales: int = 1, radius: float = 4.0,
                        n_poses: int = 120, near: float = 2.0,
                        far: float = 6.0) -> List[Rays]:
    """[H, W, ...] Rays of each frame of the orbit, `scales * n_poses` of
    them, scale-major."""
    cam2world = create_spheric_poses(radius, n_poses)
    all_rays: List[Rays] = []
    for i in range(scales):
        w, h, pix2cam = _level(base_focal, base_size, i)
        x, y = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                           np.arange(h, dtype=np.float32) + 0.5,
                           indexing='xy')
        pixel_dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
        camera_dirs = pixel_dirs @ pix2cam[:3, :3].T
        for c2w in cam2world:
            c2w = c2w.astype(np.float32)
            directions = (camera_dirs @ c2w[:3, :3].T).astype(np.float32)
            origins = np.broadcast_to(c2w[:3, -1], directions.shape).copy()
            viewdirs = directions / np.linalg.norm(directions, axis=-1,
                                                   keepdims=True)
            ones = np.ones_like(origins[..., :1])
            all_rays.append(Rays(
                origins=origins,
                directions=directions,
                viewdirs=viewdirs.astype(np.float32),
                radii=pixel_radii(directions),
                lossmult=ones,
                near=ones * near,
                far=ones * far))
    return all_rays
