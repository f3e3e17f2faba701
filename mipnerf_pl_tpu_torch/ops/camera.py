"""Camera-to-rays expansion on the device.

Counterpart of mipnerf_pl_tpu/ops/camera.py.  A `Camera` is a pose and a
3x3 raw-pixel -> camera-direction matrix (`pix2cam`, with each dataset's
pixel-centre / axis conventions folded in); `camera_rays` expands it into
the full [h, w, ...] ray bundle on the camera tensors' device, so a frame's
rays never exist on the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from mipnerf_pl_tpu_torch.rays import Rays


class Camera(NamedTuple):
    c2w: Any          # [3, 4] camera-to-world (rotation | translation)
    pix2cam: Any      # [3, 3] raw-pixel -> camera-space direction
    near: Any         # scalar
    far: Any          # scalar
    lossmult: Any     # scalar (multi-scale weighting; 1.0 otherwise)


def fold_pixel_center(pix2cam: np.ndarray) -> np.ndarray:
    """Fold the +0.5 pixel-centre offset into a pix2cam that expects it:
    P @ [x+.5, y+.5, 1] == P' @ [x, y, 1] with P' = [P0, P1, P2 + .5 P0 +
    .5 P1]."""
    p = np.asarray(pix2cam, np.float32).copy()
    p[:, 2] = p[:, 2] + 0.5 * p[:, 0] + 0.5 * p[:, 1]
    return p


def pix2cam_from_focal(w: int, h: int, focal: float) -> np.ndarray:
    """Blender/OpenGL convention: -z forward, +y up, pixel centres at +0.5:
    [(x - w/2 + .5)/f, -(y - h/2 + .5)/f, -1]."""
    f = float(focal)
    return np.array([
        [1.0 / f, 0.0, (0.5 - 0.5 * w) / f],
        [0.0, -1.0 / f, (0.5 * h - 0.5) / f],
        [0.0, 0.0, -1.0],
    ], dtype=np.float32)


def camera_rays(cam: Camera, h: int, w: int, device=None) -> Rays:
    """Expand a Camera into an image-shaped [h, w, ...] ray bundle.

    Separable multiply-adds in f32 in the same order as the JAX version, so
    the two agree to f32 rounding.  `device` defaults to the device of
    `cam.c2w` when it is a tensor, else the CPU."""
    if device is None:
        device = cam.c2w.device if torch.is_tensor(cam.c2w) else 'cpu'
    f32 = torch.float32
    c2w = torch.as_tensor(cam.c2w, dtype=f32, device=device)
    p = torch.as_tensor(cam.pix2cam, dtype=f32, device=device)
    x = torch.arange(w, dtype=f32, device=device)
    y = torch.arange(h, dtype=f32, device=device)

    # d_cam[i, j, :] = P @ [x_j, y_i, 1]
    d_cam = (x[None, :, None] * p[:, 0] + y[:, None, None] * p[:, 1]
             + p[:, 2])                                     # [h, w, 3]
    rot = c2w[:3, :3]
    directions = (d_cam[..., 0:1] * rot[:, 0] + d_cam[..., 1:2] * rot[:, 1]
                  + d_cam[..., 2:3] * rot[:, 2])            # [h, w, 3]
    origins = c2w[:3, -1].expand(directions.shape)
    viewdirs = directions / torch.linalg.norm(directions, dim=-1,
                                              keepdim=True)

    # Cone base radii from the row-neighbour direction distance; the last
    # row reuses the previous difference.
    dx = torch.sqrt(torch.sum((directions[:-1] - directions[1:]) ** 2, -1))
    dx = torch.cat([dx, dx[-2:-1]], 0)
    radii = (dx * 2.0 / np.sqrt(12.0))[..., None]

    ones = torch.ones_like(origins[..., :1])
    scalar = lambda v: torch.as_tensor(v, dtype=f32, device=device)  # noqa: E731
    return Rays(
        origins=origins,
        directions=directions,
        viewdirs=viewdirs,
        radii=radii,
        lossmult=ones * scalar(cam.lossmult),
        near=ones * scalar(cam.near),
        far=ones * scalar(cam.far),
    )
