"""LLFF / COLMAP capture layout: images_<factor>/<i>.png (RGB on black),
poses_bounds.npy and sparse/0/cameras.bin (PINHOLE), what the port's
`real360` dataset reads.  The scene's 'views' is the capture's number of
views, 'factor' the downscale of images_<factor>/ from the sensor's size;
the images are written at the scene's width x height, the intrinsics of
the full-size sensor (factor times larger) in cameras.bin, the poses as
LLFF's [down, right, back] rows with near / far bounds radius -+ 1.5."""

from __future__ import annotations

import math
import os
import struct

import numpy as np

from benchmark.reference import Views, load_png
from benchmark.scenes.hard import (CAMERA_ANGLE_X, ORBIT_RADIUS, orbit_poses,
                                   render_hard_view, save_png)


# The sizes of the CPU tests' small checkout (benchmark/tests/tiny.py).
SMALL = {'width': 24, 'height': 16, 'views': 9}


def write(scene: dict, splits, seed: int, root: str, device) -> str:
    """Every view of the capture, whatever the splits (views() takes every
    8th as the test split)."""
    width, height = scene['width'], scene['height']
    views, factor = int(scene['views']), int(scene['factor'])
    imgdir = os.path.join(root, f'images_{factor}')
    os.makedirs(imgdir, exist_ok=True)
    focal = 0.5 * width / math.tan(0.5 * CAMERA_ANGLE_X)
    rows = []
    for i, pose in enumerate(orbit_poses(views, seed)):
        rgba = render_hard_view(pose, width, height, focal, device)
        save_png(os.path.join(imgdir, f'{i:03d}.png'),
                 rgba[..., :3] * rgba[..., 3:])
        hwf = np.array([height * factor, width * factor,
                        focal * factor]).reshape(3, 1)
        m = np.concatenate([pose, hwf], axis=1)
        llff = np.concatenate([-m[:, 1:2], m[:, 0:1], m[:, 2:]], axis=1)
        rows.append(np.concatenate([llff.reshape(-1),
                                    [ORBIT_RADIUS - 1.5,
                                     ORBIT_RADIUS + 1.5]]))
    np.save(os.path.join(root, 'poses_bounds.npy'), np.stack(rows))
    os.makedirs(os.path.join(root, 'sparse', '0'), exist_ok=True)
    with open(os.path.join(root, 'sparse', '0', 'cameras.bin'), 'wb') as f:
        f.write(struct.pack('<Q', 1))
        f.write(struct.pack('<iiQQ', 1, 1, width * factor, height * factor))
        f.write(struct.pack('<dddd', focal * factor, focal * factor,
                            width * factor / 2, height * factor / 2))
    return root


def _normalize(v):
    return v / np.linalg.norm(v)


def _inverse_rigid(frame):
    """4x4 inverse of a [3, 4] camera-to-world frame."""
    m = np.eye(4)
    m[:3] = frame
    return np.linalg.inv(m)


def views(scene: dict, root: str, split: str, white_bkgd: bool) -> Views:
    """The poses are turned from LLFF's [down, right,
    back] to [right, up, back], re-expressed in the average camera's frame
    (LLFF's recenter), then centred on the point nearest every optical
    axis with +z along the cameras' mean offset from it (LLFF's spherify
    frame, without its rescale); every 8th view is the test split."""
    factor = int(scene['factor'])
    imgdir = os.path.join(root, f'images_{factor}')
    files = sorted(f for f in os.listdir(imgdir)
                   if f.lower().endswith(('.png', '.jpg')))
    arr = np.load(os.path.join(root, 'poses_bounds.npy')).astype(np.float64)
    poses = arr[:, :15].reshape(-1, 3, 5)[:, :, :4]
    bds = arr[:, 15:]
    poses = np.concatenate([poses[:, :, 1:2], -poses[:, :, 0:1],
                            poses[:, :, 2:]], 2)
    # Recenter on the average camera.
    z = _normalize(poses[:, :, 2].sum(0))
    x = _normalize(np.cross(poses[:, :, 1].sum(0), z))
    avg = np.stack([x, np.cross(z, x), z, poses[:, :, 3].mean(0)], -1)
    poses = np.einsum('ij,njk->nik', _inverse_rigid(avg),
                      np.concatenate([poses, np.tile([[[0, 0, 0, 1.0]]],
                                                     (len(poses), 1, 1))],
                                     1))[:, :3]
    # Spherify's frame: the focus point of the optical axes.
    d, o = poses[:, :, 2], poses[:, :, 3]
    proj = np.eye(3)[None] - d[:, :, None] * d[:, None, :]
    center = np.linalg.solve(np.einsum('nji,njk->ik', proj, proj),
                             np.einsum('nji,njk,nk->i', proj, proj, o))
    up = _normalize((o - center).mean(0))
    right = _normalize(np.cross([0.1, 0.2, 0.3], up))
    frame = np.stack([right, np.cross(up, right), up, center], -1)
    poses = np.einsum('ij,njk->nik', _inverse_rigid(frame),
                      np.concatenate([poses, np.tile([[[0, 0, 0, 1.0]]],
                                                     (len(poses), 1, 1))],
                                     1))[:, :3]
    with open(os.path.join(root, 'sparse', '0', 'cameras.bin'), 'rb') as f:
        struct.unpack('<Q', f.read(8))
        _, model, _, _ = struct.unpack('<iiQQ', f.read(24))
        if model != 1:
            raise ValueError('the benchmark writes PINHOLE cameras only')
        fx, fy, cx, cy = (v / factor for v in
                          struct.unpack('<dddd', f.read(32)))
    # [(x + .5 - cx) / fx, -(y + .5 - cy) / fy, -1]
    pix2cam = np.array([[1 / fx, 0, (0.5 - cx) / fx],
                        [0, -1 / fy, (cy - 0.5) / fy], [0, 0, -1.0]])
    test = np.arange(len(files))[::8]
    keep = (test if split == 'test' else
            np.array([i for i in range(len(files)) if i not in test]))
    images = [load_png(os.path.join(imgdir, files[i]))[..., :3]
              for i in keep]
    h, w = images[0].shape[:2]
    return Views(poses[keep], pix2cam, bds[keep, 0], bds[keep, 1], images,
                 h, w)
