"""NeRF-synthetic (Blender) layout: transforms_<split>.json and
<split>/r_<i>.png (RGBA), what the port's `blender` dataset reads.  The
scene's 'views' gives the number of views of each split; each split has
its own orbit."""

from __future__ import annotations

import json
import math
import os

import numpy as np

from benchmark.reference import Views, load_png
from benchmark.scenes.hard import (CAMERA_ANGLE_X, orbit_poses,
                                   render_hard_view, save_png)


# The sizes of the CPU tests' small checkout (benchmark/tests/tiny.py).
SMALL = {'width': 16, 'height': 16,
         'views': {'train': 3, 'val': 1, 'test': 2}}


def write(scene: dict, splits, seed: int, root: str, device) -> str:
    width, height = scene['width'], scene['height']
    counts = {s: scene['views'][s] for s in splits}
    os.makedirs(root, exist_ok=True)
    focal = 0.5 * width / math.tan(0.5 * CAMERA_ANGLE_X)
    for s, (split, n) in enumerate(sorted(counts.items())):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, pose in enumerate(orbit_poses(n, seed, s)):
            rgba = render_hard_view(pose, width, height, focal, device)
            save_png(os.path.join(root, split, f'r_{i}.png'), rgba)
            c2w = np.eye(4)
            c2w[:3, :4] = pose
            frames.append({'file_path': f'{split}/r_{i}',
                           'transform_matrix': c2w.tolist()})
        with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
            json.dump({'camera_angle_x': CAMERA_ANGLE_X, 'frames': frames}, f)
    return root


def views(scene: dict, root: str, split: str, white_bkgd: bool) -> Views:
    """RGBA PNGs composited on white (or black), OpenGL cameras, near 2
    and far 6."""
    with open(os.path.join(root, f'transforms_{split}.json')) as f:
        meta = json.load(f)
    c2w, images = [], []
    for frame in meta['frames']:
        c2w.append(np.asarray(frame['transform_matrix'], np.float64)[:3])
        rgba = load_png(os.path.join(root, frame['file_path'] + '.png'))
        a = rgba[..., 3:]
        images.append(rgba[..., :3] * a + (1.0 - a if white_bkgd else 0.0))
    h, w = images[0].shape[:2]
    focal = 0.5 * w / math.tan(0.5 * float(meta['camera_angle_x']))
    # [(x + .5 - w/2) / f, -(y + .5 - h/2) / f, -1]
    pix2cam = np.array([[1 / focal, 0, (0.5 - 0.5 * w) / focal],
                        [0, -1 / focal, (0.5 * h - 0.5) / focal],
                        [0, 0, -1.0]])
    n = len(c2w)
    return Views(np.stack(c2w), pix2cam, np.full(n, 2.0), np.full(n, 6.0),
                 images, h, w)
