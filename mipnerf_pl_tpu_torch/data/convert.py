"""Multi-scale dataset generator: a Blender scene -> the multi-scale layout.

Counterpart of mipnerf_pl_tpu/data/convert.py.  Each source image becomes
a 2x box-filter pyramid of `n_down` levels, and one `metadata.json` holds
every entry's camera as a `pix2cam` matrix; `Multicam` (data/datasets.py)
reads the result.

The contract (the dataset and eval's scale buckets depend on it):
  * metadata.json keys per split: file_path, cam2world, width, height,
    focal, label, near, far, lossmult, pix2cam, each a list over entries;
  * entry order is image-major, scale-minor (cli/eval.py groups every
    `--scale` consecutive entries into one resolution bucket);
  * lossmult = 4^level, focal halves per level, near/far = 2/6.

`split_entries` builds a split's entries and images in memory;
`convert_to_nerfdata` writes them.  PIL is imported inside the functions
that read or write files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

NEAR, FAR = 2.0, 6.0
SPLITS = ('train', 'val', 'test')


def load_renderings(data_dir: str, split: str) -> dict:
    """One split of a Blender scene as stacked arrays: {'images': [N, H, W,
    C] float32 in [0, 1], 'camtoworlds': [N, 4, 4], 'focal': float}."""
    from PIL import Image
    with open(os.path.join(data_dir, f'transforms_{split}.json'), 'r') as fp:
        meta = json.load(fp)
    frames = meta['frames']
    images = np.stack([
        np.asarray(Image.open(os.path.join(data_dir,
                                           fr['file_path'] + '.png')),
                   dtype=np.float32) / 255.0
        for fr in frames])
    camtoworlds = np.stack([np.asarray(fr['transform_matrix'], np.float64)
                            for fr in frames])
    width = images.shape[2]
    focal = 0.5 * width / np.tan(0.5 * float(meta['camera_angle_x']))
    return {'images': images, 'camtoworlds': camtoworlds, 'focal': focal}


def image_pyramid(stack: np.ndarray, n_levels: int) -> list:
    """2x box-filter pyramid of an [N, H, W, C] stack: level 0 is the input,
    each further level averages 2x2 blocks."""
    levels = [stack]
    for _ in range(n_levels - 1):
        n, h, w, c = levels[-1].shape
        levels.append(levels[-1]
                      .reshape(n, h // 2, 2, w // 2, 2, c)
                      .mean(axis=(2, 4)))
    return levels


def pix2cam_matrix(focal: float, width: int, height: int) -> np.ndarray:
    """Inverse intrinsics for the Blender camera convention: the inverse of
    the map from a camera-space direction (x right, y up, looking down -z)
    to homogeneous pixel coordinates with y growing downward, applied to
    pixel centres (u + 0.5, v + 0.5, 1) by the ray generators."""
    cam2pix = np.array([
        [focal, 0.0, -0.5 * width],
        [0.0, -focal, -0.5 * height],
        [0.0, 0.0, -1.0],
    ])
    return np.linalg.inv(cam2pix)


def split_entries(data: dict, n_down: int, imgdir: str
                  ) -> Tuple[Dict[str, list], List[Tuple[str, np.ndarray]]]:
    """The multi-scale entries of one split from `load_renderings`' arrays:
    (its metadata, columnar, as metadata.json holds it; [(file_path, uint8
    HWC image)] in entry order)."""
    pyramid = image_pyramid(data['images'], n_down)
    entries, images = [], []
    for i in range(len(data['images'])):
        for level, stack in enumerate(pyramid):
            img = stack[i]
            fname = f'{imgdir}/{i:03d}_d{level}.png'
            images.append((fname, (img * 255.0).astype(np.uint8)))
            height, width = img.shape[:2]
            focal = data['focal'] / 2.0 ** level
            entries.append({
                'file_path': fname,
                'cam2world': data['camtoworlds'][i].tolist(),
                'width': width,
                'height': height,
                'focal': focal,
                'label': level,
                'near': NEAR,
                'far': FAR,
                'lossmult': 4.0 ** level,
                'pix2cam': pix2cam_matrix(focal, width, height).tolist(),
            })
    return {k: [e[k] for e in entries] for k in entries[0]}, images


def convert_to_nerfdata(basedir: str, newdir: str, n_down: int) -> None:
    """Convert the Blender scene in basedir into the multi-scale layout in
    newdir: images_{split}/NNN_dL.png and metadata.json."""
    from PIL import Image
    os.makedirs(newdir, exist_ok=True)
    metadata = {}
    for split in SPLITS:
        imgdir = f'images_{split}'
        os.makedirs(os.path.join(newdir, imgdir), exist_ok=True)
        metadata[split], images = split_entries(
            load_renderings(basedir, split), n_down, imgdir)
        for fname, img in images:
            Image.fromarray(img).save(os.path.join(newdir, fname))
    with open(os.path.join(newdir, 'metadata.json'), 'w') as fp:
        json.dump(metadata, fp, indent=4)
