"""Datasets: host-side numpy image loading and ray generation.

Counterpart of mipnerf_pl_tpu/data/datasets.py for the single-scale Blender
(NeRF-synthetic) layout.  Rays are computed once into numpy arrays;
training batches are gathered on the host by `sample_batch`, with
replacement, from a seeded numpy Generator (the same `rng.integers` draw as
the JAX package, so one seed gives both the same batches), and shipped to
the device by data/pipeline.py.  PIL and cv2 are imported inside the
functions that read files.

The multi-scale (`multi_blender`) and LLFF (`real360`) datasets are not
ported yet: their names are registered and raise NotImplementedError.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from mipnerf_pl_tpu_torch.rays import Rays, namedtuple_map


def _load_image(fname: str) -> np.ndarray:
    from PIL import Image
    with open(fname, 'rb') as f:
        return np.array(Image.open(f), dtype=np.float32) / 255.0


def _alpha_composite(image: np.ndarray, white_bkgd: bool) -> np.ndarray:
    """RGBA -> RGB; optionally composite onto white."""
    if image.shape[-1] == 4:
        if white_bkgd:
            image = image[..., :3] * image[..., -1:] + (1.0 - image[..., -1:])
        else:
            image = image[..., :3] * image[..., -1:]
    return image[..., :3]


def pixel_radii(directions: np.ndarray) -> np.ndarray:
    """Base radius of each pixel's cone from the x-neighbour direction
    distance: `dx * 2 / sqrt(12)`, half the neighbour distance widened to
    the radius of a disc with the pixel's footprint variance."""
    dx = np.sqrt(np.sum((directions[:-1, :, :] - directions[1:, :, :]) ** 2,
                        -1))
    dx = np.concatenate([dx, dx[-2:-1, :]], 0)
    return (dx * 2 / np.sqrt(12))[..., None].astype(np.float32)


class BaseDataset:
    """Base class: subclasses implement _load_renderings/_generate_rays."""

    def __init__(self, data_dir: str, split: str, white_bkgd: bool = True,
                 batch_type: str = 'all_images', factor: int = 0):
        self.near = 2.0
        self.far = 6.0
        self.split = split
        self.data_dir = data_dir
        self.white_bkgd = white_bkgd
        self.batch_type = batch_type
        self.factor = factor
        self.images: List[np.ndarray] = []
        self.rays: Optional[Rays] = None

    def _init_split(self):
        self._load_renderings()
        self._generate_rays()
        if self.split == 'train':
            if self.batch_type != 'all_images':
                raise ValueError('training requires batch_type=all_images '
                                 '(flattened rays)')
            self.images = self._flatten(self.images)
            self.rays = namedtuple_map(self._flatten, self.rays)
        elif self.batch_type != 'single_image':
            raise ValueError('val/test require batch_type=single_image')

    def _flatten(self, x):
        x = [y.reshape([-1, y.shape[-1]]) for y in x]
        if self.batch_type == 'all_images':
            x = np.concatenate(x, axis=0)
        return x

    def _generate_rays(self):
        raise NotImplementedError

    def _load_renderings(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        rays = Rays(*[getattr(self.rays, k)[index] for k in Rays._fields])
        return rays, self.images[index]

    @property
    def num_rays(self) -> int:
        if self.split != 'train':
            raise ValueError('num_rays is defined for the train split')
        return self.images.shape[0]

    def camera(self, index):
        """(Camera, (h, w)) for ray generation on the device
        (ops/camera.py): a pose and intrinsics cross to the device instead
        of the materialized ray bundle."""
        raise NotImplementedError

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        """Gather a random ray batch (train split only): one index draw,
        then the same rows of every ray field and of the pixels."""
        idx = rng.integers(0, self.num_rays, size=(batch_size,))
        return Rays(*[f[idx] for f in self.rays]), self.images[idx]


class Blender(BaseDataset):
    """Single-scale NeRF-synthetic dataset (transforms_{split}.json), with
    the factor=2 half-resolution INTER_AREA downsample."""

    def __init__(self, data_dir, split='train', white_bkgd=True,
                 batch_type='all_images', factor=0):
        super().__init__(data_dir, split, white_bkgd, batch_type, factor)
        self._init_split()

    def _load_renderings(self):
        with open(os.path.join(self.data_dir,
                               f'transforms_{self.split}.json'), 'r') as fp:
            meta = json.load(fp)
        images, cams = [], []
        for frame in meta['frames']:
            fname = os.path.join(self.data_dir, frame['file_path'] + '.png')
            image = _load_image(fname)
            if self.factor == 2:
                import cv2
                h, w = [hw // 2 for hw in image.shape[:2]]
                image = cv2.resize(image, (w, h),
                                   interpolation=cv2.INTER_AREA)
            elif self.factor > 0:
                raise ValueError(
                    f'Blender supports factor 0 or 2, got {self.factor}')
            cams.append(np.array(frame['transform_matrix'], dtype=np.float32))
            images.append(_alpha_composite(image, self.white_bkgd))
        self.images = images
        self.h, self.w = images[0].shape[:2]
        self.camtoworlds = cams
        camera_angle_x = float(meta['camera_angle_x'])
        self.focal = 0.5 * self.w / np.tan(0.5 * camera_angle_x)

    def _generate_rays(self):
        x, y = np.meshgrid(np.arange(self.w, dtype=np.float32),
                           np.arange(self.h, dtype=np.float32), indexing='xy')
        # OpenGL camera: -z forward, +y up; pixel centers at +0.5.
        camera_dirs = np.stack(
            [(x - self.w * 0.5 + 0.5) / self.focal,
             -(y - self.h * 0.5 + 0.5) / self.focal,
             -np.ones_like(x)], axis=-1)
        directions = [(camera_dirs @ c2w[:3, :3].T).copy()
                      for c2w in self.camtoworlds]
        origins = [np.broadcast_to(c2w[:3, -1], v.shape).copy()
                   for v, c2w in zip(directions, self.camtoworlds)]
        viewdirs = [v / np.linalg.norm(v, axis=-1, keepdims=True)
                    for v in directions]

        def const(val):
            return [np.full_like(origins[i][..., :1], val)
                    for i in range(len(self.images))]

        self.rays = Rays(
            origins=origins,
            directions=directions,
            viewdirs=viewdirs,
            radii=[pixel_radii(v) for v in directions],
            lossmult=const(1.0),
            near=const(self.near),
            far=const(self.far))

    def camera(self, index):
        from mipnerf_pl_tpu_torch.ops.camera import (Camera,
                                                     pix2cam_from_focal)
        return Camera(
            c2w=np.asarray(self.camtoworlds[index][:3, :4], np.float32),
            pix2cam=pix2cam_from_focal(self.w, self.h, self.focal),
            near=np.float32(self.near), far=np.float32(self.far),
            lossmult=np.float32(1.0),
        ), (self.h, self.w)


def _not_ported(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f'dataset {name!r} is not ported yet (ROADMAP.md, the port\'s '
            'queue 1); use "blender"')
    return build


dataset_dict = {
    'blender': Blender,
    'multi_blender': _not_ported('multi_blender'),
    'real360': _not_ported('real360'),
}
