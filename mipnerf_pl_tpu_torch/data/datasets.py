"""Datasets: host-side numpy image loading and ray generation.

Counterpart of mipnerf_pl_tpu/data/datasets.py for the single-scale Blender
(NeRF-synthetic) layout (`blender`), the multi-scale layout that
data/convert.py writes (`multi_blender`) and LLFF / COLMAP real captures
(`real360`: poses_bounds.npy, sparse/0/cameras.bin, images_<factor>/).
Rays are computed once into numpy arrays; training batches are gathered on
the host by `sample_batch` (native/gather.py), with replacement, from a
seeded numpy Generator (the same `rng.integers` draw as the JAX package,
so one seed gives both the same batches), and shipped to the device by
data/pipeline.py.  PIL and cv2 are imported inside the functions that read
files.
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional

import numpy as np

from mipnerf_pl_tpu_torch.data.poses import recenter_poses, spherify_poses
from mipnerf_pl_tpu_torch.native.gather import gather_multi
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

    def sample_indices(self, rng: np.random.Generator, batch_size: int):
        """The ray indices of a random batch (train split only)."""
        return rng.integers(0, self.num_rays, size=(batch_size,))

    def gather(self, idx: np.ndarray):
        """(Rays, pixels) of the rays at `idx`: the same rows of every ray
        field and of the pixels, in one pass over `idx` through the native
        gather (native/gather.py)."""
        *rays, pixels = gather_multi([*self.rays, self.images], idx)
        return Rays(*rays), pixels

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        """Gather a random ray batch (train split only): one index draw,
        then the same rows of every ray field and of the pixels."""
        return self.gather(self.sample_indices(rng, batch_size))


class Multicam(BaseDataset):
    """Multi-scale dataset driven by metadata.json: every entry has its own
    resolution, pix2cam, near, far and lossmult (data/convert.py)."""

    def __init__(self, data_dir, split='train', white_bkgd=True,
                 batch_type='all_images', factor=0):
        # factor is accepted as the other datasets take it; multi-scale data
        # carries its own per-image resolutions, so a downsample cannot
        # apply.
        if factor:
            import warnings
            warnings.warn(
                f'Multicam ignores data.factor={factor}: multi-scale data '
                'carries per-image resolutions in metadata.json',
                stacklevel=2)
        super().__init__(data_dir, split, white_bkgd, batch_type)
        self._init_split()

    def _load_renderings(self):
        with open(os.path.join(self.data_dir, 'metadata.json'), 'r') as fp:
            self.meta = json.load(fp)[self.split]
        self.meta = {k: np.array(self.meta[k]) for k in self.meta}
        self.images = [
            _alpha_composite(_load_image(os.path.join(self.data_dir, rel)),
                             self.white_bkgd)
            for rel in self.meta['file_path']]

    def _generate_rays(self):
        pix2cam = self.meta['pix2cam'].astype(np.float32)
        cam2world = self.meta['cam2world'].astype(np.float32)
        width = self.meta['width'].astype(np.float32)
        height = self.meta['height'].astype(np.float32)

        def res2grid(w, h):
            return np.meshgrid(
                np.arange(w, dtype=np.float32) + 0.5,   # pixel centres
                np.arange(h, dtype=np.float32) + 0.5,
                indexing='xy')

        xy = [res2grid(w, h) for w, h in zip(width, height)]
        pixel_dirs = [np.stack([x, y, np.ones_like(x)], axis=-1)
                      for x, y in xy]
        camera_dirs = [v @ p2c[:3, :3].T
                       for v, p2c in zip(pixel_dirs, pix2cam)]
        directions = [(v @ c2w[:3, :3].T).copy()
                      for v, c2w in zip(camera_dirs, cam2world)]
        origins = [np.broadcast_to(c2w[:3, -1], v.shape).copy()
                   for v, c2w in zip(directions, cam2world)]
        viewdirs = [v / np.linalg.norm(v, axis=-1, keepdims=True)
                    for v in directions]

        def per_image_scalar(key):
            return [np.broadcast_to(self.meta[key][i],
                                    origins[i][..., :1].shape
                                    ).astype(np.float32)
                    for i in range(len(self.images))]

        self.rays = Rays(
            origins=origins,
            directions=directions,
            viewdirs=viewdirs,
            radii=[pixel_radii(v) for v in directions],
            lossmult=per_image_scalar('lossmult'),
            near=per_image_scalar('near'),
            far=per_image_scalar('far'))

    def camera(self, index):
        from mipnerf_pl_tpu_torch.ops.camera import Camera, fold_pixel_center
        return Camera(
            c2w=self.meta['cam2world'][index][:3, :4].astype(np.float32),
            pix2cam=fold_pixel_center(self.meta['pix2cam'][index]),
            near=np.float32(self.meta['near'][index]),
            far=np.float32(self.meta['far'][index]),
            lossmult=np.float32(self.meta['lossmult'][index]),
        ), (int(self.meta['height'][index]), int(self.meta['width'][index]))


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


class RealData360(BaseDataset):
    """LLFF-style real captures: poses_bounds.npy, the intrinsics of
    sparse/0/cameras.bin (COLMAP binary) and the images of
    images_<factor>/.  Every 8th view is the test (and val) split, the
    rest train; the poses are recentred and spherified, and each view's
    rays take their near / far from its bounds."""

    def __init__(self, data_dir, split='train', white_bkgd=True,
                 batch_type='all_images', factor=4):
        super().__init__(data_dir, split, white_bkgd, batch_type, factor)
        self._init_split()

    def _load_renderings(self):
        suffix = f'_{self.factor}' if self.factor > 0 else ''
        imgdir = os.path.join(self.data_dir, 'images' + suffix)
        if not os.path.exists(imgdir):
            raise ValueError(f'Image folder {imgdir} does not exist.')
        imgfiles = [os.path.join(imgdir, f)
                    for f in sorted(os.listdir(imgdir))
                    if f.lower().endswith(('.jpg', '.png'))]
        images = np.stack([_load_image(f) for f in imgfiles], axis=-1)

        with open(os.path.join(self.data_dir, 'poses_bounds.npy'),
                  'rb') as fp:
            poses_arr = np.load(fp)
        poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
        bds = poses_arr[:, -2:].transpose([1, 0])
        if poses.shape[-1] != images.shape[-1]:
            raise RuntimeError(
                f'{images.shape[-1]} images vs {poses.shape[-1]} poses')

        poses[:2, 4, :] = np.array(images.shape[:2]).reshape([2, 1])
        poses[2, 4, :] = poses[2, 4, :] / max(self.factor, 1)
        # LLFF's [down, right, back] axes -> [right, up, back].
        poses = np.concatenate(
            [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
        poses = np.moveaxis(poses, -1, 0).astype(np.float32)
        images = np.moveaxis(images, -1, 0)
        bds = np.moveaxis(bds, -1, 0).astype(np.float32)

        poses = recenter_poses(poses)
        poses = spherify_poses(poses)
        i_test = np.arange(images.shape[0])[::8]
        indices = (np.array([i for i in range(images.shape[0])
                             if i not in i_test])
                   if self.split == 'train' else i_test)
        self.images = list(images[indices])
        poses = poses[indices]
        self.bds = bds[indices]
        self._read_camera()
        self.K[:2, :] /= max(self.factor, 1)
        self.K_inv = np.linalg.inv(self.K)
        self.K_inv[1:, :] *= -1
        self.camtoworlds = poses[:, :3, :4]
        self.h, self.w = self.images[0].shape[:2]
        self.n_examples = len(self.images)

    # COLMAP model id -> (name, number of parameters).
    _COLMAP_MODELS = {
        0: ('SIMPLE_PINHOLE', 3),   # f, cx, cy
        1: ('PINHOLE', 4),          # fx, fy, cx, cy
        2: ('SIMPLE_RADIAL', 4),    # f, cx, cy, k
        3: ('RADIAL', 5),           # f, cx, cy, k1, k2
        4: ('OPENCV', 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    }

    def _read_camera(self):
        """K of the first camera of cameras.bin: the camera count (u64),
        then (camera_id i32, model_id i32, width u64, height u64) and the
        model's f64 parameters.  Distortion is ignored with a warning; an
        unknown model raises."""
        with open(os.path.join(self.data_dir, 'sparse', '0', 'cameras.bin'),
                  'rb') as fid:
            struct.unpack('<Q', fid.read(8))
            _, model_id, _, _ = struct.unpack('<iiQQ', fid.read(24))
            if model_id not in self._COLMAP_MODELS:
                raise ValueError(f'unsupported COLMAP camera model id '
                                 f'{model_id}')
            name, n_params = self._COLMAP_MODELS[model_id]
            params = struct.unpack('<' + 'd' * n_params,
                                   fid.read(8 * n_params))
            if name in ('SIMPLE_PINHOLE', 'SIMPLE_RADIAL', 'RADIAL'):
                fx = fy = params[0]
                cx, cy = params[1], params[2]
                distortion = params[3:]
            else:  # PINHOLE / OPENCV
                fx, fy, cx, cy = params[:4]
                distortion = params[4:]
            if any(abs(d) > 1e-12 for d in distortion):
                import warnings
                warnings.warn(
                    f'COLMAP {name} distortion {distortion} ignored: '
                    'undistort the images first for accurate rays')
            self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])

    def _generate_rays(self):
        x, y = np.meshgrid(np.arange(self.w, dtype=np.float32) + 0.5,
                           np.arange(self.h, dtype=np.float32) + 0.5,
                           indexing='xy')
        pixel_dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
        camera_dirs = pixel_dirs @ self.K_inv.T.astype(np.float32)
        directions = [(camera_dirs @ c2w[:3, :3].T).copy()
                      for c2w in self.camtoworlds]
        origins = [np.broadcast_to(c2w[:3, -1], v.shape).copy()
                   for v, c2w in zip(directions, self.camtoworlds)]
        viewdirs = [v / np.linalg.norm(v, axis=-1, keepdims=True)
                    for v in directions]

        def per_image_scalar(vals):
            return [np.full_like(origins[i][..., :1], vals[i])
                    for i in range(len(self.images))]

        self.rays = Rays(
            origins=origins,
            directions=directions,
            viewdirs=viewdirs,
            radii=[pixel_radii(v) for v in directions],
            lossmult=[np.ones_like(o[..., :1]) for o in origins],
            near=per_image_scalar(self.bds[:, 0]),
            far=per_image_scalar(self.bds[:, 1]))

    def camera(self, index):
        from mipnerf_pl_tpu_torch.ops.camera import Camera, fold_pixel_center
        return Camera(
            c2w=np.asarray(self.camtoworlds[index][:3, :4], np.float32),
            pix2cam=fold_pixel_center(self.K_inv.astype(np.float32)),
            near=np.float32(self.bds[index, 0]),
            far=np.float32(self.bds[index, 1]),
            lossmult=np.float32(1.0),
        ), (self.h, self.w)


dataset_dict = {
    'blender': Blender,
    'multi_blender': Multicam,
    'real360': RealData360,
}
