"""The port's datasets, batcher and synthetic scenes against the JAX
package (CPU): the same files and seeds give the same arrays bit for bit
(both sides are numpy on the host; the batcher hands out the gathered
rows unchanged, as tensors)."""

import os
import time

import numpy as np
import pytest
import torch

from helpers import make_blender_scene
from mipnerf_pl_tpu.data import synthetic as jsynthetic
from mipnerf_pl_tpu.data.datasets import Blender as JBlender
from mipnerf_pl_tpu.data.pipeline import TrainBatcher as JTrainBatcher
from mipnerf_pl_tpu_torch.data import synthetic
from mipnerf_pl_tpu_torch.data.datasets import (Blender, RealData360,
                                                _alpha_composite,
                                                dataset_dict, pixel_radii)
from mipnerf_pl_tpu_torch.data.pipeline import TrainBatcher
from mipnerf_pl_tpu_torch.rays import Rays


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp('scene')),
                              n_frames=3, size=16)


def _same_rays(got, want):
    for name in Rays._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, list):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize('split,batch_type,factor', [
    ('train', 'all_images', 0), ('val', 'single_image', 0),
    ('test', 'single_image', 0), ('train', 'all_images', 2),
    ('val', 'single_image', 2)])
def test_blender_equals_jax(scene, split, batch_type, factor):
    kw = dict(data_dir=scene, split=split, white_bkgd=split != 'test',
              batch_type=batch_type, factor=factor)
    ours, theirs = Blender(**kw), JBlender(**kw)
    assert len(ours) == len(theirs)
    assert (ours.h, ours.w) == (theirs.h, theirs.w) == \
        ((8, 8) if factor == 2 else (16, 16))
    _same_rays(ours.rays, theirs.rays)
    if split == 'train':
        np.testing.assert_array_equal(ours.images, theirs.images)
        assert ours.num_rays == theirs.num_rays
        a = ours.sample_batch(np.random.default_rng(5), 32)
        b = theirs.sample_batch(np.random.default_rng(5), 32)
        _same_rays(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    else:
        for i in range(len(ours)):
            (ra, ia), (rb, ib) = ours[i], theirs[i]
            _same_rays(ra, rb)
            np.testing.assert_array_equal(ia, ib)
            (ca, hwa), (cb, hwb) = ours.camera(i), theirs.camera(i)
            assert hwa == hwb
            for x, y in zip(ca, cb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_dataset_registry_and_refusals(scene, tmp_path):
    assert dataset_dict['blender'] is Blender
    assert dataset_dict['real360'] is RealData360
    # multi_blender builds on the converted scene.
    from mipnerf_pl_tpu_torch.data.convert import convert_to_nerfdata
    from mipnerf_pl_tpu_torch.data.datasets import Multicam
    convert_to_nerfdata(scene, str(tmp_path / 'multi'), 2)
    multi = dataset_dict['multi_blender'](data_dir=str(tmp_path / 'multi'),
                                          split='train')
    assert isinstance(multi, Multicam)
    assert multi.num_rays == 3 * (16 * 16 + 8 * 8)
    with pytest.raises(ValueError, match='factor'):
        Blender(scene, 'train', factor=4)
    with pytest.raises(ValueError, match='all_images'):
        Blender(scene, 'train', batch_type='single_image')
    with pytest.raises(NotImplementedError):
        from mipnerf_pl_tpu_torch.data.datasets import BaseDataset
        BaseDataset(scene, 'val').camera(0)
    rgba = np.random.default_rng(0).uniform(size=(4, 4, 4)).astype(np.float32)
    from mipnerf_pl_tpu.data.datasets import _alpha_composite as jcomp
    from mipnerf_pl_tpu.data.datasets import pixel_radii as jradii
    for white in (True, False):
        np.testing.assert_array_equal(_alpha_composite(rgba, white),
                                      jcomp(rgba, white))
    d = np.random.default_rng(1).normal(size=(5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(pixel_radii(d), jradii(d))


@pytest.mark.parametrize('prefetch,steps_per_call',
                         [(0, 1), (0, 3), (2, 1), (2, 3)])
def test_batcher_equals_jax(scene, prefetch, steps_per_call):
    """The first 3 batches, bit for bit, on the CPU device; close()
    returns."""
    ours = TrainBatcher(Blender(scene, 'train'), 40, seed=9,
                        prefetch=prefetch, steps_per_call=steps_per_call,
                        device='cpu')
    theirs = JTrainBatcher(JBlender(scene, 'train'), 40, seed=9,
                           prefetch=prefetch, steps_per_call=steps_per_call)
    try:
        for _ in range(3):
            (ra, pa), (rb, pb) = next(ours), next(theirs)
            shape = (3, 40) if steps_per_call == 3 else (40,)
            assert all(torch.is_tensor(f) and f.shape[:-1] == shape
                       and f.dtype == torch.float32
                       and f.device.type == 'cpu' for f in (*ra, pa))
            _same_rays(Rays(*(f.numpy() for f in ra)), rb)
            np.testing.assert_array_equal(pa.numpy(), np.asarray(pb))
    finally:
        t0 = time.monotonic()
        ours.close()
        theirs.close()
        assert time.monotonic() - t0 < 10.0
    assert ours._thread is None or not ours._thread.is_alive()


def test_batcher_producer_failure_reaches_consumer():
    class Broken:
        calls = 0

        def sample_batch(self, rng, n):
            self.calls += 1
            if self.calls > 1:
                raise KeyError('boom')
            z = np.zeros((n, 3), np.float32)
            return Rays(z, z, z, z[:, :1], z[:, :1], z[:, :1], z[:, :1]), z

    batcher = TrainBatcher(Broken(), 4, prefetch=1)
    with pytest.raises(RuntimeError, match='producer') as err:
        for _ in range(3):
            next(batcher)
    assert isinstance(err.value.__cause__, KeyError)
    batcher.close()
    assert not batcher._thread.is_alive()
    closed = TrainBatcher(Broken(), 4, prefetch=0)
    closed.close()


@pytest.mark.parametrize('which', ['spheres', 'hard'])
def test_sphere_scene_files_equal_jax(tmp_path, which):
    kw = dict(n_train=3, n_val=1, n_test=1, size=12, scene=which)
    a = synthetic.make_sphere_scene(str(tmp_path / 'port'), **kw)
    b = jsynthetic.make_sphere_scene(str(tmp_path / 'jax'), **kw)
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names
    for split in ('train', 'val', 'test'):
        with open(os.path.join(a, f'transforms_{split}.json')) as fa, \
                open(os.path.join(b, f'transforms_{split}.json')) as fb:
            assert fa.read() == fb.read()
        for png in sorted(os.listdir(os.path.join(b, split))):
            with open(os.path.join(a, split, png), 'rb') as fa, \
                    open(os.path.join(b, split, png), 'rb') as fb:
                assert fa.read() == fb.read(), png
    pose = np.eye(4)
    pose[:3, 3] = [0.0, 0.0, 4.0]
    np.testing.assert_array_equal(synthetic.render_sphere_view(pose, 10),
                                  jsynthetic.render_sphere_view(pose, 10))
    np.testing.assert_array_equal(synthetic.render_hard_view(pose, 10),
                                  jsynthetic.render_hard_view(pose, 10))
