"""The port's real-capture path against the JAX package on the CPU: the
pose normalisations (1e-6), the synthetic LLFF capture (byte for byte),
RealData360's images, rays and cameras (bit for bit), its COLMAP camera
models, and the two training-quality tools run small: real360_smoke
(cli.train -> cli.eval at data.factor 1 on a 16 px capture) and
quality_smoke (its line, and exit 1 under --min_psnr)."""

import os

import numpy as np
import pytest

from mipnerf_pl_tpu.data import poses as jposes
from mipnerf_pl_tpu.data import synthetic as jsynthetic
from mipnerf_pl_tpu.data.datasets import RealData360 as JRealData360
from mipnerf_pl_tpu_torch.data import poses
from mipnerf_pl_tpu_torch.data import synthetic
from mipnerf_pl_tpu_torch.data.datasets import RealData360, dataset_dict
from mipnerf_pl_tpu_torch.rays import Rays
from test_real360 import make_llff_capture

POSE_TOL = dict(rtol=1e-6, atol=1e-6)


def _pose_stack(seed=0, n=9):
    """[n, 3, 5] camera-to-world poses with an hwf column: noisy orbit
    cameras, as a real capture gives them."""
    from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses
    rng = np.random.default_rng(seed)
    base = create_spheric_poses(4.0, n_poses=n)
    base[:, :, 3] += rng.normal(size=(n, 3)) * 0.2
    hwf = np.broadcast_to(np.array([[16.0], [16.0], [20.0]]), (n, 3, 1))
    return np.concatenate([base, hwf], axis=-1).astype(np.float32)


def test_poses_match_jax():
    p = _pose_stack()
    rng = np.random.default_rng(1)
    fwd, up, pos = rng.normal(size=(3, 3))
    np.testing.assert_allclose(poses.camera_basis(fwd, up, pos),
                               jposes.camera_basis(fwd, up, pos), **POSE_TOL)
    for name in ('average_pose', 'recenter_poses', 'focus_point',
                 'spherify_poses'):
        got, want = getattr(poses, name)(p), getattr(jposes, name)(p)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, err_msg=name, **POSE_TOL)


@pytest.fixture(scope='module')
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp('llff')
    ours = synthetic.make_llff_sphere_capture(str(root / 'port'),
                                              n_images=9, size=16)
    theirs = jsynthetic.make_llff_sphere_capture(str(root / 'jax'),
                                                 n_images=9, size=16)
    return ours, theirs


def test_llff_sphere_capture_equals_jax(captures):
    ours, theirs = captures
    for rel in ['poses_bounds.npy', os.path.join('sparse', '0',
                                                 'cameras.bin')] + [
            os.path.join('images_1', f) for f in
            sorted(os.listdir(os.path.join(theirs, 'images_1')))]:
        with open(os.path.join(ours, rel), 'rb') as a, \
                open(os.path.join(theirs, rel), 'rb') as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize('split,batch_type', [
    ('train', 'all_images'), ('test', 'single_image')])
def test_real_data_360_equals_jax(captures, split, batch_type):
    """Images, every ray field, the bounds and each view's camera, bit for
    bit; the train split samples the same batch from the same seed."""
    root = captures[1]
    kw = dict(data_dir=root, split=split, white_bkgd=False,
              batch_type=batch_type, factor=1)
    ours, theirs = RealData360(**kw), JRealData360(**kw)
    assert dataset_dict['real360'] is RealData360
    assert len(ours) == len(theirs)
    np.testing.assert_array_equal(ours.bds, theirs.bds)
    np.testing.assert_array_equal(ours.K_inv, theirs.K_inv)
    for name in Rays._fields:
        a, b = getattr(ours.rays, name), getattr(theirs.rays, name)
        a, b = (a, b) if isinstance(b, list) else ([a], [b])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
    if split == 'train':
        assert ours.num_rays == 7 * 16 * 16         # views 1..7
        np.testing.assert_array_equal(ours.images, theirs.images)
        a = ours.sample_batch(np.random.default_rng(5), 32)
        b = theirs.sample_batch(np.random.default_rng(5), 32)
        for x, y in zip(a[0] + (a[1],), b[0] + (b[1],)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        return
    assert len(ours) == 2                     # views 0 and 8
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i][1], theirs[i][1])
        (ca, hwa), (cb, hwb) = ours.camera(i), theirs.camera(i)
        assert hwa == hwb == (16, 16)
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_real_data_360_camera_rays_match_its_rays(captures):
    """The port's on-device ray builder on a test view's camera() gives the
    view's materialised rays (the path eval renders through)."""
    import torch

    from mipnerf_pl_tpu_torch.ops.camera import camera_rays
    ds = RealData360(captures[0], 'test', white_bkgd=False,
                     batch_type='single_image', factor=1)
    rays, _ = ds[1]
    cam, (h, w) = ds.camera(1)
    got = camera_rays(cam, h, w, device='cpu')
    for name in Rays._fields:
        np.testing.assert_allclose(
            getattr(got, name).numpy(),
            np.broadcast_to(getattr(rays, name),
                            getattr(got, name).shape), rtol=1e-5, atol=1e-6,
            err_msg=name)
    assert torch.all(got.far > got.near)


def test_real360_simple_radial_camera(tmp_path):
    """SIMPLE_RADIAL (f, cx, cy, k): f goes to both fx and fy, as in JAX."""
    root = make_llff_capture(str(tmp_path / 'cap'), model_id=2,
                             params=[10.0, 4.0, 4.0, 0.0])
    ds = RealData360(root, split='train', batch_type='all_images', factor=1)
    theirs = JRealData360(root, split='train', batch_type='all_images',
                          factor=1)
    assert ds.K[0, 0] == ds.K[1, 1]
    np.testing.assert_array_equal(ds.K, theirs.K)
    np.testing.assert_array_equal(ds.rays.directions, theirs.rays.directions)


@pytest.mark.parametrize('model_id,params', [
    (2, [10.0, 4.0, 4.0, 0.1]), (3, [10.0, 4.0, 4.0, 0.1, 0.0]),
    (4, [10.0, 10.0, 4.0, 4.0, 0.0, 0.0, 0.01, 0.0])],
    ids=['simple_radial', 'radial', 'opencv'])
def test_real360_distortion_warns(tmp_path, model_id, params):
    root = make_llff_capture(str(tmp_path / 'cap'), model_id=model_id,
                             params=params)
    with pytest.warns(UserWarning, match='distortion'):
        ds = RealData360(root, split='train', batch_type='all_images',
                         factor=1)
    np.testing.assert_array_equal(
        ds.K, JRealData360(root, split='train', batch_type='all_images',
                           factor=1).K)


def test_real360_unknown_model_raises(tmp_path):
    root = make_llff_capture(str(tmp_path / 'cap'), model_id=9,
                             params=[10.0, 4.0, 4.0, 0.0])
    with pytest.raises(ValueError, match='unsupported COLMAP'):
        RealData360(root, split='train', batch_type='all_images', factor=1)
    with pytest.raises(ValueError, match='images_4'):
        RealData360(root, split='train', batch_type='all_images')


TINY = ['train.batch_size', '64', 'nerf.num_samples', '8',
        'nerf.mlp.net_depth', '3', 'nerf.mlp.net_width', '16',
        'nerf.mlp.net_width_condition', '16', 'nerf.mlp.skip_index', '2',
        'val.chunk_size', '256', 'train.steps_per_call', '2',
        'nerf.mlp_backend', 'pallas_lean_save']


def test_real360_smoke_trains_and_evaluates(tmp_path, capsys):
    """real360_smoke on the CPU: a 16 px capture, cli.train on
    configs/real360.yaml (a tiny MLP) for 4 steps at data.factor 1, then
    cli.eval, which must build its test split from images_1 (the
    checkpoint's data.factor; the class default would look for images_4).
    Finite PSNR / SSIM for the 2 test views, best and last checkpoints."""
    from mipnerf_pl_tpu_torch.tools import real360_smoke
    out = str(tmp_path / 'run')
    result = real360_smoke.main(['--out', out, '--steps', '4', '--size',
                                 '16', '--n_images', '9', '--device', 'cpu']
                                + TINY)
    assert np.isfinite(result['psnr']) and np.isfinite(result['ssim'])
    assert result['train']['steps'] == 4
    assert np.isfinite(result['train']['loss_last'])
    ckpt = os.path.join(out, 'ckpt', 'real360_smoke')
    assert os.listdir(os.path.join(ckpt, 'best'))
    assert os.listdir(os.path.join(ckpt, 'last')) == ['4']
    with open(os.path.join(out, 'test', 'real360_smoke', 'psnrs.txt')) as f:
        assert len(f.read().split()) == 2
    assert not os.path.exists(os.path.join(out, 'capture', 'images_4'))
    assert 'real360_smoke: steps=4' in capsys.readouterr().out.splitlines(
        )[-1]


def test_quality_smoke_prints_its_line(tmp_path, capsys):
    from mipnerf_pl_tpu_torch.tools import quality_smoke
    result = quality_smoke.main(['--steps', '20', '--size', '16',
                                 '--device', 'cpu', '--out',
                                 str(tmp_path / 'q')])
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith('quality_smoke: steps=20 wall=')
    assert f'val_psnr={result["val_psnr"]:.2f}' in line
    assert np.isfinite(result['val_psnr'])
    hp = quality_smoke.hparams(3000, 'pallas_lean_save', 'bfloat16')
    assert (hp['train.batch_size'], hp['nerf.num_samples'],
            hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_width'],
            hp['nerf.mlp.net_width_condition'], hp['train.steps_per_call'],
            hp['optimizer.lr_delay_steps'], hp['val.check_interval']) == (
        1024, 64, 6, 128, 64, 50, 100, 1000)


def test_quality_smoke_exits_1_under_min_psnr(tmp_path):
    from mipnerf_pl_tpu_torch.tools import quality_smoke
    with pytest.raises(SystemExit) as err:
        quality_smoke.main(['--steps', '2', '--size', '16', '--device',
                            'cpu', '--min_psnr', '99', '--out',
                            str(tmp_path / 'q')])
    assert err.value.code == 1
