"""The port's multi-scale Blender path against the JAX package (CPU).

The converter (data/convert.py and cli/convert.py) against
mipnerf_pl_tpu/data/convert.py and the root convert_blender_data.py: the
same metadata.json text and the same PNG files.  `Multicam`'s rays, images,
batches and cameras bit for bit against the JAX class.  One training step
on a Multicam batch whose rays carry lossmult 1 and 4, train.randomized
False, on 'xla' and on 'pallas_lean_save' (the plain version of the lean
kernels here, TPU kernels #3 / #4a in interpret mode on the JAX side), with
loss.disable_multiscale_loss False and True: the loss within 1e-5 relative
and every gradient within 2e-4 of its leaf's largest entry
(tests/test_fused_mlp.py's f32 bars).  validate on the val split (entries
of two sizes) against JAX at 1e-4, fit through the train CLI on
multi_blender, and the eval CLI's scale buckets and summary line against
JAX's summarize_results.
"""

import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.data import convert as jconvert
from mipnerf_pl_tpu.data.datasets import Multicam as JMulticam
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.cli import convert as convert_cli
from mipnerf_pl_tpu_torch.cli import eval as eval_cli
from mipnerf_pl_tpu_torch.cli import train as train_cli
from mipnerf_pl_tpu_torch.convert import (jax_params_to_torch,
                                          torch_params_to_jax)
from mipnerf_pl_tpu_torch.data import convert
from mipnerf_pl_tpu_torch.data.datasets import Multicam, dataset_dict
from mipnerf_pl_tpu_torch.data.synthetic import make_sphere_scene
from mipnerf_pl_tpu_torch.rays import Rays
from mipnerf_pl_tpu_torch.system import MipNeRFSystem

SIZE, N_DOWN = 16, 2
TINY = {'exp_name': 'multi', 'train.batch_size': 64, 'nerf.num_samples': 8,
        'nerf.max_deg_point': 4, 'nerf.deg_view': 2, 'nerf.mlp.net_depth': 2,
        'nerf.mlp.net_width': 32, 'nerf.mlp.net_width_condition': 16,
        'val.chunk_size': 128, 'val.sample_num': 1, 'val.check_interval': 4,
        'train.steps_per_call': 2, 'optimizer.lr_delay_steps': 0}


def _hparams(**overrides):
    hp = config.default()
    hp.update(TINY)
    hp.update(overrides)
    return hp


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope='module')
def blender(tmp_path_factory):
    """A Blender-layout sphere scene: 3 train, 1 val, 2 test views."""
    root = str(tmp_path_factory.mktemp('blender'))
    return make_sphere_scene(os.path.join(root, 'sphere'), n_train=3,
                             n_val=1, n_test=2, size=SIZE)


@pytest.fixture(scope='module')
def converted(blender, tmp_path_factory):
    """(the port's multi-scale tree, JAX's) of the same scene."""
    root = tmp_path_factory.mktemp('multi')
    ours, theirs = str(root / 'port'), str(root / 'jax')
    convert.convert_to_nerfdata(blender, ours, N_DOWN)
    jconvert.convert_to_nerfdata(blender, theirs, N_DOWN)
    return ours, theirs


def test_convert_matches_jax(converted):
    ours, theirs = converted
    a, b = _tree_files(ours), _tree_files(theirs)
    assert sorted(a) == sorted(b)
    assert a['metadata.json'] == b['metadata.json']
    from PIL import Image
    for name in a:
        if name.endswith('.png'):
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(ours, name))),
                np.asarray(Image.open(os.path.join(theirs, name))), name)
    meta = json.loads(a['metadata.json'])
    # Image-major, scale-minor; lossmult 4^level; focal halved per level.
    test = meta['test']
    assert test['label'] == [0, 1, 0, 1]
    assert test['lossmult'] == [1.0, 4.0, 1.0, 4.0]
    assert test['width'] == [SIZE, SIZE // 2] * 2
    np.testing.assert_allclose(test['focal'][1], test['focal'][0] / 2)
    assert set(test['near']) == {2.0} and set(test['far']) == {6.0}


def test_pyramid_and_pix2cam_match_jax(blender):
    stack = np.random.default_rng(0).uniform(
        size=(2, 8, 16, 4)).astype(np.float32)
    for a, b in zip(convert.image_pyramid(stack, 3),
                    jconvert.image_pyramid(stack, 3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(convert.pix2cam_matrix(20.0, 16, 8),
                                  jconvert.pix2cam_matrix(20.0, 16, 8))
    a = convert.load_renderings(blender, 'train')
    b = jconvert.load_renderings(blender, 'train')
    for k in ('images', 'camtoworlds'):
        np.testing.assert_array_equal(a[k], b[k])
    assert a['focal'] == b['focal']
    # The in-memory entries are what the writer writes.
    meta, images = convert.split_entries(a, N_DOWN, 'images_train')
    assert meta['file_path'] == [f for f, _ in images]
    assert [im.shape[:2] for _, im in images[:2]] == [(SIZE, SIZE),
                                                      (SIZE // 2, SIZE // 2)]


def test_convert_cli_matches_root_script(blender, tmp_path, monkeypatch):
    root = os.path.dirname(blender)
    assert convert_cli.main(['--blender_dir', root, '--out_dir',
                             str(tmp_path / 'port'), '--n_down',
                             str(N_DOWN)]) == [str(tmp_path / 'port' /
                                                   'sphere')]
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'convert_blender_data.py')
    monkeypatch.setattr(sys, 'argv', [script, '--blender_dir', root,
                                      '--object_name', 'sphere', '--out_dir',
                                      str(tmp_path / 'jax'), '--n_down',
                                      str(N_DOWN)])
    runpy.run_path(script, run_name='__main__')
    assert _tree_files(str(tmp_path / 'port')) == \
        _tree_files(str(tmp_path / 'jax'))


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


@pytest.mark.parametrize('split,batch_type', [
    ('train', 'all_images'), ('val', 'single_image'),
    ('test', 'single_image')])
def test_multicam_equals_jax(converted, split, batch_type):
    kw = dict(data_dir=converted[0], split=split, white_bkgd=split != 'test',
              batch_type=batch_type)
    ours, theirs = Multicam(**kw), JMulticam(**kw)
    assert dataset_dict['multi_blender'] is Multicam
    assert len(ours) == len(theirs)
    _same_rays(ours.rays, theirs.rays)
    if split == 'train':
        np.testing.assert_array_equal(ours.images, theirs.images)
        assert ours.num_rays == theirs.num_rays == 3 * (SIZE ** 2
                                                        + SIZE ** 2 // 4)
        a = ours.sample_batch(np.random.default_rng(5), 32)
        b = theirs.sample_batch(np.random.default_rng(5), 32)
        _same_rays(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        return
    for i in range(len(ours)):
        (ra, ia), (rb, ib) = ours[i], theirs[i]
        _same_rays(ra, rb)
        np.testing.assert_array_equal(ia, ib)
        (ca, hwa), (cb, hwb) = ours.camera(i), theirs.camera(i)
        assert hwa == hwb == ((SIZE, SIZE) if i % 2 == 0
                              else (SIZE // 2, SIZE // 2))
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_multicam_warns_on_factor(converted):
    with pytest.warns(UserWarning, match='data.factor=2'):
        Multicam(converted[0], 'val', batch_type='single_image', factor=2)


def _leaf_close(got, want, rel):
    """Every leaf within rel of the largest entry of its leaf."""
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        w = np.asarray(w)
        np.testing.assert_allclose(flat_g[path], w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('disable', [False, True])
@pytest.mark.parametrize('backend', ['xla', 'pallas_lean_save'])
def test_multicam_train_step_matches_jax(converted, backend, disable):
    """One step's loss and every gradient on a Multicam batch whose rays
    come from both pyramid levels (lossmult 1 and 4)."""
    from mipnerf_pl_tpu.rays import Rays as JRays
    from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
    hp = _hparams(**{'train.randomized': False, 'nerf.mlp_backend': backend,
                     'loss.disable_multiscale_loss': disable})
    rays, pixels = Multicam(converted[0], 'train').sample_batch(
        np.random.default_rng(3), 64)
    assert set(np.unique(rays.lossmult)) == {1.0, 4.0}
    jsys = JSystem(hp)
    jstate = jsys.init_state()
    system = MipNeRFSystem(hp, device='cpu')
    params = jax_params_to_torch(_np_tree(jstate['params']))
    state = system.init_state(params=params)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jsys.loss_fn, has_aux=True))(jstate['params'], JRays(*rays), pixels,
                                     jax.random.PRNGKey(0))
    (loss, _), grads = system.value_and_grad(
        state['params'], Rays(*(torch.from_numpy(np.ascontiguousarray(
            f, np.float32)) for f in rays)), torch.from_numpy(pixels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _leaf_close(torch_params_to_jax(grads), _np_tree(jgrads), 2e-4)
    # The mask is in the loss: with lossmult all ones the loss moves,
    # unless the multi-scale loss is disabled.
    flat = system.value_and_grad(
        state['params'], Rays(*(torch.from_numpy(np.ascontiguousarray(
            f, np.float32)) for f in rays._replace(
                lossmult=np.ones_like(rays.lossmult)))),
        torch.from_numpy(pixels))[0][0]
    assert (float(flat) == float(loss)) == disable


@pytest.fixture(scope='module')
def run(converted, tmp_path_factory):
    """8 steps of the train CLI on multi_blender; -> (out_dir, system,
    state)."""
    import contextlib
    import io
    out = str(tmp_path_factory.mktemp('out'))
    opts = [str(x) for kv in TINY.items() for x in kv]
    with contextlib.redirect_stdout(io.StringIO()):
        system, state = train_cli.main(
            ['--data_path', converted[0], '--out_dir', out,
             '--dataset_name', 'multi_blender', '--max_steps', '8',
             '--device', 'cpu'] + opts)
    return out, system, state


def test_fit_on_multi_blender(run):
    out, system, state = run
    assert state['step'] == 8 and isinstance(system.train_dataset, Multicam)
    stats = system.fit_stats
    assert stats['steps'] == 8 and np.isfinite(stats['loss_last'])
    ck = os.path.join(out, 'ckpt', 'multi')
    assert sorted(os.listdir(os.path.join(ck, 'best'))) == ['4', '8']
    with open(os.path.join(out, 'logs', 'multi', 'val_history.csv')) as f:
        rows = f.read().split()[1:]
    assert [r.split(',')[0] for r in rows] == ['4', '8']
    assert all(np.isfinite(float(x)) for r in rows for x in r.split(','))


def test_validate_on_multicam_matches_jax(converted):
    """Both val entries (16x16 and 8x8, lossmult 1 and 4) through each
    package's camera path, from the same parameters."""
    from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
    hp = _hparams()
    jsys = JSystem(dict(hp, **{'val.fetch_dtype': 'float32'}))
    jsys.setup(converted[1], 'multi_blender', prefetch=0)
    jstate = jsys.init_state()
    system = MipNeRFSystem(hp, device='cpu')
    system.setup(converted[0], 'multi_blender', prefetch=0)
    state = system.init_state(params=jax_params_to_torch(
        _np_tree(jstate['params'])))
    try:
        for start in (0, 1):
            np.testing.assert_allclose(
                system.validate(state, 1, start_index=start),
                jsys.validate(jstate, 1, start_index=start),
                rtol=1e-4, atol=1e-4)
    finally:
        jsys.batcher.close()
        system.batcher.close()


def test_eval_cli_scale_buckets(run, converted, capsys):
    """--scale 2 on a 2-level pyramid: 4 entries, buckets 1/ and 2/, and
    the summary line JAX's summarize_results makes of the same files."""
    from mipnerf_pl_tpu.utils.metrics import summarize_results
    out = run[0]
    summary = eval_cli.main(['--ckpt', os.path.join(out, 'ckpt', 'multi'),
                             '--out_dir', out, '--scale', '2', '--base_size',
                             str(SIZE), str(SIZE), '--save_image',
                             '--no_video', '--device', 'cpu'])
    assert summary in capsys.readouterr().out
    exp = os.path.join(out, 'test', 'multi')
    with open(os.path.join(exp, 'psnrs.txt')) as f:
        psnrs = [float(v) for v in f.read().split()]
    assert len(psnrs) == 4 and np.all(np.isfinite(psnrs))
    assert sorted(d for d in os.listdir(exp)
                  if os.path.isdir(os.path.join(exp, d))) == ['1', '2']
    for bucket, side in (('1', SIZE), ('2', SIZE // 2)):
        files = sorted(os.listdir(os.path.join(exp, bucket)))
        assert files == [f'{i:05d}_{k}.png' for i in range(2)
                         for k in ('acc', 'dist', 'rgb')]
        from PIL import Image
        assert Image.open(os.path.join(exp, bucket, files[2])).size == \
            (side, side)
    assert summary == summarize_results(out, ['multi'], 2)
    psnr_cols = summary.split(' | ')[0].split()
    np.testing.assert_allclose([float(v) for v in psnr_cols],
                               np.reshape(psnrs, (-1, 2)).mean(0), atol=1e-4)
