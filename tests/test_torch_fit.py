"""The port's whole run on the CPU: validate, fit through the train CLI,
resume, the eval CLI, and the run's training steps against the JAX package.

Tiny model (depth 2, width 32, 8 samples), a 16x16 Blender scene written by
tests/helpers, `--device cpu` (the kernels' plain versions).  Against JAX:
`validate` on converted parameters at 1e-4 (loss and PSNR of a full-image
render; the JAX side fetches f32), and 3 steps of make_train_many over each
package's own batcher from the same initial parameters, train.randomized
False, nerf.ipe_backend pallas, at test_train_slice_matches_jax's bars
(loss 2e-6 relative, parameter updates within 1e-3 of their norm).
"""

import os

import jax
import numpy as np
import pytest
import torch

from helpers import make_blender_scene
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.cli import eval as eval_cli
from mipnerf_pl_tpu_torch.cli import train as train_cli
from mipnerf_pl_tpu_torch.convert import (jax_params_to_torch,
                                          torch_params_to_jax)
from mipnerf_pl_tpu_torch.data.datasets import Blender, dataset_dict
from mipnerf_pl_tpu_torch.system import MipNeRFSystem, make_dataset
from mipnerf_pl_tpu_torch.train.ckpt import (CheckpointManager, load_hparams,
                                             restore_for_eval)

TINY = {'exp_name': 'tiny', 'train.batch_size': 64, 'nerf.num_samples': 8,
        'nerf.max_deg_point': 4, 'nerf.deg_view': 2, 'nerf.mlp.net_depth': 2,
        'nerf.mlp.net_width': 32, 'nerf.mlp.net_width_condition': 16,
        'val.chunk_size': 128, 'val.sample_num': 1, 'val.check_interval': 4,
        'train.steps_per_call': 2, 'optimizer.lr_delay_steps': 0,
        'nerf.ipe_backend': 'pallas'}


def _opts():
    return [str(x) for kv in TINY.items() for x in kv]


def _hparams(**overrides):
    hp = config.default()
    hp.update(TINY)
    hp.update(overrides)
    return hp


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp('scene')),
                              n_frames=3, size=16)


@pytest.fixture(scope='module')
def run(scene, tmp_path_factory):
    """An 8-step run of the train CLI; -> (out_dir, system, state, log)."""
    out = str(tmp_path_factory.mktemp('out'))
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        system, state = train_cli.main(
            ['--data_path', scene, '--out_dir', out, '--dataset_name',
             'blender', '--max_steps', '8', '--device', 'cpu'] + _opts())
    return out, system, state, buf.getvalue()


def test_validate_matches_jax(scene):
    from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
    hp = _hparams()
    jsys = JSystem(dict(hp, **{'val.fetch_dtype': 'float32'}))
    jsys.setup(scene, 'blender', prefetch=0)
    jstate = jsys.init_state()
    system = MipNeRFSystem(hp, device='cpu')
    system.setup(scene, 'blender', prefetch=0)
    state = system.init_state(params=jax_params_to_torch(
        _np_tree(jstate['params'])))
    try:
        for start in (0, 2):
            want = jsys.validate(jstate, 2, start_index=start)
            got = system.validate(state, 2, start_index=start)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # The materialized-rays fallback gives the same numbers.
        system.val_dataset.camera = _no_camera
        np.testing.assert_allclose(system.validate(state, 1),
                                   jsys.validate(jstate, 1), rtol=1e-4,
                                   atol=1e-4)
    finally:
        jsys.batcher.close()
        system.batcher.close()


def _no_camera(index):
    raise NotImplementedError('no single-camera form')


def test_train_cli_writes_the_artifacts(run):
    out, system, state, log = run
    assert state['step'] == 8 and system.device.type == 'cpu'
    ck = os.path.join(out, 'ckpt', 'tiny')
    assert sorted(os.listdir(os.path.join(ck, 'best'))) == ['4', '8']
    assert os.listdir(os.path.join(ck, 'last')) == ['8']
    hp = load_hparams(ck)
    assert hp['dataset_name'] == 'blender' and hp['exp_name'] == 'tiny'
    assert hp['nerf.ipe_backend'] == 'pallas' and hp['max_steps'] == 8
    with open(os.path.join(out, 'logs', 'tiny', 'val_history.csv')) as f:
        rows = f.read().split()
    assert rows[0] == 'step,val_loss,val_psnr'
    assert [r.split(',')[0] for r in rows[1:]] == ['4', '8']
    assert all(np.isfinite(float(x)) for r in rows[1:] for x in r.split(','))
    assert 'step 2/8 loss=' in log and 'rays/s=' in log
    assert 'profiler summary' in log
    stats = system.fit_stats
    assert stats['steps'] == 8 and stats['rays_per_sec'] > 0
    assert 0.0 <= stats['data_wait_share'] <= 1.0
    step, host = CheckpointManager(ck).restore_last()
    assert step == 8
    for k, v in state['params'].items():
        assert torch.equal(host['params'][k], v.detach()), k


def test_train_cli_resumes_from_its_last_checkpoint(run, scene, capsys):
    out, _, first, _ = run
    before = {k: v.detach().clone() for k, v in first['params'].items()}
    _, state = train_cli.main(
        ['--data_path', scene, '--out_dir', out, '--dataset_name', 'blender',
         '--max_steps', '12', '--device', 'cpu'] + _opts())
    log = capsys.readouterr().out
    assert 'at step 8' in log and 'step 10/12' in log
    assert 'step 2/12' not in log
    assert state['step'] == 12
    assert any(not torch.equal(v, before[k])
               for k, v in state['params'].items())
    ck = os.path.join(out, 'ckpt', 'tiny')
    assert os.listdir(os.path.join(ck, 'last')) == ['12']
    with open(os.path.join(out, 'logs', 'tiny', 'val_history.csv')) as f:
        assert [r.split(',')[0] for r in f.read().split()[1:]] == \
            ['4', '8', '12']
    # Adam's moments came along with their step counts.
    system = MipNeRFSystem(load_hparams(ck), device='cpu')
    a = system.load_state(CheckpointManager(ck).restore_last()[1])
    assert a['step'] == 12
    assert all(int(s['step']) == 12
               for s in a['opt_state'].state_dict()['state'].values())


def test_eval_cli_writes_the_metrics(run, scene, capsys):
    out, _, _, _ = run
    ck = os.path.join(out, 'ckpt', 'tiny')
    summary = eval_cli.main(['--ckpt', ck, '--data', scene, '--out_dir', out,
                             '--scale', '1', '--no_video', '--save_image',
                             '--chunk_size', '100', '--device', 'cpu'])
    log = capsys.readouterr().out
    assert 'PSNR | SSIM | Average' in log and summary in log
    psnr, ssim, avg = (float(x) for x in summary.split(' | '))
    exp = os.path.join(out, 'test', 'tiny')
    with open(os.path.join(exp, 'psnrs.txt')) as f:
        psnrs = [float(x) for x in f.read().split()]
    with open(os.path.join(exp, 'ssims.txt')) as f:
        ssims = [float(x) for x in f.read().split()]
    assert len(psnrs) == len(ssims) == 3
    assert np.all(np.isfinite(psnrs)) and np.all(np.isfinite(ssims))
    np.testing.assert_allclose(psnr, np.mean(psnrs), atol=1e-4)
    np.testing.assert_allclose(ssim, np.mean(ssims), atol=1e-4)
    assert np.isfinite(avg)
    pngs = sorted(os.listdir(os.path.join(exp, '50')))    # 800 / 16
    assert len(pngs) == 9 and pngs[0] == '00000_acc.png'
    # --summa_only reads the files back; the data path defaults to the
    # checkpoint's; without --no_video each bucket gets a video (the
    # images' own size as --base_size puts them in bucket 1).
    assert eval_cli.main(['--ckpt', ck, '--out_dir', out, '--scale', '1',
                          '--summa_only']) == summary
    eval_cli.main(['--ckpt', ck, '--out_dir', out, '--scale', '1',
                   '--base_size', '16', '16', '--save_image', '--device',
                   'cpu'])
    assert os.path.getsize(os.path.join(exp, '1', 'video_1.mov')) > 0


def test_eval_falls_back_only_when_camera_is_missing(run, scene, tmp_path,
                                                     monkeypatch):
    """A dataset whose camera() raises NotImplementedError renders through
    render_image; a NotImplementedError from a render propagates."""
    out, _, _, _ = run
    ck = os.path.join(out, 'ckpt', 'tiny')

    class NoCamera(Blender):
        def camera(self, index):
            raise NotImplementedError('no single-camera form')

    monkeypatch.setitem(dataset_dict, 'no_camera', NoCamera)
    calls = []
    render_image = MipNeRFSystem.render_image
    monkeypatch.setattr(MipNeRFSystem, 'render_image',
                        lambda self, *a, **k: calls.append(1)
                        or render_image(self, *a, **k))
    args = ['--ckpt', ck, '--data', scene, '--scale', '1', '--no_video',
            '--device', 'cpu']
    a = eval_cli.main(args + ['--out_dir', str(tmp_path / 'a'),
                              '--dataset_name', 'no_camera'])
    assert len(calls) == 3
    b = eval_cli.main(args + ['--out_dir', str(tmp_path / 'b')])
    assert len(calls) == 3
    pa, pb = (float(s.split(' | ')[0]) for s in (a, b))
    np.testing.assert_allclose(pa, pb, atol=1e-3)

    def refuse(self, *a, **k):
        raise NotImplementedError('an activation guard')
    monkeypatch.setattr(MipNeRFSystem, 'render_camera', refuse)
    with pytest.raises(NotImplementedError, match='activation guard'):
        eval_cli.main(args + ['--out_dir', str(tmp_path / 'c')])
    assert len(calls) == 3
    # validate: the same rule.
    system = MipNeRFSystem(load_hparams(ck), device='cpu')
    system.val_dataset = make_dataset(system.hparams, 'blender', scene, 'val')
    _, state = restore_for_eval(ck)
    with pytest.raises(NotImplementedError, match='activation guard'):
        system.validate(state, 1)


def test_cli_needs_a_card_or_the_flag(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(ValueError, match="device='cpu'"):
        train_cli.main(['--data_path', scene, '--out_dir', str(tmp_path),
                        '--dataset_name', 'blender'] + _opts())
    with pytest.raises(ValueError, match='unknown dataset'):
        train_cli.main(['--data_path', scene, '--out_dir', str(tmp_path),
                        '--dataset_name', 'nope', '--device', 'cpu'])


@pytest.mark.parametrize('backend,resample', [('pallas_lean_save', True),
                                              ('xla', False)])
def test_run_slice_matches_jax(scene, backend, resample):
    """The slice as a whole: 3 steps of make_train_many, each package over
    its own batcher's [3, B, C] stack, from the same initial parameters."""
    from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
    hp = _hparams(**{'train.randomized': False, 'nerf.mlp_backend': backend,
                     'nerf.stop_resample_grad': resample})
    jsys = JSystem(hp)
    jsys.setup(scene, 'blender', prefetch=0, steps_per_call=3)
    jstate = jsys.init_state()
    system = MipNeRFSystem(hp, device='cpu')
    system.setup(scene, 'blender', prefetch=0, steps_per_call=3)
    assert system.model.ipe_backend == 'pallas'
    state = system.init_state(params=jax_params_to_torch(
        _np_tree(jstate['params'])))
    start = torch_params_to_jax(state['params'])
    try:
        jrays, jpixels = next(jsys.batcher)
        rays, pixels = next(system.batcher)
    finally:
        jsys.batcher.close()
        system.batcher.close()
    np.testing.assert_array_equal(pixels.numpy(), np.asarray(jpixels))
    jstate, jaux = jsys.make_train_many(donate=False)(
        jstate, jrays, jpixels, jax.random.PRNGKey(int(hp['seed'])))
    state, aux = system.make_train_many()(state, rays, pixels,
                                          int(hp['seed']))
    assert state['step'] == int(jstate['step']) == 3
    for name in ('loss', 'train/psnr', 'lr'):
        np.testing.assert_allclose(aux[name].numpy(), np.asarray(jaux[name]),
                                   rtol=2e-6, err_msg=name)
    after = torch_params_to_jax(state['params'])
    jafter = _np_tree(jstate['params'])
    for (path, a), b, s in zip(jax.tree_util.tree_flatten_with_path(after)[0],
                               jax.tree.leaves(jafter),
                               jax.tree.leaves(start)):
        step_port, step_jax = a - s, np.asarray(b) - s
        assert np.linalg.norm(step_jax) > 0, jax.tree_util.keystr(path)
        assert (np.linalg.norm(step_port - step_jax)
                <= 1e-3 * np.linalg.norm(step_jax)), jax.tree_util.keystr(path)
