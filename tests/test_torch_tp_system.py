"""Tensor parallelism through the port's system, on the CPU.

The port's `MipNeRFSystem` under a `model` axis against the JAX system on
its 8-device virtual mesh (tests/conftest.py) under the same `(data,
model)` layout: 3 steps of make_train_many, train.randomized False, on
`xla` (JAX: GSPMD over the plain model; the port: the Megatron split on the
plain pairs) and `pallas_lean_save` (JAX: its lean kernel; the port: the
pairs through their wrappers), at data 4 x model 2 and data 2 x model 4
of the single-process mesh.  Bars: the aux within 1e-5 relative
(tests/test_tp.py holds JAX's TP loss to 1e-5), each parameter step within
1e-3 of JAX's norm (tests/test_torch_dp.py's step bar).  With
train.randomized True, model 2 against model 1 of the port on the Blender
scene, on the multi-scale one (its shards' lossmult sums differ) and on a
small unbounded-360 capture.  Two gloo processes started by cli.train's
own launcher (`--device cpu num_devices 2 parallel.model_axis 2`): the
ranks' parameters bit-equal at each checkpoint (fit checks it), the run
within 1e-6 of the single-process data 1 x model 2 mesh, rank 0 alone
wrote the files; then cli.eval of that checkpoint in one process.  The
model: an 8-layer trunk with skip_index 4 (the skip pair and view_0's
split rows), width 32, condition 16, 8 samples, 64 rays.
"""

import contextlib
import io
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from helpers import make_blender_scene
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.convert import (jax_params_to_torch,
                                          torch_params_to_jax)
from mipnerf_pl_tpu_torch.data import convert
from mipnerf_pl_tpu_torch.data.synthetic import (make_llff_sphere_capture,
                                                 make_sphere_scene)
from mipnerf_pl_tpu_torch.kernels import mlp as km
from mipnerf_pl_tpu_torch.kernels.tp_lean import model_split_rows
from mipnerf_pl_tpu_torch.parallel.launch import checkpoint_hparams
from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh
from mipnerf_pl_tpu_torch.system import MipNeRFSystem
from mipnerf_pl_tpu_torch.train.ckpt import CheckpointManager

TINY = {'exp_name': 'tiny', 'train.batch_size': 64, 'nerf.num_samples': 8,
        'nerf.max_deg_point': 4, 'nerf.deg_view': 2, 'nerf.mlp.net_depth': 8,
        'nerf.mlp.skip_index': 4, 'nerf.mlp.net_width': 32,
        'nerf.mlp.net_width_condition': 16, 'val.chunk_size': 128,
        'val.sample_num': 1, 'val.check_interval': 4,
        'train.steps_per_call': 2, 'optimizer.lr_delay_steps': 0}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def multiscale(tmp_path_factory):
    """The converted multi-scale tree of a 16 px sphere scene, 2 levels."""
    root = tmp_path_factory.mktemp('multi')
    blender = make_sphere_scene(str(root / 'sphere'), n_train=3, n_val=1,
                                n_test=2, size=16)
    out = str(root / 'converted')
    convert.convert_to_nerfdata(blender, out, 2)
    return out


def _jax_run(data_path, backend, model_axis, shape=None, jax_backend=None):
    """3 steps of the JAX system on the (8 / model_axis, model_axis) mesh
    over its own batcher's [3, B, C] stack, the model's `shape` keys over
    TINY's, on `jax_backend` where it is given -> (the port's hparams, start
    params, batch pixels, aux, params after)."""
    from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
    hp = _hparams(**{'train.randomized': False, 'nerf.mlp_backend': backend,
                     'parallel.model_axis': model_axis}, **(shape or {}))
    jsys = JSystem(dict(hp, **{'nerf.mlp_backend': jax_backend or backend}))
    assert jsys.mesh.shape == {'data': 8 // model_axis, 'model': model_axis}
    jsys.setup(data_path, 'blender', prefetch=0, steps_per_call=3)
    jstate = jsys.init_state()
    start = _np_tree(jstate['params'])
    try:
        jrays, jpixels = next(jsys.batcher)
    finally:
        jsys.batcher.close()
    jstate, jaux = jsys.make_train_many(donate=False)(
        jstate, jrays, jpixels, jax.random.PRNGKey(int(hp['seed'])))
    return (hp, start, np.asarray(jpixels),
            {k: np.asarray(v) for k, v in jaux.items()},
            _np_tree(jstate['params']))


# The model shapes the Megatron pairs alone do not take, which the JAX
# system trains under a model axis: an odd depth (the last layer alone), an
# odd skip index (a skip at a pair boundary and one inside a pair), a skip
# after the last layer, no view layer, no view directions.
SHAPES = {'depth7': {'nerf.mlp.net_depth': 7},
          'skip3': {'nerf.mlp.skip_index': 3},
          'depth4-skip1': {'nerf.mlp.net_depth': 4,
                              'nerf.mlp.skip_index': 1},
          'condition0': {'nerf.mlp.net_depth_condition': 0},
          'no-viewdirs': {'nerf.use_viewdirs': False}}


@pytest.mark.parametrize('backend,model_axis,shape', [
    pytest.param(b, m, None, id=f'{b}-{m}')
    for b in ('xla', 'pallas_lean_save') for m in (2, 4)] + [
    pytest.param(b, 2, name, id=f'{b}-2-{name}')
    for name in SHAPES for b in ('xla', 'pallas_lean_save')])
def test_tp_step_matches_jax(scene, backend, model_axis, shape):
    """3 steps at data 8 / m x model m of the single-process mesh against
    JAX's mesh of the same shape: the aux within 1e-5 relative, each
    parameter's step within 1e-3 of JAX's norm; the pairs ran through
    their wrappers on a Pallas backend (their plain versions here, on CPU
    tensors) and the lean kernels' wrappers never.  At model 2 also each
    shape of SHAPES; with no view layer JAX's lean kernel refuses the
    model, so its 'xla' step (GSPMD over the plain model) is the reference
    of both backends."""
    jax_backend = ('xla' if shape == 'condition0' else None)
    hp, start, jpixels, jaux, jafter = _jax_run(
        scene, backend, model_axis, SHAPES.get(shape), jax_backend)
    d = 8 // model_axis
    with contextlib.redirect_stdout(io.StringIO()) as said:
        system = MipNeRFSystem(hp, mesh=create_mesh(8, model_axis,
                                                    device='cpu'))
    assert system.mesh.shape == {'data': d, 'model': model_axis}
    assert 'Megatron pairs' in said.getvalue()
    system.setup(scene, 'blender', prefetch=0, steps_per_call=3)
    state = system.init_state(params=jax_params_to_torch(start))
    try:
        rays, pixels = next(system.batcher)
    finally:
        system.batcher.close()
    np.testing.assert_array_equal(pixels.numpy(), jpixels)
    km.reset_launches()
    state, aux = system.make_train_many()(state, rays, pixels,
                                          int(hp['seed']))
    assert state['step'] == 3
    launches = {k: v for k, v in km.launches.items() if v}
    assert launches == {}, launches        # CPU tensors: plain versions
    for name in ('loss', 'train/psnr', 'train/psnr_coarse', 'lr'):
        np.testing.assert_allclose(aux[name].numpy(), jaux[name], rtol=1e-5,
                                   err_msg=name)
    after = torch_params_to_jax(state['params'])
    for (path, a), b, s in zip(jax.tree_util.tree_flatten_with_path(after)[0],
                               jax.tree.leaves(jafter),
                               jax.tree.leaves(start)):
        step_port, step_jax = a - s, b - s
        assert np.linalg.norm(step_jax) > 0, jax.tree_util.keystr(path)
        assert (np.linalg.norm(step_port - step_jax)
                <= 1e-3 * np.linalg.norm(step_jax)), jax.tree_util.keystr(path)


@pytest.mark.parametrize('backend', ['xla', 'pallas', 'pallas_save',
                                     'pallas_lean', 'pallas_lean_save',
                                     'pallas_hybrid'])
def test_the_backend_names_the_pairs_route(scene, monkeypatch, backend):
    """Under a model axis the backend picks the pairs' route, with no
    fallback: 'xla' runs their plain versions and never the wrappers,
    every Pallas backend the wrappers tp_pair_fwd / tp_pair_bwd (which on
    a CUDA tensor launch or raise), 4 pairs x 2 model ranks x 2 levels a
    step; the whole-MLP fusions are off and said to be."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean as kt
    calls = {'fwd': 0, 'bwd': 0}

    def counted(key, fn):
        def call(*args):
            calls[key] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(kt, '_pair_call', counted('fwd', kt._pair_call))
    monkeypatch.setattr(kt, '_pair_bwd_call',
                        counted('bwd', kt._pair_bwd_call))
    hp = _hparams(**{'nerf.mlp_backend': backend, 'nerf.fuse_render': True,
                     'nerf.fuse_encode': True})
    with contextlib.redirect_stdout(io.StringIO()) as said:
        system = MipNeRFSystem(hp, mesh=create_mesh(2, 2, device='cpu'))
    model = system.model
    assert not (model._fused_act or model._fused_render
                or model._fused_encode)
    if backend in ('pallas_lean', 'pallas_lean_save'):
        assert model.tp_off == ['nerf.fuse_render', 'nerf.fuse_encode',
                                'the fused head activations']
    assert ', '.join(model.tp_off or ['nothing']) in said.getvalue()
    system.setup(scene, 'blender', prefetch=0, steps_per_call=1)
    try:
        rays, pixels = next(system.batcher)
    finally:
        system.batcher.close()
    state, aux = system.train_step(system.init_state(seed=0), rays, pixels)
    assert torch.isfinite(aux['loss'])
    n = 0 if backend == 'xla' else 16
    assert calls == {'fwd': n, 'bwd': n}


def _port_run(data_path, dataset, hp, d, m, steps=3):
    with contextlib.redirect_stdout(io.StringIO()):
        system = MipNeRFSystem(hp, mesh=create_mesh(d * m, m, device='cpu'))
    system.setup(data_path, dataset, prefetch=0, steps_per_call=steps)
    state = system.init_state(seed=0)
    try:
        rays, pixels = next(system.batcher)
    finally:
        system.batcher.close()
    return system.make_train_many()(state, rays, pixels, int(hp['seed']))


def _assert_same_steps(one, two, start):
    """Run `two` against run `one` from the same `start`: the loss within
    1e-5 relative, each parameter's step within 1e-3 of one's."""
    np.testing.assert_allclose(two[1]['loss'].numpy(),
                               one[1]['loss'].numpy(), rtol=1e-5)
    for k, b in one[0]['params'].items():
        a, b = two[0]['params'][k].detach(), b.detach()
        assert float((a - b).norm()) <= 1e-3 * float((b - start[k]).norm()), k


@pytest.mark.parametrize('dataset,backend,noise', [
    ('blender', 'pallas_lean_save', 0.0),
    ('multi_blender', 'xla', 1.0)])
def test_tp_randomized_equals_model_1(scene, multiscale, dataset, backend,
                                      noise):
    """train.randomized True (and on `xla` the density noise, which the
    model draws outside the MLP): data 2 x model 2 against data 2 x model
    1 of the port, 3 steps: the loss within 1e-5 relative, each parameter's
    step within 1e-3 of model 1's; on the multi-scale scene the shards'
    lossmult sums differ."""
    hp = _hparams(**{'train.randomized': True, 'nerf.mlp_backend': backend,
                     'nerf.density_noise': noise})
    path = scene if dataset == 'blender' else multiscale
    start = MipNeRFSystem(hp, device='cpu').init_params(seed=0)
    _assert_same_steps(_port_run(path, dataset, hp, 2, 1),
                       _port_run(path, dataset, hp, 2, 2), start)


def test_tp_unbounded_equals_model_1(tmp_path):
    """nerf.unbounded (F = 42 encode rows into the first pair) on a 16 px
    LLFF capture, randomized: model 2 against model 1, 3 steps, at the
    bars above."""
    capture = make_llff_sphere_capture(str(tmp_path / 'capture'),
                                       n_images=9, size=16)
    hp = _hparams(**{'train.randomized': True, 'nerf.unbounded': True,
                     'nerf.mlp_backend': 'pallas_lean_save',
                     'train.white_bkgd': False, 'val.white_bkgd': False,
                     'data.factor': 1})
    start = MipNeRFSystem(hp, device='cpu').init_params(seed=0)
    assert start['mlp.trunk_0.weight'].shape[1] == 42
    _assert_same_steps(_port_run(capture, 'real360', hp, 1, 1),
                       _port_run(capture, 'real360', hp, 1, 2), start)


@pytest.mark.parametrize('nvd', [1, 2])
def test_model_split_rows_matches_the_gloo_test_s_table(nvd):
    """model_split_rows, which the system's panels and gradient sums read,
    against the table tests/test_torch_tp_lean.py holds two gloo ranks'
    gradients to (`_sharding`: the rows a rank's panel splits and the axis
    they are split on)."""
    from test_torch_tp_lean import _flat_params, _sharding
    flat = _flat_params(np.random.default_rng(0), 24, 15, 32, 16, nvd=nvd)
    assert model_split_rows(flat, 8, nvd) == [_sharding(i, flat)
                                              for i in range(len(flat))]


def _cli(module, args, timeout):
    """A CLI in a process of its own (its workers in its session); ->
    (exit code, output).  The session is killed on the way out."""
    # One thread a process (run_workers passes it on to the workers): beside
    # the other pytest workers, torch's default of a thread a core in each
    # process oversubscribes the host.  With six copies of this test at once
    # on 8 cores, the one-process cli.eval below took 50-55 s of its 60 (4 s
    # with one thread), the 2-process cli.train 45-47 s (14-15 s).
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]),
               OMP_NUM_THREADS='1')
    proc = subprocess.Popen(
        [sys.executable, '-m', module, *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env,
        start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    return proc.returncode, out


def test_two_gloo_processes_under_a_model_axis(scene, tmp_path):
    """num_devices 2 parallel.model_axis 2 --device cpu: cli.train starts
    2 gloo workers on a data 1 x model 2 mesh; 8 steps with a checkpoint
    every 4; the ranks' parameters agree bit for bit at each checkpoint
    (fit raises otherwise), the final ones equal the single-process data 1
    x model 2 fit's within 1e-6, only rank 0 wrote (one log line a step,
    one CSV row a validation, one system line).  cli.eval of the
    checkpoint then runs in one process (checkpoint_hparams drops the
    model axis) and gives finite PSNR and SSIM."""
    out = str(tmp_path / 'gloo')
    opts = [str(x) for kv in TINY.items() for x in kv]
    tail = ['num_devices', '2', 'parallel.model_axis', '2'] + opts
    code, log = _cli('mipnerf_pl_tpu_torch.cli.train',
                     ['--data_path', scene, '--out_dir', out,
                      '--dataset_name', 'blender', '--device', 'cpu',
                      '--max_steps', '8'] + tail, timeout=150)
    assert code == 0, log[-3000:]
    assert log.count('mesh: data=1 model=2, process ') == 2, log[-3000:]
    assert log.count('Megatron pairs') == 1, log[-3000:]
    assert log.count('step 2/8 loss=') == 1
    ck = os.path.join(out, 'ckpt', 'tiny')
    with open(os.path.join(out, 'logs', 'tiny', 'val_history.csv')) as f:
        assert [r.split(',')[0] for r in f.read().split()[1:]] == ['4', '8']
    step, host = CheckpointManager(ck, write=False).restore_last()
    assert step == 8

    hp = _hparams(**{'num_devices': 2, 'parallel.model_axis': 2})
    with contextlib.redirect_stdout(io.StringIO()):
        single = MipNeRFSystem(hp, mesh=create_mesh(2, 2, device='cpu'))
        state = single.fit(scene, 'blender', str(tmp_path / 'single'),
                           max_steps=8)
    for k, v in state['params'].items():
        b = v.detach()
        assert float((host['params'][k] - b).abs().max()) <= \
            1e-6 * max(float(b.abs().max()), 1.0), k

    ev = checkpoint_hparams(ck)
    assert ev['num_devices'] == 1 and ev['parallel.model_axis'] == 1
    ev = checkpoint_hparams(ck, ['parallel.model_axis', '2', 'num_devices',
                                 '2'])
    assert ev['num_devices'] == 2 and ev['parallel.model_axis'] == 2
    code, log = _cli('mipnerf_pl_tpu_torch.cli.eval',
                     ['--ckpt', ck, '--out_dir', str(tmp_path / 'eval'),
                      '--scale', '1', '--no_video', '--device', 'cpu'],
                     timeout=60)
    assert code == 0, log[-3000:]
    assert log.count('PSNR | SSIM | Average') == 1
    for name in ('psnrs.txt', 'ssims.txt'):
        vals = np.loadtxt(str(tmp_path / 'eval' / 'test' / 'tiny' / name))
        assert vals.size and np.all(np.isfinite(vals)), name
