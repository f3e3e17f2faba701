"""Data parallelism through the port's system, on the CPU.

The port's `MipNeRFSystem` over the `data` axis of a mesh against the JAX
system on its 8-device virtual mesh (tests/conftest.py): 3 steps of
make_train_many at data 2 and data 8 of the single-process mesh, on the
Blender scene and on the converted multi-scale scene (whose shards' lossmult
sums differ), train.randomized False, `pallas_lean_save` and `xla`, at
test_run_slice_matches_jax's bars (aux 2e-6 relative, each parameter step
within 1e-3 of JAX's norm).  With train.randomized True, data 2 against
data 1 of the port (1e-6 relative): every shard draws at the batch's shape
and keeps its rows.  A sharded render_camera equals the unsharded one bit
for bit, also where the frame's rays do not divide by the data axis.
TrainBatcher's rank slices concatenate to the one-device batch.  Two gloo
processes started by cli.train's own launcher (`num_devices 2 --device
cpu`): their parameters agree bit for bit at each checkpoint (fit checks
it), the run equals the single-process data-2 mesh within 1e-6, one
process wrote the files, and a second start resumes from the last step.
Tiny model: tests/test_torch_fit.py's TINY on a 16x16 scene.
"""

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
from mipnerf_pl_tpu_torch.data.datasets import Blender
from mipnerf_pl_tpu_torch.data.pipeline import TrainBatcher
from mipnerf_pl_tpu_torch.data.synthetic import make_sphere_scene
from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh
from mipnerf_pl_tpu_torch.system import MipNeRFSystem
from mipnerf_pl_tpu_torch.train.ckpt import CheckpointManager

TINY = {'exp_name': 'tiny', 'train.batch_size': 64, 'nerf.num_samples': 8,
        'nerf.max_deg_point': 4, 'nerf.deg_view': 2, 'nerf.mlp.net_depth': 2,
        'nerf.mlp.net_width': 32, 'nerf.mlp.net_width_condition': 16,
        'val.chunk_size': 128, 'val.sample_num': 1, 'val.check_interval': 4,
        'train.steps_per_call': 2, 'optimizer.lr_delay_steps': 0,
        'nerf.ipe_backend': 'pallas'}
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


@pytest.fixture(scope='module')
def jax_runs():
    """_jax_run's cache: every data size of the port is held against one
    JAX run."""
    return {}


def _jax_run(runs, data_path, dataset, backend):
    """3 steps of the JAX system (8-device mesh) over its own batcher's
    [3, B, C] stack -> (hparams, start params, batch pixels, aux, params
    after), kept in `runs`."""
    key = (data_path, dataset, backend)
    if key not in runs:
        from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
        hp = _hparams(**{'train.randomized': False,
                         'nerf.mlp_backend': backend,
                         'nerf.stop_resample_grad':
                             backend == 'pallas_lean_save'})
        jsys = JSystem(hp)
        assert jsys.mesh.shape['data'] == 8
        jsys.setup(data_path, dataset, prefetch=0, steps_per_call=3)
        jstate = jsys.init_state()
        start = _np_tree(jstate['params'])
        try:
            jrays, jpixels = next(jsys.batcher)
        finally:
            jsys.batcher.close()
        jstate, jaux = jsys.make_train_many(donate=False)(
            jstate, jrays, jpixels, jax.random.PRNGKey(int(hp['seed'])))
        runs[key] = (hp, start, np.asarray(jpixels),
                     {k: np.asarray(v) for k, v in jaux.items()},
                     _np_tree(jstate['params']))
    return runs[key]


def _port_matches_jax(runs, data_path, dataset, backend, d):
    hp, start, jpixels, jaux, jafter = _jax_run(runs, data_path, dataset,
                                                backend)
    system = MipNeRFSystem(hp, mesh=create_mesh(d, device='cpu'))
    assert system.mesh.shape == {'data': d, 'model': 1}
    system.setup(data_path, dataset, prefetch=0, steps_per_call=3)
    state = system.init_state(params=jax_params_to_torch(start))
    try:
        rays, pixels = next(system.batcher)
    finally:
        system.batcher.close()
    np.testing.assert_array_equal(pixels.numpy(), jpixels)
    if dataset == 'multi_blender':
        # The shards' lossmult sums differ: a mean of per-shard means
        # would not be the batch's loss.
        sums = rays.lossmult[0].reshape(d, -1).sum(dim=1)
        assert len(set(sums.tolist())) > 1
    state, aux = system.make_train_many()(state, rays, pixels,
                                          int(hp['seed']))
    assert state['step'] == 3
    for name in ('loss', 'train/psnr', 'train/psnr_coarse', 'lr'):
        np.testing.assert_allclose(aux[name].numpy(), jaux[name], rtol=2e-6,
                                   err_msg=name)
    after = torch_params_to_jax(state['params'])
    for (path, a), b, s in zip(jax.tree_util.tree_flatten_with_path(after)[0],
                               jax.tree.leaves(jafter),
                               jax.tree.leaves(start)):
        step_port, step_jax = a - s, b - s
        assert np.linalg.norm(step_jax) > 0, jax.tree_util.keystr(path)
        assert (np.linalg.norm(step_port - step_jax)
                <= 1e-3 * np.linalg.norm(step_jax)), jax.tree_util.keystr(path)


@pytest.mark.parametrize('d', [2, 8])
@pytest.mark.parametrize('backend', ['pallas_lean_save', 'xla'])
def test_dp_step_matches_jax(jax_runs, scene, backend, d):
    """3 steps at data d of the single-process mesh against JAX's 8-device
    mesh on the Blender scene."""
    _port_matches_jax(jax_runs, scene, 'blender', backend, d)


@pytest.mark.parametrize('d', [2, 8])
@pytest.mark.parametrize('backend', ['pallas_lean_save', 'xla'])
def test_dp_step_matches_jax_on_multiscale(jax_runs, multiscale, backend,
                                           d):
    """The same on multi-scale data, lossmult 1 and 4 in every batch."""
    _port_matches_jax(jax_runs, multiscale, 'multi_blender', backend, d)


def _port_run(scene, hp, d, steps=3):
    system = MipNeRFSystem(hp, mesh=create_mesh(d, device='cpu'))
    system.setup(scene, 'blender', prefetch=0, steps_per_call=steps)
    state = system.init_state(seed=0)
    try:
        rays, pixels = next(system.batcher)
    finally:
        system.batcher.close()
    return system.make_train_many()(state, rays, pixels, int(hp['seed']))


@pytest.mark.parametrize('backend,noise', [('pallas_lean_save', 0.0),
                                           ('xla', 1.0)])
def test_dp_randomized_equals_one_device(scene, backend, noise):
    """train.randomized True (and on `xla` the density noise): data 2 draws
    what data 1 does, so its loss and every parameter after 3 steps equal
    data 1's within 1e-6 relative."""
    hp = _hparams(**{'train.randomized': True, 'nerf.mlp_backend': backend,
                     'nerf.density_noise': noise,
                     'nerf.stop_resample_grad':
                         backend == 'pallas_lean_save'})
    one, aux1 = _port_run(scene, hp, 1)
    two, aux2 = _port_run(scene, hp, 2)
    np.testing.assert_allclose(aux2['loss'].numpy(), aux1['loss'].numpy(),
                               rtol=1e-6)
    for k, b in one['params'].items():
        a, b = two['params'][k].detach(), b.detach()
        assert float((a - b).norm()) <= 1e-6 * float(b.norm()), k
    # The draws matter: another base seed moves the loss.
    hp2 = dict(hp, seed=int(hp['seed']) + 1)
    assert not torch.equal(_port_run(scene, hp2, 2)[1]['loss'],
                           aux2['loss'])


@pytest.mark.parametrize('d,side,atol', [(2, 16, 0.0), (2, 15, 0.0),
                                          (3, 16, 1e-6)])
def test_sharded_render_camera_equals_unsharded(scene, d, side, atol):
    """render_camera over data d against data 1: bit for bit at 256 rays
    and at 225 (which 2 does not divide); with a chunk of 128 that 3 does
    not divide (rounded up to 129, the last chunk edge-padded) within
    1e-6, since the CPU's matmul rounds a 43-row block's sums apart from a
    128-row one's in the last bit."""
    hp = _hparams(**{'train.batch_size': 96})
    one = MipNeRFSystem(hp, device='cpu')
    many = MipNeRFSystem(hp, mesh=create_mesh(d, device='cpu'))
    params = one.init_params(seed=0)
    cam, _ = Blender(scene, 'val', batch_type='single_image').camera(0)
    want = one.render_camera(params, cam, side, side)
    got = many.render_camera(params, cam, side, side)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize('d', [2, 4])
def test_batcher_rank_slices_concatenate_to_the_batch(scene, d):
    """Shard r of d gathers row block r of each step's batch: the shards'
    stacks, side by side, are the one-device stack bit for bit."""
    ds = Blender(scene, 'train')
    whole = TrainBatcher(ds, 64, seed=7, prefetch=0, steps_per_call=3)
    shards = [TrainBatcher(ds, 64, seed=7, prefetch=0, steps_per_call=3,
                           shard=(r, d)) for r in range(d)]
    for _ in range(2):
        rays, pixels = next(whole)
        parts = [next(b) for b in shards]
        for f, name in enumerate(rays._fields):
            torch.testing.assert_close(
                torch.cat([p[0][f] for p in parts], dim=1), rays[f],
                rtol=0, atol=0, msg=name)
        torch.testing.assert_close(torch.cat([p[1] for p in parts], dim=1),
                                   pixels, rtol=0, atol=0)
    with pytest.raises(ValueError, match='train.batch_size=64.*data=3'):
        TrainBatcher(ds, 64, prefetch=0, shard=(0, 3))


def _cli(args, timeout):
    """cli.train in a process of its own (its workers in its session);
    -> (exit code, output).  The session is killed on the way out."""
    # One thread a process (run_workers passes it on to the workers): torch's
    # default of a thread a core oversubscribes the host beside the other
    # pytest workers (test_torch_tp_system.py's _cli).
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]),
               OMP_NUM_THREADS='1')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'mipnerf_pl_tpu_torch.cli.train', *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
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


def test_two_gloo_processes_through_the_cli(scene, tmp_path):
    """num_devices 2 --device cpu: cli.train starts 2 gloo workers; 20
    steps with a checkpoint every 4; the workers' parameters agree bit for
    bit at each checkpoint (fit raises otherwise), the final ones equal a
    single-process data-2 fit's within 1e-6, only the first worker wrote
    (one log line a step, one CSV row a validation), and a second start
    resumes from step 20."""
    out = str(tmp_path / 'gloo')
    opts = [str(x) for kv in TINY.items() for x in kv]
    args = ['--data_path', scene, '--out_dir', out, '--dataset_name',
            'blender', '--device', 'cpu']
    tail = ['num_devices', '2'] + opts
    code, log = _cli(args + ['--max_steps', '20'] + tail, timeout=100)
    assert code == 0, log[-3000:]
    assert log.count('mesh: data=2 model=1, process ') == 2, log[-3000:]
    assert log.count('step 2/20 loss=') == 1
    ck = os.path.join(out, 'ckpt', 'tiny')
    hist = os.path.join(out, 'logs', 'tiny', 'val_history.csv')
    with open(hist) as f:
        assert [r.split(',')[0] for r in f.read().split()[1:]] == \
            ['4', '8', '12', '16', '20']
    step, host = CheckpointManager(ck, write=False).restore_last()
    assert step == 20

    hp = _hparams(**{'num_devices': 2})
    single = MipNeRFSystem(hp, mesh=create_mesh(2, device='cpu'))
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        state = single.fit(scene, 'blender', str(tmp_path / 'single'),
                           max_steps=20)
    for k, v in state['params'].items():
        b = v.detach()
        assert float((host['params'][k] - b).abs().max()) <= \
            1e-6 * max(float(b.abs().max()), 1.0), k

    code, log = _cli(args + ['--max_steps', '24'] + tail, timeout=45)
    assert code == 0, log[-3000:]
    assert log.count('at step 20') == 1 and 'step 22/24 loss=' in log
    assert 'step 2/24 ' not in log
    with open(hist) as f:
        assert [r.split(',')[0] for r in f.read().split()[1:]][-2:] == \
            ['20', '24']


def test_launcher_counts_its_workers_and_fails_with_them(monkeypatch):
    """workers_to_start: num_devices / num_gpus above 1 start that many
    workers (gloo on the CPU); 0 or 1 none; more CUDA devices than the
    host has raise; a worker, or a process of a multi-host run, starts
    none.  run_workers returns a failing worker's exit code."""
    from mipnerf_pl_tpu_torch.parallel import launch
    hp = _hparams()
    assert launch.workers_to_start(dict(hp, num_devices=2), 'cpu') == 2
    assert launch.workers_to_start(dict(hp, num_gpus=3), 'cpu') == 3
    assert launch.workers_to_start(dict(hp, num_devices=0), 'cpu') == 0
    assert launch.workers_to_start(dict(hp, num_gpus=1), 'cpu') == 0
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(ValueError, match='--device cpu'):
        launch.workers_to_start(dict(hp, num_devices=2), None)
    assert launch.workers_to_start(dict(hp, num_devices=0), None) == 0
    assert launch.workers_to_start(
        dict(hp, num_devices=2, **{'parallel.multi_host': True}), 'cpu') == 0
    monkeypatch.setenv(launch.WORKER_ENV, 'localhost:1,2,0')
    assert launch.workers_to_start(dict(hp, num_devices=2), 'cpu') == 0
    monkeypatch.delenv(launch.WORKER_ENV)
    # Both workers exit with argparse's code 2 (no --out_dir).
    assert launch.run_workers('mipnerf_pl_tpu_torch.cli.train',
                              ['--data_path', 'x', '--dataset_name',
                               'blender'], 2) == 2


def test_eval_cli_over_two_gloo_processes(scene, tmp_path):
    """cli.eval of a checkpoint whose hparams ask for 2 devices starts 2
    gloo workers (--device cpu), each rendering its rows of every chunk;
    the first writes the metrics, which equal a one-device eval of the
    same checkpoint (`num_devices 1` merged over its hparams)."""
    from mipnerf_pl_tpu_torch.cli import eval as eval_cli
    hp = _hparams(**{'num_devices': 2})
    system = MipNeRFSystem(hp, mesh=create_mesh(2, device='cpu'))
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        system.fit(scene, 'blender', str(tmp_path / 'run'), max_steps=4)
    ck = str(tmp_path / 'run' / 'ckpt' / 'tiny')
    # One thread a process (run_workers passes it on to the workers): torch's
    # default of a thread a core oversubscribes the host beside the other
    # pytest workers (test_torch_tp_system.py's _cli).
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]),
               OMP_NUM_THREADS='1')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'mipnerf_pl_tpu_torch.cli.eval', '--ckpt', ck,
         '--out_dir', str(tmp_path / 'two'), '--scale', '1', '--no_video',
         '--device', 'cpu'], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env,
        start_new_session=True)
    try:
        log = proc.communicate(timeout=60)[0]
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    assert proc.returncode == 0, log[-3000:]
    assert log.count('PSNR | SSIM | Average') == 1
    assert log.count('image 0: psnr=') == 1
    with contextlib.redirect_stdout(io.StringIO()):
        eval_cli.main(['--ckpt', ck, '--out_dir', str(tmp_path / 'one'),
                       '--scale', '1', '--no_video', '--device', 'cpu',
                       'num_devices', '1'])
    for name in ('psnrs.txt', 'ssims.txt'):
        got, want = (np.loadtxt(str(tmp_path / d / 'test' / 'tiny' / name))
                     for d in ('two', 'one'))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
