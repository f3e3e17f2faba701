"""The model axis's table and the state a process holds under it (CPU).

`model_split_rows` (kernels/tp_lean.py), the one table of the split's
compute, gradients and state, at every shape the JAX system trains under a
model axis, against the JAX table (mipnerf_pl_tpu/parallel/tp.py
`_spec_for`) but for its documented exceptions; the count of the state a
process holds at lego width on model 2.  Two gloo processes on the CPU
(data 1 x model 2, OMP_NUM_THREADS=1 as the other gloo tests set it), at
shapes the Megatron pairs alone do not take: each rank's parameters are
exactly its panels (its modules keep no whole copy), and after two steps
so are both Adam moments; the
checkpoint state holds whole tensors, within 1e-6 of the single-process
data 1 x model 2 mesh's after the same steps (its moments too); a resume
slices each rank's panels of the parameters and both moments bit for bit,
and its next step equals the unbroken state's bit for bit; cli.eval
--device cpu reads the checkpoint in one process.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from helpers import make_blender_scene
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.kernels.mlp import flatten_params, param_order
from mipnerf_pl_tpu_torch.kernels.tp_lean import model_split_rows
from mipnerf_pl_tpu_torch.models.mlp import MLP
from mipnerf_pl_tpu_torch.parallel.mesh import Mesh, create_mesh
from mipnerf_pl_tpu_torch.system import MipNeRFSystem, _Panels
from mipnerf_pl_tpu_torch.train.ckpt import CheckpointManager

F, FV, W, WV = 24, 9, 32, 16
# name -> MLP shape keywords: the base shape and the four the Megatron
# pairs alone did not take (a skip after the last layer among them).
SHAPES = {
    'depth8-skip4': dict(net_depth=8, skip_index=4),
    'depth7': dict(net_depth=7, skip_index=4),
    'skip3': dict(net_depth=8, skip_index=3),
    'depth4-skip1': dict(net_depth=4, skip_index=1),
    'condition0': dict(net_depth=8, skip_index=4, net_depth_condition=0),
    'no-viewdirs': dict(net_depth=8, skip_index=4, view_dim=0),
    'condition2': dict(net_depth=6, skip_index=3, net_depth_condition=2),
}
TINY = {'exp_name': 'tiny', 'train.batch_size': 64, 'nerf.num_samples': 8,
        'nerf.max_deg_point': 4, 'nerf.deg_view': 2,
        'nerf.mlp.net_width': 32, 'nerf.mlp.net_width_condition': 16,
        'train.randomized': False, 'optimizer.lr_delay_steps': 0,
        'nerf.mlp_backend': 'pallas_lean_save'}
# The gloo cases: an odd depth whose skips land at every place (skip 1:
# at both pair boundaries, inside the pair, and after the lone last
# layer, which reads W + F), the rgb head on the bottleneck, and no view
# directions (no bottleneck: the heads read the gathered last layer).
GLOO_CASES = {
    'depth5-skip1': {'nerf.mlp.net_depth': 5, 'nerf.mlp.skip_index': 1},
    'condition0': {'nerf.mlp.net_depth': 4, 'nerf.mlp.skip_index': 2,
                   'nerf.mlp.net_depth_condition': 0},
    'no-viewdirs': {'nerf.mlp.net_depth': 3, 'nerf.mlp.skip_index': 4,
                    'nerf.use_viewdirs': False},
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp(shape):
    kw = dict(shape)
    view_dim = kw.pop('view_dim', FV)
    return MLP(F, view_dim, net_width=W, net_width_condition=WV,
               generator=torch.Generator().manual_seed(0), **kw)


def _jax_entry(layer, kind, t):
    """JAX `_spec_for` of one flat tensor, in the table's terms."""
    from mipnerf_pl_tpu.parallel import tp as jtp
    leaf = np.zeros(tuple(t.shape) if kind == 'kernel' else (t.shape[1],))
    tree = {'params': {'mlp': {layer: {kind: leaf}}}}
    (path, _), = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec = tuple(jtp._spec_for('/'.join(str(p) for p in path), leaf))
    if 'model' not in spec:
        return (0, None)
    if kind == 'bias':
        return (1, 'col')
    return (t.shape[0], 'col' if spec.index('model') == 1 else 'row')


@pytest.mark.parametrize('shape', list(SHAPES))
def test_model_split_rows_against_jax_spec_for(shape):
    """Each tensor's entry equals JAX's but where the table's docstring
    says it differs: a skip layer's x-rows replicated (JAX splits all W + F
    rows), the layer that reads the bottleneck split on its W bottleneck
    rows (JAX: view_0 column-parallel, an rgb head replicated), the view
    layers after view_0 replicated (JAX: column-parallel)."""
    kw = SHAPES[shape]
    mlp = _mlp(kw)
    nd, ndc = mlp.net_depth, mlp.net_depth_condition
    flat = flatten_params(mlp, nd, ndc, mlp.use_viewdirs)
    table = model_split_rows(flat, nd, ndc, mlp.use_viewdirs)
    layers = param_order(nd, ndc, mlp.use_viewdirs)
    assert len(table) == len(flat) == 2 * len(layers)
    skips = set(range(mlp.skip_index, nd, mlp.skip_index))
    reads_bottleneck = ('view_0' if ndc else 'rgb') if mlp.use_viewdirs \
        else None
    differ = 0
    for i, t in enumerate(flat):
        layer, kind = layers[i // 2], ('kernel', 'bias')[i % 2]
        want = _jax_entry(layer, kind, t)
        if layer == reads_bottleneck:
            want = (W, 'row') if kind == 'kernel' else (0, None)
        elif layer.startswith('view_'):
            want = (0, None)
        elif (layer.startswith('trunk_') and kind == 'kernel'
              and int(layer[6:]) - 1 in skips and want[1] == 'row'):
            assert t.shape[0] == W + F
            want = (W, 'row')
        differ += want != _jax_entry(layer, kind, t)
        assert table[i] == want, (layer, kind)
    # The exceptions are where the docstring says, and only there.
    inside = sum(1 for e in skips if e % 2 == 0 and e + 1 < nd)
    assert differ == inside + (reads_bottleneck is not None) * (
        1 + (ndc > 0)) + 2 * max(ndc - 1, 0)


@pytest.mark.parametrize('model', [2, 4])
def test_table_counts_the_state_a_process_holds(model):
    """At lego width (8 x 256, F 96, condition 128, Fv 27) a model rank of
    a multi-process mesh holds its panels of the split regions (582,912 of
    612,740 parameters) and the replicated 29,828 whole: 0.524 of the
    state at model 2; each rank's local tensors, cut from whole ones, are
    that many elements."""
    system = MipNeRFSystem(config.default(), device='cpu')
    whole, mlp = system.init_params(seed=0), system.model.mlp
    for r in range(model):
        panels = _Panels(mlp, Mesh(1, model, 'cpu', True, r))
        held, total = panels.numel()
        assert total == 612740 == sum(v.numel() for v in whole.values())
        assert held == 582912 // model + 29828
        local = {k: panels.local(k, v) for k, v in whole.items()}
        assert sum(v.numel() for v in local.values()) == held
        for k, v in local.items():
            panel, rest = panels.regions(k, v)
            assert panel.numel() + rest.numel() == v.numel()
    if model == 2:
        assert round(held / total, 3) == 0.524


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp('scene')),
                              n_frames=3, size=16)


def _hparams(case, **extra):
    hp = config.default()
    hp.update(TINY)
    hp.update(GLOO_CASES[case])
    hp.update(extra)
    return hp


def _moments(state):
    """Adam's (exp_avg, exp_avg_sq) of each parameter, in order."""
    opt = state['opt_state'].state_dict()['state']
    return [(opt[i]['exp_avg'], opt[i]['exp_avg_sq'])
            for i in range(len(state['params']))]


def _steps(system, state, batches, first=0):
    for k, (rays, pixels) in enumerate(batches):
        state, aux = system.train_step(state, rays, pixels,
                                       system.step_generator(0, first + k))
    return state


def _batches(system, scene, n):
    system.setup(scene, 'blender', prefetch=0)
    try:
        return [next(system.batcher) for _ in range(n)]
    finally:
        system.batcher.close()


def _worker(rank: int, port: int, out_dir: str, scene: str,
            case: str) -> None:
    """One process of the 2-process gloo mesh: its state checked against
    its panels, 2 steps, the whole state written (rank 0), a resume from
    it checked, and a third step from both."""
    import torch.distributed as dist
    from mipnerf_pl_tpu_torch.parallel.mesh import \
        maybe_initialize_distributed
    assert maybe_initialize_distributed(
        {'parallel.multi_host': True,
         'parallel.coordinator_address': f'localhost:{port}',
         'parallel.num_processes': 2, 'parallel.process_id': rank},
        device='cpu', timeout_s=60)
    try:
        hp = _hparams(case, **{'num_devices': 2, 'parallel.model_axis': 2})
        with contextlib.redirect_stdout(io.StringIO()):
            system = MipNeRFSystem(hp, device='cpu')
        mesh = system.mesh
        assert mesh.distributed and mesh.shape == {'data': 1, 'model': 2}
        panels = system._panels
        whole = system.init_params(seed=0)
        state = system.init_state(seed=0)
        held, total = system.state_numel()
        assert held < total
        # The modules keep no whole copy: the state is all there is.
        assert not any(p.numel() for m in (system.model, system.eval_model)
                       for p in m.parameters())
        # The parameters are exactly this rank's panels.
        for k, v in state['params'].items():
            assert torch.equal(v.detach(), panels.local(k, whole[k])), k
        assert sum(v.numel() for v in state['params'].values()) == held
        batches = _batches(system, scene, 3)
        state = _steps(system, state, batches[:2])
        moments = _moments(state)
        for (k, v), (m, s) in zip(state['params'].items(), moments):
            assert m.shape == s.shape == v.shape, k
        counted = sum(t.numel() for t in state['params'].values()) + sum(
            m.numel() + s.numel() for m, s in moments)
        assert counted == 3 * held
        system.check_state(state)
        host = system.host_state(state)
        if rank == 0:
            torch.save(host, os.path.join(out_dir, 'host.pt'))
        # A resume takes this rank's panels of the parameters and of both
        # moments, the same bits the unbroken state holds.
        again = system.load_state(host)
        assert again['step'] == 2
        for (k, v), w in zip(state['params'].items(),
                             again['params'].values()):
            assert torch.equal(w.detach(), panels.local(k, host['params'][k]))
            assert torch.equal(w.detach(), v.detach()), k
        for i, (k, (m, s), (m2, s2)) in enumerate(
                zip(state['params'], moments, _moments(again))):
            full = host['opt_state']['state'][i]
            assert torch.equal(m2, panels.local(k, full['exp_avg'])), k
            assert torch.equal(s2, panels.local(k, full['exp_avg_sq'])), k
            assert torch.equal(m2, m) and torch.equal(s2, s), k
        state = _steps(system, state, batches[2:], first=2)
        again = _steps(system, again, batches[2:], first=2)
        for k, v in state['params'].items():
            assert torch.equal(v.detach(), again['params'][k].detach()), k
        np.savez(os.path.join(out_dir, f'rank{rank}.npz'),
                 **{k: v.detach().numpy()
                    for k, v in state['params'].items()})
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('case', list(GLOO_CASES))
def test_two_gloo_processes_hold_their_panels(scene, tmp_path, case):
    """The worker's checks on each of 2 gloo ranks (their panels, the
    resume), then here: the state rank 0 wrote holds whole tensors in the
    one-device layout, within 1e-6 of the single-process data 1 x model 2
    mesh's after the same 2 steps (its parameters and both moments), each
    rank's parameters after a third step are that mesh's panels within
    1e-6, and cli.eval --device cpu reads a checkpoint of that state in one
    process."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, 'tests')]
        + [p for p in [os.environ.get('PYTHONPATH')] if p]),
               OMP_NUM_THREADS='1')
    out = str(tmp_path)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port),
         out, scene, case], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    hp = _hparams(case, **{'num_devices': 2, 'parallel.model_axis': 2})
    with contextlib.redirect_stdout(io.StringIO()):
        single = MipNeRFSystem(hp, mesh=create_mesh(2, 2, device='cpu'))
    assert single._panels is None
    state = single.init_state(seed=0)
    batches = _batches(single, scene, 3)
    state = _steps(single, state, batches[:2])
    host = torch.load(os.path.join(out, 'host.pt'), weights_only=True)
    assert host['step'] == 2

    def close(a, b, what):
        assert a.shape == b.shape, what
        assert float((a - b).abs().max()) <= \
            1e-6 * max(float(b.abs().max()), 1.0), what

    for i, ((k, v), (m, s)) in enumerate(zip(state['params'].items(),
                                             _moments(state))):
        close(host['params'][k], v.detach(), k)
        full = host['opt_state']['state'][i]
        close(full['exp_avg'], m, f'{k} exp_avg')
        close(full['exp_avg_sq'], s, f'{k} exp_avg_sq')
    state = _steps(single, state, batches[2:], first=2)
    for rank in range(2):
        panels = _Panels(single.model.mlp, Mesh(1, 2, 'cpu', True, rank))
        with np.load(os.path.join(out, f'rank{rank}.npz')) as z:
            for k, v in state['params'].items():
                close(torch.from_numpy(z[k]),
                      panels.local(k, v.detach()), f'rank {rank} {k}')

    ck = os.path.join(out, 'ckpt')
    hp.update({'dataset_name': 'blender', 'data_path': scene})
    CheckpointManager(ck, hparams=hp).save(2, host, val_psnr=0.0)
    from mipnerf_pl_tpu_torch.cli import eval as eval_cli
    with contextlib.redirect_stdout(io.StringIO()) as said:
        summary = eval_cli.main(['--ckpt', ck, '--out_dir', out, '--scale',
                                 '1', '--no_video', '--device', 'cpu'])
    assert 'PSNR | SSIM | Average' in said.getvalue()
    psnr, ssim = (float(v) for v in summary.split(' | ')[:2])
    assert np.isfinite(psnr) and np.isfinite(ssim)


if __name__ == '__main__':
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5])
