"""The PyTorch port's training step against the JAX package (CPU).

Parameters cross with convert.py; inputs are numpy-seeded.  Pieces:
distloss at rtol = atol = 1e-6 (the same O(N) prefix sums), the LR
schedule at 1e-7 relative (both float32), and the Adam update against
optax.adam and the JAX package's packed_adam at 1e-7 (torch computes the
moments with lerp / addcmul, optax with products: the last f32 bit).

The slice: a JAX MipNeRFSystem and the port's on the same params and rays,
train.randomized False, the same lean backend on both ('pallas_lean',
'pallas_lean_save', 'pallas_hybrid'; the JAX side runs its Pallas kernels
in interpret mode), and one case with density_noise 1.0, which leaves the
heads raw (act=None) on both sides.  With stop_resample_grad False the
resampled level's samples carry the gradient of the coarse weights: the
plain 'xla' path and the input-differentiable 'pallas' / 'pallas_save'
backends (fused_mlp, dx and dview in its backward) train so on both sides,
and a test shows that the term moves the density and trunk gradients far
beyond the gradient bar.  The JAX lean path takes the IPE with
~1e-6-accurate polynomial exp/sin and its prefix sums (resample CDF,
transmittance, distloss) as triangular matmuls; the port takes libm and
cumsum.  So the loss and its aux values compare at 2e-6 relative (measured
1.5e-7) and every parameter gradient at 1e-5 of the largest entry of its
leaf (measured 6.7e-7).  After 3 train steps the parameter updates compare
at 1e-3 of their norm (measured 1.5e-4): Adam's first steps are ~ -lr *
sign(g), so an entry whose gradient lies within its error of zero may move
the other way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mipnerf_pl_tpu.ops.render import distloss as jdistloss
from mipnerf_pl_tpu.train.opt import packed_adam
from mipnerf_pl_tpu.train.schedule import mip_lr_decay as jmip_lr_decay
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.convert import (jax_params_to_torch,
                                          torch_params_to_jax)
from mipnerf_pl_tpu_torch.models.mlp import LEAN_BACKENDS
from mipnerf_pl_tpu_torch.ops.render import distloss
from mipnerf_pl_tpu_torch.rays import Rays
from mipnerf_pl_tpu_torch.train.opt import adam, adam_step
from mipnerf_pl_tpu_torch.train.schedule import mip_lr_decay
from mipnerf_pl_tpu_torch.utils.metrics import calc_psnr


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_distloss_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.uniform(0, 1, size=(7, 16)).astype(np.float32)
    t = np.sort(rng.uniform(2, 6, size=(7, 17)), -1).astype(np.float32)
    want = float(jdistloss(jnp.asarray(w), jnp.asarray(t)))
    got = float(distloss(torch.from_numpy(w), torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The O(N) identity equals the reference's O(N^2) double sum.
    m = 0.5 * (t[:, 1:] + t[:, :-1])
    bi = np.mean(np.sum(w[:, :, None] * w[:, None, :]
                        * np.abs(m[:, :, None] - m[:, None, :]), (1, 2)))
    uni = np.mean(np.sum((t[:, 1:] - t[:, :-1]) * w ** 2, -1)) / 3
    np.testing.assert_allclose(got, bi + uni, rtol=1e-5)


def test_psnr_matches_definition():
    x, y = torch.full((4, 3), 0.5), torch.full((4, 3), 0.6)
    np.testing.assert_allclose(float(calc_psnr(x, y)), 20.0, rtol=1e-5)


@pytest.mark.parametrize('delay', [2500, 0])
def test_lr_schedule_matches_jax(delay):
    args = (5e-4, 5e-6, 1000000, delay, 0.01)
    ours, theirs = mip_lr_decay(*args), jmip_lr_decay(*args)
    for step in (0, 1, 7, 1250, 2500, 10 ** 5, 10 ** 6, 2 * 10 ** 6):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-7)


@pytest.mark.parametrize('which', ['optax', 'packed'])
def test_adam_matches_optax(which):
    """Five updates of the same params and gradients, lr from the schedule
    at the 0-indexed step, against optax.adam and packed_adam."""
    sched_args = (5e-4, 5e-6, 1000, 0, 0.01)
    rng = np.random.default_rng(1)
    params = {'a': rng.normal(size=(4, 3)).astype(np.float32),
              'b': rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10 ** -i
              for k, v in params.items()} for i in range(5)]
    jsched = jmip_lr_decay(*sched_args)
    tx = optax.adam(jsched) if which == 'optax' else packed_adam(jsched)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = adam(list(tp.values()))
    for step, g in enumerate(grads):
        adam_step(opt, [torch.tensor(g[k]) for k in tp], step,
                  mip_lr_decay(*sched_args))
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def _hparams(**overrides):
    hp = config.default()
    hp.update({'nerf.num_samples': 8, 'nerf.max_deg_point': 4,
               'nerf.deg_view': 2, 'nerf.mlp.net_depth': 3,
               'nerf.mlp.net_width': 16, 'nerf.mlp.net_width_condition': 16,
               'nerf.mlp.skip_index': 2, 'train.randomized': False,
               'nerf.mlp_backend': 'pallas_lean_save'})
    hp.update(overrides)
    return hp


def _batch(B=16, seed=0):
    """Synthetic rays as bench.py makes them (directions normalised,
    origins near the centre), and pixel targets."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((B, 1), np.float32)
    rays = Rays(rng.normal(size=(B, 3)).astype(np.float32) * 0.1, d, d,
                ones * 0.005, ones, ones * 2.0, ones * 6.0)
    return rays, rng.uniform(size=(B, 3)).astype(np.float32)


def _systems(hp):
    from mipnerf_pl_tpu.rays import Rays as JRays
    from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    jsys = JSystem(hp)
    jstate = jsys.init_state()
    system = MipNeRFSystem(hp, device='cpu')
    state = system.init_state(params=jax_params_to_torch(
        _np_tree(jstate['params'])))
    return jsys, jstate, system, state, JRays


def _leaf_close(got, want, rel):
    """Every leaf within rel of the largest entry of its leaf."""
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        w = np.asarray(w)
        np.testing.assert_allclose(flat_g[path], w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def _slice_case(backend, disable_multiscale=False, noise=0.0, id=None,
                **fused):
    """A case of test_train_slice_matches_jax; the cases without fusion
    options keep their ids '<backend>-<disable_multiscale>-<noise>'."""
    return pytest.param(backend, disable_multiscale, noise, fused,
                        id=id or f'{backend}-{disable_multiscale}-{noise}')


@pytest.mark.parametrize('backend,disable_multiscale,noise,fused', [
    _slice_case('pallas_lean_save'), _slice_case('pallas_lean_save', True),
    _slice_case('pallas_lean'), _slice_case('pallas_hybrid'),
    _slice_case('pallas_lean', noise=1.0),
    _slice_case('pallas_lean_save', id='pallas_lean_save-render',
                fuse_render=True),
    _slice_case('pallas_lean', id='pallas_lean-render', fuse_render=True),
    _slice_case('pallas_lean_save', id='pallas_lean_save-render-encode',
                fuse_render=True, fuse_encode=True),
    _slice_case('pallas_lean', id='pallas_lean-encode', fuse_encode=True),
    _slice_case('pallas_lean_save', id='pallas_lean_save-pallas_encode',
                pallas_encode=True),
    _slice_case('xla', id='xla-resample', stop_resample_grad=False),
    _slice_case('pallas', id='pallas-resample', stop_resample_grad=False),
    _slice_case('pallas_save', id='pallas_save-resample',
                stop_resample_grad=False),
    _slice_case('pallas', noise=1.0, id='pallas-resample-noise',
                stop_resample_grad=False),
    _slice_case('xla', id='xla-resample-ipe', stop_resample_grad=False,
                ipe_backend='pallas'),
    _slice_case('pallas', id='pallas-resample-ipe', stop_resample_grad=False,
                ipe_backend='pallas'),
    _slice_case('pallas_lean_save', id='pallas_lean_save-ipe',
                ipe_backend='pallas')])
def test_train_slice_matches_jax(backend, disable_multiscale, noise, fused):
    """One step's loss, aux values and every parameter gradient, then the
    parameters after 3 train_steps, port against JAX.  With `fused`: the
    render-fused level (TPU kernels #1 and #2 on the JAX side), the
    moments input of the lean kernels (the IPE decoded in them) and the
    standalone moments encode (#12), each engaging on both sides; or
    stop_resample_grad False, on the plain path and on the two
    input-differentiable backends (#6-#9 on the JAX side); or
    ipe_backend 'pallas' (the standalone IPE #10 and, where the resampled
    Gaussians carry a gradient, its VJP #11)."""
    hp = _hparams(**{'loss.disable_multiscale_loss': disable_multiscale,
                     'nerf.mlp_backend': backend,
                     'nerf.density_noise': noise},
                  **{f'nerf.{k}': v for k, v in fused.items()})
    jsys, jstate, system, state, JRays = _systems(hp)
    assert system.model.mlp_backend == backend
    assert system.model._fused_act == (noise == 0.0
                                       and backend in LEAN_BACKENDS)
    for opt in ('fuse_render', 'fuse_encode', 'pallas_encode'):
        gate = '_' + opt.replace('fuse_', 'fused_')
        assert getattr(system.model, gate) == bool(fused.get(opt)), gate
    assert system.model.ipe_backend == fused.get('ipe_backend', 'xla')
    rays, pixels = _batch()
    if disable_multiscale:     # lossmult then has no effect on the loss
        rays = rays._replace(lossmult=rays.lossmult * 0.5)
    jrays = JRays(*rays)
    key = jax.random.PRNGKey(0)
    (jloss, jaux), jgrads = jax.value_and_grad(jsys.loss_fn, has_aux=True)(
        jstate['params'], jrays, pixels, key)
    trays = Rays(*(torch.from_numpy(f) for f in rays))
    (loss, aux), grads = system.value_and_grad(state['params'], trays,
                                               torch.from_numpy(pixels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=2e-6,
                                   err_msg=k)
    _leaf_close(torch_params_to_jax(grads), _np_tree(jgrads), 1e-5)

    start = torch_params_to_jax(state['params'])
    for step in range(3):
        jstate, jaux = jsys.train_step(jstate, jrays, pixels,
                                       jax.random.fold_in(key, step))
        state, aux = system.train_step(state, rays, pixels)
    assert state['step'] == int(jstate['step']) == 3
    np.testing.assert_allclose(float(aux['lr']), float(jaux['lr']),
                               rtol=1e-6)
    np.testing.assert_allclose(float(aux['loss']), float(jaux['loss']),
                               rtol=2e-6)
    after = torch_params_to_jax(state['params'])
    jafter = _np_tree(jstate['params'])
    for (path, a), b, s in zip(jax.tree_util.tree_flatten_with_path(after)[0],
                               jax.tree.leaves(jafter),
                               jax.tree.leaves(start)):
        step_port, step_jax = a - s, np.asarray(b) - s
        assert np.linalg.norm(step_jax) > 0, jax.tree_util.keystr(path)
        assert (np.linalg.norm(step_port - step_jax)
                <= 1e-3 * np.linalg.norm(step_jax)), jax.tree_util.keystr(path)


def test_resample_gradient_term_is_there():
    """With stop_resample_grad False the gradient reaches the coarse level's
    parameters through the resampled samples too: on 'pallas' the density
    and trunk leaves move by more than 100 x the slice's 1e-5 bar (of each
    leaf's largest entry) against stop_resample_grad True, so a backward
    that dropped dx or dview could not pass the slice test."""
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    rays, pixels = _batch()
    trays = Rays(*(torch.from_numpy(f) for f in rays))
    grads = {}
    for stop in (True, False):
        system = MipNeRFSystem(_hparams(**{'nerf.mlp_backend': 'pallas',
                                           'nerf.stop_resample_grad': stop}),
                               device='cpu')
        state = system.init_state(seed=0)
        _, grads[stop] = system.value_and_grad(state['params'], trays,
                                               torch.from_numpy(pixels))
    for leaf in ('mlp.density.weight', 'mlp.trunk_0.weight',
                 'mlp.trunk_2.weight'):
        a, b = grads[True][leaf], grads[False][leaf]
        assert float((a - b).abs().max()) > 100 * 1e-5 * float(
            b.abs().max()), leaf


def test_train_many_replays_single_steps():
    """make_train_many over K stacked batches equals K train_steps with
    the per-step generators, randomized sampling on; the loss is finite
    and the state advances in place."""
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    hp = _hparams(**{'train.randomized': True})
    system = MipNeRFSystem(hp, device='cpu')
    rays, pixels = _batch(8)
    K = 3
    stack = Rays(*(np.broadcast_to(f, (K,) + f.shape).copy() for f in rays))
    pix = np.broadcast_to(pixels, (K,) + pixels.shape).copy()
    a = system.init_state(seed=3)
    a, aux = system.make_train_many()(a, stack, pix, 11)
    assert a['step'] == K and aux['loss'].shape == (K,)
    assert torch.isfinite(aux['loss']).all()
    b = system.init_state(seed=3)
    for k in range(K):
        b, _ = system.train_step(b, rays, pixels,
                                 system.step_generator(11, k))
    for name in a['params']:
        torch.testing.assert_close(a['params'][name], b['params'][name],
                                   rtol=0, atol=0)
    c = system.init_state(seed=3)
    system.train_step(c, rays, pixels, system.step_generator(12, 0))
    assert not torch.equal(c['params']['mlp.rgb.bias'],
                           system.init_state(seed=3)['params']
                           ['mlp.rgb.bias'])



def test_system_runs_on_cuda_unless_asked_for_cpu(monkeypatch):
    """MipNeRFSystem's entry points run on the card by default: with no
    card and no device it raises (naming device='cpu') rather than quietly
    picking the CPU; asked for the CPU it trains there."""
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(ValueError, match="device='cpu'"):
        MipNeRFSystem(_hparams())
    system = MipNeRFSystem(_hparams(), device='cpu')
    assert system.device == torch.device('cpu')
    rays, pixels = _batch(8)
    state, aux = system.train_step(system.init_state(seed=0), rays, pixels)
    assert state['step'] == 1 and torch.isfinite(aux['loss'])


@pytest.mark.parametrize('setting,refused', [
    ({'num_devices': 4}, True),
    ({'num_gpus': 2}, True),
    ({'parallel.model_axis': 2, 'nerf.mlp.net_depth': 4}, True),
    ({'parallel.multi_host': True}, True),
    ({'num_devices': 1}, False),
    ({'num_devices': 0, 'num_gpus': 1, 'parallel.model_axis': 1,
      'parallel.multi_host': False}, False),
])
def test_system_refuses_parallel_settings_it_does_not_honour(setting,
                                                             refused):
    """Several devices without a process group raise the launcher's
    message (one process a device), and with an explicit single-process
    mesh train over the mesh; a model axis that does not divide the one
    device raises naming both keys, and on mesh=create_mesh(2, 2) takes a
    finite step; multi-host without an initialised group raises.  One
    device, asked for in either key, is accepted."""
    from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    hp = _hparams(**setting)
    if not refused:
        system = MipNeRFSystem(hp, device='cpu')
        assert system.device.type == 'cpu'
        assert system.mesh.shape == {'data': 1, 'model': 1}
        return
    key = next(iter(setting))
    if key == 'parallel.multi_host':
        with pytest.raises(ValueError, match='maybe_initialize_distributed'):
            MipNeRFSystem(hp, device='cpu')
        return
    n = setting[key]
    with pytest.raises(ValueError, match='cli.train') as err:
        MipNeRFSystem(hp, device='cpu')
    model = 1
    if key == 'parallel.model_axis':
        model = n
        assert f'{key}={n!r}' in str(err.value)
        assert 'num_devices=' in str(err.value)
    assert f'mesh=create_mesh({n}, {model}' in str(err.value)
    system = MipNeRFSystem(hp, mesh=create_mesh(n, model, device='cpu'))
    assert system.mesh.shape == {'data': n // model, 'model': model}
    rays, pixels = _batch(8)
    state, aux = system.train_step(system.init_state(seed=0), rays, pixels)
    assert state['step'] == 1 and torch.isfinite(aux['loss'])


@pytest.mark.parametrize('setting,key', [
    ({'nerf.mlp.net_depth': 3}, 'nerf.mlp.net_depth'),
    ({'nerf.mlp.skip_index': 1}, 'nerf.mlp.skip_index'),
    ({'nerf.mlp.net_depth_condition': 0}, 'nerf.mlp.net_depth_condition'),
    ({'nerf.mlp.net_width': 6}, 'nerf.mlp.net_width'),
    ({'nerf.use_viewdirs': False}, 'nerf.use_viewdirs'),
])
def test_model_axis_refuses_shapes_its_split_cannot_take(setting, key):
    """Under a model axis the Megatron split of tp_mlp_forward takes every
    shape the JAX system trains: an odd depth, an odd skip index, no view
    layer and no view directions build at data 1 x model 4 and take a
    finite step.  It refuses, as JAX's placement does, only a trunk width
    the axis does not divide: a ValueError naming the key.  All five
    build on one device."""
    from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    hp = _hparams(**{'nerf.mlp.net_depth': 4, **setting})
    MipNeRFSystem(hp, device='cpu')
    if key == 'nerf.mlp.net_width':
        with pytest.raises(ValueError, match=key) as err:
            MipNeRFSystem(hp, mesh=create_mesh(4, 4, device='cpu'))
        assert 'parallel.model_axis=4' in str(err.value)
        return
    system = MipNeRFSystem(hp, mesh=create_mesh(4, 4, device='cpu'))
    assert system.mesh.shape == {'data': 1, 'model': 4}
    rays, pixels = _batch(8)
    state, aux = system.train_step(system.init_state(seed=0), rays, pixels)
    assert state['step'] == 1 and torch.isfinite(aux['loss'])
    assert all(torch.isfinite(v).all() for v in state['params'].values())
