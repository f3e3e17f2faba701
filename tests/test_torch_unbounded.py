"""The port's unbounded-360 path against the JAX package on the CPU.

Numpy-seeded inputs go through each JAX function and its counterpart in
mipnerf_pl_tpu_torch: the contraction, its linearisation and the
icosahedral IPE at 1e-5 (their gradients against jax.grad at 2e-4), the
inverse-depth samplers (deterministic, and with the same injected jitter),
a two-level unbounded MipNerf on converted parameters at 1e-4 (the
tolerance of the bounded render) on the plain path, on 'pallas_lean_save'
and with fuse_render (the port's plain versions of the kernels against
JAX's 'xla' backend), its loss with the flipped distloss and its
gradients, and the converter on an unbounded model's parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.models.mipnerf import MipNerf as JMipNerf
from mipnerf_pl_tpu.ops import math as jmath
from mipnerf_pl_tpu.ops import sampling as jsamp
from mipnerf_pl_tpu.rays import Rays as JRays
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.convert import (jax_params_to_torch,
                                          torch_params_to_jax)
from mipnerf_pl_tpu_torch.models.mipnerf import MipNerf
from mipnerf_pl_tpu_torch.ops import math as tmath
from mipnerf_pl_tpu_torch.ops import render as trender
from mipnerf_pl_tpu_torch.ops import sampling as tsamp
from mipnerf_pl_tpu_torch.rays import Rays

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(num_samples=8, deg_view=2, mlp_net_depth=3, mlp_net_width=16,
          mlp_net_width_condition=8, mlp_skip_index=2, unbounded=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _points(rng, shape, full):
    """Means with norms spread over (0.05, 4), on both sides of 1, and
    positive (semi-)definite covariances, diagonal or full."""
    d = rng.normal(size=(*shape, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    means = d * rng.uniform(0.05, 4.0, size=(*shape, 1))
    if full:
        a = rng.normal(size=(*shape, 3, 3)) * 0.1
        covs = a @ np.swapaxes(a, -1, -2)
    else:
        covs = rng.uniform(0.0, 0.02, size=(*shape, 3))
    return means.astype(np.float32), covs.astype(np.float32)


def test_contract_matches_jax():
    means, _ = _points(np.random.default_rng(0), (64,), False)
    means[0] = 0.0                        # the 1e-10 floor
    norms = np.linalg.norm(means, axis=-1)
    assert (norms < 1).any() and (norms > 1).any()
    got = tmath.contract(_t(means))
    _close(got, jmath.contract(means))
    out = torch.linalg.norm(got, dim=-1).numpy()[norms > 1]
    assert np.all((out > 1.0) & (out < 2.0))


@pytest.mark.parametrize('full', [False, True], ids=['diag', 'full'])
def test_track_linearize_matches_jax(full):
    """Values at 1e-5 and the gradient of a seeded linear loss of both
    outputs with respect to the means and covariances at 2e-4."""
    rng = np.random.default_rng(1)
    means, covs = _points(rng, (4, 16), full)
    w_m = rng.normal(size=means.shape).astype(np.float32)
    w_c = rng.normal(size=(*means.shape, 3)).astype(np.float32)
    tm, tc = _t(means).requires_grad_(), _t(covs).requires_grad_()
    gm, gc = tmath.track_linearize(tm, tc)
    jm, jc = jmath.track_linearize(means, covs)
    assert gc.shape == jc.shape == (4, 16, 3, 3)
    _close(gm, jm)
    _close(gc, jc)
    norms = np.linalg.norm(means, axis=-1)
    inside = norms <= 1.0
    assert inside.any() and (~inside).any()
    np.testing.assert_array_equal(gm.detach().numpy()[inside], means[inside])

    def jloss(m, c):
        a, b = jmath.track_linearize(m, c)
        return jnp.sum(a * w_m) + jnp.sum(b * w_c)
    (torch.sum(gm * _t(w_m)) + torch.sum(gc * _t(w_c))).backward()
    jgm, jgc = jax.grad(jloss, argnums=(0, 1))(means, covs)
    _close(tm.grad, jgm, GRAD_TOL)
    _close(tc.grad, jgc, GRAD_TOL)


@pytest.mark.parametrize('full', [False, True], ids=['diag', 'full'])
def test_integrated_pos_enc_360_matches_jax(full):
    rng = np.random.default_rng(2)
    means, covs = _points(rng, (4, 16), full)
    w = rng.normal(size=(4, 16, 42)).astype(np.float32)
    tm, tc = _t(means).requires_grad_(), _t(covs).requires_grad_()
    got = tmath.integrated_pos_enc_360((tm, tc))
    want = jmath.integrated_pos_enc_360((means, covs))
    assert got.shape == want.shape == (4, 16, 42)
    _close(got, want)
    torch.sum(got * _t(w)).backward()
    jgm, jgc = jax.grad(
        lambda m, c: jnp.sum(jmath.integrated_pos_enc_360((m, c)) * w),
        argnums=(0, 1))(means, covs)
    _close(tm.grad, jgm, GRAD_TOL)
    _close(tc.grad, jgc, GRAD_TOL)


def _rays(rng, B, near=0.5, far=100.0):
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.normal(size=(B, 3)) * 0.5).astype(np.float32)
    radii = rng.uniform(0.001, 0.01, size=(B, 1)).astype(np.float32)
    return (o, d, radii, np.full((B, 1), near, np.float32),
            np.full((B, 1), far, np.float32))


@pytest.mark.parametrize('randomized', [False, True])
def test_sample_along_rays_360_matches_jax(randomized):
    """t_inv descends from 1/near to 1/far; with randomized the port takes
    JAX's own jitter draw."""
    rng = np.random.default_rng(3)
    o, d, radii, near, far = _rays(rng, 6)
    key = jax.random.PRNGKey(4)
    want_t, (wm, wc) = jsamp.sample_along_rays_360(
        key, o, d, radii, 8, near, far, randomized, 'cone')
    t_rand = np.asarray(jax.random.uniform(key, (6, 9), dtype=jnp.float32))
    got_t, (gm, gc) = tsamp.sample_along_rays_360(
        _t(o), _t(d), _t(radii), 8, _t(near), _t(far), randomized, 'cone',
        t_rand=_t(t_rand))
    assert gc.shape == (6, 8, 3, 3)
    assert torch.all(got_t[:, 1:] < got_t[:, :-1])
    _close(got_t, want_t)
    _close(gm, wm)
    _close(gc, wc)


@pytest.mark.parametrize('randomized', [False, True])
def test_resample_along_rays_360_matches_jax(randomized):
    """Flipped to ascending before the search, flipped back after, the new
    t_inv detached; with randomized the port takes JAX's jitter (drawn in
    the flipped order)."""
    rng = np.random.default_rng(5)
    B, N = 6, 8
    o, d, radii, near, far = _rays(rng, B)
    t_inv, _ = jsamp.sample_along_rays_360(None, o, d, radii, N, near, far,
                                           False, 'cone')
    t_inv = np.asarray(t_inv)
    w = rng.uniform(size=(B, N)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want_t, (wm, wc) = jsamp.resample_along_rays_360(
        key, o, d, radii, t_inv, w, randomized, 'cone', True, 0.01)
    s = 1.0 / (N + 1)
    eps = float(np.finfo(np.float32).eps)
    u = np.asarray(jax.random.uniform(key, (B, N + 1), dtype=jnp.float32,
                                      maxval=s - eps)) / (s - eps)
    tw = _t(w).requires_grad_()
    got_t, (gm, gc) = tsamp.resample_along_rays_360(
        _t(o), _t(d), _t(radii), _t(t_inv), tw, randomized, 'cone', True,
        0.01, u_rand=_t(u))
    assert not got_t.requires_grad
    assert torch.all(got_t[:, 1:] <= got_t[:, :-1] + 1e-7)
    _close(got_t, want_t)
    _close(gm, wm)
    _close(gc, wc)


def _model_rays(B=16, seed=0):
    o, d, radii, near, far = _rays(np.random.default_rng(seed), B)
    fields = (o, d, d, radii, np.ones((B, 1), np.float32), near, far)
    return JRays(*fields), Rays(*(_t(f) for f in fields))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _converted(jmodel, jrays):
    params = _np_tree(jmodel.init(jax.random.PRNGKey(3), jrays, None, False,
                                  False))
    return params, jax_params_to_torch(params)


def _levels_close(got, want, tol=SLICE_TOL):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in ('rgb', 'distance', 'acc', 'weights', 't_samples'):
            _close(getattr(g, field), getattr(w, field), tol)


def test_converter_takes_an_unbounded_model():
    """trunk_0 and the skip layer read the 42-wide encode: the flax tree
    converts to the port's state dict and back unchanged, and loads into
    MipNerf(unbounded=True)."""
    jrays, _ = _model_rays()
    params, state = _converted(JMipNerf(**KW), jrays)
    assert state['mlp.trunk_0.weight'].shape == (16, 42)
    # The skip after trunk_2 feeds the heads the encode again.
    assert state['mlp.bottleneck.weight'].shape == (16, 16 + 42)
    port = MipNerf(**KW)
    port.load_state_dict(state)
    back = torch_params_to_jax(state)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize('backend,fused', [
    ('xla', {}), ('pallas_lean_save', {}),
    ('pallas_lean_save', {'fuse_render': True}),
    ('pallas_lean', {'fuse_render': True})],
    ids=['xla', 'pallas_lean_save', 'pallas_lean_save-render',
         'pallas_lean-render'])
def test_unbounded_mipnerf_matches_jax(backend, fused):
    """A two-level unbounded MipNerf forward (randomized False, black
    background) on converted parameters against JAX's on the 'xla'
    backend: the lean and render-fused arms run the port's plain versions
    of TPU kernels #3 / #4a and #1 / #2 here.  The kernel encodes and
    ipe_backend stay off, as in JAX."""
    jrays, trays = _model_rays()
    jmodel = JMipNerf(**KW)
    params, state = _converted(jmodel, jrays)
    port = MipNerf(**KW, mlp_backend=backend, fuse_encode=True,
                   pallas_encode=True, ipe_backend='pallas', **fused)
    port.load_state_dict(state)
    assert port.unbounded
    assert not (port._fused_encode or port._fast_encode_math
                or port._pallas_encode)
    assert port._fused_render == bool(fused)
    assert port.mlp.trunk_0.in_features == 42
    want = jmodel.apply(params, jrays, None, False, False)
    with torch.no_grad():
        got = port(trays, False, False)
    _levels_close(got, want)
    for level in got:
        t = level.t_samples
        assert torch.all(t[:, 1:] <= t[:, :-1])           # t_inv descends
        dist = level.distance
        assert torch.all(dist >= 1.0 / t[:, 0] - 1e-4)
        assert torch.all(dist <= 1.0 / t[:, -1] + 1e-4)


def _hparams(**overrides):
    hp = config.default()
    hp.update({'nerf.num_samples': 8, 'nerf.deg_view': 2,
               'nerf.mlp.net_depth': 3, 'nerf.mlp.net_width': 16,
               'nerf.mlp.net_width_condition': 16, 'nerf.mlp.skip_index': 2,
               'train.randomized': False, 'nerf.unbounded': True,
               'train.white_bkgd': False, 'val.white_bkgd': False,
               'loss.disable_multiscale_loss': True})
    hp.update(overrides)
    return hp


def _leaf_close(got, want, rel):
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        w = np.asarray(w)
        np.testing.assert_allclose(flat_g[path], w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('backend,fused', [
    ('xla', {}), ('pallas_lean_save', {}),
    ('pallas_lean_save', {'nerf.fuse_render': True})],
    ids=['xla', 'pallas_lean_save', 'pallas_lean_save-render'])
def test_unbounded_loss_matches_jax(backend, fused):
    """MipNeRFSystem.loss_fn on the unbounded model: the loss, each aux
    value (the fine distloss on the flipped weights and t_inv among them)
    and every parameter gradient against the JAX system's; the port's
    distloss is positive, and the unflipped one is its negation's side."""
    from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    hp = _hparams(**{'nerf.mlp_backend': backend}, **fused)
    jsys = JSystem(hp)
    jstate = jsys.init_state()
    system = MipNeRFSystem(hp, device='cpu')
    assert system.eval_model.mlp_backend == 'xla'     # no render fusion
    state = system.init_state(params=jax_params_to_torch(
        _np_tree(jstate['params'])))
    jrays, trays = _model_rays(seed=1)
    pixels = np.random.default_rng(2).uniform(size=(16, 3)).astype(
        np.float32)
    (jloss, jaux), jgrads = jax.value_and_grad(jsys.loss_fn, has_aux=True)(
        jstate['params'], jrays, pixels, jax.random.PRNGKey(0))
    (loss, aux), grads = system.value_and_grad(state['params'], trays,
                                               _t(pixels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert float(aux['train/distloss_fine']) > 0
    _leaf_close(torch_params_to_jax(grads), _np_tree(jgrads), 1e-4)
    with torch.no_grad():
        fine = system.model(trays, False, False)[-1]
    assert float(trender.distloss(fine.weights, fine.t_samples)) < 0


def test_unbounded_train_step_moves_the_loss():
    """Three randomized train steps on 'pallas_lean_save' from a torch
    generator: finite, the parameters move."""
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    system = MipNeRFSystem(_hparams(**{'train.randomized': True,
                                       'nerf.mlp_backend':
                                           'pallas_lean_save'}),
                           device='cpu')
    state = system.init_state(seed=0)
    start = {k: v.detach().clone() for k, v in state['params'].items()}
    _, trays = _model_rays(seed=3)
    pixels = torch.rand(16, 3, generator=torch.Generator().manual_seed(0))
    for step in range(3):
        state, aux = system.train_step(state, trays, pixels,
                                       system.step_generator(0, step))
        assert np.isfinite(float(aux['loss']))
    assert any(not torch.equal(start[k], v) for k, v in
               state['params'].items())
