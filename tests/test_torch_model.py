"""The PyTorch port's model and render slice against the JAX package (CPU).

Parameters cross with convert.py; inputs are numpy-seeded; randomized=False
on both sides.  MLP forwards compare at rtol = atol = 1e-5.  Whole levels
and frames compare at 1e-4: the level-1 resample draws its fenceposts from
the CDF of level 0's weights, and the f32 rounding differences of that CDF
(a triangular matmul on the JAX lean path, cumsum here) move the resampled
fenceposts, which the deg-4 encode amplifies.
"""

import jax
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.models.mipnerf import MipNerf as JMipNerf
from mipnerf_pl_tpu.models.mlp import MLP as JMLP
from mipnerf_pl_tpu.rays import Rays as JRays
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.convert import (jax_params_to_torch,
                                          torch_params_to_jax)
from mipnerf_pl_tpu_torch.kernels import mlp as tk
from mipnerf_pl_tpu_torch.models.mipnerf import MipNerf
from mipnerf_pl_tpu_torch.models.mlp import MLP
from mipnerf_pl_tpu_torch.rays import Rays

KW = dict(num_samples=8, max_deg_point=4, deg_view=2, mlp_net_depth=3,
          mlp_net_width=16, mlp_net_width_condition=8, mlp_skip_index=2)
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _rays(B=16, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((B, 1), np.float32)
    fields = (rng.normal(size=(B, 3)).astype(np.float32), d, d, ones * 0.01,
              ones, ones * 2.0, ones * 6.0)
    return JRays(*fields), Rays(*(torch.from_numpy(f) for f in fields))


def _tiny_hparams(**overrides):
    hp = config.default()
    hp.update({'nerf.num_samples': 8, 'nerf.max_deg_point': 4,
               'nerf.deg_view': 2, 'nerf.mlp.net_depth': 3,
               'nerf.mlp.net_width': 16, 'nerf.mlp.net_width_condition': 8,
               'nerf.mlp.skip_index': 2})
    hp.update(overrides)
    return hp


def test_param_converter_roundtrip():
    j = JMipNerf(**KW)
    jrays, _ = _rays()
    params = _np_tree(j.init(jax.random.PRNGKey(3), jrays, None, False,
                             True))
    sd = jax_params_to_torch(params)
    port = MipNerf(**KW)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].shape == v.shape, k
    port.load_state_dict(sd)
    back = torch_params_to_jax(port.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_init_matches_flax_scheme():
    """Xavier-uniform weights within the flax bound, zero biases."""
    m = MLP(24, 15, net_depth=3, net_width=16, net_width_condition=8,
            skip_index=2, generator=torch.Generator().manual_seed(0))
    for name, lin in m.named_children():
        w = lin.weight.detach()
        fan_out, fan_in = w.shape
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        assert float(w.abs().max()) <= lim, name
        assert float(w.std()) > 0.3 * lim / np.sqrt(3), name
        assert torch.all(lin.bias == 0), name
    again = MLP(24, 15, net_depth=3, net_width=16, net_width_condition=8,
                skip_index=2, generator=torch.Generator().manual_seed(0))
    for a, b in zip(m.parameters(), again.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize('depth_cond', [0, 1, 2])
@pytest.mark.parametrize('use_view', [True, False])
def test_mlp_plain_matches_flax(depth_cond, use_view):
    cfg = dict(net_depth=4, net_width=16, net_depth_condition=depth_cond,
               net_width_condition=8, skip_index=2)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 5, 24)).astype(np.float32)
    view = rng.normal(size=(6, 15)).astype(np.float32)
    jm = JMLP(**cfg)
    args = (x, view) if use_view else (x,)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), *args))
    want = jm.apply(params, *args)
    tm = MLP(24, 15 if use_view else 0, **cfg)
    tm.load_state_dict({k[len('mlp.'):]: v for k, v in jax_params_to_torch(
        {'params': {'mlp': params['params']}}).items()})
    got = tm(torch.from_numpy(x),
             torch.from_numpy(view) if use_view else None)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def _levels_close(got, want, tol):
    for lg, lw in zip(got, want):
        for name in ('rgb', 'distance', 'acc', 'weights', 't_samples'):
            np.testing.assert_allclose(
                getattr(lg, name).detach().numpy(),
                np.asarray(getattr(lw, name)), err_msg=name, **tol)


@pytest.mark.parametrize('backend', ['xla', 'pallas_lean'])
@pytest.mark.parametrize('white', [True, False])
def test_mipnerf_matches_jax(backend, white):
    """The plain model and the fused lean-render model (the wrappers' plain
    twins on the CPU) against the JAX model with the same params: for
    'pallas_lean' the JAX side runs its Pallas render kernel in interpret
    mode with the in-kernel encode."""
    fuse = backend != 'xla'
    kw = dict(KW, mlp_backend=backend, fuse_render=fuse, fuse_encode=fuse)
    jrays, trays = _rays()
    j = JMipNerf(**kw)
    params = _np_tree(j.init(jax.random.PRNGKey(0), jrays, None, False,
                             white))
    want = j.apply(params, jrays, jax.random.PRNGKey(1), False, white)
    port = MipNerf(**kw)
    assert port._fused_render == fuse
    port.load_state_dict(jax_params_to_torch(params))
    with torch.no_grad():
        got = port(trays, False, white)
    # Level 0 has no resample between the two sides: the forward bar.
    tol0 = dict(rtol=1e-5, atol=1e-5)
    _levels_close(got[:1], want[:1], tol0)
    _levels_close(got, want, SLICE_TOL)


def test_mipnerf_disable_integration_and_cylinder():
    kw = dict(KW, mlp_backend='pallas_lean', fuse_render=True,
              fuse_encode=True, disable_integration=True,
              ray_shape='cylinder')
    jrays, trays = _rays(seed=2)
    j = JMipNerf(**kw)
    params = _np_tree(j.init(jax.random.PRNGKey(0), jrays, None, False,
                             True))
    want = j.apply(params, jrays, None, False, True)
    port = MipNerf(**kw)
    port.load_state_dict(jax_params_to_torch(params))
    with torch.no_grad():
        _levels_close(port(trays, False, True), want, SLICE_TOL)


IPE_CASES = {
    'xla': dict(mlp_backend='xla'),
    'xla-deg16': dict(mlp_backend='xla', max_deg_point=16),
    'xla-no-integration': dict(mlp_backend='xla', max_deg_point=16,
                               disable_integration=True),
    'pallas_lean_save': dict(mlp_backend='pallas_lean_save',
                             fuse_encode=True, pallas_encode=True),
    'pallas-resample': dict(mlp_backend='pallas', stop_resample_grad=False),
}


@pytest.mark.parametrize('case', list(IPE_CASES))
def test_mipnerf_ipe_backend_pallas_matches_jax(case):
    """ipe_backend='pallas': the port's fused_ipe (plain version on the
    CPU) against the JAX model's (Pallas, interpret mode) with the same
    params, up to degree 16 and with disable_integration (zero covariances,
    where the cosine form matters most): level 0's rgb / acc / weights at
    1e-5, the resampled level at the slice bar.  With zero covariances at
    degree 16 nothing damps the top features, which turn the resampled
    fenceposts' f32 rounding (~1e-7, the fenceposts themselves are held at
    1e-5) into 2^15 * 1e-7 ~ 3e-3 rad of phase: that level's outputs are
    held at 5e-3 there."""
    kw = dict(KW, ipe_backend='pallas', **IPE_CASES[case])
    jrays, trays = _rays(seed=3)
    j = JMipNerf(**kw)
    params = _np_tree(j.init(jax.random.PRNGKey(0), jrays, None, False,
                             True))
    want = j.apply(params, jrays, jax.random.PRNGKey(1), False, True)
    port = MipNerf(**kw)
    assert port.ipe_backend == 'pallas'
    assert not (port._fused_encode or port._pallas_encode)
    port.load_state_dict(jax_params_to_torch(params))
    with torch.no_grad():
        got = port(trays, False, True)
    for name in ('rgb', 'acc', 'weights'):
        np.testing.assert_allclose(getattr(got[0], name).numpy(),
                                   np.asarray(getattr(want[0], name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if case != 'xla-no-integration':
        _levels_close(got, want, SLICE_TOL)
        return
    np.testing.assert_allclose(got[1].t_samples.numpy(),
                               np.asarray(want[1].t_samples), rtol=1e-5,
                               atol=1e-5)
    _levels_close(got, want, dict(rtol=5e-3, atol=5e-3))


def test_mipnerf_randomized_runs_with_generator():
    _, trays = _rays()
    port = MipNerf(**KW, density_noise=1.0)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a = port(trays, True, True, generator=g)
        b = port(trays, True, True,
                 generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a[-1].rgb, b[-1].rgb)
    t = a[-1].t_samples
    assert torch.all(t[:, 1:] >= t[:, :-1])
    assert all(torch.isfinite(lv.rgb).all() for lv in a)


@pytest.mark.parametrize('backend', ['pallas_lean', 'pallas_hybrid'])
def test_training_backends_not_ported_raise(backend):
    """The recompute and hybrid backends train; what stays unported raises
    instead of computing something else: the moments input (encode=) with
    'hybrid' (JAX's own refusal, a ValueError), an unknown ipe_backend, and
    unknown options; the unbounded-360 mode builds on 42 encode features.
    On 'pallas_lean' the moments input trains and equals the rows form on
    their encode.  The
    'pallas' backend runs (fused_mlp) and equals the plain forward.
    ipe_backend='pallas' builds and runs on these backends (fused_ipe)."""
    _, trays = _rays()
    port = MipNerf(**KW, mlp_backend=backend)
    assert not port._fused_render
    out = port(trays, False, True)
    assert all(torch.isfinite(lv.rgb).all() for lv in out)
    rng = np.random.default_rng(2)
    moments = torch.tensor(np.concatenate(
        [rng.normal(size=(3, 4, 8)), rng.uniform(0, 1e-3, size=(3, 4, 8))]
    ).astype(np.float32))
    x = tk.ipe_moments_plain(moments.reshape(6, -1), 0, 4).reshape(4, 8, 24)
    view = torch.zeros(4, 15)
    mlp = MLP(24, 15, net_depth=3, net_width=16, net_width_condition=8,
              skip_index=2, backend=backend, fused_activation=(0.001, -1.0))
    if backend == 'pallas_hybrid':
        with pytest.raises(ValueError, match='encode'):
            mlp(moments, view, encode=(0, 4))
    else:
        for a, b in zip(mlp(moments, view, encode=(0, 4)), mlp(x, view)):
            assert a.shape == b.shape == (4, 8, a.shape[-1])
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    pallas = MLP(24, 15, net_depth=3, net_width=16, net_width_condition=8,
                 skip_index=2, backend='pallas')
    plain = MLP(24, 15, net_depth=3, net_width=16, net_width_condition=8,
                skip_index=2, backend='xla')
    plain.load_state_dict(pallas.state_dict())
    for a, b in zip(pallas(x, view), plain(x, view)):
        assert a.shape == b.shape == (4, 8, a.shape[-1])
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # The unbounded-360 mode builds: the 42-wide icosahedral encode feeds
    # trunk_0 (tests/test_torch_unbounded.py holds it against JAX).
    unbounded = MipNerf(**KW, mlp_backend=backend, unbounded=True)
    assert unbounded.mlp.trunk_0.in_features == 42
    assert all(torch.isfinite(lv.rgb).all()
               for lv in unbounded(trays, False, True))
    ipe_model = MipNerf(**KW, mlp_backend=backend, ipe_backend='pallas')
    ipe_model.load_state_dict(port.state_dict())
    assert not (ipe_model._fused_encode or ipe_model._pallas_encode)
    for a, b in zip(ipe_model(trays, False, True), out):
        assert torch.isfinite(a.rgb).all()
        # max_deg_point 4: the two cosine forms agree to f32 rounding.
        torch.testing.assert_close(a.rgb, b.rgb, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match='ipe_backend'):
        MipNerf(**KW, mlp_backend=backend, ipe_backend='triton')
    with pytest.raises(TypeError):
        MipNerf(**KW, no_such_knob=True)
    MipNerf(**KW, channel_major=True, mxu_cumsum=False, pallas_encode=True,
            fast_encode_math=True, lean_input_cast=True)


GATE_CASES = {
    'save_render_encode': dict(mlp_backend='pallas_lean_save',
                               fuse_render=True, fuse_encode=True),
    'recompute_render': dict(mlp_backend='pallas_lean', fuse_render=True),
    'deg17_encode': dict(mlp_backend='pallas_lean_save', fuse_render=True,
                         fuse_encode=True, max_deg_point=17),
    'deg17_pallas_encode': dict(mlp_backend='pallas_lean',
                                pallas_encode=True, max_deg_point=17),
    'pallas_encode': dict(mlp_backend='pallas_lean_save',
                          pallas_encode=True),
    'pallas_encode_under_fused': dict(mlp_backend='pallas_lean',
                                      pallas_encode=True, fuse_encode=True),
    'pallas_encode_no_fast_math': dict(mlp_backend='pallas_lean',
                                       pallas_encode=True,
                                       fast_encode_math=False),
    'hybrid': dict(mlp_backend='pallas_hybrid', fuse_render=True,
                   fuse_encode=True, pallas_encode=True),
    'xla': dict(mlp_backend='xla', fuse_render=True, fuse_encode=True,
                pallas_encode=True),
    'density_noise': dict(mlp_backend='pallas_lean_save', fuse_render=True,
                          fuse_encode=True, density_noise=1.0),
    # No view layer: both select the level, whose kernels then refuse it.
    'no_view_layers': dict(mlp_backend='pallas_lean', fuse_render=True,
                           mlp_net_depth_condition=0),
}


@pytest.mark.parametrize('case', list(GATE_CASES))
def test_encode_and_render_gates_match_jax(case):
    """_fused_render, _fused_encode and _pallas_encode select as the JAX
    model's setup() does: fuse_encode only below max_deg_point 17 on a lean
    pallas backend with the activations fused; pallas_encode only where the
    fast-math encode would run and the fused encode does not; hybrid and
    xla neither.  ipe_backend='pallas' turns both encodes off on both
    sides and leaves the render fusion as it was."""
    kw = dict(KW, **GATE_CASES[case])
    jm = JMipNerf(**kw).bind({})
    port = MipNerf(**kw)
    for gate in ('_fused_render', '_fused_encode', '_pallas_encode'):
        assert getattr(port, gate) == getattr(jm, gate), gate
    jp = JMipNerf(**dict(kw, ipe_backend='pallas')).bind({})
    pp = MipNerf(**dict(kw, ipe_backend='pallas'))
    assert not (jp._fused_encode or jp._pallas_encode)
    for gate in ('_fused_render', '_fused_encode', '_pallas_encode'):
        assert getattr(pp, gate) == getattr(jp, gate), gate


@pytest.mark.parametrize('backend',
                         ['pallas_lean', 'pallas_lean_save', 'pallas_hybrid'])
def test_lean_backends_require_stop_resample_grad(backend):
    """The lean backward gives the encoded inputs no gradient, so with
    resample gradients on it would drop the level-0 -> level-1 term: the
    model refuses the combination, as the JAX model does."""
    with pytest.raises(ValueError, match='stop_resample_grad'):
        MipNerf(**KW, mlp_backend=backend, stop_resample_grad=False)
    MipNerf(**KW, mlp_backend=backend)
    MipNerf(**KW, mlp_backend='xla', stop_resample_grad=False)
    with pytest.raises(ValueError, match='stop_resample_grad'):
        JMipNerf(**KW, mlp_backend=backend, stop_resample_grad=False).init(
            jax.random.PRNGKey(0), _rays()[0], None, False, True)


@pytest.mark.parametrize('noise', [0.0, 1.0], ids=['act', 'raw'])
@pytest.mark.parametrize('backend',
                         ['pallas_lean', 'pallas_lean_save', 'pallas_hybrid'])
def test_lean_save_training_forward_matches_plain(backend, noise):
    """MipNerf on a lean backend trains through the lean kernels' plain
    versions, with the activations fused (raw heads with density_noise,
    which randomized=False leaves unused), and its levels and parameter
    gradients equal the plain model's."""
    _, trays = _rays(seed=1)
    lean = MipNerf(**KW, mlp_backend=backend, density_noise=noise)
    plain = MipNerf(**KW, density_noise=noise)
    plain.load_state_dict(lean.state_dict())
    assert lean._fused_act == (noise == 0.0)
    assert (lean.mlp.fused_activation is None) == (noise > 0.0)
    outs = [m(trays, False, True) for m in (lean, plain)]
    for la, lb in zip(*outs):
        for name in ('rgb', 'distance', 'acc', 'weights', 't_samples'):
            torch.testing.assert_close(getattr(la, name), getattr(lb, name),
                                       rtol=1e-5, atol=1e-6, msg=name)
    for m, o in zip((lean, plain), outs):
        sum(lv.rgb.sum() + lv.weights.sum() for lv in o).backward()
    for (name, a), b in zip(lean.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-6,
                                   msg=name)


def test_eval_backend_selection():
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    hp = _tiny_hparams(**{'nerf.mlp_backend': 'pallas_lean_save'})
    system = MipNeRFSystem(hp, device='cpu')
    assert system.model.mlp_backend == 'pallas_lean_save'
    assert system.eval_model.mlp_backend == 'pallas_lean'
    assert system.eval_model._fused_render
    for change in ({'nerf.density_noise': 1.0}, {'val.mlp_backend': 'xla'},
                   {'nerf.mlp.net_depth_condition': 0}):
        assert MipNeRFSystem(dict(hp, **change), device='cpu'
                             ).eval_model.mlp_backend == 'xla'
    plain = MipNeRFSystem(_tiny_hparams(**{'val.mlp_backend': 'xla'}),
                          device='cpu')
    assert plain.eval_model is plain.model


@pytest.mark.parametrize('backend',
                         ['pallas_lean', 'pallas_lean_save', 'pallas_hybrid'])
def test_eval_model_of_each_lean_backend(backend):
    """val.mlp_backend 'auto' renders through the fused lean-render kernels
    whichever lean backend trains, 'pallas_hybrid' included; the training
    model of 'pallas_hybrid' never takes the render-fused level, even with
    nerf.fuse_render set (its forward has none, as in JAX)."""
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    system = MipNeRFSystem(_tiny_hparams(**{'nerf.mlp_backend': backend,
                                            'nerf.fuse_render': True}),
                           device='cpu')
    assert system.model.mlp_backend == backend and system.model._fused_act
    assert system.model._fused_render == (backend != 'pallas_hybrid')
    assert system.eval_model.mlp_backend == 'pallas_lean'
    assert system.eval_model._fused_render


def _cameras(side):
    from mipnerf_pl_tpu.ops.camera import Camera as JCamera
    from mipnerf_pl_tpu_torch.ops.camera import Camera, pix2cam_from_focal
    from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses
    pose = create_spheric_poses(4.0, n_poses=4)[1].astype(np.float32)
    p2c = pix2cam_from_focal(side, side, 1111.11 * side / 800)
    return (JCamera(pose, p2c, 2.0, 6.0, 1.0),
            Camera(torch.from_numpy(pose), torch.from_numpy(p2c), 2.0, 6.0,
                   1.0))


@pytest.mark.parametrize('val_backend', ['auto', 'xla'])
def test_render_camera_matches_jax(val_backend):
    """The slice: MipNeRFSystem.render_camera on an 8x8 Blender view, the
    port chunked by 24 (3 chunks, the last edge-padded) against the JAX
    system in one 64-ray chunk (rendering does not depend on chunking with
    val.randomized=False)."""
    from mipnerf_pl_tpu.train.system import MipNeRFSystem as JSystem
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    hp = _tiny_hparams(**{'val.mlp_backend': val_backend})
    # The JAX system fetches f16 by default (a TPU host-link trick the port
    # leaves out); compare against its f32 fetch.
    jsys = JSystem(dict(hp, **{'val.fetch_dtype': 'float32'}))
    state = jsys.init_state()
    jcam, cam = _cameras(8)
    want = jsys.render_camera(state['params'], jcam, 8, 8, chunk_size=64)
    sys_ = MipNeRFSystem(hp, device='cpu')
    assert sys_.eval_model._fused_render == (val_backend == 'auto')
    params = jax_params_to_torch(_np_tree(state['params']))
    got = sys_.render_camera(params, cam, 8, 8, chunk_size=24)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **SLICE_TOL)
    fine_only = sys_.render_camera(params, cam, 8, 8, need_coarse=False)
    assert set(fine_only) == {'fine_rgb', 'distance', 'acc'}


def test_render_image_matches_render_camera():
    from mipnerf_pl_tpu_torch.ops.camera import camera_rays
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    system = MipNeRFSystem(_tiny_hparams(), device='cpu')
    params = system.init_params(seed=7)
    _, cam = _cameras(6)
    rays = camera_rays(cam, 6, 6)
    a = system.render_image(params, Rays(*(f.numpy() for f in rays)),
                            chunk_size=10)
    b = system.render_camera(params, cam, 6, 6, chunk_size=36)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)


def test_inert_keys_warn_and_outputs_stay_f32():
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    with pytest.warns(UserWarning, match='val.fetch_dtype'):
        system = MipNeRFSystem(_tiny_hparams(**{'val.fetch_dtype':
                                                'float32'}), device='cpu')
    with pytest.warns(UserWarning, match='nerf.mxu_cumsum'):
        MipNeRFSystem(_tiny_hparams(**{'nerf.mxu_cumsum': False}),
                      device='cpu')
    _, cam = _cameras(4)
    out = system.render_camera(system.init_params(), cam, 4, 4)
    assert all(v.dtype == np.float32 for v in out.values())
