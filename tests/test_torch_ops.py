"""Parity of the PyTorch port's ray ops with the JAX package on the CPU.

The same numpy-seeded inputs go through each JAX function and its
counterpart in mipnerf_pl_tpu_torch; f32 results must agree to
rtol = atol = 1e-5 (both sides use the same formulas in the same order, so
the differences are f32 rounding).  Also: the port imports no JAX-side
module (an AST check: the interpreter here imports jax at startup, so
sys.modules cannot show it), and its default config equals the YAML
schema.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.ops import camera as jcam
from mipnerf_pl_tpu.ops import math as jmath
from mipnerf_pl_tpu.ops import render as jrender
from mipnerf_pl_tpu.ops import sampling as jsamp
from mipnerf_pl_tpu_torch.ops import camera as tcam
from mipnerf_pl_tpu_torch.ops import math as tmath
from mipnerf_pl_tpu_torch.ops import render as trender
from mipnerf_pl_tpu_torch.ops import sampling as tsamp

TOL = dict(rtol=1e-5, atol=1e-5)
PORT = pathlib.Path(__file__).resolve().parent.parent / 'mipnerf_pl_tpu_torch'


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def _rays(rng, B):
    d = rng.normal(size=(B, 3)).astype(np.float32)
    o = rng.normal(size=(B, 3)).astype(np.float32)
    radii = rng.uniform(0.001, 0.01, size=(B, 1)).astype(np.float32)
    near = np.full((B, 1), 2.0, np.float32)
    far = np.full((B, 1), 6.0, np.float32)
    return o, d, radii, near, far


def _fenceposts(rng, B, N):
    t = np.sort(rng.uniform(2.0, 6.0, size=(B, N + 1)), axis=-1)
    return t.astype(np.float32)


@pytest.mark.parametrize('module', sorted(
    str(p.relative_to(PORT.parent)) for p in PORT.rglob('*.py'))
    + ['chip_smoke.py'])
def test_port_imports_no_jax(module):
    banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mipnerf_pl_tpu')
    tree = ast.parse((PORT.parent / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in banned, (module, name)


def test_default_config_matches_yaml_schema():
    from mipnerf_pl_tpu.config import default as jax_default
    from mipnerf_pl_tpu_torch import config
    assert config.default() == jax_default()
    yaml_file = PORT.parent / 'mipnerf_pl_tpu' / 'configs' / 'default.yaml'
    assert config.load(str(yaml_file)) == config.default()


def test_config_merge_from_list():
    from mipnerf_pl_tpu.config import default as jax_default
    from mipnerf_pl_tpu.config import merge_from_list as jax_merge
    from mipnerf_pl_tpu_torch import config
    opts = ['nerf.num_samples', '64', 'val.mlp_backend', 'xla',
            'train.compute_dtype', 'bfloat16', 'data.factor', 'None']
    got, want = config.default(), jax_default()
    config.merge_from_list(got, opts)
    jax_merge(want, opts)
    assert got == want and got['nerf.num_samples'] == 64
    with pytest.raises(ValueError):
        config.merge_from_list(got, ['seed'])


def test_rays_chunks_edge_pad():
    from mipnerf_pl_tpu.rays import Rays as JRays
    from mipnerf_pl_tpu.rays import rays_chunks as j_chunks
    from mipnerf_pl_tpu_torch.rays import Rays, rays_chunks
    rng = np.random.default_rng(3)
    fields = [rng.normal(size=(5, 4, c)).astype(np.float32)
              for c in (3, 3, 3, 1, 1, 1, 1)]
    got, n = rays_chunks(Rays(*map(_t, fields)), 6)
    want, n_j = j_chunks(JRays(*fields), 6)
    assert n == n_j == 20 and len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_camera_rays():
    from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses
    from mipnerf_pl_tpu.utils.vis import create_spheric_poses as j_poses
    poses = create_spheric_poses(4.0, 5)
    np.testing.assert_array_equal(poses, j_poses(4.0, 5))
    h, w = 6, 7
    focal = 1111.11 * w / 800
    p2c = tcam.pix2cam_from_focal(w, h, focal)
    np.testing.assert_array_equal(p2c, jcam.pix2cam_from_focal(w, h, focal))
    np.testing.assert_array_equal(tcam.fold_pixel_center(p2c),
                                  jcam.fold_pixel_center(p2c))
    c2w = poses[2].astype(np.float32)
    got = tcam.camera_rays(tcam.Camera(_t(c2w), _t(p2c), 2.0, 6.0, 1.0), h, w)
    want = jcam.camera_rays(jcam.Camera(c2w, p2c, 2.0, 6.0, 1.0), h, w)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b)


def test_cast_rays_and_cmajor():
    rng = np.random.default_rng(0)
    B, N = 5, 8
    o, d, radii, _, _ = _rays(rng, B)
    t = _fenceposts(rng, B, N)
    for shape in ('cone', 'cylinder'):
        gm, gc = tmath.cast_rays(_t(t), _t(o), _t(d), _t(radii), shape)
        wm, wc = jmath.cast_rays(t, o, d, radii, shape)
        _close(gm, wm)
        _close(gc, wc)
        _close(tmath.cast_rays_cmajor(_t(t), _t(o), _t(d), _t(radii), shape),
               jmath.cast_rays_cmajor(t, o, d, radii, shape))
    gm, gc = tmath.cast_rays(_t(t), _t(o), _t(d), _t(radii), 'cone',
                             diagonal=False)
    wm, wc = jmath.cast_rays(t, o, d, radii, 'cone', diagonal=False)
    _close(gc, wc)
    with pytest.raises(ValueError):
        tmath.cast_rays(_t(t), _t(o), _t(d), _t(radii), 'sphere')


def test_lift_gaussian():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(4, 3)).astype(np.float32)
    tm, tv, rv = (rng.uniform(0.1, 2, size=(4, 6)).astype(np.float32)
                  for _ in range(3))
    for diagonal in (True, False):
        got = tmath.lift_gaussian(_t(d), _t(tm), _t(tv), _t(rv), diagonal)
        want = jmath.lift_gaussian(d, tm, tv, rv, diagonal)
        for a, b in zip(got, want):
            _close(a, b)


@pytest.mark.parametrize('deg', [(0, 4), (0, 16), (2, 6)])
def test_integrated_pos_enc(deg):
    """Exact exp/sin on both sides, on the same f32 sine arguments (every
    ladder product is exact), up to max_deg 16 where they reach 2^15 |x|."""
    rng = np.random.default_rng(2)
    means = rng.normal(size=(7, 5, 3)).astype(np.float32)
    covs = rng.uniform(0, 1e-3, size=(7, 5, 3)).astype(np.float32)
    got = tmath.integrated_pos_enc((_t(means), _t(covs)), *deg)
    want = jmath.integrated_pos_enc((means, covs), *deg)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_pos_enc():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    for ident in (True, False):
        _close(tmath.pos_enc(_t(x), 0, 4, ident),
               jmath.pos_enc(x, 0, 4, ident))


@pytest.mark.parametrize('disparity', [False, True])
def test_sample_along_rays(disparity):
    rng = np.random.default_rng(5)
    o, d, radii, near, far = _rays(rng, 6)
    got_t, (gm, gc) = tsamp.sample_along_rays(
        _t(o), _t(d), _t(radii), 8, _t(near), _t(far), False, disparity,
        'cone')
    want_t, (wm, wc) = jsamp.sample_along_rays(
        None, o, d, radii, 8, near, far, False, disparity, 'cone')
    _close(got_t, want_t)
    _close(gm, wm)
    _close(gc, wc)


def test_sample_along_rays_injected_jitter():
    """randomized: the stratified jitter is injectable; u = 0 gives the
    interval lower bounds, the JAX deterministic grid's own bins."""
    rng = np.random.default_rng(6)
    o, d, radii, near, far = _rays(rng, 4)
    t_rand = rng.uniform(size=(4, 9)).astype(np.float32)
    got, _ = tsamp.sample_along_rays(_t(o), _t(d), _t(radii), 8, _t(near),
                                     _t(far), True, False, 'cone',
                                     t_rand=_t(t_rand))
    base = np.asarray(jsamp.sample_along_rays(
        None, o, d, radii, 8, near, far, False, False, 'cone')[0])
    mids = 0.5 * (base[:, 1:] + base[:, :-1])
    lower = np.concatenate([base[:, :1], mids], -1)
    upper = np.concatenate([mids, base[:, -1:]], -1)
    _close(got, lower + (upper - lower) * t_rand)


def test_sorted_piecewise_constant_pdf():
    rng = np.random.default_rng(7)
    bins = _fenceposts(rng, 6, 10)
    weights = rng.uniform(size=(6, 10)).astype(np.float32)
    weights[0] = 0.0                          # degenerate: eps padding
    weights[1, 3:] = 0.0                      # flat CDF tail: denom guard
    got = tsamp.sorted_piecewise_constant_pdf(_t(bins), _t(weights), 13,
                                              False)
    want = jsamp.sorted_piecewise_constant_pdf(None, bins, weights, 13, False)
    _close(got, want)


def test_sorted_pdf_injected_u_stays_sorted():
    rng = np.random.default_rng(8)
    bins = _fenceposts(rng, 5, 10)
    weights = rng.uniform(size=(5, 10)).astype(np.float32)
    u = rng.uniform(size=(5, 11)).astype(np.float32)
    got = tsamp.sorted_piecewise_constant_pdf(_t(bins), _t(weights), 11,
                                              True, u_rand=_t(u)).numpy()
    assert np.all(np.diff(got, axis=-1) >= 0)
    assert np.all(got >= bins[:, :1]) and np.all(got <= bins[:, -1:])


def test_resample_along_rays():
    rng = np.random.default_rng(9)
    o, d, radii, _, _ = _rays(rng, 5)
    t = _fenceposts(rng, 5, 8)
    w = rng.uniform(size=(5, 8)).astype(np.float32)
    got_t, (gm, gc) = tsamp.resample_along_rays(
        _t(o), _t(d), _t(radii), _t(t), _t(w), False, 'cone', True, 0.01)
    want_t, (wm, wc) = jsamp.resample_along_rays(
        None, o, d, radii, t, w, False, 'cone', True, 0.01)
    _close(got_t, want_t)
    _close(gm, wm)
    _close(gc, wc)
    _close(tsamp._blurpool(_t(w), 0.01), jsamp._blurpool(w, 0.01))


@pytest.mark.parametrize('white_bkgd', [True, False])
def test_volumetric_rendering(white_bkgd):
    rng = np.random.default_rng(10)
    B, N = 6, 8
    rgb = rng.uniform(size=(B, N, 3)).astype(np.float32)
    density = rng.uniform(0, 3, size=(B, N, 1)).astype(np.float32)
    t = _fenceposts(rng, B, N)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    got = trender.volumetric_rendering(_t(rgb), _t(density), _t(t), _t(d),
                                       white_bkgd)
    want = jrender.volumetric_rendering(rgb, density, t, d, white_bkgd)
    for a, b in zip(got, want):
        _close(a, b)


def test_clamp_distance_nan_safe():
    t = torch.tensor([[2.0, 3.0, 4.0]] * 3)
    got = trender.clamp_distance(torch.tensor([float('nan'), 1.0, 9.0]), t)
    want = jnp.clip(jnp.nan_to_num(jnp.asarray([np.nan, 1.0, 9.0]), nan=0.0),
                    2.0, 4.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert jax.devices()[0].platform == 'cpu'
