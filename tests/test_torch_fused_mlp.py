"""The port's classic MLP (`fused_mlp`, modes 'recompute' and 'save')
against the JAX package's `fused_mlp` with its custom VJP (CPU).

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_fused_mlp.py runs them; the port's wrappers take their plain
versions for CPU tensors.  Inputs are numpy-seeded; params are Xavier
kernels and random biases in the flax [in, out] layout.  f32: the forward
at rtol = atol = 1e-5 and dx, dview and every parameter gradient at 2e-4
(the bars of tests/test_fused_mlp.py).  bf16: both sides round every
activation and every cotangent to bf16 at the same places, but sum in
another order, so a rounding may flip one bf16 ulp (2^-8 relative); each
output within 2e-2 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.kernels import mlp as jk
from mipnerf_pl_tpu_torch.kernels import mlp as tk

F, FV = 24, 11

CASES = {
    # the trunk ends on a skip concat: density and bottleneck read [h, x]
    'd3_skip2_v1': dict(net_depth=3, skip_index=2, net_depth_condition=1,
                        nd=1, M=192),
    # trunk_3 after a skip concat, two view layers
    'd4_skip2_v2': dict(net_depth=4, skip_index=2, net_depth_condition=2,
                        nd=1, M=256),
    'nd2': dict(net_depth=3, skip_index=2, net_depth_condition=1, nd=2,
                M=128),
    # not a multiple of the 64-point tile (nor of the JAX row tiles)
    'ragged': dict(net_depth=3, skip_index=2, net_depth_condition=1, nd=1,
                   M=301),
}


def _problem(net_depth, skip_index, net_depth_condition, nd, M, W=16,
             Wv=16, seed=0):
    """x [M, F], view [M, Fv] per point, flat params, head cotangents."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, F)).astype(np.float32)
    view = rng.normal(size=(M, FV)).astype(np.float32)
    dims, d_in = [], F
    for i in range(net_depth):
        dims.append((d_in, W))
        d_in = W + (F if i % skip_index == 0 and i > 0 else 0)
    dims += [(d_in, nd), (d_in, W)]
    d_v = W + FV
    for _ in range(net_depth_condition):
        dims.append((d_v, Wv))
        d_v = Wv
    dims.append((d_v, 3))
    flat = []
    for fi, fo in dims:
        lim = np.sqrt(6.0 / (fi + fo))
        flat.append(rng.uniform(-lim, lim, size=(fi, fo)).astype(np.float32))
        flat.append(rng.normal(0.0, 0.1, size=(1, fo)).astype(np.float32))
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    g_dens = rng.normal(size=(M, nd)).astype(np.float32)
    return x, view, flat, g_rgb, g_dens


def _args(case):
    return (case['net_depth'], case['net_depth_condition'],
            case['skip_index'])


def _jax(prob, case, mode, dtype=jnp.float32):
    """JAX fused_mlp: (rgb, density), (dx, dview, dparams)."""
    x, view, flat, g_rgb, g_dens = prob

    def f(x, view, fl):
        return jk.fused_mlp(x, view, fl, *_args(case), dtype, True, mode)
    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(view),
                       tuple(jnp.asarray(p) for p in flat))
    dx, dview, grads = vjp((jnp.asarray(g_rgb), jnp.asarray(g_dens)))
    return ([np.asarray(o, np.float32) for o in out],
            [np.asarray(dx, np.float32), np.asarray(dview, np.float32)]
            + [np.asarray(g, np.float32) for g in grads])


def _port(prob, case, mode, dtype=torch.float32):
    """The port's fused_mlp through its autograd Function on the CPU."""
    x, view, flat, g_rgb, g_dens = prob
    leaves = [torch.tensor(a, requires_grad=True) for a in [x, view] + flat]
    rgb, dens = tk.fused_mlp(leaves[0], leaves[1], leaves[2:], *_args(case),
                             dtype, mode)
    ((rgb * torch.tensor(g_rgb)).sum()
     + (dens * torch.tensor(g_dens)).sum()).backward()
    return ([rgb.detach().numpy(), dens.detach().numpy()],
            [t.grad.numpy() for t in leaves])


def _assert_all_close(got, want, rtol, atol, names):
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def _grad_names(case):
    names = tk.param_order(case['net_depth'], case['net_depth_condition'])
    return ['dx', 'dview'] + [f'{n}.{k}' for n in names
                              for k in ('kernel', 'bias')]


@pytest.mark.parametrize('mode', ['recompute', 'save'])
@pytest.mark.parametrize('case', list(CASES))
def test_fused_mlp_matches_jax(case, mode):
    """Forward at 1e-5; dx, dview and every parameter gradient at 2e-4."""
    cfg = CASES[case]
    prob = _problem(**cfg)
    (got_out, got_g), (want_out, want_g) = (_port(prob, cfg, mode),
                                            _jax(prob, cfg, mode))
    _assert_all_close(got_out, want_out, 1e-5, 1e-5, ['rgb', 'density'])
    _assert_all_close(got_g, want_g, 2e-4, 2e-4, _grad_names(cfg))


@pytest.mark.parametrize('mode', ['recompute', 'save'])
def test_fused_mlp_without_view_layers(mode):
    """net_depth_condition 0: the rgb head reads concat(bottleneck, view).
    Both port modes against JAX's recompute mode, which computes that
    function (its save mode does not: see the next test)."""
    cfg = dict(CASES['d3_skip2_v1'], net_depth_condition=0)
    prob = _problem(**cfg)
    got_out, got_g = _port(prob, cfg, mode)
    want_out, want_g = _jax(prob, cfg, 'recompute')
    _assert_all_close(got_out, want_out, 1e-5, 1e-5, ['rgb', 'density'])
    _assert_all_close(got_g, want_g, 2e-4, 2e-4, _grad_names(cfg))


@pytest.mark.parametrize('mode', ['recompute', 'save'])
def test_fused_mlp_without_view_layers_at_the_wgmma_widths(mode):
    """The same at a width the f32 wgmma kernels' NV forms take on the
    card (W 64; the trunk ends on a skip concat, so density and bottleneck
    read [h, x]; 301 points, ragged): both port modes' plain versions
    against JAX's recompute mode, forward at 1e-5, dx, dview and every
    parameter gradient at 2e-4."""
    cfg = dict(CASES['ragged'], net_depth_condition=0)
    assert tk.fwd_tf32_route(torch.float32, F, 64, 0, cfg['net_depth'], 0,
                             FV)
    assert tk.chain_tf32_route(torch.float32, 64, 0, cfg['net_depth'], 0,
                               F=F, Fv=FV, skip_index=cfg['skip_index'])
    prob = _problem(**cfg, W=64)
    got_out, got_g = _port(prob, cfg, mode)
    want_out, want_g = _jax(prob, cfg, 'recompute')
    _assert_all_close(got_out, want_out, 1e-5, 1e-5, ['rgb', 'density'])
    _assert_all_close(got_g, want_g, 2e-4, 2e-4, _grad_names(cfg))


def test_jax_save_mode_without_view_layers_fails():
    """The reference fault the port does not copy: JAX's saved backward
    (`_bwd_kernel_saved`) takes the trunk output as the rgb head's input
    when net_depth_condition is 0, where the head reads concat(bottleneck,
    view), and the gradient fails on the shapes."""
    cfg = dict(CASES['d3_skip2_v1'], net_depth_condition=0)
    with pytest.raises(TypeError, match='incompatible shapes'):
        _jax(_problem(**cfg), cfg, 'save')


@pytest.mark.parametrize('mode', ['recompute', 'save'])
def test_fused_mlp_bf16_matches_jax(mode):
    """bf16 on both sides: each output within 2e-2 of its largest entry."""
    cfg = CASES['d4_skip2_v2']
    prob = _problem(**cfg)
    got_out, got_g = _port(prob, cfg, mode, torch.bfloat16)
    want_out, want_g = _jax(prob, cfg, mode, jnp.bfloat16)
    for name, a, b in zip(['rgb', 'density'] + _grad_names(cfg),
                          got_out + got_g, want_out + want_g):
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name


@pytest.mark.parametrize('mode', ['recompute', 'save'])
def test_fused_mlp_bf16_without_view_layers_at_the_wgmma_widths(mode):
    """bf16 with no view layer at a width the bf16 wgmma kernels' NV forms
    take on the card (W 64; the trunk ends on a skip concat; 301 points,
    ragged): both port modes' plain versions against JAX's bf16 recompute
    mode, each output within 2e-2 of its largest entry."""
    cfg = dict(CASES['ragged'], net_depth_condition=0)
    assert tk.fwd_sm90_route(torch.bfloat16, F, 64, 0, cfg['net_depth'], 0,
                             FV)
    assert tk.chain_sm90_route(torch.bfloat16, 64, 0, cfg['net_depth'], 0,
                               F=F, Fv=FV, skip_index=cfg['skip_index'])
    prob = _problem(**cfg, W=64)
    got_out, got_g = _port(prob, cfg, mode, torch.bfloat16)
    want_out, want_g = _jax(prob, cfg, 'recompute', jnp.bfloat16)
    for name, a, b in zip(['rgb', 'density'] + _grad_names(cfg),
                          got_out + got_g, want_out + want_g):
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name


@pytest.mark.parametrize('depth_cond', [0, 1, 2])
def test_plain_backward_is_autograd_of_plain_forward(depth_cond):
    """In f32 the plain backward (JAX's chain rule, each cotangent cast to
    the compute dtype, a no-op here) equals torch.autograd of the plain
    forward: dx, dview and every parameter within 1e-5 of the largest
    entry."""
    cfg = dict(CASES['d4_skip2_v2'], net_depth_condition=depth_cond, nd=2)
    x, view, flat, g_rgb, g_dens = (
        [torch.tensor(p) for p in a] if isinstance(a, list)
        else torch.tensor(a) for a in _problem(**cfg))
    args = _args(cfg) + (torch.float32,)
    leaves = [t.clone().requires_grad_(True) for t in [x, view] + flat]
    rgb, dens = tk.mlp_fwd_plain(leaves[0], leaves[1], leaves[2:], *args)
    want = torch.autograd.grad((rgb * g_rgb).sum() + (dens * g_dens).sum(),
                               leaves)
    saved = tk.mlp_save_fwd_plain(x, view, flat, *args)[2]
    dx, dview, grads = tk.mlp_bwd_saved_plain(g_rgb, g_dens, saved, flat,
                                              *args)
    for name, a, b in zip(_grad_names(cfg), [dx, dview] + grads, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=name)


def test_fused_mlp_modes_and_no_grad():
    """The two modes give the same outputs; without gradients fused_mlp
    runs the plain forward of either mode; an unknown mode raises."""
    cfg = CASES['nd2']
    x, view, flat, _, _ = (
        [torch.tensor(p) for p in a] if isinstance(a, list)
        else torch.tensor(a) for a in _problem(**cfg))
    outs = [tk.fused_mlp(x, view, flat, *_args(cfg), torch.float32, mode)
            for mode in tk.CLASSIC_MODES]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert outs[0][1].shape == (cfg['M'], 2)
    with pytest.raises(ValueError, match='mode'):
        tk.fused_mlp(x, view, flat, *_args(cfg), torch.float32, 'hybrid')
    meta = torch.zeros(4, F, device='meta')
    with pytest.raises(ValueError):
        tk.mlp_fwd(meta, meta, flat, *_args(cfg), torch.float32)


def test_classic_shape_check_takes_a_model_without_view_layers():
    """What the CUDA wrappers check beyond the widths' alignment: only that
    the encode and view widths fit the trunk's.  A model with no view layer
    passes (its kernels are instantiated for it), and the refusal left does
    not speak of a view branch."""
    for depth_cond in (0, 1):
        cfg = dict(CASES['d3_skip2_v1'], net_depth_condition=depth_cond)
        flat = [torch.tensor(p) for p in _problem(**cfg, W=32)[2]]
        tk._classic_shapes_ok('mlp_fwd', flat, cfg['net_depth'])
        narrow = [torch.tensor(p) for p in _problem(**cfg)[2]]
        with pytest.raises(ValueError, match='must not exceed') as err:
            tk._classic_shapes_ok('mlp_fwd', narrow, cfg['net_depth'])
        assert 'view branch' not in str(err.value)
        assert 'net_depth_condition' not in str(err.value)


def test_fused_mlp_mma_route_counts():
    """The route counts of the classic MLP's mma.sync kernels (the shapes
    the wgmma rules refuse) name fused_mlp's wrappers that run each kernel,
    reset_launches zeroes them, and a call on CPU tensors (the plain
    versions, two density heads) launches nothing and moves none."""
    assert set(tk.mma_fwd_routes) == {'mlp_fwd', 'mlp_save_fwd',
                                      'mlp_bwd_recompute'}
    assert set(tk.mma_chain_routes) == set(tk.mma_input_routes) == {
        'mlp_bwd_saved', 'mlp_bwd_recompute'}
    tables = (tk.mma_fwd_routes, tk.mma_chain_routes, tk.mma_input_routes)
    for t in tables:
        for k in t:
            t[k] = 3
    tk.reset_launches()
    assert not any(v for t in tables for v in t.values())
    case = CASES['nd2']
    prob = _problem(**case)
    for mode in tk.CLASSIC_MODES:
        _port(prob, case, mode)
    assert not any(v for t in tables for v in t.values())
    assert not any(tk.launches.values())
