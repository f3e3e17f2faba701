"""The fused lean-render level kernels of the PyTorch port.

On the CPU: the plain PyTorch version (what each wrapper runs for CPU
tensors) against the JAX package's `fused_mlp_lean_render`, which runs its
Pallas kernel in interpret mode here, on the same numpy-seeded moments,
view features, delta/mids planes and parameters.  f32 tolerance 1e-5: the
JAX kernel decodes the IPE with ~1e-6-accurate polynomial exp/sin and sums
the transmittance with a triangular matmul, the port with libm and cumsum.

The training kernels' plain versions (`fused_mlp_lean` through its
autograd Function, modes 'recompute', 'save' and 'hybrid', heads activated
or raw) against the JAX `fused_mlp_lean` with its custom VJP, Pallas in
interpret mode: forward at rtol = atol = 1e-5 and parameter gradients at
2e-4 in f32 (the bars of tests/test_fused_mlp.py), 2e-2 in bf16 (one bf16
ulp is 2^-8 relative; sums run in another order).

The CUDA kernels against their plain versions on the card are in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.kernels import mlp as jk
from mipnerf_pl_tpu_torch.kernels import mlp as tk
from tests.test_torch_cuda import (SMALL, problem as _problem, run_port,
                                   train_problem)



def _run_jax(prob, cfg, dtype=jnp.float32, white=True):
    moments, view, delta, mids, flat = prob
    out = jk.fused_mlp_lean_render(
        jnp.asarray(moments), jnp.asarray(view), jnp.asarray(delta),
        jnp.asarray(mids), tuple(jnp.asarray(p) for p in flat), cfg['N'],
        cfg['net_depth'], cfg['net_depth_condition'], cfg['skip_index'],
        dtype, None, 'recompute', (0.001, -1.0), white, cfg['deg'])
    return [np.asarray(o, np.float32) for o in out]


@pytest.mark.parametrize('white', [True, False])
@pytest.mark.parametrize('cfg', [
    SMALL,
    # skip concat feeding trunk_3 too, two view layers, a view width
    # unlike the trunk's
    dict(SMALL, net_depth=4, net_depth_condition=2, net_width_condition=8),
], ids=['d3', 'd4_v2'])
def test_plain_matches_jax_kernel(cfg, white):
    # 37 rays x 8 samples = 296 points: neither a multiple of the JAX
    # kernel's row tile nor of the CUDA kernel's 64-point tile.
    prob = _problem(37, **cfg)
    got = run_port(prob, cfg, white=white)
    want = _run_jax(prob, cfg, white=white)
    for name, a, b in zip(('comp', 'dist', 'acc', 'weights'), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_plain_matches_jax_kernel_bf16():
    """bf16 compute: activations rounded to bf16 after every layer on both
    sides, but products accumulate in another order, so a rounding can flip
    one bf16 ulp (2^-8 relative); bar 2e-2, inside bench.py's 3e-2."""
    prob = _problem(21, **SMALL)
    got = run_port(prob, SMALL, dtype=torch.bfloat16)
    want = _run_jax(prob, SMALL, dtype=jnp.bfloat16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)


def test_plain_pieces_compose():
    """The three plain pieces are what fused_mlp_lean_render chains."""
    cfg = SMALL
    moments, view, delta, mids, flat = (
        [torch.tensor(p) for p in a] if isinstance(a, list)
        else torch.tensor(a) for a in _problem(5, **cfg))
    iv = 2 * (cfg['net_depth'] + 2)
    vp = tk.view_proj(view, flat[iv], flat[iv + 1], 16, torch.float32)
    assert vp.shape == (5, cfg['net_width_condition'])
    rs = tk.lean_mlp(moments, vp, flat, 8, 3, 1, 2, torch.float32,
                     (0.001, -1.0), cfg['deg'])
    assert rs.shape == (40, 4) and torch.all(rs[:, 3] >= 0)
    perray, w = tk.lean_composite(rs, delta, mids, True)
    comp, dist, acc, w2 = tk.fused_mlp_lean_render(
        moments, view, delta, mids, flat, 8, 3, 1, 2, encode=cfg['deg'])
    torch.testing.assert_close(perray[:, :3], comp)
    torch.testing.assert_close(perray[:, 3:4], acc)
    torch.testing.assert_close(perray[:, 4:5], dist)
    torch.testing.assert_close(w, w2)
    assert torch.all(perray[:, 5:] == 0)


def test_wrapper_rejects_other_devices_and_dtypes():
    moments = torch.zeros(6, 8, device='meta')
    with pytest.raises(ValueError):
        tk.lean_mlp(moments, None, [], 8, 3, 1, 2, torch.float32,
                    (0.001, -1.0), (0, 4))
    with pytest.raises(ValueError):
        tk._dtype_flag(torch.float16)
    with pytest.raises(ValueError):
        tk.fused_mlp_lean_render(None, None, None, None, [], 8, 3, 0, 2)
    with pytest.raises(ValueError):      # the composite takes activations
        tk.fused_mlp_lean_render(None, None, None, None, [], 8, 3, 1, 2,
                                 act=None)
    with pytest.raises(ValueError, match='mode'):
        tk.fused_mlp_lean_render(None, None, None, None, [], 8, 3, 1, 2,
                                 mode='hybrid')
    with pytest.raises(ValueError):
        tk.ipe_moments(moments, 0, 4)


def test_param_order_matches_jax():
    assert tk.param_order(8, 1) == jk.param_order(8, 1)
    assert tk.param_order(3, 2) == jk.param_order(3, 2)


ACT = (0.001, -1.0)


def _lean_args(cfg):
    return (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'])


def _jax_lean(arrays, cfg, dtype, mode, act, encode=None):
    """JAX fused_mlp_lean: outputs and the VJP of the parameters for the
    head cotangents."""
    import jax
    x, view, flat, g_rgb, g_dens = arrays

    def f(fl):
        return jk.fused_mlp_lean(jnp.asarray(x), jnp.asarray(view), fl,
                                 *_lean_args(cfg), dtype, None, mode, act,
                                 False, encode)
    (rgb, dens), vjp = jax.vjp(f, tuple(jnp.asarray(p) for p in flat))
    (grads,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_dens)))
    return [np.asarray(rgb), np.asarray(dens)], [np.asarray(g) for g in grads]


def _port_lean(arrays, cfg, dtype, mode, act, encode=None):
    """The port's fused_mlp_lean through autograd (the plain versions)."""
    x, view, flat, g_rgb, g_dens = (torch.tensor(a) if not isinstance(a, list)
                                    else a for a in arrays)
    params = [torch.tensor(p, requires_grad=True) for p in flat]
    rgb, dens = tk.fused_mlp_lean(x, view, params, *_lean_args(cfg), dtype,
                                  mode, act, encode)
    ((rgb * g_rgb).sum() + (dens * g_dens).sum()).backward()
    return ([rgb.detach().numpy(), dens.detach().numpy()],
            [p.grad.numpy() for p in params])


@pytest.mark.parametrize('act', [ACT, None], ids=['act', 'raw'])
@pytest.mark.parametrize('mode', ['save', 'recompute', 'hybrid'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('cfg', [
    SMALL,
    dict(SMALL, net_depth=4, net_depth_condition=2, net_width=32,
         net_width_condition=16),
], ids=['d3', 'd4_v2'])
def test_lean_save_plain_matches_jax(cfg, dtype, mode, act):
    """Forward and every parameter gradient of every mode, heads activated
    or raw; 37 rays x 8 samples is ragged against both the JAX row tile and
    the CUDA 64-point tile, and d3 ends its trunk on a skip concat (density
    and bottleneck read [h, x]).  In 'hybrid' both sides round each product
    and the raw heads to the compute dtype (JAX's XLA forward)."""
    arrays = train_problem(37, **cfg)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    (j_out, j_grads), (t_out, t_grads) = (
        _jax_lean(arrays, cfg, jdt, mode, act),
        _port_lean(arrays, cfg, tdt, mode, act))
    fwd_tol, grad_tol = (1e-5, 2e-4) if dtype == 'float32' else (2e-2, 2e-2)
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a, b, rtol=fwd_tol, atol=fwd_tol)
    assert len(t_grads) == len(j_grads)
    for i, (a, b) in enumerate(zip(t_grads, j_grads)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, rtol=grad_tol, atol=grad_tol,
                                   err_msg=f'leaf {i}')


@pytest.mark.parametrize('act', [ACT, None], ids=['act', 'raw'])
@pytest.mark.parametrize('mode', ['save', 'recompute', 'hybrid'])
def test_lean_param_grads_plain_is_autograd_of_forward(mode, act):
    """The explicit transcription of _lean_param_grads, fed as each mode
    feeds it, equals torch.autograd through that mode's plain forward (f32:
    the forward's roundings are exact there, so autograd is the true
    gradient)."""
    cfg = dict(SMALL, net_depth=4, net_depth_condition=2)
    x, view, flat, g_rgb, g_dens = (torch.tensor(a) if not isinstance(a, list)
                                    else a
                                    for a in train_problem(13, **cfg))
    params = [torch.tensor(p, requires_grad=True) for p in flat]
    args = _lean_args(cfg) + (torch.float32, act)
    if mode == 'hybrid':
        rgb, dens, res = tk.lean_hybrid_fwd(x, view, params, *args)
        got = tk.lean_param_grads_hybrid_plain(view, g_rgb, g_dens, res,
                                               params, *args)
    elif mode == 'save':
        rgb, dens, saved = tk.lean_mlp_save_plain(x, view, params, *args)
        got = tk.lean_param_grads_plain(view, g_rgb, g_dens, saved, params,
                                        *args)
    else:
        rgb, dens = tk.lean_fwd_plain(x, view, params, *args)
        got = tk.lean_param_grads_recompute_plain(x, view, g_rgb, g_dens,
                                                  params, *args)
    if mode == 'hybrid':
        # lean_hybrid_fwd detaches the params: differentiate the same
        # products through lean_fwd_plain (equal in f32).
        rgb2, dens2 = tk.lean_fwd_plain(x, view, params, *args)
        torch.testing.assert_close(rgb2, rgb, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dens2, dens, rtol=1e-6, atol=1e-6)
        rgb, dens = rgb2, dens2
    want = torch.autograd.grad((rgb * g_rgb).sum() + (dens * g_dens).sum(),
                               params)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_lean_save_saved_stream_layout():
    """The saved stream holds X | hs | bottleneck | ys channel-major, zero
    past M, and the raw heads the activations came from."""
    cfg = SMALL
    x, view, flat, _, _ = (torch.tensor(a) if not isinstance(a, list) else
                           [torch.tensor(p) for p in a]
                           for a in train_problem(5, **cfg))
    rgb, dens, (S, heads) = tk.lean_save_fwd(x, view, flat, *_lean_args(cfg),
                                             torch.float32, ACT)
    M, F = x.shape
    Fp, hs, bott, ys, Cs = tk.saved_rows(F, 16, 16, 3, 1)
    assert S.shape == (Cs, tk._round_up(M, tk.TILE)) == (Fp + 4 * 16 + 16, 64)
    torch.testing.assert_close(S[:F, :M].t(), x)
    assert torch.all(S[:, M:] == 0) and torch.all(S[F:Fp] == 0)
    torch.testing.assert_close(torch.relu(S[hs[0]:hs[0] + 16, :M].t()
                                          @ flat[2] + flat[3]),
                               S[hs[1]:hs[1] + 16, :M].t())
    act_rgb, act_d = tk._activate(heads[:3, :M].t(), heads[3:, :M].t(), ACT)
    torch.testing.assert_close(act_rgb, rgb)
    torch.testing.assert_close(act_d, dens)


_HYBRID_CFGS = [
    SMALL,
    dict(SMALL, net_depth=4, net_depth_condition=2, net_width=32,
         net_width_condition=16),
]


@pytest.mark.parametrize('cfg', _HYBRID_CFGS, ids=['d3', 'd4_v2'])
def test_hybrid_stream_matches_save_plain(cfg):
    """In f32 the hybrid forward's transposed products write the stream
    lean_mlp_save_plain writes: S row for row in the `saved_rows` layout
    (X | hs | bottleneck | ys, zero past M and past F in X) and the raw
    heads, to 1e-5 (the products sum in another order); d3 ends its trunk
    on a skip concat (the density head reads [h, x])."""
    x, view, flat, _, _ = (torch.tensor(a) if not isinstance(a, list) else
                           [torch.tensor(p) for p in a]
                           for a in train_problem(37, **cfg))
    args = _lean_args(cfg) + (torch.float32, ACT)
    rgb, dens, (S, heads) = tk.lean_hybrid_fwd(x, view, flat, *args)
    w_rgb, w_dens, (wS, w_heads) = tk.lean_mlp_save_plain(x, view, flat,
                                                          *args)
    M, F = x.shape
    W, Wv = cfg['net_width'], cfg['net_width_condition']
    Fp, hs, bott, ys, Cs = tk.saved_rows(F, W, Wv, cfg['net_depth'],
                                         cfg['net_depth_condition'])
    assert S.shape == wS.shape == (Cs, tk._round_up(M, tk.TILE))
    assert S.dtype == torch.float32 and heads.shape == w_heads.shape
    for r0, w in [(0, Fp)] + [(r, W) for r in hs] + [(bott, W)] \
            + [(r, Wv) for r in ys]:
        torch.testing.assert_close(S[r0:r0 + w], wS[r0:r0 + w], rtol=1e-5,
                                   atol=1e-5)
    assert torch.all(S[:, M:] == 0) and torch.all(S[F:Fp] == 0)
    assert torch.all(heads[:, M:] == 0)
    torch.testing.assert_close(heads, w_heads, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rgb, w_rgb, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dens, w_dens, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('cfg', _HYBRID_CFGS, ids=['d3', 'd4_v2'])
def test_hybrid_fwd_bf16_matches_jax_xla(cfg):
    """In bf16 the hybrid forward keeps JAX's XLA rounding
    (`_fwd_body_lean_xla`: each product rounded to bf16, the bias added in
    bf16): rgb and density, and the stream's rows against its hs,
    bottleneck and ys, at the bf16 bar 2e-2; the raw heads are the f32
    sums of the bf16 activations JAX's backward recomputes."""
    x, view, flat, _, _ = train_problem(37, **cfg)
    tflat = [torch.tensor(p) for p in flat]
    rgb, dens, (S, heads) = tk.lean_hybrid_fwd(
        torch.tensor(x), torch.tensor(view), tflat, *_lean_args(cfg),
        torch.bfloat16, ACT)
    jcfg = jk._lean_cfg(cfg['net_depth'], cfg['net_depth_condition'],
                        cfg['skip_index'], flat, jnp.bfloat16, cfg['N'], ACT)
    j_rgb, j_dens, j_hs, j_ys, j_bott = jk._fwd_body_lean_xla(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(view),
        [jnp.asarray(p, jnp.bfloat16) for p in flat], jcfg)
    for a, b in ((rgb, j_rgb), (dens, j_dens)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=2e-2, atol=2e-2)
    M, F = x.shape
    W, Wv = cfg['net_width'], cfg['net_width_condition']
    _, hs, bott, ys, _ = tk.saved_rows(F, W, Wv, cfg['net_depth'],
                                       cfg['net_depth_condition'])
    for r0, t in list(zip(hs, j_hs)) + [(bott, j_bott)] + list(zip(ys, j_ys)):
        np.testing.assert_allclose(
            S[r0:r0 + t.shape[1], :M].t().float().numpy(),
            np.asarray(t, np.float32), rtol=2e-2, atol=2e-2)
    # The raw heads: f32 sums over the stream's bf16 rows.
    y = S[ys[-1]:ys[-1] + Wv, :M].t().float()
    k_rgb, b_rgb = (tk._rounded(t, torch.bfloat16) for t in tflat[-2:])
    torch.testing.assert_close(heads[:3, :M].t(), y @ k_rgb + b_rgb,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('depth,dcond,skip', [(3, 1, 2), (4, 2, 2), (8, 1, 4)])
def test_wgrad_problems_cover_every_weight_once(depth, dcond, skip):
    """The CUDA backward's weight-gradient problems write every kernel
    entry exactly once, except view_0's per-ray rows (view^T g_ray), and
    each problem reads its layer's input activations (numbered x | hs |
    bottleneck | ys) over their full width."""
    F, W, Wv, Fv = 24, 32, 16, 15
    shapes, d_in = [], F
    for i in range(depth):
        shapes.append((d_in, W))
        d_in = W + (F if i % skip == 0 and i > 0 else 0)
    shapes += [(d_in, 1), (d_in, W), (W + Fv, Wv)]
    shapes += [(Wv, Wv)] * (dcond - 1) + [(Wv, 3)]
    probs, tiles, dw_off, b_off, view_off = tk.wgrad_problems(
        shapes, depth, dcond, skip)
    widths = [F] + [W] * (depth + 1) + [Wv] * dcond
    iv = depth + 2

    def inputs(layer):
        """The activations layer `layer` reads."""
        if layer == 0:
            return {0}
        if layer <= depth + 1:
            h = min(layer, depth)          # hs[layer - 1], hs[-1] for heads
            return {h} | ({0} if tk._skip_after(h - 1, skip) else set())
        return {1 + depth + layer - iv}    # bottleneck, ys[j - 1]

    covered = np.zeros(dw_off[-1] + shapes[-1][0] * shapes[-1][1], int)
    for a, K, g_row0, n, out, ld in probs:
        assert g_row0 in b_off
        layer = b_off.index(g_row0)
        assert a in inputs(layer) and K == widths[a], (layer, a, K)
        assert (n, ld) == (shapes[layer][1],) * 2
        for r in range(K):
            covered[out + r * ld:out + r * ld + n] += 1
    view_rows = np.arange(view_off, view_off + Fv * Wv)
    assert np.all(covered[view_rows] == 0)
    covered[view_rows] = 1
    assert np.all(covered == 1)
    assert {t[0] for t in tiles} == set(range(len(probs)))
    assert b_off[-1] + 3 == sum(n for _, n in shapes)


@pytest.mark.parametrize('M,N', [(393216, 128), (296, 8), (29 * 24, 24),
                                 (3 * 128, 128)])
def test_wgrad_ranges_align_with_recompute_chunks(M, N):
    """The weight-gradient ranges hold whole 64-point tiles and whole rays,
    every recompute chunk holds whole ranges, and both cover the level: the
    recompute backward then sums the same ranges in the same order as the
    save backward."""
    Mp = tk._round_up(M, tk.TILE)
    for n_tiles in (1, 41, 190):
        mc = tk.wgrad_split(Mp, n_tiles, N, 132)
        assert mc % tk.TILE == 0 and mc % N == 0
        splits = -(-Mp // mc)
        assert (splits - 1) * mc < Mp <= splits * mc
        chunk = tk.recompute_chunk(Mp, mc)
        assert chunk % mc == 0 and chunk >= mc
        assert chunk <= max(mc, tk.RECOMPUTE_POINTS)
        assert -(-M // chunk) * chunk >= M
    # The lego level re-runs in chunks, never as a whole level.
    mc = tk.wgrad_split(393216, 41, 128, 132)
    assert tk.recompute_chunk(393216, mc) < 393216


@pytest.mark.parametrize('M,F,W,Wv,depth,dcond', [
    (393216, 96, 256, 128, 8, 1), (296, 24, 64, 32, 3, 1),
    (29 * 24, 24, 128, 64, 4, 2), (100003, 96, 256, 128, 8, 2)])
def test_saved_stream_fits_the_tensor_maps(M, F, W, Wv, depth, dcond):
    """What the bf16 wgmma kernels' TMA maps assume of the saved stream S
    [Cs, Mp] and the cotangents G [Cg, Mp]: every row is Mp bf16 values, a
    multiple of 16 bytes and of the 64-point slab; every activation starts
    on a row of S, so its first element is 16-byte aligned; the weight
    gradients' ranges are whole 64-point slabs."""
    Mp = tk._round_up(M, tk.TILE)
    assert Mp % 64 == 0 and (Mp * 2) % 16 == 0
    Fp, hs, bott, ys, Cs = tk.saved_rows(F, W, Wv, depth, dcond)
    firsts = [0] + hs + [bott] + ys
    widths = [Fp] + [W] * (depth + 1) + [Wv] * dcond
    assert [a + w for a, w in zip(firsts, widths)][:-1] == firsts[1:]
    assert firsts[-1] + widths[-1] == Cs
    assert all((a * Mp * 2) % 16 == 0 for a in firsts)
    mc = tk.wgrad_split(Mp, 41, 128 if M == 393216 else 8, 132)
    assert mc % 64 == 0


@pytest.mark.parametrize('dtype,F,W,Wv,depth,dcond,want', [
    ('bf16', 96, 256, 128, 8, 1, True),      # lego
    ('f32', 96, 256, 128, 8, 1, False),      # f32 keeps the mma.sync tile
    ('bf16', 24, 128, 64, 4, 2, True),       # the card tests' `wide`
    ('bf16', 24, 128, 64, 3, 1, True),       # `skip_end`
    ('bf16', 24, 64, 32, 3, 1, False),       # `small`: Wv not a multiple of 64
    ('bf16', 96, 256, 128, 8, 0, False),     # no view layer
    ('bf16', 96, 256, 128, 11, 1, False),    # 13 dense layers
    ('bf16', 96, 256, 128, 10, 1, True),     # 12
    ('bf16', 128, 256, 128, 8, 1, True),     # 128 features: two boxes
    ('bf16', 130, 256, 128, 8, 1, False),    # 160 rows once rounded to 32
    ('bf16', 96, 320, 128, 8, 1, False),     # wider than MAX_WIDTH
    ('bf16', 96, 256, 256, 8, 1, True),
    # The classic MLP (fused_mlp: 27 per-point view features; nd density
    # heads): its forward's classic form.
    ('bf16 classic', 96, 256, 128, 8, 1, True),         # lego
    ('f32 classic', 96, 256, 128, 8, 1, False),         # f32 takes lean_fwd_tf32_kernel
    ('bf16 classic', 96, 256, 128, 8, 0, True),         # no view layer: NV
    ('bf16 classic nd2', 96, 256, 128, 8, 1, False),    # two density heads
    ('bf16 classic', 96, 96, 128, 8, 1, False),         # W = 96
    ('bf16 classic', 24, 64, 32, 3, 1, False),          # `small`: Wv = 32
    ('bf16 classic', 24, 64, 64, 3, 2, True),           # `wide_view2`
    ('bf16 classic', 128, 256, 256, 8, 1, True),        # the widest plan
    ('bf16 classic', 96, 256, 128, 11, 1, False),       # 13 dense layers
    # The classic MLP with no view layer (net_depth_condition 0, the NV
    # form: the rgb head reads concat(bottleneck, view); Wv unused).
    ('bf16 classic', 96, 256, 0, 8, 0, True),           # lego, no view layer
    ('bf16 classic', 24, 64, 32, 3, 0, True),           # card shape `no_view`
    ('bf16 classic nd2', 96, 256, 128, 8, 0, False),    # two density heads
    ('f32 classic', 96, 256, 0, 8, 0, False),           # f32: lean_fwd_tf32_kernel
    ('bf16 classic', 96, 160, 0, 8, 0, False),          # W = 160
    ('bf16 classic', 96, 256, 0, 11, 0, True),          # 12 dense layers
    ('bf16 classic', 96, 256, 0, 12, 0, False),         # 13
    ('bf16 classic', 128, 256, 0, 8, 0, True),          # 128 features: two boxes
    ('bf16 classic', 130, 256, 0, 8, 0, False)])        # 160 rows once rounded to 32
def test_fwd_sm90_route(dtype, F, W, Wv, depth, dcond, want):
    """The shape rule of the bf16 wgmma forward (lean_fwd_sm90_kernel),
    against hand counts, for the lean MLP and for fused_mlp's classic form
    (a second K segment of view_0 of the 27 view features, raw heads), also
    with no view layer (its NV form, depth + 1 dense layers); the card
    tests hold the library to the same rule."""
    dt = torch.bfloat16 if dtype.startswith('bf16') else torch.float32
    if 'classic' in dtype:
        nd = 2 if dtype.endswith('nd2') else 1
        assert tk.fwd_sm90_route(dt, F, W, Wv, depth, dcond, 27, nd) is want
        return
    assert tk.fwd_sm90_route(dt, F, W, Wv, depth, dcond) is want


def test_fwd_sm90_smem():
    """Its shared memory by hand: 6 stages x 4 weight boxes of 32 rows x 64
    bf16 columns (16 KB a stage), per warpgroup max(W, Wv) / 64 activation
    boxes of 64 x 64 bf16 (8 KB each) and an encode tile of F rounded up to
    32 rows of 64 bf16 (128 bytes a row), 2 x 4 x 64 f32 heads and 2 x 2 x 3
    x 64 f32 half sums of them, 12 x 256 f32
    biases, 384 + 1,152 f32 head kernels (the rgb head's 256 + 128 rows of
    3: the NV form stages its view rows too), 144 slabs' (layer, row) of 4
    bytes, 13 mbarriers, 1 KB of alignment slack: 213,672 bytes at the lego
    widths (F = 96), of an H100 block's 232,448; every shape the route
    takes fits (221,864 at W 256, F 128)."""
    fixed = 2048 + 3072 + 12288 + 1536 + 4608 + 576 + 104 + 1024
    assert tk.fwd_sm90_smem(256, 128, 96) == (6 * 16384 + 2 * (4 * 8192
                                              + 96 * 128) + fixed) == 213672
    assert tk.fwd_sm90_smem(128, 64, 24) == (6 * 16384
                                             + 2 * (2 * 8192 + 32 * 128)
                                             + fixed)
    assert tk.fwd_sm90_smem(128, 256, 96) == tk.fwd_sm90_smem(256, 128, 96)
    assert tk.fwd_sm90_smem(256, 256, 128) == 221864 <= tk.FW_SMEM_MAX


@pytest.mark.parametrize('dtype,F,W,Wv,depth,dcond,want', [
    ('f32', 96, 256, 128, 8, 1, True),       # lego
    ('bf16', 96, 256, 128, 8, 1, False),     # bf16 takes lean_fwd_sm90_kernel
    ('f32', 24, 128, 64, 4, 2, True),        # the card tests' `wide`
    ('f32', 24, 128, 64, 3, 1, True),        # `skip_end`
    ('f32', 24, 64, 32, 3, 1, False),        # `small`: Wv not a multiple of 64
    ('f32', 96, 192, 64, 8, 3, True),        # 96-column halves
    ('f32', 96, 256, 128, 8, 0, False),      # no view layer
    ('f32', 96, 256, 128, 11, 1, False),     # 13 dense layers
    ('f32', 96, 256, 128, 10, 1, True),      # 12
    ('f32', 128, 256, 256, 8, 1, True),      # 128 features, the widest plan
    ('f32', 130, 256, 128, 8, 1, False),     # 144 rows once rounded to 16
    ('f32', 18, 64, 64, 2, 1, True),         # F not a multiple of 4
    ('f32', 96, 320, 128, 8, 1, False),      # wider than MAX_WIDTH
    # The classic MLP (fused_mlp: 27 per-point view features; nd density
    # heads): its forward's classic form.
    ('f32 classic', 96, 256, 128, 8, 1, True),          # lego
    ('f32 classic', 96, 256, 128, 8, 0, True),          # no view layer: NV
    ('f32 classic nd2', 96, 256, 128, 8, 1, False),     # two density heads
    ('bf16 classic', 96, 256, 128, 8, 1, False),        # bf16: lean_fwd_sm90_kernel
    ('f32 classic', 96, 96, 128, 8, 1, False),          # W = 96
    ('f32 classic', 24, 64, 32, 3, 1, False),           # `small`: Wv = 32
    ('f32 classic', 128, 256, 256, 8, 1, True),         # the widest plan
    ('f32 classic', 96, 256, 128, 11, 1, False),        # 13 dense layers
    # The classic MLP with no view layer (net_depth_condition 0, the NV
    # form: the rgb head reads concat(bottleneck, view); Wv unused).
    ('f32 classic', 96, 256, 0, 8, 0, True),            # lego, no view layer
    ('f32 classic', 24, 64, 32, 3, 0, True),            # card shape `no_view`
    ('f32 classic nd2', 96, 256, 128, 8, 0, False),     # two density heads
    ('bf16 classic', 96, 256, 128, 8, 0, False),        # bf16 NV: lean_fwd_sm90_kernel
    ('f32 classic', 96, 160, 0, 8, 0, False),           # W = 160
    ('f32 classic', 96, 256, 0, 11, 0, True),           # 12 dense layers
    ('f32 classic', 96, 256, 0, 12, 0, False),          # 13
    ('f32 classic', 128, 256, 0, 8, 0, True),           # 128 features: 232,128 B
    ('f32 classic', 130, 256, 0, 8, 0, False)])         # 144 rows once rounded
def test_fwd_tf32_route(dtype, F, W, Wv, depth, dcond, want):
    """The shape rule of the f32 wgmma forward (lean_fwd_tf32_kernel),
    against hand counts, for the lean MLP and for fused_mlp's classic form
    (a second K segment of view_0 of the 27 view features, raw heads), also
    with no view layer (its NV form, depth + 1 dense layers); the card test
    holds the library to the same rule."""
    dt = torch.bfloat16 if dtype.startswith('bf16') else torch.float32
    if 'classic' in dtype:
        nd = 2 if dtype.endswith('nd2') else 1
        assert tk.fwd_tf32_route(dt, F, W, Wv, depth, dcond, 27, nd) is want
        return
    assert tk.fwd_tf32_route(dt, F, W, Wv, depth, dcond) is want


def test_fwd_tf32_smem():
    """Its shared memory by hand: 3 stages of 2 x 256 rows x 16 f32 (32 KB
    a stage), 64 bytes of mbarriers, one f32 activation tile of max(W, Wv)
    rows and one encode tile of F rounded up to 16 rows, both of 72 floats
    a row (288 bytes), 4 x 64 f32 heads and 4 x 3 x 64 f32 quarter sums of
    them, 12 x 256 f32 biases, 384 + 768 f32 head kernels, 288 slabs'
    (layer, column) of 4 bytes, 1 KB of alignment slack: 222,912 bytes at
    the lego widths (F = 96), of an H100 block's 232,448; the widest plan
    the route takes (W = Wv = 256, F = 128) fits with 320 bytes to spare."""
    fixed = 3 * 32768 + 64 + 1024 + 3072 + 12288 + 1536 + 3072 + 1152 + 1024
    assert tk.fwd_tf32_smem(256, 128, 96) == (fixed + 288 * (256 + 96)) \
        == 222912 <= tk.FW_SMEM_MAX
    assert tk.fwd_tf32_smem(128, 64, 24) == fixed + 288 * (128 + 32)
    assert tk.fwd_tf32_smem(128, 256, 96) == tk.fwd_tf32_smem(256, 128, 96)
    assert tk.fwd_tf32_smem(256, 256, 128) == 232128 == tk.FW_SMEM_MAX - 320


@pytest.mark.parametrize('dtype,W,Wv,depth,dcond,want', [
    ('bf16', 256, 128, 8, 1, True),          # lego
    ('f32', 256, 128, 8, 1, True),
    ('bf16', 128, 64, 4, 2, True),           # the card tests' `wide`
    ('f32', 128, 64, 4, 2, True),
    ('bf16', 64, 32, 3, 1, False),           # `small`: Wv not a multiple of 64
    ('f32', 64, 32, 3, 1, False),
    ('f32', 256, 128, 8, 0, False),          # no view layer
    ('bf16', 64, 64, 14, 1, True),           # 16 steps
    ('f32', 64, 64, 14, 1, True),
    ('bf16', 64, 64, 15, 1, False),          # 17
    ('f32', 64, 64, 15, 1, False),
    ('bf16', 256, 128, 9, 1, True),          # G of 2,692 rows
    ('bf16', 256, 128, 10, 1, False),        # 2,948: the bf16 sums outgrow the block
    ('f32', 256, 256, 14, 1, True),
    # The classic backward (fused_mlp: F = 96, 27 view features, skip 4;
    # nd density heads), its chain, dx and dview on lean_chain_tf32_kernel.
    ('f32 classic', 256, 128, 8, 1, True),              # lego
    ('f32 classic', 256, 128, 8, 0, True),              # no view layer: NV
    ('f32 classic nd2', 256, 128, 8, 1, False),         # two density heads
    ('f32 classic nd2', 256, 128, 8, 0, False),         # NV, two density heads
    ('bf16 classic', 256, 128, 8, 0, False),            # bf16 NV: lean_chain_sm90_kernel
    ('f32 classic', 160, 0, 8, 0, False),               # NV, W = 160
    ('bf16 classic', 256, 128, 8, 1, False),            # bf16: lean_chain_sm90_kernel
    ('f32 classic', 96, 128, 8, 1, False),              # W = 96
    ('f32 classic', 64, 32, 3, 1, False),               # `small`: Wv = 32
    ('f32 classic', 256, 256, 11, 1, True),             # 16 weight maps
    ('f32 classic', 256, 256, 12, 1, False),            # 17
    # The same on the bf16 chain's classic form.
    ('bf16 classic on sm90', 256, 128, 8, 1, True),     # lego
    ('f32 classic on sm90', 256, 128, 8, 1, False),     # f32: lean_chain_tf32_kernel
    ('bf16 classic on sm90', 256, 128, 8, 0, True),     # no view layer: NV
    ('bf16 classic nd2 on sm90', 256, 128, 8, 1, False),   # two density heads
    ('bf16 classic on sm90', 96, 128, 8, 1, False),     # W = 96
    ('bf16 classic on sm90', 64, 32, 3, 1, False),      # `small`: Wv = 32
    ('bf16 classic on sm90', 256, 128, 9, 1, True),     # G of 2,692 rows
    ('bf16 classic on sm90', 256, 128, 10, 1, False),   # 2,948: the sums outgrow the block
    ('bf16 classic on sm90', 64, 64, 11, 1, True),      # 16 weight maps
    ('bf16 classic on sm90', 64, 64, 12, 1, False),     # 17
    # Its NV form (no view layer: Wv unused, dview in the rgb step).
    ('bf16 classic on sm90', 256, 0, 8, 0, True),       # lego, G of 2,308 rows
    ('f32 classic on sm90', 256, 0, 8, 0, False),       # f32: lean_chain_tf32_kernel
    ('bf16 classic nd2 on sm90', 256, 0, 8, 0, False),  # two density heads
    ('bf16 classic on sm90', 160, 0, 8, 0, False),      # W = 160
    ('bf16 classic on sm90', 256, 0, 9, 0, True),       # G of 2,564 rows
    ('bf16 classic on sm90', 256, 0, 10, 0, False)])    # 2,820: the sums outgrow the block
def test_chain_route(dtype, W, Wv, depth, dcond, want):
    """The shape rules of the lean chains on wgmma (bf16
    lean_chain_sm90_kernel, f32 lean_chain_tf32_kernel), against hand
    counts; each is a rule on its own dtype only.  The classic cases: the
    f32 chain's classic form, and (`on sm90`) the bf16 chain's (their
    weight maps: every chain layer, the dview step and one dx step a layer
    that reads x)."""
    if 'classic' in dtype:
        dt = torch.bfloat16 if dtype.startswith('bf16') else torch.float32
        nd = 2 if 'nd2' in dtype.split() else 1
        rule = (tk.chain_sm90_route if dtype.endswith('on sm90')
                else tk.chain_tf32_route)
        assert rule(dt, W, Wv, depth, dcond, F=96, Fv=27, nd=nd,
                    skip_index=4) is want
        return
    dt, other = ((torch.bfloat16, torch.float32) if dtype == 'bf16'
                 else (torch.float32, torch.bfloat16))
    own = tk.chain_sm90_route if dtype == 'bf16' else tk.chain_tf32_route
    rival = tk.chain_tf32_route if dtype == 'bf16' else tk.chain_sm90_route
    assert own(dt, W, Wv, depth, dcond) is want
    assert rival(dt, W, Wv, depth, dcond) is False
    assert own(other, W, Wv, depth, dcond) is False


def test_chain_smem():
    """The chains' shared memory by hand.  G's rows at the lego widths:
    8 x 256 trunk + 1 density + 256 bottleneck + 128 view + 3 rgb = 2436.
    bf16: 4 stages x 4 boxes of 32 x 64 bf16 (64 KB), 2 x 4 cotangent boxes
    of 64 x 64 bf16 (64 KB), 4 mask slots of 256 x 16 bytes, 6 activation
    boxes (48 KB), 2 x 4 x 256 + 2 x 4 x 128 f32 partials and head
    cotangents, 2 x 2436 f32 bias sums, 28 mbarriers, 1 KB: 229,632 bytes.
    f32: 3 stages of 32 KB, 64 bytes of mbarriers, a 256-row tile of 72
    floats, 4 x 64 f32 head cotangents, 256 + 768 f32 head kernels, 2436
    f32 bias sums, 1 KB: 187,984 bytes."""
    assert tk.chain_cg(256, 128, 8, 1) == 2436
    assert tk.chain_sm90_smem(2436) == (65536 + 65536 + 16384 + 49152
                                        + 12288 + 8 * 2436 + 224 + 1024) \
        == 229632
    assert tk.chain_tf32_smem(256, 128, 2436) == (98304 + 64 + 288 * 256
                                                  + 4 * (256 + 1024 + 2436)
                                                  + 1024) == 187984
    assert tk.chain_tf32_smem(128, 64, 1000) == (98304 + 64 + 288 * 128
                                                 + 4 * (256 + 1024 + 1000)
                                                 + 1024)


def test_classic_tf32_smem():
    """The classic forms' shared memory by hand at the lego shape (F = 96,
    27 view features): the forward's input tile holds max(96, 32) rows, so
    its plan is the lean one's, 222,912 bytes; the chain adds to the lean
    chain's 187,984 the density kernel's 128 staged x rows and the stash of
    dx's products, 64 points x 96 columns of f32: 213,072 bytes."""
    assert tk.fwd_tf32_smem(256, 128, 96, 27) == tk.fwd_tf32_smem(256, 128,
                                                                   96) \
        == 222912
    assert tk.fwd_tf32_smem(256, 128, 24, 100) == tk.fwd_tf32_smem(
        256, 128, 112)
    assert tk.chain_tf32_smem(256, 128, 2436, 96) == (
        187984 + 4 * (128 + 64 * 96)) == 213072 <= tk.FW_SMEM_MAX


def test_classic_sm90_smem():
    """The bf16 classic forms' shared memory by hand at the lego shape (F =
    96, 27 view features): the forward's encode tile holds max(96, 32)
    rows, so its plan is the lean one's, 213,672 bytes; a view wider than
    the encode widens that tile (F = 24, Fv = 100: 128 rows, as an encode
    of 128); the widest plan the rule takes (W = Wv = 256, F = Fv = 128)
    is the lean one's widest, 221,864.  The chain keeps no stash: its plan
    is the lean chain's, 229,632 bytes at lego, 2,816 under the block's
    232,448.  With no view layer (the NV forms, Wv unused) the forward's
    plan is the same 213,672 bytes, and the chain's G loses the view
    layer's 128 rows (8 x 256 + 1 + 256 + 3 = 2,308), its bias sums 2 x
    128 x 4 bytes: 228,608, 3,840 under the block's."""
    assert tk.fwd_sm90_smem(256, 128, 96, 27) == tk.fwd_sm90_smem(256, 128,
                                                                   96) \
        == 213672
    assert tk.fwd_sm90_smem(256, 128, 24, 100) == tk.fwd_sm90_smem(
        256, 128, 128)
    assert tk.fwd_sm90_smem(256, 256, 128, 128) == 221864 <= tk.FW_SMEM_MAX
    assert tk.chain_sm90_smem(tk.chain_cg(256, 128, 8, 1)) == 229632 \
        == tk.FW_SMEM_MAX - 2816
    assert tk.fwd_sm90_smem(256, 0, 96, 27) == 213672
    assert tk.chain_cg(256, 0, 8, 0) == 2308
    assert tk.chain_sm90_smem(2308) == 229632 - 8 * 128 == 228608 \
        == tk.FW_SMEM_MAX - 3840


def _cuh_consts(name):
    """The `constexpr int` constants of csrc/<name> as a dict."""
    import re
    from pathlib import Path
    src = (Path(tk.__file__).resolve().parent.parent / 'csrc'
           / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r'constexpr int (\w+) = (\d+);', src)}


@pytest.mark.parametrize('case,F,Fv,W,Wv,depth,dcond,nd,skip,want', [
    ('lego', 96, 27, 256, 128, 8, 1, 1, 4, True),
    ('weight maps: 12 + 1 + 4 = 17', 96, 27, 256, 256, 12, 1, 1, 4, False),
    ('weight maps: 11 + 1 + 4 = 16', 96, 27, 256, 256, 11, 1, 1, 4, True),
    ('weight maps: skip 1 at depth 7, 7 + 1 + 8', 96, 27, 64, 64, 7, 1, 1, 1,
     True),
    ('weight maps: skip 1 at depth 8, 8 + 1 + 9', 96, 27, 64, 64, 8, 1, 1, 1,
     False),
    ('encode: 144 columns once rounded', 130, 27, 256, 128, 8, 1, 1, 4,
     False),
    ('encode: 128 columns', 128, 27, 256, 128, 8, 1, 1, 4, True),
    ('view: 160 columns once rounded', 96, 129, 256, 128, 8, 1, 1, 4, False),
    ('two density heads', 96, 27, 256, 128, 8, 1, 2, 4, False),
    ('no view layer', 96, 27, 256, 128, 8, 0, 1, 4, True),
    ('W not a multiple of 64', 96, 27, 160, 128, 8, 1, 1, 4, False),
    # No view layer (the NV form: Wv unused, dview written by the rgb step,
    # so the maps are the trunk's, the bottleneck and one dx step a layer
    # that reads x; the steps are one more, never the limit).
    ('no view layer: weight maps: skip 1 at depth 8, 8 + 8 = 16', 96, 27,
     64, 0, 8, 0, 1, 1, True),
    ('no view layer: weight maps: skip 2 at depth 10, 10 + 5 = 15', 96, 27,
     64, 0, 10, 0, 1, 2, True),
    ('no view layer: weight maps: skip 2 at depth 11, 11 + 6 = 17', 96, 27,
     64, 0, 11, 0, 1, 2, False),
    ('no view layer: the dx stash, 128 columns', 128, 27, 256, 0, 8, 0, 1,
     4, True),
    ('no view layer: the dx stash, 160 columns once rounded', 130, 27, 256,
     0, 8, 0, 1, 4, False),
    ('no view layer: view 160 columns once rounded', 96, 129, 256, 0, 8, 0,
     1, 4, False),
    ('no view layer: two density heads', 96, 27, 256, 0, 8, 0, 2, 4, False),
    ('no view layer: W 160', 96, 27, 160, 0, 8, 0, 1, 4, False),
    ('no view layer: W 64, the card shape', 24, 27, 64, 0, 3, 0, 1, 2,
     True)])
def test_classic_chain_plan_mirror(case, F, Fv, W, Wv, depth, dcond, nd,
                                   skip, want):
    """The Python mirror of the classic chain's plan refuses what the C++
    plan (csrc/lean_chain_tf32.cuh chain_tf32_route, chain_tf32_plan)
    refuses: its limits are the C++ constants (read from the source), and
    each case sits on one of them, counted by hand (the input steps: dview,
    with a view layer, and one a layer that reads x).  The card test holds
    the library to the same answers
    (test_cuda_classic_tf32_route_matches_the_library)."""
    chain = _cuh_consts('lean_chain_tf32.cuh')
    fwd = _cuh_consts('lean_fwd_tf32.cuh')
    assert (tk.CT_MAX_MAPS, tk.CT_STEPS) == (chain['CT_MAX_MAPS'],
                                             chain['CT_STEPS'])
    assert (tk.FT_MAX_X, tk.FT_KS, tk.FT_STAGES, tk.FT_LD) == (
        fwd['FT_MAX_X'], fwd['FT_KS'], fwd['FT_STAGES'], fwd['FT_TM'] + 8)
    if 'weight maps' in case:
        ix = tk._classic_dx_steps(depth, skip) + (1 if dcond else 0)
        assert (depth + dcond + ix <= tk.CT_MAX_MAPS) is want
        assert depth + dcond + 1 + ix <= tk.CT_STEPS
    if not dcond and 'stash' in case:
        # The stash of a 64-point tile's dx products, N = F rounded up to
        # 16 and to 32 columns of f32: 24 KB at 96 features, 32 KB at 128;
        # the plan fits the block at any depth the maps allow.
        ix_n = -(-(-(-F // 16) * 16) // 32) * 32
        assert (ix_n <= tk.FT_MAX_X) is want
        cg = tk.chain_cg(W, 0, 12, 0)
        assert tk.chain_tf32_smem(W, 0, cg, 128) <= tk.FW_SMEM_MAX
    got = tk.chain_tf32_route(torch.float32, W, Wv, depth, dcond, F=F,
                              Fv=Fv, nd=nd, skip_index=skip)
    assert got is want, case
    assert tk.chain_tf32_route(torch.bfloat16, W, Wv, depth, dcond, F=F,
                               Fv=Fv, nd=nd, skip_index=skip) is False


@pytest.mark.parametrize('case,F,Fv,W,Wv,depth,dcond,nd,skip,want', [
    ('lego', 96, 27, 256, 128, 8, 1, 1, 4, (True, True)),
    ('weight maps: 11 + 1 + 4 = 16 (13 dense layers)', 96, 27, 64, 64, 11,
     1, 1, 4, (False, True)),
    ('weight maps: 12 + 1 + 4 = 17', 96, 27, 64, 64, 12, 1, 1, 4,
     (False, False)),
    ('weight maps: skip 1 at depth 7, 7 + 1 + 8', 96, 27, 64, 64, 7, 1, 1, 1,
     (True, True)),
    ('weight maps: skip 1 at depth 8, 8 + 1 + 9', 96, 27, 64, 64, 8, 1, 1, 1,
     (True, False)),
    ('steps: 9 + 1 + 3 + 1 = 14, G of 2,692 rows', 96, 27, 256, 128, 9, 1, 1,
     4, (True, True)),
    ('bias sums: G of 2,948 rows', 96, 27, 256, 128, 10, 1, 1, 4,
     (True, False)),
    ('encode: 128 features, two boxes', 128, 27, 256, 128, 8, 1, 1, 4,
     (True, True)),
    ('encode: 160 rows once rounded to 32', 130, 27, 256, 128, 8, 1, 1, 4,
     (False, True)),
    ('encode: 320 columns once rounded to 64', 257, 27, 256, 128, 8, 1, 1, 4,
     (False, False)),
    ('view: 128 features', 96, 128, 256, 128, 8, 1, 1, 4, (True, True)),
    ('view: 160 rows once rounded to 32', 96, 129, 256, 128, 8, 1, 1, 4,
     (False, True)),
    ('view: 320 columns once rounded to 64', 96, 257, 256, 128, 8, 1, 1, 4,
     (False, False)),
    ('two density heads', 96, 27, 256, 128, 8, 1, 2, 4, (False, False)),
    ('no view layer', 96, 27, 256, 128, 8, 0, 1, 4, (True, True)),
    ('W not a multiple of 64', 96, 27, 160, 128, 8, 1, 1, 4, (False, False)),
    ('Wv 32', 24, 27, 64, 32, 3, 1, 1, 2, (False, False)),
    # No view layer (the NV forms: Wv unused; the forward's dense layers
    # are depth + 1, the chain's weight maps the trunk's, the bottleneck
    # and one dx step a layer that reads x, its steps one more).
    ('no view layer: two density heads', 96, 27, 256, 0, 8, 0, 2, 4,
     (False, False)),
    ('no view layer: W 160', 96, 27, 160, 0, 8, 0, 1, 4, (False, False)),
    ('no view layer: dense layers: 11 + 1 = 12', 96, 27, 64, 0, 11, 0, 1, 4,
     (True, True)),
    ('no view layer: dense layers: 12 + 1 = 13', 96, 27, 64, 0, 12, 0, 1, 4,
     (False, True)),
    ('no view layer: encode: 128 features, two boxes', 128, 27, 256, 0, 8,
     0, 1, 4, (True, True)),
    ('no view layer: encode: 160 rows once rounded to 32', 130, 27, 256, 0,
     8, 0, 1, 4, (False, True)),
    ('no view layer: view: 128 features', 96, 128, 256, 0, 8, 0, 1, 4,
     (True, True)),
    ('no view layer: view: 160 rows once rounded to 32', 96, 129, 256, 0, 8,
     0, 1, 4, (False, True)),
    ('no view layer: weight maps: skip 1 at depth 8, 8 + 8 = 16', 96, 27,
     64, 0, 8, 0, 1, 1, (True, True)),
    ('no view layer: weight maps: skip 1 at depth 9, 9 + 9 = 18', 96, 27,
     64, 0, 9, 0, 1, 1, (True, False)),
    ('no view layer: bias sums: G of 2,564 rows', 96, 27, 256, 0, 9, 0, 1,
     4, (True, True)),
    ('no view layer: bias sums: G of 2,820 rows', 96, 27, 256, 0, 10, 0, 1,
     4, (True, False)),
    ('no view layer: W 64, the card shape', 24, 27, 64, 0, 3, 0, 1, 2,
     (True, True))])
def test_classic_sm90_plan_mirror(case, F, Fv, W, Wv, depth, dcond, nd, skip,
                                  want):
    """The Python mirrors of the bf16 classic plans refuse what the C++
    plans (csrc/lean_fwd_sm90.cuh fwd_sm90_route / fwd_sm90_plan,
    csrc/lean_chain_sm90.cuh chain_sm90_route / chain_sm90_plan) refuse:
    their limits are the C++ constants (read from the source), and each
    case sits on one of them, counted by hand (the forward's dense layers
    and its 128-row encode tile; the chain's weight maps, steps, 64-column
    input steps and bias sums).  want = (forward, chain).  The card test
    holds the library to the same answers
    (test_cuda_classic_sm90_route_matches_the_library)."""
    chain = _cuh_consts('lean_chain_sm90.cuh')
    fwd = _cuh_consts('lean_fwd_sm90.cuh')
    assert (tk.CH_MAX_STEPS, tk.CH_STEPS, tk.CH_STAGES, tk.CH_MASKS,
            tk.CH_RAW) == (chain['CH_MAX_STEPS'], chain['CH_STEPS'],
                           chain['CH_STAGES'], chain['CH_MASKS'],
                           chain['CH_RAW'])
    assert (tk.FW_STAGES, tk.FW_KS, tk.FW_XBOXES, tk.FW_MAX_LAYERS) == (
        fwd['FW_STAGES'], fwd['FW_KS'], fwd['FW_XBOXES'],
        fwd['FW_MAX_LAYERS'])
    if 'weight maps' in case:
        ix = tk._classic_dx_steps(depth, skip) + (1 if dcond else 0)
        assert (depth + dcond + ix <= tk.CH_MAX_STEPS) is want[1]
        assert depth + dcond + 1 + ix <= tk.CH_STEPS
    bf16 = torch.bfloat16
    got = (tk.fwd_sm90_route(bf16, F, W, Wv, depth, dcond, Fv, nd),
           tk.chain_sm90_route(bf16, W, Wv, depth, dcond, F=F, Fv=Fv, nd=nd,
                               skip_index=skip))
    assert got == want, case
    assert not tk.fwd_sm90_route(torch.float32, F, W, Wv, depth, dcond, Fv,
                                 nd)
    assert not tk.chain_sm90_route(torch.float32, W, Wv, depth, dcond, F=F,
                                   Fv=Fv, nd=nd, skip_index=skip)


# The backward entries whose weight gradients may take wgrad_tf32_kernel.
_WGRAD_ENTRIES = ('lean_param_grads', 'lean_param_grads_recompute',
                  'lean_param_grads_hybrid', 'mlp_bwd_saved',
                  'mlp_bwd_recompute', 'tp_pair_bwd')


@pytest.mark.parametrize('entry', _WGRAD_ENTRIES)
@pytest.mark.parametrize('dtype,Mp,MC,want', [
    ('f32', 393216, 15232, True),       # the lego level, its range
    ('f32', 320, 128, True),            # the card tests' `small`
    ('f32', 64, 64, True),
    ('f32', 393216, 15248, False),      # MC not a multiple of the slab
    ('f32', 400, 128, False),           # Mp not a multiple of the slab
    ('f32', 0, 64, False),
    ('bf16', 393216, 15232, False)])    # bf16 has wgrad_sm90_kernel
def test_wgrad_tf32_route(entry, dtype, Mp, MC, want):
    """The shape rule of the f32 weight gradients on wgmma
    (wgrad_tf32_kernel): f32, Mp and MC multiples of the 32-point slab.
    Every entry reads a channel-major stream (hybrid's forward writes one
    since its products land in the rows of S), so none is refused by its
    layout; each is counted in both dtypes' tables."""
    dt = torch.float32 if dtype == 'f32' else torch.bfloat16
    assert entry in tk.wgrad_tf32_routes and entry in tk.wgrad_sm90_routes
    assert tk.WT_KP == 32
    assert tk.wgrad_tf32_route(dt, Mp, MC) is want


def _trunc13(t):
    """f32 t with its low 13 mantissa bits cleared: the tf32 the tensor
    core reads from an f32 word."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _toward_zero(x64):
    """f64 -> the f32 next to it toward zero (the tensor core's rounding of
    its accumulators)."""
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _tc_wgrad(a, g, period):
    """a [K, P] @ g [N, P]^T as wgrad_tf32_kernel sums one range: 3xTF32
    (the register operand, the cotangent rows g, split to nearest, hi and
    lo rounded by cvt.rna.tf32; the shared operand, the activation rows a,
    read as the tensor core reads it, hi = the word truncated, lo = a - hi
    truncated), each k8 step's three products exact, added into the
    accumulators rounded toward zero; every `period` points (None: never)
    the accumulators restart into f32 sums rounded to nearest."""
    gh, gl = tk.tf32_split(g)
    gl = tk.tf32_split(gl)[0]
    ah = _trunc13(a)
    al = _trunc13(a - ah)
    terms = [(x.double(), y.double()) for x, y in ((ah, gl), (al, gh),
                                                   (ah, gh))]
    tot = torch.zeros(a.shape[0], g.shape[0])
    acc = torch.zeros(a.shape[0], g.shape[0], dtype=torch.float64)
    for k0 in range(0, a.shape[1], 8):
        if period and k0 and k0 % period == 0:
            tot = tot + acc.float()
            acc.zero_()
        for x, y in terms:
            acc = _toward_zero(acc + x[:, k0:k0 + 8] @ y[:, k0:k0 + 8].T)
            acc = acc.double()
    return tot + acc.float()


def test_wgrad_tf32_numerics():
    """Why wgrad_tf32_kernel restarts its accumulators every 128 points: on
    one lego-sized range (15,232 points of seeded ReLU activations and
    cotangents), 3xTF32 with the tensor core's round-toward-zero
    accumulation drifts to ~1.4e-4 relative (||a - b|| / ||b|| against the
    f64 sum), past the card's 1e-4 bar on the f32 parameter gradients;
    restarted every 128 points into round-to-nearest f32 sums it stays at
    ~1.2e-6, within 5x of a plain f32 sum."""
    rng = np.random.default_rng(0)
    P = 15232
    a = torch.tensor(np.maximum(rng.normal(size=(64, P)), 0.0)
                     .astype(np.float32))
    g = torch.tensor((rng.normal(size=(64, P)) * 1e-3).astype(np.float32))
    exact = a.double() @ g.double().T

    def err(got):
        return float(torch.linalg.norm(got.double() - exact)
                     / torch.linalg.norm(exact))
    restarted = err(_tc_wgrad(a, g, 128))
    never = err(_tc_wgrad(a, g, None))
    f32 = err(a @ g.T)
    assert restarted <= 2e-6
    assert restarted <= 5 * f32
    assert never >= 1e-4 >= 50 * restarted


def test_tf32_split():
    """The weight split of the f32 wgmma kernels: hi has its low 13
    mantissa bits zero (a tf32 value), hi + lo == w exactly in f32, and
    |lo| <= 2^-11 |w| (hi rounds to nearest), over magnitudes from 1e-30 to
    1e30, both signs, zeros and the halfway cases."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    half = np.float32(1.0) + np.float32(2.0 ** -11)   # halfway between tf32s
    w = np.concatenate([w, [0.0, -0.0, half, -half, 1.0, -1.0]]).astype(
        np.float32)
    wt = torch.tensor(w)
    hi, lo = tk.tf32_split(wt)
    assert hi.dtype == lo.dtype == torch.float32
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi + lo, wt)
    assert bool((lo.abs() <= wt.abs() * 2.0 ** -11).all())
    # ties round away from zero, as cvt.rna.tf32 does
    assert float(hi[-4]) == 1.0 + 2.0 ** -10
    assert float(hi[-3]) == -float(hi[-4])
    # the forward's B operands: [hi; lo] of the transposed kernels, the
    # encode columns padded to the slab with zeros
    shapes = [(18, 64), (1, 64), (64, 64), (1, 64), (64, 64), (1, 64),
              (82, 1), (1, 1), (82, 64), (1, 64), (64 + 5, 64), (1, 64),
              (64, 3), (1, 3)]
    flat = [torch.tensor(rng.standard_normal(sh).astype(np.float32))
            for sh in shapes]
    wt_all = tk.tf32_fwd_weights(flat, 3, 1, 2)
    assert [None if t is None else tuple(t.shape) for t in wt_all] == [
        (128, 32), (128, 64), (128, 64), None, (128, 96), (128, 64), None]
    bott = wt_all[4][:64] + wt_all[4][64:]     # [h, x] read by the bottleneck
    assert torch.equal(bott[:, :82], flat[8].t())
    assert torch.equal(bott[:, 82:], torch.zeros(64, 14))
    assert torch.equal(wt_all[5][:64] + wt_all[5][64:], flat[10][:64].t())
    assert torch.equal(wt_all[0][:64, 18:], torch.zeros(64, 14))


def test_tf32_weights_without_view_layers():
    """The f32 wgmma kernels' operands for a classic MLP with no view layer
    (net_depth_condition 0, the NV form; trunk 3 x 64 ending on a skip
    concat, 18 encode and 27 view features): tf32_fwd_weights splits the
    trunk and the bottleneck as the view-layer form does and has nothing
    for the two heads; the rgb head after the bottleneck is [W + Fv, 3],
    its 64 bottleneck rows then the 27 view rows, which the forward stages
    from the kernels as stored (as the density head).  tf32_input_weights
    has the x rows of each layer that reads x (trunk_0, the bottleneck) and
    no view rows: the chain's rgb step writes dview from the rgb head."""
    rng = np.random.default_rng(1)
    shapes = [(18, 64), (1, 64), (64, 64), (1, 64), (64, 64), (1, 64),
              (82, 1), (1, 1), (82, 64), (1, 64), (64 + 27, 3), (1, 3)]
    flat = [torch.tensor(rng.standard_normal(sh).astype(np.float32))
            for sh in shapes]
    assert tk._mlp_dims(flat, 3)[:3] == (18, 64, 27)
    wt = tk.tf32_fwd_weights(flat, 3, 0, 2, 27)
    assert [None if t is None else tuple(t.shape) for t in wt] == [
        (128, 32), (128, 64), (128, 64), None, (128, 96), None]
    bott = wt[4][:64] + wt[4][64:]
    assert torch.equal(bott[:, :82], flat[8].t())
    assert torch.equal(bott[:, 82:], torch.zeros(64, 14))
    for i in (0, 1, 2, 4):              # hi is tf32, lo the rest exactly
        assert int((wt[i][:64].view(torch.int32) & 0x1FFF).abs().max()) == 0
    ws = tk._kernel_params(flat, torch.float32)[0]
    assert tuple(ws[5].shape) == (64 + 27, 3)
    assert torch.equal(ws[5][:64], flat[10][:64])     # kr_s: the first W rows
    assert torch.equal(ws[5][64:], flat[10][64:])     # read where used
    on, _ = tk._tf32_ptrs(flat, 3, 0, 2, torch.float32, classic=True)
    assert on is not None and all(
        (a is None) == (b is None) and (a is None or torch.equal(a, b))
        for a, b in zip(on, wt))
    assert tk._tf32_ptrs(flat, 3, 0, 2, torch.bfloat16,
                         classic=True) == (None, None)
    xs, vs = tk.tf32_input_weights(flat, 3, 0, 2)
    assert vs is None
    assert [None if t is None else tuple(t.shape) for t in xs] == [
        (64, 64), None, None, None, (64, 64), None]
    assert torch.equal((xs[4][:32] + xs[4][32:])[:18], flat[8][64:])
    assert torch.equal(xs[0][:32] + xs[0][32:],
                       torch.cat([flat[0], torch.zeros(14, 64)]))


def test_lean_training_form_rejects():
    """What the training form still refuses: encode with 'hybrid' (JAX's
    refusal), an encode whose width is not trunk_0's, no view branch, an
    unknown mode, and a device that is neither the CPU nor CUDA."""
    x = torch.zeros(8, 24)
    with pytest.raises(ValueError, match='hybrid'):
        tk.fused_mlp_lean(x, None, [], 8, 3, 1, 2, mode='hybrid',
                          encode=(0, 4))
    with pytest.raises(ValueError, match='trunk_0'):
        tk._input_points('lean_fwd', torch.zeros(6, 8), (0, 3), 24)
    with pytest.raises(ValueError):
        tk.fused_mlp_lean(x, None, [], 8, 3, 0, 2, act=ACT)
    with pytest.raises(ValueError, match='mode'):
        tk.fused_mlp_lean(x, None, [], 8, 3, 1, 2, mode='pallas')
    meta = torch.zeros(8, 24, device='meta')
    with pytest.raises(ValueError):
        tk.lean_save_fwd(meta, None, [], 8, 3, 1, 2, torch.float32, ACT)
    with pytest.raises(ValueError):
        tk.lean_fwd(meta, None, [], 8, 3, 1, 2, torch.float32, None)
    with pytest.raises(ValueError):
        tk.lean_param_grads_recompute(meta, None, None, None, [], 8, 3, 1, 2,
                                      torch.float32, ACT)
    with pytest.raises(ValueError):
        tk.lean_param_grads_hybrid(meta, None, None, None, [], 8, 3, 1, 2,
                                   torch.float32, ACT)
    with pytest.raises(ValueError):
        tk.lean_composite_bwd(meta, None, None, None, None, True)


# ---------------------------------------------------------------------------
# The moments input of the training kernels, the render-fused level's
# backward and the standalone moments encode.  JAX decodes the IPE with
# ~1e-6-accurate polynomial exp/sin, the port with libm: outputs compare at
# rtol = atol = 1e-5 and parameter gradients at 2e-4, JAX's own bars for
# that comparison (tests/test_fused_mlp.py:750-754).
# ---------------------------------------------------------------------------

def _moments_train_problem(R, cfg, seed=0):
    """problem()'s moments, view and params with numpy-seeded head
    cotangents, in train_problem's order."""
    moments, view, _, _, flat = _problem(R, **cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    M = R * cfg['N']
    return (moments, view, flat,
            rng.normal(size=(M, 3)).astype(np.float32),
            rng.normal(size=(M, 1)).astype(np.float32))


def _close(got, want, tol, what):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f'{what} {i}')


@pytest.mark.parametrize('act', [ACT, None], ids=['act', 'raw'])
@pytest.mark.parametrize('mode', ['save', 'recompute'])
@pytest.mark.parametrize('R', [37, 8], ids=['ragged', 'whole_tiles'])
def test_lean_encode_plain_matches_jax(R, mode, act):
    """fused_mlp_lean(encode=) on the [6, M] moments: forward and every
    parameter gradient against JAX's, whose kernels decode the IPE per
    tile.  37 rays x 8 samples is ragged against both row tiles; 8 x 8 is
    one whole 64-point CUDA tile."""
    cfg = SMALL
    arrays = _moments_train_problem(R, cfg)
    j_out, j_grads = _jax_lean(arrays, cfg, jnp.float32, mode, act,
                               cfg['deg'])
    t_out, t_grads = _port_lean(arrays, cfg, torch.float32, mode, act,
                                cfg['deg'])
    _close(t_out, j_out, 1e-5, 'output')
    _close(t_grads, j_grads, 2e-4, 'leaf')


def _render_cotangents(R, N, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((R, 3), (R, 1), (R, 1), (R, N))]


@pytest.mark.parametrize('white', [True, False])
@pytest.mark.parametrize('form', ['rows', 'moments'])
@pytest.mark.parametrize('mode', ['save', 'recompute'])
def test_render_level_grads_match_jax(mode, form, white):
    """Training through the render-fused level: its four outputs and the
    gradient of every parameter for cotangents on comp_rgb, dist, acc and
    the weights, against JAX's custom VJP (TPU kernel #2 in interpret
    mode), on encode rows or on the moments."""
    import jax
    cfg = SMALL
    R, N = 37, cfg['N']
    moments, view, delta, mids, flat = _problem(R, **cfg)
    encode = cfg['deg'] if form == 'moments' else None
    x = moments if encode else tk.ipe_moments_plain(
        torch.tensor(moments), *cfg['deg']).numpy()
    cots = _render_cotangents(R, N)
    args = (N, cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'])

    def f(fl):
        return jk.fused_mlp_lean_render(
            jnp.asarray(x), jnp.asarray(view), jnp.asarray(delta),
            jnp.asarray(mids), fl, *args, jnp.float32, None, mode, ACT,
            white, encode)
    j_out, vjp = jax.vjp(f, tuple(jnp.asarray(p) for p in flat))
    (j_grads,) = vjp(tuple(jnp.asarray(c) for c in cots))

    params = [torch.tensor(p, requires_grad=True) for p in flat]
    t_out = tk.fused_mlp_lean_render(
        torch.tensor(x), torch.tensor(view), torch.tensor(delta),
        torch.tensor(mids), params, *args, torch.float32, ACT, white, encode,
        mode)
    sum((o * torch.tensor(c)).sum() for o, c in zip(t_out, cots)).backward()
    _close([o.detach().numpy() for o in t_out],
           [np.asarray(o) for o in j_out], 1e-5, 'output')
    _close([p.grad.numpy() for p in params],
           [np.asarray(g) for g in j_grads], 2e-4, 'leaf')


@pytest.mark.parametrize('N', [8, 40], ids=['N8', 'N40'])
@pytest.mark.parametrize('white', [True, False])
def test_composite_bwd_plain_matches_jax(white, N):
    """lean_composite_bwd_plain against the JAX
    `_lean_render_head_cotangents` (the composite backward of TPU kernel
    #2) on the same activated heads and per-ray cotangents, and against
    autograd through the port's plain composite (the VJP both compute).
    f32, rtol 1e-5 / atol 1e-6: prefix and suffix sums run in another
    order (cumsum against JAX's triangular matmuls).  N = 40 is ragged
    against the CUDA kernel's 32-sample chunks."""
    rng = np.random.default_rng(11)
    R = 13
    rgbsig = rng.uniform(0.0, 1.0, size=(R * N, 4)).astype(np.float32)
    rgbsig[:, 3] *= 30.0
    delta = rng.uniform(0.0, 0.1, size=(R, N)).astype(np.float32)
    mids = np.cumsum(rng.uniform(0.01, 0.05, size=(R, N)), -1) + 2.0
    mids = mids.astype(np.float32)
    g_perray = rng.normal(size=(R, 8)).astype(np.float32)
    g_w = rng.normal(size=(R, N)).astype(np.float32)
    cfg = {'num_samples': N, 'render': {'white_bkgd': white}}
    want = jk._lean_render_head_cotangents(
        jnp.asarray(rgbsig[:, :3]), jnp.asarray(rgbsig[:, 3:]),
        jnp.asarray(delta), jnp.asarray(mids), jnp.asarray(g_perray),
        jnp.asarray(g_w), cfg)
    t = [torch.tensor(a) for a in (rgbsig, delta, mids, g_perray, g_w)]
    got = tk.lean_composite_bwd(*t, white)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    heads = t[0].clone().requires_grad_(True)
    perray, w = tk.lean_composite_plain(heads, t[1], t[2], white)
    g_pad = t[3].clone()
    g_pad[:, 5:] = 0.0                    # the pad lanes carry nothing
    ((perray * g_pad).sum() + (w * t[4]).sum()).backward()
    auto = torch.cat(got, dim=-1)
    torch.testing.assert_close(auto, heads.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('case', ['deg16', 'ragged', 'no_integration'])
def test_ipe_moments_plain_matches_jax(case):
    """ipe_moments (its plain version on the CPU) against JAX's
    fused_ipe_moments (TPU kernel #12 in interpret mode): [6, M] -> [M, 6L].
    atol 5e-6: JAX's polynomial exp/sin against libm, the bar JAX holds its
    own fast encode to (tests/test_ops_math.py:263-277).  'ragged' has 700
    points (no multiple of the JAX tile); 'no_integration' zeroes the
    covariance rows as disable_integration does.  The moments get no
    gradient (JAX: zero cotangents): the port encodes moments that need
    none and refuses moments that require one instead of detaching them."""
    from mipnerf_pl_tpu.kernels.ipe import fused_ipe_moments
    rng = np.random.default_rng(12)
    M, deg = {'deg16': (256, (0, 16)), 'ragged': (700, (0, 4)),
              'no_integration': (96, (2, 6))}[case]
    moments = np.concatenate([rng.normal(size=(3, M)) * 1.5,
                              rng.uniform(0.001, 0.2, size=(3, M))])
    moments = moments.astype(np.float32)
    if case == 'no_integration':
        moments[3:] = 0.0
    want = np.asarray(fused_ipe_moments(jnp.asarray(moments), *deg, True))
    m = torch.tensor(moments)
    got = tk.ipe_moments(m, *deg)
    assert got.shape == want.shape == (M, 6 * (deg[1] - deg[0]))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)
    with pytest.raises(ValueError, match='require a gradient'):
        tk.ipe_moments(m.clone().requires_grad_(True), *deg)
