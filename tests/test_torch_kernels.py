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
