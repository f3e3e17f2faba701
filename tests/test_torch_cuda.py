"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where there is no CUDA device.
This file imports neither jax nor the JAX package (the GPU machine has
neither), so on the card it runs without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are numpy-seeded; the plain reference runs on the card in f32 with
TF32 off.  f32 kernels: max |d| <= 1e-4 (f32 sums in another order over
K <= 352).  bf16 kernels: max |d| / max |ref| <= 3e-2 against the f32
plain version (bench.py's bar for bf16).  Parameter gradients, with both
backwards fed the same saved stream (the plain forward's, in the compute
dtype): the largest leaf relative error ||a - b|| / ||b|| (bench.py's
metric) against the f32 plain backward, <= 1e-4 in f32 and <= 3e-2 in
bf16.  Fed the kernel forward's own stream instead, the f32 gradients move
by ~3e-3 at 393,216 points: the forwards differ by ~1e-6, which flips the
ReLU mask of every pre-activation that close to zero.  So the hybrid
backward is held against its plain version on the same stream (its plain
forward's, which writes the `saved_rows` layout and the raw heads as
'save' does; the same kernels then run it), and the recompute backward against the save backward on the same kernel forward
(<= 1e-5: it re-runs that forward, and only the order of the f32 bias
sums differs); lean_fwd must equal lean_save_fwd's outputs bit for bit.
The bf16 backward of a channel-major stream runs on wgmma (the chain where
the widths are multiples of 64: the `wide`, `skip_end` and lego shapes),
under the same bars, two lean_param_grads runs bit for bit.  At those
shapes the bf16 lean forwards (lean_fwd, lean_save_fwd, the recompute
re-run, lean_mlp) run on wgmma too (lean_fwd_sm90_kernel): each test
asserts the route its calls took (`routes`, against `fwd_sm90_route`), the
library's route and shared memory agree with the Python rule, and two runs
of the new forward give the same bits.  The f32 lean forwards at the same
shapes run on the 3xTF32 wgmma forward (lean_fwd_tf32_kernel, `tf32_routes`
against `fwd_tf32_route`) and the f32 lean chain on lean_chain_tf32_kernel
(`chain_tf32_routes` against `chain_tf32_route`; the bf16 chain's calls in
`chain_routes`), under the f32 bars above.  The weight gradients of every
f32 backward run on wgrad_tf32_kernel (`wgrad_tf32_routes` against
`wgrad_tf32_route`, hybrid's included), every bf16 one on
wgrad_sm90_kernel (`wgrad_sm90_routes`), and a stream the f32 kernel
cannot map raises.
The moments input form is held against the rows form on the plain decode
of the same moments (<= 1e-5 f32), lean_composite_bwd and ipe_moments
against their plain versions (<= 1e-5), and training through the
render-fused level against its wrappers called in order (bit for bit).
fused_mlp's kernels (the `pallas` / `pallas_save` backends) take the same
bars, dx and dview with the parameters; its recompute backward equals the
saved one on dx and dview bit for bit; they also run a model with no view
layer (net_depth_condition 0).  The Megatron pair kernels (tp_pair_fwd,
tp_pair_bwd: kernels/tp_lean.py) are held against their plain versions at
small, ragged and chunked-width shapes and the TP slice's pair widths at
the same bars (the gradients at ||a - b|| / ||b||), two backward runs bit
for bit, each on the kernel its rule names (tp_pair_wg_kernel in bf16 and
f32 at the slice's widths, the mma.sync kernels elsewhere; a plan that
cannot be made raises), and tp_lean_forward on a single-process mesh on
the card against the same function on the CPU, as is tp_mlp_forward at
the shapes the pairs alone do not take (an odd depth, a skip at a pair
boundary, no view layer, no view directions).  The
standalone IPE (ipe_fwd,
ipe_bwd: `nerf.ipe_backend: pallas`) is held against its plain versions,
max |d| <= 1e-5 forward and ||a - b|| / ||b|| <= 1e-5 for dmeans and dcovs
(which reach 1e5 and 1e9), two runs bit for bit, one launch a call, also at
zero covariances, with means past the range where CUDA's sincosf turns slow,
at degrees 16..32 and on an odd ladder.  The unbounded-360 path:
lean_save_fwd and lean_param_grads on the 42-feature icosahedral encode
(the real360 widths, a skip concat at the end of the trunk, and the
mma.sync tile) at the bars above, each on the route its rule names for F =
42, and an unbounded MipNerf trained with and without fuse_render (the
render-fused level compositing over 1/t_inv) against its plain versions on
the CPU.
"""

import numpy as np
import pytest
import torch

from mipnerf_pl_tpu_torch.kernels import mlp as tk

SMALL = dict(net_depth=3, net_width=16, net_depth_condition=1,
             net_width_condition=16, skip_index=2, N=8, deg=(0, 4), Fv=27)


def problem(R, N, net_depth, net_width, net_depth_condition,
             net_width_condition, skip_index, deg, Fv, seed=0):
    """Numpy-seeded inputs and Xavier-uniform params in flax [in, out]
    layout, listed in param_order."""
    rng = np.random.default_rng(seed)
    F = 6 * (deg[1] - deg[0])
    M = R * N
    means = rng.normal(size=(3, M)) * 0.7
    covs = rng.uniform(0.0, 2e-3, size=(3, M))
    moments = np.concatenate([means, covs]).astype(np.float32)
    view = rng.normal(size=(R, Fv)).astype(np.float32)
    delta = rng.uniform(0.0, 0.1, size=(R, N)).astype(np.float32)
    mids = np.cumsum(rng.uniform(0.01, 0.05, size=(R, N)), -1) + 2.0
    mids = mids.astype(np.float32)
    dims = []
    d_in = F
    for i in range(net_depth):
        dims.append((d_in, net_width))
        d_in = net_width + (F if i % skip_index == 0 and i > 0 else 0)
    dims += [(d_in, 1), (d_in, net_width)]
    d_v = net_width + Fv
    for _ in range(net_depth_condition):
        dims.append((d_v, net_width_condition))
        d_v = net_width_condition
    dims.append((d_v, 3))
    flat = []
    for fi, fo in dims:
        lim = np.sqrt(6.0 / (fi + fo))
        flat.append(rng.uniform(-lim, lim, size=(fi, fo)).astype(np.float32))
        flat.append(rng.normal(0.0, 0.1, size=(1, fo)).astype(np.float32))
    return moments, view, delta, mids, flat


def run_port(prob, cfg, dtype=torch.float32, white=True, device='cpu'):
    """fused_mlp_lean_render of the port on `problem`'s arrays."""
    moments, view, delta, mids, flat = (
        [torch.tensor(p, device=device) for p in a] if isinstance(a, list)
        else torch.tensor(a, device=device) for a in prob)
    out = tk.fused_mlp_lean_render(
        moments, view, delta, mids, flat, cfg['N'], cfg['net_depth'],
        cfg['net_depth_condition'], cfg['skip_index'], dtype, (0.001, -1.0),
        white, cfg['deg'])
    return [o.float().cpu().numpy() for o in out]


# ---------------------------------------------------------------------------
# On the card: CUDA kernels against their plain versions.
# ---------------------------------------------------------------------------

LEGO = dict(net_depth=8, net_width=256, net_depth_condition=1,
            net_width_condition=128, skip_index=4, N=128, deg=(0, 16), Fv=27)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels build with nvcc for '
                    'sm_90a)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _plain_on(prob, cfg, device, dtype=torch.float32, white=True):
    """The plain twin on the card, through the wrapper's CPU-only branch."""
    moments, view, delta, mids, flat = (
        [torch.tensor(p, device=device) for p in a] if isinstance(a, list)
        else torch.tensor(a, device=device) for a in prob)
    iv = 2 * (cfg['net_depth'] + 2)
    vp = tk.view_proj_plain(view, flat[iv], flat[iv + 1], cfg['net_width'],
                            dtype)
    rs = tk.lean_mlp_plain(moments, vp, flat, cfg['N'], cfg['net_depth'],
                           cfg['net_depth_condition'], cfg['skip_index'],
                           dtype, (0.001, -1.0), cfg['deg'])
    perray, w = tk.lean_composite_plain(rs, delta, mids, white)
    return [o.cpu().numpy() for o in (perray[:, 0:3], perray[:, 4:5],
                                      perray[:, 3:4], w)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', ['small', 'lego'])
def test_cuda_kernels_match_plain(cuda_device, shape, dtype):
    cfg = dict(SMALL, net_width=64, net_width_condition=32) \
        if shape == 'small' else LEGO
    # small: 37 rays x 8 = 296 points, ragged against the 64-point tile;
    # lego: N = 128 fills whole tiles, R = 300 rays.
    R = 37 if shape == 'small' else 300
    prob = problem(R, **cfg)
    dt = getattr(torch, dtype)
    tk.reset_launches()
    got = run_port(prob, cfg, dt, device=cuda_device)
    torch.cuda.synchronize()
    assert tk.launches == dict({k: 0 for k in tk.launches},
                               lean_view_proj=1, lean_mlp=1, lean_composite=1)
    assert tk.routes['lean_mlp'] == sm90_calls(cfg, dtype)
    assert tk.tf32_routes['lean_mlp'] == tf32_calls(cfg, dtype)
    want = _plain_on(prob, cfg, cuda_device)      # f32 plain reference
    for name, a, b in zip(('comp', 'dist', 'acc', 'weights'), got, want):
        assert np.all(np.isfinite(a)), name
        if dtype == 'float32':
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        else:
            # bench.py's bar for bf16 against the f32 reference.
            scale = max(np.abs(b).max(), 1e-6)
            assert np.abs(a - b).max() / scale <= 3e-2, name


@pytest.mark.cuda
def test_cuda_composite_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    R, N = 50, 128
    rs = torch.tensor(rng.uniform(0, 3, size=(R * N, 4)).astype(np.float32),
                      device=cuda_device)
    delta = torch.tensor(rng.uniform(0, 0.05, size=(R, N)).astype(np.float32),
                         device=cuda_device)
    mids = torch.tensor(rng.uniform(2, 6, size=(R, N)).astype(np.float32),
                        device=cuda_device)
    for white in (True, False):
        got = tk.lean_composite(rs, delta, mids, white)
        want = tk.lean_composite_plain(rs, delta, mids, white)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def train_problem(R, N, net_depth, net_width, net_depth_condition,
                  net_width_condition, skip_index, deg, Fv, seed=0):
    """problem() with encode rows x [M, F] (the IPE of its moments) in
    place of the moments, and numpy-seeded head cotangents."""
    from mipnerf_pl_tpu_torch.ops.math import integrated_pos_enc
    moments, view, _, _, flat = problem(
        R, N, net_depth, net_width, net_depth_condition, net_width_condition,
        skip_index, deg, Fv, seed)
    m = torch.tensor(moments)
    x = integrated_pos_enc((m[:3].t(), m[3:].t()), *deg).numpy()
    rng = np.random.default_rng(seed + 1)
    g_rgb = rng.normal(size=(R * N, 3)).astype(np.float32)
    g_dens = rng.normal(size=(R * N, 1)).astype(np.float32)
    return x, view, flat, g_rgb, g_dens


def max_leaf_rel_err(got, want):
    return max(float(torch.linalg.norm(a.double() - b.double())
                     / (torch.linalg.norm(b.double()) + 1e-12))
               for a, b in zip(got, want))


TRAIN_SHAPES = {
    # 37 rays x 8 = 296 points, ragged against the 64-point tile (the
    # padded points must add nothing to any gradient); the trunk ends on a
    # skip concat, so density and bottleneck read [h, x].
    'small': (37, dict(SMALL, net_width=64, net_width_condition=32)),
    # two view layers (the chain's view loop), 24 samples: rays straddle
    # the 64-point tiles at unaligned boundaries.
    'view2': (29, dict(SMALL, net_depth=4, net_width=64,
                       net_depth_condition=2, net_width_condition=32, N=24)),
    'lego': (96, LEGO),
    # widths that are multiples of 64 (the bf16 chain on wgmma), two view
    # layers, 696 points: the last 128-point tile of the chain is half
    # past the padded stream.
    'wide': (29, dict(SMALL, net_depth=4, net_width=128,
                      net_depth_condition=2, net_width_condition=64, N=24)),
    # widths that are multiples of 64 with the trunk ending on a skip
    # concat (density and bottleneck read [h, x] on the wgmma forward), 296
    # points: ragged against the 64- and 128-point tiles.
    'skip_end': (37, dict(SMALL, net_width=128, net_width_condition=64)),
}


def sm90_calls(cfg, dtype, calls=1):
    """Calls of a lean forward that take lean_fwd_sm90_kernel at cfg's
    widths in `dtype` (the rule of fwd_sm90_route)."""
    F = 6 * (cfg['deg'][1] - cfg['deg'][0])
    on = tk.fwd_sm90_route(getattr(torch, dtype), F, cfg['net_width'],
                           cfg['net_width_condition'], cfg['net_depth'],
                           cfg['net_depth_condition'])
    return calls if on else 0


def tf32_calls(cfg, dtype, calls=1):
    """Calls of a lean forward that take lean_fwd_tf32_kernel at cfg's
    widths in `dtype` (the rule of fwd_tf32_route)."""
    F = 6 * (cfg['deg'][1] - cfg['deg'][0])
    on = tk.fwd_tf32_route(getattr(torch, dtype), F, cfg['net_width'],
                           cfg['net_width_condition'], cfg['net_depth'],
                           cfg['net_depth_condition'])
    return calls if on else 0


def chain_calls(cfg, dtype, calls=1):
    """(calls on lean_chain_sm90_kernel, calls on lean_chain_tf32_kernel)
    of a lean backward on a channel-major stream at cfg's widths in
    `dtype` (the rules of chain_sm90_route and chain_tf32_route)."""
    args = (getattr(torch, dtype), cfg['net_width'],
            cfg['net_width_condition'], cfg['net_depth'],
            cfg['net_depth_condition'])
    return (calls if tk.chain_sm90_route(*args) else 0,
            calls if tk.chain_tf32_route(*args) else 0)


def chain_took(name):
    return tk.chain_routes[name], tk.chain_tf32_routes[name]


def wgrad_calls(dtype, calls=1):
    """Calls of a backward on a channel-major stream whose weight
    gradients take wgrad_tf32_kernel in `dtype`: f32 at every shape the
    tests use (their Mp and ranges are multiples of the 32-point slab)."""
    return calls if dtype == 'float32' else 0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TRAIN_SHAPES))
def test_cuda_lean_save_matches_plain(cuda_device, shape, dtype):
    """lean_save_fwd and lean_param_grads against lean_mlp_save_plain and
    lean_param_grads_plain (f32) on the card: outputs, saved activations,
    raw heads and every parameter gradient."""
    R, cfg = TRAIN_SHAPES[shape]
    arrays = train_problem(R, **cfg)
    x, view, g_rgb, g_dens = (torch.tensor(a, device=cuda_device)
                              for a in (arrays[0], arrays[1], arrays[3],
                                        arrays[4]))
    flat = [torch.tensor(p, device=cuda_device) for p in arrays[2]]
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'])
    act = (0.001, -1.0)
    dt = getattr(torch, dtype)
    in_saved = tk.lean_mlp_save_plain(x, view, flat, *args, dt, act)[2]
    tk.reset_launches()
    rgb, dens, saved = tk.lean_save_fwd(x, view, flat, *args, dt, act)
    grads = tk.lean_param_grads(view, g_rgb, g_dens, in_saved, flat, *args,
                                dt, act)
    torch.cuda.synchronize()
    assert tk.launches['lean_save_fwd'] == 1
    assert tk.launches['lean_param_grads'] == 1
    assert tk.routes['lean_save_fwd'] == sm90_calls(cfg, dtype)
    assert tk.tf32_routes['lean_save_fwd'] == tf32_calls(cfg, dtype)
    assert chain_took('lean_param_grads') == chain_calls(cfg, dtype)
    assert tk.wgrad_tf32_routes['lean_param_grads'] == wgrad_calls(dtype)
    ref_rgb, ref_dens, ref_saved = tk.lean_mlp_save_plain(
        x, view, flat, *args, torch.float32, act)
    ref_grads = tk.lean_param_grads_plain(view, g_rgb, g_dens, in_saved,
                                          flat, *args, torch.float32, act)
    M = x.shape[0]
    pairs = [(rgb, ref_rgb), (dens, ref_dens),
             (saved[0][:, :M].float(), ref_saved[0][:, :M].float()),
             (saved[1][:, :M], ref_saved[1][:, :M])]
    for i, (a, b) in enumerate(pairs):
        assert torch.isfinite(a).all(), i
        err = float((a - b).abs().max())
        if dtype == 'float32':
            assert err <= 1e-4, (i, err)
        else:
            assert err / max(float(b.abs().max()), 1e-6) <= 3e-2, (i, err)
    assert [g.shape for g in grads] == [g.shape for g in ref_grads]
    assert all(torch.isfinite(g).all() for g in grads)
    bar = 1e-4 if dtype == 'float32' else 3e-2
    assert max_leaf_rel_err(grads, ref_grads) <= bar


def _on(arrays, device):
    x, view, flat, g_rgb, g_dens = arrays
    return ([torch.tensor(a, device=device) for a in (x, view)],
            [torch.tensor(p, device=device) for p in flat],
            [torch.tensor(a, device=device) for a in (g_rgb, g_dens)])


@pytest.mark.cuda
@pytest.mark.parametrize('act', [(0.001, -1.0), None], ids=['act', 'raw'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TRAIN_SHAPES))
def test_cuda_lean_fwd_matches_plain(cuda_device, shape, dtype, act):
    """lean_fwd against lean_fwd_plain (f32) at the forward bars, and bit
    for bit equal to lean_save_fwd's outputs (the same kernel and tiles)."""
    R, cfg = TRAIN_SHAPES[shape]
    (x, view), flat, _ = _on(train_problem(R, **cfg), cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'])
    dt = getattr(torch, dtype)
    tk.reset_launches()
    got = tk.lean_fwd(x, view, flat, *args, dt, act)
    saved_out = tk.lean_save_fwd(x, view, flat, *args, dt, act)
    torch.cuda.synchronize()
    assert tk.launches['lean_fwd'] == 1
    assert tk.routes['lean_fwd'] == tk.routes['lean_save_fwd'] \
        == sm90_calls(cfg, dtype)
    assert tk.tf32_routes['lean_fwd'] == tk.tf32_routes['lean_save_fwd'] \
        == tf32_calls(cfg, dtype)
    ref = tk.lean_fwd_plain(x, view, flat, *args, torch.float32, act)
    for a, b, c in zip(got, saved_out, ref):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
        err = float((a - c).abs().max())
        if dtype == 'float32':
            assert err <= 1e-4, err
        else:
            assert err / max(float(c.abs().max()), 1e-6) <= 3e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize('chunks', ['default', 'one_range'])
@pytest.mark.parametrize('act', [(0.001, -1.0), None], ids=['act', 'raw'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TRAIN_SHAPES))
def test_cuda_recompute_matches_save(cuda_device, shape, dtype, act, chunks,
                                     monkeypatch):
    """lean_param_grads_recompute against lean_param_grads on the kernel
    forward's saved stream (the same forward, re-run chunk by chunk): only
    the order of the f32 bias sums differs, largest leaf relative error
    <= 1e-5; two runs give the same bits.  'one_range' re-runs one
    weight-gradient range at a time, so the small shapes take several
    chunks too (the last one ragged)."""
    if chunks == 'one_range':
        monkeypatch.setattr(tk, 'RECOMPUTE_POINTS', 1)
    R, cfg = TRAIN_SHAPES[shape]
    (x, view), flat, (g_rgb, g_dens) = _on(train_problem(R, **cfg),
                                           cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], getattr(torch, dtype), act)
    saved = tk.lean_save_fwd(x, view, flat, *args)[2]
    want = tk.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args)
    tk.reset_launches()
    got = tk.lean_param_grads_recompute(x, view, g_rgb, g_dens, flat, *args)
    again = tk.lean_param_grads_recompute(x, view, g_rgb, g_dens, flat,
                                          *args)
    torch.cuda.synchronize()
    assert tk.launches['lean_param_grads_recompute'] == 2
    assert tk.routes['lean_param_grads_recompute'] == sm90_calls(cfg, dtype, 2)
    assert tk.tf32_routes['lean_param_grads_recompute'] \
        == tf32_calls(cfg, dtype, 2)
    assert chain_took('lean_param_grads_recompute') \
        == chain_calls(cfg, dtype, 2)
    assert tk.wgrad_tf32_routes['lean_param_grads_recompute'] \
        == wgrad_calls(dtype, 2)
    assert all(torch.isfinite(g).all() for g in got)
    assert max_leaf_rel_err(got, want) <= 1e-5
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', ['wide', 'skip_end', 'lego'])
def test_cuda_fwd_sm90_deterministic(cuda_device, shape):
    """Two runs of the bf16 wgmma forward give the same bits: lean_save_fwd
    (outputs, saved stream, raw heads) on encode rows and on the moments,
    and lean_mlp on the moments."""
    R, cfg = TRAIN_SHAPES[shape]
    m, x, view, flat, _, _ = moments_problem(R, cfg, cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], torch.bfloat16, (0.001, -1.0))
    M = x.shape[0]
    iv = 2 * (cfg['net_depth'] + 2)
    vp = tk.view_proj(view, flat[iv], flat[iv + 1], cfg['net_width'],
                      torch.bfloat16)
    tk.reset_launches()
    runs = [fwd_parts(tk.lean_save_fwd(x, view, flat, *args), M)
            + fwd_parts(tk.lean_save_fwd(m, view, flat, *args,
                                         encode=cfg['deg']), M)
            + [tk.lean_mlp(m, vp, flat, *args, cfg['deg'])]
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tk.routes['lean_save_fwd'] == 4 and tk.routes['lean_mlp'] == 2
    for a, b in zip(*runs):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_fwd_sm90_route_matches_the_library(cuda_device):
    """The library's route and shared memory of lean_fwd_sm90_kernel agree
    with fwd_sm90_route and fwd_sm90_smem, and the lego plan fits."""
    from mipnerf_pl_tpu_torch.kernels import _build
    lib = _build.load('lean_train')
    for F, W, Wv, depth, dcond in [(96, 256, 128, 8, 1), (24, 128, 64, 4, 2),
                                   (24, 64, 32, 3, 1), (96, 256, 128, 12, 1),
                                   (130, 256, 128, 8, 1), (96, 192, 64, 8, 3),
                                   (96, 256, 256, 8, 1), (96, 320, 128, 8, 1)]:
        want = tk.fwd_sm90_route(torch.bfloat16, F, W, Wv, depth, dcond)
        assert bool(lib.lean_fwd_sm90_route(F, W, Wv, depth, dcond)) == want
        assert lib.lean_fwd_sm90_smem(W, Wv, F) == tk.fwd_sm90_smem(W, Wv, F)
    assert tk.fwd_sm90_smem(256, 128, 96) <= tk.FW_SMEM_MAX


@pytest.mark.cuda
@pytest.mark.parametrize('shape', ['wide', 'skip_end', 'lego'])
def test_cuda_fwd_tf32_deterministic(cuda_device, shape):
    """Two runs of the f32 wgmma forward give the same bits: lean_save_fwd
    (outputs, saved stream, raw heads) on encode rows and on the moments,
    and lean_mlp on the moments; lean_fwd gives lean_save_fwd's outputs bit
    for bit in both forms."""
    R, cfg = TRAIN_SHAPES[shape]
    m, x, view, flat, _, _ = moments_problem(R, cfg, cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], torch.float32, (0.001, -1.0))
    M = x.shape[0]
    iv = 2 * (cfg['net_depth'] + 2)
    vp = tk.view_proj(view, flat[iv], flat[iv + 1], cfg['net_width'],
                      torch.float32)
    tk.reset_launches()
    runs = [fwd_parts(tk.lean_save_fwd(x, view, flat, *args), M)
            + fwd_parts(tk.lean_save_fwd(m, view, flat, *args,
                                         encode=cfg['deg']), M)
            + [tk.lean_mlp(m, vp, flat, *args, cfg['deg'])]
            for _ in range(2)]
    fwd = (list(tk.lean_fwd(x, view, flat, *args))
           + list(tk.lean_fwd(m, view, flat, *args, encode=cfg['deg'])))
    torch.cuda.synchronize()
    assert tk.tf32_routes['lean_save_fwd'] == 4
    assert tk.tf32_routes['lean_mlp'] == 2 and tk.tf32_routes['lean_fwd'] == 2
    assert not any(tk.routes.values())
    for a, b in zip(*runs):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
    for a, b in zip(fwd, runs[0][:2] + runs[0][4:6]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_tf32_routes_match_the_library(cuda_device):
    """The library's rules and shared memory of lean_fwd_tf32_kernel and of
    the two wgmma chains agree with fwd_tf32_route / fwd_tf32_smem and
    chain_sm90_route / chain_tf32_route / chain_tf32_smem, and the lego
    plans fit."""
    import ctypes
    from mipnerf_pl_tpu_torch.kernels import _build
    lib = _build.load('lean_train')
    for F, W, Wv, depth, dcond in [(96, 256, 128, 8, 1), (24, 128, 64, 4, 2),
                                   (24, 64, 32, 3, 1), (96, 256, 128, 12, 1),
                                   (130, 256, 128, 8, 1), (96, 192, 64, 8, 3),
                                   (128, 256, 256, 8, 1), (96, 320, 128, 8, 1),
                                   (18, 64, 64, 14, 1), (96, 256, 128, 10, 1),
                                   (96, 64, 64, 15, 1)]:
        want = tk.fwd_tf32_route(torch.float32, F, W, Wv, depth, dcond)
        assert bool(lib.lean_fwd_tf32_route(F, W, Wv, depth, dcond)) == want
        assert lib.lean_fwd_tf32_smem(W, Wv, F) == tk.fwd_tf32_smem(W, Wv, F)
        for flag, dt, rule in ((1, torch.bfloat16, tk.chain_sm90_route),
                               (0, torch.float32, tk.chain_tf32_route)):
            got = bool(lib.lean_chain_route(flag, W, Wv, depth, dcond))
            assert got == rule(dt, W, Wv, depth, dcond)
        cg = tk.chain_cg(W, Wv, depth, dcond)
        assert lib.lean_chain_tf32_smem(W, Wv, depth, dcond) \
            == tk.chain_tf32_smem(W, Wv, cg)
        smem = (ctypes.c_int * 2)()
        lib.lean_sm90_smem(cg, smem)
        assert smem[0] == tk.chain_sm90_smem(cg)
    assert tk.fwd_tf32_smem(256, 128, 96) <= tk.FW_SMEM_MAX
    assert tk.chain_tf32_route(torch.float32, 256, 128, 8, 1)
    assert tk.chain_sm90_route(torch.bfloat16, 256, 128, 8, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_lego_chain_routes(cuda_device, dtype):
    """At the lego widths the lean chain of lean_param_grads and of
    lean_param_grads_recompute runs on its wgmma kernel in both dtypes
    (lean_chain_sm90_kernel in bf16, lean_chain_tf32_kernel in f32), and
    the f32 parameter gradients hold the f32 bar against the plain
    backward on the same stream."""
    R, cfg = TRAIN_SHAPES['lego']
    (x, view), flat, (g_rgb, g_dens) = _on(train_problem(R, **cfg),
                                           cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], getattr(torch, dtype), (0.001, -1.0))
    saved = tk.lean_save_fwd(x, view, flat, *args)[2]
    tk.reset_launches()
    got = tk.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args)
    tk.lean_param_grads_recompute(x, view, g_rgb, g_dens, flat, *args)
    torch.cuda.synchronize()
    want = (1, 0) if dtype == 'bfloat16' else (0, 1)
    assert chain_took('lean_param_grads') == want
    assert chain_took('lean_param_grads_recompute') == want
    if dtype == 'float32':
        ref = tk.lean_param_grads_plain(view, g_rgb, g_dens, saved, flat,
                                        *args)
        assert max_leaf_rel_err(got, ref) <= 1e-4


@pytest.mark.cuda
def test_cuda_chain_plan_failure_raises(cuda_device, monkeypatch):
    """A shape the f32 chain's rule takes whose plan cannot be made (here:
    no split kernels handed to the library) raises; no other chain runs in
    its place."""
    R, cfg = TRAIN_SHAPES['wide']
    (x, view), flat, (g_rgb, g_dens) = _on(train_problem(R, **cfg),
                                           cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], torch.float32, (0.001, -1.0))
    saved = tk.lean_save_fwd(x, view, flat, *args)[2]
    monkeypatch.setattr(tk, 'chain_tf32_route', lambda *a: False)
    tk.reset_launches()
    with pytest.raises(RuntimeError, match='lean_param_grads'):
        tk.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args)
    torch.cuda.synchronize()
    assert chain_took('lean_param_grads') == (0, 0)


@pytest.mark.cuda
def test_cuda_wgrad_tf32_route_matches_the_library(cuda_device):
    """The library's rule of wgrad_tf32_kernel (C entry wgrad_tf32_route)
    agrees with kernels/mlp.py wgrad_tf32_route, and its shared memory
    fits the block's."""
    from mipnerf_pl_tpu_torch.kernels import _build
    lib = _build.load('lean_train')
    for flag, dt in ((0, torch.float32), (1, torch.bfloat16)):
        for Mp, MC in ((393216, 15232), (320, 128), (64, 64),
                       (393216, 15248), (400, 128), (0, 64)):
            assert bool(lib.wgrad_tf32_route(flag, Mp, MC)) \
                == tk.wgrad_tf32_route(dt, Mp, MC)
    assert 0 < lib.lean_wgrad_tf32_smem() <= tk.FW_SMEM_MAX


@pytest.mark.cuda
def test_cuda_lego_wgrad_routes(cuda_device):
    """At the lego shape every f32 backward runs its weight gradients on
    wgrad_tf32_kernel, by the library's own count: lean_param_grads,
    lean_param_grads_recompute, lean_param_grads_hybrid (on the stream its
    plain forward writes), the render-fused level's backward in both modes
    (through the first two), mlp_bwd_saved, mlp_bwd_recompute and
    tp_pair_bwd.  Two runs of each give the same bits."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean
    R, cfg = TRAIN_SHAPES['lego']
    (x, view), flat, (g_rgb, g_dens) = _on(train_problem(R, **cfg),
                                           cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], torch.float32, (0.001, -1.0))
    saved = tk.lean_save_fwd(x, view, flat, *args)[2]
    res = tk.lean_hybrid_fwd(x, view, flat, *args)[2]
    ccfg, (cx, cview, cg_rgb, cg_dens), cflat = _classic_on('lego',
                                                            cuda_device)
    cargs = (ccfg['net_depth'], ccfg['net_depth_condition'],
             ccfg['skip_index'], torch.float32)
    cS = tk.mlp_save_fwd(cx, cview, cflat, *cargs)[2]
    M = x.shape[0]
    pair = _pair_problem_at((M, 1024, 512, 1024), cuda_device)
    calls = {
        'lean_param_grads': lambda: tk.lean_param_grads(
            view, g_rgb, g_dens, saved, flat, *args),
        'lean_param_grads_recompute': lambda: tk.lean_param_grads_recompute(
            x, view, g_rgb, g_dens, flat, *args),
        'lean_param_grads_hybrid': lambda: tk.lean_param_grads_hybrid(
            view, g_rgb, g_dens, res, flat, *args),
        'mlp_bwd_saved': lambda: tk.mlp_bwd_saved(
            cg_rgb, cg_dens, cS, cflat, *cargs)[2],
        'mlp_bwd_recompute': lambda: tk.mlp_bwd_recompute(
            cx, cview, cg_rgb, cg_dens, cflat, *cargs)[2],
        'tp_pair_bwd': lambda: tp_lean._pair_bwd_call(*pair, torch.float32),
    }
    tk.reset_launches()
    for name, fn in calls.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        assert tk.wgrad_tf32_routes[name] == 2, name
        assert tk.wgrad_sm90_routes[name] == 0, name
        for a, b in zip(got, again):
            assert torch.isfinite(a).all(), name
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # The render-fused level's backward, in each mode.
    m = torch.tensor(problem(R, **cfg)[0], device=cuda_device)
    delta = torch.full((R, cfg['N']), 0.01, device=cuda_device)
    mids = 2.0 + torch.cumsum(delta, -1)
    params = [p.clone().requires_grad_(True) for p in flat]
    for mode, name in (('save', 'lean_param_grads'),
                       ('recompute', 'lean_param_grads_recompute')):
        tk.reset_launches()
        out = tk.fused_mlp_lean_render(m, view, delta, mids, params, *args,
                                       True, cfg['deg'], mode)
        sum(o.sum() for o in out).backward()
        torch.cuda.synchronize()
        assert tk.wgrad_tf32_routes[name] == 1, mode
        assert all(torch.isfinite(p.grad).all() for p in params)


@pytest.mark.cuda
def test_cuda_wgrad_plan_failure_raises(cuda_device):
    """A backward whose stream the f32 weight-gradient kernel cannot map
    (a saved stream 4 bytes off the 16-byte alignment a tensor map needs;
    at the `small` widths the chain is the mma.sync one, which reads it)
    raises; no other weight-gradient kernel runs in its place."""
    R, cfg = TRAIN_SHAPES['small']
    (x, view), flat, (g_rgb, g_dens) = _on(train_problem(R, **cfg),
                                           cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], torch.float32, (0.001, -1.0))
    S, heads = tk.lean_save_fwd(x, view, flat, *args)[2]
    buf = torch.empty(S.numel() + 1, device=cuda_device)
    off = buf[1:].view(S.shape)
    off.copy_(S)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    assert tk.wgrad_tf32_route(torch.float32, S.shape[1], 64)
    tk.reset_launches()
    with pytest.raises(RuntimeError, match='lean_param_grads'):
        tk.lean_param_grads(view, g_rgb, g_dens, (off, heads), flat, *args)
    torch.cuda.synchronize()
    assert tk.wgrad_tf32_routes['lean_param_grads'] == 0
    # The aligned stream takes it.
    tk.lean_param_grads(view, g_rgb, g_dens, (S, heads), flat, *args)
    torch.cuda.synchronize()
    assert tk.wgrad_tf32_routes['lean_param_grads'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TRAIN_SHAPES))
def test_cuda_lean_param_grads_deterministic(cuda_device, shape, dtype):
    """Two lean_param_grads calls on the same saved stream give the same
    bits (bf16 at widths that are multiples of 64: the wgmma chain and
    weight gradients; elsewhere the mma.sync kernels): fixed summation
    orders, no atomics."""
    R, cfg = TRAIN_SHAPES[shape]
    (x, view), flat, (g_rgb, g_dens) = _on(train_problem(R, **cfg),
                                           cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], getattr(torch, dtype), (0.001, -1.0))
    saved = tk.lean_save_fwd(x, view, flat, *args)[2]
    got = tk.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args)
    again = tk.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('act', [(0.001, -1.0), None], ids=['act', 'raw'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TRAIN_SHAPES))
def test_cuda_hybrid_matches_plain(cuda_device, shape, dtype, act):
    """lean_param_grads_hybrid against the f32 lean_param_grads_hybrid_plain
    on the same stream and raw heads (lean_hybrid_fwd's, in the compute
    dtype): largest leaf relative error <= 1e-4 f32, <= 3e-2 bf16.  Its
    chain takes the wgmma chain of its dtype where the rule takes the shape
    (`wide`, `skip_end`, lego), as 'save' does, and its weight gradients
    wgrad_tf32_kernel in f32, wgrad_sm90_kernel in bf16."""
    R, cfg = TRAIN_SHAPES[shape]
    (x, view), flat, (g_rgb, g_dens) = _on(train_problem(R, **cfg),
                                           cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'])
    dt = getattr(torch, dtype)
    res = tk.lean_hybrid_fwd(x, view, flat, *args, dt, act)[2]
    tk.reset_launches()
    got = tk.lean_param_grads_hybrid(view, g_rgb, g_dens, res, flat, *args,
                                     dt, act)
    torch.cuda.synchronize()
    name = 'lean_param_grads_hybrid'
    assert tk.launches[name] == 1
    assert chain_took(name) == chain_calls(cfg, dtype)
    assert tk.wgrad_tf32_routes[name] == wgrad_calls(dtype)
    assert tk.wgrad_sm90_routes[name] == (dtype == 'bfloat16')
    want = tk.lean_param_grads_hybrid_plain(view, g_rgb, g_dens, res, flat,
                                            *args, torch.float32, act)
    assert all(torch.isfinite(g).all() for g in got)
    bar = 1e-4 if dtype == 'float32' else 3e-2
    assert max_leaf_rel_err(got, want) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['save', 'recompute', 'hybrid'])
def test_cuda_fused_mlp_lean_autograd(cuda_device, mode):
    """The autograd Function on the card: gradients of the parameters
    through backward() equal the mode's backward wrapper, x and view get
    none."""
    cfg = dict(SMALL, net_width=64, net_width_condition=32)
    (x, view), flat, (g_rgb, g_dens) = _on(train_problem(21, **cfg),
                                           cuda_device)
    flat = [p.requires_grad_(True) for p in flat]
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], torch.float32, (0.001, -1.0))
    rgb, dens = tk.fused_mlp_lean(x, view, flat, *args[:5], mode, args[5])
    ((rgb * g_rgb).sum() + (dens * g_dens).sum()).backward()
    if mode == 'save':
        _, _, saved = tk.lean_save_fwd(x, view, flat, *args)
        want = tk.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args)
    elif mode == 'recompute':
        want = tk.lean_param_grads_recompute(x, view, g_rgb, g_dens, flat,
                                             *args)
    else:
        res = tk.lean_hybrid_fwd(x, view, flat, *args)[2]
        want = tk.lean_param_grads_hybrid(view, g_rgb, g_dens, res, flat,
                                          *args)
    for p, w in zip(flat, want):
        torch.testing.assert_close(p.grad, w.reshape(p.shape), rtol=0, atol=0)




# ---------------------------------------------------------------------------
# The moments input of the training kernels, the composite backward, the
# standalone moments encode and training through the render-fused level.
# ---------------------------------------------------------------------------

def moments_problem(R, cfg, device, seed=0):
    """problem()'s moments [6, M], the encode rows of the same moments (the
    plain decode), view and params on the card, and numpy-seeded head
    cotangents."""
    moments, view, _, _, flat = problem(R, **cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    M = R * cfg['N']

    def on(a):
        return torch.tensor(a, device=device)
    m = on(moments)
    return (m, tk.ipe_moments_plain(m, *cfg['deg']).contiguous(), on(view),
            [on(p) for p in flat],
            on(rng.normal(size=(M, 3)).astype(np.float32)),
            on(rng.normal(size=(M, 1)).astype(np.float32)))


def max_rel_err(got, want):
    """The largest max |a - b| / max |b| over the pairs."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)
               for a, b in zip(got, want))


def fwd_parts(out, M):
    """A forward's outputs, saved stream and raw heads of the M points."""
    rgb, dens, (S, heads) = out
    return [rgb, dens, S[:, :M].float(), heads[:, :M]]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TRAIN_SHAPES))
def test_cuda_moments_forms_match_rows(cuda_device, shape, dtype):
    """lean_fwd and lean_save_fwd on the [6, M] moments (the IPE decoded in
    the kernel) against the same kernels on the encode rows of the plain
    decode: f32 max |d| / max |ref| <= 1e-5 (the kernels' sines within
    ~0.5 ulp, torch.sin's of the same f32 arguments; the saved X rows are
    the decoded encode);
    bf16 <= 3e-2 against the f32 plain forward on the rows.  lean_fwd gives
    lean_save_fwd's outputs bit for bit."""
    R, cfg = TRAIN_SHAPES[shape]
    m, x, view, flat, _, _ = moments_problem(R, cfg, cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'])
    dt = getattr(torch, dtype)
    act = (0.001, -1.0)
    M = x.shape[0]
    tk.reset_launches()
    fwd = tk.lean_fwd(m, view, flat, *args, dt, act, encode=cfg['deg'])
    got = fwd_parts(tk.lean_save_fwd(m, view, flat, *args, dt, act,
                                     encode=cfg['deg']), M)
    torch.cuda.synchronize()
    assert tk.launches['lean_fwd'] == 1 and tk.launches['lean_save_fwd'] == 1
    assert tk.routes['lean_fwd'] == tk.routes['lean_save_fwd'] \
        == sm90_calls(cfg, dtype)
    assert tk.tf32_routes['lean_fwd'] == tk.tf32_routes['lean_save_fwd'] \
        == tf32_calls(cfg, dtype)
    assert all(torch.equal(a, b) for a, b in zip(fwd, got[:2]))
    assert all(torch.isfinite(t).all() for t in got)
    if dtype == 'float32':
        want = fwd_parts(tk.lean_save_fwd(x, view, flat, *args, dt, act), M)
        assert max_rel_err(got, want) <= 1e-5
    else:
        want = fwd_parts(tk.lean_mlp_save_plain(x, view, flat, *args,
                                                torch.float32, act), M)
        assert max_rel_err(got, want) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', ['small', 'wide', 'lego'])
def test_cuda_moments_forms_equal_rows_of_ipe_moments(cuda_device, shape,
                                                       dtype):
    """One decode: lean_fwd and lean_save_fwd on the [6, M] moments equal,
    bit for bit, the same wrappers on ipe_moments' rows of those moments
    (the outputs, the saved stream, the raw heads), since the forwards'
    in-tile decode and ipe_moments call one routine (ipe_moments_pair,
    csrc/ipe_core.cuh).  'small' takes the mma.sync tile, 'wide' (degrees
    0..4) and 'lego' (0..16) the wgmma forward of the dtype."""
    R, cfg = TRAIN_SHAPES[shape]
    m, _, view, flat, _, _ = moments_problem(R, cfg, cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], getattr(torch, dtype), (0.001, -1.0))
    rows = tk.ipe_moments(m, *cfg['deg'])
    M = rows.shape[0]
    tk.reset_launches()
    got = fwd_parts(tk.lean_save_fwd(m, view, flat, *args,
                                     encode=cfg['deg']), M)
    got += list(tk.lean_fwd(m, view, flat, *args, encode=cfg['deg']))
    want = fwd_parts(tk.lean_save_fwd(rows, view, flat, *args), M)
    want += list(tk.lean_fwd(rows, view, flat, *args))
    torch.cuda.synchronize()
    assert tk.launches['lean_fwd'] == 2 and tk.launches['lean_save_fwd'] == 2
    assert tk.routes['lean_fwd'] == tk.routes['lean_save_fwd'] \
        == sm90_calls(cfg, dtype, 2)
    assert tk.tf32_routes['lean_fwd'] == tk.tf32_routes['lean_save_fwd'] \
        == tf32_calls(cfg, dtype, 2)
    assert all(torch.isfinite(t).all() for t in got)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('chunks', ['default', 'one_range'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TRAIN_SHAPES))
def test_cuda_moments_recompute_matches_save(cuda_device, shape, dtype,
                                             chunks, monkeypatch):
    """lean_param_grads_recompute on the moments (each chunk's re-run
    decodes them with the forward's loader and tiles) against
    lean_param_grads on the stream of lean_save_fwd on the same moments:
    largest leaf relative error <= 1e-5 (only the f32 bias sums' order
    differs), two runs bit-equal."""
    if chunks == 'one_range':
        monkeypatch.setattr(tk, 'RECOMPUTE_POINTS', 1)
    R, cfg = TRAIN_SHAPES[shape]
    m, _, view, flat, g_rgb, g_dens = moments_problem(R, cfg, cuda_device)
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], getattr(torch, dtype), (0.001, -1.0))
    saved = tk.lean_save_fwd(m, view, flat, *args, encode=cfg['deg'])[2]
    want = tk.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args)
    tk.reset_launches()
    got, again = (tk.lean_param_grads_recompute(m, view, g_rgb, g_dens, flat,
                                                *args, encode=cfg['deg'])
                  for _ in range(2))
    torch.cuda.synchronize()
    assert tk.launches['lean_param_grads_recompute'] == 2
    assert all(torch.isfinite(g).all() for g in got)
    assert max_leaf_rel_err(got, want) <= 1e-5
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('white', [True, False])
@pytest.mark.parametrize('shape', ['small', 'lego'])
def test_cuda_composite_bwd_matches_plain(cuda_device, shape, white):
    """lean_composite_bwd against lean_composite_bwd_plain (f32): max |d| /
    max |ref| <= 1e-5, the scans' sums run in another order.  'small' has
    N = 40, ragged against the kernel's 32-sample chunks; 'lego' is a
    training level, 3072 rays x 128 samples."""
    R, N = (37, 40) if shape == 'small' else (3072, 128)
    rng = np.random.default_rng(5)

    def on(a):
        return torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    rgbsig = rng.uniform(0.0, 1.0, size=(R * N, 4))
    rgbsig[:, 3] *= 30.0
    delta = rng.uniform(0.0, 0.05, size=(R, N))
    mids = np.cumsum(rng.uniform(0.01, 0.05, size=(R, N)), -1) + 2.0
    t = [on(a) for a in (rgbsig, delta, mids, rng.normal(size=(R, 8)),
                         rng.normal(size=(R, N)))]
    tk.reset_launches()
    got = tk.lean_composite_bwd(*t, white)
    torch.cuda.synchronize()
    assert tk.launches['lean_composite_bwd'] == 1
    want = tk.lean_composite_bwd_plain(*t, white)
    assert [a.shape for a in got] == [(R * N, 3), (R * N, 1)]
    assert all(torch.isfinite(a).all() for a in got)
    assert max_rel_err(got, want) <= 1e-5


def render_chunk_moments(device, seed=0):
    """The [6, M] moments of one render chunk, as chip_smoke.py's
    chunk_inputs makes them: 8192 numpy-seeded rays from near (0, 3.2, 2.35)
    on the radius-4 orbit towards U(-1, 1)^3, radius 5e-4, 128 stratified
    samples over [2, 6] (1,048,576 points)."""
    from mipnerf_pl_tpu_torch.ops.math import cast_rays_cmajor
    from mipnerf_pl_tpu_torch.ops.sampling import sample_along_rays
    rng = np.random.default_rng(seed)
    R, N = 8192, 128
    origins = rng.normal(size=(R, 3)) * 0.1 + np.array([0.0, 3.2, 2.35])
    dirs = rng.uniform(-1.0, 1.0, size=(R, 3)) - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    def on(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    o, d, radii = on(origins), on(dirs), on(np.full((R, 1), 5e-4))
    t, _ = sample_along_rays(o, d, radii, N, on(np.full((R, 1), 2.0)),
                             on(np.full((R, 1), 6.0)), False, False, 'cone')
    return cast_rays_cmajor(t, o, d, radii).reshape(6, -1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['ragged', 'lego', 'no_integration',
                                  'render_chunk', 'far'])
def test_cuda_ipe_moments_matches_plain(cuda_device, case):
    """ipe_moments against ipe_moments_plain: max |d| <= 1e-5 (the kernel's
    sines from one exact FP64 reduction, within ~0.5 ulp of float64 sin of
    each f32 argument; the plain version's torch.sin of the same f32
    arguments), two runs bit-equal.  'ragged': 700 points, no multiple of
    a tile; 'lego': a training level, 393,216 points at degrees 0..16;
    'no_integration': the covariance rows zeroed, as disable_integration
    hands them over; 'render_chunk': one render chunk's moments (1,048,576
    points); 'far': the lego means pushed out to |mean| + 3.25, so that every
    degree-15 argument passes 105,615 (where CUDA's sinf turns slow)."""
    M, deg = {'ragged': (700, (0, 4)), 'lego': (393216, (0, 16)),
              'no_integration': (4096, (0, 16)), 'render_chunk': (0, (0, 16)),
              'far': (393216, (0, 16))}[case]
    if case == 'render_chunk':
        m = render_chunk_moments(cuda_device)
        M = m.shape[1]
    else:
        rng = np.random.default_rng(6)
        moments = np.concatenate([rng.normal(size=(3, M)) * 0.7,
                                  rng.uniform(0.0, 2e-3, size=(3, M))])
        if case == 'no_integration':
            moments[3:] = 0.0
        if case == 'far':
            moments[:3] = np.sign(moments[:3]) * (np.abs(moments[:3]) + 3.25)
            assert np.abs(moments[:3]).min() * 2.0 ** 15 > 105615
        m = torch.tensor(moments.astype(np.float32), device=cuda_device)
    tk.reset_launches()
    got = tk.ipe_moments(m, *deg)
    again = tk.ipe_moments(m, *deg)
    torch.cuda.synchronize()
    assert tk.launches['ipe_moments'] == 2
    assert got.shape == (M, 6 * (deg[1] - deg[0]))
    assert torch.isfinite(got).all()
    assert float((got - tk.ipe_moments_plain(m, *deg)).abs().max()) <= 1e-5
    torch.testing.assert_close(got, again, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('white', [True, False])
@pytest.mark.parametrize('form', ['rows', 'moments'])
@pytest.mark.parametrize('mode', ['save', 'recompute'])
def test_cuda_render_level_autograd(cuda_device, mode, form, white):
    """Training through the render-fused level on the card: the forward
    runs the mode's training forward and lean_composite, backward() runs
    lean_composite_bwd and the mode's parameter-gradient backward, and the
    gradients equal those wrappers called in that order bit for bit."""
    R, cfg = TRAIN_SHAPES['small']
    N = cfg['N']
    moments, view, delta, mids, flat = problem(R, **cfg)
    on = [torch.tensor(a, device=cuda_device)
          for a in (moments, view, delta, mids)]
    m, view, delta, mids = on
    enc = cfg['deg'] if form == 'moments' else None
    x = m if enc else tk.ipe_moments_plain(m, *cfg['deg']).contiguous()
    params = [torch.tensor(p, device=cuda_device, requires_grad=True)
              for p in flat]
    args = (N, cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'], torch.float32, (0.001, -1.0))
    rng = np.random.default_rng(9)
    cots = [torch.tensor(rng.normal(size=s).astype(np.float32),
                         device=cuda_device)
            for s in ((R, 3), (R, 1), (R, 1), (R, N))]
    tk.reset_launches()
    out = tk.fused_mlp_lean_render(x, view, delta, mids, params, *args,
                                   white, enc, mode)
    sum((o * c).sum() for o, c in zip(out, cots)).backward()
    torch.cuda.synchronize()
    fwd, bwd = (('lean_save_fwd', 'lean_param_grads') if mode == 'save'
                else ('lean_fwd', 'lean_param_grads_recompute'))
    for name in (fwd, bwd, 'lean_composite', 'lean_composite_bwd'):
        assert tk.launches[name] == 1, name
    assert tk.launches['lean_mlp'] == 0
    flat_d = [p.detach() for p in params]
    if mode == 'save':
        rgb, dens, saved = tk.lean_save_fwd(x, view, flat_d, *args,
                                            encode=enc)
    else:
        rgb, dens = tk.lean_fwd(x, view, flat_d, *args, encode=enc)
    rgbsig = torch.cat([rgb, dens], dim=-1)
    g_perray = torch.zeros((R, 8), device=cuda_device)
    g_perray[:, 0:3], g_perray[:, 3:4], g_perray[:, 4:5] = (cots[0], cots[2],
                                                            cots[1])
    g_rgb, g_sig = tk.lean_composite_bwd(rgbsig, delta, mids, g_perray,
                                         cots[3], white)
    if mode == 'save':
        want = tk.lean_param_grads(view, g_rgb, g_sig, saved, flat_d, *args)
    else:
        want = tk.lean_param_grads_recompute(x, view, g_rgb, g_sig, flat_d,
                                             *args, encode=enc)
    for p, w in zip(params, want):
        torch.testing.assert_close(p.grad, w.reshape(p.shape), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('fused', ['render', 'render_encode', 'encode',
                                   'pallas_encode'])
@pytest.mark.parametrize('backend', ['pallas_lean_save', 'pallas_lean'])
def test_cuda_fused_training_runs_the_kernels(cuda_device, backend, fused):
    """A MipNerf with fuse_render, fuse_encode or pallas_encode trains on
    the card: one loss backward launches each of its kernels once a level,
    the gradients are finite, and the loss agrees with the same model's
    plain versions on the CPU (max |d| / |ref| <= 1e-4: one f32 forward)."""
    from mipnerf_pl_tpu_torch.models.mipnerf import MipNerf
    from mipnerf_pl_tpu_torch.rays import Rays
    opts = {'render': dict(fuse_render=True),
            'render_encode': dict(fuse_render=True, fuse_encode=True),
            'encode': dict(fuse_encode=True),
            'pallas_encode': dict(pallas_encode=True)}[fused]
    model = MipNerf(num_samples=16, max_deg_point=4, deg_view=2,
                    mlp_net_depth=3, mlp_net_width=64,
                    mlp_net_width_condition=32, mlp_skip_index=2,
                    mlp_backend=backend, **opts)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((64, 1), np.float32)
    fields = (rng.normal(size=(64, 3)).astype(np.float32) * 0.1, d, d,
              ones * 0.005, ones, ones * 2.0, ones * 6.0)
    target = torch.tensor(rng.uniform(size=(64, 3)).astype(np.float32))
    losses = {}
    for dev in ('cpu', cuda_device):
        model.to(dev)
        model.zero_grad()
        rays = Rays(*(torch.tensor(f, device=dev) for f in fields))
        tk.reset_launches()
        out = model(rays, False, True)
        loss = sum(((lv.rgb - target.to(dev)) ** 2).mean() for lv in out)
        loss.backward()
        losses[str(dev)] = float(loss.detach())
    torch.cuda.synchronize()
    fwd, bwd = (('lean_save_fwd', 'lean_param_grads')
                if backend == 'pallas_lean_save'
                else ('lean_fwd', 'lean_param_grads_recompute'))
    names = [fwd, bwd] + (['lean_composite', 'lean_composite_bwd']
                          if 'render' in fused else []) \
        + (['ipe_moments'] if fused == 'pallas_encode' else [])
    for name in names:
        assert tk.launches[name] == model.num_levels, (name, tk.launches)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    want = losses['cpu']
    assert abs(losses[str(cuda_device)] - want) <= 1e-4 * abs(want)


# ---------------------------------------------------------------------------
# The classic MLP (fused_mlp, modes 'recompute' and 'save'): per-point view
# features, nd density heads, and the input cotangents dx / dview.
# ---------------------------------------------------------------------------

def classic_problem(R, cfg, nd=1, seed=0):
    """train_problem's encode rows and params for fused_mlp: per-point view
    features [M, Fv], nd density heads (the density layer redrawn nd wide)
    and head cotangents [M, 3] / [M, nd]."""
    x, _, flat, g_rgb, _ = train_problem(R, **cfg, seed=seed)
    rng = np.random.default_rng(seed + 7)
    M = x.shape[0]
    view = rng.normal(size=(M, cfg['Fv'])).astype(np.float32)
    d = 2 * cfg['net_depth']
    if nd != 1:
        flat[d] = rng.uniform(-0.2, 0.2, size=(flat[d].shape[0], nd)
                              ).astype(np.float32)
        flat[d + 1] = rng.normal(0.0, 0.1, size=(1, nd)).astype(np.float32)
    g_dens = rng.normal(size=(M, nd)).astype(np.float32)
    return x, view, flat, g_rgb, g_dens


CLASSIC_SHAPES = {
    # 296 points, ragged against the 64-point tile; the trunk ends on a
    # skip concat (density and bottleneck read [h, x], their x rows reach
    # dx).
    'small': (37, dict(SMALL, net_width=64, net_width_condition=32), 1),
    # two view layers, trunk_3 after a skip concat, two density heads.
    'view2_nd2': (29, dict(SMALL, net_depth=4, net_width=64,
                           net_depth_condition=2, net_width_condition=32,
                           N=24), 2),
    'lego': (96, LEGO, 1),
    # widths multiples of 64 (the wgmma classic forms of both dtypes), two
    # view layers, ragged, the trunk ending on a skip concat (the
    # bottleneck's dx step with the density term's x part).
    'wide_view2': (37, dict(SMALL, net_width=64, net_depth_condition=2,
                            net_width_condition=64), 1),
    # net_depth_condition 0: the rgb head reads concat(bottleneck, view);
    # ragged, the trunk ending on a skip concat; then the lego widths with
    # two density heads.
    'no_view': (37, dict(SMALL, net_width=64, net_depth_condition=0), 1),
    'no_view_lego_nd2': (96, dict(LEGO, net_depth_condition=0), 2),
}


def _classic_on(shape, device):
    R, cfg, nd = CLASSIC_SHAPES[shape]
    x, view, flat, g_rgb, g_dens = classic_problem(R, cfg, nd)
    t = [torch.tensor(a, device=device) for a in (x, view, g_rgb, g_dens)]
    return cfg, t, [torch.tensor(p, device=device) for p in flat]


def classic_calls(shape, dtype, calls=1):
    """(calls of a classic forward on the wgmma forward of `dtype`, calls of
    a classic backward whose chain, dx and dview run on the wgmma chain of
    `dtype`) at the shape: f32 lean_fwd_tf32_kernel / lean_chain_tf32_kernel
    by fwd_tf32_route / chain_tf32_route, bf16 lean_fwd_sm90_kernel /
    lean_chain_sm90_kernel by fwd_sm90_route / chain_sm90_route, each with
    the classic arguments (one density head, widths multiples of 64: the
    lego and `wide_view2` shapes; also with no view layer, `no_view`, on the
    NV forms)."""
    _, cfg, nd = CLASSIC_SHAPES[shape]
    dt = getattr(torch, dtype)
    F = 6 * (cfg['deg'][1] - cfg['deg'][0])
    W, Wv = cfg['net_width'], cfg['net_width_condition']
    depth, dcond = cfg['net_depth'], cfg['net_depth_condition']
    fwd_rule, chain_rule = (
        (tk.fwd_tf32_route, tk.chain_tf32_route) if dtype == 'float32'
        else (tk.fwd_sm90_route, tk.chain_sm90_route))
    fwd = fwd_rule(dt, F, W, Wv, depth, dcond, cfg['Fv'], nd)
    chain = chain_rule(dt, W, Wv, depth, dcond, F=F, Fv=cfg['Fv'], nd=nd,
                       skip_index=cfg['skip_index'])
    return calls if fwd else 0, calls if chain else 0


def classic_took(name, dtype):
    """(calls of wrapper `name` whose forward, whose chain with dx and dview
    ran on the wgmma kernels of `dtype`) since the last reset_launches;
    none may have run on the other dtype's."""
    tables = [(tk.tf32_routes, tk.chain_tf32_routes),
              (tk.routes, tk.chain_routes)]
    own, other = tables if dtype == 'float32' else tables[::-1]
    assert other[0].get(name, 0) == other[1].get(name, 0) == 0, name
    return own[0].get(name, 0), own[1].get(name, 0)


def _close(a, b, dtype):
    """The forward bars: f32 max |d| <= 1e-4; bf16 max |d| / max |ref| <=
    3e-2 against the f32 plain version."""
    assert torch.isfinite(a).all()
    err = float((a - b).abs().max())
    if dtype == 'float32':
        assert err <= 1e-4, err
    else:
        assert err / max(float(b.abs().max()), 1e-6) <= 3e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(CLASSIC_SHAPES))
def test_cuda_mlp_fwd_matches_plain(cuda_device, shape, dtype):
    """mlp_save_fwd against mlp_save_fwd_plain (f32): raw heads and every
    row of the stream; mlp_fwd equal to its outputs bit for bit."""
    cfg, (x, view, _, _), flat = _classic_on(shape, cuda_device)
    args = (cfg['net_depth'], cfg['net_depth_condition'], cfg['skip_index'])
    dt = getattr(torch, dtype)
    tk.reset_launches()
    rgb, dens, S = tk.mlp_save_fwd(x, view, flat, *args, dt)
    got = tk.mlp_fwd(x, view, flat, *args, dt)
    torch.cuda.synchronize()
    assert tk.launches['mlp_save_fwd'] == 1 and tk.launches['mlp_fwd'] == 1
    want = classic_calls(shape, dtype)[0]
    assert shape not in ('lego', 'wide_view2') or want == 1
    assert shape != 'no_view' or want == 1
    assert shape != 'no_view_lego_nd2' or want == 0
    assert classic_took('mlp_save_fwd', dtype)[0] \
        == classic_took('mlp_fwd', dtype)[0] == want
    # Elsewhere the library's own count of mlp_fwd_kernel.
    assert tk.mma_fwd_routes['mlp_save_fwd'] == tk.mma_fwd_routes['mlp_fwd'] \
        == 1 - want
    ref = tk.mlp_save_fwd_plain(x, view, flat, *args, torch.float32)
    M = x.shape[0]
    for a, b in ((rgb, ref[0]), (dens, ref[1]),
                 (S[:, :M].float(), ref[2][:, :M].float())):
        _close(a, b, dtype)
    assert torch.equal(got[0], rgb) and torch.equal(got[1], dens)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(CLASSIC_SHAPES))
def test_cuda_mlp_bwd_saved_matches_plain(cuda_device, shape, dtype):
    """mlp_bwd_saved against the f32 mlp_bwd_saved_plain on the same stream
    (the plain forward's, in the compute dtype): dx and dview at max |d| /
    max |ref| <= 1e-4 f32, 3e-2 bf16; the parameters at the largest leaf
    relative error, the same bars."""
    cfg, (x, view, g_rgb, g_dens), flat = _classic_on(shape, cuda_device)
    args = (cfg['net_depth'], cfg['net_depth_condition'], cfg['skip_index'])
    dt = getattr(torch, dtype)
    S = tk.mlp_save_fwd_plain(x, view, flat, *args, dt)[2]
    tk.reset_launches()
    dx, dview, grads = tk.mlp_bwd_saved(g_rgb, g_dens, S, flat, *args, dt)
    torch.cuda.synchronize()
    assert tk.launches['mlp_bwd_saved'] == 1
    assert tk.wgrad_tf32_routes['mlp_bwd_saved'] == wgrad_calls(dtype)
    want = classic_calls(shape, dtype)[1]
    assert shape not in ('lego', 'wide_view2') or want == 1
    assert shape != 'no_view' or want == 1
    assert shape != 'no_view_lego_nd2' or want == 0
    assert classic_took('mlp_bwd_saved', dtype) == (0, want)
    # Elsewhere the library's own counts of lean_grad_chain_kernel and
    # mlp_input_grads_kernel.
    assert tk.mma_chain_routes['mlp_bwd_saved'] \
        == tk.mma_input_routes['mlp_bwd_saved'] == 1 - want
    rdx, rdview, rgrads = tk.mlp_bwd_saved_plain(g_rgb, g_dens, S, flat,
                                                 *args, torch.float32)
    bar = 1e-4 if dtype == 'float32' else 3e-2
    for a, b in ((dx, rdx), (dview, rdview)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= bar * float(b.abs().max())
    assert [g.shape for g in grads] == [g.shape for g in rgrads]
    assert all(torch.isfinite(g).all() for g in grads)
    assert max_leaf_rel_err(grads, rgrads) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize('chunks', ['default', 'one_range'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(CLASSIC_SHAPES))
def test_cuda_mlp_recompute_matches_saved(cuda_device, shape, dtype, chunks,
                                          monkeypatch):
    """mlp_bwd_recompute against mlp_bwd_saved on the kernel forward's
    stream (the forward it re-runs): dx and dview bit for bit, the
    parameters at the largest leaf relative error <= 1e-5 (the f32 bias
    sums' order); two runs give the same bits."""
    if chunks == 'one_range':
        monkeypatch.setattr(tk, 'RECOMPUTE_POINTS', 1)
    cfg, (x, view, g_rgb, g_dens), flat = _classic_on(shape, cuda_device)
    args = (cfg['net_depth'], cfg['net_depth_condition'], cfg['skip_index'],
            getattr(torch, dtype))
    S = tk.mlp_save_fwd(x, view, flat, *args)[2]
    want = tk.mlp_bwd_saved(g_rgb, g_dens, S, flat, *args)
    tk.reset_launches()
    got = tk.mlp_bwd_recompute(x, view, g_rgb, g_dens, flat, *args)
    again = tk.mlp_bwd_recompute(x, view, g_rgb, g_dens, flat, *args)
    torch.cuda.synchronize()
    assert tk.launches['mlp_bwd_recompute'] == 2
    assert tk.wgrad_tf32_routes['mlp_bwd_recompute'] == wgrad_calls(dtype, 2)
    assert classic_took('mlp_bwd_recompute', dtype) \
        == classic_calls(shape, dtype, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.isfinite(g).all() for g in got[2])
    assert max_leaf_rel_err(got[2], want[2]) <= 1e-5
    for a, b in zip(got[:2] + tuple(got[2]), again[:2] + tuple(again[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_classic_plan_failure_raises(cuda_device, monkeypatch, dtype):
    """A classic shape the rules take whose plans cannot be made raises, the
    forward and the backward; neither falls back to the mma.sync kernels.
    Both at the lego shape and with no view layer (the NV forms).  f32: no
    split kernels handed to the library.  bf16: the forward's kernels and
    the chain's input-step rows (the transposed x / view rows) 2 bytes off
    the 16-byte alignment a tensor map needs."""
    for shape in ('lego', 'no_view'):
        with monkeypatch.context() as mp:
            _classic_plan_failure(cuda_device, mp, dtype, shape)


def _classic_plan_failure(cuda_device, monkeypatch, dtype, shape):
    import ctypes
    cfg, (x, view, g_rgb, g_dens), flat = _classic_on(shape, cuda_device)
    args = (cfg['net_depth'], cfg['net_depth_condition'], cfg['skip_index'],
            getattr(torch, dtype))
    assert classic_calls(shape, dtype) == (1, 1)
    S = tk.mlp_save_fwd(x, view, flat, *args)[2]
    if dtype == 'float32':
        monkeypatch.setattr(tk, 'fwd_tf32_route', lambda *a, **k: False)
        monkeypatch.setattr(tk, 'chain_tf32_route', lambda *a, **k: False)
    else:
        def off(t):
            return torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
        kernel_params, padded_t = tk._kernel_params, tk._padded_t

        def shifted(flat_params, compute_dtype):
            ws, bs, _, b_ptrs = kernel_params(flat_params, compute_dtype)
            ws = [off(w) for w in ws]
            w_ptrs = (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])
            return ws, bs, w_ptrs, b_ptrs
        monkeypatch.setattr(tk, '_kernel_params', shifted)
        monkeypatch.setattr(tk, '_padded_t', lambda *a: off(padded_t(*a)))
    tk.reset_launches()
    with pytest.raises(RuntimeError, match='mlp_save_fwd'):
        tk.mlp_save_fwd(x, view, flat, *args)
    with pytest.raises(RuntimeError, match='mlp_bwd_saved'):
        tk.mlp_bwd_saved(g_rgb, g_dens, S, flat, *args)
    with pytest.raises(RuntimeError, match='mlp_bwd_recompute'):
        tk.mlp_bwd_recompute(x, view, g_rgb, g_dens, flat, *args)
    torch.cuda.synchronize()
    assert classic_took('mlp_save_fwd', dtype) == (0, 0)
    assert classic_took('mlp_bwd_saved', dtype) == (0, 0)
    assert classic_took('mlp_bwd_recompute', dtype) == (0, 0)


@pytest.mark.cuda
def test_cuda_classic_tf32_route_matches_the_library(cuda_device):
    """The library's classic rules (C entry classic_tf32_route) and shared
    memory agree with fwd_tf32_route / chain_tf32_route and fwd_tf32_smem /
    chain_tf32_smem given the classic arguments."""
    import ctypes
    from mipnerf_pl_tpu_torch.kernels import _build
    lib = _build.load('lean_train')
    out = (ctypes.c_int * 4)()
    for F, Fv, W, Wv, depth, dcond, nd, skip in [
            (96, 27, 256, 128, 8, 1, 1, 4), (96, 27, 256, 128, 8, 1, 2, 4),
            (24, 27, 64, 32, 3, 1, 1, 2), (24, 27, 128, 64, 3, 1, 1, 2),
            (96, 27, 256, 128, 8, 0, 1, 4), (96, 27, 96, 128, 8, 1, 1, 4),
            (24, 27, 64, 64, 4, 2, 1, 2), (130, 27, 256, 128, 8, 1, 1, 4),
            (96, 27, 256, 256, 11, 1, 1, 4), (96, 27, 256, 128, 10, 1, 1, 1),
            (96, 140, 256, 128, 8, 1, 1, 4),
            # no view layer (the NV forms; Wv unused)
            (96, 27, 256, 0, 8, 0, 1, 4), (24, 27, 64, 32, 3, 0, 1, 2),
            (96, 27, 256, 0, 8, 0, 2, 4), (96, 27, 160, 0, 8, 0, 1, 4),
            (96, 27, 64, 0, 8, 0, 1, 1), (96, 27, 64, 0, 11, 0, 1, 2),
            (130, 27, 256, 0, 8, 0, 1, 4), (96, 27, 256, 0, 12, 0, 1, 4)]:
        lib.classic_tf32_route(F, Fv, W, Wv, depth, dcond, nd, skip, out)
        f32 = torch.float32
        fwd = tk.fwd_tf32_route(f32, F, W, Wv, depth, dcond, Fv, nd)
        chain = tk.chain_tf32_route(f32, W, Wv, depth, dcond, F=F, Fv=Fv,
                                    nd=nd, skip_index=skip)
        assert (bool(out[0]), bool(out[1])) == (fwd, chain), (F, Fv, W, Wv,
                                                              depth, dcond)
        assert out[2] == tk.fwd_tf32_smem(W, Wv, F, Fv)
        cg = depth * W + nd + W + dcond * Wv + 3
        assert out[3] == tk.chain_tf32_smem(W, Wv, cg,
                                            -(-(-(-F // 16) * 16) // 32) * 32)


@pytest.mark.cuda
def test_cuda_classic_sm90_route_matches_the_library(cuda_device):
    """The library's bf16 classic rules (C entry classic_sm90_route) and
    shared memory agree with fwd_sm90_route / chain_sm90_route and
    fwd_sm90_smem / chain_sm90_smem given the classic arguments."""
    import ctypes
    from mipnerf_pl_tpu_torch.kernels import _build
    lib = _build.load('lean_train')
    out = (ctypes.c_int * 4)()
    for F, Fv, W, Wv, depth, dcond, nd, skip in [
            (96, 27, 256, 128, 8, 1, 1, 4), (96, 27, 256, 128, 8, 1, 2, 4),
            (24, 27, 64, 32, 3, 1, 1, 2), (24, 27, 64, 64, 3, 2, 1, 2),
            (96, 27, 256, 128, 8, 0, 1, 4), (96, 27, 96, 128, 8, 1, 1, 4),
            (130, 27, 256, 128, 8, 1, 1, 4), (128, 128, 256, 256, 8, 1, 1, 4),
            (96, 129, 256, 128, 8, 1, 1, 4), (96, 27, 256, 128, 9, 1, 1, 4),
            (96, 27, 256, 128, 10, 1, 1, 4), (96, 27, 64, 64, 7, 1, 1, 1),
            (96, 27, 64, 64, 8, 1, 1, 1), (96, 27, 320, 128, 8, 1, 1, 4),
            # no view layer (the NV forms; Wv unused)
            (96, 27, 256, 0, 8, 0, 1, 4), (24, 27, 64, 32, 3, 0, 1, 2),
            (96, 27, 256, 0, 8, 0, 2, 4), (96, 27, 160, 0, 8, 0, 1, 4),
            (96, 27, 64, 0, 11, 0, 1, 4), (96, 27, 64, 0, 12, 0, 1, 4),
            (128, 27, 256, 0, 8, 0, 1, 4), (130, 27, 256, 0, 8, 0, 1, 4),
            (96, 129, 256, 0, 8, 0, 1, 4), (96, 27, 64, 0, 8, 0, 1, 1),
            (96, 27, 64, 0, 9, 0, 1, 1), (96, 27, 256, 0, 9, 0, 1, 4),
            (96, 27, 256, 0, 10, 0, 1, 4)]:
        lib.classic_sm90_route(F, Fv, W, Wv, depth, dcond, nd, skip, out)
        bf16 = torch.bfloat16
        fwd = tk.fwd_sm90_route(bf16, F, W, Wv, depth, dcond, Fv, nd)
        chain = tk.chain_sm90_route(bf16, W, Wv, depth, dcond, F=F, Fv=Fv,
                                    nd=nd, skip_index=skip)
        assert (bool(out[0]), bool(out[1])) == (fwd, chain), (F, Fv, W, Wv,
                                                              depth, dcond)
        Wv = Wv if dcond else 0
        assert out[2] == tk.fwd_sm90_smem(W, Wv, F, Fv)
        cg = depth * W + nd + W + dcond * Wv + 3
        assert out[3] == tk.chain_sm90_smem(cg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', ['view2_nd2', 'no_view'])
@pytest.mark.parametrize('mode', ['save', 'recompute'])
def test_cuda_fused_mlp_autograd(cuda_device, mode, shape, dtype):
    """fused_mlp's autograd Function on the card: x, view and every
    parameter receive what the mode's backward wrapper returns; with no
    view layer the forward and the chain run on the NV forms of the wgmma
    kernels of the dtype."""
    cfg, (x, view, g_rgb, g_dens), flat = _classic_on(shape, cuda_device)
    args = (cfg['net_depth'], cfg['net_depth_condition'], cfg['skip_index'],
            getattr(torch, dtype))
    leaves = [t.clone().requires_grad_(True) for t in [x, view] + flat]
    tk.reset_launches()
    rgb, dens = tk.fused_mlp(leaves[0], leaves[1], leaves[2:], *args, mode)
    ((rgb * g_rgb).sum() + (dens * g_dens).sum()).backward()
    names = (('mlp_save_fwd', 'mlp_bwd_saved') if mode == 'save'
             else ('mlp_fwd', 'mlp_bwd_recompute'))
    fwd, chain = classic_calls(shape, dtype)
    assert shape != 'no_view' or (fwd, chain) == (1, 1)
    assert classic_took(names[0], dtype)[0] == fwd
    assert classic_took(names[1], dtype) == (
        fwd if mode == 'recompute' else 0, chain)
    if mode == 'save':
        S = tk.mlp_save_fwd(x, view, flat, *args)[2]
        dx, dview, grads = tk.mlp_bwd_saved(g_rgb, g_dens, S, flat, *args)
    else:
        dx, dview, grads = tk.mlp_bwd_recompute(x, view, g_rgb, g_dens, flat,
                                                *args)
    for p, w in zip(leaves, [dx, dview] + list(grads)):
        torch.testing.assert_close(p.grad, w.reshape(p.shape), rtol=0, atol=0)
    with torch.no_grad():
        tk.reset_launches()
        out = tk.fused_mlp(x, view, flat, *args, mode)
    assert tk.launches['mlp_fwd'] == 1 and tk.launches['mlp_save_fwd'] == 0
    assert torch.equal(out[0], rgb.detach())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('backend', ['pallas', 'pallas_save'])
def test_cuda_classic_training_runs_the_kernels(cuda_device, backend, dtype):
    """A MipNerf on 'pallas' / 'pallas_save' with stop_resample_grad False
    trains on the card: one loss backward launches the backend's forward and
    backward once a level, the gradients are finite, and the loss agrees
    with the same model's plain versions on the CPU (<= 1e-4 relative in
    f32, 3e-2 in bf16).  In bf16 the view layer is 64 wide, so the forward
    and the chain with dx and dview run on the bf16 wgmma kernels' classic
    forms (asserted from the route counts)."""
    _classic_training(cuda_device, backend, dtype, 1)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('backend', ['pallas', 'pallas_save'])
def test_cuda_classic_training_without_view_layers(cuda_device, backend,
                                                   dtype):
    """The same for a model with no view layer (net_depth_condition 0, the
    rgb head on concat(bottleneck, view)): the forward and the chain with
    dx and dview run on the NV forms of the wgmma kernels of the dtype
    (asserted from the route counts)."""
    _classic_training(cuda_device, backend, dtype, 0)


def _classic_training(cuda_device, backend, dtype, depth_cond):
    from mipnerf_pl_tpu_torch.models.mipnerf import MipNerf
    from mipnerf_pl_tpu_torch.rays import Rays
    bf16 = dtype == 'bfloat16'
    model = MipNerf(num_samples=16, max_deg_point=4, deg_view=2,
                    mlp_net_depth=3, mlp_net_width=64,
                    mlp_net_depth_condition=depth_cond,
                    mlp_net_width_condition=64 if bf16 else 32,
                    mlp_skip_index=2, mlp_backend=backend,
                    stop_resample_grad=False,
                    compute_dtype=getattr(torch, dtype))
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((64, 1), np.float32)
    fields = (rng.normal(size=(64, 3)).astype(np.float32) * 0.1, d, d,
              ones * 0.005, ones, ones * 2.0, ones * 6.0)
    target = torch.tensor(rng.uniform(size=(64, 3)).astype(np.float32))
    losses = {}
    for dev in ('cpu', cuda_device):
        model.to(dev)
        model.zero_grad()
        rays = Rays(*(torch.tensor(f, device=dev) for f in fields))
        tk.reset_launches()
        out = model(rays, False, True)
        loss = sum(((lv.rgb - target.to(dev)) ** 2).mean() for lv in out)
        loss.backward()
        losses[str(dev)] = float(loss.detach())
    torch.cuda.synchronize()
    names = (('mlp_save_fwd', 'mlp_bwd_saved') if backend == 'pallas_save'
             else ('mlp_fwd', 'mlp_bwd_recompute'))
    for name in names:
        assert tk.launches[name] == model.num_levels, (name, tk.launches)
    if bf16 or not depth_cond:
        n = model.num_levels
        assert classic_took(names[0], dtype) == (n, 0)
        assert classic_took(names[1], dtype) == (
            n if names[1] == 'mlp_bwd_recompute' else 0, n)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    want = losses['cpu']
    bar = 3e-2 if bf16 else 1e-4
    assert abs(losses[str(cuda_device)] - want) <= bar * abs(want)


# name -> (points, degrees, means): 'normal' 2 N(0, 1); 'far' the same pushed
# out to |mean| + 3.25 (every degree-15 argument past 105,615, where CUDA's
# sincosf turns slow); 'wide' U(-8, 8).  odd_3_8 has an odd ladder (the
# backward's 4-byte copies, the forward's tail past its bulk store);
# wide_0_32 the longest ladder the kernels take (the backward's two tiles
# past 48 KB of shared memory).
IPE_SHAPES = {'ragged': (700, (0, 16), 'normal'),
              'ragged_2_6': (1001, (2, 6), 'normal'),
              'odd_3_8': (999, (3, 8), 'normal'),
              'one_point': (1, (0, 16), 'normal'),
              'lego': (393216, (0, 16), 'normal'),
              'far': (393216, (0, 16), 'far'),
              'high_16_32': (4097, (16, 32), 'wide'),
              'wide_0_32': (777, (0, 32), 'wide')}


def _ipe_problem(shape, zero_covs, device, seed=0):
    M, deg, spread = IPE_SHAPES[shape]
    rng = np.random.default_rng(seed)
    means = (rng.uniform(-8.0, 8.0, size=(M, 3)) if spread == 'wide'
             else 2.0 * rng.normal(size=(M, 3)))
    if spread == 'far':
        means = np.sign(means) * (np.abs(means) + 3.25)
    means = means.astype(np.float32)
    covs = rng.uniform(0.0, 1e-3, size=(M, 3)).astype(np.float32)
    if zero_covs:
        covs[:] = 0.0
    g = rng.normal(size=(M, 6 * (deg[1] - deg[0]))).astype(np.float32)
    return deg, [torch.tensor(a, device=device) for a in (means, covs, g)]


def _norm_rel(a, b):
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


@pytest.mark.cuda
@pytest.mark.parametrize('zero_covs', [False, True], ids=['covs', 'covs0'])
@pytest.mark.parametrize('shape', list(IPE_SHAPES))
def test_cuda_ipe_kernels_match_plain(cuda_device, shape, zero_covs):
    from mipnerf_pl_tpu_torch.kernels import ipe
    deg, (means, covs, g) = _ipe_problem(shape, zero_covs, cuda_device)
    tk.reset_launches()
    out = ipe.ipe_fwd(means, covs, *deg)
    assert tk.launches['ipe_fwd'] == 1 and tk.launches['ipe_bwd'] == 0
    again = ipe.ipe_fwd(means, covs, *deg)
    dm, dc = ipe.ipe_bwd(means, covs, g, *deg)
    assert tk.launches['ipe_fwd'] == 2 and tk.launches['ipe_bwd'] == 1
    dm2, dc2 = ipe.ipe_bwd(means, covs, g, *deg)
    torch.cuda.synchronize()
    assert tk.launches['ipe_fwd'] == 2 and tk.launches['ipe_bwd'] == 2
    assert out.shape == g.shape and dm.shape == dc.shape == means.shape
    assert torch.isfinite(out).all()
    assert float((out - ipe.ipe_fwd_plain(means, covs, *deg)).abs().max()) \
        <= 1e-5
    rm, rc = ipe.ipe_bwd_plain(means, covs, g, *deg)
    assert _norm_rel(dm, rm) <= 1e-5 and _norm_rel(dc, rc) <= 1e-5
    assert torch.equal(out, again)
    assert torch.equal(dm, dm2) and torch.equal(dc, dc2)


@pytest.mark.cuda
def test_cuda_ipe_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from mipnerf_pl_tpu_torch.kernels import ipe
    x = torch.zeros(8, 3, device=cuda_device)
    with pytest.raises(ValueError, match='covs'):
        ipe.ipe_fwd(x, x[:4], 0, 4)
    with pytest.raises(ValueError, match='max_deg > min_deg'):
        ipe.ipe_fwd(x, x, 4, 4)
    with pytest.raises(ValueError, match='g must be'):
        ipe.ipe_bwd(x, x, torch.zeros(8, 23, device=cuda_device), 0, 4)
    with pytest.raises(ValueError, match='at most'):
        ipe.ipe_bwd(x, x, torch.zeros(8, 6 * 33, device=cuda_device), 0, 33)
    with pytest.raises(ValueError, match='at most'):
        ipe.ipe_fwd(x, x, 0, 33)
    with pytest.raises(ValueError, match='outside'):
        ipe.ipe_fwd(x, x, -63, -60)
    with pytest.raises(ValueError, match='outside'):
        ipe.ipe_bwd(x, x, torch.zeros(8, 6 * 2, device=cuda_device), 63, 65)
    with pytest.raises(ValueError, match='covs'):
        ipe.ipe_fwd(x, x.cpu(), 0, 4)
    with pytest.raises(ValueError, match='require a gradient'):
        tk.ipe_moments(torch.zeros(6, 8, device=cuda_device,
                                   requires_grad=True), 0, 4)
    moments = torch.zeros(6, 8, device=cuda_device)
    with pytest.raises(ValueError, match='at most'):
        tk.ipe_moments(moments, 0, 33)
    with pytest.raises(ValueError, match='outside'):
        tk.ipe_moments(moments, 63, 65)


@pytest.mark.cuda
@pytest.mark.parametrize('needs', ['means', 'covs', 'both'])
def test_cuda_fused_ipe_autograd(cuda_device, needs):
    """fused_ipe through autograd on the card, a [R, N, 3] leading shape:
    the inputs that need a gradient receive what ipe_bwd returns."""
    from mipnerf_pl_tpu_torch.kernels import ipe
    deg, (means, covs, g) = _ipe_problem('ragged', False, cuda_device, 1)
    lead = (7, 100)
    m = means.reshape(*lead, 3).clone().requires_grad_(needs != 'covs')
    c = covs.reshape(*lead, 3).clone().requires_grad_(needs != 'means')
    tk.reset_launches()
    out = ipe.fused_ipe(m, c, *deg)
    assert out.shape == (*lead, 96)
    out.backward(g.reshape(*lead, 96))
    torch.cuda.synchronize()
    assert tk.launches['ipe_fwd'] == 1 and tk.launches['ipe_bwd'] == 1
    dm, dc = ipe.ipe_bwd(means, covs, g, *deg)
    if needs != 'covs':
        assert torch.equal(m.grad, dm.reshape(*lead, 3))
    else:
        assert m.grad is None
    if needs != 'means':
        assert torch.equal(c.grad, dc.reshape(*lead, 3))
    else:
        assert c.grad is None
    tk.reset_launches()
    assert not ipe.fused_ipe(means, covs, *deg).requires_grad
    assert tk.launches['ipe_fwd'] == 1 and tk.launches['ipe_bwd'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('backend,resample', [
    ('pallas_lean_save', False), ('xla', True), ('pallas_save', True)])
def test_cuda_ipe_backend_training_runs_the_kernels(cuda_device, backend,
                                                    resample):
    """A MipNerf with ipe_backend 'pallas' trains on the card: ipe_fwd once
    a level; ipe_bwd once, for the resampled level, only where the
    Gaussians carry a gradient (stop_resample_grad False); finite
    gradients, and the loss agrees with the plain versions on the CPU."""
    from mipnerf_pl_tpu_torch.models.mipnerf import MipNerf
    from mipnerf_pl_tpu_torch.rays import Rays
    model = MipNerf(num_samples=16, max_deg_point=8, deg_view=2,
                    mlp_net_depth=3, mlp_net_width=64,
                    mlp_net_width_condition=32, mlp_skip_index=2,
                    mlp_backend=backend, ipe_backend='pallas',
                    stop_resample_grad=not resample)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((64, 1), np.float32)
    fields = (rng.normal(size=(64, 3)).astype(np.float32) * 0.1, d, d,
              ones * 0.005, ones, ones * 2.0, ones * 6.0)
    target = torch.tensor(rng.uniform(size=(64, 3)).astype(np.float32))
    losses = {}
    for dev in ('cpu', cuda_device):
        model.to(dev)
        model.zero_grad()
        rays = Rays(*(torch.tensor(f, device=dev) for f in fields))
        tk.reset_launches()
        out = model(rays, False, True)
        loss = sum(((lv.rgb - target.to(dev)) ** 2).mean() for lv in out)
        loss.backward()
        losses[str(dev)] = float(loss.detach())
    torch.cuda.synchronize()
    assert tk.launches['ipe_fwd'] == model.num_levels, tk.launches
    assert tk.launches['ipe_bwd'] == (1 if resample else 0), tk.launches
    assert tk.launches['ipe_moments'] == 0
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    want = losses['cpu']
    assert abs(losses[str(cuda_device)] - want) <= 1e-4 * abs(want)


# ---------------------------------------------------------------------------
# The Megatron pair kernels (kernels/tp_lean.py) and tp_lean_forward.
# ---------------------------------------------------------------------------

# (rows, f_in, local width, output width): one column chunk; ragged rows and
# an f_in that is no multiple of 16; widths over the engines' 256 columns
# (two and three column chunks, the last 16 wide) over two staging tiles;
# the TP slice's first and later pairs at few rows; 64-column blocks that
# split unevenly between the two warpgroups.  tp_pair_wg_kernel takes
# 'ragged', 'tp_first', 'tp_later' and 'uneven'; the mma.sync kernels the
# others.
PAIR_SHAPES = {'small': (200, 24, 16, 32), 'ragged': (777, 96, 64, 128),
               'chunked': (4097, 40, 272, 528), 'wide_in': (300, 272, 64, 272),
               'tp_first': (333, 96, 512, 1024),
               'tp_later': (1000, 1024, 512, 1024),
               'uneven': (130, 40, 192, 320)}


def pair_took(name):
    """(tp_pair_wg_kernel bf16, its f32 form, mma.sync) calls of a pair
    wrapper since the last reset_launches, by the library's counts."""
    return (tk.pair_sm90_routes[name], tk.pair_tf32_routes[name],
            tk.pair_mma_routes[name])


def pair_calls(dims, dtype, calls):
    """What pair_took should read after `calls` calls at dims = (f_in, Wl,
    Wout) in dtype, by the rules of kernels/tp_lean.py."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean
    dt = getattr(torch, dtype)
    on = (tp_lean.pair_sm90_route(dt, *dims), tp_lean.pair_tf32_route(dt, *dims))
    return (calls if on[0] else 0, calls if on[1] else 0,
            0 if any(on) else calls)


def _pair_problem(shape, dtype, device, seed=0):
    """x f32, or post-ReLU in the compute dtype when f_in is the output
    width (a later pair's input); f32 parameters and cotangent."""
    return _pair_problem_at(PAIR_SHAPES[shape], device, dtype, seed)


def _pair_problem_at(dims, device, dtype=torch.float32, seed=0):
    """_pair_problem at dims = (M, f_in, Wl, Wout)."""
    M, f_in, Wl, Wout = dims
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    x = t(rng.normal(size=(M, f_in)))
    if f_in == Wout:
        x = torch.relu(x).to(dtype)
    return (x, t(rng.normal(size=(f_in, Wl)) / np.sqrt(f_in)),
            t(rng.normal(size=(1, Wl)) * 0.1),
            t(rng.normal(size=(Wl, Wout)) / np.sqrt(Wl)),
            t(rng.normal(size=(M, Wout))))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(PAIR_SHAPES))
def test_cuda_pair_kernels_match_plain(cuda_device, shape, dtype):
    """tp_pair_fwd against `_pair_plain` and tp_pair_bwd against
    `_pair_bwd_plain` (f32; the backward's on x and the panels rounded to
    the compute dtype): forward at the forward bars, dx, dWcol, dbcol and
    dWrow at ||a - b|| / ||b|| <= 1e-4 f32, 3e-2 bf16; two backward runs
    give the same bits; each call ran on the kernel the rules name
    (tp_pair_wg_kernel of the dtype, else the mma.sync kernels), by the
    library's own counts."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean
    dt = getattr(torch, dtype)
    *args, g = _pair_problem(shape, dt, cuda_device)
    tk.reset_launches()
    out = tp_lean._pair_call(*args, dt)
    got = tp_lean._pair_bwd_call(*args, g, dt)
    again = tp_lean._pair_bwd_call(*args, g, dt)
    torch.cuda.synchronize()
    assert tk.launches['tp_pair_fwd'] == 1 and tk.launches['tp_pair_bwd'] == 2
    assert tk.wgrad_tf32_routes['tp_pair_bwd'] == wgrad_calls(dtype, 2)
    dims = PAIR_SHAPES[shape][1:]
    assert pair_took('tp_pair_fwd') == pair_calls(dims, dtype, 1)
    assert pair_took('tp_pair_bwd') == pair_calls(dims, dtype, 2)
    if shape.startswith('tp_'):      # the slice's widths: the wgmma kernel
        assert pair_took('tp_pair_fwd')[2] == 0
    _close(out, tp_lean._pair_plain(*args, torch.float32), dtype)
    # The f32 backward on the operands as the kernel rounds them, so that
    # both recompute the same pre-activation and take the same ReLU mask.
    x, w_col, b_col, w_row = args
    want = tp_lean._pair_bwd_plain(x.to(dt), w_col.to(dt), b_col,
                                   w_row.to(dt), g, torch.float32)
    assert [a.shape for a in got] == [b.shape for b in want]
    assert all(torch.isfinite(a).all() for a in got)
    assert max_leaf_rel_err(got, want) <= (1e-4 if dtype == 'float32'
                                           else 3e-2)
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_pair_plan_failure_raises(cuda_device, monkeypatch, dtype):
    """A pair shape the wgmma rule takes whose plan cannot be made raises,
    the forward and the backward; neither falls back to the mma.sync
    kernels.  f32: no split weights handed to the library.  bf16: Wcol 2
    bytes off the 16-byte alignment a tensor map needs."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean
    dt = getattr(torch, dtype)
    x, w_col, b_col, w_row, g = _pair_problem('tp_first', dt, cuda_device)
    assert pair_calls(PAIR_SHAPES['tp_first'][1:], dtype, 1)[2] == 0
    if dtype == 'float32':
        monkeypatch.setattr(tp_lean, 'pair_tf32_weights',
                            lambda *a, **k: [None] * 4)
    else:
        flat = torch.cat([w_col.new_zeros(1, dtype=dt),
                          w_col.to(dt).reshape(-1)])
        w_col = flat[1:].view(w_col.shape)
        assert w_col.data_ptr() % 16 == 2
    tk.reset_launches()
    with pytest.raises(RuntimeError, match='tp_pair_fwd'):
        tp_lean._pair_call(x, w_col, b_col, w_row, dt)
    with pytest.raises(RuntimeError, match='tp_pair_bwd'):
        tp_lean._pair_bwd_call(x, w_col, b_col, w_row, g, dt)
    torch.cuda.synchronize()
    assert pair_took('tp_pair_fwd') == pair_took('tp_pair_bwd') == (0, 0, 0)
    assert tk.launches['tp_pair_fwd'] == tk.launches['tp_pair_bwd'] == 0


@pytest.mark.cuda
def test_cuda_pair_route_matches_the_library(cuda_device):
    """The library's rule (C entry tp_pair_wg_route) agrees with
    pair_sm90_route / pair_tf32_route, and its plan's shared memory (C
    entry tp_pair_wg_smem) with pair_wg_smem."""
    import ctypes
    from mipnerf_pl_tpu_torch.kernels import _build, tp_lean
    lib = _build.load('tp_pair')
    lib.tp_pair_wg_smem.restype = ctypes.c_longlong
    for dims in [(96, 512, 1024), (1024, 512, 1024), (96, 64, 256),
                 (256, 64, 256), (40, 192, 320), (1, 64, 64),
                 (24, 16, 32), (40, 272, 528), (272, 64, 272),
                 (96, 576, 1024), (96, 512, 1000), (96, 32, 64)]:
        for dt, flag in ((torch.bfloat16, 1), (torch.float32, 0)):
            rule = tp_lean.pair_sm90_route if flag else tp_lean.pair_tf32_route
            assert bool(lib.tp_pair_wg_route(*dims, flag)) == rule(dt, *dims)
    for Wl in (64, 192, 256, 384, 448, 512):
        for dt, flag in ((torch.bfloat16, 1), (torch.float32, 0)):
            stages = tp_lean.pair_wg_stages(dt, Wl)
            assert lib.tp_pair_wg_smem(Wl, flag) == tp_lean.pair_wg_smem(
                dt, Wl, stages)


@pytest.mark.cuda
def test_cuda_pair_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """A local width over 512 or off the 16-column grid and an x in another
    dtype raise ValueError naming the width; nothing falls back."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean

    def call(M, f_in, Wl, Wout, x_dtype=torch.float32):
        z = lambda *s: torch.zeros(*s, device=cuda_device)  # noqa: E731
        return tp_lean._pair_call(z(M, f_in).to(x_dtype), z(f_in, Wl),
                                  z(1, Wl), z(Wl, Wout), torch.float32)
    for bad in ((64, 32, 528, 64), (64, 32, 24, 64), (64, 32, 32, 40)):
        with pytest.raises(ValueError, match='local width'):
            call(*bad)
    with pytest.raises(ValueError, match='float32'):
        call(64, 32, 32, 64, torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mesh_shape', [(2, 2), (8, 4)])
def test_cuda_tp_lean_forward_matches_plain(cuda_device, mesh_shape, dtype):
    """tp_lean_forward on a single-process mesh on the card against the
    same function on the CPU, where the pairs take their plain versions:
    the raw heads at the forward bars (against the f32 plain run), dx,
    dview and every leaf of a seeded linear loss at ||a - b|| / ||b|| <=
    2e-3 f32 (the forwards differ by ~1e-6, which flips ReLU masks) and
    3e-2 bf16 (against the plain run in the same dtype); each pair kernel
    launches once a pair, model rank and data shard, on tp_pair_wg_kernel
    at a local width of 64 (model 2) and on the mma.sync kernels at 32."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean
    from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh
    n, m = mesh_shape
    cfg = dict(LEGO, net_depth=4, skip_index=2, net_width=128, N=16)
    arrays = train_problem(8 * n // m, **cfg)
    dt = getattr(torch, dtype)

    def run(device, compute_dtype):
        x, view, flat, g_rgb, g_dens = arrays
        leaves = [torch.tensor(a, device=device, requires_grad=True)
                  for a in [x, view] + flat]
        mesh = create_mesh(n, m, device=device)
        assert mesh.shape == {'data': n // m, 'model': m}
        rgb, dens = tp_lean.tp_lean_forward(
            leaves[0], leaves[1], leaves[2:], mesh, cfg['N'],
            cfg['net_depth'], cfg['net_depth_condition'], cfg['skip_index'],
            compute_dtype)
        loss = ((rgb * torch.tensor(g_rgb, device=device)).sum()
                + (dens * torch.tensor(g_dens, device=device)).sum())
        grads = torch.autograd.grad(loss, leaves)
        return [rgb.detach().cpu(), dens.detach().cpu()], \
            [g.cpu() for g in grads]

    tk.reset_launches()
    got_out, got_g = run(cuda_device, dt)
    torch.cuda.synchronize()
    pairs = cfg['net_depth'] // 2 * n
    assert tk.launches['tp_pair_fwd'] == pairs
    assert tk.launches['tp_pair_bwd'] == pairs
    W = cfg['net_width']     # a local width of 64 takes the wgmma kernel
    assert pair_took('tp_pair_fwd') == pair_took('tp_pair_bwd') \
        == pair_calls((W, W // m, W), dtype, pairs)
    ref_out, ref_g = run('cpu', torch.float32)
    for a, b in zip(got_out, ref_out):
        _close(a, b, dtype)
    if dtype == 'bfloat16':
        ref_g = run('cpu', dt)[1]
    assert max_leaf_rel_err(got_g, ref_g) <= (2e-3 if dtype == 'float32'
                                              else 3e-2)


# The model shapes the Megatron pairs alone do not take (tp_mlp_forward):
# an odd depth, a skip at a pair boundary (the next pair reads W + F), no
# view layer, no view directions.
TP_SHAPES = {'depth7': dict(net_depth=7, skip_index=4),
             'skip3': dict(net_depth=8, skip_index=3),
             'condition0': dict(net_depth=8, skip_index=4,
                                net_depth_condition=0),
             'no-viewdirs': dict(net_depth=8, skip_index=4, view_dim=0)}


def _settled_points(x, view, flat, depth, dcond, skip, N, margin=1e-5):
    """(the raw heads of the MLP at full width in f32, [M, 1] f32: 1 for
    the points none of whose ReLU pre-activations lies within `margin` of
    zero) for the flat layout of any shape (view None: no view
    directions), as chip_smoke.py's settled_points does for the lego one.
    Two f32 forwards that round in another order differ by ~1e-6 in a
    pre-activation and flip the ReLU masks of the points this close to
    zero, which moves a whole-MLP f32 gradient by ~4e-3 at the skip3
    shape on an H100: a cotangent zero on those points leaves the
    kernels' own error."""
    worst = torch.full((x.shape[0],), float('inf'))

    def relu_of(pre):
        torch.minimum(worst, pre.abs().amin(dim=1), out=worst)
        return torch.relu(pre)
    h = x
    for i in range(depth):
        h = relu_of(h @ flat[2 * i] + flat[2 * i + 1])
        if i % skip == 0 and i > 0:
            h = torch.cat([h, x], dim=-1)
    nd_i = 2 * depth
    density = h @ flat[nd_i] + flat[nd_i + 1]
    if view is None:
        return (h @ flat[nd_i + 2] + flat[nd_i + 3], density), \
            (worst > margin).float()[:, None]
    W = flat[nd_i + 2].shape[1]
    y = h @ flat[nd_i + 2] + flat[nd_i + 3]
    for j in range(dcond + 1):
        k, b = flat[nd_i + 4 + 2 * j], flat[nd_i + 5 + 2 * j]
        if j == 0:
            y = y @ k[:W] + (view @ k[W:] + b).repeat_interleave(N, dim=0)
        else:
            y = y @ k + b
        if j < dcond:
            y = relu_of(y)
    return (y, density), (worst > margin).float()[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TP_SHAPES))
def test_cuda_tp_mlp_forward_shapes_match_plain(cuda_device, shape, dtype):
    """tp_mlp_forward at each shape of TP_SHAPES on data 2 x model 2 of a
    single-process mesh on the card against the same function on the CPU
    (the pairs' plain versions), on train_problem's inputs and weights of
    width 128 drawn as problem() draws them: the raw heads at the forward
    bars; the gradients of x, the view features and every parameter of the
    seeded linear loss, its cotangent zero on the points whose ReLU masks
    are in doubt (`_settled_points`, whose own f32 heads equal the CPU
    run's within 1e-4), at ||a - b|| / ||b|| <= 2e-3 f32, 3e-2 bf16
    (against the CPU run in the same dtype); each pair kernel once a pair,
    rank and shard, every pair (the boundary pair's f_in = W + F too) on
    tp_pair_wg_kernel of the dtype."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean
    from mipnerf_pl_tpu_torch.models.mlp import MLP
    from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh
    kw = dict(TP_SHAPES[shape])
    view_dim = kw.pop('view_dim', 27)
    W, F, R, N = 128, 96, 64, 16
    mlp = MLP(F, view_dim, net_width=W, net_width_condition=64, **kw)
    nd, ndc = mlp.net_depth, mlp.net_depth_condition
    # train_problem's encode rows, view features and cotangents; weights
    # and biases drawn as problem() draws them, at this shape's layout.
    x, view, _, g_rgb, g_dens = train_problem(R, **dict(LEGO, net_width=W,
                                                        N=N))
    rng = np.random.default_rng(5)
    flat = []
    for k in tk.flatten_params(mlp, nd, ndc, mlp.use_viewdirs)[0::2]:
        lim = np.sqrt(6.0 / sum(k.shape))
        flat += [rng.uniform(-lim, lim, size=k.shape).astype(np.float32),
                 rng.normal(0.0, 0.1, size=(1, k.shape[1])).astype(
                     np.float32)]
    dt = getattr(torch, dtype)
    heads, keep = _settled_points(
        torch.tensor(x), torch.tensor(view) if view_dim else None,
        [torch.tensor(a) for a in flat], nd, ndc, mlp.skip_index, N)
    assert float(keep.mean()) > 0.9
    c_rgb, c_dens = g_rgb * keep.numpy(), g_dens * keep.numpy()

    def run(device, compute_dtype):
        leaves = [torch.tensor(a, device=device, requires_grad=True)
                  for a in [x] + ([view] if view_dim else []) + flat]
        n_in = 2 if view_dim else 1
        rgb, dens = tp_lean.tp_mlp_forward(
            leaves[0], leaves[1] if view_dim else None, leaves[n_in:],
            create_mesh(4, 2, device=device), N, nd, ndc, mlp.skip_index,
            compute_dtype)
        loss = ((rgb * torch.tensor(c_rgb, device=device)).sum()
                + (dens * torch.tensor(c_dens, device=device)).sum())
        grads = torch.autograd.grad(loss, leaves)
        return [rgb.detach().cpu(), dens.detach().cpu()], \
            [g.cpu() for g in grads]

    tk.reset_launches()
    got_out, got_g = run(cuda_device, dt)
    torch.cuda.synchronize()
    pairs = nd // 2 * 2 * 2
    assert tk.launches['tp_pair_fwd'] == tk.launches['tp_pair_bwd'] == pairs
    skips = set(range(mlp.skip_index, nd, mlp.skip_index))
    dims = [(F if e == 0 else W + F if e - 1 in skips else W, W // 2, W)
            for e in range(0, nd - 1, 2)]
    assert (shape == 'skip3') == any(d[0] == W + F for d in dims)
    calls = [pair_calls(d, dtype, pairs) for d in dims]
    assert calls[0][2] == 0 and len(set(calls)) == 1
    assert pair_took('tp_pair_fwd') == pair_took('tp_pair_bwd') == calls[0]
    ref_out, ref_g = run('cpu', torch.float32)
    for a, b in zip(heads, ref_out):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for a, b in zip(got_out, ref_out):
        _close(a, b, dtype)
    if dtype == 'bfloat16':
        ref_g = run('cpu', dt)[1]
    assert max_leaf_rel_err(got_g, ref_g) <= (2e-3 if dtype == 'float32'
                                              else 3e-2)


# ---------------------------------------------------------------------------
# The unbounded-360 path: the lean kernels on the 42-feature icosahedral
# encode, and the render-fused level compositing over 1/t_inv.
# ---------------------------------------------------------------------------

SHAPES_360 = {
    # the real360 config's MLP (8 x 256, view 128, N 128) on 96 rays.
    'real360': (96, LEGO),
    # widths that are multiples of 64 with the trunk ending on a skip
    # concat: the 42 x-rows of the skip layer on the ragged 296 points.
    'skip_end': TRAIN_SHAPES['skip_end'],
    # the mma.sync tile (widths the wgmma rules refuse).
    'small': TRAIN_SHAPES['small'],
}


def problem_360(R, cfg, seed=0):
    """train_problem's arrays with x [M, 42], the icosahedral IPE of
    Gaussians whose means straddle the unit sphere, trunk_0 and the skip
    layer reading 42 x-rows."""
    from mipnerf_pl_tpu_torch.ops.math import integrated_pos_enc_360
    _, view, flat, g_rgb, g_dens = train_problem(R, **cfg, seed=seed)
    rng = np.random.default_rng(seed + 5)
    M = R * cfg['N']
    means = rng.normal(size=(M, 3)) * 1.2
    covs = rng.uniform(0.0, 2e-3, size=(M, 3))
    x = integrated_pos_enc_360((torch.tensor(means, dtype=torch.float32),
                                torch.tensor(covs, dtype=torch.float32)))
    F = 6 * (cfg['deg'][1] - cfg['deg'][0])
    depth, skip = cfg['net_depth'], cfg['skip_index']
    readers = [0] + [i + 1 for i in range(depth)
                     if i % skip == 0 and i > 0]
    for li in readers:          # trunk_{li}, or the heads after the trunk
        for k in ([2 * li] if li < depth else [2 * depth, 2 * depth + 2]):
            w = flat[k]
            lim = np.sqrt(6.0 / (w.shape[0] - F + 42 + w.shape[1]))
            flat[k] = np.concatenate(
                [w[:w.shape[0] - F], rng.uniform(
                    -lim, lim, size=(42, w.shape[1])).astype(np.float32)])
    return x.numpy(), view, flat, g_rgb, g_dens


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(SHAPES_360))
def test_cuda_lean_save_at_42_features_matches_plain(cuda_device, shape,
                                                     dtype):
    """lean_save_fwd (#3) and lean_param_grads (#4a) on a 42-feature
    encode, which rounds up to the forwards' slabs: outputs, saved stream
    and every parameter gradient (trunk_0's and the skip layer's 42 x-rows
    among them) against the f32 plain versions, each call on the route its
    rule names for F = 42."""
    R, cfg = SHAPES_360[shape]
    x, view, flat, g_rgb, g_dens = (
        [torch.tensor(p, device=cuda_device) for p in a]
        if isinstance(a, list) else torch.tensor(a, device=cuda_device)
        for a in problem_360(R, cfg))
    assert x.shape[1] == 42 and flat[0].shape[0] == 42
    args = (cfg['N'], cfg['net_depth'], cfg['net_depth_condition'],
            cfg['skip_index'])
    act = (0.001, -1.0)
    dt = getattr(torch, dtype)
    widths = (42, cfg['net_width'], cfg['net_width_condition'],
              cfg['net_depth'], cfg['net_depth_condition'])
    in_saved = tk.lean_mlp_save_plain(x, view, flat, *args, dt, act)[2]
    tk.reset_launches()
    rgb, dens, saved = tk.lean_save_fwd(x, view, flat, *args, dt, act)
    grads = tk.lean_param_grads(view, g_rgb, g_dens, in_saved, flat, *args,
                                dt, act)
    torch.cuda.synchronize()
    assert tk.launches['lean_save_fwd'] == tk.launches['lean_param_grads'] \
        == 1
    assert tk.routes['lean_save_fwd'] == int(tk.fwd_sm90_route(dt, *widths))
    assert tk.tf32_routes['lean_save_fwd'] == int(
        tk.fwd_tf32_route(dt, *widths))
    assert chain_took('lean_param_grads') == chain_calls(cfg, dtype)
    assert tk.wgrad_tf32_routes['lean_param_grads'] == wgrad_calls(dtype)
    if shape != 'small':          # the wgmma forward of the dtype
        assert tk.routes['lean_save_fwd'] + tk.tf32_routes['lean_save_fwd'] \
            == 1
    ref_rgb, ref_dens, ref_saved = tk.lean_mlp_save_plain(
        x, view, flat, *args, torch.float32, act)
    ref_grads = tk.lean_param_grads_plain(view, g_rgb, g_dens, in_saved,
                                          flat, *args, torch.float32, act)
    M = x.shape[0]
    for i, (a, b) in enumerate([
            (rgb, ref_rgb), (dens, ref_dens),
            (saved[0][:, :M].float(), ref_saved[0][:, :M].float()),
            (saved[1][:, :M], ref_saved[1][:, :M])]):
        assert torch.isfinite(a).all(), i
        err = float((a - b).abs().max())
        if dtype == 'float32':
            assert err <= 1e-4, (i, err)
        else:
            assert err / max(float(b.abs().max()), 1e-6) <= 3e-2, (i, err)
    assert [g.shape for g in grads] == [tuple(p.shape) for p in flat]
    assert all(torch.isfinite(g).all() for g in grads)
    assert max_leaf_rel_err(grads, ref_grads) <= (
        1e-4 if dtype == 'float32' else 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize('fused', [True, False], ids=['render', 'lean'])
@pytest.mark.parametrize('backend', ['pallas_lean_save', 'pallas_lean'])
def test_cuda_unbounded_training_runs_the_kernels(cuda_device, backend,
                                                  fused):
    """An unbounded MipNerf (42-feature encode, t_inv samples) trains on
    the card: with fuse_render the render-fused level composites over
    1/t_inv through lean_composite / lean_composite_bwd; one loss backward
    launches each kernel once a level, the gradients are finite, and the
    loss and every gradient agree with the same model's plain versions on
    the CPU (1e-4 of the loss, leaf relative error <= 1e-3)."""
    from mipnerf_pl_tpu_torch.models.mipnerf import MipNerf
    from mipnerf_pl_tpu_torch.rays import Rays
    model = MipNerf(num_samples=16, deg_view=2, mlp_net_depth=3,
                    mlp_net_width=64, mlp_net_width_condition=64,
                    mlp_skip_index=2, mlp_backend=backend, unbounded=True,
                    fuse_render=fused)
    assert model._fused_render == fused
    rng = np.random.default_rng(1)
    o = rng.normal(size=(64, 3))
    o = (4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True))
    d = rng.uniform(-1, 1, size=(64, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((64, 1))
    fields = [a.astype(np.float32) for a in
              (o, d, d, ones * 2e-3, ones, ones * 2.5, ones * 5.5)]
    target = rng.uniform(size=(64, 3)).astype(np.float32)
    losses, grads = {}, {}
    for dev in ('cpu', cuda_device):
        model.to(dev)
        model.zero_grad()
        rays = Rays(*(torch.tensor(f, device=dev) for f in fields))
        tk.reset_launches()
        out = model(rays, False, False)
        loss = sum(((lv.rgb - torch.tensor(target, device=dev)) ** 2).mean()
                   for lv in out)
        loss.backward()
        losses[str(dev)] = float(loss.detach())
        grads[str(dev)] = [p.grad.detach().cpu() for p in model.parameters()]
    torch.cuda.synchronize()
    fwd, bwd = (('lean_save_fwd', 'lean_param_grads')
                if backend == 'pallas_lean_save'
                else ('lean_fwd', 'lean_param_grads_recompute'))
    names = [fwd, bwd] + (['lean_composite', 'lean_composite_bwd']
                          if fused else [])
    for name in names:
        assert tk.launches[name] == model.num_levels, (name, tk.launches)
    assert tk.launches['ipe_moments'] == tk.launches['ipe_fwd'] == 0
    gpu = grads[str(cuda_device)]
    assert all(torch.isfinite(g).all() for g in gpu)
    assert max_leaf_rel_err(gpu, grads['cpu']) <= 1e-3
    want = losses['cpu']
    assert abs(losses[str(cuda_device)] - want) <= 1e-4 * abs(want)
