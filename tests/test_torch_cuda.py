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
backward is held against its plain version on the same residuals, and the
recompute backward against the save backward on the same kernel forward
(<= 1e-5: it re-runs that forward, and only the order of the f32 bias
sums differs); lean_fwd must equal lean_save_fwd's outputs bit for bit.
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
}


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
    assert all(torch.isfinite(g).all() for g in got)
    assert max_leaf_rel_err(got, want) <= 1e-5
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('act', [(0.001, -1.0), None], ids=['act', 'raw'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', list(TRAIN_SHAPES))
def test_cuda_hybrid_matches_plain(cuda_device, shape, dtype, act):
    """lean_param_grads_hybrid against the f32 lean_param_grads_hybrid_plain
    on the same residuals (lean_hybrid_fwd's, in the compute dtype):
    largest leaf relative error <= 1e-4 f32, <= 3e-2 bf16."""
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
    assert tk.launches['lean_param_grads_hybrid'] == 1
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


@pytest.mark.cuda
def test_cuda_fuse_render_training_is_refused(cuda_device):
    """The render-fused level is forward only on the card too: a training
    forward through it raises NotImplementedError; rendering works."""
    from mipnerf_pl_tpu_torch.models.mipnerf import MipNerf
    from mipnerf_pl_tpu_torch.rays import Rays
    model = MipNerf(num_samples=8, max_deg_point=4, deg_view=2,
                    mlp_net_depth=3, mlp_net_width=16,
                    mlp_net_width_condition=16, mlp_skip_index=2,
                    mlp_backend='pallas_lean_save', fuse_render=True,
                    fuse_encode=True).to(cuda_device)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((64, 1), np.float32)
    rays = Rays(*(torch.tensor(f, device=cuda_device) for f in (
        rng.normal(size=(64, 3)).astype(np.float32) * 0.1, d, d,
        ones * 0.005, ones, ones * 2.0, ones * 6.0)))
    with pytest.raises(NotImplementedError, match='_bwd_kernel_lean_render'):
        model(rays, False, True)
    with torch.no_grad():
        out = model(rays, False, True)
    torch.cuda.synchronize()
    assert all(torch.isfinite(lv.rgb).all() for lv in out)
