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
The bf16 backward of a channel-major stream runs on wgmma (the chain where
the widths are multiples of 64: the `wide` and lego shapes), under the
same bars, two lean_param_grads runs bit for bit.
The moments input form is held against the rows form on the plain decode
of the same moments (<= 1e-5 f32), lean_composite_bwd and ipe_moments
against their plain versions (<= 1e-5), and training through the
render-fused level against its wrappers called in order (bit for bit).
fused_mlp's kernels (the `pallas` / `pallas_save` backends) take the same
bars, dx and dview with the parameters; its recompute backward equals the
saved one on dx and dview bit for bit; they also run a model with no view
layer (net_depth_condition 0).  The Megatron pair kernels (tp_pair_fwd,
tp_pair_bwd: kernels/tp_lean.py) are held against their plain versions at
small, ragged and chunked-width shapes at the same bars (the gradients at
||a - b|| / ||b||), two backward runs bit for bit, and tp_lean_forward on a
single-process mesh on the card against the same function on the CPU.  The
standalone IPE (ipe_fwd,
ipe_bwd: `nerf.ipe_backend: pallas`) is held against its plain versions,
max |d| <= 1e-5 forward and ||a - b|| / ||b|| <= 1e-5 for dmeans and dcovs
(which reach 1e5 and 1e9), two runs bit for bit, also at zero covariances.
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
    # widths that are multiples of 64 (the bf16 chain on wgmma), two view
    # layers, 696 points: the last 128-point tile of the chain is half
    # past the padded stream.
    'wide': (29, dict(SMALL, net_depth=4, net_width=128,
                      net_depth_condition=2, net_width_condition=64, N=24)),
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
    decode: f32 max |d| / max |ref| <= 1e-5 (both decodes are libm expf /
    sinf of the same products; the saved X rows are the decoded encode);
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


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['ragged', 'lego', 'no_integration'])
def test_cuda_ipe_moments_matches_plain(cuda_device, case):
    """ipe_moments against ipe_moments_plain: max |d| <= 1e-5 (both are
    libm expf / sinf of the same f32 products).  'ragged': 700 points, no
    multiple of a block; 'lego': a training level, 393,216 points at
    degrees 0..16; 'no_integration': the covariance rows zeroed, as
    disable_integration hands them over."""
    M, deg = {'ragged': (700, (0, 4)), 'lego': (393216, (0, 16)),
              'no_integration': (4096, (0, 16))}[case]
    rng = np.random.default_rng(6)
    moments = np.concatenate([rng.normal(size=(3, M)) * 0.7,
                              rng.uniform(0.0, 2e-3, size=(3, M))])
    if case == 'no_integration':
        moments[3:] = 0.0
    m = torch.tensor(moments.astype(np.float32), device=cuda_device)
    tk.reset_launches()
    got = tk.ipe_moments(m, *deg)
    torch.cuda.synchronize()
    assert tk.launches['ipe_moments'] == 1
    assert got.shape == (M, 6 * (deg[1] - deg[0]))
    assert torch.isfinite(got).all()
    assert float((got - tk.ipe_moments_plain(m, *deg)).abs().max()) <= 1e-5


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
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.isfinite(g).all() for g in got[2])
    assert max_leaf_rel_err(got[2], want[2]) <= 1e-5
    for a, b in zip(got[:2] + tuple(got[2]), again[:2] + tuple(again[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', ['view2_nd2', 'no_view'])
@pytest.mark.parametrize('mode', ['save', 'recompute'])
def test_cuda_fused_mlp_autograd(cuda_device, mode, shape):
    """fused_mlp's autograd Function on the card: x, view and every
    parameter receive what the mode's backward wrapper returns."""
    cfg, (x, view, g_rgb, g_dens), flat = _classic_on(shape, cuda_device)
    args = (cfg['net_depth'], cfg['net_depth_condition'], cfg['skip_index'],
            torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in [x, view] + flat]
    rgb, dens = tk.fused_mlp(leaves[0], leaves[1], leaves[2:], *args, mode)
    ((rgb * g_rgb).sum() + (dens * g_dens).sum()).backward()
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
@pytest.mark.parametrize('backend', ['pallas', 'pallas_save'])
def test_cuda_classic_training_runs_the_kernels(cuda_device, backend):
    """A MipNerf on 'pallas' / 'pallas_save' with stop_resample_grad False
    trains on the card: one loss backward launches the backend's forward and
    backward once a level, the gradients are finite, and the loss agrees
    with the same model's plain versions on the CPU (<= 1e-4 relative)."""
    from mipnerf_pl_tpu_torch.models.mipnerf import MipNerf
    from mipnerf_pl_tpu_torch.rays import Rays
    model = MipNerf(num_samples=16, max_deg_point=4, deg_view=2,
                    mlp_net_depth=3, mlp_net_width=64,
                    mlp_net_width_condition=32, mlp_skip_index=2,
                    mlp_backend=backend, stop_resample_grad=False)
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
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    want = losses['cpu']
    assert abs(losses[str(cuda_device)] - want) <= 1e-4 * abs(want)


IPE_SHAPES = {'ragged': (700, (0, 16)), 'ragged_2_6': (1001, (2, 6)),
              'one_point': (1, (0, 16)), 'lego': (393216, (0, 16))}


def _ipe_problem(shape, zero_covs, device, seed=0):
    M, deg = IPE_SHAPES[shape]
    rng = np.random.default_rng(seed)
    means = (2.0 * rng.normal(size=(M, 3))).astype(np.float32)
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
    again = ipe.ipe_fwd(means, covs, *deg)
    dm, dc = ipe.ipe_bwd(means, covs, g, *deg)
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
    with pytest.raises(ValueError, match='covs'):
        ipe.ipe_fwd(x, x.cpu(), 0, 4)
    with pytest.raises(ValueError, match='require a gradient'):
        tk.ipe_moments(torch.zeros(6, 8, device=cuda_device,
                                   requires_grad=True), 0, 4)


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
# (two and three column chunks, the last 16 wide) over two staging tiles.
PAIR_SHAPES = {'small': (200, 24, 16, 32), 'ragged': (777, 96, 64, 128),
               'chunked': (4097, 40, 272, 528), 'wide_in': (300, 272, 64, 272)}


def _pair_problem(shape, dtype, device, seed=0):
    """x f32, or post-ReLU in the compute dtype when f_in is the output
    width (a later pair's input); f32 parameters and cotangent."""
    M, f_in, Wl, Wout = PAIR_SHAPES[shape]
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
    give the same bits."""
    from mipnerf_pl_tpu_torch.kernels import tp_lean
    dt = getattr(torch, dtype)
    *args, g = _pair_problem(shape, dt, cuda_device)
    tk.reset_launches()
    out = tp_lean._pair_call(*args, dt)
    got = tp_lean._pair_bwd_call(*args, g, dt)
    again = tp_lean._pair_bwd_call(*args, g, dt)
    torch.cuda.synchronize()
    assert tk.launches['tp_pair_fwd'] == 1 and tk.launches['tp_pair_bwd'] == 2
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
    launches once a pair, model rank and data shard."""
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
    ref_out, ref_g = run('cpu', torch.float32)
    for a, b in zip(got_out, ref_out):
        _close(a, b, dtype)
    if dtype == 'bfloat16':
        ref_g = run('cpu', dt)[1]
    assert max_leaf_rel_err(got_g, ref_g) <= (2e-3 if dtype == 'float32'
                                              else 3e-2)
