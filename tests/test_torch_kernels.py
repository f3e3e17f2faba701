"""The fused lean-render level kernels of the PyTorch port.

On the CPU: the plain PyTorch version (what each wrapper runs for CPU
tensors) against the JAX package's `fused_mlp_lean_render`, which runs its
Pallas kernel in interpret mode here, on the same numpy-seeded moments,
view features, delta/mids planes and parameters.  f32 tolerance 1e-5: the
JAX kernel decodes the IPE with ~1e-6-accurate polynomial exp/sin and sums
the transmittance with a triangular matmul, the port with libm and cumsum.

The CUDA kernels against their plain versions on the card are in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.kernels import mlp as jk
from mipnerf_pl_tpu_torch.kernels import mlp as tk
from tests.test_torch_cuda import SMALL, problem as _problem, run_port



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
    with pytest.raises(ValueError):      # the kernels decode moments only
        tk.fused_mlp_lean_render(None, None, None, None, [], 8, 3, 1, 2)


def test_param_order_matches_jax():
    assert tk.param_order(8, 1) == jk.param_order(8, 1)
    assert tk.param_order(3, 2) == jk.param_order(3, 2)
