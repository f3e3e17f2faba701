"""The port's standalone IPE (kernels/ipe.py) against the JAX package (CPU).

Inputs are numpy-seeded.  The JAX side runs `fused_ipe`'s Pallas kernels in
interpret mode; the port takes its plain versions (CPU tensors).  Both
compute the cosine half as cos(mean s), so the forward agrees to the last
f32 bits of exp / sin / cos (<= 1e-5 absolute, ~6e-8 measured) also at
covs = 0 and degrees 0..16, where the default encode's sin(y + pi/2)
differs by 7e-3, with means out to |8| (arguments past 1e5, where CUDA's
sincosf takes its slow reduction) and at degrees up to 31.  The VJP sums
16 terms that reach 1e5 (dmeans) and 1e9 (dcovs) in another order than
XLA: ||a - b|| / ||b|| <= 2e-4.

The CUDA kernels take sin and cos from their own reduction of mean 2/pi
(csrc/ipe.cu); `_mirror` repeats it in numpy with the constants read from
the source, and is held against float64 sin / cos of the exact arguments.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.kernels.ipe import fused_ipe as jfused_ipe
from mipnerf_pl_tpu.ops.math import integrated_pos_enc as jintegrated_pos_enc
from mipnerf_pl_tpu_torch.kernels import ipe
from mipnerf_pl_tpu_torch.kernels import mlp as tk
from mipnerf_pl_tpu_torch.ops.math import integrated_pos_enc

# (min_deg, max_deg, rows, covs zeroed, means U(-8, 8) instead of 2 N(0, 1))
CASES = [pytest.param(0, 16, 64, False, False, id='0-16'),
         pytest.param(0, 8, 64, False, False, id='0-8'),
         pytest.param(2, 6, 64, False, False, id='2-6'),
         pytest.param(0, 16, 700, False, False, id='ragged-700'),
         pytest.param(0, 16, 700, True, False, id='covs0-0-16'),
         pytest.param(0, 16, 64, False, True, id='far-0-16'),
         pytest.param(0, 16, 64, True, True, id='far-covs0-0-16'),
         pytest.param(16, 32, 64, True, True, id='far-covs0-16-32'),
         pytest.param(0, 32, 64, True, True, id='far-covs0-0-32')]


def _inputs(rows, zero_covs, width, seed=0, far=False):
    rng = np.random.default_rng(seed)
    means = (rng.uniform(-8, 8, size=(rows, 3)) if far
             else 2.0 * rng.normal(size=(rows, 3))).astype(np.float32)
    covs = rng.uniform(0, 1e-3, size=(rows, 3)).astype(np.float32)
    if zero_covs:
        covs = np.zeros_like(covs)
    g = rng.normal(size=(rows, width)).astype(np.float32)
    return means, covs, g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize('min_deg,max_deg,rows,zero_covs,far', CASES)
def test_ipe_fwd_plain_matches_jax(min_deg, max_deg, rows, zero_covs, far):
    means, covs, _ = _inputs(rows, zero_covs, 6 * (max_deg - min_deg),
                             far=far)
    want = np.asarray(jfused_ipe(jnp.asarray(means), jnp.asarray(covs),
                                 min_deg, max_deg, True))
    got = ipe.ipe_fwd_plain(torch.from_numpy(means), torch.from_numpy(covs),
                            min_deg, max_deg).numpy()
    assert got.shape == want.shape == (rows, 6 * (max_deg - min_deg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The wrapper and the autograd Function take the plain version on the CPU.
    for fn in (ipe.ipe_fwd, ipe.fused_ipe):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(means), torch.from_numpy(covs), min_deg,
               max_deg).numpy(), got)


@pytest.mark.parametrize('min_deg,max_deg,rows,zero_covs,far', CASES)
def test_ipe_bwd_plain_matches_jax_vjp(min_deg, max_deg, rows, zero_covs,
                                       far):
    means, covs, g = _inputs(rows, zero_covs, 6 * (max_deg - min_deg), seed=1,
                             far=far)
    jm, jc = jax.grad(
        lambda m, c: jnp.sum(jfused_ipe(m, c, min_deg, max_deg, True) * g),
        argnums=(0, 1))(jnp.asarray(means), jnp.asarray(covs))
    tm, tc, tg = (torch.from_numpy(a) for a in (means, covs, g))
    dm, dc = ipe.ipe_bwd_plain(tm, tc, tg, min_deg, max_deg)
    assert dm.shape == dc.shape == (rows, 3)
    assert _rel(dm.numpy(), jm) <= 2e-4
    assert _rel(dc.numpy(), jc) <= 2e-4
    # The VJP written out equals autograd through the plain forward.
    tm.requires_grad_(True)
    tc.requires_grad_(True)
    am, ac = torch.autograd.grad(
        ipe.ipe_fwd_plain(tm, tc, min_deg, max_deg), [tm, tc], tg)
    assert _rel(dm.numpy(), am.numpy()) <= 1e-6
    assert _rel(dc.numpy(), ac.numpy()) <= 1e-6


def test_fused_ipe_leading_shape_and_gradients():
    """Any leading shape; the backward returns a gradient only for an input
    that needs one."""
    means, covs, g = _inputs(5 * 7, False, 96, seed=2)
    shape = (5, 7, 3)
    tm = torch.from_numpy(means).reshape(shape).requires_grad_(True)
    tc = torch.from_numpy(covs).reshape(shape)
    out = ipe.fused_ipe(tm, tc)
    assert out.shape == (5, 7, 96)
    out.backward(torch.from_numpy(g).reshape(5, 7, 96))
    want_m, want_c = ipe.ipe_bwd_plain(torch.from_numpy(means),
                                       torch.from_numpy(covs),
                                       torch.from_numpy(g), 0, 16)
    np.testing.assert_array_equal(tm.grad.numpy(),
                                  want_m.reshape(shape).numpy())
    assert tc.grad is None
    grads = {}
    for need_m, need_c in ((True, False), (False, True), (True, True)):
        ctx = type('Ctx', (), dict(saved_tensors=(tm.detach(), tc),
                                   needs_input_grad=(need_m, need_c, False,
                                                     False),
                                   degrees=(0, 16)))
        grads[need_m, need_c] = ipe._FusedIpe.backward(
            ctx, torch.from_numpy(g).reshape(5, 7, 96))
    assert grads[True, False][1] is None and grads[False, True][0] is None
    assert all(x is None for gs in grads.values() for x in gs[2:])
    np.testing.assert_array_equal(grads[True, True][1].numpy(),
                                  want_c.reshape(shape).numpy())
    # No input needs a gradient: the output carries none.
    assert not ipe.fused_ipe(tm.detach(), tc).requires_grad


def test_fused_ipe_refuses_other_dtypes_and_shapes():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match='float32'):
        ipe.fused_ipe(x.double(), x.double())
    with pytest.raises(ValueError, match='float32'):
        ipe.fused_ipe(x, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match=r'\[\.\.\., 3\]'):
        ipe.fused_ipe(torch.zeros(4, 2), torch.zeros(4, 2))


def test_cosine_half_differs_from_the_default_encode():
    """With zero covariances at degrees 0..16 the kernel's cos(mean s) and
    the default encode's sin(mean s + pi/2) differ by more than 1e-3 (in
    the cosine half only), in the port as in JAX: one is not a drop-in for
    the other."""
    means, covs, _ = _inputs(700, True, 96)
    tm, tc = torch.from_numpy(means), torch.from_numpy(covs)
    kernel_form = ipe.ipe_fwd_plain(tm, tc, 0, 16)
    default_form = integrated_pos_enc((tm, tc), 0, 16)
    assert float((kernel_form[:, 48:] - default_form[:, 48:]).abs().max()) \
        > 1e-3
    np.testing.assert_allclose(kernel_form[:, :48].numpy(),
                               default_form[:, :48].numpy(), atol=1e-6)
    jdiff = np.abs(np.asarray(jfused_ipe(means, covs, 0, 16, True))
                   - np.asarray(jintegrated_pos_enc((means, covs), 0, 16)))
    assert jdiff.max() > 1e-3


def test_ipe_moments_refuses_moments_that_require_grad():
    """The moments form gives its input no gradient: it raises on moments
    that require one instead of detaching them, and still encodes with
    grad mode off or on moments that need none."""
    rng = np.random.default_rng(3)
    moments = torch.tensor(np.concatenate(
        [rng.normal(size=(3, 40)), rng.uniform(0, 1e-3, size=(3, 40))]
    ).astype(np.float32))
    want = tk.ipe_moments(moments, 0, 4)
    assert want.shape == (40, 24)
    needy = moments.clone().requires_grad_(True)
    with pytest.raises(ValueError, match='stop_resample_grad'):
        tk.ipe_moments(needy, 0, 4)
    with pytest.raises(ValueError, match='fused_ipe'):
        tk.ipe_moments(needy * 1.0, 0, 4)
    with torch.no_grad():
        torch.testing.assert_close(tk.ipe_moments(needy, 0, 4), want,
                                   rtol=0, atol=0)


# The kernels' reduction and core (csrc/ipe.cu), in numpy.
_CU = Path(ipe.__file__).resolve().parent.parent / 'csrc' / 'ipe.cu'
_NAMES = ('TWO_OVER_PI_HI', 'TWO_OVER_PI_LO', 'ROUND_MAGIC')
_HEX = r'[-+]?0x[0-9a-fA-F.]+p[-+]?\d+'


def _constants():
    """The reduction's constants and the core's coefficient lists (lowest
    power first) as csrc/ipe.cu defines them."""
    text = _CU.read_text()
    found = dict(re.findall(rf'constexpr double (\w+) = ({_HEX});', text))
    assert set(_NAMES) <= set(found), set(_NAMES) - set(found)
    out = {k: float.fromhex(found[k]) for k in _NAMES}
    for name in ('IPE_SIN', 'IPE_COS'):
        body = re.search(rf'__constant__ double {name}\[5\] = \{{([^}}]*)\}};',
                         text).group(1)
        out[name] = [float.fromhex(v) for v in re.findall(_HEX, body)]
        assert len(out[name]) == 5, name
    return out


def _two_prod(a, b):
    """(a b rounded, its exact error) of float64 arrays, as an FMA gives."""
    c = 134217729.0 * b                       # Veltkamp's split of b
    b_hi = c - (c - b)
    p1, p2 = a * b_hi, a * (b - b_hi)          # exact: a has 24 bits
    s = p1 + p2
    t = s - p1
    return s, (p1 - (s - t)) + (p2 - t)


def _mirror(means, min_deg, max_deg):
    """sin and cos [n, L] f32 of means [n] f32 times 2^deg, as the kernels'
    ipe_turns and ipe_sincos take them."""
    k = _constants()
    magic = k['ROUND_MAGIC']
    m = means.astype(np.float64)
    hi, err = _two_prod(m, np.full_like(m, k['TWO_OVER_PI_HI']))
    lo = m * k['TWO_OVER_PI_LO'] + err
    hi = hi - np.rint(hi * 2.0 ** (min_deg - 2)) * 2.0 ** (2 - min_deg)
    sins, coss = [], []
    for deg in range(min_deg, max_deg):
        scale = 2.0 ** deg
        big = hi * scale + magic
        q = big.view(np.int64)
        f = lo * scale + (hi * scale + (magic - big))
        big = f + magic
        q = q + big.view(np.int64)
        f = f + (magic - big)
        u = f * f
        ps, pc = k['IPE_SIN'][4], k['IPE_COS'][4]
        for i in range(3, -1, -1):
            ps, pc = ps * u + k['IPE_SIN'][i], pc * u + k['IPE_COS'][i]
        a, b = (f * ps).astype(np.float32), (pc * u + 1.0).astype(np.float32)
        sv, cv = np.where(q & 1, b, a), np.where(q & 1, a, b)
        sins.append(np.where(q & 2, -sv, sv))
        coss.append(np.where((q + 1) & 2, -cv, cv))
    return np.stack(sins, -1), np.stack(coss, -1)


def _ulps(got, exact):
    """|got - exact| in f32 ulps of the exact value."""
    spacing = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    return np.abs(got.astype(np.float64) - exact) / spacing


@pytest.mark.parametrize('min_deg,max_deg', [(0, 17), (0, 32), (16, 33),
                                             (2, 6), (-3, 5)])
def test_kernel_sincos_mirror_is_within_two_ulps(min_deg, max_deg):
    """sin / cos of mean 2^deg from the kernels' one reduction of mean 2/pi
    (double-double, multiples of 4 2^-min_deg off, two roundings to the
    nearest quarter turn, the FP64 core) within 2 f32 ulps of float64 sin /
    cos of the exact argument (the product is exact in float64) at every
    degree up to 32: means U(-8, 8) and 2 N(0, 1), tiny ones and zeros,
    means next to multiples of pi/2 at each degree, and means up to 1e10
    (2^deg t_lo past 1/2)."""
    rng = np.random.default_rng(7)
    near = np.array([kq * np.pi / 2 / 2.0 ** deg for kq in range(1, 40)
                     for deg in range(max(min_deg, 0), max_deg)])
    means = np.concatenate([
        rng.uniform(-8, 8, 20000), 2 * rng.normal(size=20000),
        rng.uniform(-1e-3, 1e-3, 1000), near, -near,
        [0.0, -0.0, 1e-30, 3.25, 2.0 ** 19, 1e6, -7.5e8, 1e10]
    ]).astype(np.float32)
    sins, coss = _mirror(means, min_deg, max_deg)
    arg = means.astype(np.float64)[:, None] * 2.0 ** np.arange(min_deg,
                                                              max_deg)
    assert _ulps(sins, np.sin(arg)).max() <= 2.0
    assert _ulps(coss, np.cos(arg)).max() <= 2.0
