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
(csrc/ipe_core.cuh); `_mirror` repeats it in numpy with the constants read
from the source, and is held against float64 sin / cos of the exact
arguments: the cosine itself (ipe_fwd), and the moments form's cosine half
sin(fl32(y + fl32(pi / 2))) (ipe_moments and every lean kernel's decode).
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


# The kernels' reduction and core (csrc/ipe_core.cuh), in numpy.
_CU = Path(ipe.__file__).resolve().parent.parent / 'csrc' / 'ipe_core.cuh'
_NAMES = ('TWO_OVER_PI_HI', 'TWO_OVER_PI_LO', 'TWO_OVER_PI_A',
          'TWO_OVER_PI_B', 'ROUND_MAGIC')
_HEX = r'[-+]?0x[0-9a-fA-F.]+p[-+]?\d+'
_HALF_PI_F32 = np.float32(np.pi / 2)


def _constants():
    """The reduction's constants and the cores' coefficient lists (lowest
    power first) as csrc/ipe_core.cuh defines them."""
    text = _CU.read_text()
    found = dict(re.findall(rf'constexpr double (\w+) = ({_HEX});', text))
    assert set(_NAMES) <= set(found), set(_NAMES) - set(found)
    out = {k: float.fromhex(found[k]) for k in _NAMES}
    assert out['TWO_OVER_PI_A'] + out['TWO_OVER_PI_B'] == \
        out['TWO_OVER_PI_HI']
    for name, n in (('IPE_SIN', 5), ('IPE_COS', 5), ('IPE_SINE', 6)):
        body = re.search(rf'__constant__ double {name}\[{n}\] = '
                         rf'\{{([^}}]*)\}};', text).group(1)
        out[name] = [float.fromhex(v) for v in re.findall(_HEX, body)]
        assert len(out[name]) == n, name
    half_pi = re.search(r'constexpr float HALF_PI_F32 = ([-+]?0x[0-9a-fA-F.]+'
                        r'p[-+]?\d+)f;', text).group(1)
    assert np.float32(float.fromhex(half_pi)) == _HALF_PI_F32
    return out


def _split(x):
    """Veltkamp's split of float64 x into two halves of 26 bits."""
    c = 134217729.0 * x
    hi = c - (c - x)
    return hi, x - hi


def _two_prod(a, b):
    """(a b rounded, its exact error) of float64 arrays, as an FMA gives
    (Dekker's product)."""
    p = a * b
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    return p, ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2


def _round(f, q, magic):
    """ipe_round: f's nearest integer added to q, f left as the rest."""
    big = f + magic
    return f + (magic - big), q + big.view(np.int64)


def _core(f, q, k):
    """sin and cos of pi (q + f) / 2 in f32, as ipe_sincos takes them."""
    u = f * f
    ps, pc = k['IPE_SIN'][4], k['IPE_COS'][4]
    for i in range(3, -1, -1):
        ps, pc = ps * u + k['IPE_SIN'][i], pc * u + k['IPE_COS'][i]
    a, b = (f * ps).astype(np.float32), (pc * u + 1.0).astype(np.float32)
    sv, cv = np.where(q & 1, b, a), np.where(q & 1, a, b)
    return np.where(q & 2, -sv, sv), np.where((q + 1) & 2, -cv, cv)


def _sine(f, q, k):
    """sin(pi (q + f) / 2) in f32, as ipe_sin takes it: one odd polynomial
    in x = f, or 1 - |f| for odd q."""
    x = np.where(q & 1, 1.0 - np.abs(f), f)
    u = x * x
    p = k['IPE_SINE'][5]
    for i in range(4, -1, -1):
        p = p * u + k['IPE_SINE'][i]
    v = (x * p).astype(np.float32)
    return np.where(q & 2, -v, v)


def _mirror(means, min_deg, max_deg, moments=False):
    """Pairs [n, L] f32 of means [n] f32 at degrees min_deg..max_deg - 1, as
    the kernels' ipe_turns with ipe_sincos (sin and cos of y = mean 2^deg)
    or, with moments, ipe_moments_pair (sin y and sin z, z = fl32(y +
    fl32(pi / 2)), the default encode's cosine half, each from ipe_sin)
    take them."""
    k = _constants()
    magic = k['ROUND_MAGIC']
    m = means.astype(np.float64)
    hi, err = _two_prod(m, np.full_like(m, k['TWO_OVER_PI_HI']))
    lo = m * k['TWO_OVER_PI_LO'] + err
    hi = hi - np.rint(hi * 2.0 ** (min_deg - 2)) * 2.0 ** (2 - min_deg)
    first, second = [], []
    for deg in range(min_deg, max_deg):
        scale = 2.0 ** deg
        big = hi * scale + magic
        q0 = big.view(np.int64)
        f0 = hi * scale + (magic - big)
        fs, qs = _round(lo * scale + f0, q0, magic)
        if not moments:
            sn, cs = _core(fs, qs, k)
            first.append(sn)
            second.append(cs)
            continue
        first.append(_sine(fs, qs, k))
        # z 2/pi = 2^deg t + d 2/pi, d = z - y: f0 plus d A rounded to a
        # quarter turn, then the tails 2^deg t_lo and d (B + 2/pi's tail).
        y = means * np.float32(scale)
        d = (y + _HALF_PI_F32).astype(np.float64) - y.astype(np.float64)
        dq, q = _round(d * k['TWO_OVER_PI_A'], q0, magic)
        fc = (lo * scale + (f0 + dq)) + (d * k['TWO_OVER_PI_B']
                                        + d * k['TWO_OVER_PI_LO'])
        second.append(_sine(*_round(fc, q, magic), k))
    return np.stack(first, -1), np.stack(second, -1)


def _ulps(got, exact):
    """|got - exact| in f32 ulps of the exact value."""
    spacing = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    return np.abs(got.astype(np.float64) - exact) / spacing


def _mirror_means(min_deg, max_deg):
    """Means U(-8, 8) and 2 N(0, 1), tiny ones and zeros, means next to
    multiples of pi/2 at each degree, and means up to 1e10 (2^deg t_lo past
    1/2)."""
    rng = np.random.default_rng(7)
    near = np.array([kq * np.pi / 2 / 2.0 ** deg for kq in range(1, 40)
                     for deg in range(max(min_deg, 0), max_deg)])
    return np.concatenate([
        rng.uniform(-8, 8, 20000), 2 * rng.normal(size=20000),
        rng.uniform(-1e-3, 1e-3, 1000), near, -near,
        [0.0, -0.0, 1e-30, 3.25, 2.0 ** 19, 1e6, -7.5e8, 1e10]
    ]).astype(np.float32)


MIRROR_DEGREES = [(0, 17), (0, 32), (16, 33), (2, 6), (-3, 5)]


@pytest.mark.parametrize('min_deg,max_deg', MIRROR_DEGREES)
def test_kernel_sincos_mirror_is_within_two_ulps(min_deg, max_deg):
    """sin / cos of mean 2^deg from the kernels' one reduction of mean 2/pi
    (double-double, multiples of 4 2^-min_deg off, two roundings to the
    nearest quarter turn, the FP64 core) within 2 f32 ulps of float64 sin /
    cos of the exact argument (the product is exact in float64) at every
    degree up to 32, on _mirror_means."""
    means = _mirror_means(min_deg, max_deg)
    sins, coss = _mirror(means, min_deg, max_deg)
    arg = means.astype(np.float64)[:, None] * 2.0 ** np.arange(min_deg,
                                                              max_deg)
    assert _ulps(sins, np.sin(arg)).max() <= 2.0
    assert _ulps(coss, np.cos(arg)).max() <= 2.0


def _rounded_sum(means, min_deg, max_deg):
    """float64 of y = mean 2^deg and of z = fl32(y + fl32(pi / 2)), [n, L]."""
    y = means[:, None] * (2.0 ** np.arange(min_deg, max_deg)).astype(
        np.float32)
    return y.astype(np.float64), (y + _HALF_PI_F32).astype(np.float64)


@pytest.mark.parametrize('min_deg,max_deg', MIRROR_DEGREES)
def test_kernel_moments_mirror_is_within_two_ulps(min_deg, max_deg):
    """The moments form (ipe_moments_pair: ipe_moments and every lean
    kernel's in-tile decode): its sine half within 2 f32 ulps of float64
    sin(y), its cosine half within 2 ulps of float64 sin(z), z = fl32(y +
    fl32(pi / 2)) as the default encode's f32 formula rounds it, from the
    same reduction of mean 2/pi (z 2/pi = 2^deg t + (z - y) 2/pi) and one
    odd polynomial for each sine, at every
    degree up to 32 on _mirror_means; and the mirror's damped pairs equal
    ipe_moments_plain's (torch.sin on the CPU) to 1e-6 at degrees 0..16."""
    means = _mirror_means(min_deg, max_deg)
    sins, sinz = _mirror(means, min_deg, max_deg, moments=True)
    y, z = _rounded_sum(means, min_deg, max_deg)
    assert _ulps(sins, np.sin(y)).max() <= 2.0
    assert _ulps(sinz, np.sin(z)).max() <= 2.0
    if (min_deg, max_deg) == (0, 17):
        small = means[np.abs(means) < 8][:2000]
        covs = np.random.default_rng(8).uniform(0, 1e-3, (3, 2000)).astype(
            np.float32)
        moments = np.concatenate([np.stack([small] * 3), covs])
        plain = tk.ipe_moments_plain(torch.from_numpy(moments), 0, 16).numpy()
        s, c = _mirror(small, 0, 16, moments=True)
        for dim in range(3):
            damp = np.exp(-0.5 * (covs[dim][:, None].astype(np.float64)
                                  * 4.0 ** np.arange(16)))
            np.testing.assert_allclose(plain[:, dim:48:3], damp * s,
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(plain[:, 48 + dim::3], damp * c,
                                       rtol=0, atol=1e-6)


def test_kernel_moments_mirror_takes_the_sum_as_rounded():
    """Where fl32(y + fl32(pi / 2)) rounds away from y + pi / 2 by a whole
    ulp of y (|y| in [2^24, 2^25): ulp 2, so z = y + 2; past 2^25 z = y),
    the cosine half is sin(z) of that rounded sum, within 2 ulps, and not
    cos(y), from which it differs by up to ~0.4."""
    rng = np.random.default_rng(9)
    means = np.concatenate([
        np.float32(2.0 ** 24) + 2 * rng.integers(0, 2 ** 23, 500),
        np.float32(2.0 ** 25) + 4 * rng.integers(0, 2 ** 23, 500),
    ]).astype(np.float32)
    y, z = _rounded_sum(means, 0, 1)
    assert np.all(z[:500] - y[:500] == 2.0) and np.all(z[500:] == y[500:])
    _, sinz = _mirror(means, 0, 1, moments=True)
    assert _ulps(sinz, np.sin(z)).max() <= 2.0
    assert np.abs(sinz[:500, 0] - np.cos(y[:500, 0])).max() > 0.1
