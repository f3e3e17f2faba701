"""The port's image metrics against the JAX package (CPU): the SSIM map,
its reductions and eval_errors at 1e-5 on numpy-seeded images (both are
float32 depthwise convolutions with the same window; the sums run in
another order), summarize_results string-equal."""

import os

import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.utils import metrics as jmetrics
from mipnerf_pl_tpu_torch.utils import metrics

TOL = dict(rtol=1e-5, atol=1e-5)


def _images(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize('shape', [(2, 3, 20, 24), (1, 1, 11, 11),
                                   (1, 3, 7, 9)])
def test_ssim_map_matches_jax(shape):
    a, b = _images(shape)
    got = metrics.ssim_map(a, b)
    assert torch.is_tensor(got) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmetrics.ssim_map(a, b)), **TOL)
    np.testing.assert_allclose(
        metrics.ssim_map(torch.from_numpy(a), torch.from_numpy(b),
                         window_size=5, sigma=1.0).numpy(),
        np.asarray(jmetrics.ssim_map(a, b, window_size=5, sigma=1.0)), **TOL)


@pytest.mark.parametrize('reduction', ['none', 'mean', 'sum'])
def test_ssim_reductions_match_jax(reduction):
    a, b = _images((2, 3, 16, 16), seed=1)
    got = metrics.ssim(a, b, reduction=reduction)
    want = jmetrics.ssim(a, b, reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 if reduction != 'sum' else 1e-3)
    assert float(metrics.ssim(a, a, reduction='mean')) == pytest.approx(1.0)


@pytest.mark.parametrize('layout', ['nhwc', 'nchw'])
def test_eval_errors_matches_jax(layout):
    a, b = _images((2, 18, 14, 3), seed=2)
    if layout == 'nchw':
        a, b = a.transpose(0, 3, 1, 2), b.transpose(0, 3, 1, 2)
    psnr, ssim = metrics.eval_errors(a, b)
    jpsnr, jssim = jmetrics.eval_errors(a, b)
    np.testing.assert_allclose(float(psnr), float(jpsnr), **TOL)
    np.testing.assert_allclose(float(ssim), float(jssim), **TOL)


@pytest.mark.parametrize('buckets', [1, 2])
def test_summarize_results_string_equal(tmp_path, buckets):
    rng = np.random.default_rng(3)
    for scene in ('a', 'b'):
        d = tmp_path / 'test' / scene
        os.makedirs(d)
        (d / 'psnrs.txt').write_text(
            ' '.join(str(v) for v in rng.uniform(20, 35, size=4)))
        (d / 'ssims.txt').write_text(
            ' '.join(str(v) for v in rng.uniform(0.8, 0.99, size=4)))
    got = metrics.summarize_results(str(tmp_path), ['a', 'b'], buckets)
    assert got == jmetrics.summarize_results(str(tmp_path), ['a', 'b'],
                                             buckets)
    assert len(got.split(' | ')) == 3
