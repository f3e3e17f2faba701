"""Image quality metrics: PSNR, Gaussian-window SSIM, result summaries.

Counterpart of mipnerf_pl_tpu/utils/metrics.py: calc_mse / calc_psnr, the
SSIM of window 11 and sigma 1.5 with zero padding (k - 1) // 2 as a
depthwise `conv2d(groups=C)` in float32, eval_errors, and
summarize_results with the same psnrs.txt / ssims.txt artifact format and
the paper's "average" exp(mean(log([mse, sqrt(1 - ssim)]))).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def calc_mse(x, y):
    return torch.mean((x - y) ** 2)


def calc_psnr(x, y):
    return -10.0 * torch.log10(calc_mse(x, y))


def _gaussian_kernel2d(ksize: int, sigma: float) -> np.ndarray:
    xs = np.arange(ksize, dtype=np.float64)
    g = np.exp(-((xs - ksize // 2) ** 2) / (2.0 * sigma ** 2))
    k1 = (g / g.sum()).astype(np.float32)
    return np.outer(k1, k1)


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise zero-padded convolution of an NCHW image."""
    c = img.shape[1]
    pad = (kernel.shape[0] - 1) // 2
    return F.conv2d(img, kernel.expand(c, 1, *kernel.shape), padding=pad,
                    groups=c)


def ssim_map(img1, img2, window_size: int = 11, max_val: float = 1.0,
             sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM map for NCHW float images in [0, max_val] (tensors
    or arrays; computed in float32 on img1's device)."""
    img1 = torch.as_tensor(img1, dtype=torch.float32)
    img2 = torch.as_tensor(img2, dtype=torch.float32, device=img1.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kernel = torch.as_tensor(_gaussian_kernel2d(window_size, sigma),
                             device=img1.device)
    # A float32 convolution on a card runs in TF32 unless told otherwise
    # (about three digits); the metric is computed in full float32.
    with torch.backends.cudnn.flags(allow_tf32=False):
        mu1 = _filter2d(img1, kernel)
        mu2 = _filter2d(img2, kernel)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
        sigma1_sq = _filter2d(img1 * img1, kernel) - mu1_sq
        sigma2_sq = _filter2d(img2 * img2, kernel) - mu2_sq
        sigma12 = _filter2d(img1 * img2, kernel) - mu1_mu2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
           ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1, img2, window_size: int = 11, reduction: str = 'none',
         max_val: float = 1.0):
    """SSIM between NCHW images (reduction: none | mean | sum)."""
    loss = ssim_map(img1, img2, window_size, max_val)
    if reduction == 'mean':
        return torch.mean(loss)
    if reduction == 'sum':
        return torch.sum(loss)
    return loss


def eval_errors(pred_color, batch_pixels):
    """(PSNR, SSIM-mean) for NHWC (or NCHW) image batches."""
    pred_color = torch.as_tensor(pred_color, dtype=torch.float32)
    batch_pixels = torch.as_tensor(batch_pixels, dtype=torch.float32,
                                   device=pred_color.device)
    psnr_val = calc_psnr(pred_color, batch_pixels)
    if pred_color.shape[-1] == 3 and batch_pixels.shape[-1] == 3:
        pred_color = pred_color.permute(0, 3, 1, 2)
        batch_pixels = batch_pixels.permute(0, 3, 1, 2)
    ssim_val = ssim(pred_color, batch_pixels, window_size=11,
                    reduction='mean')
    return psnr_val, ssim_val


def summarize_results(folder: str, scene_names, num_buckets: int) -> str:
    """Aggregate psnrs.txt / ssims.txt across scenes into the
    'PSNR | SSIM | Average' line: per-scale PSNR means, per-scale SSIM
    means, then the geometric mean of the mean MSE (from PSNR) and the mean
    sqrt(1 - SSIM), all at 4 decimals, ' | '-separated."""
    def per_scale_means(metric: str) -> np.ndarray:
        rows = []
        for scene in scene_names:
            path = os.path.join(folder, 'test', scene, f'{metric}.txt')
            vals = np.atleast_1d(np.loadtxt(path))
            rows.append(vals.reshape(-1, num_buckets).mean(axis=0))
        return np.mean(rows, axis=0)

    psnr = per_scale_means('psnrs')
    ssim_v = per_scale_means('ssims')

    mse = 10.0 ** (-psnr.mean() / 10.0)
    dssim = np.sqrt(1.0 - ssim_v.mean())
    overall = np.sqrt(mse * dssim)   # exp(mean(log([mse, dssim])))

    fmt = lambda row: ' '.join(f'{x:0.4f}' for x in row)  # noqa: E731
    return ' | '.join([fmt(psnr), fmt(ssim_v), f'{overall:0.4f}'])
