"""Image metrics: what the training loss reports.

Counterpart of mipnerf_pl_tpu/utils/metrics.py calc_mse / calc_psnr.  SSIM
and the result summaries are not ported yet.
"""

from __future__ import annotations

import torch


def calc_mse(x, y):
    return torch.mean((x - y) ** 2)


def calc_psnr(x, y):
    return -10.0 * torch.log10(calc_mse(x, y))
