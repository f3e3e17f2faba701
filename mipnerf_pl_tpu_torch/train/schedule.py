"""Learning-rate schedule.

Counterpart of mipnerf_pl_tpu/train/schedule.py (reference
utils/lr_schedule.py MipLRDecay): log-linear interpolation lr_init ->
lr_final over max_steps with a sin-eased warm-up scaled by lr_delay_mult
over lr_delay_steps.  Evaluated in float32, as the JAX schedule is.
"""

from __future__ import annotations

import math

import torch


def mip_lr_decay(lr_init: float, lr_final: float, max_steps: int,
                 lr_delay_steps: int, lr_delay_mult: float):
    """Return a schedule step -> learning rate (a Python float)."""

    def schedule(step) -> float:
        step = torch.tensor(float(step), dtype=torch.float32)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0, 1)
        log_lerp = torch.exp(math.log(lr_init) * (1 - t)
                             + math.log(lr_final) * t)
        return float(delay_rate * log_lerp)

    return schedule
