"""Adam with optax's semantics, on torch.optim.Adam.

Counterpart of mipnerf_pl_tpu/train/opt.py (packed_adam) and optax.adam:
the update -lr * m_hat / (sqrt(v_hat) + eps), bias corrections with the
1-indexed count, and the learning rate of update k (0-indexed) taken from
schedule(k).  torch.optim.Adam computes the same update; the learning rate
is set before each step.  Parameters are updated in place.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def adam(params: Sequence[torch.Tensor], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> torch.optim.Adam:
    """Adam over `params` (leaf tensors); the learning rate is set per step
    by `adam_step`."""
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps)


def adam_step(opt: torch.optim.Adam, grads: Sequence[torch.Tensor],
              step: int, schedule: Callable[[int], float]) -> float:
    """One update of opt's parameters, in place, with gradients `grads`
    (in the order the parameters were given) and lr = schedule(step).
    Returns the learning rate used."""
    lr = schedule(step)
    params = [p for group in opt.param_groups for p in group['params']]
    for p, g in zip(params, grads, strict=True):
        p.grad = g
    for group in opt.param_groups:
        group['lr'] = lr
    opt.step()
    for p in params:
        p.grad = None
    return lr
