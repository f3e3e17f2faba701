"""The numbers that decide `correct`, and their limits.

Training (the first steps of the timed call, against the reference's):
  loss_gap    the largest |loss - reference loss| / |reference loss| over
              the steps compared
  grad_gap    the first step's gradients as the optimizer got them: over
              the leaves, the largest | ||g|| - ||g_ref|| | / max(||g_ref||,
              the median leaf's ||g_ref||)
  update_gap  the same of each leaf's change after the steps, of the
              median leaf, leaving out the leaves whose reference gradient
              is under a thousandth of the median leaf's (they move by
              round-off alone under Adam)
  update_gap_worst
              the same of the worst leaf: it swings from seed to seed with
              a bias or two, whose Adam updates over three steps amplify
              the round-off of both sides' float32 sums where their
              gradients nearly cancel (against float64, the program's
              worst leaf reads as the float32 reference's; PERF.md), so
              its limit catches a leaf left unmoved or moved twice, and
              the median leaf's the rest
Rendering (every frame of the window, at pixels drawn from the seed):
  rgb_gap     the largest |value - reference| over the coarse and fine
              colours and the accumulated opacity
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in leaves.items()}


def leaf_gaps(side: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leave_out=()) -> Dict[str, float]:
    """Each leaf's | ||side|| - ||ref|| | over max(||ref||, the median
    leaf's ||ref||)."""
    ns, nr = _norms(side), _norms(ref)
    median = statistics.median(nr.values())
    return {k: abs(ns[k] - nr[k]) / max(nr[k], median, 1e-30)
            for k in nr if k not in leave_out}


def quiet_leaves(ref_grad: Dict[str, torch.Tensor]) -> list:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's."""
    nr = _norms(ref_grad)
    median = statistics.median(nr.values())
    return sorted(k for k, v in nr.items() if v < 1e-3 * median)


def train_numbers(side: dict, ref: dict, params0: dict) -> Dict[str, float]:
    """side and ref: {'loss': [...], 'grad': {leaf: first gradient},
    'params': {leaf: after the steps}}."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(side['loss'], ref['loss'], strict=True))
    grad, update = train_leaf_gaps(side, ref, params0)
    return {'loss_gap': loss_gap, 'grad_gap': max(grad.values()),
            'update_gap': statistics.median(update.values()),
            'update_gap_worst': max(update.values())}


def train_leaf_gaps(side: dict, ref: dict, params0: dict):
    """({leaf: gradient gap}, {leaf: change gap}) of train_numbers."""
    return (leaf_gaps(side['grad'], ref['grad']),
            leaf_gaps({k: side['params'][k] - params0[k] for k in params0},
                      {k: ref['params'][k] - params0[k] for k in params0},
                      quiet_leaves(ref['grad'])))


def render_numbers(side: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {'rgb_gap': max(float((side[k].double() - ref[k].double())
                                 .abs().max()) for k in ref)}


def checks(numbers: Dict[str, float], limits: Dict[str, Optional[float]]):
    """-> (correct, {name: {'value', 'limit'}}) over the numbers that have a
    limit; a number that is not finite fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        if limit is None:
            continue
        out[name] = {'value': value, 'limit': limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out
