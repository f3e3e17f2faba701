"""Arithmetic shared by the per-layer readers in metrics/.

Each reader gets a driver's result (drivers.py) and returns a number, or
None where it finds nothing to read: no trace, or a trace with no device
operation (a run on the CPU)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

from benchmark import trace, work

HERE = Path(__file__).resolve().parent


def _device(res) -> Optional[dict]:
    tr = res.get('trace')
    return tr if tr and tr['device'] else None


def patterns(name: str):
    """benchmark/metrics/<name>.txt, one regular expression a line (#
    begins a comment), compiled into one that finds any of them."""
    lines = (HERE / 'metrics' / f'{name}.txt').read_text().splitlines()
    return re.compile('|'.join(f'(?:{p})' for p in lines
                               if p.strip() and not p.startswith('#')))


def device_ms_per_unit(res, pattern, matching: bool) -> Optional[float]:
    """Device ms a step (or frame) in the operations whose names `pattern`
    matches (matching True), or in every other one."""
    tr = _device(res)
    if tr is None:
        return None
    return (1e3 * trace.device_seconds(tr, pattern, matching)
            / res['traced_units'])


def roofline_share(res) -> Optional[float]:
    """% of device busy time the work's bound accounts for."""
    tr = _device(res)
    if tr is None:
        return None
    bound = work.bound_s(res['unit_flop'], res['unit_bytes'],
                         res['peak_flops']) * res['traced_units']
    return 100.0 * bound / trace.busy_s(tr)


def idle_share(res) -> Optional[float]:
    tr = _device(res)
    if tr is None:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / tr['window_s'])


def mfu(res) -> Optional[float]:
    """% of the peak the work's FLOP reach over the traced window's wall."""
    tr = _device(res)
    if tr is None:
        return None
    return (100.0 * res['unit_flop'] * res['traced_units']
            / (tr['window_s'] * res['peak_flops']))
