"""The drivers a traffic mix names, one module each
(`benchmark/drivers/<name>.py`, found by the mix's 'driver'), and what
they share.

A driver's `run(config, mix, seed, seconds, traced, devices, t_start,
extra)` builds the cell's program from the configuration and the seed on
`devices` (one a chip the cell asks for), warms up every shape it will
time (set-up), measures for `seconds`, optionally traces a short tail of
the same work, frees the program, and then checks what the timed path
produced against the plain reference.  It returns a dict:

  setup_s, attempted, failed     as the result line has them
  end_to_end                     {metric: value} of the cell's end-to-end
                                 metrics, setup_s among them
  window                         the measured window's host spans
  trace                          the traced tail (trace.profile) or None
  traced_units, unit_flop, unit_bytes, peak_flops
                                 what the per-layer readers divide by
  peak_bytes                     the peak on the fullest chip
  numbers, readings              the numbers compared (limits:
                                 config['limits'][driver]) and the
                                 calibration's witnesses (extra)

A new kind of traffic is a new driver module; a new mix of an existing
kind is a JSON file in benchmark/mixes/.
"""

from __future__ import annotations

import sys
import time

import torch


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == 'cuda':
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


class Phases:
    """Seconds of each phase of a run since the last, printed to stderr."""

    def __init__(self, t_start: float):
        self.last, self.seen = t_start, []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seen.append(f'{name} {now - self.last:.2f} s')
        self.last = now

    def report(self) -> None:
        print('phases: ' + ', '.join(self.seen), file=sys.stderr)
