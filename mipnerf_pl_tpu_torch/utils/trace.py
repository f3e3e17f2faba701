"""Spans of the port's own work, on the profiler's clock.

`span(name)` is a context manager around one piece of the port's work.
While a torch profiler records (`cli.train --profile N`, or a caller's own
`torch.profiler.profile`), it enters `torch.profiler.record_function(name)`:
the span lands in the trace on the clock of the operators and kernels
issued inside it, so each stretch the card sits idle can be put down to
what the host was doing.  Otherwise it returns one shared no-op object (one
C call, nothing allocated).

The spans, the one list of their names:

  mip.dispatch    `make_train_many`'s call: its K training steps
  mip.model       a training step's forward and loss terms (`_shard_loss`);
                  a render chunk's forward (`_render_flat`'s functional_call)
  mip.backward    a training step's `torch.autograd.grad`
  mip.adam        a training step's `adam_step`
  mip.launch      one kernel launch with its route-counter reads
                  (`kernels/mlp.py` `_call`, which every CUDA kernel of the
                  port goes through)
  mip.frame       `render_camera` / `render_image`: one whole frame
  mip.to_host     a frame's copy to the host (`_unpack_outputs`), which
                  waits for the card to drain
  mip.batch       `TrainBatcher.__next__`
  mip.sync        `fit`'s wait for the card before a validation
  mip.validate    `fit`'s validation and its row of val_history.csv
  mip.checkpoint  `fit`'s checkpoint

On the card autograd runs the backward on a device thread of its own: the
`mip.launch` spans of the kernels' backward sit on that thread, and
`mip.backward` is the calling thread's wait while the backward is issued.

Phases: inside `collect(totals)` the spans PHASES names also add their
perf_counter durations to `totals` under `fit`'s phase names, whether or
not a profiler records; `fit` prints them at its end.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# fit's phase of each span it sums.
PHASES = {'mip.batch': 'data', 'mip.dispatch': 'train_dispatch',
          'mip.sync': 'train_sync', 'mip.validate': 'validate',
          'mip.checkpoint': 'checkpoint'}

_OFF = contextlib.nullcontext()
_collecting: Optional['PhaseTotals'] = None


class PhaseTotals:
    """Seconds and calls of each of `fit`'s phases."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, dt: float):
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = ['profiler summary (phase: total s | calls | mean ms):']
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f'  {name:16s} {total:10.2f} | {n:6d} | '
                         f'{total / n * 1e3:10.2f}')
        return '\n'.join(lines)


def span(name: str):
    """A context manager over one piece of the port's work: a
    `record_function(name)` while a profiler records, else a shared no-op;
    a phase's timer as well inside `collect`."""
    if _collecting is not None and name in PHASES:
        return _phase(_collecting, name)
    if not _profiler_enabled():
        return _OFF
    return record_function(name)


@contextlib.contextmanager
def _phase(totals: PhaseTotals, name: str):
    t = time.perf_counter()
    with record_function(name) if _profiler_enabled() else _OFF:
        yield
    totals.add(PHASES[name], time.perf_counter() - t)


@contextlib.contextmanager
def collect(totals: PhaseTotals):
    """Sum the phase spans into `totals` inside the block."""
    global _collecting
    outer, _collecting = _collecting, totals
    try:
        yield totals
    finally:
        _collecting = outer
