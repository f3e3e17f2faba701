"""Host time inside the port's own spans in a traced tail.

The port marks its work with `record_function` ranges named `mip.*`
(mipnerf_pl_tpu_torch/utils/trace.py lists them); trace.profile keeps them
among the window thread's host events (`trace['host']`), on the clock of
the device's operations.  A span's time is the union of its intervals (a
span nested in one of its own name counts once); a layer's own time is its
span's time less the part the named child spans cover.  Readers divide by
the traced steps or frames, and return None where the trace holds no event
of the span: no trace, or a program that does not emit it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from benchmark import trace


def _union(host, names) -> List[Tuple[float, float]]:
    return trace.busy_intervals([e for e in host if e[0] in names])


def _overlap_s(a, b) -> float:
    """Seconds two sorted, merged interval lists share."""
    i = j = 0
    shared = 0.0
    while i < len(a) and j < len(b):
        shared += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def ms_per_unit(res, name: str, less: Sequence[str] = ()) -> Optional[float]:
    """Host ms a traced step (or frame) inside the span `name`, less the
    part of it inside any span named in `less`."""
    tr = res.get('trace')
    if not tr:
        return None
    outer = _union(tr['host'], (name,))
    if not outer:
        return None
    seconds = (sum(b - a for a, b in outer)
               - _overlap_s(outer, _union(tr['host'], set(less))))
    return 1e3 * seconds / res['traced_units']
