"""The device trace of a short window, reduced to what the readers need.

`profile(fn)` runs fn under Kineto's profiler with CPU and CUDA
activities inside one 'bench.window' annotation, and reads its raw events
(no chrome trace is written and no event tree is built, which takes
minutes for a training window).
The result holds the window's length, every device operation (kernels,
memcpy, memset) and every host event of the thread that ran fn
(operators and the harness's own annotations) as (name, start s, end s),
relative to the window's start.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation')

def profile(fn) -> Dict:
    """Run fn under Kineto's profiler (CPU and, with a card, CUDA
    activities) through the profiler's own bindings, which hand back the
    raw events without the Python event tree the profiler classes build
    on exit."""
    from torch._C._autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _ExperimentalConfig)
    from torch.profiler import record_function
    cuda = torch.cuda.is_available()
    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda
                                     else set())
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                            False, False, _ExperimentalConfig())
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts)
    try:
        with record_function('bench.window'):
            fn()
        if cuda:
            torch.cuda.synchronize()
    finally:
        result = _disable_profiler()
    return reduce_events([_event(e) for e in result.events()])


def _event(e) -> tuple:
    """(category, name, start ns, end ns, thread) of a Kineto event; the
    category from the event where this torch names it, else from its
    device and name (a host event named cu* is a CUDA runtime call)."""
    name = e.name()
    if hasattr(e, 'activity_type'):
        cat = e.activity_type()
    elif e.device_type() == torch.autograd.DeviceType.CUDA:
        cat = 'gpu_user_annotation' if name.startswith('bench.') else 'kernel'
    elif name.startswith('bench.'):
        cat = 'user_annotation'
    else:
        cat = 'cuda_runtime' if name.startswith('cu') else 'cpu_op'
    start = e.start_ns()
    return (cat, name, start, start + e.duration_ns(),
            getattr(e, 'start_thread_id', lambda: 0)())


def reduce_events(events: List[tuple]) -> Dict:
    """Raw events (category, name, start ns, end ns, thread) ->
    {'window_s', 'device': [(name, t0, t1)], 'host': [(name, t0, t1)]},
    times in seconds from the window's start, device operations clipped
    to it, host events of the window's thread only."""
    win = [e for e in events if e[1] == 'bench.window' and e[0] in HOST_CATS]
    if not win:
        raise ValueError('the trace has no bench.window annotation')
    _, _, w0, w1, thread = win[0]

    def rel(e) -> Tuple[str, float, float]:
        return (str(e[1]), (max(e[2], w0) - w0) * 1e-9,
                (min(e[3], w1) - w0) * 1e-9)
    # A device event named as a host event is an annotation's mirror on
    # the card's timeline (where the category does not say so), not work.
    host_names = {e[1] for e in events if e[0] not in DEVICE_CATS}
    device = [rel(e) for e in events
              if e[0] in DEVICE_CATS and e[1] not in host_names
              and e[2] < w1 and e[3] > w0]
    host = [rel(e) for e in events if e[0] in HOST_CATS
            and e[4] == thread and e[1] != 'bench.window']
    return {'window_s': (w1 - w0) * 1e-9, 'device': device, 'host': host}


def busy_intervals(device) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, merged and sorted."""
    merged: List[List[float]] = []
    for _, a, b in sorted(device, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_s(trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace['device']))


def device_seconds(trace, pattern, matching: bool) -> float:
    """Summed durations of the device operations whose name the compiled
    regular expression `pattern` finds something in (matching True), or
    of every other one."""
    return sum(b - a for name, a, b in trace['device']
               if bool(pattern.search(name)) == matching)


def breakdown(trace, top: int = 10) -> Dict:
    """{'device_ops': [[name, s]] the operations that took most device time;
    'idle_gaps': [[host activity, s]] the device's idle time by the
    innermost host event at each gap's middle}, at most `top` each."""
    ops: Dict[str, float] = {}
    for name, a, b in trace['device']:
        ops[name] = ops.get(name, 0.0) + (b - a)
    gaps: Dict[str, float] = {}
    edges = [0.0]
    for a, b in busy_intervals(trace['device']):
        edges += [a, b]
    edges.append(trace['window_s'])
    mids = sorted((0.5 * (a + b), b - a)
                  for a, b in zip(edges[0::2], edges[1::2]) if b > a)
    # A sweep over the gaps' middles in time: the events begun so far in a
    # heap by duration, those already ended dropped from its top.
    host = sorted(trace['host'], key=lambda e: e[1])
    active: list = []
    i = 0
    for mid, length in mids:
        while i < len(host) and host[i][1] <= mid:
            name, a, b = host[i]
            heapq.heappush(active, (b - a, b, name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2] if active else 'no host event'
        gaps[label] = gaps.get(label, 0.0) + length

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {'device_ops': ranked(ops), 'idle_gaps': ranked(gaps)}
