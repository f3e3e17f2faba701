"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell (BENCHMARK.json's `workloads`)
names a configuration (`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/mixes/<traffic>.json`, data whose `driver` names the module
`benchmark/drivers/<driver>.py` that runs it).  The run writes its scene
from the seed into TMPDIR (`benchmark/scenes/<kind>.py`), sets up and warms
the port (mipnerf_pl_tpu_torch) on the cards the cell asks for, measures
for --seconds, then checks what the timed path produced against the plain
reference (benchmark/reference.py).  With --trace 1 it also
traces a short tail of the same work and reports the cell's per-layer
metrics (benchmark/metrics/<metric>.py) instead of its end-to-end ones.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown when traced), and last the numbers
compared with their limits, which also end standard error.  It exits 2,
printing no result, without a card (or with fewer than the cell asks
for), and 3 if a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             devices, t_start: float, extra: tuple = (), root=None) -> dict:
    """One run of a cell on `devices` (one a chip; a single device may be
    given alone) -> the result line (a dict).  `extra` also reads
    witnesses against the reference (benchmark/calibrate.py).  `root` is
    the checkout whose BENCHMARK.json, configurations and mixes are read
    (the tests give a small one)."""
    import torch

    from benchmark import compare, harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = [devices] if isinstance(devices, str) else list(devices)
    root = root or harness.ROOT
    man = harness.manifest(root)
    wl, config, mix = harness.cell(workload, man, root)
    res = harness.driver(mix['driver'])(config, mix, seed, seconds, traced,
                                        devices, t_start, extra)
    correct, checks = compare.checks(res['numbers'],
                                     config['limits'][mix['driver']])
    dev = torch.device(devices[0])
    line = {'correct': bool(correct and res['failed'] == 0),
            'attempted': res['attempted'], 'failed': res['failed']}
    metrics = {}
    if traced:
        for m in harness.metrics_of(wl, man, 'per_layer'):
            value = harness.reader(m['name'])(res)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        for m in harness.metrics_of(wl, man, 'end_to_end'):
            metrics[m['name']] = {'value': res['end_to_end'][m['name']],
                                  'unit': m['unit']}
    line['metrics'] = metrics
    line['device'] = {
        'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
        'kind': (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
                 else 'cpu'),
        'count': int(wl['chips']), 'memory_peak_bytes': res['peak_bytes']}
    if traced:
        from benchmark import trace
        line['device']['busy_s'] = trace.busy_s(res['trace'])
        line['device']['window_s'] = res['trace']['window_s']
        line['breakdown'] = trace.breakdown(res['trace'])
    readings = dict(res['readings'])
    unjudged = {k: v for k, v in res['numbers'].items() if k not in checks}
    if unjudged:
        readings['program'] = unjudged
    if readings:
        line['readings'] = readings
    line['checks'] = checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness
    chips = harness.cell(args.workload)[0]['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'benchmark: {args.workload} needs {chips} CUDA device(s); '
              f'this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    [f'cuda:{i}' for i in range(chips)], T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f'benchmark: forbidden modules loaded: {loaded}',
              file=sys.stderr)
        return 3
    for name, c in line['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
