"""Readings for the limits of `correct`: the program on many seeds, and the
controls on some, in one process (set-up is long; the kernels build once).

    python3 -m benchmark.calibrate --workload lego.train \\
        --seeds 11,12,13 --controls 3 [--seconds 1]

For every seed, one run of the cell (benchmark.run's run_cell at
--seconds) prints a JSON line with the numbers the program reads against
the reference; for the first --controls seeds also the control's (the
reference in TF32) and, for a training cell, each of --witnesses: by
default the half-batch fault's (the reference's loss over half of each
batch) and the float64 reference's, a witness of the round-off a float32
run carries, against which every side is then read too.  The
benchmark's own runs never run this.  A training cell needs no window for
its readings (they come from set-up's first steps); a render cell's
compare as many frames as a run at the window given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--controls', type=int, default=3)
    parser.add_argument('--seconds', type=float, default=1.0)
    parser.add_argument('--witnesses', default='tf32,half_batch,f64',
                        help='a training cell\'s reference variants '
                        '(TRAIN_WITNESSES in benchmark/drivers/train.py)')
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.run import run_cell
    if not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 2
    driver = harness.cell(args.workload)[2]['driver']
    controls = (tuple(args.witnesses.split(',')) if driver == 'train'
                else ('tf32',))
    for i, seed in enumerate(int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        line = run_cell(args.workload, seed, args.seconds, False, 'cuda', t0,
                        controls if i < args.controls else ())
        print(json.dumps({
            'workload': args.workload, 'seed': seed,
            'correct': line['correct'], 'attempted': line['attempted'],
            'numbers': {k: v['value'] for k, v in line['checks'].items()},
            'readings': line.get('readings', {}),
            'seconds': time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
