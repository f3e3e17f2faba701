"""Train CLI: the flags of the JAX package's train.py, plus --device.

  python -m mipnerf_pl_tpu_torch.cli.train --data_path DATA --out_dir OUT \\
      --dataset_name blender [--config CFG.yaml] [--max_steps N] \\
      [--profile N] [--device cpu] [key value ...]

Trains on a CUDA device unless --device says otherwise (with no card and no
flag MipNeRFSystem raises ValueError).  Writes OUT/ckpt/<exp_name>/
{hparams.json, best/<step>, last/<step>} and OUT/logs/<exp_name>/
val_history.csv (and TensorBoard events where tensorboardX is installed);
started again with the same OUT it resumes from its own last checkpoint.

Data parallelism, one process a device (parallel/launch.py): where the
hparams ask for n > 1 devices (`num_devices n`, or `num_gpus n`;
`num_devices 0` is every visible card) the command starts n workers of
itself, NCCL on cuda:0..n-1 or gloo with --device cpu, and exits with the
first non-zero code of theirs.  Across hosts, run one process a card with
`parallel.multi_host True parallel.coordinator_address HOST:PORT
parallel.num_processes N parallel.process_id R` on a shared OUT.  The
first process writes the files.  `parallel.model_axis m` (m dividing n)
lays the n devices out as data n / m x model m: each data shard's MLP
runs in Megatron pairs over its m processes (tensor parallelism, gloo
with --device cpu: `num_devices 2 parallel.model_axis 2`).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--data_path', help='data path.', type=str,
                        required=True)
    parser.add_argument('--out_dir', help='Output directory.', type=str,
                        required=True)
    parser.add_argument('--dataset_name', help='Registered dataset type '
                        '(data/datasets.py dataset_dict), e.g. blender.',
                        type=str, required=True)
    parser.add_argument('--config', help='Path to a YAML config file '
                        '(default: the built-in schema).', default=None)
    parser.add_argument('--max_steps', help='Override optimizer.max_steps.',
                        type=int, default=None)
    parser.add_argument('--profile', help='Trace one warmed train dispatch '
                        'with torch.profiler into the log directory (0 = '
                        'off).  The chrome trace carries the port\'s mip.* '
                        'spans (their list: the docstring of '
                        'mipnerf_pl_tpu_torch/utils/trace.py), the same '
                        'spans whose times the profiler summary at the end '
                        'of the run adds up.', type=int, default=0)
    parser.add_argument('--device', help='Device to train on (default: '
                        'cuda; cpu runs the kernels\' plain versions).',
                        default=None)
    parser.add_argument('opts', nargs=argparse.REMAINDER,
                        help='Modify hparams, e.g.: train.batch_size 1024')
    return parser


def main(argv: Optional[Sequence[str]] = None):
    """Parse argv (None: sys.argv), run MipNeRFSystem.fit and return
    (system, final state); (None, None) where it started workers that
    ran it, and SystemExit with the first non-zero code of theirs where
    one failed."""
    import sys

    from mipnerf_pl_tpu_torch.config import parse_args
    from mipnerf_pl_tpu_torch.data.datasets import dataset_dict
    from mipnerf_pl_tpu_torch.parallel import launch
    from mipnerf_pl_tpu_torch.parallel.mesh import process_count
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

    hparams = parse_args(make_parser(), argv)
    if hparams['dataset_name'] not in dataset_dict:
        raise ValueError(f'unknown dataset {hparams["dataset_name"]!r}; '
                         f'registered: {sorted(dataset_dict)}')
    n = launch.workers_to_start(hparams, hparams.get('device'))
    if n:
        code = launch.run_workers(
            'mipnerf_pl_tpu_torch.cli.train',
            sys.argv[1:] if argv is None else list(argv), n)
        if code:
            raise SystemExit(code)
        return None, None
    device = launch.join_group(hparams, hparams.get('device'))
    try:
        system = MipNeRFSystem(hparams, device=device)
        mesh = system.mesh
        print(f'mesh: data={mesh.shape["data"]} model={mesh.shape["model"]}'
              f', process {mesh.rank}/{process_count()}, device '
              f'{system.device}', flush=True)
        state = system.fit(
            data_path=hparams['data_path'],
            dataset_name=hparams['dataset_name'],
            out_dir=hparams['out_dir'],
            max_steps=hparams.get('max_steps'),
            resume_path=hparams.get('checkpoint.resume_path'))
    finally:
        launch.leave_group()
    return system, state


if __name__ == '__main__':
    main()
