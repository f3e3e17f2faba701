"""Train CLI: the flags of the JAX package's train.py, plus --device.

  python -m mipnerf_pl_tpu_torch.cli.train --data_path DATA --out_dir OUT \\
      --dataset_name blender [--config CFG.yaml] [--max_steps N] \\
      [--profile N] [--device cpu] [key value ...]

Trains on a CUDA device unless --device says otherwise (with no card and no
flag MipNeRFSystem raises ValueError).  Writes OUT/ckpt/<exp_name>/
{hparams.json, best/<step>, last/<step>} and OUT/logs/<exp_name>/
val_history.csv (and TensorBoard events where tensorboardX is installed);
started again with the same OUT it resumes from its own last checkpoint.
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
                        'off).', type=int, default=0)
    parser.add_argument('--device', help='Device to train on (default: '
                        'cuda; cpu runs the kernels\' plain versions).',
                        default=None)
    parser.add_argument('opts', nargs=argparse.REMAINDER,
                        help='Modify hparams, e.g.: train.batch_size 1024')
    return parser


def main(argv: Optional[Sequence[str]] = None):
    """Parse argv (None: sys.argv), run MipNeRFSystem.fit and return
    (system, final state)."""
    from mipnerf_pl_tpu_torch.config import parse_args
    from mipnerf_pl_tpu_torch.data.datasets import dataset_dict
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

    hparams = parse_args(make_parser(), argv)
    if hparams['dataset_name'] not in dataset_dict:
        raise ValueError(f'unknown dataset {hparams["dataset_name"]!r}; '
                         f'registered: {sorted(dataset_dict)}')
    system = MipNeRFSystem(hparams, device=hparams.get('device'))
    print(f'device: {system.device}', flush=True)
    state = system.fit(
        data_path=hparams['data_path'],
        dataset_name=hparams['dataset_name'],
        out_dir=hparams['out_dir'],
        max_steps=hparams.get('max_steps'),
        resume_path=hparams.get('checkpoint.resume_path'))
    return system, state


if __name__ == '__main__':
    main()
