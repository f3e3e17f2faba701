"""The distortion loss on and off, on the hard synthetic scene.

Trains the model twice on the multi-scale pyramid of the 'hard' scene,
once with `loss.distloss_mult 0.01` (the upstream training step's fixed
weight) and once with the regularizer off, then evaluates both on the
same multi-scale test pyramid.  The companion of tools/ablation.py.

  python -m mipnerf_pl_tpu_torch.tools.distloss_ablation --out DIR
      [--steps 10000] [--size 256] [--n_down 4] [--device cpu]
      [--skip_train NAME ...] [key value ...]

Counterpart of the JAX package's tools/distloss_ablation.py, with its
flags, its arms, its table and report files, plus --device (default: the
card).  The stages run through the port's cli.convert, cli.train and
cli.eval (tools/stages.py); the trailing key / value pairs go to both
cli.train runs.  Writes <out>/DISTLOSS.md and <out>/distloss.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from mipnerf_pl_tpu_torch.tools import stages


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--out', required=True)
    p.add_argument('--steps', type=int, default=10000)
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--n_down', type=int, default=4, choices=[1, 2, 4])
    p.add_argument('--skip_train', nargs='*', default=[])
    p.add_argument('--device', default=None,
                   help='default: cuda; cpu runs the kernels\' plain '
                   'versions')
    p.add_argument('opts', nargs=argparse.REMAINDER)
    return p


def main(argv: Optional[Sequence[str]] = None,
         stage: Optional[stages.Stage] = None) -> dict:
    """Parse argv (None: sys.argv) and run every stage through `stage`
    (default: a process each); -> the content of distloss.json."""
    args = make_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    scene_dir = stages.make_scene(args.out, args.size)
    data_dir = stages.make_pyramid(args.out, scene_dir, args.n_down, stage)
    device = stages.device_args(args.device)

    variants = [
        ('distloss_on', ['loss.distloss_mult', '0.01']),
        ('distloss_off', ['loss.distloss_mult', '0.0']),
    ]
    common = stages.train_options(args.steps, args.steps)
    for name, extra in variants:
        if name in args.skip_train:
            continue
        stages.run(stages.TRAIN, [
            '--data_path', data_dir, '--out_dir', args.out,
            '--dataset_name', 'multi_blender',
            '--max_steps', str(args.steps)]
            + device + ['exp_name', name] + common + extra + args.opts,
            stage)

    for name, _ in variants:
        stages.run(stages.EVAL, [
            '--ckpt', os.path.join(args.out, 'ckpt', name),
            '--data', data_dir, '--out_dir', args.out,
            '--dataset_name', 'multi_blender',
            '--scale', str(args.n_down), '--no_video'] + device, stage)

    rows = {name: stages.per_scale(args.out, name, args.n_down)
            for name, _ in variants}
    scale_names = stages.SCALE_NAMES[:args.n_down]

    lines = [
        '# Distortion-loss on/off — hard scene, full lego config',
        '',
        f'Steps: {args.steps} per variant  |  generated: '
        f'{time.strftime("%Y-%m-%d %H:%M:%S")}',
        '',
        '| Scale | distloss=0.01 PSNR | distloss=0 PSNR | distloss=0.01 SSIM '
        '| distloss=0 SSIM |',
        '|---|---|---|---|---|',
    ]
    for i, sn in enumerate(scale_names):
        lines.append(
            f'| {sn} | {rows["distloss_on"][0][i]:.3f} '
            f'| {rows["distloss_off"][0][i]:.3f} '
            f'| {rows["distloss_on"][1][i]:.4f} '
            f'| {rows["distloss_off"][1][i]:.4f} |')
    lines.append(
        f'| **average** | **{rows["distloss_on"][0].mean():.3f}** '
        f'| **{rows["distloss_off"][0].mean():.3f}** '
        f'| **{rows["distloss_on"][1].mean():.4f}** '
        f'| **{rows["distloss_off"][1].mean():.4f}** |')

    report = '\n'.join(lines) + '\n'
    out_md = os.path.join(args.out, 'DISTLOSS.md')
    with open(out_md, 'w') as f:
        f.write(report)
    result = {n: {'psnr': rows[n][0].tolist(), 'ssim': rows[n][1].tolist()}
              for n in rows}
    with open(os.path.join(args.out, 'distloss.json'), 'w') as f:
        json.dump(result, f, indent=1)
    print(report)
    print(f'wrote {out_md}', flush=True)
    return result


if __name__ == '__main__':
    main()
