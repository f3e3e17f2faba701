"""Mip-NeRF's ablations on the hard synthetic scene, in one command.

Trains three variants on the 'hard' scene (textured spheres over a
checkered ground disk, data/synthetic.py) and evaluates each on the SAME
multi-scale test pyramid:

  multi_ipe   multi-scale training, integrated PE (the mip-NeRF recipe)
  multi_pe    multi-scale training, nerf.disable_integration True (the
              classic NeRF encode: zero covariances)
  single_ipe  single-scale (full-resolution) training with IPE (no
              lossmult)

The claims it checks at the coarse scales, where the cone's footprint is
large: IPE beats PE, and multi-scale training beats single-scale training.

  python -m mipnerf_pl_tpu_torch.tools.ablation --out DIR [--steps 20000]
      [--size 256] [--n_down 4] [--device cpu] [--skip_train NAME ...]
      [key value ...]

Counterpart of the JAX package's tools/ablation.py, with its flags, its
variants, its tables and report files, plus --device (default: the card).
The stages run through the port's cli.convert, cli.train and cli.eval
(tools/stages.py); the trailing key / value pairs go to every cli.train
run (e.g. nerf.mlp_backend pallas_lean_save).  Writes <out>/ABLATION.md
(the per-scale PSNR / SSIM table and the sign checks' verdicts) and
<out>/ablation.json, beside each variant's train / eval outputs.
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
    p.add_argument('--steps', type=int, default=20000)
    p.add_argument('--size', type=int, default=256)
    p.add_argument('--n_down', type=int, default=4, choices=[1, 2, 4],
                   help='pyramid levels; a cli.eval --scale choice, checked '
                   'here so that a bad value cannot waste the training '
                   'before the eval stage rejects it')
    p.add_argument('--skip_train', nargs='*', default=[],
                   help='variant names to reuse existing checkpoints for')
    p.add_argument('--device', default=None,
                   help='default: cuda; cpu runs the kernels\' plain '
                   'versions')
    p.add_argument('opts', nargs=argparse.REMAINDER,
                   help='extra hparams forwarded to every cli.train run')
    return p


def main(argv: Optional[Sequence[str]] = None,
         stage: Optional[stages.Stage] = None) -> dict:
    """Parse argv (None: sys.argv) and run every stage through `stage`
    (default: a process each); -> the content of ablation.json."""
    args = make_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    scene_dir = stages.make_scene(args.out, args.size)
    data_dir = stages.make_pyramid(args.out, scene_dir, args.n_down, stage)
    device = stages.device_args(args.device)

    variants = [
        # (name, dataset_name, training data, extra training options)
        ('multi_ipe', 'multi_blender', data_dir, []),
        ('multi_pe', 'multi_blender', data_dir,
         ['nerf.disable_integration', 'True']),
        ('single_ipe', 'blender', scene_dir, []),
    ]
    common = stages.train_options(args.steps, args.steps)
    for name, dataset_name, train_dir, extra in variants:
        if name in args.skip_train:
            continue
        stages.run(stages.TRAIN, [
            '--data_path', train_dir, '--out_dir', args.out,
            '--dataset_name', dataset_name, '--max_steps', str(args.steps)]
            + device + ['exp_name', name] + common + extra + args.opts,
            stage)

    # Every variant on the same multi-scale test pyramid.
    for name, _, _, _ in variants:
        stages.run(stages.EVAL, [
            '--ckpt', os.path.join(args.out, 'ckpt', name),
            '--data', data_dir, '--out_dir', args.out,
            '--dataset_name', 'multi_blender',
            '--scale', str(args.n_down), '--no_video'] + device, stage)

    rows = {name: stages.per_scale(args.out, name, args.n_down)
            for name, _, _, _ in variants}
    scale_names = stages.SCALE_NAMES[:args.n_down]

    # The sign checks at the coarse scales (the cone's footprint is large).
    coarse = slice(args.n_down // 2, args.n_down)
    ipe_delta = rows['multi_ipe'][0][coarse] - rows['multi_pe'][0][coarse]
    ms_delta = rows['multi_ipe'][0][coarse] - rows['single_ipe'][0][coarse]
    checks = [
        ('IPE beats PE at coarse scales',
         float(ipe_delta.mean()), bool((ipe_delta > 0).all())),
        ('multi-scale training beats single-scale at coarse scales',
         float(ms_delta.mean()), bool((ms_delta > 0).all())),
    ]

    lines = [
        '# Ablations — mip-NeRF behavior on the hard synthetic scene',
        '',
        f'Scene: `{scene_dir}` (textured spheres + checkered ground; '
        f'{args.size}px, 2x supersampled GT)',
        f'Steps: {args.steps} per variant  |  eval: same {args.n_down}-scale '
        f'test pyramid  |  generated: {time.strftime("%Y-%m-%d %H:%M:%S")}',
        '',
        '| Scale | multi+IPE PSNR | multi+PE PSNR | single+IPE PSNR '
        '| multi+IPE SSIM | multi+PE SSIM | single+IPE SSIM |',
        '|---|---|---|---|---|---|---|',
    ]
    for i, sname in enumerate(scale_names):
        lines.append(
            f'| {sname} '
            f'| {rows["multi_ipe"][0][i]:.3f} | {rows["multi_pe"][0][i]:.3f} '
            f'| {rows["single_ipe"][0][i]:.3f} '
            f'| {rows["multi_ipe"][1][i]:.4f} | {rows["multi_pe"][1][i]:.4f} '
            f'| {rows["single_ipe"][1][i]:.4f} |')
    lines += ['', '## Sign checks', '']
    for desc, delta, ok in checks:
        lines.append(f'- {desc}: mean coarse-scale PSNR delta '
                     f'**{delta:+.3f} dB** — {"PASS" if ok else "FAIL"}')
    report = '\n'.join(lines) + '\n'
    out_md = os.path.join(args.out, 'ABLATION.md')
    with open(out_md, 'w') as f:
        f.write(report)
    result = ({name: {'psnr': r[0].tolist(), 'ssim': r[1].tolist()}
               for name, r in rows.items()}
              | {'checks': [{'desc': d, 'delta': x, 'pass': ok}
                            for d, x, ok in checks],
                 'steps': args.steps, 'size': args.size})
    with open(os.path.join(args.out, 'ablation.json'), 'w') as f:
        json.dump(result, f, indent=1)
    print(report, flush=True)
    print(f'wrote {out_md}', flush=True)
    return result


if __name__ == '__main__':
    main()
