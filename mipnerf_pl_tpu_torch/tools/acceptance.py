"""Multi-scale quality acceptance in one command: convert, train, evaluate
into the scale buckets, and summarize against the BASELINE.md table.

  python -m mipnerf_pl_tpu_torch.tools.acceptance --out DIR [--steps 50000]
      [--blender_scene DIR] [--size 256] [--scene spheres|hard]
      [--n_down 4] [--val_interval 10000] [--skip_train] [--device cpu]
      [key value ...]

With no --blender_scene it writes a synthetic scene (data/synthetic.py) of
--size px, so the whole multi-scale pipeline runs with no download;
--blender_scene takes a NeRF-synthetic scene directory
(transforms_{split}.json and PNGs) instead.

Counterpart of the JAX package's tools/acceptance.py, with its flags,
table and report files, plus --device (default: the card).  The stages run
through the port's cli.convert, cli.train and cli.eval (tools/stages.py);
the trailing key / value pairs go to cli.train.  Writes <out>/ACCEPTANCE.md
(the per-scale PSNR / SSIM table beside the BASELINE targets, the summary
line and the validation trajectory) and <out>/acceptance.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from mipnerf_pl_tpu_torch.tools import stages

# BASELINE.md's per-scale targets (lego, multi-scale, 300k steps).
BASELINE_PSNR = [34.412, 35.640, 36.074, 35.482]
BASELINE_SSIM = [0.9719, 0.9843, 0.9897, 0.9912]
BASELINE_AVG = (35.402, 0.9843)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--blender_scene', default=None,
                   help='single-scale Blender scene dir; default: generate '
                        'the synthetic sphere scene')
    p.add_argument('--out', required=True)
    p.add_argument('--steps', type=int, default=50000)
    p.add_argument('--size', type=int, default=256,
                   help='synthetic scene resolution (ignored with '
                        '--blender_scene)')
    p.add_argument('--scene', default='spheres', choices=['spheres', 'hard'],
                   help="built-in synthetic scene: 'spheres' (easy, "
                        "saturates ~45 PSNR) or 'hard' (textured, "
                        "aliasing-prone — the regime the BASELINE targets "
                        "live in)")
    p.add_argument('--n_down', type=int, default=4,
                   help='multi-scale pyramid levels (= eval scale buckets)')
    p.add_argument('--val_interval', type=int, default=10000)
    p.add_argument('--skip_train', action='store_true',
                   help='reuse an existing checkpoint in --out')
    p.add_argument('--device', default=None,
                   help='default: cuda; cpu runs the kernels\' plain '
                   'versions')
    p.add_argument('opts', nargs=argparse.REMAINDER,
                   help='extra hparams forwarded to cli.train')
    return p


def main(argv: Optional[Sequence[str]] = None,
         stage: Optional[stages.Stage] = None) -> dict:
    """Parse argv (None: sys.argv) and run every stage through `stage`
    (default: a process each); -> the content of acceptance.json."""
    from mipnerf_pl_tpu_torch.utils.metrics import summarize_results

    args = make_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    scene_dir = args.blender_scene or stages.make_scene(
        args.out, args.size, args.scene)
    scene_name = os.path.basename(scene_dir.rstrip('/'))
    # 1. convert: the single-scale scene -> the multi-scale pyramid.
    data_dir = stages.make_pyramid(args.out, scene_dir, args.n_down, stage)
    device = stages.device_args(args.device)

    # 2. train the lego config on the multi-scale data.
    exp_name = f'acceptance_{scene_name}'
    if not args.skip_train:
        stages.run(stages.TRAIN, [
            '--data_path', data_dir, '--out_dir', args.out,
            '--dataset_name', 'multi_blender',
            '--max_steps', str(args.steps)] + device + ['exp_name', exp_name]
            + stages.train_options(args.steps, args.val_interval, None)
            + args.opts, stage)

    # 3. evaluate every test image into the per-scale buckets.
    stages.run(stages.EVAL, [
        '--ckpt', os.path.join(args.out, 'ckpt', exp_name),
        '--data', data_dir, '--out_dir', args.out,
        '--scale', str(args.n_down), '--no_video'] + device, stage)

    # 4. summarize into the BASELINE comparison table.
    summary = summarize_results(args.out, [exp_name], args.n_down)
    psnr_s, ssim_s = stages.per_scale(args.out, exp_name, args.n_down)
    mse = 10.0 ** (-psnr_s.mean() / 10.0)
    avg_psnr = psnr_s.mean()
    avg_ssim = ssim_s.mean()

    is_lego = 'lego' in scene_name.lower()
    scale_names = stages.SCALE_NAMES[:args.n_down]
    lines = [
        '# Acceptance — multi-scale quality vs BASELINE',
        '',
        f'Scene: `{scene_dir}`'
        + ('' if is_lego else ' (synthetic sphere stand-in; BASELINE targets '
           'are for the real lego scene and are shown for reference only)'),
        f'Steps: {args.steps}  |  eval buckets: {args.n_down}  |  '
        f'generated: {time.strftime("%Y-%m-%d %H:%M:%S")}',
        '',
        '| Scale | PSNR | SSIM | BASELINE PSNR (lego@300k) | BASELINE SSIM |',
        '|---|---|---|---|---|',
    ]
    for i, name in enumerate(scale_names):
        bp = f'{BASELINE_PSNR[i]:.3f}' if i < len(BASELINE_PSNR) else '-'
        bs = f'{BASELINE_SSIM[i]:.4f}' if i < len(BASELINE_SSIM) else '-'
        lines.append(f'| {name} | {psnr_s[i]:.3f} | {ssim_s[i]:.4f} '
                     f'| {bp} | {bs} |')
    lines += [
        f'| **average** | **{avg_psnr:.3f}** | **{avg_ssim:.4f}** '
        f'| {BASELINE_AVG[0]:.3f} | {BASELINE_AVG[1]:.4f} |',
        '',
        f'`summarize_results` line: `{summary}`',
        '',
    ]
    # The validation trajectory that the fit wrote: evidence of a plateau.
    hist = os.path.join(args.out, 'logs', exp_name, 'val_history.csv')
    if os.path.exists(hist):
        with open(hist) as f:
            rows = [line.strip().split(',') for line in f][1:]
        lines += ['## Validation trajectory', '',
                  '| step | val PSNR |', '|---|---|']
        lines += [f'| {r[0]} | {float(r[2]):.2f} |' for r in rows]
        lines.append('')
    report = '\n'.join(lines)
    out_md = os.path.join(args.out, 'ACCEPTANCE.md')
    with open(out_md, 'w') as f:
        f.write(report)
    result = {'psnr_per_scale': psnr_s.tolist(),
              'ssim_per_scale': ssim_s.tolist(),
              'psnr_avg': float(avg_psnr), 'ssim_avg': float(avg_ssim),
              'mse_avg': float(mse), 'steps': args.steps,
              'scene': scene_dir}
    with open(os.path.join(args.out, 'acceptance.json'), 'w') as f:
        json.dump(result, f, indent=1)
    print(report, flush=True)
    print(f'wrote {out_md}', flush=True)
    return result


if __name__ == '__main__':
    main()
