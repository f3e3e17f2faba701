"""Eval CLI: the flags and artifacts of the JAX package's eval.py, plus
--device.

  python -m mipnerf_pl_tpu_torch.cli.eval --ckpt OUT/ckpt/<exp> --data DATA \\
      --out_dir OUT --scale 1 [--chunk_size N] [--save_image] [--no_video] \\
      [--device cpu]

Renders the test split from a checkpoint (hparams restored from the
checkpoint directory), computes per-image PSNR / SSIM, writes
OUT/test/<exp>/psnrs.txt and ssims.txt, optionally dumps images into
per-scale directories, and prints the 'PSNR | SSIM | Average' summary.
Video generation is not ported: --save_image needs --no_video.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def _str2bool(v):
    return str(v).lower() not in ('false', '0', 'no')


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ckpt', help='Path to ckpt directory.',
                        required=True)
    parser.add_argument('--data', help='Path to data (default: the '
                        'checkpoint\'s data_path).', default=None)
    parser.add_argument('--out_dir', help='Output directory.', type=str,
                        required=True)
    parser.add_argument('--chunk_size', help='Chunk size for render.',
                        type=int, default=12288)
    parser.add_argument('--white_bkgd', help='Use white background.',
                        type=_str2bool, default=True)
    parser.add_argument('--save_image', help='whether save predicted image',
                        action='store_true')
    parser.add_argument('--summa_only', help='Only summarize results',
                        action='store_true')
    parser.add_argument('--scale', help='eval scale', type=int, required=True,
                        choices=[1, 2, 4])
    parser.add_argument('--base_size', help='source image size', type=int,
                        nargs=2, default=[800, 800])
    parser.add_argument('--no_video', help='skip video generation',
                        action='store_true')
    parser.add_argument('--dataset_name', default=None,
                        help='override the checkpoint-recorded dataset type')
    parser.add_argument('--device', help='Device to render on (default: '
                        'cuda; cpu runs the kernels\' plain versions).',
                        default=None)
    return parser


def evaluate(args) -> list:
    """Render and score the test split; -> [exp_name]."""
    import numpy as np

    from mipnerf_pl_tpu_torch.system import MipNeRFSystem, make_dataset
    from mipnerf_pl_tpu_torch.train.ckpt import load_hparams, restore_for_eval
    from mipnerf_pl_tpu_torch.utils.metrics import eval_errors
    from mipnerf_pl_tpu_torch.utils.vis import save_images

    hparams = load_hparams(args.ckpt)
    exp_name = hparams['exp_name']
    if args.summa_only:
        return [exp_name]
    if args.save_image and not args.no_video:
        raise NotImplementedError(
            'video generation is not ported yet (ROADMAP.md, the port\'s '
            'queue 1: render_video); pass --no_video')

    system = MipNeRFSystem(hparams, device=args.device)
    # --white_bkgd drives the render compositing; the dataset's compositing
    # follows the checkpoint's hparams.
    system.white_bkgd = bool(args.white_bkgd)
    _, state = restore_for_eval(args.ckpt)
    test_dataset = make_dataset(
        hparams, args.dataset_name or hparams['dataset_name'],
        args.data or hparams['data_path'], 'test')

    exp_dir = os.path.join(args.out_dir, 'test', exp_name)
    for i in range(args.scale):
        os.makedirs(os.path.join(exp_dir, str(2 ** i)), exist_ok=True)

    psnr_values, ssim_values = [], []
    n = -1
    for idx in range(len(test_dataset)):
        if idx % args.scale == 0:
            n += 1
        rays, rgb_gt = test_dataset[idx]
        # Only a dataset without a single-camera form falls back to the
        # materialized rays; a NotImplementedError from a render propagates.
        try:
            cam, (ch, cw) = test_dataset.camera(idx)
        except NotImplementedError:
            cam = None
        if cam is not None:
            out = system.render_camera(state['params'], cam, ch, cw,
                                       chunk_size=args.chunk_size,
                                       need_coarse=False)
        else:
            out = system.render_image(state['params'], rays,
                                      chunk_size=args.chunk_size,
                                      need_coarse=False)
        width = out['fine_rgb'].shape[1]
        psnr_val, ssim_val = eval_errors(
            out['fine_rgb'][None], np.asarray(rgb_gt[..., :3])[None])
        psnr_values.append(float(psnr_val))
        ssim_values.append(float(ssim_val))
        print(f'image {idx}: psnr={psnr_values[-1]:.3f} '
              f'ssim={ssim_values[-1]:.4f}', flush=True)
        if args.save_image:
            save_images(out['fine_rgb'], out['distance'], out['acc'],
                        os.path.join(exp_dir,
                                     str(int(args.base_size[0] / width))), n)

    with open(os.path.join(exp_dir, 'psnrs.txt'), 'w') as f:
        f.write(' '.join(str(v) for v in psnr_values))
    with open(os.path.join(exp_dir, 'ssims.txt'), 'w') as f:
        f.write(' '.join(str(v) for v in ssim_values))
    return [exp_name]


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Parse argv (None: sys.argv), evaluate, print and return the
    'PSNR | SSIM | Average' summary line."""
    from mipnerf_pl_tpu_torch.utils.metrics import summarize_results
    args = make_parser().parse_args(argv)
    scenes = evaluate(args)
    summary = summarize_results(args.out_dir, scenes, args.scale)
    print('PSNR | SSIM | Average')
    print(summary, flush=True)
    return summary


if __name__ == '__main__':
    main()
