"""Eval CLI: the flags and artifacts of the JAX package's eval.py, plus
--device.

  python -m mipnerf_pl_tpu_torch.cli.eval --ckpt OUT/ckpt/<exp> --data DATA \\
      --out_dir OUT --scale 1|2|4 [--base_size W H] [--chunk_size N] \\
      [--save_image] [--no_video] [--device cpu] [key value ...]

Renders the test split from a checkpoint (hparams restored from the
checkpoint directory), computes per-image PSNR / SSIM, writes
OUT/test/<exp>/psnrs.txt and ssims.txt, and prints the 'PSNR | SSIM |
Average' summary with one PSNR and one SSIM column per scale: a
multi_blender test split holds `--scale` consecutive levels of each view,
and entry i falls in bucket i % scale.  With --save_image each image goes
into OUT/test/<exp>/<base width / width>/ and, unless --no_video, each of
those directories gets a looping video of its frames
(cli/render_video.py generate_video).

The hparams are the checkpoint's, with `key value` pairs merged over them
(parallel/launch.py checkpoint_hparams); a render over n > 1 devices runs
as cli.train's does, one process a device, each rendering its rows of
every chunk, and the first writes the files.  `num_devices 1` renders a
checkpoint of a larger run on one card.  A checkpoint trained under
`parallel.model_axis` m renders on its data axis alone (num_devices / m
devices: one card for data 1 x model m) unless the key value pairs ask for
a model axis again.
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
    parser.add_argument('opts', nargs=argparse.REMAINDER,
                        help='Modify the checkpoint\'s hparams, e.g.: '
                        'num_devices 1')
    return parser


def evaluate(args, hparams, device) -> bool:
    """Render and score the test split; -> whether this process wrote the
    files (the first of a run's processes)."""
    import numpy as np

    from mipnerf_pl_tpu_torch.system import MipNeRFSystem, make_dataset
    from mipnerf_pl_tpu_torch.train.ckpt import restore_for_eval
    from mipnerf_pl_tpu_torch.utils.metrics import eval_errors
    from mipnerf_pl_tpu_torch.utils.vis import save_images

    exp_name = hparams['exp_name']
    system = MipNeRFSystem(hparams, device=device)
    root = system.mesh.is_root
    # --white_bkgd drives the render compositing; the dataset's compositing
    # follows the checkpoint's hparams.
    system.white_bkgd = bool(args.white_bkgd)
    _, state = restore_for_eval(args.ckpt)
    test_dataset = make_dataset(
        hparams, args.dataset_name or hparams['dataset_name'],
        args.data or hparams['data_path'], 'test')

    exp_dir = os.path.join(args.out_dir, 'test', exp_name)
    for i in range(args.scale if root else 0):
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
        if not root:
            continue
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

    if not root:
        return False
    with open(os.path.join(exp_dir, 'psnrs.txt'), 'w') as f:
        f.write(' '.join(str(v) for v in psnr_values))
    with open(os.path.join(exp_dir, 'ssims.txt'), 'w') as f:
        f.write(' '.join(str(v) for v in ssim_values))
    if args.save_image and not args.no_video:
        from mipnerf_pl_tpu_torch.cli.render_video import generate_video
        generate_video(exp_dir)
    return True


def main(argv: Optional[Sequence[str]] = None) -> Optional[str]:
    """Parse argv (None: sys.argv), evaluate, print and return the
    'PSNR | SSIM | Average' summary line (None in the workers it starts
    and on the processes of a run but the first; SystemExit with a failed
    worker's code)."""
    import sys

    from mipnerf_pl_tpu_torch.parallel import launch
    from mipnerf_pl_tpu_torch.train.ckpt import load_hparams
    from mipnerf_pl_tpu_torch.utils.metrics import summarize_results
    args = make_parser().parse_args(argv)
    if args.summa_only:
        exp_name = load_hparams(args.ckpt)['exp_name']
    else:
        hparams = launch.checkpoint_hparams(args.ckpt, args.opts)
        exp_name = hparams['exp_name']
        n = launch.workers_to_start(hparams, args.device)
        if n:
            code = launch.run_workers(
                'mipnerf_pl_tpu_torch.cli.eval',
                sys.argv[1:] if argv is None else list(argv), n)
            if code:
                raise SystemExit(code)
        else:
            device = launch.join_group(hparams, args.device)
            try:
                wrote = evaluate(args, hparams, device)
            finally:
                launch.leave_group()
            # A started worker's parent prints the summary.
            if not wrote or launch.started_worker():
                return None
    summary = summarize_results(args.out_dir, [exp_name], args.scale)
    print('PSNR | SSIM | Average')
    print(summary, flush=True)
    return summary


if __name__ == '__main__':
    main()
