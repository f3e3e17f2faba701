"""Unbounded-360 smoke: a synthetic LLFF capture, then real360 training
through the port's cli.train on configs/real360.yaml, then cli.eval; one
command, in this process.  It drives the whole unbounded path (inverse-depth
sampling and its flipped resample, contraction, the icosahedral IPE, the
flipped distloss, the LLFF / COLMAP loader).

  python -m mipnerf_pl_tpu_torch.tools.real360_smoke --out DIR
      [--steps 2000] [--size 64] [--n_images 16] [--device cpu] [key value ...]

Trains at data.factor 1 in bf16 with validation at the last step, then
evaluates the test views with --white_bkgd False.  The trailing key / value
pairs go to cli.train (e.g. nerf.mlp_backend pallas_lean_save).  Prints
`real360_smoke: steps=... wall=...s psnr=... ssim=...` last.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'configs', 'real360.yaml')


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--out', required=True)
    p.add_argument('--steps', type=int, default=2000)
    p.add_argument('--size', type=int, default=64)
    p.add_argument('--n_images', type=int, default=16)
    p.add_argument('--device', default=None,
                   help='default: cuda; cpu runs the kernels\' plain '
                   'versions')
    p.add_argument('opts', nargs=argparse.REMAINDER,
                   help='extra hparams forwarded to cli.train')
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """-> {'steps', 'wall', 'psnr', 'ssim', 'train': the fit's stats}."""
    from mipnerf_pl_tpu_torch.cli import eval as eval_cli
    from mipnerf_pl_tpu_torch.cli import train as train_cli
    from mipnerf_pl_tpu_torch.data.synthetic import make_llff_sphere_capture

    args = make_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    capture = os.path.join(args.out, 'capture')
    if not os.path.exists(os.path.join(capture, 'poses_bounds.npy')):
        print(f'generating LLFF capture at {args.size}px', flush=True)
        make_llff_sphere_capture(capture, n_images=args.n_images,
                                 size=args.size)
    device = ['--device', args.device] if args.device else []
    t0 = time.time()
    system, _ = train_cli.main(
        ['--data_path', capture, '--out_dir', args.out,
         '--dataset_name', 'real360', '--config', CONFIG,
         '--max_steps', str(args.steps)] + device
        + ['exp_name', 'real360_smoke', 'data.factor', '1',
           'train.compute_dtype', 'bfloat16',
           'val.check_interval', str(args.steps), 'val.sample_num', '1',
           'optimizer.max_steps', str(args.steps),
           'optimizer.lr_delay_steps', '500'] + list(args.opts))
    summary = eval_cli.main(
        ['--ckpt', os.path.join(args.out, 'ckpt', 'real360_smoke'),
         '--data', capture, '--out_dir', args.out, '--scale', '1',
         '--white_bkgd', 'False', '--no_video'] + device)
    wall = time.time() - t0
    psnr, ssim = (float(v) for v in summary.split(' | ')[:2])
    print(f'real360_smoke: steps={args.steps} wall={wall:.0f}s '
          f'psnr={psnr:.2f} ssim={ssim:.4f}', flush=True)
    return {'steps': args.steps, 'wall': wall, 'psnr': psnr, 'ssim': ssim,
            'train': dict(system.fit_stats)}


if __name__ == '__main__':
    main()
