"""Quality smoke: write a multi-view-consistent sphere scene, train a few
thousand steps through MipNeRFSystem.fit, and report the val PSNR.  A PSNR
in the high 20s says that the whole learning stack (sampling, resampling,
IPE, MLP, compositing, loss, LR schedule) learns, with no dataset on disk.

  python -m mipnerf_pl_tpu_torch.tools.quality_smoke [--steps 3000]
      [--out DIR] [--size 64] [--min_psnr 27] [--device cpu]
      [--backend pallas_lean_save] [--dtype bfloat16]

The settings are those of the JAX package's tools/quality_smoke.py: 1024
rays a step, 64 samples, a 6 x 128 MLP with a 64-wide view branch, 50
steps a dispatch, LR delay 100, validation on 2 views.  Prints one line,
`quality_smoke: steps=... wall=...s val_psnr=...`, and exits 1 when the
val PSNR is below --min_psnr.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--steps', type=int, default=3000)
    parser.add_argument('--out', type=str, default=None,
                        help='output directory (default: a temporary one, '
                        'removed at the end)')
    parser.add_argument('--size', type=int, default=64)
    parser.add_argument('--min_psnr', type=float, default=0.0,
                        help='exit 1 if the final val PSNR is below this')
    parser.add_argument('--device', default=None,
                        help='default: cuda; cpu runs the kernels\' plain '
                        'versions')
    parser.add_argument('--backend', default='xla',
                        help='nerf.mlp_backend of the training step')
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['bfloat16', 'float32'],
                        help='train.compute_dtype')
    return parser


def hparams(steps: int, backend: str, dtype: str) -> dict:
    """The smoke's hparams on the default schema."""
    from mipnerf_pl_tpu_torch.config import default
    hp = default()
    hp.update({
        'exp_name': 'quality_smoke',
        'train.compute_dtype': dtype,
        'train.batch_size': 1024,
        'nerf.num_samples': 64,
        'nerf.mlp.net_depth': 6,
        'nerf.mlp.net_width': 128,
        'nerf.mlp.net_width_condition': 64,
        'nerf.mlp_backend': backend,
        'val.check_interval': max(500, steps // 3),
        'val.sample_num': 2,
        'val.chunk_size': 4096,
        'optimizer.max_steps': steps,
        'optimizer.lr_delay_steps': 100,
        'train.steps_per_call': 50,
    })
    return hp


def run(args) -> dict:
    """Write the scene, train, validate 2 views; -> {'steps', 'wall',
    'val_psnr', 'rays_per_sec'} (wall: the fit's seconds)."""
    from mipnerf_pl_tpu_torch.data.synthetic import make_sphere_scene
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

    scene = make_sphere_scene(os.path.join(args.out, 'scene'),
                              size=args.size)
    system = MipNeRFSystem(hparams(args.steps, args.backend, args.dtype),
                           device=args.device)
    t0 = time.time()
    state = system.fit(scene, 'blender', args.out, max_steps=args.steps,
                       log_every=500, verbose=True)
    wall = time.time() - t0
    _, psnr = system.validate(state, num_images=2)
    return {'steps': args.steps, 'wall': wall, 'val_psnr': psnr,
            'rays_per_sec': system.fit_stats['rays_per_sec']}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse argv (None: sys.argv), run, print the line; raise SystemExit(1)
    under --min_psnr.  -> run()'s dict."""
    args = make_parser().parse_args(argv)
    if args.out is None:
        with tempfile.TemporaryDirectory() as out:
            args.out = out
            result = run(args)
    else:
        result = run(args)
    print(f'quality_smoke: steps={result["steps"]} '
          f'wall={result["wall"]:.0f}s val_psnr={result["val_psnr"]:.2f} '
          f'backend={args.backend} dtype={args.dtype}', flush=True)
    if result['val_psnr'] < args.min_psnr:
        raise SystemExit(1)
    return result


if __name__ == '__main__':
    main()
