"""Orbit video CLI: the flags of the root render_video.py, plus --device.

  python -m mipnerf_pl_tpu_torch.cli.render_video --ckpt OUT/ckpt/<exp> \\
      --out_dir OUT --scale 2 [--base_size 800 800] [--n_poses 120] \\
      [--chunk_size N] [--camera_angle_x A] [--device cpu]
  python -m mipnerf_pl_tpu_torch.cli.render_video --out_dir OUT --scale 1 \\
      --gen_video_only --render_images_dir DIR

Renders `--n_poses` poses of the spheric orbit at `--scale` levels from a
checkpoint (hparams restored from the checkpoint directory), each frame
through `MipNeRFSystem.render_camera` on the device, writes each level's
{idx:05d}_{rgb,dist,acc}.png into OUT/render_spheric/<exp>/<base width /
width>/ and a looping video_<k>.mov beside them (imageio where it imports
and writes, else cv2's mp4v; the writer is printed).  With
--gen_video_only it only assembles the videos of already rendered frames.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, List, Optional, Sequence


def _str2bool(v):
    return str(v).lower() not in ('false', '0', 'no')


def _write_video(path: str, frames, fps: int) -> str:
    """Write frames (uint8 HWC or HW) as a video; -> the writer used:
    'imageio' when it imports and writes, else 'cv2' (mp4v)."""
    try:
        import imageio
        imageio.mimwrite(path, frames, fps=fps, quality=10)
        return 'imageio'
    except Exception:
        pass
    import cv2
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f'cv2.VideoWriter failed for {path}')
    for f in frames:
        if f.ndim == 2:
            f = f[..., None].repeat(3, -1)
        writer.write(cv2.cvtColor(f[..., :3], cv2.COLOR_RGB2BGR))
    writer.release()
    return 'cv2'


def generate_video(image_path: str, fps: int = 40) -> List[str]:
    """Assemble video_<2^i>.mov in each level directory <2^i>/ of
    image_path from its *_rgb.png frames, played forward then backward;
    -> the videos written."""
    import numpy as np
    from PIL import Image

    scale_dirs = [s for s in os.listdir(image_path)
                  if os.path.isdir(os.path.join(image_path, s))]
    written = []
    for i in range(len(scale_dirs)):
        images = sorted(glob.glob(os.path.join(image_path, str(2 ** i),
                                               '*_rgb.png')))
        if not images:
            continue
        imgs = [np.array(Image.open(f)).astype(np.uint8) for f in images]
        imgs += imgs[::-1]
        path = os.path.join(image_path, str(2 ** i), f'video_{2 ** i}.mov')
        writer = _write_video(path, imgs, fps)
        print(f'generate video in {path} ({writer})', flush=True)
        written.append(path)
    return written


def run_render(args) -> Dict[int, List[float]]:
    """Render the orbit from the checkpoint and write frames and videos;
    -> {level width divisor: [seconds of each frame]}."""
    import numpy as np

    from mipnerf_pl_tpu_torch.data.render_path import spheric_render_cameras
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    from mipnerf_pl_tpu_torch.train.ckpt import load_hparams, restore_for_eval
    from mipnerf_pl_tpu_torch.utils.vis import save_images

    hparams = load_hparams(args.ckpt)
    exp_name = hparams['exp_name']
    system = MipNeRFSystem(hparams, device=args.device)
    system.white_bkgd = bool(args.white_bkgd)
    _, state = restore_for_eval(args.ckpt)
    root = os.path.join(args.out_dir, 'render_spheric', exp_name)
    for i in range(args.scale):
        os.makedirs(os.path.join(root, str(2 ** i)), exist_ok=True)

    focal = 0.5 * args.base_size[0] / np.tan(0.5 * args.camera_angle_x)
    all_cams = spheric_render_cameras(focal, args.base_size, args.scale,
                                      n_poses=args.n_poses)
    nums = len(all_cams) // args.scale
    seconds: Dict[int, List[float]] = {}
    for idx, (cam, (h, w)) in enumerate(all_cams):
        t0 = time.perf_counter()
        # The outputs come back as numpy: the frame has ended on the device.
        out = system.render_camera(state['params'], cam, h, w,
                                   chunk_size=args.chunk_size,
                                   need_coarse=False)
        dt = time.perf_counter() - t0
        level = int(args.base_size[0] / out['fine_rgb'].shape[1])
        seconds.setdefault(level, []).append(dt)
        save_images(out['fine_rgb'], out['distance'], out['acc'],
                    os.path.join(root, str(level)), idx % nums)
        print(f'rendered frame {idx + 1}/{len(all_cams)} ({w}x{h}, '
              f'{dt:.3f} s)', flush=True)
    generate_video(root)
    return seconds


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ckpt', help='Path to ckpt directory.')
    parser.add_argument('--out_dir', help='Output directory.', type=str,
                        required=True)
    parser.add_argument('--chunk_size', type=int, default=12288)
    parser.add_argument('--white_bkgd', type=_str2bool, default=True)
    parser.add_argument('--render_images_dir', type=str, default=None,
                        help='already rendered image directory.')
    parser.add_argument('--scale', help='number of scales', type=int,
                        required=True)
    parser.add_argument('--base_size', type=int, nargs=2, default=[800, 800])
    parser.add_argument('--camera_angle_x', type=float,
                        default=0.6911112070083618)
    parser.add_argument('--n_poses', type=int, default=120)
    parser.add_argument('--gen_video_only', action='store_true')
    parser.add_argument('--device', help='Device to render on (default: '
                        'cuda; cpu runs the kernels\' plain versions).',
                        default=None)
    return parser


def main(argv: Optional[Sequence[str]] = None):
    """Parse argv (None: sys.argv) and render, or only assemble videos with
    --gen_video_only; -> run_render's frame times, or the videos
    written."""
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.gen_video_only:
        if args.render_images_dir is None:
            parser.error('--gen_video_only needs --render_images_dir')
        return generate_video(args.render_images_dir)
    if args.ckpt is None:
        parser.error('rendering needs --ckpt')
    return run_render(args)


if __name__ == '__main__':
    main()
