"""Full-image render time (s/frame) of MipNeRFSystem.render_camera.

    python -m mipnerf_pl_tpu_torch.render_bench [--device cpu] \\
        [--side 800] [key value ...]
    e.g. python -m mipnerf_pl_tpu_torch.render_bench \\
        val.mlp_backend xla val.chunk_size 16384 train.compute_dtype float32

The counterpart of tools/render_bench.py on its camera path: the default
schema in bf16 (train.compute_dtype bfloat16, nerf.mlp_backend
pallas_lean_save, as that tool sets them; `key value` overrides after
that), seeded weights, a synthetic pinhole camera at 4 units looking at the
origin, a side x side frame (default 800).  Warm up 2 frames, then time 3;
each frame ends when its images are on the host.  Prints one JSON line:
{"metric": "render_sec_per_frame", "sec_per_frame", "rays_per_sec",
"resolution", "val_backend", "chunk", "compute_dtype"}.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

WARMUP_FRAMES = 2
TIMED_FRAMES = 3
CAMERA_ANGLE_X = 0.6911


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the bench; -> the printed line as a dict."""
    from mipnerf_pl_tpu_torch.config import default, merge_from_list
    from mipnerf_pl_tpu_torch.ops.camera import Camera, pix2cam_from_focal
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None, help='Device to render on '
                        '(default: cuda; cpu runs the kernels\' plain '
                        'versions).')
    parser.add_argument('--side', type=int, default=800,
                        help='frame width and height')
    parser.add_argument('opts', nargs=argparse.REMAINDER,
                        help='hparams overrides, e.g. val.chunk_size 16384')
    args = parser.parse_args(argv)
    hp = default()
    hp['train.compute_dtype'] = 'bfloat16'
    hp['nerf.mlp_backend'] = 'pallas_lean_save'
    if args.opts:
        merge_from_list(hp, args.opts)

    h = w = int(args.side)
    system = MipNeRFSystem(hp, device=args.device)
    params = system.init_params()
    focal = 0.5 * w / np.tan(0.5 * CAMERA_ANGLE_X)
    c2w = np.array([[1, 0, 0, 0], [0, 0, -1, -4], [0, 1, 0, 0]], np.float32)
    cam = Camera(c2w=c2w, pix2cam=pix2cam_from_focal(w, h, focal),
                 near=np.float32(2.0), far=np.float32(6.0),
                 lossmult=np.float32(1.0))

    def render():
        return system.render_camera(params, cam, h, w, need_coarse=False)

    for _ in range(WARMUP_FRAMES):
        render()
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        out = render()
    dt = (time.perf_counter() - t0) / TIMED_FRAMES
    if not np.all(np.isfinite(out['fine_rgb'])):
        raise FloatingPointError('the frame is not finite')
    line = {'metric': 'render_sec_per_frame',
            'sec_per_frame': round(dt, 4),
            'rays_per_sec': round(h * w / dt, 1),
            'resolution': h,
            'val_backend': str(hp.get('val.mlp_backend', 'auto')),
            'chunk': int(hp['val.chunk_size']),
            'compute_dtype': str(hp['train.compute_dtype'])}
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
