"""Multi-scale conversion CLI: the flags of the root convert_blender_data.py.

  python -m mipnerf_pl_tpu_torch.cli.convert --blender_dir ROOT \\
      --out_dir OUT [--object_name SCENE] [--n_down 4]

Converts every scene directory under ROOT (or only SCENE) into
OUT/<scene>/{images_{split}/, metadata.json}, the layout the
`multi_blender` dataset reads (data/convert.py).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--blender_dir', help='data root path', type=str)
    parser.add_argument('--object_name', help='single scene to convert',
                        type=str, default=None)
    parser.add_argument('--out_dir', help='Output directory.', type=str)
    parser.add_argument('--n_down', help='number of pyramid levels',
                        type=int, default=4)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Parse argv (None: sys.argv), convert, and return the output
    directories."""
    from mipnerf_pl_tpu_torch.data.convert import convert_to_nerfdata

    args = make_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    scenes = [args.object_name] if args.object_name else os.listdir(
        args.blender_dir)
    dirs = [os.path.join(args.blender_dir, s) for s in scenes]
    dirs = [d for d in dirs if os.path.isdir(d)]
    print(dirs)
    out = []
    for basedir in dirs:
        newdir = os.path.join(args.out_dir, os.path.basename(basedir))
        print('Converting from', basedir, 'to', newdir, flush=True)
        convert_to_nerfdata(basedir, newdir, args.n_down)
        out.append(newdir)
    return out


if __name__ == '__main__':
    main()
