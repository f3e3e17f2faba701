"""Camera frustum visualizer: the frusta of a Blender or multi-scale
dataset's cameras, and optionally the orbit that cli/render_video.py
renders, as a PNG (matplotlib 3-D, headless) or as a self-contained HTML
viewer (drag to orbit, wheel to zoom, shift-drag to pan; numpy and json
only).

  python -m mipnerf_pl_tpu_torch.utils.visualize_cameras --data_dir DIR \
      [--out cameras.png | --out cameras.html] [--split train] \
      [--multi_scale] [--spheric_path]

Counterpart of the JAX package's utils/visualize_cameras.py (the upstream
project draws the same frusta interactively with open3d), with its flags:
`--multi_scale` reads a metadata.json directory (the upstream's flag was
`"-- "`, which can never be set).  matplotlib is imported by
`visualize_cameras` only, and its absence raises ImportError there.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def get_camera_frustum(img_size, focal, c2w, frustum_length: float = 0.5):
    """5 frustum corner points (world) + the 8 line segments between them."""
    w, h = img_size
    half_w = frustum_length * (w / 2.0) / focal
    half_h = frustum_length * (h / 2.0) / focal
    # OpenGL camera: -z forward.
    points_cam = np.array([
        [0.0, 0.0, 0.0],
        [-half_w, half_h, -frustum_length],
        [half_w, half_h, -frustum_length],
        [half_w, -half_h, -frustum_length],
        [-half_w, -half_h, -frustum_length],
    ])
    lines = np.array([[0, i] for i in range(1, 5)]
                     + [[i, i + 1] for i in range(1, 4)] + [[4, 1]])
    c2w = np.asarray(c2w)
    r, t = c2w[:3, :3], c2w[:3, 3]
    points_world = points_cam @ r.T + t
    return points_world, lines


def plot_frustums(ax, frusta: List[Tuple[np.ndarray, np.ndarray]], color):
    for points, lines in frusta:
        for a, b in lines:
            ax.plot(*zip(points[a], points[b]), color=color, linewidth=0.7)


def load_blender_cameras(data_dir: str, split: str = 'train'):
    """(img_size, focal, [c2w]) from transforms_{split}.json."""
    with open(os.path.join(data_dir, f'transforms_{split}.json')) as f:
        meta = json.load(f)
    # Probe one image for its size.
    from PIL import Image
    first = os.path.join(data_dir, meta['frames'][0]['file_path'] + '.png')
    with Image.open(first) as im:
        w, h = im.size
    focal = 0.5 * w / np.tan(0.5 * float(meta['camera_angle_x']))
    c2ws = [np.array(fr['transform_matrix']) for fr in meta['frames']]
    return (w, h), focal, c2ws


def load_multicam_cameras(data_dir: str, split: str = 'train'):
    """Per-image ((w, h), focal, c2w) triples from metadata.json."""
    with open(os.path.join(data_dir, 'metadata.json')) as f:
        meta = json.load(f)[split]
    out = []
    for i in range(len(meta['file_path'])):
        out.append(((meta['width'][i], meta['height'][i]),
                    meta['focal'][i], np.array(meta['cam2world'][i])))
    return out


def visualize_cameras(camera_sets, out_path: str,
                      sphere_radius: float = 1.0,
                      spheric_path: bool = False,
                      frustum_length: float = 0.5):
    """Render colored camera sets (+ optional spheric orbit) to a PNG.

    Args:
      camera_sets: list of (color, [( (w,h), focal, c2w ), ...]).
      out_path: output PNG path.
      spheric_path: additionally draw the 120-pose orbit of
        cli/render_video.py (radius 4).
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError('visualize_cameras draws the PNG with matplotlib, '
                          'which is not installed; export_html (an --out '
                          'ending in .html) needs no more than numpy') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection='3d')

    for color, cams in camera_sets:
        frusta = [get_camera_frustum(size, focal, c2w, frustum_length)
                  for size, focal, c2w in cams]
        plot_frustums(ax, frusta, color)

    if spheric_path:
        from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses
        poses = create_spheric_poses(4.0)
        frusta = [get_camera_frustum((800, 800), 1111.0, np.vstack(
            [p, [0, 0, 0, 1]]), frustum_length) for p in poses]
        plot_frustums(ax, frusta, 'red')

    # A wireframe sphere of sphere_radius for scale.
    u = np.linspace(0, 2 * np.pi, 24)
    v = np.linspace(0, np.pi, 12)
    x = sphere_radius * np.outer(np.cos(u), np.sin(v))
    y = sphere_radius * np.outer(np.sin(u), np.sin(v))
    z = sphere_radius * np.outer(np.ones_like(u), np.cos(v))
    ax.plot_wireframe(x, y, z, color='gray', alpha=0.2, linewidth=0.3)

    ax.set_box_aspect([1, 1, 1])
    fig.savefig(out_path, dpi=120, bbox_inches='tight')
    plt.close(fig)
    return out_path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>camera frusta</title><style>
body{margin:0;background:#111;color:#ccc;font:12px monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;user-select:none}
canvas{display:block;cursor:grab}
</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
const SEGS = __SEGS__;   // [[x0,y0,z0,x1,y1,z1,"color"], ...]
const cv = document.getElementById('c'), g = cv.getContext('2d');
let yaw = 0.7, pitch = 0.4, dist = __DIST__, panX = 0, panY = 0;
function resize(){cv.width = innerWidth; cv.height = innerHeight; draw();}
function proj(p, R){
  const x = R[0]*p[0]+R[1]*p[1]+R[2]*p[2];
  const y = R[3]*p[0]+R[4]*p[1]+R[5]*p[2];
  const z = R[6]*p[0]+R[7]*p[1]+R[8]*p[2] + dist;
  if (z <= 0.05) return null;
  const f = 0.9 * Math.min(cv.width, cv.height) / z;
  return [cv.width/2 + f*x + panX, cv.height/2 - f*y + panY];
}
function draw(){
  g.fillStyle = '#111'; g.fillRect(0, 0, cv.width, cv.height);
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  // R = Rx(pitch) @ Ry(yaw), row-major.
  const R = [cy, 0, sy,  sy*sp, cp, -cy*sp,  -sy*cp, sp, cy*cp];
  for (const s of SEGS){
    const a = proj([s[0], s[1], s[2]], R), b = proj([s[3], s[4], s[5]], R);
    if (!a || !b) continue;
    g.strokeStyle = s[6]; g.globalAlpha = 0.85; g.lineWidth = 1;
    g.beginPath(); g.moveTo(a[0], a[1]); g.lineTo(b[0], b[1]); g.stroke();
  }
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => { if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { panX += dx; panY += dy; }
  else { yaw += dx * 0.01;
         pitch = Math.max(-1.55, Math.min(1.55, pitch + dy * 0.01)); }
  drag = [e.clientX, e.clientY, drag[2]]; draw(); };
cv.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); draw();
                    e.preventDefault(); };
onresize = resize; resize();
</script></body></html>
"""


def _sphere_segments(radius: float, color: str = '#555'):
    """Wireframe lat/long segments of the scale sphere."""
    segs = []
    for v in np.linspace(0.3, np.pi - 0.3, 5):          # latitude rings
        pts = [(radius * np.cos(u) * np.sin(v), radius * np.sin(u)
                * np.sin(v), radius * np.cos(v))
               for u in np.linspace(0, 2 * np.pi, 25)]
        segs += [[*pts[i], *pts[i + 1], color] for i in range(len(pts) - 1)]
    for u in np.linspace(0, np.pi, 4, endpoint=False):  # longitude rings
        pts = [(radius * np.cos(u) * np.sin(v), radius * np.sin(u)
                * np.sin(v), radius * np.cos(v))
               for v in np.linspace(0, 2 * np.pi, 25)]
        segs += [[*pts[i], *pts[i + 1], color] for i in range(len(pts) - 1)]
    return segs


def export_html(camera_sets, out_path: str, sphere_radius: float = 1.0,
                spheric_path: bool = False, frustum_length: float = 0.5):
    """Write a self-contained HTML frustum viewer (a JS canvas renderer,
    no external assets): orbit, zoom and pan in any browser, written
    headless.  Its bytes are those of the JAX package's export_html on the
    same cameras."""
    segs = _sphere_segments(sphere_radius)
    extent = [sphere_radius]
    for color, cams in camera_sets:
        for size, focal, c2w in cams:
            points, lines = get_camera_frustum(size, focal, c2w,
                                               frustum_length)
            segs += [[*points[a], *points[b], color] for a, b in lines]
            extent.append(float(np.abs(points).max()))
    if spheric_path:
        from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses
        for p in create_spheric_poses(4.0):
            points, lines = get_camera_frustum(
                (800, 800), 1111.0, np.vstack([p, [0, 0, 0, 1]]),
                frustum_length)
            segs += [[*points[a], *points[b], 'red'] for a, b in lines]
            extent.append(float(np.abs(points).max()))
    segs = [[round(float(v), 4) for v in s[:6]] + [s[6]] for s in segs]
    html = (_HTML_TEMPLATE
            .replace('__SEGS__', json.dumps(segs, separators=(',', ':')))
            .replace('__DIST__', f'{3.0 * max(extent):.3f}'))
    with open(out_path, 'w') as f:
        f.write(html)
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Parse argv (None: sys.argv), write the PNG or the HTML viewer;
    -> its path."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--data_dir', required=True)
    parser.add_argument('--out', default='cameras.png',
                        help='output path; a .html extension writes the '
                             'interactive orbit viewer instead of a PNG')
    parser.add_argument('--split', default='train')
    parser.add_argument('--multi_scale', action='store_true',
                        help='dataset is a multi-scale metadata.json dir')
    parser.add_argument('--spheric_path', action='store_true',
                        help='also draw the render_video orbit')
    args = parser.parse_args(argv)

    if args.multi_scale:
        cams = load_multicam_cameras(args.data_dir, args.split)
    else:
        size, focal, c2ws = load_blender_cameras(args.data_dir, args.split)
        cams = [(size, focal, c2w) for c2w in c2ws]
    if args.out.endswith('.html'):
        path = export_html([('#4caf50', cams)], args.out,
                           spheric_path=args.spheric_path)
    else:
        path = visualize_cameras([('green', cams)], args.out,
                                 spheric_path=args.spheric_path)
    print(f'wrote {path}')
    return path


if __name__ == '__main__':
    main()
