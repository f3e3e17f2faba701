"""The yardstick's work counts and the chip's peaks.

The operations and bytes a training step or a rendered frame needs,
counted from the configuration's shapes (a frozen copy of the arithmetic
of the port's `chip_smoke.py` `kernel_work` / `layer_shapes`), so they
read the same work whatever implements it:

  * FLOP: the MLP's matrix products at 2 operations a multiply-add.  A
    training step: both levels, forward, weight gradients and input
    gradients of every layer but the first (the encode and the view
    features need none), no recomputation.  The view layer's view half is
    a product per ray, not per sample.  A frame: the forward of both
    levels for every ray.
  * bytes: each level's Gaussians (means and diagonal covariances, 24 B a
    sample) read once and its heads (16 B a sample) written once, and for
    a step the parameters, gradients and both Adam moments read and
    written once.

Peaks are NVIDIA's published dense rates for the H100 SXM at its 700 W
limit (the card's power limit is printed beside every run).
"""

from __future__ import annotations

PEAKS = {
    'tf32': 494.7e12,       # float32 operands on the tensor cores
    'bf16': 989.4e12,
    'fp32_cuda_cores': 66.9e12,
}
HBM_BYTES_PER_S = 3.35e12


def xyz_features(hp) -> int:
    if hp.get('nerf.unbounded'):
        return 42
    return 6 * (hp['nerf.max_deg_point'] - hp['nerf.min_deg_point'])


def layer_shapes(hp):
    """(fan in, fan out) of the MLP's layers in order: trunk, density,
    bottleneck, view layers, rgb."""
    depth, width = hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_width']
    skip, fx = hp['nerf.mlp.skip_index'], xyz_features(hp)
    fv = 3 * (2 * hp['nerf.deg_view'] + int(bool(hp['nerf.append_identity'])))
    wv = hp['nerf.mlp.net_width_condition']
    shapes, d_in = [], fx
    for i in range(depth):
        shapes.append((d_in, width))
        d_in = width + (fx if i % skip == 0 and i > 0 else 0)
    shapes += [(d_in, hp['nerf.mlp.num_density_channels']), (d_in, width)]
    d_v = width + fv
    for _ in range(hp['nerf.mlp.net_depth_condition']):
        shapes.append((d_v, wv))
        d_v = wv
    shapes.append((d_v, hp['nerf.mlp.num_rgb_channels']))
    return shapes, fx, fv


def _forward(hp, rays: int, samples: int) -> float:
    shapes, _, fv = layer_shapes(hp)
    depth = hp['nerf.mlp.net_depth']
    points = rays * samples
    per_point = sum(k * n for k, n in shapes)
    view_half = fv * shapes[depth + 2][1]   # the first view layer's view rows
    return 2.0 * (points * (per_point - view_half) + rays * view_half)


def _input_grads(hp, rays: int, samples: int) -> float:
    """Every layer's input cotangent but the first trunk layer's, over the
    rows that need one (not the skip's encode rows, not the view rows)."""
    shapes, fx, fv = layer_shapes(hp)
    depth, width = hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_width']
    rows = 0
    for i, (k, n) in enumerate(shapes):
        if i == 0:
            continue
        if i < depth + 2:                    # trunk and heads read the trunk
            k = width
        elif i == depth + 2:                 # the first view layer
            k = width
        rows += k * n
    return 2.0 * rays * samples * rows


def step_flop(hp) -> float:
    rays, samples = hp['train.batch_size'], hp['nerf.num_samples']
    fwd = _forward(hp, rays, samples)
    return hp['nerf.num_levels'] * (2 * fwd + _input_grads(hp, rays, samples))


def frame_flop(hp, pixels: int) -> float:
    return hp['nerf.num_levels'] * _forward(hp, pixels, hp['nerf.num_samples'])


def _params(hp) -> int:
    shapes, _, _ = layer_shapes(hp)
    return sum((k + 1) * n for k, n in shapes)


def step_bytes(hp) -> float:
    points = hp['train.batch_size'] * hp['nerf.num_samples']
    return (hp['nerf.num_levels'] * points * (24 + 16)
            + 4 * 2 * 4 * _params(hp))


def frame_bytes(hp, pixels: int) -> float:
    return (hp['nerf.num_levels'] * pixels * hp['nerf.num_samples'] * (24 + 16)
            + 4 * _params(hp))


def bound_s(flop: float, nbytes: float, peak: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flop / peak, nbytes / HBM_BYTES_PER_S)
