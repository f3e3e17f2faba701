"""Volumetric compositing and the distortion loss.

Counterpart of mipnerf_pl_tpu/ops/render.py: volumetric_rendering and
distloss.  The per-ray composite over (delta, mids) planes is `composite`;
it is also the plain version the fused lean-render kernel's composite is
checked against (kernels/mlp.py).  Kept in float32 whatever the MLP's
compute dtype.
"""

from __future__ import annotations

import torch


def composite(rgb, density, delta, mids, white_bkgd: bool):
    """rgb [B, N, 3], density [B, N], delta/mids [B, N] f32 ->
    (comp_rgb [B, 3], dist_raw [B], acc [B], weights [B, N]).

    delta = (t1 - t0) * ||dir||, mids = (t0 + t1) / 2.  dist_raw is the
    UNCLAMPED expected distance; the caller clamps it."""
    density_delta = density * delta
    alpha = 1.0 - torch.exp(-density_delta)
    # Exclusive prefix sum: trans_i = exp(-sum_{j<i} density_delta_j).
    trans = torch.exp(-(torch.cumsum(density_delta, dim=-1) - density_delta))
    weights = alpha * trans
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    dist_raw = torch.sum(weights * mids, dim=-1)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, dist_raw, acc, weights


def delta_mids(t_samples, dirs):
    """Fenceposts t_samples [B, N+1] and directions [B, 3] ->
    (delta [B, N], mids [B, N]); directions are un-normalized, so the
    interval length is scaled by ||dir||."""
    t0, t1 = t_samples[..., :-1], t_samples[..., 1:]
    delta = (t1 - t0) * torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return delta, 0.5 * (t0 + t1)


def clamp_distance(dist_raw, t_samples):
    """The reference's nan-safe clamp of the expected distance to
    [t_samples[..., 0], t_samples[..., -1]]."""
    d = torch.nan_to_num(dist_raw, nan=0.0)
    return torch.minimum(torch.maximum(d, t_samples[..., 0]),
                         t_samples[..., -1])


def volumetric_rendering(rgb, density, t_samples, dirs, white_bkgd: bool):
    """Composite per-sample (rgb [B, N, 3], density [B, N, 1]) along rays
    with fenceposts t_samples [B, N+1] and directions dirs [B, 3] ->
    (comp_rgb [B, 3], distance [B], acc [B], weights [B, N])."""
    delta, mids = delta_mids(t_samples, dirs)
    comp_rgb, dist_raw, acc, weights = composite(rgb, density[..., 0], delta,
                                                 mids, white_bkgd)
    return comp_rgb, clamp_distance(dist_raw, t_samples), acc, weights


def distloss(weights, t_samples):
    """Distortion regularizer of mip-NeRF 360 (uni- + bilateral terms),
    per-ray sums, batch mean: weights [B, N], t_samples [B, N+1] sorted
    ascending.  The bilateral sum_ij w_i w_j |m_i - m_j| is the O(N)
    prefix-sum identity 2 sum_i w_i (m_i W_<i - (wm)_<i), valid because the
    midpoints ascend."""
    interval = t_samples[..., 1:] - t_samples[..., :-1]
    mid_points = 0.5 * (t_samples[..., 1:] + t_samples[..., :-1])
    loss_uni = (1.0 / 3.0) * torch.mean(
        torch.sum(interval * weights ** 2, dim=-1))
    wm = weights * mid_points
    # Exclusive prefix sums: contributions of all j < i.
    w_before = torch.cumsum(weights, dim=-1) - weights
    wm_before = torch.cumsum(wm, dim=-1) - wm
    loss_bi = 2.0 * torch.mean(torch.sum(
        weights * (mid_points * w_before - wm_before), dim=-1))
    return loss_uni + loss_bi
