"""Stratified sampling and inverse-CDF hierarchical resampling.

Counterpart of mipnerf_pl_tpu/ops/sampling.py, bounded and unbounded-360
(inverse-depth samples t_inv, descending, with full-covariance Gaussians at
t = 1/t_inv).  The interval
search is `torch.searchsorted` + `gather`; the JAX package's comparison-mask
reductions were a TPU choice and select the same bin endpoints.  The eps
padding of degenerate weights, the [0, 1-eps] deterministic u grid and the
`denom < 1e-5 -> 1` guard are kept.

Randomness: pass a `torch.Generator`, or inject the uniform draws
(`t_rand`, `u_rand`) so a test can feed two implementations the same
numbers.  A data shard passes `rows` = (start, stop, total), its rows of
a `total`-ray batch: each draw is then made at the batch's shape and the
shard's rows kept (`draw`), so the shards of a batch draw what one device
would.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mipnerf_pl_tpu_torch.ops.math import cast_rays

_F32_EPS = float(torch.finfo(torch.float32).eps)

Rows = Optional[Tuple[int, int, int]]


def draw(shape, dtype, device, generator: Optional[torch.Generator],
         rows: Rows = None, normal: bool = False) -> torch.Tensor:
    """torch.rand (torch.randn with `normal`) of `shape` [B, ...]; with
    rows = (start, stop, total), rows start:stop of the draw at [total,
    ...], so that a shard's draw equals its rows of the whole batch's."""
    fn = torch.randn if normal else torch.rand
    if rows is None:
        return fn(shape, dtype=dtype, device=device, generator=generator)
    start, stop, total = rows
    if stop - start != shape[0]:
        raise ValueError(f'rows {rows} for a draw of {shape[0]} rows')
    full = fn((total, *shape[1:]), dtype=dtype, device=device,
              generator=generator)
    return full[start:stop]


def sample_along_rays(origins, directions, radii, num_samples: int, near,
                      far, randomized: bool, disparity: bool,
                      ray_shape: str,
                      generator: Optional[torch.Generator] = None,
                      t_rand: Optional[torch.Tensor] = None,
                      rows: Rows = None):
    """Stratified samples along rays, cast to Gaussians.

    origins/directions [B, 3], radii/near/far [B, 1] ->
    (t_samples [B, N+1], (means [B, N, 3], covs [B, N, 3])).
    `t_rand` [B, N+1] in [0, 1) replaces the generator's draw."""
    batch_size = origins.shape[0]
    dtype, device = origins.dtype, origins.device
    t = torch.linspace(0.0, 1.0, num_samples + 1, dtype=dtype, device=device)
    if disparity:
        t_samples = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        t_samples = near + (far - near) * t                     # [B, N+1]
    t_samples = _stratify(t_samples, batch_size, randomized, generator,
                          t_rand, rows)
    means, covs = cast_rays(t_samples, origins, directions, radii, ray_shape)
    return t_samples, (means, covs)


def _stratify(t, batch_size: int, randomized: bool,
              generator: Optional[torch.Generator],
              t_rand: Optional[torch.Tensor], rows: Rows = None):
    """Fenceposts t [.., N+1] -> [B, N+1]: each jittered uniformly within
    the interval between its neighbours' midpoints when `randomized`
    (`t_rand`, else the generator's draw), else broadcast."""
    if not randomized:
        return t.expand(batch_size, t.shape[-1])
    mids = 0.5 * (t[..., 1:] + t[..., :-1])
    upper = torch.cat([mids, t[..., -1:]], dim=-1)
    lower = torch.cat([t[..., :1], mids], dim=-1)
    if t_rand is None:
        t_rand = draw((batch_size, t.shape[-1]), t.dtype, t.device,
                      generator, rows)
    return lower + (upper - lower) * t_rand


def sample_along_rays_360(origins, directions, radii, num_samples: int, near,
                          far, randomized: bool, ray_shape: str,
                          generator: Optional[torch.Generator] = None,
                          t_rand: Optional[torch.Tensor] = None,
                          rows: Rows = None):
    """Inverse-depth samples for unbounded scenes -> (t_inv [B, N+1],
    descending from 1/near to 1/far, (means [B, N, 3], covs [B, N, 3, 3]))
    of the segments of t = 1/t_inv.  `t_rand` as in sample_along_rays."""
    dtype, device = origins.dtype, origins.device
    t = torch.linspace(0.0, 1.0, num_samples + 1, dtype=dtype, device=device)
    t_inv = _stratify((1.0 / far) * t + (1.0 - t) * (1.0 / near),
                      origins.shape[0], randomized, generator, t_rand,
                      rows)
    means, covs = cast_rays(1.0 / t_inv, origins, directions, radii,
                            ray_shape, diagonal=False)
    return t_inv, (means, covs)


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int,
                                  randomized: bool,
                                  generator: Optional[torch.Generator] = None,
                                  u_rand: Optional[torch.Tensor] = None,
                                  rows: Rows = None):
    """Inverse-transform samples from a piecewise-constant PDF.

    bins [B, M+1] sorted, weights [B, M] >= 0 -> samples [B, S] ascending.
    `u_rand` [B, S] in [0, 1) replaces the generator's jitter draw (it is
    scaled to [0, 1/S - eps) as the JAX version scales its own draw)."""
    dtype, device = bins.dtype, bins.device
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)   # [B, M+1]

    shape = (*cdf.shape[:-1], num_samples)
    if randomized:
        s = 1.0 / num_samples
        u = torch.arange(num_samples, dtype=dtype, device=device) * s
        if u_rand is None:
            u_rand = draw(shape, dtype, device, generator, rows)
        u = u + u_rand * (s - _F32_EPS)
        u = torch.clamp(u, max=1.0 - _F32_EPS)
    else:
        u = torch.linspace(0.0, 1.0 - _F32_EPS, num_samples, dtype=dtype,
                           device=device).expand(shape)
    u = u.contiguous()

    # Right-side search: idx = #{m : cdf_m <= u}.  cdf[0] = 0 <= u and
    # cdf[-1] = 1 > u, so 1 <= idx <= M and both gathers are in range.
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def _blurpool(weights, resample_padding: float):
    """Max-filter adjacent pairs, 2-tap average, plus the Dirichlet
    padding."""
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                            dim=-1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    return weights_blur + resample_padding


def resample_along_rays(origins, directions, radii, t_samples, weights,
                        randomized: bool, ray_shape: str, stop_grad: bool,
                        resample_padding: float,
                        generator: Optional[torch.Generator] = None,
                        u_rand: Optional[torch.Tensor] = None,
                        rows: Rows = None):
    """Hierarchical resampling: blurpool the previous level's weights and
    draw new fenceposts from their PDF.

    Returns (new_t_samples [B, N+1], (means, covs))."""
    weights_blur = _blurpool(weights, resample_padding)
    new_t_samples = sorted_piecewise_constant_pdf(
        t_samples, weights_blur, t_samples.shape[-1], randomized,
        generator=generator, u_rand=u_rand, rows=rows)
    if stop_grad:
        new_t_samples = new_t_samples.detach()
    means, covs = cast_rays(new_t_samples, origins, directions, radii,
                            ray_shape)
    return new_t_samples, (means, covs)


def resample_along_rays_360(origins, directions, radii, t_inv, weights,
                            randomized: bool, ray_shape: str,
                            stop_grad: bool, resample_padding: float,
                            generator: Optional[torch.Generator] = None,
                            u_rand: Optional[torch.Tensor] = None,
                            rows: Rows = None):
    """Hierarchical resampling in inverse depth: the blurpooled weights'
    PDF over the descending t_inv bins is sampled in flipped (ascending)
    order, before the search, and the draws are flipped back.  `u_rand`
    is the jitter in the flipped order.

    Returns (new_t_inv [B, N+1] descending, (means, covs [..., 3, 3]))."""
    weights_blur = _blurpool(weights, resample_padding)
    new_asc = sorted_piecewise_constant_pdf(
        torch.flip(t_inv, dims=(-1,)), torch.flip(weights_blur, dims=(-1,)),
        t_inv.shape[-1], randomized, generator=generator, u_rand=u_rand,
        rows=rows)
    new_t_inv = torch.flip(new_asc, dims=(-1,))
    if stop_grad:
        new_t_inv = new_t_inv.detach()
    means, covs = cast_rays(1.0 / new_t_inv, origins, directions, radii,
                            ray_shape, diagonal=False)
    return new_t_inv, (means, covs)
