"""Cone-casting math and positional encodings.

Counterpart of mipnerf_pl_tpu/ops/math.py: the bounded, diagonal-covariance
path, the full-covariance lift, and the unbounded-360 pieces (`contract`,
`track_linearize`, `integrated_pos_enc_360`).  Same formulas in the same
operation order, so f32 results agree with the JAX functions to rounding.
The encode uses exact libm exp/sin: the JAX package's polynomial
`fast_exp`/`fast_sin` were a TPU throughput choice.
"""

from __future__ import annotations

import numpy as np
import torch


def lift_gaussian(directions, t_mean, t_var, r_var, diagonal: bool):
    """Lift a per-ray 1-D Gaussian (along the ray) to a 3-D Gaussian.

    directions [..., 3], t_mean/t_var/r_var [..., N] ->
    (mean [..., N, 3], cov [..., N, 3] or [..., N, 3, 3])."""
    mean = directions[..., None, :] * t_mean[..., None]
    d_sq = torch.sum(directions ** 2, dim=-1, keepdim=True) + 1e-10
    if diagonal:
        d_outer_diag = directions ** 2
        null_outer_diag = 1.0 - d_outer_diag / d_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = directions[..., :, None] * directions[..., None, :]
    eye = torch.eye(directions.shape[-1], dtype=directions.dtype,
                    device=directions.device)
    null_outer = eye - directions[..., :, None] * (directions / d_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def _frustum_moments(t0, t1, base_radius):
    """(t_mean, t_var, r_var) of a conical frustum, stable parameterization
    (Mip-NeRF eq. 7)."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    denom = 3.0 * mu ** 2 + hw ** 2
    t_mean = mu + (2.0 * mu * hw ** 2) / denom
    t_var = hw ** 2 / 3.0 - (4.0 / 15.0) * (
        hw ** 4 * (12.0 * mu ** 2 - hw ** 2)) / denom ** 2
    r_var = base_radius ** 2 * (mu ** 2 / 4.0 + (5.0 / 12.0) * hw ** 2
                                - (4.0 / 15.0) * hw ** 4 / denom)
    return t_mean, t_var, r_var


def _cylinder_moments(t0, t1, radius):
    return (t0 + t1) / 2.0, (t1 - t0) ** 2 / 12.0, radius ** 2 / 4.0


def conical_frustum_to_gaussian(directions, t0, t1, base_radius,
                                diagonal: bool):
    """Approximate the conical frustum [t0, t1] as a Gaussian."""
    return lift_gaussian(directions, *_frustum_moments(t0, t1, base_radius),
                         diagonal)


def cylinder_to_gaussian(directions, t0, t1, radius, diagonal: bool):
    """Approximate the cylinder segment [t0, t1] as a Gaussian."""
    return lift_gaussian(directions, *_cylinder_moments(t0, t1, radius),
                         diagonal)


_SHAPES = {'cone': (conical_frustum_to_gaussian, _frustum_moments),
           'cylinder': (cylinder_to_gaussian, _cylinder_moments)}


def _shape(ray_shape: str):
    if ray_shape not in _SHAPES:
        raise ValueError(f'unknown ray_shape: {ray_shape!r}')
    return _SHAPES[ray_shape]


def cast_rays(t_samples, origins, directions, radii, ray_shape: str = 'cone',
              diagonal: bool = True):
    """Gaussians of the segments between fencepost distances.

    t_samples [..., N+1], origins/directions [..., 3], radii [..., 1] ->
    (means [..., N, 3], covs [..., N, 3] (or [..., N, 3, 3]))."""
    t0 = t_samples[..., :-1]
    t1 = t_samples[..., 1:]
    means, covs = _shape(ray_shape)[0](directions, t0, t1, radii, diagonal)
    return means + origins[..., None, :], covs


def cast_rays_cmajor(t_samples, origins, directions, radii,
                     ray_shape: str = 'cone'):
    """Channel-major `cast_rays` (diagonal only): ONE [6, ..., N] tensor —
    rows 0-2 the means xyz, rows 3-5 the diagonal covariances xyz.  The
    moments stream the fused lean-render kernel decodes in place of the
    [M, 2*L*3] encode."""
    t0 = t_samples[..., :-1]
    t1 = t_samples[..., 1:]
    t_mean, t_var, r_var = _shape(ray_shape)[1](t0, t1, radii)
    d = torch.movedim(directions, -1, 0)[..., None]          # [3, ..., 1]
    o = torch.movedim(origins, -1, 0)[..., None]
    d_sq = torch.sum(directions ** 2, dim=-1)[None, ..., None] + 1e-10
    means = d * t_mean[None] + o                              # [3, ..., N]
    d_outer_diag = d ** 2
    null_outer_diag = 1.0 - d_outer_diag / d_sq
    covs = t_var[None] * d_outer_diag + r_var[None] * null_outer_diag
    return torch.cat([means, covs], dim=0)                    # [6, ..., N]


def integrated_pos_enc(means_covs, min_deg: int, max_deg: int):
    """Integrated positional encoding, diagonal covariances.

    (means [..., D], covs [..., D]) -> [..., 2*L*D]: the sin block then the
    cos block (cos(y) as sin(y + pi/2)), each indexed k*D + d (degree-major).
    Each feature is one coordinate times 2^(min_deg + k), exact in f32."""
    means, covs = means_covs
    L, D = max_deg - min_deg, means.shape[-1]
    dtype, device = means.dtype, means.device
    scale = torch.tensor([2.0 ** (min_deg + k) for k in range(L)],
                         dtype=dtype, device=device)
    scale = scale.repeat_interleave(D).repeat(2)               # [2*L*D]
    phase = torch.cat([torch.zeros(L * D, dtype=dtype, device=device),
                       torch.full((L * D,), 0.5 * np.pi, dtype=dtype,
                                  device=device)])

    def tiled(t):
        """[..., D] -> [..., 2*L*D], coordinate d at every k*D + d: an
        expand and a copy, whose backward is a sum (an index gather's is a
        sorted index_put, ~2.5 ms a lego level on an H100)."""
        lead = t.shape[:-1]
        return t[..., None, :].expand(*lead, 2 * L, D).reshape(*lead, -1)
    y = tiled(means) * scale
    yv = tiled(covs) * (scale * scale)
    return torch.exp(-0.5 * yv) * torch.sin(y + phase)


def pos_enc(x, min_deg: int, max_deg: int, append_identity: bool = True):
    """Classic NeRF positional encoding (view directions): optional
    identity, then the sin block, then the cos block."""
    scales = torch.as_tensor([2.0 ** i for i in range(min_deg, max_deg)],
                             dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * scales[:, None]                   # [..., L, D]
    xb = xb.reshape(*xb.shape[:-2], -1)                      # [..., L*D]
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * np.pi], dim=-1))
    if append_identity:
        return torch.cat([x, four_feat], dim=-1)
    return four_feat


# ---------------------------------------------------------------------------
# Unbounded-360: scene contraction and the icosahedral IPE.  The 3 x 3 and
# 3 x 21 products are written as sums of elementwise products, so they stay
# in full f32 on a card whatever the matmul precision setting (TF32 would
# cost ~1e-3 here).
# ---------------------------------------------------------------------------

# mip-NeRF 360's icosahedron-derived basis: 21 directions, used as columns.
_ICOSA_P = np.array(
    [[0.8506508, 0.0, 0.5257311],
     [0.809017, 0.5, 0.309017],
     [0.5257311, 0.8506508, 0.0],
     [1.0, 0.0, 0.0],
     [0.809017, 0.5, -0.309017],
     [0.8506508, 0.0, -0.5257311],
     [0.309017, 0.809017, -0.5],
     [0.0, 0.5257311, -0.8506508],
     [0.5, 0.309017, -0.809017],
     [0.0, 1.0, 0.0],
     [-0.5257311, 0.8506508, 0.0],
     [-0.309017, 0.809017, -0.5],
     [0.0, 0.5257311, 0.8506508],
     [-0.309017, 0.809017, 0.5],
     [0.309017, 0.809017, 0.5],
     [0.5, 0.309017, 0.809017],
     [0.5, -0.309017, 0.809017],
     [0.0, 0.0, 1.0],
     [-0.5, 0.309017, 0.809017],
     [-0.809017, 0.5, 0.309017],
     [-0.809017, 0.5, -0.309017]], dtype=np.float32).T  # [3, 21]


def _norm(x):
    """||x|| over the last axis, floored at 1e-10, keepdim."""
    return torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-10)


def contract(x):
    """Scene contraction of mip-NeRF 360: R^3 into the ball of radius 2,
    (2 - 1/||x||) x / ||x||, the norm floored at 1e-10."""
    norm = _norm(x)
    return (2.0 - 1.0 / norm) * x / norm


def _contract_jacobian(x):
    """d contract / dx [M, 3, 3] at x [M, 3]: with n = ||x|| and u = x / n,
    (2 - 1/n) / n I + (1/n^2 - (2 - 1/n) / n) u u^T."""
    n = _norm(x)
    u = x / n
    g = (2.0 - 1.0 / n) / n                                   # [M, 1]
    outer = u[:, :, None] * u[:, None, :]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    return g[:, :, None] * eye + (1.0 / (n * n) - g)[:, :, None] * outer


def _mm3(a, b):
    """a [M, i, 3] @ b [M, 3, k] as three elementwise products."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def track_linearize(means, covs):
    """Push Gaussians through `contract` by its Jacobian J where ||mean|| >
    1 (mean -> contract(mean), cov -> J cov J^T), unchanged elsewhere.
    means [..., 3], covs [..., 3] (diagonal) or [..., 3, 3] ->
    (means [..., 3], covs [..., 3, 3])."""
    shape = means.shape
    x = means.reshape(-1, 3)
    if covs.shape == shape:
        cov = torch.diag_embed(covs.reshape(-1, 3))
    else:
        cov = covs.reshape(-1, 3, 3)
    jac = _contract_jacobian(x)
    contracted = _mm3(_mm3(jac, cov), jac.transpose(-1, -2))
    mask = torch.linalg.norm(x, dim=-1, keepdim=True) > 1.0
    new_means = torch.where(mask, contract(x), x)
    new_covs = torch.where(mask[..., None], contracted, cov)
    return new_means.reshape(shape), new_covs.reshape(*shape, 3)


def integrated_pos_enc_360(means_covs):
    """Icosahedral IPE of contracted Gaussians: (means [..., N, 3], covs
    [..., N, 3] or [..., N, 3, 3]) -> [..., N, 42], the 21 damped sines
    then the 21 cosines (as sin(y + pi/2))."""
    means, covs = means_covs
    means, x_cov = track_linearize(means, covs)
    P = torch.as_tensor(_ICOSA_P, dtype=means.dtype, device=means.device)
    y = (means[..., 0:1] * P[0] + means[..., 1:2] * P[1]
         + means[..., 2:3] * P[2])                             # [..., N, 21]
    cov_p = _mm3(x_cov, P)                                     # [..., 3, 21]
    y_var = cov_p[..., 0, :] * P[0] + cov_p[..., 1, :] * P[1] \
        + cov_p[..., 2, :] * P[2]
    scale = torch.exp(-0.5 * y_var)
    return torch.cat([scale * torch.sin(y),
                      scale * torch.sin(y + 0.5 * np.pi)], dim=-1)
