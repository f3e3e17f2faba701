"""MipNerf: coarse-to-fine cone-cast rendering with one shared MLP.

Counterpart of mipnerf_pl_tpu/models/mipnerf.py.  Level 0 samples
stratified, level >= 1 resamples from the previous level's weights; each
level encodes its cone Gaussians with the IPE, runs the MLP and composites.
With `unbounded` (mip-NeRF 360 scenes) the levels sample in inverse depth
t_inv, encode full-covariance Gaussians contracted into a ball with the
42-feature icosahedral IPE (`integrated_pos_enc_360`), and composite over
t = 1/t_inv; LevelOutput.t_samples then holds t_inv (descending).  The
kernel encodes and `ipe_backend` do not apply there, as in JAX; render
fusion does, over 1/t_inv.

Training with a lean backend ('pallas_lean', 'pallas_lean_save',
'pallas_hybrid') runs `fused_mlp_lean`; it applies the head activations
itself when the model's activations are the defaults and density_noise is
0, as in JAX (otherwise it returns the raw heads and the activations, with
the noise, run here), and the heads are composited by the plain
`volumetric_rendering` with autograd through it.  The lean backends give
the encoded inputs no gradient, so they require stop_resample_grad
(checked at construction).  With stop_resample_grad False the model
trains on 'xla' or on the input-differentiable 'pallas' / 'pallas_save'
(`fused_mlp`: raw heads, activated here as on 'xla'; its backward returns
the encode's and the view features' cotangents, so the gradient reaches
the coarse level through the resampled samples, as in JAX).

The options of the lean path engage as the JAX model's gates say
(mipnerf_pl_tpu/models/mipnerf.py `setup`):
  fuse_render   ('pallas_lean' / 'pallas_lean_save', activations fused)
                each level runs the render-fused level (MLP, activations
                and compositing in the kernels; only the nan-safe distance
                clamp stays outside), in training through its backward;
  fuse_encode   (the same backends, max_deg_point <= 16) the kernels take
                the [6, B, N] moments and decode the IPE per tile;
  pallas_encode (where fast_encode_math would engage and fuse_encode does
                not) the [M, 6L] encode rows come from the `ipe_moments`
                kernel.
Under a model axis (`tp_mesh`, the mesh's model_view: MipNeRFSystem with
parallel.model_axis > 1) the MLP runs the Megatron split of
`tp_mlp_forward` on raw heads, so fuse_render, fuse_encode and the lean
kernels' fused head activations are off, each named in `tp_off`; the
encode feeds rows (through `ipe_moments` or `fused_ipe` where
pallas_encode / ipe_backend say so), and the activations, the density
noise and the compositing run here, as on 'xla'.
`fast_encode_math` selects no fast transcendentals in the port: the kernel
encodes take their sines from one exact FP64 reduction a (point, dim)
(csrc/ipe_core.cuh), within ~0.5 ulp of float64 sin of each f32 argument,
and libm's exact expf.  It only gates `pallas_encode`, as in JAX.
MipNeRFSystem's eval model (val.mlp_backend='auto') takes fuse_render and
fuse_encode for rendering.

`ipe_backend='pallas'` (any MLP backend) encodes with `fused_ipe`
(kernels/ipe.py: the standalone IPE kernel, whose backward kernel returns
the Gaussians' cotangents, so it also serves stop_resample_grad False); it
turns the two kernel encodes above off, as in JAX, and computes the cosine
half as the cosine where the default 'xla' encode takes sin(y + pi/2).

Knobs that steer TPU-only machinery (`channel_major`, `lean_input_cast`,
`mxu_cumsum`) are accepted and have no effect.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from mipnerf_pl_tpu_torch.kernels.ipe import fused_ipe
from mipnerf_pl_tpu_torch.kernels.mlp import ipe_moments
from mipnerf_pl_tpu_torch.models.mlp import (LEAN_BACKENDS, MLP,
                                             RENDER_BACKENDS)
from mipnerf_pl_tpu_torch.ops.math import (cast_rays_cmajor,
                                           integrated_pos_enc,
                                           integrated_pos_enc_360, pos_enc)
from mipnerf_pl_tpu_torch.ops.render import (clamp_distance, delta_mids,
                                             volumetric_rendering)
from mipnerf_pl_tpu_torch.ops.sampling import (Rows, draw,
                                               resample_along_rays,
                                               resample_along_rays_360,
                                               sample_along_rays,
                                               sample_along_rays_360)
from mipnerf_pl_tpu_torch.rays import Rays


class LevelOutput(NamedTuple):
    """Per-level render result."""

    rgb: torch.Tensor        # [B, 3] composited colour
    distance: torch.Tensor   # [B] expected termination distance
    acc: torch.Tensor        # [B] accumulated opacity
    weights: torch.Tensor    # [B, N] per-sample compositing weights
    t_samples: torch.Tensor  # [B, N+1] fencepost distances (unbounded: t_inv)


class MipNerf(nn.Module):
    """Mip-NeRF with a shared MLP across sampling levels."""

    def __init__(self, num_samples: int = 128, num_levels: int = 2,
                 resample_padding: float = 0.01,
                 stop_resample_grad: bool = True, use_viewdirs: bool = True,
                 disparity: bool = False, ray_shape: str = 'cone',
                 min_deg_point: int = 0, max_deg_point: int = 16,
                 deg_view: int = 4, density_activation: str = 'softplus',
                 density_noise: float = 0.0, density_bias: float = -1.0,
                 rgb_activation: str = 'sigmoid', rgb_padding: float = 0.001,
                 disable_integration: bool = False,
                 append_identity: bool = True, mlp_net_depth: int = 8,
                 mlp_net_width: int = 256, mlp_net_depth_condition: int = 1,
                 mlp_net_width_condition: int = 128, mlp_skip_index: int = 4,
                 mlp_num_rgb_channels: int = 3,
                 mlp_num_density_channels: int = 1,
                 mlp_net_activation: str = 'relu',
                 compute_dtype: torch.dtype = torch.float32,
                 unbounded: bool = False, ipe_backend: str = 'xla',
                 mlp_backend: str = 'xla', fuse_render: bool = False,
                 fuse_encode: bool = False, fast_encode_math: bool = True,
                 pallas_encode: bool = False,
                 generator: Optional[torch.Generator] = None,
                 tp_mesh=None, **tpu_only_knobs):
        super().__init__()
        unknown = set(tpu_only_knobs) - {
            'channel_major', 'lean_input_cast', 'mxu_cumsum'}
        if unknown:
            raise TypeError(f'unknown MipNerf options: {sorted(unknown)}')
        if ipe_backend not in ('xla', 'pallas'):
            raise ValueError(f'ipe_backend must be "xla" or "pallas", got '
                             f'{ipe_backend!r}')
        if rgb_activation != 'sigmoid':
            raise NotImplementedError(rgb_activation)
        if density_activation not in ('softplus', 'relu'):
            raise NotImplementedError(density_activation)
        if mlp_backend in LEAN_BACKENDS and not stop_resample_grad:
            # The lean kernels' backward gives the encoded inputs no
            # gradient; that is exact only while stop_resample_grad blocks
            # the one parameter-dependent input path (level-0 weights ->
            # level-1 resampled positions).
            raise ValueError(
                f'nerf.mlp_backend={mlp_backend!r} requires '
                f'nerf.stop_resample_grad=True (its backward produces '
                f'parameter gradients only); use the "xla" or "pallas" '
                f'backend to train with resample gradients enabled')
        self.num_samples = num_samples
        self.num_levels = num_levels
        self.resample_padding = resample_padding
        self.stop_resample_grad = stop_resample_grad
        self.use_viewdirs = use_viewdirs
        self.disparity = disparity
        self.ray_shape = ray_shape
        self.min_deg_point = min_deg_point
        self.max_deg_point = max_deg_point
        self.deg_view = deg_view
        self.density_activation = density_activation
        self.density_noise = density_noise
        self.density_bias = density_bias
        self.rgb_padding = rgb_padding
        self.disable_integration = disable_integration
        self.append_identity = append_identity
        self.ipe_backend = ipe_backend
        self.mlp_backend = mlp_backend
        self.unbounded = unbounded
        # The lean kernels apply the default head activations themselves;
        # density noise sits between raw head and activation, so fusion
        # needs it off (the same gate as the JAX model).
        self._fused_act = (mlp_backend in LEAN_BACKENDS and use_viewdirs
                           and density_activation == 'softplus'
                           and density_noise == 0.0)
        # Render fusion needs a lean backend with a render-fused level: the
        # hybrid forward has none (in JAX it composites in XLA).
        self._fused_render = (fuse_render and self._fused_act
                              and mlp_backend in RENDER_BACKENDS
                              and mlp_num_rgb_channels == 3
                              and mlp_num_density_channels == 1)
        # The kernel encodes (the JAX gates): the in-kernel decode of the
        # moments, and the standalone moments encode where JAX's fast-math
        # encode would run.  JAX bounds both at max_deg_point 16 (its fast
        # sine's range); the port keeps that bound.
        fastmath_ok = max_deg_point <= 16
        self._fused_encode = (fuse_encode and self._fused_act and fastmath_ok
                              and mlp_backend in RENDER_BACKENDS
                              and not unbounded and ipe_backend == 'xla')
        # What the model axis turns off (the options that would engage on
        # one device).
        self.tp_off = []
        if tp_mesh is not None:
            self.tp_off = [name for name, on in (
                ('nerf.fuse_render', self._fused_render),
                ('nerf.fuse_encode', self._fused_encode),
                ('the fused head activations', self._fused_act)) if on]
            self._fused_act = self._fused_render = False
            self._fused_encode = False
        self._fast_encode_math = (fast_encode_math and fastmath_ok
                                  and mlp_backend in RENDER_BACKENDS
                                  and use_viewdirs and not unbounded
                                  and ipe_backend == 'xla')
        self._pallas_encode = (pallas_encode and self._fast_encode_math
                               and not self._fused_encode)
        # The icosahedral encode: 21 sines and 21 cosines.
        xyz_dim = 42 if unbounded else 2 * (max_deg_point - min_deg_point) * 3
        view_dim = (2 * deg_view + int(append_identity)) * 3 \
            if use_viewdirs else 0
        self.mlp = MLP(
            xyz_dim, view_dim, net_depth=mlp_net_depth,
            net_width=mlp_net_width,
            net_depth_condition=mlp_net_depth_condition,
            net_width_condition=mlp_net_width_condition,
            skip_index=mlp_skip_index, num_rgb_channels=mlp_num_rgb_channels,
            num_density_channels=mlp_num_density_channels,
            net_activation=mlp_net_activation, compute_dtype=compute_dtype,
            backend=mlp_backend,
            fused_activation=((float(rgb_padding), float(density_bias))
                              if self._fused_act else None),
            generator=generator, tp_mesh=tp_mesh)

    def _density_act(self, x):
        if self.density_activation == 'softplus':
            return nn.functional.softplus(x)
        return torch.relu(x)

    def _moments_stream(self, t_samples, rays):
        """[6, B, N] channel-major moments for the kernel encodes;
        disable_integration zeroes the covariance rows."""
        moments = cast_rays_cmajor(t_samples, rays.origins, rays.directions,
                                   rays.radii, self.ray_shape)
        if self.disable_integration:
            moments = torch.cat([moments[:3], torch.zeros_like(moments[3:])],
                                dim=0)
        return moments

    def forward(self, rays: Rays, randomized: bool, white_bkgd: bool,
                generator: Optional[torch.Generator] = None,
                rows: Rows = None) -> Tuple[LevelOutput, ...]:
        """Render a batch of rays [B, ...] at every level (coarse first).
        `generator` drives the stratified jitter, the resample jitter and
        the density noise when `randomized`; a data shard passes its `rows`
        (start, stop, total) of the whole batch, and each draw is made at
        the batch's shape (ops/sampling.py `draw`)."""
        ret = []
        t_samples, weights = None, None
        for i_level in range(self.num_levels):
            if self.unbounded and i_level == 0:
                t_samples, means_covs = sample_along_rays_360(
                    rays.origins, rays.directions, rays.radii,
                    self.num_samples, rays.near, rays.far, randomized,
                    self.ray_shape, generator=generator, rows=rows)
            elif self.unbounded:
                t_samples, means_covs = resample_along_rays_360(
                    rays.origins, rays.directions, rays.radii, t_samples,
                    weights, randomized, self.ray_shape,
                    self.stop_resample_grad, self.resample_padding,
                    generator=generator, rows=rows)
            elif i_level == 0:
                t_samples, means_covs = sample_along_rays(
                    rays.origins, rays.directions, rays.radii,
                    self.num_samples, rays.near, rays.far, randomized,
                    self.disparity, self.ray_shape, generator=generator,
                    rows=rows)
            else:
                t_samples, means_covs = resample_along_rays(
                    rays.origins, rays.directions, rays.radii, t_samples,
                    weights, randomized, self.ray_shape,
                    self.stop_resample_grad, self.resample_padding,
                    generator=generator, rows=rows)
            viewdirs_enc = (pos_enc(rays.viewdirs, 0, self.deg_view,
                                    self.append_identity)
                            if self.use_viewdirs else None)

            encode = None
            degrees = (self.min_deg_point, self.max_deg_point)
            if self._fused_encode:
                samples_enc = self._moments_stream(t_samples, rays)
                encode = degrees
            elif self._pallas_encode:
                moments = self._moments_stream(t_samples, rays)
                samples_enc = ipe_moments(moments.reshape(6, -1), *degrees
                                          ).reshape(*moments.shape[1:], -1)
            else:
                means, covs = means_covs
                if self.disable_integration:
                    covs = torch.zeros_like(covs)
                if self.unbounded:
                    samples_enc = integrated_pos_enc_360((means, covs))
                elif self.ipe_backend == 'pallas':
                    samples_enc = fused_ipe(means, covs, *degrees)
                else:
                    samples_enc = integrated_pos_enc((means, covs), *degrees)

            # Unbounded: t_samples holds t_inv; composite over the world
            # distances 1/t_inv (ascending).
            t_render = 1.0 / t_samples if self.unbounded else t_samples
            if self._fused_render:
                delta, mids = delta_mids(t_render, rays.directions)
                comp_rgb, dist_raw, acc, weights = self.mlp(
                    samples_enc, viewdirs_enc, (delta, mids, white_bkgd),
                    encode)
                ret.append(LevelOutput(comp_rgb,
                                       clamp_distance(dist_raw, t_render),
                                       acc, weights, t_samples))
                continue

            raw_rgb, raw_density = self.mlp(samples_enc, viewdirs_enc,
                                            None, encode)
            if self._fused_act:
                # The lean kernel applied the activations already.
                rgb, density = raw_rgb, raw_density
            else:
                if randomized and self.density_noise > 0:
                    raw_density = raw_density + self.density_noise * draw(
                        raw_density.shape, raw_density.dtype,
                        raw_density.device, generator, rows, normal=True)
                rgb = torch.sigmoid(raw_rgb)
                rgb = rgb * (1.0 + 2.0 * self.rgb_padding) - self.rgb_padding
                density = self._density_act(raw_density + self.density_bias)
            comp_rgb, distance, acc, weights = volumetric_rendering(
                rgb, density, t_render, rays.directions, white_bkgd)
            ret.append(LevelOutput(comp_rgb, distance, acc, weights,
                                   t_samples))
        return tuple(ret)


def make_mipnerf_from_hparams(hparams: dict,
                              compute_dtype: torch.dtype = torch.float32,
                              generator: Optional[torch.Generator] = None,
                              tp_mesh=None) -> MipNerf:
    """Build a MipNerf from the flat dotted-key hparams dict (its MLP
    split over `tp_mesh`'s model axis where one is given)."""
    return MipNerf(
        num_samples=hparams['nerf.num_samples'],
        num_levels=hparams['nerf.num_levels'],
        resample_padding=hparams['nerf.resample_padding'],
        stop_resample_grad=hparams['nerf.stop_resample_grad'],
        use_viewdirs=hparams['nerf.use_viewdirs'],
        disparity=hparams['nerf.disparity'],
        ray_shape=hparams['nerf.ray_shape'],
        min_deg_point=hparams['nerf.min_deg_point'],
        max_deg_point=hparams['nerf.max_deg_point'],
        deg_view=hparams['nerf.deg_view'],
        density_activation=hparams['nerf.density_activation'],
        density_noise=hparams['nerf.density_noise'],
        density_bias=hparams['nerf.density_bias'],
        rgb_activation=hparams['nerf.rgb_activation'],
        rgb_padding=hparams['nerf.rgb_padding'],
        disable_integration=hparams['nerf.disable_integration'],
        append_identity=bool(hparams['nerf.append_identity']),
        mlp_net_depth=hparams['nerf.mlp.net_depth'],
        mlp_net_width=hparams['nerf.mlp.net_width'],
        mlp_net_depth_condition=hparams['nerf.mlp.net_depth_condition'],
        mlp_net_width_condition=hparams['nerf.mlp.net_width_condition'],
        mlp_skip_index=hparams['nerf.mlp.skip_index'],
        mlp_num_rgb_channels=hparams['nerf.mlp.num_rgb_channels'],
        mlp_num_density_channels=hparams['nerf.mlp.num_density_channels'],
        mlp_net_activation=hparams['nerf.mlp.net_activation'],
        compute_dtype=compute_dtype,
        unbounded=bool(hparams.get('nerf.unbounded', False)),
        ipe_backend=str(hparams.get('nerf.ipe_backend', 'xla')),
        mlp_backend=str(hparams.get('nerf.mlp_backend', 'xla')),
        fuse_render=bool(hparams.get('nerf.fuse_render', False)),
        fuse_encode=bool(hparams.get('nerf.fuse_encode', False)),
        fast_encode_math=bool(hparams.get('nerf.fast_encode_math', True)),
        pallas_encode=bool(hparams.get('nerf.pallas_encode', False)),
        generator=generator, tp_mesh=tp_mesh,
    )
