"""The Mip-NeRF MLP as a torch module.

Counterpart of mipnerf_pl_tpu/models/mlp.py.  The same layers under the
same names (`trunk_i`, `density`, `bottleneck`, `view_j`, `rgb`), each an
`nn.Linear` (weight [out, in], the transpose of the flax kernel [in, out];
convert.py maps between them), Xavier-uniform weights and zero biases.

Backends:
  'xla'   the plain forward (torch ops; named after the JAX backend it
          mirrors, so the same configs select it)
  'pallas_lean' | 'pallas_lean_save' | 'pallas_hybrid'
          `fused_mlp_lean`, the counterpart of the JAX `_call_pallas_lean`,
          in mode 'recompute', 'save' or 'hybrid': f32 encode rows (or,
          with `encode=`, the [6, B, N] moments, not for 'hybrid'), view
          features per ray, the head activations applied in the kernel
          when `fused_activation` is set (raw heads otherwise), parameter
          gradients only.
  'pallas_lean' | 'pallas_lean_save'
          with `render=`: the fused lean-render level (kernels/mlp.py
          `fused_mlp_lean_render`, mode 'recompute' or 'save'), in either
          input form; it trains through its backward and renders without.
  'pallas' | 'pallas_save'
          `fused_mlp`, the counterpart of the JAX `_call_pallas`, in mode
          'recompute' or 'save': the per-ray view features repeated over
          the samples, raw heads, and a backward that returns the input
          cotangents beside the parameter gradients, so these train with
          stop_resample_grad False.
Without view directions every backend runs the plain forward, as in JAX.

Under a model axis (`tp_mesh`, MipNeRFSystem with parallel.model_axis > 1)
the training forward of every backend is `tp_mlp_forward` on the lean flat
layout (kernels/tp_lean.py), at every shape: the trunk in Megatron pairs
over the mesh's `model` axis, the rest in torch.matmul, raw heads.  The
backend names the pairs' route: 'xla' their plain versions, every Pallas
backend the pair kernels tp_pair_fwd / tp_pair_bwd (on a CUDA tensor they
launch or raise).  x, the view features and every parameter get
gradients.  It takes encode rows and view features (none without view
directions) only: no render or encode fusion.  The parameters are the
module's own at full shapes, or on a multi-process mesh a model rank's
panels (`model_split_rows`, the state MipNeRFSystem holds there), told
apart by trunk_0's width.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mipnerf_pl_tpu_torch.kernels.mlp import (flatten_params, fused_mlp,
                                              fused_mlp_lean,
                                              fused_mlp_lean_render)
from mipnerf_pl_tpu_torch.kernels.tp_lean import tp_mlp_forward
from mipnerf_pl_tpu_torch.parallel.mesh import Mesh

# The lean training backends and their fused_mlp_lean modes.
LEAN_MODES = {'pallas_lean': 'recompute', 'pallas_lean_save': 'save',
              'pallas_hybrid': 'hybrid'}
LEAN_BACKENDS = tuple(LEAN_MODES)
# The backends with a render-fused level (the hybrid forward has none).
RENDER_BACKENDS = ('pallas_lean', 'pallas_lean_save')
# The input-differentiable backends and their fused_mlp modes.
PALLAS_MODES = {'pallas': 'recompute', 'pallas_save': 'save'}
BACKENDS = ('xla',) + LEAN_BACKENDS + tuple(PALLAS_MODES)


class MLP(nn.Module):
    """Coordinate MLP: encoded cone Gaussians -> (raw_rgb, raw_density)."""

    def __init__(self, xyz_dim: int, view_dim: int, net_depth: int = 8,
                 net_width: int = 256, net_depth_condition: int = 1,
                 net_width_condition: int = 128, skip_index: int = 4,
                 num_rgb_channels: int = 3, num_density_channels: int = 1,
                 net_activation: str = 'relu',
                 compute_dtype: torch.dtype = torch.float32,
                 backend: str = 'xla',
                 fused_activation: Optional[tuple] = None,
                 generator: Optional[torch.Generator] = None,
                 tp_mesh: Optional[Mesh] = None):
        super().__init__()
        if net_activation != 'relu':
            raise NotImplementedError(net_activation)
        self.net_depth = net_depth
        self.net_width = net_width
        self.net_depth_condition = net_depth_condition
        self.use_viewdirs = view_dim > 0
        self.skip_index = skip_index
        self.num_rgb_channels = num_rgb_channels
        self.num_density_channels = num_density_channels
        self.compute_dtype = compute_dtype
        self.backend = backend
        # (rgb_padding, density_bias) of the head activations the lean
        # kernels apply in place; None = raw heads.
        self.fused_activation = fused_activation
        # The mesh's model_view under a model axis, else None.
        self.tp_mesh = tp_mesh

        dim_in = xyz_dim
        for i in range(net_depth):
            self.add_module(f'trunk_{i}', nn.Linear(dim_in, net_width))
            dim_in = net_width
            if i % skip_index == 0 and i > 0:
                dim_in = net_width + xyz_dim
        self.density = nn.Linear(dim_in, num_density_channels)
        if view_dim > 0:
            self.bottleneck = nn.Linear(dim_in, net_width)
            dim_v = net_width + view_dim
            for j in range(net_depth_condition):
                self.add_module(f'view_{j}',
                                nn.Linear(dim_v, net_width_condition))
                dim_v = net_width_condition
            self.rgb = nn.Linear(dim_v, num_rgb_channels)
        else:
            self.rgb = nn.Linear(dim_in, num_rgb_channels)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Xavier-uniform weights, zero biases (the flax Dense init)."""
        for lin in self.children():
            nn.init.xavier_uniform_(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x, view_direction=None, render=None, encode=None):
        """x [B, N, F] encoded samples, or with `encode` = (min_deg,
        max_deg) the [6, B, N] moments, view_direction [B, Fv] per ray.

        Returns (raw_rgb [B, N, 3], raw_density [B, N, nd]) f32 (activated
        on a lean path with `fused_activation`), or with `render` = (delta
        [B, N], mids [B, N], white_bkgd) the per-ray (comp_rgb [B, 3],
        dist_raw [B], acc [B], weights [B, N]) of the lean render level."""
        if self.tp_mesh is not None:
            if render is not None or encode is not None \
                    or (view_direction is None) == self.use_viewdirs:
                raise ValueError('under a model axis the MLP takes encode '
                                 'rows and view features (none without '
                                 'view directions), with no render or '
                                 'encode fusion')
            return self._tp(x, view_direction)
        if encode is not None and self.backend not in RENDER_BACKENDS:
            raise ValueError('encode fusion requires a lean pallas backend, '
                             f'got {self.backend!r}')
        if render is not None:
            return self._lean_render(x, view_direction, *render, encode)
        if self.backend == 'xla' or view_direction is None:
            return self._plain(x, view_direction)
        if self.backend in LEAN_BACKENDS:
            return self._lean(x, view_direction, encode)
        if self.backend in PALLAS_MODES:
            return self._pallas(x, view_direction)
        raise ValueError(f'unknown mlp backend {self.backend!r}')

    def _plain(self, x, view_direction):
        """The JAX 'xla' forward: a concatenated input is split into
        row-slices of the kernel; activations in the compute dtype."""
        cd = self.compute_dtype
        num_samples = x.shape[-2]
        lead = x.shape[:-1]

        def dense(lin, *xs):
            k = lin.weight.t().to(cd)
            out, off = lin.bias.to(cd), 0
            for t in xs:
                out = out + t @ k[off:off + t.shape[-1]]
                off += t.shape[-1]
            return out

        x = x.reshape(-1, x.shape[-1]).to(cd)
        inputs = x
        skip = None
        for i in range(self.net_depth):
            parts = (x,) if skip is None else (x, skip)
            x = torch.relu(dense(getattr(self, f'trunk_{i}'), *parts))
            skip = inputs if (i % self.skip_index == 0 and i > 0) else None
        trunk = (x,) if skip is None else (x, skip)
        raw_density = dense(self.density, *trunk)
        if view_direction is not None:
            bottleneck = dense(self.bottleneck, *trunk)
            view = view_direction.to(cd)

            def split_dense(lin, per_sample):
                """concat(per_sample, view) @ kernel + bias with the view
                half projected once per ray and broadcast over samples."""
                k = lin.weight.t().to(cd)
                w_in = per_sample.shape[-1]
                per_ray = view @ k[w_in:] + lin.bias.to(cd)
                out = (per_sample @ k[:w_in]).reshape(
                    -1, num_samples, k.shape[1]) + per_ray[:, None, :]
                return out.reshape(-1, k.shape[1])

            for j in range(self.net_depth_condition):
                lin = getattr(self, f'view_{j}')
                x = torch.relu(split_dense(lin, bottleneck) if j == 0
                               else dense(lin, x))
            if self.net_depth_condition == 0:
                raw_rgb = split_dense(self.rgb, bottleneck)
            else:
                raw_rgb = dense(self.rgb, x)
        else:
            raw_rgb = dense(self.rgb, *trunk)
        return (raw_rgb.reshape(*lead, self.num_rgb_channels).float(),
                raw_density.reshape(*lead, self.num_density_channels).float())

    def _pallas(self, x, view_direction):
        """The 'pallas' / 'pallas_save' forward: x [B, N, F], view_direction
        [B, Fv] repeated to every sample as JAX does (autograd sums dview
        back per ray) -> (raw_rgb [B, N, 3], raw_density [B, N, nd]); x,
        view and every parameter get gradients.  The repeat is an expand
        and a copy, whose backward is a sum over the samples."""
        num_samples = x.shape[-2]
        lead = x.shape[:-1]
        flat = flatten_params(self, self.net_depth, self.net_depth_condition)
        B, Fv = view_direction.shape
        view = view_direction[:, None, :].expand(B, num_samples, Fv)
        rgb, density = fused_mlp(
            x.reshape(-1, x.shape[-1]), view.reshape(-1, Fv), flat,
            self.net_depth, self.net_depth_condition, self.skip_index,
            self.compute_dtype, PALLAS_MODES[self.backend])
        return (rgb.reshape(*lead, self.num_rgb_channels),
                density.reshape(*lead, self.num_density_channels))

    def _tp(self, x, view_direction):
        """The training forward under a model axis: x [B, N, F] encode
        rows, view_direction [B, Fv] (or None) -> raw (rgb [B, N, 3],
        density [B, N, nd]) through `tp_mlp_forward` on `tp_mesh`."""
        if self.backend not in BACKENDS:
            raise ValueError(f'unknown mlp backend {self.backend!r}')
        num_samples, lead = x.shape[-2], x.shape[:-1]
        flat = flatten_params(self, self.net_depth, self.net_depth_condition,
                              self.use_viewdirs)
        rgb, density = tp_mlp_forward(
            x.reshape(-1, x.shape[-1]),
            None if view_direction is None else
            view_direction.reshape(-1, view_direction.shape[-1]),
            flat, self.tp_mesh, num_samples, self.net_depth,
            self.net_depth_condition, self.skip_index, self.compute_dtype,
            plain=self.backend == 'xla',
            local=flat[0].shape[1] != self.net_width)
        return (rgb.reshape(*lead, self.num_rgb_channels),
                density.reshape(*lead, self.num_density_channels))

    def _check_lean_heads(self, what: str):
        if self.num_rgb_channels != 3 or self.num_density_channels != 1:
            raise ValueError(f'{what} requires 3 rgb channels and 1 density '
                             'channel')

    @staticmethod
    def _lean_x_layout(x, encode):
        """(num_samples, lead, x2) of a lean input in either form: encode
        rows [.., N, F] -> [M, F], or the moments [6, .., N] -> [6, M]
        (JAX's `_lean_x_layout`)."""
        if encode is None:
            return x.shape[-2], x.shape[:-1], x.reshape(-1, x.shape[-1])
        return x.shape[-1], x.shape[1:], x.reshape(x.shape[0], -1)

    def _lean(self, x, view_direction, encode=None):
        """Training form of the lean backends: x [B, N, F] f32 encode rows
        or the [6, B, N] moments, view_direction [B, Fv] -> (rgb [B, N, 3],
        density [B, N, 1]), activated when fused_activation is set;
        gradients reach the parameters only."""
        self._check_lean_heads('the lean training kernels')
        num_samples, lead, x2 = self._lean_x_layout(x, encode)
        flat = flatten_params(self, self.net_depth, self.net_depth_condition)
        rgb, density = fused_mlp_lean(
            x2, view_direction.reshape(-1, view_direction.shape[-1]), flat,
            num_samples, self.net_depth, self.net_depth_condition,
            self.skip_index, self.compute_dtype, LEAN_MODES[self.backend],
            self.fused_activation, encode)
        return rgb.reshape(*lead, 3), density.reshape(*lead, 1)

    def _lean_render(self, x, view_direction, delta, mids, white_bkgd,
                     encode):
        if self.backend not in RENDER_BACKENDS:
            raise ValueError('render fusion requires a lean pallas backend, '
                             f'got {self.backend!r}')
        self._check_lean_heads('render fusion')
        if view_direction is None:
            raise ValueError('render fusion requires view directions')
        num_samples, lead_x, x2 = self._lean_x_layout(x, encode)
        lead = lead_x[:-1]
        flat = flatten_params(self, self.net_depth, self.net_depth_condition)
        comp, dist, acc, w = fused_mlp_lean_render(
            x2, view_direction.reshape(-1, view_direction.shape[-1]),
            delta.reshape(-1, num_samples), mids.reshape(-1, num_samples),
            flat, num_samples, self.net_depth, self.net_depth_condition,
            self.skip_index, self.compute_dtype, self.fused_activation,
            bool(white_bkgd), encode, LEAN_MODES[self.backend])
        return (comp.reshape(*lead, 3), dist.reshape(*lead),
                acc.reshape(*lead), w.reshape(*lead, num_samples))
