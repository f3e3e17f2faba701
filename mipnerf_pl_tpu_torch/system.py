"""MipNeRFSystem, render half.

Counterpart of mipnerf_pl_tpu/train/system.py: the same eval-model
selection from `val.mlp_backend` ('auto' picks the fused lean-render path
when the model config supports it, else the plain forward), and the
full-image renders behind eval and video: `render_camera` builds the rays
on the device from a Camera, `render_image` takes a ray bundle.  Both run
fixed-size chunks (the last one edge-padded, its results sliced away) in a
Python loop; there is no jit to build.  Parameters are passed in, as in the
JAX system, as the MipNerf state dict (convert.py maps a flax tree to it).

Training, data loading, checkpoints and the CLIs are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.models.mipnerf import make_mipnerf_from_hparams
from mipnerf_pl_tpu_torch.ops.camera import Camera, camera_rays
from mipnerf_pl_tpu_torch.rays import (Rays, namedtuple_map, rays_flatten,
                                       rays_pad_to)


def _render_fusion_ok(hparams: Dict[str, Any]) -> bool:
    """True when the fused lean-render kernels support this model config:
    the condition under which val.mlp_backend='auto' selects them."""
    return (bool(hparams['nerf.use_viewdirs'])
            and str(hparams['nerf.rgb_activation']) == 'sigmoid'
            and str(hparams['nerf.density_activation']) == 'softplus'
            and float(hparams['nerf.density_noise']) == 0.0
            and str(hparams['nerf.mlp.net_activation']) == 'relu'
            and int(hparams['nerf.mlp.num_rgb_channels']) == 3
            and int(hparams['nerf.mlp.num_density_channels']) == 1
            and int(hparams['nerf.mlp.net_depth_condition']) >= 1
            and not bool(hparams.get('nerf.unbounded', False))
            and str(hparams.get('nerf.ipe_backend', 'xla')) == 'xla')


def _compute_dtype(hparams) -> torch.dtype:
    name = str(hparams.get('train.compute_dtype', 'float32'))
    return torch.bfloat16 if name == 'bfloat16' else torch.float32


class MipNeRFSystem:
    """Owns the model and its render-time twin on one device."""

    def __init__(self, hparams: Dict[str, Any], device='cpu'):
        config.warn_inert_keys(hparams)
        self.hparams = dict(hparams)
        self.device = torch.device(device)
        compute_dtype = _compute_dtype(hparams)
        self.model = make_mipnerf_from_hparams(hparams, compute_dtype)
        # Inference model: same parameters, its own backend (val.mlp_backend;
        # 'auto' -> the fused lean-render kernels when supported).
        train_backend = str(hparams.get('nerf.mlp_backend', 'xla'))
        val_backend = str(hparams.get('val.mlp_backend', 'auto') or 'auto')
        if val_backend == 'auto':
            val_backend = ('pallas_lean' if _render_fusion_ok(hparams)
                           else 'xla')
        if (val_backend != train_backend
                or val_backend.startswith('pallas_lean')):
            eval_hp = dict(hparams)
            eval_hp['nerf.mlp_backend'] = val_backend
            if val_backend.startswith('pallas_lean'):
                # Forward only: composite and encode inside the kernels.
                # No gradients flow at render time, so stop_resample_grad
                # is moot.
                eval_hp['nerf.fuse_render'] = True
                eval_hp['nerf.fuse_encode'] = True
                eval_hp['nerf.stop_resample_grad'] = True
            self.eval_model = make_mipnerf_from_hparams(eval_hp,
                                                        compute_dtype)
        else:
            self.eval_model = self.model
        self.model.to(self.device)
        self.eval_model.to(self.device)
        self.val_randomized = bool(hparams['val.randomized'])
        self.white_bkgd = bool(hparams['train.white_bkgd'])
        self.val_chunk_size = int(hparams['val.chunk_size'])

    def init_params(self, seed: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """Seeded Xavier-uniform weights and zero biases, as the model's
        state dict on the system's device."""
        seed = int(self.hparams['seed'] if seed is None else seed)
        gen = torch.Generator().manual_seed(seed)
        fresh = make_mipnerf_from_hparams(self.hparams,
                                          _compute_dtype(self.hparams),
                                          generator=gen)
        return {k: v.to(self.device) for k, v in fresh.state_dict().items()}

    # -- rendering -------------------------------------------------------
    @staticmethod
    def _pack_outputs(coarse, fine, need_coarse: bool):
        outs = (fine.rgb, fine.distance, fine.acc)
        return ((coarse.rgb,) + outs) if need_coarse else outs

    @staticmethod
    def _unpack_outputs(outs, n_valid: int, need_coarse: bool):
        names = (['coarse_rgb'] if need_coarse else []) + \
            ['fine_rgb', 'distance', 'acc']
        return {name: o[:n_valid].cpu().numpy()
                for name, o in zip(names, outs)}

    @torch.no_grad()
    def _render_flat(self, params, flat: Rays, chunk: int,
                     generator: Optional[torch.Generator],
                     need_coarse: bool):
        """Rays [n, C] -> dict of numpy [n, ...] outputs, chunk by chunk."""
        params = {k: v.to(self.device) for k, v in params.items()}
        n = flat.origins.shape[0]
        n_chunks = -(-n // chunk)
        if n_chunks * chunk != n:
            flat = rays_pad_to(flat, n_chunks * chunk)
        outs = []
        for i in range(n_chunks):
            rays = namedtuple_map(lambda x: x[i * chunk:(i + 1) * chunk],
                                  flat)
            ret = functional_call(
                self.eval_model, params,
                (rays, self.val_randomized, self.white_bkgd),
                {'generator': generator})
            outs.append(self._pack_outputs(ret[0], ret[-1], need_coarse))
        cat = [torch.cat(parts, dim=0) for parts in zip(*outs)]
        return self._unpack_outputs(cat, n, need_coarse)

    @staticmethod
    def _to_image(out, h: int, w: int):
        return {k: v.reshape(h, w, 3) if v.ndim == 2 else v.reshape(h, w)
                for k, v in out.items()}

    def render_camera(self, params, cam: Camera, h: int, w: int,
                      generator: Optional[torch.Generator] = None,
                      chunk_size: Optional[int] = None,
                      need_coarse: bool = True):
        """Full-image render from a Camera -> dict of numpy images
        (`fine_rgb` [h, w, 3], `distance` / `acc` [h, w], and `coarse_rgb`
        when need_coarse).  The rays are built on the system's device."""
        chunk = chunk_size or self.val_chunk_size
        flat = rays_flatten(camera_rays(cam, h, w, device=self.device))
        return self._to_image(
            self._render_flat(params, flat, chunk, generator, need_coarse),
            h, w)

    def render_image(self, params, rays: Rays,
                     generator: Optional[torch.Generator] = None,
                     chunk_size: Optional[int] = None,
                     need_coarse: bool = True):
        """Full-image render of an [h, w, ...] ray bundle (numpy or torch)
        -> dict of numpy images, as render_camera."""
        chunk = chunk_size or self.val_chunk_size
        h, w = rays.origins.shape[-3:-1]
        rays = namedtuple_map(lambda x: torch.as_tensor(
            np.asarray(x) if not torch.is_tensor(x) else x,
            dtype=torch.float32, device=self.device), rays)
        return self._to_image(
            self._render_flat(params, rays_flatten(rays), chunk, generator,
                              need_coarse), h, w)
