"""MipNeRFSystem: the training step and the renders.

Counterpart of mipnerf_pl_tpu/train/system.py.

Training: `init_state`, `loss_fn` (masked MSE per level plus
distloss_mult * distloss, coarse_loss_mult on the coarser levels),
`train_step` (one Adam step with the mip LR schedule) and `make_train_many`
(K steps over stacked batches in a Python loop, each step's generator
seeded from (base seed, step) as the JAX trainer folds the step into its
key).  The state's parameters and Adam moments are updated in place.

Rendering: the same eval-model selection from `val.mlp_backend` ('auto'
picks the fused lean-render path when the model config supports it, else
the plain forward), and the full-image renders behind eval and video:
`render_camera` builds the rays on the device from a Camera, `render_image`
takes a ray bundle.  Both run fixed-size chunks (the last one edge-padded,
its results sliced away) in a Python loop; there is no jit to build.
Parameters are passed in, as in the JAX system, as the MipNerf state dict
(convert.py maps a flax tree to it).

Data loading, `fit`, checkpoints and the CLIs are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.models.mipnerf import make_mipnerf_from_hparams
from mipnerf_pl_tpu_torch.ops.camera import Camera, camera_rays
from mipnerf_pl_tpu_torch.ops.render import distloss
from mipnerf_pl_tpu_torch.rays import (Rays, namedtuple_map, rays_flatten,
                                       rays_pad_to)
from mipnerf_pl_tpu_torch.train.opt import adam, adam_step
from mipnerf_pl_tpu_torch.train.schedule import mip_lr_decay
from mipnerf_pl_tpu_torch.utils.metrics import calc_psnr


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
    """Owns the model, its render-time twin and the optimizer schedule on
    one device: a CUDA device unless `device` says otherwise (the CPU runs
    the kernels' plain versions)."""

    def __init__(self, hparams: Dict[str, Any], device=None):
        config.warn_inert_keys(hparams)
        self.hparams = dict(hparams)
        if device is None:
            if not torch.cuda.is_available():
                raise ValueError(
                    'MipNeRFSystem runs on a CUDA device by default and none '
                    'is available; pass device=\'cpu\' to run the plain '
                    'PyTorch versions of the kernels on the CPU')
            device = 'cuda'
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
        self.train_randomized = bool(hparams['train.randomized'])
        self.white_bkgd = bool(hparams['train.white_bkgd'])
        self.val_chunk_size = int(hparams['val.chunk_size'])
        self.lr_schedule = mip_lr_decay(
            hparams['optimizer.lr_init'], hparams['optimizer.lr_final'],
            hparams['optimizer.max_steps'],
            hparams['optimizer.lr_delay_steps'],
            hparams['optimizer.lr_delay_mult'])
        self.coarse_loss_mult = float(hparams['loss.coarse_loss_mult'])
        self.distloss_mult = float(hparams.get('loss.distloss_mult', 0.01))
        self.disable_multiscale_loss = bool(
            hparams['loss.disable_multiscale_loss'])

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

    # -- training --------------------------------------------------------
    def init_state(self, seed: Optional[int] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, Any]:
        """{'params': the state dict as leaf tensors that require grad,
        'opt_state': Adam over them, 'step': 0}.  The params are
        `init_params(seed)`, or copies of `params` when given."""
        params = self.init_params(seed) if params is None else params
        params = {k: v.detach().to(self.device, torch.float32).clone()
                  .requires_grad_(True) for k, v in params.items()}
        return {'params': params, 'opt_state': adam(list(params.values())),
                'step': 0}

    def _on_device(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=self.device)

    def loss_fn(self, params, rays: Rays, pixels,
                generator: Optional[torch.Generator] = None):
        """-> (loss, aux): the masked MSE of every level plus distloss_mult
        * distloss, the coarser levels weighted by coarse_loss_mult."""
        ret = functional_call(self.model, params,
                              (rays, self.train_randomized, self.white_bkgd),
                              {'generator': generator})
        mask = rays.lossmult
        if self.disable_multiscale_loss:
            mask = torch.ones_like(mask)
        mask_sum = torch.sum(mask)
        gt = pixels[..., :3]
        losses, dists = [], []
        for level in ret:
            losses.append(torch.sum(mask * (level.rgb - gt) ** 2) / mask_sum)
            dists.append(distloss(level.weights, level.t_samples)
                         if self.distloss_mult != 0.0
                         else torch.zeros((), device=gt.device))
        loss = losses[-1] + self.distloss_mult * dists[-1]
        for mse_c, dist_c in zip(losses[:-1], dists[:-1]):
            loss = loss + self.coarse_loss_mult * (
                mse_c + self.distloss_mult * dist_c)
        with torch.no_grad():
            aux = {'loss': loss.detach(),
                   'train/psnr': calc_psnr(ret[-1].rgb, gt),
                   'train/psnr_coarse': calc_psnr(ret[0].rgb, gt),
                   'train/mse_fine': losses[-1].detach(),
                   'train/distloss_fine': dists[-1].detach()}
        return loss, aux

    def value_and_grad(self, params, rays: Rays, pixels,
                       generator: Optional[torch.Generator] = None):
        """-> ((loss, aux), {name: gradient}) of loss_fn."""
        names = list(params)
        loss, aux = self.loss_fn(params, rays, pixels, generator)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return (loss.detach(), aux), dict(zip(names, grads))

    def train_step(self, state, rays: Rays, pixels,
                   generator: Optional[torch.Generator] = None):
        """One Adam step with lr = schedule(step).  Updates
        state['params'], the Adam moments and state['step'] IN PLACE and
        returns (state, aux).  Rays and pixels may be numpy or torch."""
        rays = namedtuple_map(self._on_device, rays)
        (_, aux), grads = self.value_and_grad(
            state['params'], rays, self._on_device(pixels), generator)
        lr = adam_step(state['opt_state'], list(grads.values()),
                       state['step'], self.lr_schedule)
        aux['lr'] = torch.tensor(lr)
        state['step'] += 1
        return state, aux

    def step_generator(self, base_seed: int, step: int) -> torch.Generator:
        """Training step `step`'s generator, seeded from (base_seed, step):
        the counterpart of jax.random.fold_in(PRNGKey(base_seed), step)."""
        seed = np.random.SeedSequence([int(base_seed), int(step)])
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0] >> 1))

    def make_train_many(self):
        """K steps per call: fn(state, rays_stack [K, B, ...], pixels_stack
        [K, B, 3], base_seed) -> (state, aux stacked over K).  Step k draws
        from a generator seeded from (base_seed, state['step']), so resuming
        mid-run replays the same draws as single steps.  Updates the state
        IN PLACE, as train_step does."""

        def train_many(state, rays_stack: Rays, pixels_stack, base_seed: int):
            rays_stack = namedtuple_map(self._on_device, rays_stack)
            pixels_stack = self._on_device(pixels_stack)
            auxs = []
            for k in range(pixels_stack.shape[0]):
                gen = self.step_generator(base_seed, state['step'])
                state, aux = self.train_step(
                    state, namedtuple_map(lambda x: x[k], rays_stack),
                    pixels_stack[k], gen)
                auxs.append(aux)
            return state, {name: torch.stack([a[name] for a in auxs])
                           for name in auxs[0]}

        return train_many

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
        rays = namedtuple_map(self._on_device, rays)
        return self._to_image(
            self._render_flat(params, rays_flatten(rays), chunk, generator,
                              need_coarse), h, w)
