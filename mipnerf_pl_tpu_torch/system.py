"""MipNeRFSystem: the training step, the renders and the fit loop.

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

Data parallelism: the system runs over the `data` axis of its mesh
(parallel/mesh.py), resolved from `num_devices` / `num_gpus` as JAX
resolves them (`resolve_mesh`), or given.  Each data shard computes its
rows of a batch, drawing its random numbers at the batch's shape (its
`rows`), and its term of the batch's loss: the masked MSE over the batch's
sum(lossmult), distloss over the batch's rays.  The gradients and the aux
sums are reduced over `data` before the Adam step, so every shard updates
the same parameters by the same sum, and the result is that of one device
on the whole batch.  A render splits each chunk over the shards and
assembles the rows.  A single-process mesh runs the shards in turn; on a
multi-process one (one process a device, cli/train.py's launcher or
`parallel.multi_host`) each process holds its own rows and the first
writes the run's files.

Tensor parallelism: with a `model` axis (`parallel.model_axis` > 1, or a
mesh that has one) the training model's MLP splits each data shard's
trunk over `model` in Megatron pairs (`tp_mlp_forward` on the mesh's
`model_view`, at every shape the JAX system trains: any depth, any skip
index, no view layer, no view directions; the pair kernels for a Pallas
backend, their plain versions for 'xla'), with the whole-MLP fusions off
(models/mipnerf.py `tp_off`; the system prints what runs and what is
off).  Only a trunk width the axis does not divide is refused, as JAX's
placement refuses it.  On a multi-process mesh each process holds, as
JAX places them, its model rank's panels of the parameters, of both Adam
moments and of the gradients (`_Panels`, from `model_split_rows`: the
split regions' panels, the replicated regions whole): a panel's gradient
is summed over `data`, a replicated region's over the whole mesh with
model ranks other than 0 handing in zeros.  A checkpoint holds whole
tensors in the one-device layout (`host_state` assembles them over
`model`), so one card evaluates it; a resume slices each rank's panels of
the parameters and both moments (`load_state`, JAX's `place_state`).  The
training model and its eval twin keep no parameters of their own there
(`functional_call` hands them the state's, or `whole_params` for a
render).  A
single-process mesh holds the state whole: its shards share one device,
so panels would save nothing, and autograd adds the model ranks' panels
into each parameter's gradient.  The renders run the eval model, never
split, on the whole parameters (`whole_params`), rows over `data` only,
as JAX's `pallas_call` does not split over `model`.  The step is that of
one device on the whole batch, as under JAX's GSPMD.

The run: `setup` builds the train / val datasets and the prefetching
TrainBatcher, `validate` renders val images (through `camera()` where the
dataset has one) and returns the mean loss and PSNR, and `fit` is the whole
training run: data, K-step dispatches over the batcher, the log line,
validation with val_history.csv, a checkpoint after each validation (top-k
by val PSNR plus the last) and resume.  cli/train.py and cli/eval.py are the
command lines over it.  TensorBoard events are written when `tensorboardX`
imports: the scalars, and at each validation the panels of its first image
(`val/GT_coarse_fine`: ground truth, coarse and fine; `distance`: the
colour-mapped distance map); the CSV and the log lines always are.  Every
image size goes through the same code: the datasets (single-scale
`blender`, multi-scale `multi_blender`) hand each view's camera and size to
the renders, and the loss weights each ray by its `lossmult`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.data.datasets import dataset_dict
from mipnerf_pl_tpu_torch.data.pipeline import TrainBatcher
from mipnerf_pl_tpu_torch.kernels.mlp import flatten_params, param_order
from mipnerf_pl_tpu_torch.kernels.tp_lean import model_split_rows
from mipnerf_pl_tpu_torch.models.mipnerf import make_mipnerf_from_hparams
from mipnerf_pl_tpu_torch.ops.camera import Camera, camera_rays
from mipnerf_pl_tpu_torch.ops.render import distloss
from mipnerf_pl_tpu_torch.parallel.mesh import (Mesh, create_mesh,
                                                model_axis, multi_host,
                                                pad_batch_to_devices,
                                                requested_devices)
from mipnerf_pl_tpu_torch.rays import (Rays, namedtuple_map, rays_flatten,
                                       rays_pad_to)
from mipnerf_pl_tpu_torch.train.ckpt import CheckpointManager, host_copy
from mipnerf_pl_tpu_torch.train.opt import adam, adam_step
from mipnerf_pl_tpu_torch.train.schedule import mip_lr_decay
from mipnerf_pl_tpu_torch.utils.trace import PhaseTotals, collect, span
from mipnerf_pl_tpu_torch.utils.vis import stack_rgb, visualize_depth


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


def make_dataset(hparams: Dict[str, Any], dataset_name: str, data_path: str,
                 split: str):
    """The `split` of a registered dataset under data_path, built from the
    hparams: the train split from the `train.*` keys, val and test from
    the `val.*` keys, and `data.factor` where it is set.  Training and eval
    both build their datasets here, so a checkpoint evaluates at the
    resolution it trained at."""
    extra = {}
    factor = hparams.get('data.factor')
    if factor is not None and str(factor) != 'None':
        extra['factor'] = int(factor)
    prefix = 'train' if split == 'train' else 'val'
    return dataset_dict[dataset_name](
        data_dir=data_path, split=split,
        white_bkgd=hparams[f'{prefix}.white_bkgd'],
        batch_type=hparams[f'{prefix}.batch_type'], **extra)


def _summary_writer(logdir: str):
    """A tensorboardX SummaryWriter on logdir, or None (said once) where
    the package is missing."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        print('tensorboardX is not installed: TensorBoard events are not '
              'written (val_history.csv and the log lines are)', flush=True)
        return None
    return SummaryWriter(logdir)


def _compute_dtype(hparams) -> torch.dtype:
    name = str(hparams.get('train.compute_dtype', 'float32'))
    return torch.bfloat16 if name == 'bfloat16' else torch.float32


def _check_model_axis_shapes(hparams, n_model: int) -> None:
    """Raise a ValueError naming the key where the model axis does not
    divide the trunk width, the one shape the Megatron split of
    `tp_mlp_forward` refuses (JAX's placement refuses it too)."""
    width = int(hparams['nerf.mlp.net_width'])
    if width % n_model:
        raise ValueError(f'nerf.mlp.net_width={width} does not divide among '
                         f'model={n_model} shards (parallel.model_axis='
                         f'{n_model} splits the MLP with tp_mlp_forward)')


class _Panels:
    """The state a process of a multi-process mesh with a model axis
    holds: of every parameter (and of each Adam moment and gradient, which
    take its layout) its model rank's panel of the split region and the
    replicated region whole, both as `model_split_rows` names them for the
    flat layout.  In the state dict's [out, in] layout a parameter's entry
    is (dim, split): along dim, the first `split` entries are split in n
    panels (a column-parallel slot's outputs, dim 0; a 'row' entry's
    h-rows, the weight's dim 1) and the rest are replicated; (0, 0) is a
    replicated parameter.  A local tensor is its panel, then the
    replicated rest."""

    def __init__(self, mlp, mesh: Mesh):
        self.mesh = mesh
        self.n, self.r = mesh.shape['model'], mesh.model_rank
        dims = (mlp.net_depth, mlp.net_depth_condition, mlp.use_viewdirs)
        table = model_split_rows(flatten_params(mlp, *dims), *dims)
        self.spec = {}
        for j, layer in enumerate(param_order(*dims)):
            lin = getattr(mlp, layer)
            (rows, axis), (_, b_axis) = table[2 * j], table[2 * j + 1]
            self.spec[f'mlp.{layer}.weight'] = (
                {'col': (0, lin.weight.shape[0]), 'row': (1, rows)}.get(
                    axis, (0, 0)), tuple(lin.weight.shape))
            self.spec[f'mlp.{layer}.bias'] = (
                (0, lin.bias.shape[0]) if b_axis == 'col' else (0, 0),
                tuple(lin.bias.shape))

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's local tensor of a whole one (a new tensor)."""
        (dim, split), shape = self.spec[name]
        p = split // self.n
        return torch.cat([full.narrow(dim, self.r * p, p),
                          full.narrow(dim, split, shape[dim] - split)], dim)

    def regions(self, name: str, t: torch.Tensor):
        """(panel, replicated rest) of a local tensor, as views."""
        (dim, split), shape = self.spec[name]
        p = split // self.n
        want = shape[:dim] + (p + shape[dim] - split,) + shape[dim + 1:]
        if tuple(t.shape) != want:
            raise ValueError(f'{name}: {tuple(t.shape)} is not model rank '
                             f'{self.r}\'s panel {want} of {shape}')
        return t.narrow(dim, 0, p), t.narrow(dim, p, t.shape[dim] - p)

    def whole(self, names, tensors):
        """The whole tensors of local ones (one each name), on every
        process of the `model` group: each rank writes its panel, model
        rank 0 the replicated rest, into zeros, summed over `model` in one
        all_reduce."""
        bufs = []
        for name, t in zip(names, tensors):
            (dim, split), shape = self.spec[name]
            panel, rest = self.regions(name, t.detach())
            full = torch.zeros(shape, dtype=torch.float32, device=t.device)
            p = split // self.n
            full.narrow(dim, self.r * p, p).copy_(panel)
            if self.r == 0:
                full.narrow(dim, split, shape[dim] - split).copy_(rest)
            bufs.append(full)
        return self.mesh.sum_over_model(bufs)

    def numel(self):
        """(elements this process holds, elements of the whole) of the
        parameters, from the table."""
        held = whole = 0
        for (dim, split), shape in self.spec.values():
            size = int(np.prod(shape))
            whole += size
            held += size // shape[dim] * (split // self.n + shape[dim] - split)
        return held, whole


def resolve_mesh(hparams, device: torch.device) -> Mesh:
    """The system's mesh from the hparams, as the JAX system resolves its
    device count (`requested_devices`; 0 = every visible card) and lays it
    out as (data, model) with `parallel.model_axis`.  With an initialised
    process group: the multi-process mesh, one process a device, whose
    world size the count must equal.  Without one, one device: a larger
    count needs its processes (the CLIs start them) or an explicit
    single-process `mesh=`; the count is never quietly cut.  A count the
    model axis does not divide raises, naming both keys."""
    n = requested_devices(hparams)
    m = model_axis(hparams)
    if dist.is_initialized():
        n = n or dist.get_world_size()
    elif n == 0:
        n = torch.cuda.device_count() if device.type == 'cuda' else 1
    if m < 1 or n % m:
        raise ValueError(
            f'parallel.model_axis={hparams.get("parallel.model_axis")!r} '
            f'does not divide the {n} device(s) of num_devices='
            f'{hparams.get("num_devices")!r}, num_gpus='
            f'{hparams.get("num_gpus")!r}: ask for a multiple of it (the '
            'launcher of python -m mipnerf_pl_tpu_torch.cli.train starts '
            f'one process a device), or pass mesh=create_mesh({max(m, 1)}, '
            f'{max(m, 1)}, device=...) for the single-process mesh')
    if dist.is_initialized():
        return create_mesh(n, m, device=device, distributed=True)
    if multi_host(hparams):
        raise ValueError(
            'parallel.multi_host is set and no process group is '
            'initialised: call parallel.mesh.maybe_initialize_distributed '
            'before building the system (cli.train does)')
    if n > 1:
        raise ValueError(
            f'num_devices={hparams.get("num_devices")!r}, num_gpus='
            f'{hparams.get("num_gpus")!r} ask for {n} shards, and this '
            'process drives one device: start one process a device with the '
            f'launcher of python -m mipnerf_pl_tpu_torch.cli.train (it '
            f'starts {n} workers; parallel.multi_host joins them across '
            f'hosts), or pass mesh=create_mesh({n}, {m}, device=...) for the '
            'single-process mesh')
    return create_mesh(1, device=device)


class MipNeRFSystem:
    """Owns the model, its render-time twin, the optimizer schedule and the
    mesh: a CUDA device unless `device` says otherwise (the CPU runs the
    kernels' plain versions), and the mesh from the hparams
    (`resolve_mesh`) unless `mesh` is given.  Over a mesh's `data` axis
    every step, loss and render is that of one device on the whole batch:
    each shard computes its rows and the sums are reduced over `data`, as
    JAX's sharded step gives.  Over its `model` axis each shard's training
    MLP runs in Megatron pairs, a process of a multi-process mesh holding
    its panels of the state, and the step is again that of one device (the
    module docstring)."""

    def __init__(self, hparams: Dict[str, Any], device=None,
                 mesh: Optional[Mesh] = None):
        config.warn_inert_keys(hparams)
        self.hparams = dict(hparams)
        if device is None and mesh is not None:
            device = mesh.device
        if device is None:
            if not torch.cuda.is_available():
                raise ValueError(
                    'MipNeRFSystem runs on a CUDA device by default and none '
                    'is available; pass device=\'cpu\' to run the plain '
                    'PyTorch versions of the kernels on the CPU')
            device = 'cuda'
        self.device = torch.device(device)
        if mesh is None:
            mesh = resolve_mesh(hparams, self.device)
        elif mesh.device != self.device:
            raise ValueError(f'device {self.device} but the mesh is on '
                             f'{mesh.device}')
        self.mesh = mesh
        n_model = mesh.shape['model']
        if n_model > 1:
            _check_model_axis_shapes(hparams, n_model)
        compute_dtype = _compute_dtype(hparams)
        self.model = make_mipnerf_from_hparams(
            hparams, compute_dtype,
            tp_mesh=mesh.model_view() if n_model > 1 else None)
        # Inference model: same parameters, its own backend (val.mlp_backend;
        # 'auto' -> the fused lean-render kernels when supported), and
        # never split over `model`.
        train_backend = str(hparams.get('nerf.mlp_backend', 'xla'))
        val_backend = str(hparams.get('val.mlp_backend', 'auto') or 'auto')
        if val_backend == 'auto':
            val_backend = ('pallas_lean' if _render_fusion_ok(hparams)
                           else 'xla')
        if (val_backend != train_backend or n_model > 1
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
        # A process of a multi-process mesh with a model axis holds its
        # panels of the state; a single-process mesh holds it whole.
        self._panels = (_Panels(self.model.mlp, mesh)
                        if mesh.distributed and n_model > 1 else None)
        if self._panels is not None:
            # The modules' own parameters are only what functional_call
            # swaps out: where the processes hold panels, no whole copy.
            for module in (self.model, self.eval_model):
                for p in module.parameters():
                    p.data = p.data.new_empty(0)
        if n_model > 1 and mesh.is_root:
            route = ('their plain versions' if train_backend == 'xla' else
                     'the kernels tp_pair_fwd / tp_pair_bwd')
            print(f'model axis {n_model} ({mesh!r}): the training MLP '
                  f'(nerf.mlp_backend {train_backend}) runs its trunk in '
                  f'Megatron pairs on {route}, the rest in torch.matmul; '
                  'off under the model axis: '
                  f'{", ".join(self.model.tp_off) or "nothing"}; state: '
                  f'{"panels a process" if self._panels else "whole"}; '
                  'renders on the whole parameters (val.mlp_backend '
                  f'{val_backend})', flush=True)
        self.val_randomized = bool(hparams['val.randomized'])
        self.train_randomized = bool(hparams['train.randomized'])
        self.white_bkgd = bool(hparams['train.white_bkgd'])
        self.val_chunk_size = int(hparams['val.chunk_size'])
        self.batch_size = int(hparams['train.batch_size'])
        if self.batch_size % mesh.shape['data']:
            raise ValueError(f'train.batch_size={self.batch_size} does not '
                             f'divide among data={mesh.shape["data"]} shards')
        self.train_dataset = None
        self.val_dataset = None
        self.batcher = None
        # What the last fit() measured (see fit).
        self.fit_stats: Dict[str, float] = {}
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
                  for k, v in params.items()}
        # Every process starts from the first one's parameters.
        self.mesh.broadcast_from_root(list(params.values()))
        if self._panels is not None:
            params = {k: self._panels.local(k, v) for k, v in params.items()}
        params = {k: v.requires_grad_(True) for k, v in params.items()}
        return {'params': params, 'opt_state': adam(list(params.values())),
                'step': 0}

    def state_numel(self):
        """(elements of the parameters this process holds, elements of the
        whole parameters), from the split's table: the same numbers for
        each Adam moment."""
        if self._panels is not None:
            return self._panels.numel()
        whole = sum(p.numel() for p in self.model.parameters())
        return whole, whole

    def whole_params(self, params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The whole parameters of a training state's: its own where the
        state is whole; assembled over `model` from every rank's panels (a
        collective: every process of the mesh calls it) where it holds
        panels."""
        if self._panels is None:
            return params
        return dict(zip(params, self._panels.whole(list(params),
                                                   list(params.values()))))

    def host_state(self, state) -> Dict[str, Any]:
        """The state as a checkpoint holds it: CPU copies, the optimizer
        as its state dict (the Adam moments in parameter order), whole
        tensors however the processes hold them (where they hold panels,
        assembled over `model`: every process of the mesh calls it)."""
        names = list(state['params'])
        params = list(state['params'].values())
        opt = state['opt_state'].state_dict()
        if self._panels is not None:
            moments = [(i, key) for i in sorted(opt['state'])
                       for key in ('exp_avg', 'exp_avg_sq')]
            whole = self._panels.whole(
                names + [names[i] for i, _ in moments],
                params + [opt['state'][i][key] for i, key in moments])
            params = whole[:len(names)]
            opt['state'] = {i: dict(s) for i, s in opt['state'].items()}
            for (i, key), t in zip(moments, whole[len(names):]):
                opt['state'][i][key] = t
        return host_copy({'params': dict(zip(names, params)),
                          'opt_state': opt, 'step': int(state['step'])})

    def load_state(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """A training state on the system's device from `host_state`'s
        form (the parameters those of the mesh's first process); where the
        processes hold panels, each takes its own of the parameters and of
        both Adam moments."""
        state = self.init_state(params=host['params'])
        opt = host['opt_state']
        if self._panels is not None:
            names = list(state['params'])
            opt = {'param_groups': opt['param_groups'], 'state': {
                i: {k: (self._panels.local(names[i], v.to(self.device))
                        if k in ('exp_avg', 'exp_avg_sq') else v)
                    for k, v in s.items()}
                for i, s in opt['state'].items()}}
        state['opt_state'].load_state_dict(opt)
        state['step'] = int(host['step'])
        return state

    def check_state(self, state) -> None:
        """Raise unless the processes hold the same parameters: all of them
        over the whole mesh, or where they hold panels, everything over
        `data` and the replicated regions over `model`."""
        params = state['params']
        if self._panels is None:
            self.mesh.check_equal_over_mesh(list(params.values()),
                                            'the parameters')
            return
        self.mesh.check_equal_over_mesh(list(params.values()),
                                        'the parameters', axis='data')
        self.mesh.check_equal_over_mesh(
            [self._panels.regions(k, v)[1] for k, v in params.items()],
            'the replicated regions of the parameters', axis='model')

    # -- data ------------------------------------------------------------
    def setup(self, data_path: str, dataset_name: str, prefetch: int = 2,
              seed: Optional[int] = None, steps_per_call: int = 1):
        """Build the train and val datasets and the train batcher."""
        self.train_dataset = make_dataset(self.hparams, dataset_name,
                                          data_path, 'train')
        self.val_dataset = make_dataset(self.hparams, dataset_name,
                                        data_path, 'val')
        # A process of a multi-process mesh gathers its own rows of each
        # batch; a single-process mesh splits the whole batch in the step.
        self.batcher = TrainBatcher(
            self.train_dataset, self.batch_size,
            seed=int(self.hparams['seed'] if seed is None else seed),
            prefetch=prefetch, steps_per_call=steps_per_call,
            device=self.device,
            shard=((self.mesh.data_rank, self.mesh.shape['data'])
                   if self.mesh.distributed else None))

    def _on_device(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=self.device)

    def _shard_loss(self, params, rays: Rays, pixels,
                    generator: Optional[torch.Generator], rows,
                    mask_sum, n_rays: int):
        """One data shard's term of the batch's loss, and its detached sums
        [loss term, fine and coarse squared error, fine MSE term, fine
        distloss term].  `rows` (start, stop, total) places the shard's rays
        in the batch (its random draws); `mask_sum` and `n_rays` are the
        batch's, so the terms of the shards add up to the batch's loss: the
        masked MSE over the batch's sum(lossmult), distloss the batch's
        mean over rays."""
        ret = functional_call(self.model, params,
                              (rays, self.train_randomized, self.white_bkgd),
                              {'generator': generator, 'rows': rows})
        mask = self._loss_mask(rays)
        gt = pixels[..., :3]
        share = gt.shape[0] / n_rays
        losses, dists = [], []
        for level in ret:
            losses.append(torch.sum(mask * (level.rgb - gt) ** 2) / mask_sum)
            if self.distloss_mult == 0.0:
                dists.append(torch.zeros((), device=gt.device))
                continue
            w, t = level.weights, level.t_samples
            if self.model.unbounded:
                # t_samples holds DESCENDING t_inv: distloss needs
                # ascending bins (its prefix-sum identity negates on
                # descending ones), so both are flipped.
                w, t = torch.flip(w, dims=(-1,)), torch.flip(t, dims=(-1,))
            dists.append(distloss(w, t) * share)
        loss = losses[-1] + self.distloss_mult * dists[-1]
        for mse_c, dist_c in zip(losses[:-1], dists[:-1]):
            loss = loss + self.coarse_loss_mult * (
                mse_c + self.distloss_mult * dist_c)
        with torch.no_grad():
            sums = [loss.detach(), torch.sum((ret[-1].rgb - gt) ** 2),
                    torch.sum((ret[0].rgb - gt) ** 2), losses[-1].detach(),
                    dists[-1].detach()]
        return loss, sums

    @staticmethod
    def _aux(sums, n_rays: int):
        """The step's aux from the batch's sums (`_shard_loss`'s list)."""
        loss, se_fine, se_coarse, mse_fine, dist_fine = sums
        return {'loss': loss,
                'train/psnr': -10.0 * torch.log10(se_fine / (3 * n_rays)),
                'train/psnr_coarse':
                    -10.0 * torch.log10(se_coarse / (3 * n_rays)),
                'train/mse_fine': mse_fine,
                'train/distloss_fine': dist_fine}

    def _loss_mask(self, rays: Rays):
        """Each ray's weight in the MSE: its lossmult, or 1 where the
        multi-scale loss is disabled."""
        if self.disable_multiscale_loss:
            return torch.ones_like(rays.lossmult)
        return rays.lossmult

    def loss_fn(self, params, rays: Rays, pixels,
                generator: Optional[torch.Generator] = None):
        """-> (loss, aux) of one device on the batch: the masked MSE of
        every level plus distloss_mult * distloss, the coarser levels
        weighted by coarse_loss_mult."""
        n = pixels.shape[0]
        loss, sums = self._shard_loss(params, rays, pixels, generator, None,
                                      torch.sum(self._loss_mask(rays)), n)
        return loss, self._aux(sums, n)

    def _shard_generators(self, generator: Optional[torch.Generator],
                          n: int):
        """n generators in `generator`'s state, one a data shard (itself
        when n is 1), so each shard draws what one device would."""
        if generator is None or n == 1:
            return [generator] * n
        gens = []
        for _ in range(n):
            g = torch.Generator(device=generator.device)
            g.set_state(generator.get_state())
            gens.append(g)
        return gens

    def value_and_grad(self, params, rays: Rays, pixels,
                       generator: Optional[torch.Generator] = None):
        """-> ((loss, aux), {name: gradient}) of loss_fn on the whole batch,
        over the mesh: `rays` and `pixels` are this process's rows (all of
        them on a single-process mesh, which runs the shards in turn); each
        shard's loss term is differentiated, and the gradients and the aux
        sums are reduced over `data`, and over `model` on a multi-process
        mesh, whose model ranks other than 0 first drop what every model
        rank holds alike (`_drop_replicated`)."""
        names = list(params)
        mesh = self.mesh
        n_local = pixels.shape[0]
        n_rays = n_local * (mesh.shape['data'] if mesh.distributed else 1)
        shards = mesh.data_rows(n_rays)
        base = shards[0][0]
        mask = self._loss_mask(rays)
        mask_sum, = mesh.reduce_from_data(
            [[torch.sum(mask[a - base:b - base])] for a, b in shards])
        gens = self._shard_generators(generator, len(shards))
        partials = []
        for (a, b), gen in zip(shards, gens):
            part = namedtuple_map(lambda x: x[a - base:b - base], rays)
            with span('mip.model'):
                loss, sums = self._shard_loss(
                    params, part, pixels[a - base:b - base], gen,
                    (a, b, n_rays), mask_sum, n_rays)
            with span('mip.backward'):
                grads = torch.autograd.grad(loss, [params[k] for k in names])
            partials.append(list(grads) + sums)
        if gens[-1] is not generator:
            generator.set_state(gens[-1].get_state())
        if self._panels is None:
            reduced = mesh.reduce_from_mesh(partials)
        else:
            reduced = self._reduce_panels(names, partials[0])
        aux = self._aux(reduced[len(names):], n_rays)
        return (aux['loss'], aux), dict(zip(names, reduced[:len(names)]))

    def _reduce_panels(self, names, partial):
        """A process's gradients (of its panels of the state) and loss
        sums, reduced: each panel's gradient summed over `data`, the
        replicated regions and the sums over the whole mesh, where model
        ranks other than 0 hand in zeros (every model rank computes the
        same values there), so they count once."""
        grads, sums = partial[:len(names)], partial[len(names):]
        panels, rests = zip(*(self._panels.regions(k, g)
                              for k, g in zip(names, grads)))
        rests, sums = list(rests), list(sums)
        if self.mesh.model_rank > 0:
            rests = [torch.zeros_like(t) for t in rests]
            sums = [torch.zeros_like(t) for t in sums]
        panels = self.mesh.reduce_from_data([list(panels)])
        rest_sums = self.mesh.reduce_from_mesh([rests + sums])
        out = []
        for k, p, r in zip(names, panels, rest_sums):
            out.append(torch.cat([p, r], self._panels.spec[k][0][0]))
        return out + rest_sums[len(names):]

    def train_step(self, state, rays: Rays, pixels,
                   generator: Optional[torch.Generator] = None):
        """One Adam step with lr = schedule(step).  Updates
        state['params'], the Adam moments and state['step'] IN PLACE and
        returns (state, aux).  Rays and pixels may be numpy or torch."""
        rays = namedtuple_map(self._on_device, rays)
        (_, aux), grads = self.value_and_grad(
            state['params'], rays, self._on_device(pixels), generator)
        with span('mip.adam'):
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
            with span('mip.dispatch'):
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
        with span('mip.to_host'):
            return {name: o[:n_valid].cpu().numpy()
                    for name, o in zip(names, outs)}

    @torch.no_grad()
    def _render_flat(self, params, flat: Rays, chunk: int,
                     generator: Optional[torch.Generator],
                     need_coarse: bool):
        """Rays [n, C] -> dict of numpy [n, ...] outputs, chunk by chunk:
        the chunk (rounded up to a multiple of the `data` axis, the last
        one edge-padded) split over the data shards, each shard's rows
        rendered and the rows assembled on every process."""
        params = {k: v.to(self.device) for k, v in params.items()}
        mesh = self.mesh
        chunk = pad_batch_to_devices(chunk, mesh.shape['data'])
        n = flat.origins.shape[0]
        n_chunks = -(-n // chunk)
        if n_chunks * chunk != n:
            flat = rays_pad_to(flat, n_chunks * chunk)
        shards = mesh.data_rows(chunk)
        outs = []
        for i in range(n_chunks):
            gens = self._shard_generators(generator, len(shards))
            parts = []
            for (a, b), gen in zip(shards, gens):
                rays = namedtuple_map(
                    lambda x: x[i * chunk + a:i * chunk + b], flat)
                with span('mip.model'):
                    ret = functional_call(
                        self.eval_model, params,
                        (rays, self.val_randomized, self.white_bkgd),
                        {'generator': gen, 'rows': (a, b, chunk)})
                parts.append(self._pack_outputs(ret[0], ret[-1],
                                                need_coarse))
            if gens[-1] is not generator:
                generator.set_state(gens[-1].get_state())
            # One assembly a chunk: the outputs side by side as columns.
            widths = [o[0].numel() for o in parts[0]]
            cols = mesh.assemble_rows(
                [torch.cat([o.reshape(o.shape[0], -1).float() for o in part],
                           dim=1) for part in parts], chunk)
            outs.append(tuple(
                c.reshape(chunk, *o.shape[1:]) for c, o in
                zip(torch.split(cols, widths, dim=1), parts[0])))
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
        with span('mip.frame'):
            flat = rays_flatten(camera_rays(cam, h, w, device=self.device))
            return self._to_image(
                self._render_flat(params, flat, chunk, generator,
                                  need_coarse), h, w)

    def render_image(self, params, rays: Rays,
                     generator: Optional[torch.Generator] = None,
                     chunk_size: Optional[int] = None,
                     need_coarse: bool = True):
        """Full-image render of an [h, w, ...] ray bundle (numpy or torch)
        -> dict of numpy images, as render_camera."""
        chunk = chunk_size or self.val_chunk_size
        h, w = rays.origins.shape[-3:-1]
        with span('mip.frame'):
            rays = namedtuple_map(self._on_device, rays)
            return self._to_image(
                self._render_flat(params, rays_flatten(rays), chunk,
                                  generator, need_coarse), h, w)

    def validate(self, state, num_images: int, writer=None,
                 global_step: int = 0, start_index: int = 0):
        """Render `num_images` val images from start_index on (cyclic);
        log and return the mean loss (coarse_loss_mult * coarse MSE + fine
        MSE, masked by lossmult) and the mean fine PSNR.  With a writer:
        the scalars, and the first image's panels `val/GT_coarse_fine`
        ([3, 3, H, W]: ground truth, coarse, fine) and `distance` (the
        colour-mapped distance map, CHW)."""
        val_losses, val_psnrs = [], []
        n = len(self.val_dataset)
        # The eval model is never split: it renders on the whole
        # parameters, assembled here where the state holds panels.
        params = self.whole_params(state['params'])
        for i in range(num_images):
            index = (start_index + i) % n
            rays, rgb_gt = self.val_dataset[index]
            # NotImplementedError is caught around the accessor only ("this
            # dataset has no single-camera form"); one raised inside the
            # render is a misconfiguration and propagates.
            try:
                cam, (ch, cw) = self.val_dataset.camera(index)
            except NotImplementedError:
                cam = None
            if cam is not None:
                out = self.render_camera(params, cam, ch, cw)
            else:
                out = self.render_image(params, rays)
            gt = rgb_gt[..., :3]
            mask = np.broadcast_to(np.asarray(rays.lossmult),
                                   (*gt.shape[:-1], 1))
            mse_c = (mask * (out['coarse_rgb'] - gt) ** 2).sum() / mask.sum()
            mse_f = (mask * (out['fine_rgb'] - gt) ** 2).sum() / mask.sum()
            val_losses.append(self.coarse_loss_mult * mse_c + mse_f)
            val_psnrs.append(
                -10.0 * np.log10(np.mean((out['fine_rgb'] - gt) ** 2)))
            if writer is not None and i == 0:
                writer.add_images('val/GT_coarse_fine',
                                  stack_rgb(gt, out['coarse_rgb'],
                                            out['fine_rgb']), global_step)
                writer.add_image('distance', np.transpose(
                    visualize_depth(out['distance']), (2, 0, 1)),
                    global_step)
        mean_loss = float(np.mean(val_losses))
        mean_psnr = float(np.mean(val_psnrs))
        if writer is not None:
            writer.add_scalar('val/loss', mean_loss, global_step)
            writer.add_scalar('val/psnr', mean_psnr, global_step)
        return mean_loss, mean_psnr

    @staticmethod
    def _log_val(log_dir: str, step: int, val_loss: float, val_psnr: float):
        """Append a validation's row to log_dir/val_history.csv."""
        hist = os.path.join(log_dir, 'val_history.csv')
        write_header = not os.path.exists(hist)
        with open(hist, 'a') as f:
            if write_header:
                f.write('step,val_loss,val_psnr\n')
            f.write(f'{step},{val_loss:.6f},{val_psnr:.4f}\n')

    def _synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _profiled_dispatch(self, dispatch, trace_dir: str):
        """Run dispatch() under torch.profiler and write its chrome trace
        and kernel table; a tracing failure is reported, never raised (the
        dispatch then runs unprofiled if it had not run)."""
        ran = False
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                dispatch()
                ran = True
                self._synchronize()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir,
                                                  'train_dispatch.json'))
            print(prof.key_averages().table(row_limit=15), flush=True)
            print(f'--profile: trace written to {trace_dir}', flush=True)
        except Exception as e:  # tracing must never end the training run
            print(f'--profile: trace failed ({e!r}); continuing', flush=True)
            if not ran:
                dispatch()

    def fit(self, data_path: str, dataset_name: str, out_dir: str,
            max_steps: Optional[int] = None, log_every: int = 100,
            resume_path: Optional[str] = None, verbose: bool = True):
        """Full training run: data, loop, validation, checkpoints, logs.
        Returns the final state.  `self.fit_stats` then holds the run's
        rays/s over its training time (loop wall time less validation and
        checkpointing; the whole batch of every data shard), this
        process's share of the loop's wall time spent waiting on the
        batcher, and the loss of the last step of its first and of its last
        dispatch.  On a multi-process mesh every process trains and
        validates, and the first alone writes the checkpoints, the logs and
        the log lines; the others wait for each checkpoint."""
        hp = self.hparams
        root = self.mesh.is_root
        verbose = verbose and root
        # The data binding goes into the checkpoint's hparams: eval restores
        # from the checkpoint directory alone.
        hp['dataset_name'] = dataset_name
        hp['data_path'] = data_path
        exp_name = hp['exp_name']
        max_steps = int(max_steps or hp['optimizer.max_steps'])
        val_interval = int(hp['val.check_interval'])
        val_sample_num = int(hp['val.sample_num'])

        # K steps per make_train_many call; the val and log intervals are
        # rounded up to multiples of K.
        spc = int(hp.get('train.steps_per_call', 20) or 1)
        spc = max(1, min(spc, val_interval, max_steps))
        val_interval = ((val_interval + spc - 1) // spc) * spc
        log_every = max(spc, ((log_every + spc - 1) // spc) * spc)

        self.setup(data_path, dataset_name, steps_per_call=spc)
        ckpt_dir = os.path.join(out_dir, 'ckpt', exp_name)
        ckpt = CheckpointManager(
            ckpt_dir, hparams=hp,
            save_top_k=int(hp.get('checkpoint.save_top_k', 2)), write=root)
        # An explicit resume_path wins; otherwise a run restarted with the
        # same out_dir continues from its own `last` checkpoint.
        resume_from = None
        explicit = resume_path or hp.get('checkpoint.resume_path')
        if explicit and str(explicit) != 'None':
            resume_from = str(explicit)
        elif (hp.get('checkpoint.auto_resume', True)
              and ckpt.latest_step() is not None):
            resume_from = ckpt_dir
        start_step = 0
        if resume_from:
            start_step, host = CheckpointManager(
                resume_from, write=False).restore_last()
            state = self.load_state(host)
            if verbose:
                print(f'resumed from {resume_from} at step {start_step}',
                      flush=True)
        else:
            state = self.init_state()

        log_dir = os.path.join(out_dir, 'logs', exp_name)
        writer = None
        if root:
            os.makedirs(log_dir, exist_ok=True)
            writer = _summary_writer(log_dir)
        base_seed = int(hp['seed'])

        # Sanity validation before any training.
        self.validate(state, 1, writer=None, global_step=start_step)

        train_many = self.make_train_many()
        # fit's phases: the spans mip.batch, mip.dispatch, mip.sync,
        # mip.validate and mip.checkpoint, summed (utils/trace.py).
        prof = PhaseTotals()
        profile_steps = int(hp.get('profile', 0) or 0)

        def next_shaped(remaining):
            """A batch as a [k, ...] dispatch stack (k <= spc; ragged on
            the final call only)."""
            rays, pixels = next(self.batcher)
            if spc == 1:
                rays = namedtuple_map(lambda x: x[None], rays)
                pixels = pixels[None]
            k = min(spc, remaining)
            if k < spc:
                rays = namedtuple_map(lambda x: x[:k], rays)
                pixels = pixels[:k]
            return rays, pixels, k

        t_loop = t0 = time.time()
        rays_since_log = rays_total = 0
        val_cursor = 0
        dispatch_index = 0
        first_aux = aux = None
        step = start_step
        try:
            with collect(prof):
                while step < max_steps:
                    rays, pixels, k = next_shaped(max_steps - step)
                    if profile_steps > 0 and dispatch_index == 1 and root:
                        # The second dispatch: every kernel is built and
                        # warm.
                        out = {}

                        def dispatch():
                            out['state'], out['aux'] = train_many(
                                state, rays, pixels, base_seed)
                        self._profiled_dispatch(dispatch, log_dir)
                        state, aux = out['state'], out['aux']
                        profile_steps = 0
                    else:
                        state, aux = train_many(state, rays, pixels,
                                                base_seed)
                    first_aux = aux if first_aux is None else first_aux
                    step += k
                    rays_since_log += self.batch_size * k
                    rays_total += self.batch_size * k
                    dispatch_index += 1

                    if step % log_every == 0 or step == start_step + spc:
                        loss, psnr, lr = (float(aux[name][-1]) for name in
                                          ('loss', 'train/psnr', 'lr'))
                        rays_per_sec = rays_since_log / max(
                            time.time() - t0, 1e-9)
                        if writer is not None:
                            writer.add_scalar('lr', lr, step)
                            writer.add_scalar('train/loss', loss, step)
                            writer.add_scalar('train/psnr', psnr, step)
                            writer.add_scalar('perf/rays_per_sec',
                                              rays_per_sec, step)
                        if verbose:
                            print(f'step {step}/{max_steps} loss={loss:.5f} '
                                  f'psnr={psnr:.2f} lr={lr:.2e} '
                                  f'rays/s={rays_per_sec:,.0f}', flush=True)
                        t0 = time.time()
                        rays_since_log = 0

                    if step % val_interval == 0 or step >= max_steps:
                        # The queued training work ends before validation's
                        # clock starts.
                        with span('mip.sync'):
                            self._synchronize()
                        with span('mip.validate'):
                            val_loss, val_psnr = self.validate(
                                state, val_sample_num, writer=writer,
                                global_step=step, start_index=val_cursor)
                            val_cursor += val_sample_num
                            if root:
                                self._log_val(log_dir, step, val_loss,
                                              val_psnr)
                        with span('mip.checkpoint'):
                            # The first process's checkpoint stands for
                            # every process's state, in whole tensors.
                            self.check_state(state)
                            host = self.host_state(state)
                            if root:
                                ckpt.save(step, host, val_psnr=val_psnr)
                            del host
                            # No process goes on before the checkpoint is
                            # whole.
                            self.mesh.barrier()
                        t0 = time.time()
                        rays_since_log = 0
            self._synchronize()
        finally:
            ckpt.close()
            self.batcher.close()
            if writer is not None:
                writer.close()
        wall = time.time() - t_loop
        train_s = wall - prof.totals.get('validate', 0.0) \
            - prof.totals.get('checkpoint', 0.0)
        self.fit_stats = {
            'steps': step - start_step,
            'loop_seconds': wall,
            'rays_per_sec': rays_total / max(train_s, 1e-9),
            'data_wait_share': prof.totals.get('data', 0.0) / max(wall, 1e-9),
        }
        if aux is not None:
            self.fit_stats['loss_first'] = float(first_aux['loss'][-1])
            self.fit_stats['loss_last'] = float(aux['loss'][-1])
        if verbose:
            print(prof.summary(), flush=True)
        return state
