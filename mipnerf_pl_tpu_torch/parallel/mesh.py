"""The (data, model) mesh and its collectives.

Counterpart of mipnerf_pl_tpu/parallel/mesh.py.  `create_mesh` lays
`num_devices` shards out as a (data, model) grid, shard r at data index
r // model and model index r % model, as the JAX mesh reshapes its device
list.  Two forms behind one interface, and the caller says which:

  single-process  every shard lives on one torch device (`cuda` unless the
      caller asks for the CPU) and the shards run in turn.  A sum over the
      `model` axis adds the shards' f32 partials in rank order.  The
      counterpart of JAX's one controller over several (virtual) devices,
      and the form one card runs: NCCL does not take two ranks on one
      device.
  multi-process  (`distributed=True`) one process a shard over
      `torch.distributed` (NCCL on a card, gloo on the CPU), initialised by
      the caller or by `maybe_initialize_distributed`; a `model` group and
      a `data` group per rank.  Only the `model` axis has collectives here:
      each process passes its own rows, and reducing parameter gradients
      over `data` is not done.

The collectives are Megatron's two operators: `copy_to_model` (identity
forward, a sum over `model` backward) and `reduce_from_model` (a sum
forward, identity backward).  On a single-process mesh autograd gives both
for free: a tensor used by every shard collects the sum of their
cotangents, and a sum hands its cotangent to every term.
"""

from __future__ import annotations

import datetime
from typing import Sequence

import torch
import torch.distributed as dist


class _CopyToModel(torch.autograd.Function):
    """Into a column-parallel product: identity forward, all-reduce
    backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Out of a row-parallel product: all-reduce forward, identity
    backward."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class Mesh:
    """`shape == {'data': d, 'model': m}` over d * m shards.

    `model_ranks` are the model ranks this process computes (all of them on
    a single-process mesh, its own on a multi-process one); `device` is
    where its shards live."""

    def __init__(self, data: int, model: int, device: torch.device,
                 distributed: bool = False, rank: int = 0,
                 model_group=None, data_group=None):
        self.shape = {'data': data, 'model': model}
        self.device = torch.device(device)
        self.distributed = distributed
        self.rank = rank
        self.data_rank, self.model_rank = divmod(rank, model)
        self.model_group = model_group
        self.data_group = data_group
        self.model_ranks = [self.model_rank] if distributed \
            else list(range(model))

    def copy_to_model(self, t: torch.Tensor) -> torch.Tensor:
        if not self.distributed:
            return t
        return _CopyToModel.apply(t, self.model_group)

    def reduce_from_model(self, partials: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
        """The sum over `model` of one partial a model rank, in
        `model_ranks`' order."""
        if len(partials) != len(self.model_ranks):
            raise ValueError(f'{len(partials)} partials for model ranks '
                             f'{self.model_ranks}')
        if self.distributed:
            return _ReduceFromModel.apply(partials[0], self.model_group)
        total = partials[0]
        for p in partials[1:]:
            total = total + p
        return total

    def split_rows(self, x: torch.Tensor, view: torch.Tensor,
                   num_samples: int):
        """[(x rows, view rows)] of the data shards this process computes:
        the rays split evenly on a single-process mesh, this process's own
        rows on a multi-process one."""
        rays = view.shape[0]
        if x.shape[0] != rays * num_samples:
            raise ValueError(f'{x.shape[0]} rows is not {rays} rays x '
                             f'num_samples={num_samples}')
        if self.distributed:
            return [(x, view)]
        d = self.shape['data']
        if rays % d:
            raise ValueError(f'{rays} rays do not divide among data={d} '
                             'shards')
        per = rays // d
        return [(x[i * per * num_samples:(i + 1) * per * num_samples],
                 view[i * per:(i + 1) * per]) for i in range(d)]


def maybe_initialize_distributed(hparams, device='cuda',
                                 timeout_s: float = 1800.0) -> bool:
    """`torch.distributed.init_process_group` gated on
    `parallel.multi_host`, from the same keys as the JAX package:
    `parallel.coordinator_address` (host:port), `parallel.num_processes`
    and `parallel.process_id`.  NCCL for a CUDA `device`, gloo for the CPU.
    Nothing tells a process of its cluster here, so all three are required.
    Returns True iff the group was initialised."""
    def _get(key):
        v = hparams.get(key)
        return None if v is None or str(v) == 'None' else v

    if not _get('parallel.multi_host'):
        return False
    keys = ('parallel.coordinator_address', 'parallel.num_processes',
            'parallel.process_id')
    missing = [k for k in keys if _get(k) is None]
    if missing:
        raise ValueError(f'parallel.multi_host needs {", ".join(missing)}')
    backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    dist.init_process_group(
        backend, init_method=f'tcp://{_get(keys[0])}',
        world_size=int(_get(keys[1])), rank=int(_get(keys[2])),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def create_mesh(num_devices: int = 0, model_axis: int = 1, device=None,
                distributed: bool = False) -> Mesh:
    """A (data, model) mesh of `num_devices` shards.

    Args:
      num_devices: how many shards; 0 = all there are: the process group's
        world size on a multi-process mesh, the visible cards (one shard on
        the CPU) on a single-process one.
      model_axis: size of the model-parallel axis (1 = pure data
        parallelism).
      device: where this process's shards live; None = `cuda`, which must
        then be available.
      distributed: one process a shard over the initialised process group
        (whose world size must be `num_devices`), else every shard in this
        process.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise ValueError('create_mesh places its shards on a CUDA device '
                             'by default and none is available; pass '
                             'device=\'cpu\' to run on the CPU')
        device = 'cuda'
    device = torch.device(device)
    if distributed:
        if not dist.is_initialized():
            raise ValueError('a multi-process mesh needs an initialised '
                             'process group (maybe_initialize_distributed)')
        world = dist.get_world_size()
        n = num_devices if num_devices and num_devices > 0 else world
        if n != world:
            raise ValueError(f'num_devices={n} but the process group has '
                             f'{world} processes')
    elif num_devices and num_devices > 0:
        n = num_devices
    else:
        n = torch.cuda.device_count() if device.type == 'cuda' else 1
    assert n % model_axis == 0, (n, model_axis)
    data = n // model_axis
    if not distributed:
        return Mesh(data, model_axis, device)
    # Every process creates every group, in the same order.
    rank = dist.get_rank()
    grid = [[i * model_axis + j for j in range(model_axis)]
            for i in range(data)]
    model_group = data_group = None
    for i in range(data):
        group = dist.new_group(grid[i])
        if rank in grid[i]:
            model_group = group
    for j in range(model_axis):
        ranks = [grid[i][j] for i in range(data)]
        group = dist.new_group(ranks)
        if rank in ranks:
            data_group = group
    return Mesh(data, model_axis, device, True, rank, model_group,
                data_group)


def pad_batch_to_devices(n: int, num_devices: int) -> int:
    """Smallest multiple of num_devices >= n."""
    return ((n + num_devices - 1) // num_devices) * num_devices
