"""The (data, model) mesh and its collectives.

Counterpart of mipnerf_pl_tpu/parallel/mesh.py.  `create_mesh` lays
`num_devices` shards out as a (data, model) grid, shard r at data index
r // model and model index r % model, as the JAX mesh reshapes its device
list.  Two forms behind one interface, and the caller says which:

  single-process  every shard lives on one torch device (`cuda` unless the
      caller asks for the CPU) and the shards run in turn.  A sum over an
      axis adds the shards' f32 partials in shard order.  The counterpart
      of JAX's one controller over several (virtual) devices, and the form
      one card runs: NCCL does not take two ranks on one device.
  multi-process  (`distributed=True`) one process a shard over
      `torch.distributed` (NCCL on a card, gloo on the CPU or, for two
      processes on one card, on CUDA tensors), initialised by the caller or
      by `maybe_initialize_distributed`; a `model` group and a `data` group
      per rank.

MipNeRFSystem drives both axes: rows over `data`, the MLP's Megatron pairs
over `model` (kernels/tp_lean.py, through `model_view`, the mesh as the
MLP of one data shard sees it).

The `model` collectives are Megatron's operators: `copy_to_model`
(identity forward, a sum over `model` backward), `reduce_from_model` (a
sum forward, identity backward) and `gather_from_model` (a column-parallel
layer's panels side by side forward, this rank's columns of the cotangent
backward).  On a single-process mesh autograd gives them for free: a
tensor used by every shard collects the sum of their cotangents, a sum
hands its cotangent to every term, a concatenation its slices.
`sum_over_model` assembles a multi-process mesh's panels of the state into
whole tensors (each rank's regions and zeros, summed).

The `data` collectives serve data parallelism, where every shard holds the
whole model and its rows of each batch: `data_rows` names the rows a
process computes, `reduce_from_data` sums the shards' partials over
`data`, `reduce_from_mesh` over the whole mesh (a step's gradients and loss
sums, whose model ranks have each added their own share), `assemble_rows`
hands every process the rows of all shards, and `broadcast_from_root`
starts every process from the first's parameters, which
`check_equal_over_mesh` holds the processes to.  They are `all_reduce` and
`broadcast` only (row assembly is a sum of zero-filled buffers), the two
collectives gloo also takes on CUDA tensors.  Where JAX places a global
array with `put_global` and `batch_sharding`, a process here computes its
own rows.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

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


class _GatherFromModel(torch.autograd.Function):
    """Out of a column-parallel layer that the next layers read whole: the
    model ranks' column panels side by side forward (this rank's columns
    written into a zero-filled f32 buffer, all-reduced over `model`), this
    rank's columns of the cotangent backward."""

    @staticmethod
    def forward(ctx, t, rank, n, group):
        w = t.shape[-1]
        ctx.cols = (rank * w, (rank + 1) * w)
        full = torch.zeros((*t.shape[:-1], n * w), dtype=torch.float32,
                           device=t.device)
        full[..., rank * w:(rank + 1) * w] = t
        dist.all_reduce(full, group=group)
        return full.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.cols
        return g[..., a:b].contiguous(), None, None, None


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

    def __repr__(self):
        where = f'process {self.rank}' if self.distributed else 'one process'
        return (f'Mesh(data={self.shape["data"]}, model={self.shape["model"]}'
                f', {where}, device={self.device})')

    @property
    def is_root(self) -> bool:
        """True on the process that writes the run's files: rank 0 of a
        multi-process mesh, and the one process of a single-process one."""
        return self.rank == 0

    def model_view(self) -> 'Mesh':
        """The mesh as the MLP of one data shard sees it: data 1, this
        mesh's `model` axis, ranks and group.  The system splits a batch's
        rows over `data` itself, so the MLP splits over `model` only."""
        return Mesh(1, self.shape['model'], self.device, self.distributed,
                    self.model_rank, self.model_group)

    def data_rows(self, total: int) -> List[Tuple[int, int]]:
        """[(start, stop)] of the data shards this process computes, as
        rows of a `total`-row batch split evenly over `data`: every shard
        in turn on a single-process mesh, this process's own on a
        multi-process one."""
        d = self.shape['data']
        if total % d:
            raise ValueError(f'{total} rows do not divide among data={d} '
                             'shards')
        per = total // d
        shards = [self.data_rank] if self.distributed else range(d)
        return [(i * per, (i + 1) * per) for i in shards]

    def reduce_from_data(self, partials: Sequence[Sequence[torch.Tensor]]
                         ) -> List[torch.Tensor]:
        """The sum over `data` of each tensor of a list, given one list a
        data shard this process computes (in `data_rows`' order): added in
        shard order on a single-process mesh, one `all_reduce` of the
        tensors packed into one f32 buffer on a multi-process one.  Every
        process gets the same sums."""
        return self._reduce(partials, self.data_group, self.shape['data'])

    def reduce_from_mesh(self, partials: Sequence[Sequence[torch.Tensor]]
                         ) -> List[torch.Tensor]:
        """As reduce_from_data, the sum taken over every process of the
        mesh: over `data` and `model` on a multi-process mesh, where each
        model rank hands in its own share of its data shard's sums.  On a
        single-process mesh the model ranks' shares are already added (the
        shards run in turn in one autograd graph), so it is
        reduce_from_data."""
        if self.shape['model'] == 1:
            return self.reduce_from_data(partials)
        return self._reduce(partials, None,
                            self.shape['data'] * self.shape['model'])

    def _reduce(self, partials, group, size: int) -> List[torch.Tensor]:
        if len(partials) != (1 if self.distributed else self.shape['data']):
            raise ValueError(f'{len(partials)} partials for a data axis of '
                             f'{self.shape["data"]} on {self!r}')
        if not self.distributed:
            totals = list(partials[0])
            for part in partials[1:]:
                totals = [a + b for a, b in zip(totals, part)]
            return totals
        tensors = list(partials[0])
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        if size > 1:
            dist.all_reduce(flat, group=group)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def assemble_rows(self, parts: Sequence[torch.Tensor], total: int
                      ) -> torch.Tensor:
        """The [total, ...] tensor of every shard's rows, given the rows of
        the shards this process computes (`data_rows(total)`'s order): a
        concatenation on a single-process mesh; on a multi-process one an
        `all_reduce` of a zero-filled buffer into which this process wrote
        its rows, so every process gets them all."""
        rows = self.data_rows(total)
        if len(parts) != len(rows):
            raise ValueError(f'{len(parts)} parts for the shards {rows}')
        if not self.distributed:
            return torch.cat(list(parts), dim=0)
        (start, stop), = rows
        part = parts[0]
        full = torch.zeros((total, *part.shape[1:]), dtype=part.dtype,
                           device=part.device)
        full[start:stop] = part
        if self.shape['data'] > 1:
            dist.all_reduce(full, group=self.data_group)
        return full

    def broadcast_from_root(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite the tensors IN PLACE with those of the mesh's first
        process (rank 0 of the whole group: every data and model rank
        holds the whole parameters); nothing to do on a single-process
        mesh."""
        if not self.distributed or dist.get_world_size() == 1:
            return
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)

    def check_equal_over_mesh(self, tensors: Sequence[torch.Tensor],
                              what: str, axis: Optional[str] = None) -> None:
        """Raise unless every process of the mesh (of this process's
        `axis` group: 'data' or 'model') holds the same bits in each f32
        tensor: one all_reduce(MAX) over the group of each tensor's bit sum
        and its negation.  Nothing to check on a single-process mesh."""
        if not self.distributed or dist.get_world_size() == 1:
            return
        group = {None: None, 'data': self.data_group,
                 'model': self.model_group}[axis]
        sums = torch.stack([t.detach().contiguous().view(torch.int32)
                            .to(torch.int64).sum() for t in tensors])
        both = torch.cat([sums, -sums])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
        n = len(tensors)
        if not torch.equal(both[:n], -both[n:]):
            where = '' if axis is None else f' over `{axis}`'
            raise RuntimeError(f'{what} differ between the processes of the '
                               f'mesh{where} ({self!r})')

    def barrier(self) -> None:
        """Wait for every process of the mesh (a one-element all_reduce on
        the mesh's device, which both backends take)."""
        if self.distributed:
            dist.all_reduce(torch.zeros(1, device=self.device))

    def copy_to_model(self, t: torch.Tensor) -> torch.Tensor:
        if not self.distributed:
            return t
        return _CopyToModel.apply(t, self.model_group)

    def sum_over_model(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The sum over this process's `model` group of each tensor of a
        multi-process mesh: one `all_reduce` of the tensors packed into
        one f32 buffer (how a process's panels of the state are assembled
        into whole tensors, each rank adding its own regions and zeros)."""
        if not self.distributed:
            raise ValueError('sum_over_model sums over the processes of a '
                             'multi-process mesh')
        return self._reduce([tensors], self.model_group, self.shape['model'])

    def gather_from_model(self, panels: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
        """The column panels of a column-parallel layer's output, one a
        model rank in `model_ranks`' order, side by side on the last dim:
        a concatenation on a single-process mesh; on a multi-process one an
        `all_reduce` of a zero-filled buffer holding this rank's columns,
        whose backward hands this rank its columns of the cotangent."""
        if len(panels) != len(self.model_ranks):
            raise ValueError(f'{len(panels)} panels for model ranks '
                             f'{self.model_ranks}')
        if self.distributed:
            return _GatherFromModel.apply(panels[0], self.model_rank,
                                          self.shape['model'],
                                          self.model_group)
        return torch.cat(list(panels), dim=-1)

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

    def split_rows(self, x: torch.Tensor, view: Optional[torch.Tensor],
                   num_samples: int):
        """[(x rows, view rows)] of the data shards this process computes:
        the rays split evenly on a single-process mesh, this process's own
        rows on a multi-process one.  With no view features (None) the rays
        are x's rows over num_samples."""
        rays = x.shape[0] // num_samples if view is None else view.shape[0]
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
                 None if view is None else view[i * per:(i + 1) * per])
                for i in range(d)]


def multi_host(hparams) -> bool:
    """Whether `parallel.multi_host` is set (None and 'None' are unset)."""
    v = hparams.get('parallel.multi_host')
    return v is not None and str(v) != 'None' and bool(v)


def maybe_initialize_distributed(hparams, device='cuda',
                                 timeout_s: float = 1800.0,
                                 backend: Optional[str] = None) -> bool:
    """`torch.distributed.init_process_group` gated on
    `parallel.multi_host`, from the same keys as the JAX package:
    `parallel.coordinator_address` (host:port), `parallel.num_processes`
    and `parallel.process_id`.  NCCL for a CUDA `device`, gloo for the CPU,
    unless `backend` says (gloo for two processes on one card).  Nothing
    tells a process of its cluster here, so all three are required.
    Returns True iff the group was initialised."""
    def _get(key):
        v = hparams.get(key)
        return None if v is None or str(v) == 'None' else v

    if not multi_host(hparams):
        return False
    keys = ('parallel.coordinator_address', 'parallel.num_processes',
            'parallel.process_id')
    missing = [k for k in keys if _get(k) is None]
    if missing:
        raise ValueError(f'parallel.multi_host needs {", ".join(missing)}')
    if backend is None:
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
    if model_axis < 1 or n % model_axis:
        # An assertion, as the JAX mesh's.
        raise AssertionError(f'parallel.model_axis={model_axis} does not '
                             f'divide num_devices={n}')
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


def process_count() -> int:
    """The processes of the run: the process group's world size, 1 with no
    group (jax.process_count())."""
    return dist.get_world_size() if dist.is_initialized() else 1


def model_axis(hparams) -> int:
    """`parallel.model_axis`, 1 where unset (None or 'None')."""
    v = hparams.get('parallel.model_axis')
    return 1 if v is None or str(v) == 'None' else int(v)


def requested_devices(hparams) -> int:
    """The device count the hparams ask for, as the JAX system reads it:
    `num_devices` wins; otherwise `num_gpus` when it is above 1 (0 or 1
    mean unset); 0 = every device there is."""
    def _int(key):
        v = hparams.get(key)
        return 0 if v is None or str(v) == 'None' else int(v)

    n = _int('num_devices')
    if n <= 0 and _int('num_gpus') > 1:
        n = _int('num_gpus')
    return max(n, 0)


def pad_batch_to_devices(n: int, num_devices: int) -> int:
    """Smallest multiple of num_devices >= n."""
    return ((n + num_devices - 1) // num_devices) * num_devices
