"""Tensor parallelism for the Mip-NeRF MLP over the mesh's `model` axis.

Counterpart of mipnerf_pl_tpu/parallel/tp.py: the Megatron table on the
port's parameter names.  Trunk layers alternate column-parallel (even:
outputs split) and row-parallel (odd: inputs split); the bottleneck and the
view layers are column-parallel; the density and rgb heads are replicated.
A bias follows its layer's outputs, so it is split only in a column-parallel
layer.

The port's parameters are `nn.Linear` leaves, `<module>.<layer>.weight`
[out, in] and `.bias` [out]: the transpose of the flax kernel [in, out].
A column-parallel weight is therefore split on dim 0 here where JAX's spec
names dim 1, and a row-parallel one on dim 1.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from mipnerf_pl_tpu_torch.parallel.mesh import Mesh


def _spec_for(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dim of parameter `name` that the `model` axis splits, or None
    for a replicated one."""
    if len(shape) == 0:
        return None
    m = re.search(r'trunk_(\d+)', name)
    if m is not None:
        col = int(m.group(1)) % 2 == 0
        if len(shape) == 2:
            return 0 if col else 1
        return 0 if col else None
    if 'bottleneck' in name or re.search(r'view_\d+', name):
        return 0
    return None


def _check_divides(name, shape, dim, n):
    if shape[dim] % n:
        raise ValueError(f'{name}: dim {dim} of {tuple(shape)} does not '
                         f'divide among model={n} shards')


def shard_params_tp(params: Dict[str, torch.Tensor], mesh: Mesh
                    ) -> List[Dict[str, torch.Tensor]]:
    """The local panels of `params`, one dict for each model rank this
    process computes (`mesh.model_ranks`): views of the full tensors."""
    n = mesh.shape['model']
    shards = []
    for r in mesh.model_ranks:
        local = {}
        for name, t in params.items():
            dim = _spec_for(name, t.shape)
            if dim is None:
                local[name] = t
                continue
            _check_divides(name, t.shape, dim, n)
            local[name] = t.chunk(n, dim=dim)[r]
        shards.append(local)
    return shards


def gather_params_tp(shards: List[Dict[str, torch.Tensor]], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """The full parameters back from `shard_params_tp`'s panels: a
    concatenation on a single-process mesh, an all-gather over the `model`
    group on a multi-process one."""
    if len(shards) != len(mesh.model_ranks):
        raise ValueError(f'{len(shards)} shards for model ranks '
                         f'{mesh.model_ranks}')
    full = {}
    for name, t in shards[0].items():
        dim = _spec_for(name, t.shape)
        if dim is None:
            full[name] = t
        elif mesh.distributed:
            parts = [torch.empty_like(t) for _ in range(mesh.shape['model'])]
            dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
            full[name] = torch.cat(parts, dim=dim)
        else:
            full[name] = torch.cat([s[name] for s in shards], dim=dim)
    return full
