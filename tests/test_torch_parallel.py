"""The port's mesh (parallel/mesh.py) and Megatron shardings (parallel/tp.py)
against the JAX package's (CPU).

`create_mesh` and `pad_batch_to_devices` against the JAX functions on the
8-device virtual mesh; the port's `_spec_for` against JAX's for every
parameter of a tiny model (a torch weight is [out, in], the transpose of the
flax kernel, so a split dim d of a JAX kernel is dim 1 - d here); shard then
gather is the identity.
"""

import jax
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.parallel import mesh as jmesh
from mipnerf_pl_tpu.parallel import tp as jtp
from mipnerf_pl_tpu_torch.kernels.mlp import param_order
from mipnerf_pl_tpu_torch.models.mlp import MLP
from mipnerf_pl_tpu_torch.parallel import mesh as tmesh
from mipnerf_pl_tpu_torch.parallel import tp as ttp

DEPTH, DEPTH_COND = 4, 2
PARAM_NAMES = [f'mlp.{layer}.{kind}'
               for layer in param_order(DEPTH, DEPTH_COND)
               for kind in ('weight', 'bias')]


def _tiny_params():
    """The tiny model's parameters under the port's names."""
    mlp = MLP(xyz_dim=24, view_dim=9, net_depth=DEPTH, net_width=16,
              net_depth_condition=DEPTH_COND, net_width_condition=8,
              skip_index=2, generator=torch.Generator().manual_seed(0))
    return {f'mlp.{k}': v.detach() for k, v in mlp.state_dict().items()}


@pytest.mark.parametrize('num_devices,model_axis', [(8, 1), (8, 2), (8, 4),
                                                    (4, 2), (2, 2)])
def test_create_mesh_shape_matches_jax(num_devices, model_axis):
    want = jmesh.create_mesh(num_devices, model_axis).shape
    mesh = tmesh.create_mesh(num_devices, model_axis, device='cpu')
    assert mesh.shape == dict(want)
    assert mesh.model_ranks == list(range(model_axis))
    assert not mesh.distributed and mesh.device.type == 'cpu'


def test_create_mesh_asserts_divisibility_as_jax_does():
    with pytest.raises(AssertionError):
        jmesh.create_mesh(8, 3)
    with pytest.raises(AssertionError):
        tmesh.create_mesh(8, 3, device='cpu')


def test_create_mesh_needs_a_card_unless_asked_for_the_cpu():
    """No form is picked by what is found: without a CUDA device the
    default raises, and a multi-process mesh needs its process group."""
    if torch.cuda.is_available():
        assert tmesh.create_mesh(2, 2).device.type == 'cuda'
    else:
        with pytest.raises(ValueError, match="device='cpu'"):
            tmesh.create_mesh(2, 2)
    with pytest.raises(ValueError, match='process group'):
        tmesh.create_mesh(2, 2, device='cpu', distributed=True)


@pytest.mark.parametrize('n,num_devices', [(0, 8), (1, 8), (8, 8), (3073, 4),
                                           (4096, 3)])
def test_pad_batch_to_devices_matches_jax(n, num_devices):
    assert (tmesh.pad_batch_to_devices(n, num_devices)
            == jmesh.pad_batch_to_devices(n, num_devices))


def test_maybe_initialize_distributed_reads_the_parallel_keys():
    assert tmesh.maybe_initialize_distributed({}, device='cpu') is False
    assert tmesh.maybe_initialize_distributed(
        {'parallel.multi_host': False}, device='cpu') is False
    with pytest.raises(ValueError, match='parallel.process_id'):
        tmesh.maybe_initialize_distributed(
            {'parallel.multi_host': True,
             'parallel.coordinator_address': 'localhost:1',
             'parallel.num_processes': 2, 'parallel.process_id': None},
            device='cpu')


def test_mesh_sums_in_rank_order_and_splits_rows():
    mesh = tmesh.create_mesh(8, 4, device='cpu')
    parts = [torch.tensor([v], dtype=torch.float32)
             for v in (1e8, 1.0, -1e8, 1.0)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(mesh.reduce_from_model(parts), want)
    assert mesh.copy_to_model(parts[0]) is parts[0]
    with pytest.raises(ValueError, match='partials'):
        mesh.reduce_from_model(parts[:2])
    x, view = torch.arange(24.).reshape(12, 2), torch.arange(4.).reshape(4, 1)
    rows = mesh.split_rows(x, view, 3)
    assert len(rows) == 2
    assert torch.equal(torch.cat([r[0] for r in rows]), x)
    assert torch.equal(rows[1][1], view[2:])
    with pytest.raises(ValueError, match='num_samples'):
        mesh.split_rows(x, view, 2)


@pytest.mark.parametrize('name', PARAM_NAMES)
def test_spec_matches_jax(name):
    """The port's split dim of every parameter against JAX's
    PartitionSpec for the same layer."""
    t = _tiny_params()[name]
    _, layer, kind = name.split('.')
    leaf = np.zeros(tuple(t.t().shape) if kind == 'weight' else t.shape)
    tree = {'params': {'mlp': {layer: {
        'kernel' if kind == 'weight' else 'bias': leaf}}}}
    (path, _), = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec = jtp._spec_for('/'.join(str(p) for p in path), leaf)
    jax_dim = next((d for d, axis in enumerate(spec) if axis == 'model'),
                   None)
    want = jax_dim if jax_dim is None or kind == 'bias' else 1 - jax_dim
    assert ttp._spec_for(name, t.shape) == want


@pytest.mark.parametrize('model_axis', [2, 4])
def test_shard_then_gather_is_the_identity(model_axis):
    params = _tiny_params()
    mesh = tmesh.create_mesh(8, model_axis, device='cpu')
    shards = ttp.shard_params_tp(params, mesh)
    assert len(shards) == model_axis
    for name, t in params.items():
        dim = ttp._spec_for(name, t.shape)
        for local in shards:
            want = list(t.shape)
            if dim is not None:
                want[dim] //= model_axis
            assert list(local[name].shape) == want, name
    full = ttp.gather_params_tp(shards, mesh)
    assert full.keys() == params.keys()
    for name, t in params.items():
        assert torch.equal(full[name], t), name


def test_shard_params_refuses_a_width_that_does_not_divide():
    mesh = tmesh.create_mesh(3, 3, device='cpu')
    with pytest.raises(ValueError, match='model=3'):
        ttp.shard_params_tp(_tiny_params(), mesh)
