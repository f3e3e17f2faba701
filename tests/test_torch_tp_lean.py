"""The port's tensor-parallel lean MLP (kernels/tp_lean.py) against the JAX
package's (CPU).

The JAX side runs on the 8-device virtual mesh with its Pallas pair kernels
in interpret mode, as tests/test_tp_lean.py runs them; the port's wrappers
take their plain versions for CPU tensors, on a single-process mesh of the
same shape.  Inputs and the flat parameter list come from one numpy seed and
go to both.  f32: forwards at rtol = atol = 1e-5, every gradient within 2e-4
of its norm (the bars of the kernel tests; the sums over `model` and over
the rows run in another order).  bf16: within 3e-2 of the largest entry.
One case runs the multi-process form: 2 gloo processes on the CPU.
"""

import os
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf_pl_tpu.kernels import tp_lean as jtp
from mipnerf_pl_tpu.parallel.mesh import create_mesh as jax_create_mesh
from mipnerf_pl_tpu_torch.kernels import mlp as tk
from mipnerf_pl_tpu_torch.kernels import tp_lean as ttp
from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh

# name -> (devices, model axis, W, view width, net_depth_condition, f_x)
CASES = {
    'dp4_tp2_w128': (8, 2, 128, 32, 1, 24),
    'dp4_tp2_w256': (8, 2, 256, 32, 1, 96),
    'dp2_tp4_w64': (8, 4, 64, 16, 1, 32),
    'dp4_tp2_w128_view2': (8, 2, 128, 32, 2, 24),
}
N, R, F_V = 8, 64, 27


def _flat_params(rng, f_x, f_v, W, wv, net_depth=8, nvd=1, skip=4, nd=1):
    """Random params in the lean flat layout, as tests/test_tp_lean.py
    draws them."""
    def kb(fin, fout):
        return [rng.normal(size=(fin, fout)).astype(np.float32)
                * (1.0 / np.sqrt(fin)),
                rng.normal(size=(1, fout)).astype(np.float32) * 0.1]

    flat, fin = [], f_x
    for i in range(net_depth):
        flat += kb(fin, W)
        fin = W + f_x if (i % skip == 0 and i > 0) else W
    flat += kb(W, nd) + kb(W, W) + kb(W + f_v, wv)
    for _ in range(1, nvd):
        flat += kb(wv, wv)
    return flat + kb(wv, 3)


def _problem(case, seed=0):
    """(x, view, flat, rgb cotangent, density cotangent) as numpy."""
    _, _, W, wv, nvd, f_x = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R * N, f_x)).astype(np.float32)
    view = rng.normal(size=(R, F_V)).astype(np.float32)
    flat = _flat_params(rng, f_x, F_V, W, wv, nvd=nvd)
    cr = rng.normal(size=(R * N, 3)).astype(np.float32)
    cd = rng.normal(size=(R * N, 1)).astype(np.float32)
    return x, view, flat, cr, cd


def _jax_run(case, prob, dtype=jnp.float32):
    """JAX tp_lean_forward and the gradients of the seeded linear loss:
    ([rgb, density], [dx, dview, leaves...])."""
    n, m, _, _, nvd, _ = CASES[case]
    x, view, flat, cr, cd = prob
    mesh = jax_create_mesh(num_devices=n, model_axis=m)

    def fwd(x_, view_, flat_):
        return jtp.tp_lean_forward(x_, view_, flat_, mesh, num_samples=N,
                                   net_depth_condition=nvd,
                                   compute_dtype=dtype, interpret=True)

    def loss(args):
        rgb, dens = fwd(*args)
        return jnp.sum(rgb * cr) + jnp.sum(dens * cd)

    args = (jnp.asarray(x), jnp.asarray(view), [jnp.asarray(p) for p in flat])
    out = fwd(*args)
    gx, gv, gf = jax.grad(loss)(args)
    return ([np.asarray(o, np.float32) for o in out],
            [np.asarray(g, np.float32) for g in [gx, gv] + list(gf)])


def _port_run(prob, mesh, nvd, dtype=torch.float32, fwd=None):
    """The port's tp_lean_forward (or `fwd`) and the same gradients."""
    x, view, flat, cr, cd = prob
    leaves = [torch.tensor(a, requires_grad=True) for a in [x, view] + flat]
    if fwd is None:
        rgb, dens = ttp.tp_lean_forward(
            leaves[0], leaves[1], leaves[2:], mesh, N,
            net_depth_condition=nvd, compute_dtype=dtype)
    else:
        rgb, dens = fwd(leaves[0], leaves[1], leaves[2:])
    grads = torch.autograd.grad(
        (rgb * torch.tensor(cr)).sum() + (dens * torch.tensor(cd)).sum(),
        leaves)
    return ([rgb.detach().numpy(), dens.detach().numpy()],
            [g.numpy() for g in grads])


def _names(n_flat):
    return ['dx', 'dview'] + [f'flat[{i}]' for i in range(n_flat)]


def _assert_norm_close(got, want, bar, names):
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        err = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert err <= bar, (name, err)


def _pair_inputs(seed, M=256, f_in=24, Wl=32, Wout=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, f_in)).astype(np.float32),
            (rng.normal(size=(f_in, Wl)) / np.sqrt(f_in)).astype(np.float32),
            (rng.normal(size=(1, Wl)) * 0.1).astype(np.float32),
            (rng.normal(size=(Wl, Wout)) / np.sqrt(Wl)).astype(np.float32),
            rng.normal(size=(M, Wout)).astype(np.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_pair_plain_matches_jax_pair_call(dtype):
    """`_pair_plain` against `_pair_call` in interpret mode: f32 at 1e-5,
    bf16 within 3e-2 of the largest entry."""
    x, wc, bc, wr, _ = _pair_inputs(0)
    want = np.asarray(jtp._pair_call(
        *(jnp.asarray(a) for a in (x, wc, bc, wr)), getattr(jnp, dtype),
        True))
    got = ttp._pair_call(*(torch.tensor(a) for a in (x, wc, bc, wr)),
                         getattr(torch, dtype)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_pair_bwd_plain_matches_jax_pair_bwd_call(dtype):
    """`_pair_bwd_plain` against `_pair_bwd_call` in interpret mode: dx,
    dWcol, dbcol, dWrow within 2e-4 of their norms in f32, 3e-2 in bf16."""
    arrays = _pair_inputs(1)
    want = [np.asarray(g) for g in jtp._pair_bwd_call(
        *(jnp.asarray(a) for a in arrays), getattr(jnp, dtype), True)]
    got = [g.numpy() for g in ttp._pair_bwd_call(
        *(torch.tensor(a) for a in arrays), getattr(torch, dtype))]
    _assert_norm_close(got, want, 2e-4 if dtype == 'float32' else 3e-2,
                       ['dx', 'dWcol', 'dbcol', 'dWrow'])


def test_pair_function_casts_dx_to_the_input_dtype():
    """The autograd Function hands a later pair's input its cotangent in the
    compute dtype (the pair boundary rounds it), the first pair's in f32."""
    x, wc, bc, wr, g = (torch.tensor(a) for a in _pair_inputs(2))
    for x_in in (x, torch.relu(x).to(torch.bfloat16)):
        leaf = x_in.clone().requires_grad_(True)
        out = ttp._pair(leaf, wc, bc, wr, torch.bfloat16)
        out.backward(g)
        assert out.dtype == torch.float32 and leaf.grad.dtype == x_in.dtype
        want = ttp._pair_bwd_plain(x_in, wc, bc, wr, g, torch.bfloat16)[0]
        assert torch.equal(leaf.grad, want.to(x_in.dtype))


# (f_in, local width, output width, whether tp_pair_wg_kernel takes them):
# the TP slice's pairs (net_width 1024 on a model axis of 2, 256 on 4: the
# first and the later pairs), the card tests' shapes, and each edge of the
# rule (a local width a multiple of 64 up to 512, an output width a
# multiple of 64, any f_in from 1).
PAIR_ROUTES = [
    (96, 512, 1024, True), (1024, 512, 1024, True), (96, 64, 256, True),
    (256, 64, 256, True), (96, 64, 128, True), (40, 192, 320, True),
    (1, 64, 64, True), (1000, 448, 4096, True),
    (24, 16, 32, False), (40, 272, 528, False), (272, 64, 272, False),
    (96, 576, 1024, False), (96, 512, 1000, False), (96, 32, 64, False),
    (96, 64, 32, False), (0, 64, 64, False)]


@pytest.mark.parametrize('f_in,Wl,Wout,want', PAIR_ROUTES)
def test_pair_wg_route(f_in, Wl, Wout, want):
    """pair_sm90_route takes the widths in bf16 only, pair_tf32_route the
    same widths in f32 only: the TP slice's pairs take the wgmma kernel in
    both dtypes, the ragged widths keep the mma.sync kernels."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert ttp.pair_sm90_route(bf16, f_in, Wl, Wout) is want
    assert ttp.pair_tf32_route(f32, f_in, Wl, Wout) is want
    assert ttp.pair_sm90_route(f32, f_in, Wl, Wout) is False
    assert ttp.pair_tf32_route(bf16, f_in, Wl, Wout) is False


def _pair_cuh():
    """The constants of csrc/tp_pair_sm90.cuh as a dict."""
    import re
    from pathlib import Path
    src = (Path(ttp.__file__).resolve().parent.parent / 'csrc'
           / 'tp_pair_sm90.cuh').read_text()
    return {k: int(v) for k, v in
            re.findall(r'constexpr (?:int|size_t) (\w+) = (\d+);', src)}


@pytest.mark.parametrize('dtype,Wl,stages', [
    ('bfloat16', 512, 4), ('bfloat16', 64, 4), ('float32', 512, 2),
    ('float32', 448, 2), ('float32', 384, 3), ('float32', 256, 4)])
def test_pair_wg_plan_mirror(dtype, Wl, stages):
    """The Python mirror of tp_pair_wg_kernel's plan (pair_wg_smem,
    pair_wg_stages) uses the C++ constants (read from the source): a ring
    stage is the 4 KB A slab and 8 weight boxes of 4 KB; the ring has the
    most stages up to TP_MAX_STAGES that fit beside the hidden tile, counted
    by hand: the f32 tile at Wl = 512 (128 KB) leaves room for two, bf16's
    (64 KB) for four, and one stage more never fits."""
    c = _pair_cuh()
    assert ttp.TP_MAX_STAGES == c['TP_MAX_STAGES']
    assert ttp.TP_STAGE == c['TP_ABYTES'] + 8 * c['TP_BOX']
    assert ttp.TP_SMEM_MAX == c['TP_SMEM_MAX']
    assert ttp.MAX_LOCAL == c['TP_MAX_LOCAL']
    assert (c['TP_TM'], c['TP_PART'], c['TP_HELPERS']) == (64, 256, 2)
    dt = getattr(torch, dtype)
    assert ttp.pair_wg_stages(dt, Wl) == stages
    tile = Wl * 64 * (2 if dtype == 'bfloat16' else 4)
    want = stages * ttp.TP_STAGE + tile + 8 * 3 * 4 + 4 * (2 * Wl + 2048) + 1024
    assert ttp.pair_wg_smem(dt, Wl, stages) == want <= ttp.TP_SMEM_MAX
    if stages < ttp.TP_MAX_STAGES:
        assert ttp.pair_wg_smem(dt, Wl, stages + 1) > ttp.TP_SMEM_MAX


@pytest.mark.parametrize('f_in,Wl,Wout', [(96, 512, 1024), (40, 192, 320),
                                          (1024, 64, 256), (1, 64, 64)])
def test_pair_tf32_weights_layout(f_in, Wl, Wout):
    """The f32 form's B operands: each product's B transposed and padded
    (P1 Wcol^T [Wl, f_in -> 16], P2 Wrow^T, P3 Wrow, P4 Wcol [f_in -> 64,
    Wl]) is exactly hi + lo of its [hi; lo] split, hi a tf32 value (its 13
    low mantissa bits zero), the padding zero."""
    rng = np.random.default_rng(7)
    wc = torch.tensor(rng.normal(size=(f_in, Wl)).astype(np.float32))
    wr = torch.tensor(rng.normal(size=(Wl, Wout)).astype(np.float32))
    fwd = ttp.pair_tf32_weights(wc, wr, backward=False)
    bwd = ttp.pair_tf32_weights(wc, wr, backward=True)
    assert fwd[2] is None and fwd[3] is None and bwd[1] is None
    assert torch.equal(fwd[0], bwd[0])
    r16, r64 = -(-f_in // 16) * 16, -(-f_in // 64) * 64
    for t, bt, n, k in ((fwd[0], wc.t(), Wl, r16), (fwd[1], wr.t(), Wout, Wl),
                        (bwd[2], wr, Wl, Wout), (bwd[3], wc, r64, Wl)):
        assert t.shape == (2 * n, k) and t.dtype == torch.float32
        assert t.is_contiguous()
        hi, lo = t[:n], t[n:]
        want = torch.zeros(n, k)
        want[:bt.shape[0], :bt.shape[1]] = bt
        assert torch.equal(hi + lo, want)
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        assert lo.abs().max() <= 2.0 ** -11 * want.abs().max()


@pytest.mark.parametrize('case', list(CASES))
def test_tp_lean_forward_matches_jax(case):
    """Forward and every gradient leaf, dx and dview, port against JAX on
    the same (data, model) mesh."""
    n, m, _, _, nvd, _ = CASES[case]
    prob = _problem(case)
    want_out, want_g = _jax_run(case, prob)
    got_out, got_g = _port_run(prob, create_mesh(n, m, device='cpu'), nvd)
    for a, b in zip(got_out, want_out):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    _assert_norm_close(got_g, want_g, 2e-4, _names(len(prob[2])))


@pytest.mark.parametrize('case', ['dp4_tp2_w128', 'dp2_tp4_w64',
                                  'dp4_tp2_w128_view2'])
def test_tp_lean_forward_matches_full_width_plain(case):
    """Against the port's own full-width plain lean forward, at
    tests/test_tp_lean.py's tolerances: 2e-4 forward, rtol 1e-3 / atol 1e-4
    on every gradient."""
    n, m, _, _, nvd, _ = CASES[case]
    prob = _problem(case, seed=3)
    got_out, got_g = _port_run(prob, create_mesh(n, m, device='cpu'), nvd)
    want_out, want_g = _port_run(
        prob, None, nvd,
        fwd=lambda x, v, fl: tk.lean_fwd_plain(x, v, fl, N, 8, nvd, 4,
                                               torch.float32, None))
    for a, b in zip(got_out, want_out):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    for name, a, b in zip(_names(len(prob[2])), got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=name)


def test_tp_lean_forward_bf16_matches_jax():
    """bf16 on both sides (the casts in the same places: operands and every
    pair boundary's cotangent in bf16, biases and sums in f32): raw heads
    within 3e-2 of the largest entry, every gradient within 3e-2 of its
    norm.  (The full-width lean forward is no reference here: it rounds
    its biases to bf16, which this function, like JAX's, does not.)"""
    case = 'dp4_tp2_w128'
    n, m, _, _, nvd, _ = CASES[case]
    prob = _problem(case, seed=4)
    got_out, got_g = _port_run(prob, create_mesh(n, m, device='cpu'), nvd,
                               torch.bfloat16)
    want_out, want_g = _jax_run(case, prob, jnp.bfloat16)
    for a, b in zip(got_out, want_out):
        assert np.abs(a - b).max() <= 3e-2 * np.abs(b).max()
    _assert_norm_close(got_g, want_g, 3e-2, _names(len(prob[2])))


def test_tp_lean_backward_runs_are_bit_equal():
    case = 'dp2_tp4_w64'
    n, m, _, _, nvd, _ = CASES[case]
    prob = _problem(case, seed=5)
    mesh = create_mesh(n, m, device='cpu')
    first, again = (_port_run(prob, mesh, nvd) for _ in range(2))
    for a, b in zip(first[0] + first[1], again[0] + again[1]):
        assert np.array_equal(a, b)


# The shapes the Megatron pairs alone do not take (tp_mlp_forward's): an
# odd depth, an odd skip index, a skip after the last layer, no view layer,
# no view directions; and two view layers beside the odd skip.
SPLIT_SHAPES = {
    'depth7': dict(net_depth=7, skip_index=4),
    'skip3': dict(net_depth=8, skip_index=3),
    'depth4-skip1': dict(net_depth=4, skip_index=1),
    'condition0': dict(net_depth=8, skip_index=4, net_depth_condition=0),
    'no-viewdirs': dict(net_depth=8, skip_index=4, view_dim=0),
    'depth5-condition2': dict(net_depth=5, skip_index=3,
                              net_depth_condition=2),
}


@pytest.mark.parametrize('model_axis', [2, 4])
@pytest.mark.parametrize('shape', list(SPLIT_SHAPES))
def test_tp_mlp_forward_matches_the_plain_mlp(shape, model_axis):
    """tp_mlp_forward on its plain pairs over data 8 / m x model m of the
    single-process mesh against the single-device plain MLP
    (models/mlp.py `_plain`) with the same seeded weights, f32: the raw
    heads within 2e-4, every gradient (x, the view features, each
    parameter) within rtol 1e-3 / atol 1e-4 (this file's full-width
    tolerances)."""
    from mipnerf_pl_tpu_torch.models.mlp import MLP
    kw = dict(SPLIT_SHAPES[shape])
    view_dim = kw.pop('view_dim', F_V)
    mlp = MLP(24, view_dim, net_width=64, net_width_condition=32,
              generator=torch.Generator().manual_seed(0), **kw)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(R, N, 24)).astype(np.float32),
                     requires_grad=True)
    view = (torch.tensor(rng.normal(size=(R, F_V)).astype(np.float32),
                         requires_grad=True) if view_dim else None)
    cr = torch.tensor(rng.normal(size=(R, N, 3)).astype(np.float32))
    cd = torch.tensor(rng.normal(size=(R, N, 1)).astype(np.float32))
    inputs = [x] + ([view] if view_dim else [])
    flat = tk.flatten_params(mlp, mlp.net_depth, mlp.net_depth_condition,
                             mlp.use_viewdirs)

    def grads(rgb, dens):
        loss = (rgb.reshape(R, N, 3) * cr).sum() + \
            (dens.reshape(R, N, 1) * cd).sum()
        return torch.autograd.grad(loss, inputs + list(mlp.parameters()))

    want_out = mlp._plain(x, view)
    want_g = grads(*want_out)
    got_out = ttp.tp_mlp_forward(
        x.reshape(-1, 24), view, flat,
        create_mesh(8, model_axis, device='cpu'), N, mlp.net_depth,
        mlp.net_depth_condition, mlp.skip_index, torch.float32, plain=True)
    got_g = grads(*got_out)
    for a, b in zip(got_out, want_out):
        np.testing.assert_allclose(a.detach().numpy().reshape(b.shape),
                                   b.detach().numpy(), rtol=2e-4, atol=2e-4)
    assert len(got_g) == len(want_g)
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=str(i))


@pytest.mark.parametrize('kwargs,match', [
    (dict(net_depth=7), 'tp_lean_forward needs an even net_depth'),
    (dict(skip_index=3), 'tp_lean_forward needs an even skip_index'),
    (dict(width=17), 'net_width 17 not divisible by model=2'),
])
def test_tp_lean_validates_shapes(kwargs, match):
    """The three ValueErrors of the JAX function, in its words."""
    kwargs = dict(kwargs)
    W = kwargs.pop('width', 16)
    rng = np.random.default_rng(2)
    flat = [torch.tensor(p) for p in _flat_params(rng, 8, 3, W, 8)]
    mesh = create_mesh(2, 2, device='cpu')
    with pytest.raises(ValueError, match=match):
        ttp.tp_lean_forward(torch.zeros(16, 8), torch.zeros(4, 3), flat, mesh,
                            num_samples=4, **kwargs)


def test_tp_lean_rows_must_divide_among_the_data_shards():
    rng = np.random.default_rng(2)
    flat = [torch.tensor(p) for p in _flat_params(rng, 8, 3, 16, 8)]
    mesh = create_mesh(8, 2, device='cpu')
    with pytest.raises(ValueError, match='divide among data=4'):
        ttp.tp_lean_forward(torch.zeros(24, 8), torch.zeros(6, 3), flat, mesh,
                            num_samples=4, compute_dtype=torch.float32)


def _sharding(i, flat, net_depth=8):
    """(leading rows of flat[i] that the model axis splits, the axis they
    are split on): whole even trunk layers and the bottleneck by columns,
    the h-rows of odd trunk kernels and of view_0's kernel by rows; the
    rest is replicated."""
    W = flat[0].shape[1]
    layer, is_bias = divmod(i, 2)
    if layer < net_depth and layer % 2 == 0 or layer == net_depth + 1:
        return flat[i].shape[0], 'col'
    if not is_bias and (layer < net_depth or layer == net_depth + 2):
        return W, 'row'
    return 0, None


def _worker(rank: int, port: int, out_dir: str) -> None:
    """One process of the 2-process gloo mesh (model 2, data 1): the
    forward and the gradients of the seeded loss, saved for the parent."""
    import torch.distributed as dist
    from mipnerf_pl_tpu_torch.parallel.mesh import \
        maybe_initialize_distributed
    assert maybe_initialize_distributed(
        {'parallel.multi_host': True,
         'parallel.coordinator_address': f'localhost:{port}',
         'parallel.num_processes': 2, 'parallel.process_id': rank},
        device='cpu', timeout_s=60)
    try:
        mesh = create_mesh(2, 2, device='cpu', distributed=True)
        assert mesh.model_ranks == [rank] and mesh.shape == {'data': 1,
                                                             'model': 2}
        out, grads = _port_run(_problem('dp4_tp2_w128', seed=6), mesh, 1)
        np.savez(os.path.join(out_dir, f'rank{rank}.npz'),
                 *out, *grads)
    finally:
        dist.destroy_process_group()


def test_tp_lean_two_gloo_processes_match_the_single_process_mesh():
    """Model axis 2 over 2 gloo processes on the CPU: each rank's outputs,
    dx, dview and replicated gradients, and the sum of the ranks' sharded
    gradients (a rank's are zero outside its panel), equal the
    single-process mesh's within 1e-6 of each tensor's largest entry."""
    prob = _problem('dp4_tp2_w128', seed=6)
    flat = prob[2]
    want_out, want_g = _port_run(prob, create_mesh(2, 2, device='cpu'), 1)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    # The children run this file as a script: they import the packages from
    # the repository's root.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # One thread a process: torch's default of a thread a core oversubscribes
    # the host beside the other pytest workers (test_torch_tp_system.py's
    # _cli).
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]),
               OMP_NUM_THREADS='1')
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(port),
             out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env) for rank in range(2)]
        try:
            logs = [p.communicate(timeout=150)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]
        ranks = []
        for rank in range(2):
            with np.load(os.path.join(out_dir, f'rank{rank}.npz')) as z:
                ranks.append([z[k] for k in z.files])

    def close(a, b, what):
        assert a.shape == b.shape, what
        if a.size:
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(),
                                                     1.0), what

    n_out = len(want_out)
    want = want_out + want_g
    for j, b in enumerate(want):
        per_rank = [r[j] for r in ranks]
        i = j - n_out - 2          # index into flat, < 0 for outputs, dx, dview
        rows, axis = _sharding(i, flat) if i >= 0 else (0, None)
        for r, a in enumerate(per_rank):
            close(a[rows:], b[rows:], f'tensor {j} rank {r} (replicated)')
        if rows:
            close(sum(a[:rows] for a in per_rank), b[:rows],
                  f'tensor {j} (sharded rows summed over the ranks)')
            for r, a in enumerate(per_rank):
                # A rank's gradient is zero outside its own panel.
                half = (a.shape[1] if axis == 'col' else rows) // 2
                lo, hi = (1 - r) * half, (2 - r) * half
                other = a[:, lo:hi] if axis == 'col' else a[lo:hi]
                assert not other.any(), f'tensor {j} rank {r}'


if __name__ == '__main__':
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
