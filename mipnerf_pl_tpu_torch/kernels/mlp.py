"""The fused lean-render level kernels (CUDA, sm_90a) and their plain twins.

Replaces mipnerf_pl_tpu/kernels/mlp.py:fused_mlp_lean_render, forward only
(the TPU kernel `_fwd_kernel_lean_render` behind the `pl.pallas_call` of
`_run_fwd_lean_render`, save=False, encode=(min_deg, max_deg)).  That one
Pallas kernel decodes the IPE from the [6, M] moments, runs the lean MLP,
applies the head activations and composites every ray.  On the card it is
three hand-written kernels in csrc/lean_render.cu, one wrapper each here:

  view_proj       view_0's per-ray half, once per ray       -> [R, Wv] f32
  lean_mlp        IPE decode + MLP + activations per tile   -> [M, 4]  f32
  lean_composite  per-ray scan and reductions               -> [R, 8], [R, N]

What bounds them: `lean_mlp` does ~1.21 MFLOP per sample point (~1.27
TFLOP per 8192-ray level-chunk at the lego shape) and is compute bound; the
composite and the view projection move a few tens of bytes per point.  The
TPU kernel kept every weight resident in 96 MB of VMEM; an SM has 227 KB of
shared memory, so `lean_mlp` keeps one 64-point tile's activations resident
in shared memory through all layers, streams the weights from L2, and runs
the products on the tensor cores: bf16 directly, float32 as 3xTF32 (each
operand split into two TF32 halves; ~1e-6 from exact f32).  Widths must be
multiples of 8 (float32) or 16 (bfloat16), at most 256.

Each wrapper takes the plain PyTorch version for tensors on the CPU, and
only there.  For a CUDA tensor it launches its kernel or raises: there is
no fallback.  `launches[name]` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mipnerf_pl_tpu_torch.ops.math import integrated_pos_enc
from mipnerf_pl_tpu_torch.ops.render import composite

# Kernel name -> number of launches (incremented only where the kernel is
# launched; callers reset it to count one run).
launches = {'lean_view_proj': 0, 'lean_mlp': 0, 'lean_composite': 0}

# Source of the kernels, and the Pallas kernel they replace.
SOURCE = 'mipnerf_pl_tpu_torch/csrc/lean_render.cu'
REPLACES = 'mipnerf_pl_tpu/kernels/mlp.py:1428'

MAX_WIDTH = 256     # widest dense layer the CUDA column tiling covers


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def param_order(net_depth: int, net_depth_condition: int):
    names = [f'trunk_{i}' for i in range(net_depth)]
    names += ['density', 'bottleneck']
    names += [f'view_{i}' for i in range(net_depth_condition)]
    names += ['rgb']
    return names


def flatten_params(mlp: torch.nn.Module, net_depth: int,
                   net_depth_condition: int):
    """MLP module -> [k0, b0, k1, b1, ...] in param_order, kernels in the
    flax [in, out] layout and biases [1, out] (views, no copies)."""
    out = []
    for name in param_order(net_depth, net_depth_condition):
        lin = getattr(mlp, name)
        out.append(lin.weight.t())
        out.append(lin.bias.reshape(1, -1))
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the JAX kernel's semantics, written with torch ops.
# Activations are rounded to the compute dtype after every layer; products
# accumulate in f32 (bf16 values are upcast, so every product is exact).
# ---------------------------------------------------------------------------

def _rounded(t, dtype):
    return t.to(dtype).float()


def view_proj_plain(view, k0, b0, net_width: int, compute_dtype):
    return (_rounded(view, compute_dtype)
            @ _rounded(k0[net_width:], compute_dtype)
            + _rounded(b0, compute_dtype).reshape(1, -1))


def lean_mlp_plain(moments, vproj, flat_params, num_samples: int,
                   net_depth: int, net_depth_condition: int, skip_index: int,
                   compute_dtype, act, encode):
    dt = compute_dtype
    p = [_rounded(t, dt) for t in flat_params]
    means, covs = moments[:3].t(), moments[3:].t()
    x = _rounded(integrated_pos_enc((means, covs), *encode), dt)

    def dense(h, i):
        return h @ p[2 * i] + p[2 * i + 1]

    h = x
    for i in range(net_depth):
        h = _rounded(torch.relu(dense(h, i)), dt)
        if i % skip_index == 0 and i > 0:
            h = torch.cat([h, x], dim=-1)
    density = dense(h, net_depth)
    bottleneck = _rounded(dense(h, net_depth + 1), dt)
    iv = net_depth + 2
    W = bottleneck.shape[-1]
    y = bottleneck @ p[2 * iv][:W] + vproj.repeat_interleave(num_samples, 0)
    y = _rounded(torch.relu(y), dt)
    for j in range(1, net_depth_condition):
        y = _rounded(torch.relu(dense(y, iv + j)), dt)
    rgb = dense(y, iv + net_depth_condition)
    pad, bias = act
    rgb = torch.sigmoid(rgb) * (1.0 + 2.0 * pad) - pad
    z = density + bias
    sigma = torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))
    return torch.cat([rgb, sigma], dim=-1)


def lean_composite_plain(rgbsig, delta, mids, white_bkgd: bool):
    R, N = delta.shape
    rs = rgbsig.reshape(R, N, 4)
    comp, dist, acc, w = composite(rs[..., :3], rs[..., 3], delta, mids,
                                   white_bkgd)
    zeros = torch.zeros_like(comp)
    perray = torch.cat([comp, acc[:, None], dist[:, None], zeros], dim=-1)
    return perray, w


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the CUDA kernel for CUDA tensors.
# ---------------------------------------------------------------------------

def _on_cpu(t: torch.Tensor, fn: str) -> bool:
    if t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError(f'{fn}: tensors must be on the CPU or a CUDA device,'
                         f' got {t.device}')
    return False


def _dtype_flag(compute_dtype) -> int:
    if compute_dtype == torch.float32:
        return 0
    if compute_dtype == torch.bfloat16:
        return 1
    raise ValueError(f'compute dtype must be float32 or bfloat16, got '
                     f'{compute_dtype}')


def _check(t, shape, fn, name, device):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f'{fn}: {name} must be float32 {tuple(shape)}, got '
                         f'{t.dtype} {tuple(t.shape)}')
    if t.device != device:
        raise ValueError(f'{fn}: {name} is on {t.device}, expected {device}')


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/lean_render.cu (pointers and the stream as void*).
_ARGTYPES = {
    'lean_view_proj': [_P] * 4 + [_I] * 5 + [_P],
    'lean_mlp': [_P] * 4 + [_I, _P] + [_I] * 10 + [_F, _F, _I, _P],
    'lean_composite': [_P] * 5 + [_I] * 3 + [_P],
}


def _call(fn_name: str, device, *args):
    """Launch one kernel on the current stream of `device`; raise if the
    launch was refused (the C entry returns cudaGetLastError())."""
    from mipnerf_pl_tpu_torch.kernels import _build
    fn = getattr(_build.load('lean_render'), fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):       # launch on the tensors' card
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{fn_name}: CUDA error {err} at launch')


def view_proj(view, k0, b0, net_width: int, compute_dtype):
    """(view [R, Fv] f32, k0 [W + Fv, Wv], b0 [1, Wv]) -> [R, Wv] f32 =
    cast(view) @ cast(k0[W:]) + cast(b0): view_0's per-ray half."""
    if _on_cpu(view, 'view_proj'):
        return view_proj_plain(view, k0, b0, net_width, compute_dtype)
    flag = _dtype_flag(compute_dtype)
    R, Fv = view.shape
    Wv = k0.shape[1]
    if k0.shape[0] != net_width + Fv:
        raise ValueError(f'view_proj: view_0 kernel has {k0.shape[0]} rows, '
                         f'expected {net_width} + {Fv}')
    _check(view, (R, Fv), 'view_proj', 'view', view.device)
    view = view.contiguous()
    kw = k0.detach().to(compute_dtype).contiguous()
    bw = _rounded(b0.detach(), compute_dtype).reshape(-1).contiguous()
    out = torch.empty((R, Wv), dtype=torch.float32, device=view.device)
    _call('lean_view_proj', view.device, view.data_ptr(), kw.data_ptr(),
          bw.data_ptr(), out.data_ptr(), R, Fv, net_width, Wv, flag)
    launches['lean_view_proj'] += 1
    return out


def lean_mlp(moments, vproj, flat_params: Sequence[torch.Tensor],
             num_samples: int, net_depth: int, net_depth_condition: int,
             skip_index: int, compute_dtype, act, encode):
    """(moments [6, M] f32, vproj [M/N, Wv] f32, params) -> [M, 4] f32:
    activated rgb | sigma of every sample point, the IPE decoded from the
    moments in the kernel."""
    if _on_cpu(moments, 'lean_mlp'):
        return lean_mlp_plain(moments, vproj, flat_params, num_samples,
                              net_depth, net_depth_condition, skip_index,
                              compute_dtype, act, encode)
    flag = _dtype_flag(compute_dtype)
    min_deg, max_deg = encode
    L = max_deg - min_deg
    M = moments.shape[1]
    N = num_samples
    R = M // N
    W = flat_params[0].shape[1]
    Wv = flat_params[2 * (net_depth + 2)].shape[1]
    dev = moments.device
    _check(moments, (6, M), 'lean_mlp', 'moments', dev)
    _check(vproj, (R, Wv), 'lean_mlp', 'vproj', dev)
    if M != R * N or M == 0:
        raise ValueError(f'lean_mlp: {M} points is not a positive multiple '
                         f'of num_samples={N}')
    if flat_params[0].shape[0] != 6 * L:
        raise ValueError(f'lean_mlp: trunk_0 takes {flat_params[0].shape[0]}'
                         f' inputs, the encode has {6 * L}')
    align = 16 if flag else 8      # tensor-core tiles: k16/n16, k8/n8
    for w in (W, Wv):
        if w % align or w > MAX_WIDTH:
            raise ValueError(f'lean_mlp: layer width {w} must be a multiple '
                             f'of {align} and at most {MAX_WIDTH}')
    if flat_params[2 * (net_depth + 2) + 2 * net_depth_condition].shape[1] \
            != 3 or flat_params[2 * net_depth].shape[1] != 1:
        raise ValueError('lean_mlp: heads must be 3 rgb + 1 density')
    ws = [t.detach().to(compute_dtype).contiguous()
          for t in flat_params[0::2]]
    bs = [_rounded(t.detach(), compute_dtype).reshape(-1).contiguous()
          for t in flat_params[1::2]]
    for t in ws + bs:
        if t.device != dev:
            raise ValueError(f'lean_mlp: parameter on {t.device}, expected '
                             f'{dev}')
    n = len(ws)
    w_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in ws])
    b_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in bs])
    moments = moments.contiguous()
    vproj = vproj.contiguous()
    out = torch.empty((M, 4), dtype=torch.float32, device=dev)
    pad, bias = act
    _call('lean_mlp', dev, moments.data_ptr(), vproj.data_ptr(),
          ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs), n,
          out.data_ptr(), M, N, R, L, min_deg, net_depth,
          net_depth_condition, skip_index, W, Wv, pad, bias, flag)
    launches['lean_mlp'] += 1
    return out


def lean_composite(rgbsig, delta, mids, white_bkgd: bool):
    """(rgbsig [R*N, 4], delta [R, N], mids [R, N]) f32 ->
    (perray [R, 8] = comp rgb | acc | dist_raw | 0 0 0, weights [R, N])."""
    if _on_cpu(rgbsig, 'lean_composite'):
        return lean_composite_plain(rgbsig, delta, mids, white_bkgd)
    R, N = delta.shape
    dev = rgbsig.device
    _check(rgbsig, (R * N, 4), 'lean_composite', 'rgbsig', dev)
    _check(delta, (R, N), 'lean_composite', 'delta', dev)
    _check(mids, (R, N), 'lean_composite', 'mids', dev)
    rgbsig, delta, mids = (t.contiguous() for t in (rgbsig, delta, mids))
    perray = torch.empty((R, 8), dtype=torch.float32, device=dev)
    w = torch.empty((R, N), dtype=torch.float32, device=dev)
    _call('lean_composite', dev, rgbsig.data_ptr(), delta.data_ptr(),
          mids.data_ptr(), perray.data_ptr(), w.data_ptr(), R, N,
          int(bool(white_bkgd)))
    launches['lean_composite'] += 1
    return perray, w


def fused_mlp_lean_render(x, view, delta, mids, flat_params,
                          num_samples: int, net_depth: int,
                          net_depth_condition: int, skip_index: int,
                          compute_dtype=torch.float32, act=(0.001, -1.0),
                          white_bkgd: bool = True, encode=None):
    """Level forward: MLP + head activations + volumetric compositing.

    (x = moments [6, M] f32, view [M/N, Fv], delta [M/N, N] =
    (t1 - t0) * ||dir||, mids [M/N, N] = (t0 + t1) / 2, params) ->
    (comp_rgb [M/N, 3], dist_raw [M/N, 1], acc [M/N, 1], weights [M/N, N]),
    as the JAX function returns them: dist_raw is UNCLAMPED (the caller
    applies the nan-safe clamp).  `encode` = (min_deg, max_deg) of the IPE
    decoded in the kernel; `act` = (rgb_padding, density_bias)."""
    if net_depth_condition < 1:
        raise ValueError('fused_mlp_lean_render requires '
                         'net_depth_condition >= 1')
    if act is None or encode is None:
        raise ValueError('fused_mlp_lean_render requires act=(rgb_padding, '
                         'density_bias) and encode=(min_deg, max_deg)')
    W = flat_params[0].shape[1]
    iv = 2 * (net_depth + 2)
    vproj = view_proj(view.float(), flat_params[iv], flat_params[iv + 1], W,
                      compute_dtype)
    rgbsig = lean_mlp(x, vproj, flat_params, num_samples, net_depth,
                      net_depth_condition, skip_index, compute_dtype, act,
                      encode)
    perray, w = lean_composite(rgbsig, delta.float(), mids.float(),
                               white_bkgd)
    return perray[:, 0:3], perray[:, 4:5], perray[:, 3:4], w
