"""The standalone integrated positional encoding and its VJP (CUDA, sm_90a).

Counterpart of mipnerf_pl_tpu/kernels/ipe.py `fused_ipe`, which
`nerf.ipe_backend: pallas` selects on every MLP backend.  Replaces the TPU
kernels `_fwd_kernel` (the `pl.pallas_call` of `_run_fwd`) and `_bwd_kernel`
(`_run_bwd`) by two hand-written kernels in csrc/ipe.cu, one wrapper each:

  ipe_fwd  means, diagonal covs [M, 3] f32 -> [M, 6L] f32: with s =
           2^(min_deg + l), column l*3 + d = exp(-0.5 cov_d s^2) sin(mean_d
           s) and column 3L + l*3 + d the same with cos(mean_d s)
  ipe_bwd  means, covs [M, 3], g [M, 6L] -> dmeans, dcovs [M, 3]: the sums
           over the ladder of s damp (g_sin cos - g_cos sin) and of
           -0.5 s^2 damp (g_sin sin + g_cos cos)

and the autograd Function `fused_ipe` over them.

The cosine half is cos(mean s) itself, as in the TPU kernel.  The default
encode (`ops.math.integrated_pos_enc`, and the lean kernels' in-tile decode
behind `ipe_moments`) takes it as sin(mean s + pi/2); in f32 that sum rounds
once mean s is large, so the two encodes differ wherever the damping leaves
the high degrees alive (7.3e-3 at degrees 0..16 with means ~ 2 N(0, 1) and
zero covariances, as `nerf.disable_integration` makes them).  The plain
versions here follow the kernel's formula.

What bounds them: 24 bytes in and 24L out a point forward, 24 + 24L in and
24 out backward.  Neither kernel calls CUDA's sincosf, whose exact
reduction turns slow past |mean 2^deg| ~ 1e5: each (point, dim) reduces
mean 2/pi once in double-double arithmetic and takes every degree's sin and
cos from it in FP64 (csrc/ipe_core.cuh), within ~0.5 ulp of the exact
values.

Each wrapper takes its plain version for tensors on the CPU, and only
there; on a CUDA tensor it launches its kernel or raises.  The launches are
counted in kernels.mlp's `launches`.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from mipnerf_pl_tpu_torch.kernels.mlp import (_call, _check, _check_ladder,
                                             _on_cpu, launches)


def _ladder(min_deg: int, max_deg: int, like: torch.Tensor):
    """[3L] scales 2^l, each repeated over the 3 dims (column l*3 + d)."""
    return torch.tensor([2.0 ** deg for deg in range(min_deg, max_deg)],
                        dtype=like.dtype, device=like.device
                        ).repeat_interleave(3)


def _arg_damp(means2d, covs2d, min_deg: int, max_deg: int):
    """(s, mean s, exp(-0.5 cov s^2)), each [M, 3L] (s is [3L])."""
    s = _ladder(min_deg, max_deg, means2d)
    reps = max_deg - min_deg
    return (s, means2d.repeat(1, reps) * s,
            torch.exp(-0.5 * covs2d.repeat(1, reps) * (s * s)))


def ipe_fwd_plain(means2d, covs2d, min_deg: int, max_deg: int):
    """ipe_fwd in plain PyTorch: the cosine half is cos(mean s)."""
    _, arg, damp = _arg_damp(means2d, covs2d, min_deg, max_deg)
    return torch.cat([damp * torch.sin(arg), damp * torch.cos(arg)], dim=-1)


def ipe_bwd_plain(means2d, covs2d, g2d, min_deg: int, max_deg: int):
    """ipe_bwd in plain PyTorch, the VJP written out (no autograd)."""
    s, arg, damp = _arg_damp(means2d, covs2d, min_deg, max_deg)
    L3 = s.shape[0]
    g_sin, g_cos = g2d[:, :L3], g2d[:, L3:]
    sin_a, cos_a = torch.sin(arg), torch.cos(arg)
    dm_wide = (g_sin * damp * cos_a - g_cos * damp * sin_a) * s
    dc_wide = -0.5 * (s * s) * (g_sin * damp * sin_a + g_cos * damp * cos_a)
    fold = lambda wide: wide.reshape(-1, L3 // 3, 3).sum(dim=1)  # noqa: E731
    return fold(dm_wide), fold(dc_wide)


def _check_points(fn, means2d, covs2d, min_deg, max_deg):
    L = max_deg - min_deg
    M = means2d.shape[0]
    dev = means2d.device
    _check(means2d, (M, 3), fn, 'means', dev)
    _check(covs2d, (M, 3), fn, 'covs', dev)
    if L < 1 or M == 0:
        raise ValueError(f'{fn}: needs max_deg > min_deg and points, got '
                         f'degrees ({min_deg}, {max_deg}), {M} points')
    _check_ladder(fn, min_deg, max_deg)
    return M, L, dev


def ipe_fwd(means2d, covs2d, min_deg: int, max_deg: int):
    """(means [M, 3], diagonal covs [M, 3]) f32 -> [M, 6L] f32 encode rows,
    L = max_deg - min_deg: the sin block then the cos block."""
    if _on_cpu(means2d, 'ipe_fwd'):
        return ipe_fwd_plain(means2d, covs2d, min_deg, max_deg)
    M, L, dev = _check_points('ipe_fwd', means2d, covs2d, min_deg, max_deg)
    means2d, covs2d = means2d.contiguous(), covs2d.contiguous()
    out = torch.empty((M, 6 * L), dtype=torch.float32, device=dev)
    _call('ipe_fwd', dev, means2d.data_ptr(), covs2d.data_ptr(),
          out.data_ptr(), M, L, min_deg)
    launches['ipe_fwd'] += 1
    return out


def ipe_bwd(means2d, covs2d, g2d, min_deg: int, max_deg: int):
    """(means, covs [M, 3], cotangent g [M, 6L]) f32 -> (dmeans, dcovs)
    [M, 3] f32: the VJP of ipe_fwd.  The sums run in ladder order, so two
    calls agree bit for bit."""
    if _on_cpu(means2d, 'ipe_bwd'):
        return ipe_bwd_plain(means2d, covs2d, g2d, min_deg, max_deg)
    M, L, dev = _check_points('ipe_bwd', means2d, covs2d, min_deg, max_deg)
    _check(g2d, (M, 6 * L), 'ipe_bwd', 'g', dev)
    means2d, covs2d, g2d = (t.contiguous() for t in (means2d, covs2d, g2d))
    dmeans = torch.empty((M, 3), dtype=torch.float32, device=dev)
    dcovs = torch.empty((M, 3), dtype=torch.float32, device=dev)
    _call('ipe_bwd', dev, means2d.data_ptr(), covs2d.data_ptr(),
          g2d.data_ptr(), dmeans.data_ptr(), dcovs.data_ptr(), M, L, min_deg)
    launches['ipe_bwd'] += 1
    return dmeans, dcovs


class _FusedIpe(torch.autograd.Function):
    """ipe_fwd with ipe_bwd as its backward, over any leading shape."""

    @staticmethod
    def forward(ctx, means, covs_diag, min_deg, max_deg):
        ctx.save_for_backward(means, covs_diag)
        ctx.degrees = (min_deg, max_deg)
        out = ipe_fwd(means.reshape(-1, 3), covs_diag.reshape(-1, 3),
                      min_deg, max_deg)
        return out.reshape(*means.shape[:-1], -1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        means, covs_diag = ctx.saved_tensors
        need_m, need_c = ctx.needs_input_grad[:2]
        dm, dc = ipe_bwd(means.reshape(-1, 3), covs_diag.reshape(-1, 3),
                         g.reshape(-1, g.shape[-1]), *ctx.degrees)
        return (dm.reshape(means.shape) if need_m else None,
                dc.reshape(covs_diag.shape) if need_c else None, None, None)


def fused_ipe(means, covs_diag, min_deg: int = 0, max_deg: int = 16):
    """Fused IPE: diagonal Gaussians [..., 3] f32 -> [..., 6L] f32
    encodings, scale-major sin block then cos block (the layout of
    `ops.math.integrated_pos_enc`; the cosine half computed as the cosine,
    see the module docstring).  The backward launches ipe_bwd when an input
    needs a gradient and returns None for one that does not."""
    for name, t in (('means', means), ('covs_diag', covs_diag)):
        if t.dtype != torch.float32:
            raise ValueError(f'fused_ipe: {name} must be float32, got '
                             f'{t.dtype}')
    if means.shape != covs_diag.shape or means.shape[-1] != 3:
        raise ValueError(f'fused_ipe: means and covs_diag must both be '
                         f'[..., 3], got {tuple(means.shape)} and '
                         f'{tuple(covs_diag.shape)}')
    return _FusedIpe.apply(means, covs_diag, min_deg, max_deg)
