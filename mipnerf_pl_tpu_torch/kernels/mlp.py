"""The lean MLP kernels (CUDA, sm_90a) and their plain twins.

Render path.  Replaces mipnerf_pl_tpu/kernels/mlp.py:fused_mlp_lean_render
(the TPU kernel `_fwd_kernel_lean_render` behind the `pl.pallas_call` of
`_run_fwd_lean_render`, and for training its backward
`_bwd_kernel_lean_render` behind `_run_bwd_lean_render`).  That Pallas
kernel decodes the IPE from the [6, M] moments (or reads encode rows), runs
the lean MLP, applies the head activations and composites every ray.  On
the card, rendering (no gradients) is three hand-written kernels in
csrc/lean_render.cu, one wrapper each here:

  view_proj       view_0's per-ray half, once per ray       -> [R, Wv] f32
  lean_mlp        IPE decode + MLP + activations per tile   -> [M, 4]  f32
  lean_composite  per-ray scan and reductions               -> [R, 8], [R, N]

Training through the level is the autograd Function `_LeanRender`: the
training forward below (rows or moments) then lean_composite; backward

  lean_composite_bwd  per-ray cotangents -> the activated heads' [M, 3],
                      [M, 1] (the new part of `_bwd_kernel_lean_render`)

then the mode's parameter-gradient backward with the activation fold.

Encode.  ipe_moments replaces `_moments_kernel` (kernels/ipe.py, behind
fused_ipe_moments): [6, M] moments -> [M, 6L] encode rows (csrc/ipe.cu),
the same decode every kernel here runs in its encode tile.

Training path.  Replaces fused_mlp_lean in its three modes, one autograd
Function `fused_mlp_lean` over csrc/lean_train.cu:

  lean_fwd          MLP + heads from f32 encode rows, or from the [6, M]
                    moments with the IPE decoded per tile (`encode=`) ->
                    [M, 4]: mode 'recompute' (`_fwd_kernel_lean`)
  lean_save_fwd     the same kernel, which also writes the saved stream
                    and raw heads: mode 'save' (`_fwd_kernel_lean_save`)
  lean_param_grads  f32 gradients of every parameter from the saved stream,
                    none for x and view (`_bwd_kernel_lean_save` through
                    `_lean_param_grads`)
  lean_param_grads_recompute
                    the same gradients, the forward re-run chunk by chunk
                    in its input form (`_bwd_kernel_lean`)
  lean_param_grads_hybrid
                    the same gradients, on the same kernels, from the
                    stream the plain-torch forward `lean_hybrid_fwd` of mode
                    'hybrid' writes (`_bwd_kernel_lean_hybrid`): its
                    products, transposed, land in the rows of S

The forwards run view_proj for view_0's per-ray half; heads are activated
with act = (rgb_padding, density_bias), or raw for act=None.  These need
net_depth_condition >= 1, as their TPU kernels do.

Input gradients.  Replaces fused_mlp in its two modes (the `pallas` /
`pallas_save` backends, the fused path with stop_resample_grad False), one
autograd Function `fused_mlp` over the same source, whose kernels are the
lean tile and driver instantiated for the classic MLP: the view features
per point (view_0 reads concat(bottleneck, view)), nd raw density heads,
and a backward that also returns dx and dview:

  mlp_fwd           forward -> raw rgb [M, 3], density [M, nd]: mode
                    'recompute' (`_fwd_kernel`)
  mlp_save_fwd      the same kernel, which also writes the stream X | hs |
                    bottleneck | ys | V: mode 'save' (`_fwd_kernel_save`)
  mlp_bwd_saved     dx, dview and every parameter's gradient from the
                    stream (`_bwd_kernel_saved`)
  mlp_bwd_recompute the same, the forward re-run chunk by chunk
                    (`_bwd_kernel`)

With net_depth_condition 0 (no view layer) the rgb head reads
concat(bottleneck, view): the four kernels are instantiated for it, and its
cotangent splits into the bottleneck's and dview.  With a view layer, one
density head and widths that are multiples of 64 (the rules with the
classic arguments) the forwards run on the wgmma forward's classic form
(view_0's per-point view rows a second K segment) and the backwards' chain
with dx and dview on the wgmma chain's (the input cotangents steps of the
chain): in f32 the 3xTF32 kernels (`fwd_tf32_route` / `chain_tf32_route`,
counted in `tf32_routes` / `chain_tf32_routes`), in bf16 the bf16 ones
(`fwd_sm90_route` / `chain_sm90_route`, counted in `routes` /
`chain_routes`).  The same rules also take the model with no view layer,
on the NV forms of the two kernels of each dtype (the rgb head and dview on
the CUDA cores).  The shapes they refuse (more than one density head,
other widths) run on the mma.sync kernels, counted in `mma_fwd_routes`,
`mma_chain_routes` and `mma_input_routes`.

What bounds them: the MLP is ~1.21 MFLOP per sample point forward and about
twice that backward (with the input gradients, exactly twice), so the
kernels are compute bound; the composite and
the view projection move a few tens of bytes per point.  The TPU kernels
kept every weight resident in 96 MB of VMEM; an SM has 227 KB of shared
memory, so a 64-point tile's activations stay resident in shared memory
through all layers, the weights stream from L2, and the products run on the
tensor cores: bf16 directly, float32 as 3xTF32 (each operand split into two
TF32 halves; ~1e-6 from exact f32).  Widths must be multiples of 8
(float32) or 16 (bfloat16), at most 256.  The bf16 lean forwards at widths
that are multiples of 64 (`fwd_sm90_route`) run on Hopper's wgmma fed by
TMA instead, 128-point tiles whose weight slabs feed both halves
(csrc/lean_fwd_sm90.cuh); `routes[name]` counts the calls that took it.
The f32 lean forwards at those widths (`fwd_tf32_route`) run on the
3xTF32 wgmma forward (csrc/lean_fwd_tf32.cuh), from the transposed kernels
split once a call into tf32 hi and lo (`tf32_fwd_weights`);
`tf32_routes[name]` counts the calls that took it.  The weight gradients
of every backward run on wgmma: f32 on a 3xTF32 kernel
(csrc/lean_wgrad_tf32.cuh, `wgrad_tf32_route`), bf16 on
csrc/lean_wgrad_sm90.cuh; `wgrad_tf32_routes[name]` and
`wgrad_sm90_routes[name]` count the calls that took each.

Each wrapper takes the plain PyTorch version for tensors on the CPU, and
only there.  For a CUDA tensor it launches its kernel or raises: there is
no fallback.  `launches[name]` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from mipnerf_pl_tpu_torch.ops.math import integrated_pos_enc
from mipnerf_pl_tpu_torch.ops.render import composite
from mipnerf_pl_tpu_torch.utils.trace import span

# Kernel name -> number of launches (incremented only where the kernel is
# launched; callers reset it to count one run).
launches = {'lean_view_proj': 0, 'lean_mlp': 0, 'lean_composite': 0,
            'lean_save_fwd': 0, 'lean_param_grads': 0, 'lean_fwd': 0,
            'lean_param_grads_recompute': 0, 'lean_param_grads_hybrid': 0,
            'lean_composite_bwd': 0, 'ipe_moments': 0, 'mlp_fwd': 0,
            'mlp_bwd_recompute': 0, 'mlp_save_fwd': 0, 'mlp_bwd_saved': 0,
            'ipe_fwd': 0, 'ipe_bwd': 0, 'tp_pair_fwd': 0, 'tp_pair_bwd': 0}

# Kernel name -> (source, the Pallas kernel it replaces).
_RENDER_CU = 'mipnerf_pl_tpu_torch/csrc/lean_render.cu'
_TRAIN_CU = 'mipnerf_pl_tpu_torch/csrc/lean_train.cu'
_IPE_CU = 'mipnerf_pl_tpu_torch/csrc/ipe.cu'
_TP_CU = 'mipnerf_pl_tpu_torch/csrc/tp_pair.cu'
KERNELS = {
    'lean_view_proj': (_RENDER_CU, 'mipnerf_pl_tpu/kernels/mlp.py:1428'),
    'lean_mlp': (_RENDER_CU, 'mipnerf_pl_tpu/kernels/mlp.py:1428'),
    'lean_composite': (_RENDER_CU, 'mipnerf_pl_tpu/kernels/mlp.py:1428'),
    'lean_save_fwd': (_TRAIN_CU, 'mipnerf_pl_tpu/kernels/mlp.py:1002'),
    'lean_param_grads': (_TRAIN_CU, 'mipnerf_pl_tpu/kernels/mlp.py:1021'),
    'lean_fwd': (_TRAIN_CU, 'mipnerf_pl_tpu/kernels/mlp.py:845'),
    'lean_param_grads_recompute': (_TRAIN_CU,
                                   'mipnerf_pl_tpu/kernels/mlp.py:988'),
    'lean_param_grads_hybrid': (_TRAIN_CU,
                                'mipnerf_pl_tpu/kernels/mlp.py:1101'),
    'lean_composite_bwd': (_RENDER_CU, 'mipnerf_pl_tpu/kernels/mlp.py:1445'),
    'ipe_moments': (_IPE_CU, 'mipnerf_pl_tpu/kernels/ipe.py:170'),
    'mlp_fwd': (_TRAIN_CU, 'mipnerf_pl_tpu/kernels/mlp.py:134'),
    'mlp_bwd_recompute': (_TRAIN_CU, 'mipnerf_pl_tpu/kernels/mlp.py:291'),
    'mlp_save_fwd': (_TRAIN_CU, 'mipnerf_pl_tpu/kernels/mlp.py:183'),
    'mlp_bwd_saved': (_TRAIN_CU, 'mipnerf_pl_tpu/kernels/mlp.py:206'),
    # The standalone IPE and its VJP: wrappers in kernels/ipe.py.
    'ipe_fwd': (_IPE_CU, 'mipnerf_pl_tpu/kernels/ipe.py:40'),
    'ipe_bwd': (_IPE_CU, 'mipnerf_pl_tpu/kernels/ipe.py:55'),
    # The Megatron pair and its backward: wrappers in kernels/tp_lean.py.
    'tp_pair_fwd': (_TP_CU, 'mipnerf_pl_tpu/kernels/tp_lean.py:69'),
    'tp_pair_bwd': (_TP_CU, 'mipnerf_pl_tpu/kernels/tp_lean.py:104'),
}

MAX_WIDTH = 256     # widest dense layer the CUDA column tiling covers
MAX_DENSITY = 5     # density heads of the classic kernels (3 + 5 head rows)
TILE = 64           # points per CUDA tile; saved streams pad M to it
WGRAD_TILE = 128    # output tile of the weight-gradient products
# Points a recompute backward re-runs at a time: a quarter of a lego level.
# On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), 1/8, 1/4 and 1/2 of a
# level take 14.2, 12.95 and 12.27 ms (bf16) for 0.53, 0.97 and 1.85 GiB of
# scratch: a larger chunk fills more of the card in the weight gradients.
RECOMPUTE_POINTS = 98304


# Wrapper name -> calls whose forward ran on the bf16 wgmma / TMA kernel
# lean_fwd_sm90_kernel (csrc/lean_fwd_sm90.cuh), read from the library's
# own count of that kernel's launches around each call: the lean forwards
# and the classic ones (mlp_bwd_recompute: its re-run).
routes = {'lean_mlp': 0, 'lean_fwd': 0, 'lean_save_fwd': 0,
          'lean_param_grads_recompute': 0, 'mlp_fwd': 0, 'mlp_save_fwd': 0,
          'mlp_bwd_recompute': 0}

# The shape rule of lean_fwd_sm90_kernel (csrc/lean_fwd_sm90.cuh,
# fwd_sm90_route): its ring of FW_STAGES slabs of FW_KS weight rows x 4 boxes
# of 64 columns, two warpgroups' activation tiles of 64-row boxes and
# encode tiles (F rounded up to FW_KS rows, at most FW_XBOXES boxes), their
# heads and the heads' half sums, the staged f32 biases (256 a layer) and
# head kernels, the slab
# schedule (12 slabs a layer, 4 bytes each), its mbarriers, 1 KB of
# alignment.
FW_STAGES, FW_KS, FW_XBOXES, FW_MAX_LAYERS = 6, 32, 2, 12
FW_SMEM_MAX = 232448


# Wrapper name -> calls whose forward ran on the f32 wgmma / TMA kernel
# lean_fwd_tf32_kernel (csrc/lean_fwd_tf32.cuh), read from the library's
# own count of that kernel's launches around each call: the lean forwards
# and the classic ones (mlp_bwd_recompute: its re-run).
tf32_routes = dict.fromkeys(routes, 0)

# The shape rule of lean_fwd_tf32_kernel (csrc/lean_fwd_tf32.cuh,
# fwd_tf32_route): a ring of FT_STAGES slabs of FT_KS columns of the split
# kernels (256 rows of hi and of lo, 4-byte words), its mbarriers (64
# bytes), the f32 activation and encode tiles of one 64-point tile (row
# stride FT_LD floats; the encode F rounded up to FT_KS, at most FT_MAX_X
# rows), the heads and their quarter sums, the staged biases (256 a layer)
# and head kernels, the slab schedule (4 bytes a slab), 1 KB of alignment.
FT_STAGES, FT_KS, FT_LD, FT_MAX_LAYERS, FT_MAX_X = 3, 16, 72, 12, 128


# Wrapper name -> calls whose cotangent chain (the classic ones: with dx and
# dview) ran on the bf16 wgmma kernel lean_chain_sm90_kernel
# (csrc/lean_chain_sm90.cuh) / on the f32 one lean_chain_tf32_kernel
# (csrc/lean_chain_tf32.cuh), read from the library's own counts of their
# launches around each call.
chain_routes = {'lean_param_grads': 0, 'lean_param_grads_recompute': 0,
                'lean_param_grads_hybrid': 0, 'mlp_bwd_saved': 0,
                'mlp_bwd_recompute': 0}
chain_tf32_routes = dict.fromkeys(chain_routes, 0)

# Wrapper name -> calls of fused_mlp's wrappers that ran the classic MLP's
# mma.sync kernels (the shapes the wgmma rules refuse: nd > 1, other
# widths), read from the library's own counts of their launches around each
# call: the forward on mlp_fwd_kernel (mlp_bwd_recompute: its re-run), the
# chain on lean_grad_chain_kernel, dx and dview on mlp_input_grads_kernel.
mma_fwd_routes = {'mlp_fwd': 0, 'mlp_save_fwd': 0, 'mlp_bwd_recompute': 0}
mma_chain_routes = {'mlp_bwd_saved': 0, 'mlp_bwd_recompute': 0}
mma_input_routes = dict.fromkeys(mma_chain_routes, 0)


# Wrapper name -> calls whose weight gradients ran on the f32 wgmma kernel
# wgrad_tf32_kernel (csrc/lean_wgrad_tf32.cuh) / on the bf16 one
# wgrad_sm90_kernel (csrc/lean_wgrad_sm90.cuh), read from the library's own
# counts of their launches around each call (tp_pair_bwd:
# kernels/tp_lean.py).
wgrad_tf32_routes = {'lean_param_grads': 0, 'lean_param_grads_recompute': 0,
                     'lean_param_grads_hybrid': 0, 'mlp_bwd_saved': 0,
                     'mlp_bwd_recompute': 0, 'tp_pair_bwd': 0}
wgrad_sm90_routes = dict.fromkeys(wgrad_tf32_routes, 0)

# Wrapper name -> calls of the Megatron pair wrappers (kernels/tp_lean.py)
# whose kernel (tp_pair_bwd: its chain) ran on the bf16 wgmma / TMA kernel
# tp_pair_wg_kernel (csrc/tp_pair_sm90.cuh), on its f32 3xTF32 form, or on
# the mma.sync kernels (tp_pair_fwd_kernel / tp_pair_bwd_kernel), read
# from the library's own counts of their launches around each call.
pair_sm90_routes = {'tp_pair_fwd': 0, 'tp_pair_bwd': 0}
pair_tf32_routes = dict.fromkeys(pair_sm90_routes, 0)
pair_mma_routes = dict.fromkeys(pair_sm90_routes, 0)

# The shape rule of wgrad_tf32_kernel (csrc/lean_wgrad_tf32.cuh,
# wgrad_tf32_takes): slabs of WT_KP points.
WT_KP = 32


def wgrad_tf32_route(compute_dtype, Mp: int, MC: int) -> bool:
    """Whether the weight gradients of a backward run on wgrad_tf32_kernel:
    f32, and the padded points Mp and the points of a range MC multiples of
    the WT_KP-point slab.  Every backward reads a channel-major stream."""
    return (compute_dtype == torch.float32 and Mp > 0 and MC > 0
            and Mp % WT_KP == 0 and MC % WT_KP == 0)


def _array_count(lib, entry, i):
    """A function reading entry i of a library's launch counts `entry`:
    lean_chain_launches (0 lean_chain_sm90_kernel, 1
    lean_chain_tf32_kernel), classic_mma_launches (0 mlp_fwd_kernel, 1
    lean_grad_chain_kernel's classic form, 2 mlp_input_grads_kernel),
    tp_pair_launches (0 tp_pair_wg_kernel bf16, 1 its f32 form, 2 the
    mma.sync pair kernels)."""
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def count():
        out = (ctypes.c_longlong * 3)()
        fn(out)
        return out[i]
    return count


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for counts in (routes, tf32_routes, chain_routes, chain_tf32_routes,
                   wgrad_tf32_routes, wgrad_sm90_routes, mma_fwd_routes,
                   mma_chain_routes, mma_input_routes, pair_sm90_routes,
                   pair_tf32_routes, pair_mma_routes):
        for k in counts:
            counts[k] = 0


# The shape rule of the lean chains on wgmma (csrc/lean_chain_sm90.cuh
# chain_sm90_route, csrc/lean_chain_tf32.cuh chain_tf32_route): a lean MLP
# (save, recompute, hybrid), W and Wv multiples of 64 up to MAX_WIDTH, a
# view layer, depth + depth_cond + 1 <= CH_MAX_STEPS, and
# the plan within the block's shared memory.  The bf16 chain: a ring of
# CH_STAGES slabs of 32 rows x 4 boxes of 64 bf16 columns, two warpgroups'
# 4-box cotangent tiles, CH_MASKS mask slots of MAX_WIDTH x 16 bytes,
# CH_RAW activation boxes, the warps' column partials and the head
# cotangents, each warpgroup's Cg bias sums, its mbarriers, 1 KB.  The f32
# chain: lean_fwd_tf32_kernel's ring and mbarriers, one f32 cotangent tile
# (max(W, Wv) rows of FT_LD floats), the head cotangents, the staged head
# kernels, the block's Cg bias sums, 1 KB.
CH_STAGES, CH_MASKS, CH_RAW, CH_MAX_STEPS = 4, 4, 6, 16
# The classic bf16 chain's plan: its steps (csrc/lean_chain_sm90.cuh
# CH_STEPS); its weight maps within CH_MAX_STEPS.
CH_STEPS = 20


def chain_cg(W: int, Wv: int, net_depth: int, net_depth_condition: int):
    """Rows of G (every layer's out columns, one density head)."""
    return net_depth * W + 1 + W + net_depth_condition * Wv + 3


def chain_sm90_smem(Cg: int) -> int:
    """Dynamic shared memory of lean_chain_sm90_kernel for a G of Cg rows."""
    box, wbox = 64 * 64 * 2, 32 * 64 * 2
    fixed = (CH_STAGES * 4 * wbox + 2 * 4 * box + CH_MASKS * MAX_WIDTH * 16
             + CH_RAW * box + 4 * (2 * 4 * MAX_WIDTH + 2 * 4 * 128))
    return (fixed + 2 * 4 * _round_up(Cg, 2)
            + 8 * 2 * (CH_STAGES + CH_MASKS + CH_RAW) + 1024)


def chain_tf32_smem(W: int, Wv: int, Cg: int, ix_n: int = 0) -> int:
    """Dynamic shared memory of lean_chain_tf32_kernel; the classic form
    (ix_n: the N of its dx steps) also stages the density kernel's x rows
    (FT_MAX_X floats) and stashes dx's products of a 64-point tile."""
    return (FT_STAGES * 2 * 256 * FT_KS * 4 + 64 + 4 * FT_LD * max(W, Wv)
            + 4 * (4 * 64 + 256 + 3 * 256 + _round_up(Cg, 4))
            + (4 * (FT_MAX_X + 64 * ix_n) if ix_n else 0) + 1024)


# The classic chain's plan: its weight maps and steps (csrc/lean_chain_tf32.cuh
# CT_MAX_MAPS, CT_STEPS).
CT_MAX_MAPS, CT_STEPS = 16, 20


def _classic_dx_steps(net_depth: int, skip_index: int) -> int:
    """Layers of the classic MLP whose input holds x: trunk_0, each trunk
    layer after a skip concat, the bottleneck after a last one."""
    return (sum(L == 0 or _skip_after(L - 1, skip_index)
                for L in range(net_depth))
            + _skip_after(net_depth - 1, skip_index))


def _view_width(Wv: int, net_depth_condition: int) -> int:
    """The view layers' width as the kernels' dims and rules read it: 0
    with no view layer (net_depth_condition 0), whatever width was given;
    the rules' NV forms are the classic MLP with Wv 0."""
    return Wv if net_depth_condition else 0


def _wgmma_width(w: int) -> bool:
    return 64 <= w <= MAX_WIDTH and w % 64 == 0


def _chain_route(W, Wv, net_depth, net_depth_condition, smem):
    return (_wgmma_width(W) and _wgmma_width(Wv)
            and net_depth >= 1 and net_depth_condition >= 1
            and net_depth + net_depth_condition + 1 <= CH_MAX_STEPS
            and smem <= FW_SMEM_MAX)


def chain_sm90_route(compute_dtype, W: int, Wv: int, net_depth: int,
                     net_depth_condition: int, *, F: int = 0, Fv: int = 0,
                     nd: int = 1, skip_index: int = 4) -> bool:
    """Whether the lean chain of lean_param_grads / _recompute / _hybrid
    (and the render-fused level's backward) runs on lean_chain_sm90_kernel:
    bf16 and the shape rule above.  With Fv > 0, whether the classic
    backward of fused_mlp (mlp_bwd_saved, mlp_bwd_recompute; F encode and
    Fv view features, nd density heads) runs its chain, dx and dview there:
    bf16, W and Wv multiples of 64 up to MAX_WIDTH, a view layer, one
    density head, the encode and the view at most MAX_WIDTH once rounded up
    to 64 (the N of their steps), its weight maps (every chain layer and
    input step) within CH_MAX_STEPS and its steps within CH_STEPS, and the
    plan within the block's shared memory (the lean chain's).  With no view
    layer (net_depth_condition 0, the NV form) Wv is unused and dview is no
    step of its own: the rgb step writes it on the CUDA cores."""
    if compute_dtype != torch.bfloat16:
        return False
    Wv = _view_width(Wv, net_depth_condition)
    Cg = chain_cg(W, Wv, net_depth, net_depth_condition)
    if not Fv:
        return _chain_route(W, Wv, net_depth, net_depth_condition,
                            chain_sm90_smem(Cg))
    ix = _classic_dx_steps(net_depth, skip_index) + (1 if Wv else 0)
    return (_wgmma_width(W)
            and (_wgmma_width(Wv) or not net_depth_condition)
            and net_depth >= 1 and nd == 1
            and skip_index >= 1 and 1 <= F and _round_up(F, 64) <= MAX_WIDTH
            and _round_up(Fv, 64) <= MAX_WIDTH
            and net_depth + net_depth_condition + ix <= CH_MAX_STEPS
            and net_depth + net_depth_condition + 1 + ix <= CH_STEPS
            and chain_sm90_smem(Cg) <= FW_SMEM_MAX)


def chain_tf32_route(compute_dtype, W: int, Wv: int, net_depth: int,
                     net_depth_condition: int, *, F: int = 0, Fv: int = 0,
                     nd: int = 1, skip_index: int = 4) -> bool:
    """Whether that chain runs on lean_chain_tf32_kernel: f32 and the shape
    rule above.  With Fv > 0, whether the classic backward of fused_mlp
    (mlp_bwd_saved, mlp_bwd_recompute; F encode and Fv view features, nd
    density heads) runs its chain, dx and dview there: f32, W and Wv
    multiples of 64 up to MAX_WIDTH, a view layer, one density head, the
    encode and the view at most FT_MAX_X once rounded up to 32 (the N of
    their steps), its weight maps (every chain layer and input step)
    within CT_MAX_MAPS and its steps within CT_STEPS, and the plan within
    the block's shared memory.  With no view layer (net_depth_condition 0,
    the NV form) Wv is unused and dview is no step of its own: the rgb step
    writes it on the CUDA cores."""
    if compute_dtype != torch.float32:
        return False
    Wv = _view_width(Wv, net_depth_condition)
    Cg = chain_cg(W, Wv, net_depth, net_depth_condition)
    if not Fv:
        return _chain_route(W, Wv, net_depth, net_depth_condition,
                            chain_tf32_smem(W, Wv, Cg))
    ix = _classic_dx_steps(net_depth, skip_index) + (1 if Wv else 0)
    ix_n = _round_up(_round_up(F, 16), 32)
    return (_wgmma_width(W)
            and (_wgmma_width(Wv) or not net_depth_condition)
            and net_depth >= 1 and nd == 1
            and skip_index >= 1 and 1 <= F and ix_n <= FT_MAX_X
            and _round_up(_round_up(Fv, 16), 32) <= FT_MAX_X
            and net_depth + net_depth_condition + ix <= CT_MAX_MAPS
            and net_depth + net_depth_condition + 1 + ix <= CT_STEPS
            and chain_tf32_smem(W, Wv, Cg, ix_n) <= FW_SMEM_MAX)


def fwd_tf32_smem(W: int, Wv: int, F: int, Fv: int = 0) -> int:
    """Dynamic shared memory of lean_fwd_tf32_kernel at widths W, Wv and an
    encode of F features (the classic form: the input tile also holds the
    Fv per-point view features)."""
    staged = (4 * 64 + 4 * 3 * 64 + FT_MAX_LAYERS * 256
              + (256 + FT_MAX_X) + 768)
    slabs = FT_MAX_LAYERS * (256 + FT_MAX_X) // FT_KS
    xrows = max(_round_up(F, FT_KS), _round_up(Fv, FT_KS))
    return (FT_STAGES * 2 * 256 * FT_KS * 4 + 64
            + 4 * FT_LD * (max(W, Wv) + xrows)
            + 4 * staged + 4 * slabs + 1024)


def fwd_tf32_route(compute_dtype, F: int, W: int, Wv: int, net_depth: int,
                   net_depth_condition: int, Fv: int = 0,
                   nd: int = 1) -> bool:
    """Whether a lean forward (lean_fwd, lean_save_fwd, the recompute
    backward's re-run, lean_mlp) runs on lean_fwd_tf32_kernel: f32, W and
    Wv multiples of 64 up to MAX_WIDTH, a view layer, at most FT_MAX_LAYERS
    dense layers, an encode of at most FT_MAX_X features once rounded up to
    the FT_KS slab, and the plan within the block's shared memory.  With
    Fv > 0, whether the classic forward of fused_mlp (mlp_fwd,
    mlp_save_fwd, mlp_bwd_recompute's re-run; Fv per-point view features,
    nd density heads) runs on its classic form: the same rule, the view at
    most FT_MAX_X features once rounded up, one density head; also with no
    view layer (net_depth_condition 0, the NV form; Wv unused)."""
    Wv = _view_width(Wv, net_depth_condition)
    return (compute_dtype == torch.float32
            and _wgmma_width(W)
            and (_wgmma_width(Wv) or not net_depth_condition and Fv >= 1)
            and net_depth >= 1
            and net_depth + 1 + net_depth_condition <= FT_MAX_LAYERS
            and 1 <= F and _round_up(F, FT_KS) <= FT_MAX_X
            and 0 <= Fv and _round_up(Fv, FT_KS) <= FT_MAX_X and nd == 1
            and fwd_tf32_smem(W, Wv, F, Fv) <= FW_SMEM_MAX)


def tf32_split(w: torch.Tensor):
    """f32 w -> (hi, lo), both f32: hi = w rounded to tf32 (10 explicit
    mantissa bits, to nearest, ties away from zero, as cvt.rna.tf32 rounds;
    its low 13 bits zero), lo = w - hi exactly (|lo| <= 2^-11 |w|).  The
    tensor core reads lo as tf32 by ignoring its low 13 bits."""
    bits = w.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, w.float() - hi


def tf32_fwd_weights(flat_params, net_depth: int, net_depth_condition: int,
                     skip_index: int, Fv: int = 0):
    """The B operands of lean_fwd_tf32_kernel: by param index, for each
    dense layer the transposed kernel k^T [N, Kp] split into [hi; lo]
    [2N, Kp] f32 (Kp: the encode columns rounded up to FT_KS with zeros;
    view_0 its first W rows only, or in the classic form (Fv > 0) all of
    them, the Fv view columns rounded up likewise); None for the heads.
    With no view layer (net_depth_condition 0) the entry after the
    bottleneck is the rgb head [W + Fv, 3], a head the kernel reads from
    the kernels as stored: None."""
    F, W = flat_params[0].shape
    ks = [t.detach().float() for t in flat_params[0::2]]
    out = [None] * len(ks)

    def split(k, x_rows):
        kt = k.t()
        if x_rows:      # the encode (view) rows, padded to FT_KS
            pad = kt.new_zeros((kt.shape[0],
                                _round_up(x_rows, FT_KS) - x_rows))
            kt = torch.cat([kt, pad], dim=1)
        return torch.cat(tf32_split(kt), dim=0).contiguous()

    out[0] = split(ks[0], F)
    for i in range(1, net_depth):
        out[i] = split(ks[i], F if _skip_after(i - 1, skip_index) else 0)
    out[net_depth + 1] = split(ks[net_depth + 1],
                               F if _skip_after(net_depth - 1, skip_index)
                               else 0)
    iv = net_depth + 2
    if net_depth_condition:
        out[iv] = split(ks[iv], Fv) if Fv else split(ks[iv][:W], 0)
    for j in range(1, net_depth_condition):
        out[iv + j] = split(ks[iv + j], 0)
    return out


def _ptr_array(ts):
    """A ctypes array of the tensors' pointers (None: null)."""
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def _tf32_ptrs(flat_params, net_depth, net_depth_condition, skip_index,
               compute_dtype, classic=False):
    """(the split kernels, a ctypes array of their pointers) for an f32
    forward that takes lean_fwd_tf32_kernel (classic: the classic MLP's, on
    its classic form); (None, None) otherwise."""
    F, W = flat_params[0].shape
    if classic:
        _, _, Fv, Wv = _mlp_dims(flat_params, net_depth)
        nd = flat_params[2 * net_depth].shape[1]
        on = fwd_tf32_route(compute_dtype, F, W, Wv, net_depth,
                            net_depth_condition, Fv, nd)
    else:
        Fv, Wv = 0, flat_params[2 * (net_depth + 2)].shape[1]
        on = fwd_tf32_route(compute_dtype, F, W, Wv, net_depth,
                            net_depth_condition)
    if not on:
        return None, None
    wt = tf32_fwd_weights(flat_params, net_depth, net_depth_condition,
                          skip_index, Fv)
    return wt, _ptr_array(wt)


def fwd_sm90_smem(W: int, Wv: int, F: int, Fv: int = 0) -> int:
    """Dynamic shared memory of lean_fwd_sm90_kernel at widths W, Wv and an
    encode of F features (the classic form: the encode tile also holds the
    Fv per-point view features)."""
    box, wbox = 64 * 64 * 2, FW_KS * 64 * 2
    staged = (2 * 4 * 64 + 2 * 2 * 3 * 64 + FW_MAX_LAYERS * 256
              + (256 + 64 * FW_XBOXES) + 3 * (256 + 64 * FW_XBOXES))
    xrows = max(_round_up(F, FW_KS), _round_up(Fv, FW_KS))
    tile = max(W, Wv) // 64 * box + 128 * xrows
    return (FW_STAGES * 4 * wbox + 2 * tile
            + 4 * staged + 4 * 12 * FW_MAX_LAYERS + 8 * (2 * FW_STAGES + 1)
            + 1024)


def fwd_sm90_route(compute_dtype, F: int, W: int, Wv: int, net_depth: int,
                   net_depth_condition: int, Fv: int = 0,
                   nd: int = 1) -> bool:
    """Whether a lean forward (lean_fwd, lean_save_fwd, the recompute
    backward's re-run, lean_mlp) runs on lean_fwd_sm90_kernel: bf16, W and
    Wv multiples of 64 up to MAX_WIDTH, a view layer, at most FW_MAX_LAYERS
    dense layers, an encode of at most 128 features once rounded up to the
    32-row slab, and the plan within the block's shared memory.  With Fv >
    0, whether the classic forward of fused_mlp (mlp_fwd, mlp_save_fwd,
    mlp_bwd_recompute's re-run; Fv per-point view features, nd density
    heads) runs on its classic form: the same rule, the view at most 128
    features once rounded up, one density head; also with no view layer
    (net_depth_condition 0, the NV form; Wv unused).  Every other bf16
    forward runs on the mma.sync tile."""
    Wv = _view_width(Wv, net_depth_condition)
    return (compute_dtype == torch.bfloat16
            and _wgmma_width(W)
            and (_wgmma_width(Wv) or not net_depth_condition and Fv >= 1)
            and net_depth >= 1
            and net_depth + 1 + net_depth_condition <= FW_MAX_LAYERS
            and 1 <= F and _round_up(F, FW_KS) <= 64 * FW_XBOXES
            and 0 <= Fv and _round_up(Fv, FW_KS) <= 64 * FW_XBOXES
            and nd == 1 and fwd_sm90_smem(W, Wv, F, Fv) <= FW_SMEM_MAX)


def param_order(net_depth: int, net_depth_condition: int,
                use_viewdirs: bool = True):
    """The MLP's layers in the lean flat layout's order; with no view
    directions the trunk, the density head and the rgb head."""
    names = [f'trunk_{i}' for i in range(net_depth)]
    if not use_viewdirs:
        return names + ['density', 'rgb']
    names += ['density', 'bottleneck']
    names += [f'view_{i}' for i in range(net_depth_condition)]
    names += ['rgb']
    return names


def flatten_params(mlp: torch.nn.Module, net_depth: int,
                   net_depth_condition: int, use_viewdirs: bool = True):
    """MLP module -> [k0, b0, k1, b1, ...] in param_order, kernels in the
    flax [in, out] layout and biases [1, out] (views, no copies)."""
    out = []
    for name in param_order(net_depth, net_depth_condition, use_viewdirs):
        lin = getattr(mlp, name)
        out.append(lin.weight.t())
        out.append(lin.bias.reshape(1, -1))
    return out


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _skip_after(i: int, skip_index: int) -> bool:
    """Layer i's output is concatenated with the encode (a skip layer)."""
    return i % skip_index == 0 and i > 0


def saved_rows(F: int, W: int, Wv: int, net_depth: int,
               net_depth_condition: int, Fv: int = 0):
    """Row offsets of the channel-major saved stream [Cs, Mp] of the
    training forward: X (the encode in the compute dtype, F rows padded to
    Fp) | hs[0..depth-1] | bottleneck | ys[0..depth_cond-1], and with Fv
    (the classic MLP's stream) then V, the per-point view features in the
    compute dtype, Fv rows padded to a multiple of 16 (V's first row is
    Cs - that width).
    Returns (Fp, [hs rows], bottleneck row, [ys rows], Cs)."""
    Fp = _round_up(F, 16)
    hs = [Fp + i * W for i in range(net_depth)]
    bott = Fp + net_depth * W
    ys = [bott + W + j * Wv for j in range(net_depth_condition)]
    end = bott + W + net_depth_condition * Wv
    return Fp, hs, bott, ys, end + (_round_up(Fv, 16) if Fv else 0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the JAX kernels' semantics, written with torch ops.
# Activations are rounded to the compute dtype after every layer; products
# accumulate in f32 (bf16 values are upcast, so every product is exact).
# ---------------------------------------------------------------------------

def _rounded(t, dtype):
    return t.to(dtype).float()


def view_proj_plain(view, k0, b0, net_width: int, compute_dtype):
    return (_rounded(view, compute_dtype)
            @ _rounded(k0[net_width:], compute_dtype)
            + _rounded(b0, compute_dtype).reshape(1, -1))


def _lean_body_plain(x, vproj, p, num_samples, net_depth, net_depth_condition,
                     skip_index, dt):
    """x [M, F] and p (params) already rounded to the compute dtype, vproj
    [M/N, Wv] view_0's per-ray half -> (raw_rgb, raw_density, hs,
    bottleneck, ys), the body of the JAX `_fwd_body_lean`."""
    def dense(h, i):
        return h @ p[2 * i] + p[2 * i + 1]

    h, hs = x, []
    for i in range(net_depth):
        h = _rounded(torch.relu(dense(h, i)), dt)
        hs.append(h)
        if _skip_after(i, skip_index):
            h = torch.cat([h, x], dim=-1)
    density = dense(h, net_depth)
    bottleneck = _rounded(dense(h, net_depth + 1), dt)
    iv = net_depth + 2
    W = bottleneck.shape[-1]
    y = bottleneck @ p[2 * iv][:W] + vproj.repeat_interleave(num_samples, 0)
    y = _rounded(torch.relu(y), dt)
    ys = [y]
    for j in range(1, net_depth_condition):
        y = _rounded(torch.relu(dense(y, iv + j)), dt)
        ys.append(y)
    rgb = dense(y, iv + net_depth_condition)
    return rgb, density, hs, bottleneck, ys


def _activate(raw_rgb, raw_density, act):
    """Sigmoid rgb widened by rgb_padding; softplus(raw + density_bias)."""
    pad, bias = act
    rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * pad) - pad
    z = raw_density + bias
    return rgb, torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))


def ipe_moments_plain(moments, min_deg: int, max_deg: int):
    """[6, M] moments (means xyz | diagonal covs xyz) -> [M, 6L] f32 IPE
    encode rows, the decode of every lean kernel's encode tile."""
    return integrated_pos_enc((moments[:3].t(), moments[3:].t()), min_deg,
                              max_deg)


def _encode_rows(x, encode):
    """The f32 encode rows of a lean input: x itself, or with encode =
    (min_deg, max_deg) the IPE of the [6, M] moments x."""
    return x if encode is None else ipe_moments_plain(x, *encode)


def lean_mlp_plain(moments, vproj, flat_params, num_samples: int,
                   net_depth: int, net_depth_condition: int, skip_index: int,
                   compute_dtype, act, encode):
    dt = compute_dtype
    p = [_rounded(t, dt) for t in flat_params]
    x = _rounded(ipe_moments_plain(moments, *encode), dt)
    rgb, density, _, _, _ = _lean_body_plain(
        x, vproj, p, num_samples, net_depth, net_depth_condition, skip_index,
        dt)
    rgb, sigma = _activate(rgb, density, act)
    return torch.cat([rgb, sigma], dim=-1)


def lean_composite_plain(rgbsig, delta, mids, white_bkgd: bool):
    R, N = delta.shape
    rs = rgbsig.reshape(R, N, 4)
    comp, dist, acc, w = composite(rs[..., :3], rs[..., 3], delta, mids,
                                   white_bkgd)
    zeros = torch.zeros_like(comp)
    perray = torch.cat([comp, acc[:, None], dist[:, None], zeros], dim=-1)
    return perray, w


def lean_composite_bwd_plain(rgbsig, delta, mids, g_perray, g_w,
                             white_bkgd: bool):
    """The backward of lean_composite as the JAX
    `_lean_render_head_cotangents` writes it: (activated heads rgbsig
    [R*N, 4], delta / mids [R, N], g_perray [R, 8] = g_comp | g_acc |
    g_dist | pad, g_w [R, N]) f32 -> (g_rgb [R*N, 3], g_sigma [R*N, 1]),
    the cotangents of the activated heads.  The exclusive prefix sum of
    sigma * delta and the strictly-later suffix sum of g_s (JAX's two
    triangular products) are cumulative sums here."""
    R, N = delta.shape
    rs = rgbsig.reshape(R, N, 4)
    rgb, sigma = rs[..., :3], rs[..., 3]
    dd = sigma * delta
    zero = torch.zeros_like(dd[:, :1])
    alpha = 1.0 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([zero, torch.cumsum(dd, -1)[:, :-1]], -1))
    w = alpha * trans
    g_comp = g_perray[:, :3]
    ga = g_perray[:, 3:4]
    if white_bkgd:
        ga = ga - torch.sum(g_comp, dim=-1, keepdim=True)
    g_wt = (g_w + g_perray[:, 4:5] * mids
            + (ga + torch.sum(g_comp[:, None, :] * rgb, dim=-1)))
    g_s = -trans * (g_wt * alpha)
    tail = torch.flip(torch.cumsum(torch.flip(g_s, [-1]), -1), [-1])
    g_dd = (torch.exp(-dd) * (g_wt * trans)
            + torch.cat([tail[:, 1:], zero], -1))
    g_rgb = w[..., None] * g_comp[:, None, :]
    return g_rgb.reshape(R * N, 3), (g_dd * delta).reshape(R * N, 1)


def _lean_fwd_plain_parts(x, view, flat_params, num_samples, net_depth,
                          net_depth_condition, skip_index, compute_dtype):
    """(x rounded to the compute dtype, raw rgb [M, 3], raw density [M, 1]
    f32, hs, bottleneck, ys) of the Pallas-mode forward on encode rows."""
    dt = compute_dtype
    p = [_rounded(t, dt) for t in flat_params]
    W = p[0].shape[1]
    iv = 2 * (net_depth + 2)
    xr = _rounded(x, dt)
    vproj = view_proj_plain(view, flat_params[iv], flat_params[iv + 1], W, dt)
    return (xr,) + _lean_body_plain(xr, vproj, p, num_samples, net_depth,
                                    net_depth_condition, skip_index, dt)


def _heads_out(raw_rgb, raw_d, act):
    return _activate(raw_rgb, raw_d, act) if act is not None \
        else (raw_rgb, raw_d)


def lean_fwd_plain(x, view, flat_params, num_samples: int, net_depth: int,
                   net_depth_condition: int, skip_index: int, compute_dtype,
                   act, encode=None):
    """The lean forward: (x [M, F] f32 encode rows, or with encode =
    (min_deg, max_deg) the [6, M] moments, view [M/N, Fv], params) -> (rgb
    [M, 3], density [M, 1]) f32, activated with act = (rgb_padding,
    density_bias), raw heads for act=None."""
    _, raw_rgb, raw_d, _, _, _ = _lean_fwd_plain_parts(
        _encode_rows(x, encode), view, flat_params, num_samples, net_depth,
        net_depth_condition, skip_index, compute_dtype)
    return _heads_out(raw_rgb, raw_d, act)


def lean_mlp_save_plain(x, view, flat_params, num_samples: int,
                        net_depth: int, net_depth_condition: int,
                        skip_index: int, compute_dtype, act, encode=None):
    """lean_fwd_plain that also returns saved = (S [Cs, Mp] compute dtype,
    the `saved_rows` layout (X the decoded encode with moments), zero past
    M; raw heads [4, Mp] f32)."""
    dt = compute_dtype
    x = _encode_rows(x, encode)
    xr, raw_rgb, raw_d, hs, bott, ys = _lean_fwd_plain_parts(
        x, view, flat_params, num_samples, net_depth, net_depth_condition,
        skip_index, dt)
    rgb, density = _heads_out(raw_rgb, raw_d, act)
    M, F = x.shape
    W = hs[0].shape[1]
    Wv = ys[0].shape[1]
    Mp = _round_up(M, TILE)
    _, hs_r, bott_r, ys_r, Cs = saved_rows(F, W, Wv, net_depth,
                                           net_depth_condition)
    S = torch.zeros((Cs, Mp), dtype=dt, device=x.device)
    for row, t in [(0, xr)] + list(zip(hs_r, hs)) + [(bott_r, bott)] \
            + list(zip(ys_r, ys)):
        S[row:row + t.shape[1], :M] = t.t().to(dt)
    heads = torch.zeros((4, Mp), dtype=torch.float32, device=x.device)
    heads[:3, :M] = raw_rgb.t()
    heads[3:, :M] = raw_d.t()
    return rgb, density, (S, heads)


def _saved_parts(S, M, F, W, Wv, net_depth, net_depth_condition):
    """Views of the saved stream as f32 [M, width] tiles: (x, hs,
    bottleneck, ys)."""
    _, hs_r, bott_r, ys_r, _ = saved_rows(F, W, Wv, net_depth,
                                          net_depth_condition)

    def rows(r, w):
        return S[r:r + w, :M].t().float()
    return (rows(0, F), [rows(r, W) for r in hs_r], rows(bott_r, W),
            [rows(r, Wv) for r in ys_r])


def _param_grads_core(view, g_rgb, g_dens, x, hs, bott, ys, flat_params,
                      num_samples, net_depth, net_depth_condition, skip_index,
                      compute_dtype, act):
    """The JAX `_lean_param_grads`, op for op, on the activations as f32
    [M, width] tensors holding compute-dtype values."""
    dt = compute_dtype
    iv = net_depth + 2
    nvd = net_depth_condition
    W = flat_params[0].shape[1]
    Wv = flat_params[2 * iv].shape[1]
    N = num_samples
    p = [_rounded(t, dt) for t in flat_params]
    grads = [None] * len(flat_params)
    cat_last = _skip_after(net_depth - 1, skip_index)

    if act is not None:
        # Fold the head-activation derivatives into the cotangents, from
        # the raw heads recomputed off the saved activations.
        pad, bias = act

        def head_raw(t, idx):
            return t @ p[2 * idx] + p[2 * idx + 1]

        sig = torch.sigmoid(head_raw(ys[-1], iv + nvd))
        g_rgb = g_rgb * ((1.0 + 2.0 * pad) * sig * (1.0 - sig))
        h_last = torch.cat([hs[-1], x], dim=-1) if cat_last else hs[-1]
        g_dens = g_dens * torch.sigmoid(head_raw(h_last, net_depth) + bias)

    def d_dense(idx, parts, g_out, need):
        """dW / db of layer idx (always), d(part) where need[i]."""
        k = p[2 * idx]
        gb = _rounded(g_out, dt)
        grads[2 * idx + 1] = g_out.sum(0, keepdim=True)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        out, off = [], 0
        for t, n in zip(parts, need):
            w = t.shape[-1]
            dk[off:off + w] = t.t() @ gb
            if n:
                out.append(gb @ k[off:off + w].t())
            off += w
        grads[2 * idx] = dk
        return out

    # rgb head and view layers j >= 1.
    g = d_dense(iv + nvd, [ys[-1]], g_rgb, [True])[0]
    for j in reversed(range(1, nvd)):
        g = torch.where(ys[j] > 0.0, g, 0.0)
        g = d_dense(iv + j, [ys[j - 1]], g, [True])[0]

    # view_0, split: per-point rows take bottleneck^T g, per-ray rows take
    # view^T g_ray with g summed over each ray's samples first.
    g1 = torch.where(ys[0] > 0.0, g, 0.0)
    k0 = p[2 * iv]
    grads[2 * iv + 1] = g1.sum(0, keepdim=True)
    g1b = _rounded(g1, dt)
    dk0 = torch.zeros(k0.shape, dtype=torch.float32, device=k0.device)
    dk0[:W] = bott.t() @ g1b
    g_ray = _rounded(g1.reshape(-1, N, Wv).sum(1), dt)
    dk0[W:] = _rounded(view, dt).t() @ g_ray
    grads[2 * iv] = dk0
    g_bott = g1b @ k0[:W].t()

    # Bottleneck and density read [hs[-1], x] after a last skip concat; the
    # x halves of skip concats carry no cotangent, their kernel rows do.
    parts = [hs[-1]] + ([x] if cat_last else [])
    need = [True] + ([False] if cat_last else [])
    g_trunk = d_dense(net_depth + 1, parts, g_bott, need)[0]
    g_trunk = g_trunk + d_dense(net_depth, parts, g_dens, need)[0]
    for i in reversed(range(net_depth)):
        g_trunk = torch.where(hs[i] > 0.0, g_trunk, 0.0)
        if i == 0:
            d_dense(0, [x], g_trunk, [False])
            break
        skip = _skip_after(i - 1, skip_index)
        g_trunk = d_dense(i, [hs[i - 1]] + ([x] if skip else []), g_trunk,
                          [True] + ([False] if skip else []))[0]
    return grads


def lean_param_grads_plain(view, g_rgb, g_dens, saved, flat_params,
                           num_samples: int, net_depth: int,
                           net_depth_condition: int, skip_index: int,
                           compute_dtype, act):
    """(view [R, Fv] f32, head cotangents g_rgb [M, 3] / g_dens [M, 1] f32,
    saved from lean_mlp_save_plain, params) -> f32 gradients in param order
    (kernels [in, out], biases [1, out]); act=None: the heads were raw, no
    activation derivative is folded in."""
    S, _ = saved
    M = g_rgb.shape[0]
    F, W = flat_params[0].shape
    Wv = flat_params[2 * (net_depth + 2)].shape[1]
    x, hs, bott, ys = _saved_parts(S, M, F, W, Wv, net_depth,
                                   net_depth_condition)
    return _param_grads_core(view, g_rgb, g_dens, x, hs, bott, ys,
                             flat_params, num_samples, net_depth,
                             net_depth_condition, skip_index, compute_dtype,
                             act)


def lean_param_grads_recompute_plain(x, view, g_rgb, g_dens, flat_params,
                                     num_samples: int, net_depth: int,
                                     net_depth_condition: int,
                                     skip_index: int, compute_dtype, act,
                                     encode=None):
    """The recompute backward: the forward again (rows, or the moments
    with encode), with its saved activations, then
    lean_param_grads_plain."""
    args = (num_samples, net_depth, net_depth_condition, skip_index,
            compute_dtype, act)
    saved = lean_mlp_save_plain(x, view, flat_params, *args, encode)[2]
    return lean_param_grads_plain(view, g_rgb, g_dens, saved, flat_params,
                                  *args)


# The hybrid backward reads what 'save' reads, (S, heads): one plain version.
lean_param_grads_hybrid_plain = lean_param_grads_plain

def _f32_products(k, t):
    """k^T t [n, Mp] as f32 sums of the exact products of the compute-dtype
    kernel rows k [w, n] and activation rows t [w, Mp]: on the card cuBLAS
    writes its f32 sums as they are (no f32 copy of t); on the CPU the
    operands are cast first."""
    if t.is_cuda:
        return torch.mm(k.t(), t, out_dtype=torch.float32)
    return k.float().t() @ t.float()


@torch.no_grad()
def lean_hybrid_fwd(x, view, flat_params, num_samples: int, net_depth: int,
                    net_depth_condition: int, skip_index: int, compute_dtype,
                    act):
    """The forward of mode 'hybrid', plain torch as JAX's is plain XLA
    (`_fwd_body_lean_xla`), with its rounding: each product in the compute
    dtype, biases added in it, skip and head concats as split products.
    Each product is computed transposed, k^T act^T, straight into its rows
    of the channel-major stream S [Cs, Mp] of the `saved_rows` layout (the
    same cuBLAS product with its operands swapped), then the bias and the
    ReLU in place; view_0's per-ray term is added along each ray's columns.
    -> (rgb [M, 3], density [M, 1] f32, activated with act from heads
    rounded to the compute dtype, saved = (S, raw heads [4, Mp] f32)), the
    pair the 'save' backward reads.  The raw heads are f32 sums of the
    compute-dtype activations with the rounded biases, the value JAX's
    backward recomputes for its activation fold (in f32 the output heads
    themselves; in bf16 `_f32_products`, so no level-sized f32 copy
    exists).  Columns M..Mp of S and heads are zero, as lean_mlp_save_plain
    leaves them."""
    dt = compute_dtype
    dev = x.device
    # Contiguous [in, out] kernels: cuBLAS then picks its faster f32 tiles
    # for k^T act^T (the model's kernels are transposed views).
    p = [t.detach().to(dt).contiguous() for t in flat_params]
    M, F = x.shape
    Mp = _round_up(M, TILE)
    W = p[0].shape[1]
    iv = net_depth + 2
    Wv = p[2 * iv].shape[1]
    Fp, hs_r, bott_r, ys_r, Cs = saved_rows(F, W, Wv, net_depth,
                                            net_depth_condition)
    S = torch.empty((Cs, Mp), dtype=dt, device=dev)
    # X = x^T as the product of the identity and x^T (each entry 1 times an
    # x, exact): cuBLAS transposes with coalesced reads, where a copy of
    # x.t() reads x with a stride of F values (~6x slower at a lego level).
    torch.mm(torch.eye(F, dtype=dt, device=dev), x.to(dt).t(), out=S[:F, :M])
    S[:F, M:] = 0
    S[F:Fp] = 0
    X = S[:F]
    ones = torch.ones((1, Mp), dtype=dt, device=dev)

    def dense_t(idx, parts, out):
        """out [n, Mp] = b + sum of k[part]^T part (parts [w, Mp] rows):
        each product rounded to the compute dtype, then added in it.  The
        bias goes in as the rank-1 product b 1^T added to out (exact
        products, one rounding of the sum, as the add would): cuBLAS
        streams out once, where an add broadcast along rows runs slower."""
        k, off = p[2 * idx], 0
        for t in parts:
            w = t.shape[0]
            if off == 0:
                torch.mm(k[:w].t(), t, out=out)
                out.addmm_(p[2 * idx + 1].reshape(-1, 1), ones)
            else:
                out += k[off:off + w].t() @ t
            off += w
        return out

    def rows(r, w):
        return S[r:r + w]

    parts = [X]
    for i in range(net_depth):
        h = dense_t(i, parts, rows(hs_r[i], W)).relu_()
        parts = [h, X] if _skip_after(i, skip_index) else [h]
    f32 = dt == torch.float32
    heads = torch.empty((4, Mp), dtype=torch.float32, device=dev)
    dens = dense_t(net_depth, parts,
                   heads[3:] if f32 else torch.empty((1, Mp), dtype=dt,
                                                      device=dev))
    bott = dense_t(net_depth + 1, parts, rows(bott_r, W))
    k0, b0 = p[2 * iv], p[2 * iv + 1]
    per_ray = view.to(dt) @ k0[W:] + b0
    y = rows(ys_r[0], Wv)
    torch.mm(k0[:W].t(), bott, out=y)
    y[:, :M].view(Wv, -1, num_samples).add_(per_ray.t()[:, :, None])
    y.relu_()
    for j in range(1, net_depth_condition):
        y = dense_t(iv + j, [y], rows(ys_r[j], Wv)).relu_()
    i_rgb = iv + net_depth_condition
    rgb = dense_t(i_rgb, [y],
                  heads[:3] if f32 else torch.empty((3, Mp), dtype=dt,
                                                    device=dev))
    if not f32:
        for idx, srcs, out in ((i_rgb, [y], heads[:3]),
                               (net_depth, parts, heads[3:])):
            k, off = p[2 * idx], 0
            acc = p[2 * idx + 1].float().reshape(-1, 1)
            for t in srcs:
                acc = acc + _f32_products(k[off:off + t.shape[0]], t)
                off += t.shape[0]
            out.copy_(acc)
    S[Fp:, M:] = 0
    heads[:, M:] = 0
    raw_rgb = rgb[:, :M].t().float().contiguous()
    raw_d = dens[:, :M].t().float().contiguous()
    rgb, density = _heads_out(raw_rgb, raw_d, act)
    return rgb, density, (S, heads)


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


def _check(t, shape, fn, name, device, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f'{fn}: {name} must be {dtype} {tuple(shape)}, got '
                         f'{t.dtype} {tuple(t.shape)}')
    if t.device != device:
        raise ValueError(f'{fn}: {name} is on {t.device}, expected {device}')


def _check_mlp(flat_params, net_depth, net_depth_condition, flag, fn, dev,
               max_density=1):
    """Widths the CUDA tilings take, 3 rgb + 1 (up to max_density) density
    heads, parameters on `dev`; returns (W, Wv), Wv = 0 with no view
    layer."""
    W = flat_params[0].shape[1]
    iv = 2 * (net_depth + 2)
    Wv = _view_width(flat_params[iv].shape[1], net_depth_condition)
    align = 16 if flag else 8      # tensor-core tiles: k16/n16, k8/n8
    for w in (W, Wv) if net_depth_condition else (W,):
        if w % align or w > MAX_WIDTH:
            raise ValueError(f'{fn}: layer width {w} must be a multiple of '
                             f'{align} and at most {MAX_WIDTH}')
    if flat_params[iv + 2 * net_depth_condition].shape[1] != 3 \
            or not 1 <= flat_params[2 * net_depth].shape[1] <= max_density:
        raise ValueError(f'{fn}: heads must be 3 rgb + '
                         f'{"1" if max_density == 1 else f"1..{max_density}"}'
                         ' density')
    for t in flat_params:
        if t.device != dev:
            raise ValueError(f'{fn}: parameter on {t.device}, expected {dev}')
    return W, Wv


def _kernel_params(flat_params, compute_dtype):
    """Kernels in the compute dtype, biases rounded through it (f32), and
    ctypes arrays of their pointers (keep all four alive over the call)."""
    ws = [t.detach().to(compute_dtype).contiguous() for t in flat_params[0::2]]
    bs = [_rounded(t.detach(), compute_dtype).reshape(-1).contiguous()
          for t in flat_params[1::2]]
    n = len(ws)
    w_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in ws])
    b_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in bs])
    return ws, bs, w_ptrs, b_ptrs


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The arguments every backward entry takes after its mode's own.
_GRAD_TAIL = ([_P] * 5 + [_I] + [_P] * 7 + [_I, _P, _I, _P, _I, _P, _I, _I]
              + [_P] * 3 + [_I, _P, _F, _F, _I, _I, _P])
# C signatures of csrc/<lib>.cu (pointers and the stream as void*).
_ARGTYPES = {
    'lean_view_proj': [_P] * 4 + [_I] * 5 + [_P],
    'lean_mlp': [_P] * 5 + [_I, _P] + [_I] * 10 + [_F, _F, _I, _P],
    'lean_composite': [_P] * 5 + [_I] * 3 + [_P],
    'lean_composite_bwd': [_P] * 7 + [_I] * 3 + [_P],
    'ipe_moments': [_P] * 2 + [_I] * 3 + [_P],
    'ipe_fwd': [_P] * 3 + [_I] * 3 + [_P],
    'ipe_bwd': [_P] * 5 + [_I] * 3 + [_P],
    'lean_fwd': [_P] * 5 + [_I] + [_P] * 2 + [_F, _F, _I, _I, _P],
    'lean_save_fwd': [_P] * 5 + [_I] + [_P] * 4 + [_F, _F, _I, _I, _P],
    'lean_param_grads': [_P] * 2 + _GRAD_TAIL,
    'lean_param_grads_recompute': [_P] * 7 + [_I] + _GRAD_TAIL,
    'mlp_fwd': [_P] * 5 + [_I] + [_P] * 3 + [_I, _P],
    'mlp_save_fwd': [_P] * 5 + [_I] + [_P] * 4 + [_I, _P],
    'mlp_bwd_saved': [_P] * 7 + _GRAD_TAIL,
    'mlp_bwd_recompute': [_P] * 6 + [_I] + [_P] * 6 + _GRAD_TAIL,
    'tp_pair_fwd': [_P] * 5 + [_I] * 6 + [_P, _P],
    'tp_pair_bwd': [_P] * 9 + [_I, _P, _I, _I, _P, _P] + [_I] * 6 + [_P, _P],
}


# Wrapper name -> the C entry it launches, where the two differ: the hybrid
# backward reads the stream 'save' reads.
_ENTRY = {'lean_param_grads_hybrid': 'lean_param_grads'}


def _call(fn_name: str, device, *args):
    """Launch one kernel on the current stream of `device`; raise if the
    launch was refused (the C entry returns cudaGetLastError())."""
    with span('mip.launch'):
        from mipnerf_pl_tpu_torch.kernels import _build
        lib = _build.load(KERNELS[fn_name][0].rsplit('/', 1)[1][:-len('.cu')])
        entry = _ENTRY.get(fn_name, fn_name)
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        counts = []
        for name, table in (('lean_fwd_sm90_launches', routes),
                            ('lean_fwd_tf32_launches', tf32_routes)):
            if fn_name in table:
                count = getattr(lib, name)
                count.argtypes, count.restype = [], ctypes.c_longlong
                counts.append((count, count(), table))
        for entry, i, table in (
                ('lean_chain_launches', 0, chain_routes),
                ('lean_chain_launches', 1, chain_tf32_routes),
                ('classic_mma_launches', 0, mma_fwd_routes),
                ('classic_mma_launches', 1, mma_chain_routes),
                ('classic_mma_launches', 2, mma_input_routes),
                ('tp_pair_launches', 0, pair_sm90_routes),
                ('tp_pair_launches', 1, pair_tf32_routes),
                ('tp_pair_launches', 2, pair_mma_routes)):
            if fn_name in table:
                count = _array_count(lib, entry, i)
                counts.append((count, count(), table))
        for name, table in (('wgrad_tf32_launches', wgrad_tf32_routes),
                            ('wgrad_sm90_launches', wgrad_sm90_routes)):
            if fn_name in table:
                count = getattr(lib, name)
                count.argtypes, count.restype = [], ctypes.c_longlong
                counts.append((count, count(), table))
        with torch.cuda.device(device):       # launch on the tensors' card
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'{fn_name}: CUDA error {err} at launch')
        for count, before, table in counts:
            if count() > before:
                table[fn_name] += 1


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
    dev = moments.device
    W, Wv = _check_mlp(flat_params, net_depth, net_depth_condition, flag,
                       'lean_mlp', dev)
    _check(moments, (6, M), 'lean_mlp', 'moments', dev)
    _check(vproj, (R, Wv), 'lean_mlp', 'vproj', dev)
    if M != R * N or M == 0:
        raise ValueError(f'lean_mlp: {M} points is not a positive multiple '
                         f'of num_samples={N}')
    if flat_params[0].shape[0] != 6 * L:
        raise ValueError(f'lean_mlp: trunk_0 takes {flat_params[0].shape[0]}'
                         f' inputs, the encode has {6 * L}')
    _check_degrees('lean_mlp', min_deg, max_deg)
    ws, bs, w_ptrs, b_ptrs = _kernel_params(flat_params, compute_dtype)
    wt, wt_ptrs = _tf32_ptrs(flat_params, net_depth, net_depth_condition,
                             skip_index, compute_dtype)
    moments = moments.contiguous()
    vproj = vproj.contiguous()
    out = torch.empty((M, 4), dtype=torch.float32, device=dev)
    pad, bias = act
    _call('lean_mlp', dev, moments.data_ptr(), vproj.data_ptr(),
          ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
          None if wt is None else ctypes.addressof(wt_ptrs), len(ws),
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


def lean_composite_bwd(rgbsig, delta, mids, g_perray, g_w, white_bkgd: bool):
    """(activated heads rgbsig [R*N, 4], delta / mids [R, N], g_perray
    [R, 8], g_w [R, N]) f32 -> (g_rgb [R*N, 3], g_sigma [R*N, 1]) f32:
    the backward of lean_composite."""
    if _on_cpu(rgbsig, 'lean_composite_bwd'):
        return lean_composite_bwd_plain(rgbsig, delta, mids, g_perray, g_w,
                                        white_bkgd)
    R, N = delta.shape
    dev = rgbsig.device
    fn = 'lean_composite_bwd'
    for t, name, shape in ((rgbsig, 'rgbsig', (R * N, 4)),
                           (delta, 'delta', (R, N)), (mids, 'mids', (R, N)),
                           (g_perray, 'g_perray', (R, 8)),
                           (g_w, 'g_w', (R, N))):
        _check(t, shape, fn, name, dev)
    rgbsig, delta, mids, g_perray, g_w = (
        t.contiguous() for t in (rgbsig, delta, mids, g_perray, g_w))
    g_rgb = torch.empty((R * N, 3), dtype=torch.float32, device=dev)
    g_sig = torch.empty((R * N, 1), dtype=torch.float32, device=dev)
    _call(fn, dev, rgbsig.data_ptr(), delta.data_ptr(), mids.data_ptr(),
          g_perray.data_ptr(), g_w.data_ptr(), g_rgb.data_ptr(),
          g_sig.data_ptr(), R, N, int(bool(white_bkgd)))
    launches[fn] += 1
    return g_rgb, g_sig


def ipe_moments(moments, min_deg: int, max_deg: int):
    """[6, M] f32 moments (means xyz | diagonal covs xyz) -> [M, 6L] f32
    IPE encode rows, L = max_deg - min_deg.  The moments form gives its
    input no gradient (the JAX fused_ipe_moments returns zero cotangents:
    its callers train behind stop_resample_grad), so moments that require
    one are refused rather than silently detached."""
    if torch.is_grad_enabled() and moments.requires_grad:
        raise ValueError(
            'ipe_moments: the moments require a gradient, which the moments '
            'form of the encode does not give; train with '
            'nerf.stop_resample_grad (which detaches the resampled '
            'fenceposts) or encode with kernels.ipe.fused_ipe '
            '(nerf.ipe_backend: pallas), whose backward returns it')
    if _on_cpu(moments, 'ipe_moments'):
        return ipe_moments_plain(moments, min_deg, max_deg)
    L = max_deg - min_deg
    dev = moments.device
    M = moments.shape[-1]
    _check(moments, (6, M), 'ipe_moments', 'moments', dev)
    if L < 1 or M == 0:
        raise ValueError(f'ipe_moments: needs max_deg > min_deg and points, '
                         f'got degrees ({min_deg}, {max_deg}), {M} points')
    _check_ladder('ipe_moments', min_deg, max_deg)
    moments = moments.contiguous()
    out = torch.empty((M, 6 * L), dtype=torch.float32, device=dev)
    _call('ipe_moments', dev, moments.data_ptr(), out.data_ptr(), M, L,
          min_deg)
    launches['ipe_moments'] += 1
    return out


class _LeanRender(torch.autograd.Function):
    """The render-fused level with a backward: the training forward of the
    mode ('save': lean_save_fwd, 'recompute': lean_fwd, in the level's
    input form) writes the activated heads, lean_composite composites them;
    the backward runs lean_composite_bwd, then the mode's parameter-gradient
    backward with the activation fold.  What crosses to the backward: the
    activated heads [M, 4], delta, mids, and the saved stream ('save') or
    the level's input ('recompute').  x, view, delta and mids get no
    gradient (the JAX VJP returns zeros for them)."""

    @staticmethod
    def forward(ctx, x, view, delta, mids, mode, cfg, white_bkgd, encode,
                *flat):
        ctx.mode, ctx.cfg, ctx.n_flat = mode, cfg, len(flat)
        ctx.white_bkgd, ctx.encode = white_bkgd, encode
        rgb, density, kept = _mode_forward(mode, x, view, flat, cfg, encode)
        rgbsig = torch.cat([rgb, density], dim=-1)
        perray, w = lean_composite(rgbsig, delta, mids, white_bkgd)
        ctx.save_for_backward(rgbsig, delta, mids, *kept, *flat)
        return perray, w

    @staticmethod
    @once_differentiable
    def backward(ctx, g_perray, g_w):
        saved = ctx.saved_tensors
        rgbsig, delta, mids = saved[:3]
        res, flat = saved[3:-ctx.n_flat], saved[-ctx.n_flat:]
        g_rgb, g_sigma = lean_composite_bwd(rgbsig, delta, mids,
                                            g_perray.float(), g_w.float(),
                                            ctx.white_bkgd)
        grads = _mode_param_grads(ctx.mode, res, g_rgb, g_sigma, flat,
                                  ctx.cfg, ctx.encode)
        return ((None,) * 8
                + tuple(g.reshape(p.shape) for g, p in zip(grads, flat)))


RENDER_MODES = ('save', 'recompute')


def fused_mlp_lean_render(x, view, delta, mids, flat_params,
                          num_samples: int, net_depth: int,
                          net_depth_condition: int, skip_index: int,
                          compute_dtype=torch.float32, act=(0.001, -1.0),
                          white_bkgd: bool = True, encode=None,
                          mode: str = 'save'):
    """Level: MLP + head activations + volumetric compositing.

    (x = [M, F] f32 encode rows, or with encode = (min_deg, max_deg) the
    [6, M] moments whose IPE the kernels decode, view [M/N, Fv], delta
    [M/N, N] = (t1 - t0) * ||dir||, mids [M/N, N] = (t0 + t1) / 2, params)
    -> (comp_rgb [M/N, 3], dist_raw [M/N, 1], acc [M/N, 1], weights
    [M/N, N]), as the JAX function returns them: dist_raw is UNCLAMPED (the
    caller applies the nan-safe clamp).  `act` = (rgb_padding,
    density_bias).

    When a parameter wants a gradient, the level is the autograd Function
    `_LeanRender` of `mode` ('save' or 'recompute', as in JAX).  Otherwise
    it renders: with the moments through view_proj, lean_mlp and
    lean_composite; with encode rows through lean_fwd and lean_composite."""
    if net_depth_condition < 1:
        raise ValueError('fused_mlp_lean_render requires '
                         'net_depth_condition >= 1')
    if act is None:
        raise ValueError('fused_mlp_lean_render requires act=(rgb_padding, '
                         'density_bias): the composite takes activated '
                         'heads')
    if mode not in RENDER_MODES:
        raise ValueError(f'fused_mlp_lean_render: mode must be one of '
                         f'{RENDER_MODES}, got {mode!r}')
    act = (float(act[0]), float(act[1]))
    cfg = (num_samples, net_depth, net_depth_condition, skip_index,
           compute_dtype, act)
    x, view, delta, mids = (t.float() for t in (x, view, delta, mids))
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat_params):
        perray, w = _LeanRender.apply(x, view, delta, mids, mode, cfg,
                                      bool(white_bkgd), encode, *flat_params)
    elif encode is not None:
        W = flat_params[0].shape[1]
        iv = 2 * (net_depth + 2)
        vproj = view_proj(view, flat_params[iv], flat_params[iv + 1], W,
                          compute_dtype)
        rgbsig = lean_mlp(x, vproj, flat_params, *cfg, encode)
        perray, w = lean_composite(rgbsig, delta, mids, white_bkgd)
    else:
        rgb, density = lean_fwd(x, view, flat_params, *cfg)
        perray, w = lean_composite(torch.cat([rgb, density], dim=-1), delta,
                                   mids, white_bkgd)
    return perray[:, 0:3], perray[:, 4:5], perray[:, 3:4], w


# ---------------------------------------------------------------------------
# Training: fused_mlp_lean in modes 'recompute', 'save' and 'hybrid'.
# ---------------------------------------------------------------------------

def _train_dims(M, N, F, Fv, W, Wv, net_depth, net_depth_condition,
                skip_index, encode=None, nd=1, view_rows=False):
    """The C entries' dims: M, Mp, N, R, F, Fp, Fv, depth, depth_cond, skip,
    W, Wv, L, min_deg (L = 0: encode rows; L >= 1: the moments input), nd
    (density channels), Fvp (the classic MLP's per-point view rows, Fv
    padded to 16; 0 for the lean kernels)."""
    L, min_deg = (0, 0) if encode is None else (encode[1] - encode[0],
                                                encode[0])
    return [M, _round_up(M, TILE), N, M // N, F, _round_up(F, 16), Fv,
            net_depth, net_depth_condition, skip_index, W, Wv, L, min_deg,
            nd, _round_up(Fv, 16) if view_rows else 0]


# Degrees whose scales 2^deg and 2^(2 deg) the IPE kernels build from
# exponent bits (csrc/ipe_core.cuh IPE_MIN_DEG, IPE_END_DEG), and the
# longest ladder the standalone encodes' tiles hold (csrc/ipe.cu
# IPE_MAX_DEGREES).
IPE_DEGREE_RANGE = (-62, 64)
IPE_MAX_DEGREES = 32


def _check_degrees(fn, min_deg: int, max_deg: int):
    if min_deg < IPE_DEGREE_RANGE[0] or max_deg > IPE_DEGREE_RANGE[1]:
        raise ValueError(f'{fn}: degrees ({min_deg}, {max_deg}) outside the '
                         f'kernels\' {IPE_DEGREE_RANGE}')


def _check_ladder(fn, min_deg: int, max_deg: int):
    """The degrees a standalone IPE kernel takes (csrc/ipe.cu ipe_takes)."""
    if max_deg - min_deg > IPE_MAX_DEGREES:
        raise ValueError(f'{fn}: {max_deg - min_deg} degrees, the kernel takes '
                         f'at most {IPE_MAX_DEGREES}')
    _check_degrees(fn, min_deg, max_deg)


def _input_points(fn, x, encode, F):
    """Points of a lean input, x [M, F] encode rows or, with encode, the
    [6, M] moments of an F = 6L encode; checks the form."""
    if encode is None:
        return x.shape[0]
    L = encode[1] - encode[0]
    if 6 * L != F:
        raise ValueError(f'{fn}: trunk_0 takes {F} inputs, the encode of '
                         f'degrees {tuple(encode)} has {6 * L}')
    _check_degrees(fn, *encode)
    return x.shape[-1]


def wgrad_problems(shapes, net_depth: int, net_depth_condition: int,
                   skip_index: int, view_rows: int = 0):
    """Weight-gradient products of the CUDA backward, from the kernel
    shapes [(in, out), ...] in param order.

    The saved activations are numbered as the kernels read them: 0 the
    encode x, 1 + i hs[i], 1 + net_depth the bottleneck, 2 + net_depth + j
    ys[j], and in the classic stream 2 + net_depth + net_depth_condition
    the per-point view.  Returns (problems, tiles, kernel offsets in dw,
    bias offsets in db, view_off): problem = (activation a, K rows, first
    row of the cotangent in G, n columns, offset of its first output in dw,
    row stride in dw), dW[r][c] = sum over points of act_a[r] G[g + c];
    tiles = (problem, row0, col0) of every WGRAD_TILE-square output tile.
    Bias gradients and G rows share one layout: every layer's out columns
    in param order.  view_0's view rows (view_off in dw) are a problem of
    the per-point view when view_rows (= Fv) is set; in the lean kernels
    they are not: they take view^T g_ray per ray."""
    F, W = shapes[0]
    iv = net_depth + 2
    dw_off, b_off, o_dw, o_b = [], [], 0, 0
    for k, n in shapes:
        dw_off.append(o_dw)
        b_off.append(o_b)
        o_dw += k * n
        o_b += n
    probs = []

    def add(a, K, layer, row0):
        n = shapes[layer][1]
        probs.append((a, K, b_off[layer], n, dw_off[layer] + row0 * n, n))

    def inputs(layer, a, width, after):
        add(a, width, layer, 0)
        if _skip_after(after, skip_index):
            add(0, F, layer, width)      # the encode rows of a skip concat

    add(0, F, 0, 0)
    for i in range(1, net_depth):
        inputs(i, i, W, i - 1)                       # hs[i - 1]
    for layer in (net_depth, net_depth + 1):
        inputs(layer, net_depth, W, net_depth - 1)   # hs[-1]
    add(1 + net_depth, W, iv, 0)                     # the bottleneck
    if view_rows:                                    # the per-point view
        add(2 + net_depth + net_depth_condition, view_rows, iv, W)
    for j in range(1, net_depth_condition + 1):
        add(1 + net_depth + j, shapes[iv + j][0], iv + j, 0)   # ys[j - 1]
    tiles = [(i, r0, c0) for i, (_, K, _, n, _, _) in enumerate(probs)
             for r0 in range(0, K, WGRAD_TILE)
             for c0 in range(0, n, WGRAD_TILE)]
    return probs, tiles, dw_off, b_off, dw_off[iv] + W * shapes[iv][1]


def wgrad_split(Mp: int, n_tiles: int, num_samples: int, sms: int) -> int:
    """Points of one partial sum of the weight-gradient products: enough
    ranges for ~8 blocks per SM, each a multiple of the 64-point tile and of
    num_samples, so a range holds whole tiles and rays and a recompute
    chunk holds whole ranges (every mode then sums the same ranges)."""
    want = max(1, -(-8 * sms // n_tiles))
    return _round_up(-(-Mp // want), math.lcm(TILE, num_samples))


def recompute_chunk(Mp: int, mc: int) -> int:
    """Points the recompute backward re-runs at a time: the most whole
    ranges of mc points within RECOMPUTE_POINTS (at least one), at most the
    level."""
    return min(max(1, RECOMPUTE_POINTS // mc), -(-Mp // mc)) * mc


def _act_args(act):
    """(rgb_padding, density_bias, use_act) of the C entries."""
    return (0.0, 0.0, 0) if act is None else (float(act[0]), float(act[1]), 1)


def _fwd_launch(fn, x, view, flat_params, num_samples, net_depth,
                net_depth_condition, skip_index, compute_dtype, act, encode,
                saved_shape=None):
    """Launch lean_fwd or lean_save_fwd (saved_shape = (Cs, Mp)) on encode
    rows or, with encode, the moments -> (out [M, 4] f32, (S, heads) or
    None)."""
    flag = _dtype_flag(compute_dtype)
    dev = x.device
    F = flat_params[0].shape[0]
    M = _input_points(fn, x, encode, F)
    R, Fv = view.shape
    W, Wv = _check_mlp(flat_params, net_depth, net_depth_condition, flag,
                       fn, dev)
    if encode is None:
        _check(x, (M, F), fn, 'x (trunk_0 inputs)', dev)
    else:
        _check(x, (6, M), fn, 'moments', dev)
    _check(view, (R, Fv), fn, 'view', dev)
    if M != R * num_samples or M == 0:
        raise ValueError(f'{fn}: {M} points is not {R} rays x '
                         f'num_samples={num_samples}')
    iv = 2 * (net_depth + 2)
    vproj = view_proj(view, flat_params[iv], flat_params[iv + 1], W,
                      compute_dtype)
    ws, bs, w_ptrs, b_ptrs = _kernel_params(flat_params, compute_dtype)
    wt, wt_ptrs = _tf32_ptrs(flat_params, net_depth, net_depth_condition,
                             skip_index, compute_dtype)
    c_dims = _ints(_train_dims(M, num_samples, F, Fv, W, Wv, net_depth,
                               net_depth_condition, skip_index, encode))
    x = x.contiguous()
    out = torch.empty((M, 4), dtype=torch.float32, device=dev)
    saved, extra = None, []
    if saved_shape is not None:
        saved = (torch.empty(saved_shape, dtype=compute_dtype, device=dev),
                 torch.empty((4, saved_shape[1]), dtype=torch.float32,
                             device=dev))
        extra = [t.data_ptr() for t in saved]
    _call(fn, dev, x.data_ptr(), vproj.data_ptr(), ctypes.addressof(w_ptrs),
          ctypes.addressof(b_ptrs),
          None if wt is None else ctypes.addressof(wt_ptrs), len(ws),
          out.data_ptr(), *extra,
          ctypes.addressof(c_dims), *_act_args(act), flag)
    launches[fn] += 1
    return out, saved


def lean_fwd(x, view, flat_params: Sequence[torch.Tensor], num_samples: int,
             net_depth: int, net_depth_condition: int, skip_index: int,
             compute_dtype, act, encode=None):
    """(x [M, F] f32 encode rows, or with encode = (min_deg, max_deg) the
    [6, M] f32 moments whose IPE the kernel decodes per tile, view [M/N,
    Fv] f32, params) -> (rgb [M, 3], density [M, 1]) f32, activated with
    act = (rgb_padding, density_bias), raw heads for act=None."""
    if _on_cpu(x, 'lean_fwd'):
        return lean_fwd_plain(x, view, flat_params, num_samples, net_depth,
                              net_depth_condition, skip_index, compute_dtype,
                              act, encode)
    out, _ = _fwd_launch('lean_fwd', x, view, flat_params, num_samples,
                         net_depth, net_depth_condition, skip_index,
                         compute_dtype, act, encode)
    return out[:, :3], out[:, 3:]


def lean_save_fwd(x, view, flat_params: Sequence[torch.Tensor],
                  num_samples: int, net_depth: int, net_depth_condition: int,
                  skip_index: int, compute_dtype, act, encode=None):
    """lean_fwd that also returns saved = (S [Cs, Mp] compute dtype in the
    `saved_rows` layout, X the decoded encode with moments; raw heads
    [4, Mp] f32)."""
    if _on_cpu(x, 'lean_save_fwd'):
        return lean_mlp_save_plain(x, view, flat_params, num_samples,
                                   net_depth, net_depth_condition, skip_index,
                                   compute_dtype, act, encode)
    F, W = flat_params[0].shape
    M = _input_points('lean_save_fwd', x, encode, F)
    Wv = flat_params[2 * (net_depth + 2)].shape[1]
    Cs = saved_rows(F, W, Wv, net_depth, net_depth_condition)[-1]
    out, saved = _fwd_launch('lean_save_fwd', x, view, flat_params,
                             num_samples, net_depth, net_depth_condition,
                             skip_index, compute_dtype, act, encode,
                             (Cs, _round_up(M, TILE)))
    return out[:, :3], out[:, 3:], saved


def _grad_plan(fn, view, g_rgb, g_dens, flat_params, num_samples,
               net_depth, net_depth_condition, skip_index, compute_dtype,
               encode=None, classic=False):
    """The checks and the layout every backward wrapper shares; classic:
    fused_mlp's per-point view [M, Fv] (num_samples 1, its rows saved in
    the stream) and up to MAX_DENSITY density heads."""
    flag = _dtype_flag(compute_dtype)
    dev = view.device
    M = g_rgb.shape[0]
    R, Fv = view.shape
    F = flat_params[0].shape[0]
    nd = flat_params[2 * net_depth].shape[1]
    W, Wv = _check_mlp(flat_params, net_depth, net_depth_condition, flag,
                       fn, dev, MAX_DENSITY if classic else 1)
    if M != R * num_samples or M == 0:
        raise ValueError(f'{fn}: {M} points is not {R} rays x '
                         f'num_samples={num_samples}')
    _check(view, (R, Fv), fn, 'view', dev)
    _check(g_rgb, (M, 3), fn, 'g_rgb', dev)
    _check(g_dens, (M, nd), fn, 'g_dens', dev)
    dims = _train_dims(M, num_samples, F, Fv, W, Wv, net_depth,
                       net_depth_condition, skip_index, encode, nd, classic)
    shapes = [tuple(t.shape) for t in flat_params[0::2]]
    probs, tiles, dw_off, b_off, view_off = wgrad_problems(
        shapes, net_depth, net_depth_condition, skip_index,
        Fv if classic else 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(flag=flag, dev=dev, M=M, Mp=dims[1], R=R, F=F, W=W, Wv=Wv,
                dims=dims, shapes=shapes, probs=probs, tiles=tiles,
                dw_off=dw_off, b_off=b_off, view_off=view_off, sms=sms,
                mc=wgrad_split(dims[1], len(tiles), num_samples, sms))


def _grad_launch(fn, prefix, chunk, plan, view, g_rgb, g_dens, flat_params,
                 net_depth, net_depth_condition, compute_dtype, act,
                 classic=False):
    """Launch backward entry `fn` with its mode's own arguments `prefix`
    over chunks of `chunk` points -> f32 gradients in param order.  The
    classic entries take no per-ray scratch (g1f, g_ray)."""
    dev, M, Mp, R, W, Wv = (plan[k] for k in ('dev', 'M', 'Mp', 'R', 'W',
                                              'Wv'))
    shapes, dw_off, b_off = plan['shapes'], plan['dw_off'], plan['b_off']
    iv = net_depth + 2
    ks = [t.detach() for t in flat_params[0::2]]
    # Chain kernels k[:in_h]^T [out, in_h] of the layers the cotangent runs
    # back through (their x rows carry none).
    chain = {i: ks[i][:W] for i in range(1, net_depth)}
    chain[net_depth + 1] = ks[net_depth + 1][:W]
    if net_depth_condition:
        chain[iv] = ks[iv][:W]
    chain.update({iv + j: ks[iv + j] for j in range(1, net_depth_condition)})
    # f32 on lean_chain_tf32_kernel: the same kernels as stored, split.
    ws = {}
    dims = plan['dims']
    if classic:       # the classic chain: F, Fv, nd, skip from the dims
        on = chain_tf32_route(compute_dtype, W, Wv, net_depth,
                              net_depth_condition, F=dims[4], Fv=dims[6],
                              nd=dims[14], skip_index=dims[9])
    else:
        on = fn in chain_routes and chain_tf32_route(
            compute_dtype, W, Wv, net_depth, net_depth_condition)
    if on:
        ws = {i: torch.cat(tf32_split(k), dim=0).contiguous()
              for i, k in chain.items()}
    c_ws = (ctypes.c_void_p * len(ks))(
        *[ws[i].data_ptr() if i in ws else None for i in range(len(ks))])
    chain = {i: k.t().to(compute_dtype).contiguous() for i, k in chain.items()}
    c_chain = (ctypes.c_void_p * len(ks))(
        *[chain[i].data_ptr() if i in chain else None for i in range(len(ks))])
    i_rgb = iv + net_depth_condition
    heads = [ks[net_depth].to(compute_dtype).contiguous(),
             ks[i_rgb].to(compute_dtype).contiguous()]
    heads += [_rounded(flat_params[2 * i + 1].detach(), compute_dtype)
              .reshape(-1).contiguous() for i in (net_depth, i_rgb)]
    cap = min(chunk, Mp)
    n_chain = min(cap // TILE, 2 * plan['sms'])
    n_chunks = -(-M // chunk)
    PW = dw_off[-1] + shapes[-1][0] * shapes[-1][1]
    Cg = b_off[-1] + shapes[-1][1]
    f32 = dict(dtype=torch.float32, device=dev)
    G = torch.empty((Cg, cap), dtype=compute_dtype, device=dev)
    db_part = torch.empty((n_chunks * n_chain, Cg), **f32)
    partial = torch.zeros((-(-Mp // plan['mc']), PW), **f32)
    g1f = g_ray = None
    if not classic:
        g1f = torch.empty((Wv, cap), **f32)
        g_ray = torch.empty((R, Wv), dtype=compute_dtype, device=dev)
    dw = torch.empty(PW, **f32)
    db = torch.empty(Cg, **f32)
    g_rgb, g_dens = g_rgb.contiguous(), g_dens.contiguous()
    view = view if classic else view.contiguous()   # classic: never read
    c_probs = _ints([v for pr in plan['probs'] for v in pr])
    c_tiles = _ints([v for tl in plan['tiles'] for v in tl])
    c_dims = _ints(plan['dims'])
    _call(fn, dev, *prefix, g_rgb.data_ptr(), g_dens.data_ptr(),
          view.data_ptr(), ctypes.addressof(c_chain),
          ctypes.addressof(c_ws) if ws else None, len(ks),
          *[t.data_ptr() for t in heads], G.data_ptr(),
          None if g1f is None else g1f.data_ptr(),
          db_part.data_ptr(), n_chain, partial.data_ptr(), plan['mc'],
          ctypes.addressof(c_probs), len(plan['probs']),
          ctypes.addressof(c_tiles), len(plan['tiles']), PW,
          None if g_ray is None else g_ray.data_ptr(),
          dw.data_ptr(), db.data_ptr(), plan['view_off'],
          ctypes.addressof(c_dims), *_act_args(act), plan['flag'])
    launches[fn] += 1
    grads = []
    for (k, n), o_w, o_b in zip(shapes, dw_off, b_off):
        grads += [dw[o_w:o_w + k * n].view(k, n), db[o_b:o_b + n].view(1, n)]
    return grads


def _stream_param_grads(fn, view, g_rgb, g_dens, saved, flat_params,
                        num_samples, net_depth, net_depth_condition,
                        skip_index, compute_dtype, act):
    """The backward of a level-sized stream (S, heads) as backward wrapper
    `fn` ('lean_param_grads', 'lean_param_grads_hybrid') launches it."""
    plan = _grad_plan(fn, view, g_rgb, g_dens, flat_params, num_samples,
                      net_depth, net_depth_condition, skip_index,
                      compute_dtype)
    S, heads = saved
    Mp, dev = plan['Mp'], plan['dev']
    Cs = saved_rows(plan['F'], plan['W'], plan['Wv'], net_depth,
                    net_depth_condition)[-1]
    _check(S, (Cs, Mp), fn, 'saved stream', dev, compute_dtype)
    _check(heads, (4, Mp), fn, 'saved heads', dev)
    S, heads = S.contiguous(), heads.contiguous()
    return _grad_launch(fn, [S.data_ptr(), heads.data_ptr()],
                        _round_up(Mp, plan['mc']), plan, view, g_rgb, g_dens,
                        flat_params, net_depth, net_depth_condition,
                        compute_dtype, act)


def lean_param_grads(view, g_rgb, g_dens, saved, flat_params,
                     num_samples: int, net_depth: int,
                     net_depth_condition: int, skip_index: int,
                     compute_dtype, act):
    """(view [R, Fv] f32, head cotangents g_rgb [M, 3] / g_dens [M, 1] f32,
    saved from lean_save_fwd, params) -> f32 gradients of every parameter
    in param order (kernels [in, out], biases [1, out])."""
    args = (view, g_rgb, g_dens, saved, flat_params, num_samples, net_depth,
            net_depth_condition, skip_index, compute_dtype, act)
    if _on_cpu(view, 'lean_param_grads'):
        return lean_param_grads_plain(*args)
    return _stream_param_grads('lean_param_grads', *args)


def lean_param_grads_recompute(x, view, g_rgb, g_dens, flat_params,
                               num_samples: int, net_depth: int,
                               net_depth_condition: int, skip_index: int,
                               compute_dtype, act, encode=None):
    """lean_param_grads with the forward re-run by lean_fwd's kernel chunk
    by chunk (recompute_chunk points at a time) instead of read back: (x
    [M, F] f32 encode rows, or with encode the [6, M] moments, view, head
    cotangents, params) -> f32 gradients in param order.  No level-sized
    saved stream is allocated."""
    if _on_cpu(x, 'lean_param_grads_recompute'):
        return lean_param_grads_recompute_plain(
            x, view, g_rgb, g_dens, flat_params, num_samples, net_depth,
            net_depth_condition, skip_index, compute_dtype, act, encode)
    fn = 'lean_param_grads_recompute'
    plan = _grad_plan(fn, view, g_rgb, g_dens, flat_params, num_samples,
                      net_depth, net_depth_condition, skip_index,
                      compute_dtype, encode)
    dev, M, F, W, Wv = (plan[k] for k in ('dev', 'M', 'F', 'W', 'Wv'))
    _input_points(fn, x, encode, F)         # the encode's width is F
    _check(x, (M, F) if encode is None else (6, M), fn, 'x', dev)
    x = x.contiguous()
    iv = 2 * (net_depth + 2)
    vproj = view_proj(view, flat_params[iv], flat_params[iv + 1], W,
                      compute_dtype)
    ws, bs, w_ptrs, b_ptrs = _kernel_params(flat_params, compute_dtype)
    wt, wt_ptrs = _tf32_ptrs(flat_params, net_depth, net_depth_condition,
                             skip_index, compute_dtype)
    chunk = recompute_chunk(plan['Mp'], plan['mc'])
    cap = min(chunk, plan['Mp'])
    Cs = saved_rows(F, W, Wv, net_depth, net_depth_condition)[-1]
    S = torch.empty((Cs, cap), dtype=compute_dtype, device=dev)
    heads = torch.empty((4, cap), dtype=torch.float32, device=dev)
    prefix = [x.data_ptr(), vproj.data_ptr(), ctypes.addressof(w_ptrs),
              ctypes.addressof(b_ptrs),
              None if wt is None else ctypes.addressof(wt_ptrs),
              S.data_ptr(), heads.data_ptr(), chunk]
    return _grad_launch(fn, prefix, chunk, plan, view, g_rgb, g_dens,
                        flat_params, net_depth, net_depth_condition,
                        compute_dtype, act)


def lean_param_grads_hybrid(view, g_rgb, g_dens, saved, flat_params,
                            num_samples: int, net_depth: int,
                            net_depth_condition: int, skip_index: int,
                            compute_dtype, act):
    """lean_param_grads from lean_hybrid_fwd's saved = (S, heads): the same
    kernels, counted under this name."""
    args = (view, g_rgb, g_dens, saved, flat_params, num_samples, net_depth,
            net_depth_condition, skip_index, compute_dtype, act)
    if _on_cpu(view, 'lean_param_grads_hybrid'):
        return lean_param_grads_hybrid_plain(*args)
    return _stream_param_grads('lean_param_grads_hybrid', *args)


def _mode_forward(mode, x, view, flat, cfg, encode):
    """The training forward of `mode` -> (rgb, density, what crosses to
    the backward): 'save' and 'hybrid' view and the saved stream with its
    raw heads, 'recompute' only x and view."""
    if mode == 'recompute':
        rgb, density = lean_fwd(x, view, flat, *cfg, encode=encode)
        return rgb, density, (x, view)
    if mode == 'save':
        rgb, density, saved = lean_save_fwd(x, view, flat, *cfg,
                                            encode=encode)
    else:
        rgb, density, saved = lean_hybrid_fwd(x, view, flat, *cfg)
    return rgb, density, (view, *saved)


def _mode_param_grads(mode, kept, g_rgb, g_dens, flat, cfg, encode):
    """The parameter-gradient backward of `mode` from what _mode_forward
    kept and the f32 head cotangents."""
    if mode == 'recompute':
        x, view = kept
        return lean_param_grads_recompute(x, view, g_rgb, g_dens, flat, *cfg,
                                          encode=encode)
    view, S, heads = kept
    fn = lean_param_grads if mode == 'save' else lean_param_grads_hybrid
    return fn(view, g_rgb, g_dens, (S, heads), flat, *cfg)


class _Lean(torch.autograd.Function):
    """The forward of a mode and its parameter-gradient backward.  x and
    view get no gradient (their producers are parameter-free, and
    resampling is detached under stop_resample_grad, which MipNerf
    enforces)."""

    @staticmethod
    def forward(ctx, x, view, mode, cfg, encode, *flat):
        ctx.mode, ctx.cfg, ctx.n_flat = mode, cfg, len(flat)
        ctx.encode = encode
        rgb, density, kept = _mode_forward(mode, x, view, flat, cfg, encode)
        ctx.save_for_backward(*kept, *flat)
        return rgb, density

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rgb, g_dens):
        saved = ctx.saved_tensors
        kept, flat = saved[:-ctx.n_flat], saved[-ctx.n_flat:]
        grads = _mode_param_grads(ctx.mode, kept, g_rgb.float(),
                                  g_dens.float(), flat, ctx.cfg, ctx.encode)
        return (None, None, None, None, None,
                *[g.reshape(p.shape) for g, p in zip(grads, flat)])


MODES = ('recompute', 'save', 'hybrid')


def fused_mlp_lean(x, view, flat_params, num_samples: int, net_depth: int,
                   net_depth_condition: int, skip_index: int,
                   compute_dtype=torch.float32, mode: str = 'recompute',
                   act=None, encode=None):
    """Lean MLP with a parameter-gradient backward: (x [M, F] f32 encode
    rows, view [M/num_samples, Fv] per ray, flat params) -> (rgb [M, 3],
    density [M, 1]) f32, activated with act = (rgb_padding, density_bias),
    the raw heads for act=None.  encode = (min_deg, max_deg): x is the
    [6, M] f32 moments stream and the kernels decode its IPE per tile
    (modes 'recompute' and 'save'; the recompute backward decodes again).

    mode='recompute': the backward re-runs the forward chunk by chunk;
    nothing level-sized crosses from the forward.  mode='save': the forward
    also keeps every activation (the compute dtype) and the backward reads
    them back.  mode='hybrid': a plain-torch forward whose products write
    the same stream, which the same backward reads.  The backward gives
    gradients to the parameters only: x and view get none, as the JAX
    function gives them zero cotangents."""
    if net_depth_condition < 1:
        raise ValueError('fused_mlp_lean requires net_depth_condition >= 1 '
                         '(the view branch); use the "xla" backend for '
                         'net_depth_condition == 0')
    if mode not in MODES:
        raise ValueError(f'fused_mlp_lean: mode must be one of {MODES}, got '
                         f'{mode!r}')
    if encode is not None and mode == 'hybrid':
        raise ValueError("encode is a kernel-boundary fusion; mode 'hybrid' "
                         "runs its forward in plain torch - use "
                         "'recompute'/'save'")
    cfg = (num_samples, net_depth, net_depth_condition, skip_index,
           compute_dtype, None if act is None
           else (float(act[0]), float(act[1])))
    return _Lean.apply(x.float(), view.float(), mode, cfg,
                       None if encode is None else tuple(encode),
                       *flat_params)


# ---------------------------------------------------------------------------
# The classic MLP: fused_mlp in modes 'recompute' and 'save', with input
# gradients.  Per-point view features, raw heads (nd density channels), and
# a backward that returns dx and dview beside the parameter gradients.
# ---------------------------------------------------------------------------

CLASSIC_MODES = ('recompute', 'save')


def _mlp_body_plain(x, view, p, net_depth, net_depth_condition, skip_index,
                    dt):
    """x [M, F], view [M, Fv] and params p rounded to the compute dtype ->
    (raw rgb [M, 3], raw density [M, nd] f32, hs, bottleneck, ys): the JAX
    `_fwd_body_save`, view_0 (with no view layer, the rgb head) reading
    concat(bottleneck, view) in one product."""
    def dense(h, i):
        return h @ p[2 * i] + p[2 * i + 1]

    h, hs = x, []
    for i in range(net_depth):
        h = _rounded(torch.relu(dense(h, i)), dt)
        hs.append(h)
        if _skip_after(i, skip_index):
            h = torch.cat([h, x], dim=-1)
    density = dense(h, net_depth)
    bott = _rounded(dense(h, net_depth + 1), dt)
    y, ys = torch.cat([bott, view], dim=-1), []
    for j in range(net_depth_condition):
        y = _rounded(torch.relu(dense(y, net_depth + 2 + j)), dt)
        ys.append(y)
    rgb = dense(y, net_depth + 2 + net_depth_condition)
    return rgb, density, hs, bott, ys


def _mlp_dims(flat_params, net_depth):
    """(F, W, Fv, Wv) of the classic MLP from its parameters: Fv is the
    view width of the layer after the bottleneck, Wv that layer's outputs
    (with no view layer it is the rgb head, and Wv is unused)."""
    F, W = flat_params[0].shape
    k = flat_params[2 * (net_depth + 2)]
    return F, W, k.shape[0] - W, k.shape[1]


def mlp_fwd_plain(x, view, flat_params, net_depth: int,
                  net_depth_condition: int, skip_index: int, compute_dtype):
    """(x [M, F], view [M, Fv] f32 per point, params) -> (rgb [M, 3],
    density [M, nd]) f32 raw heads: the JAX `_fwd_kernel`."""
    dt = compute_dtype
    p = [_rounded(t, dt) for t in flat_params]
    rgb, density, _, _, _ = _mlp_body_plain(
        _rounded(x, dt), _rounded(view, dt), p, net_depth,
        net_depth_condition, skip_index, dt)
    return rgb, density


def mlp_save_fwd_plain(x, view, flat_params, net_depth: int,
                       net_depth_condition: int, skip_index: int,
                       compute_dtype):
    """mlp_fwd_plain that also returns the saved stream S [Cs, Mp] in the
    compute dtype, the `saved_rows(..., Fv)` layout (X | hs | bottleneck |
    ys | V), zero past M: the JAX `_fwd_kernel_save` with x and view kept
    in the stream."""
    dt = compute_dtype
    p = [_rounded(t, dt) for t in flat_params]
    xr, vr = _rounded(x, dt), _rounded(view, dt)
    rgb, density, hs, bott, ys = _mlp_body_plain(
        xr, vr, p, net_depth, net_depth_condition, skip_index, dt)
    M = x.shape[0]
    F, W, Fv, Wv = _mlp_dims(flat_params, net_depth)
    _, hs_r, bott_r, ys_r, Cs = saved_rows(F, W, Wv, net_depth,
                                           net_depth_condition, Fv)
    S = torch.zeros((Cs, _round_up(M, TILE)), dtype=dt, device=x.device)
    rows = ([(0, xr)] + list(zip(hs_r, hs)) + [(bott_r, bott)]
            + list(zip(ys_r, ys)) + [(Cs - _round_up(Fv, 16), vr)])
    for row, t in rows:
        S[row:row + t.shape[1], :M] = t.t().to(dt)
    return rgb, density, S


def _mlp_grads_core(x, view, g_rgb, g_dens, hs, bott, ys, flat_params,
                    net_depth, net_depth_condition, skip_index, dt):
    """The JAX `_bwd_kernel_saved`, op for op, on the activations as f32
    tensors holding compute-dtype values -> (dx [M, F], dview [M, Fv],
    grads in param order), all f32.  Each cotangent is cast to the compute
    dtype before its products; masks come from the post-ReLU values.  With
    no view layer the rgb head reads concat(bottleneck, view) (JAX's saved
    backward takes the trunk output there and fails; its recompute
    backward does not)."""
    W = flat_params[0].shape[1]
    iv = net_depth + 2
    p = [_rounded(t, dt) for t in flat_params]
    grads = [None] * len(flat_params)

    def d_dense(idx, inp, g_out):
        gb = _rounded(g_out, dt)
        grads[2 * idx] = inp.t() @ gb
        grads[2 * idx + 1] = g_out.sum(0, keepdim=True)
        return gb @ p[2 * idx].t()

    acts, h = [], x
    for i in range(net_depth):
        acts.append(h)
        h = hs[i]
        if _skip_after(i, skip_index):
            h = torch.cat([h, x], dim=-1)
    trunk_out = h
    v_acts = [torch.cat([bott, view], dim=-1)] + ys[:-1]
    rgb_in = ys[-1] if net_depth_condition else v_acts[0]
    g = d_dense(iv + net_depth_condition, rgb_in, g_rgb)
    for j in reversed(range(net_depth_condition)):
        g = torch.where(ys[j] > 0.0, g, 0.0)
        g = d_dense(iv + j, v_acts[j], g)
    dview = g[:, W:]
    g_trunk = (d_dense(net_depth + 1, trunk_out, g[:, :W])
               + d_dense(net_depth, trunk_out, g_dens))
    g_x = torch.zeros_like(x)
    for i in reversed(range(net_depth)):
        if _skip_after(i, skip_index):
            g_x = g_x + g_trunk[:, W:]
            g_trunk = g_trunk[:, :W]
        g_trunk = torch.where(hs[i] > 0.0, g_trunk, 0.0)
        g_trunk = d_dense(i, acts[i], g_trunk)
    return g_trunk + g_x, dview, grads


def mlp_bwd_saved_plain(g_rgb, g_dens, saved, flat_params, net_depth: int,
                        net_depth_condition: int, skip_index: int,
                        compute_dtype):
    """(head cotangents g_rgb [M, 3] / g_dens [M, nd] f32, the saved stream
    of mlp_save_fwd_plain, params) -> (dx [M, F], dview [M, Fv], grads in
    param order: kernels [in, out], biases [1, out]), f32."""
    M = g_rgb.shape[0]
    F, W, Fv, Wv = _mlp_dims(flat_params, net_depth)
    _, hs_r, bott_r, ys_r, Cs = saved_rows(F, W, Wv, net_depth,
                                           net_depth_condition, Fv)

    def rows(r, w):
        return saved[r:r + w, :M].t().float()
    return _mlp_grads_core(
        rows(0, F), rows(Cs - _round_up(Fv, 16), Fv), g_rgb, g_dens,
        [rows(r, W) for r in hs_r], rows(bott_r, W),
        [rows(r, Wv) for r in ys_r], flat_params, net_depth,
        net_depth_condition, skip_index, compute_dtype)


def mlp_bwd_recompute_plain(x, view, g_rgb, g_dens, flat_params,
                            net_depth: int, net_depth_condition: int,
                            skip_index: int, compute_dtype):
    """The recompute backward: the forward again, then
    mlp_bwd_saved_plain on its stream (the JAX `_bwd_kernel`)."""
    args = (net_depth, net_depth_condition, skip_index, compute_dtype)
    saved = mlp_save_fwd_plain(x, view, flat_params, *args)[2]
    return mlp_bwd_saved_plain(g_rgb, g_dens, saved, flat_params, *args)


def _classic_shapes_ok(fn, flat_params, net_depth):
    """What the classic CUDA kernels take beyond _check_mlp: the encode and
    view widths (padded to 16) within the trunk's."""
    F, W, Fv, _ = _mlp_dims(flat_params, net_depth)
    if max(_round_up(F, 16), _round_up(Fv, 16)) > W:
        raise ValueError(f'{fn}: the encode ({F}) and view ({Fv}) widths, '
                         f'padded to 16, must not exceed the width {W}')


def _mlp_check(fn, x, view, flat_params, net_depth, net_depth_condition,
               compute_dtype):
    """The classic kernels' checks -> (flag, M, F, Fv, W, Wv), Wv = 0
    with no view layer."""
    flag = _dtype_flag(compute_dtype)
    _classic_shapes_ok(fn, flat_params, net_depth)
    dev = x.device
    M = x.shape[0]
    F, W, Fv, _ = _mlp_dims(flat_params, net_depth)
    _, Wv = _check_mlp(flat_params, net_depth, net_depth_condition, flag, fn,
                       dev, MAX_DENSITY)
    _check(x, (M, F), fn, 'x', dev)
    _check(view, (M, Fv), fn, 'view (per point)', dev)
    if M == 0:
        raise ValueError(f'{fn}: no points')
    return flag, M, F, Fv, W, Wv


def _mlp_fwd_launch(fn, x, view, flat_params, net_depth, net_depth_condition,
                    skip_index, compute_dtype, save):
    """Launch mlp_fwd or mlp_save_fwd -> (rgb, density, S or None)."""
    flag, M, F, Fv, W, Wv = _mlp_check(fn, x, view, flat_params, net_depth,
                                       net_depth_condition, compute_dtype)
    dev = x.device
    nd = flat_params[2 * net_depth].shape[1]
    ws, bs, w_ptrs, b_ptrs = _kernel_params(flat_params, compute_dtype)
    wt, wt_ptrs = _tf32_ptrs(flat_params, net_depth, net_depth_condition,
                             skip_index, compute_dtype, classic=True)
    c_dims = _ints(_train_dims(M, 1, F, Fv, W, Wv, net_depth,
                               net_depth_condition, skip_index, None, nd,
                               True))
    x, view = x.contiguous(), view.contiguous()
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    density = torch.empty((M, nd), dtype=torch.float32, device=dev)
    S, extra = None, []
    if save:
        Cs = saved_rows(F, W, Wv, net_depth, net_depth_condition, Fv)[-1]
        S = torch.empty((Cs, _round_up(M, TILE)), dtype=compute_dtype,
                        device=dev)
        extra = [S.data_ptr()]
    _call(fn, dev, x.data_ptr(), view.data_ptr(), ctypes.addressof(w_ptrs),
          ctypes.addressof(b_ptrs),
          None if wt is None else ctypes.addressof(wt_ptrs), len(ws),
          rgb.data_ptr(), density.data_ptr(), *extra,
          ctypes.addressof(c_dims), flag)
    launches[fn] += 1
    return rgb, density, S


def mlp_fwd(x, view, flat_params: Sequence[torch.Tensor], net_depth: int,
            net_depth_condition: int, skip_index: int, compute_dtype):
    """(x [M, F], view [M, Fv] f32 per point, params) -> (rgb [M, 3],
    density [M, nd]) f32 raw heads."""
    if _on_cpu(x, 'mlp_fwd'):
        return mlp_fwd_plain(x, view, flat_params, net_depth,
                             net_depth_condition, skip_index, compute_dtype)
    return _mlp_fwd_launch('mlp_fwd', x, view, flat_params, net_depth,
                           net_depth_condition, skip_index, compute_dtype,
                           False)[:2]


def mlp_save_fwd(x, view, flat_params: Sequence[torch.Tensor],
                 net_depth: int, net_depth_condition: int, skip_index: int,
                 compute_dtype):
    """mlp_fwd that also returns the saved stream S [Cs, Mp] in the compute
    dtype (`saved_rows(..., Fv)`: X | hs | bottleneck | ys | V)."""
    if _on_cpu(x, 'mlp_save_fwd'):
        return mlp_save_fwd_plain(x, view, flat_params, net_depth,
                                  net_depth_condition, skip_index,
                                  compute_dtype)
    return _mlp_fwd_launch('mlp_save_fwd', x, view, flat_params, net_depth,
                           net_depth_condition, skip_index, compute_dtype,
                           True)


def _padded_t(k, cols, compute_dtype):
    """k [K, n] -> k^T [n, cols] in the compute dtype, zero past column K."""
    out = torch.zeros((k.shape[1], cols), dtype=compute_dtype,
                      device=k.device)
    out[:, :k.shape[0]] = k.detach().t()
    return out


def tf32_input_weights(flat_params, net_depth: int,
                       net_depth_condition: int, skip_index: int):
    """The B operands of the classic chain's input-cotangent steps on
    lean_chain_tf32_kernel: by param index, for each layer whose input holds
    x (trunk_0 all of it, each layer after a skip concat, the bottleneck
    after a last one) its x rows k[x rows] as stored [F, out], padded with
    zero rows to F rounded up to 16 and then to 32, split into [hi; lo]
    [2 Fx, out] f32 (None elsewhere); and view_0's view rows k[W:] [Fv, Wv]
    padded likewise and split (None with no view layer: the chain's rgb
    step writes dview from the rgb head as stored)."""
    F, W, Fv, _ = _mlp_dims(flat_params, net_depth)
    ks = [t.detach().float() for t in flat_params[0::2]]

    def split(k):
        rows = _round_up(_round_up(k.shape[0], 16), 32)
        k = torch.cat([k, k.new_zeros((rows - k.shape[0], k.shape[1]))])
        return torch.cat(tf32_split(k), dim=0).contiguous()
    xs = [None] * len(ks)
    xs[0] = split(ks[0])
    for i in range(1, net_depth):
        if _skip_after(i - 1, skip_index):
            xs[i] = split(ks[i][W:])
    if _skip_after(net_depth - 1, skip_index):
        xs[net_depth + 1] = split(ks[net_depth + 1][W:])
    if not net_depth_condition:
        return xs, None
    return xs, split(ks[net_depth + 2][W:])


def _mlp_grad_launch(fn, mode_args, view, g_rgb, g_dens, flat_params,
                     net_depth, net_depth_condition, skip_index,
                     compute_dtype):
    """The classic backward entries: the lean driver with the input
    cotangents.  mode_args(plan) -> (the mode's own arguments, points a
    chunk); then come dx, dview, the x-column kernels and view_0's view
    rows (with no view layer, the rgb head's) of the mma.sync
    input-gradient pass, transposed and padded (lean_chain_sm90_kernel's
    input steps read the same), and, where the chain runs on
    lean_chain_tf32_kernel, its input steps' split kernels.  -> (dx,
    dview, grads)."""
    M = g_rgb.shape[0]
    F, W, Fv, _ = _mlp_dims(flat_params, net_depth)
    Fp = _round_up(F, 16)
    ks = flat_params[0::2]
    # The layers whose input holds x: trunk_0 (all of it), each layer after
    # a skip concat, and the bottleneck after a last skip concat (the
    # density head's x rows fold in there as a rank-nd term).
    x_parts = {0: ks[0]}
    x_parts.update({i: ks[i][W:] for i in range(1, net_depth)
                    if _skip_after(i - 1, skip_index)})
    if _skip_after(net_depth - 1, skip_index):
        x_parts[net_depth + 1] = ks[net_depth + 1][W:]
    x_chain = {i: _padded_t(k, Fp, compute_dtype) for i, k in x_parts.items()}
    c_xchain = (ctypes.c_void_p * len(ks))(
        *[x_chain[i].data_ptr() if i in x_chain else None
          for i in range(len(ks))])
    kv = _padded_t(ks[net_depth + 2][W:], _round_up(Fv, 16), compute_dtype)
    dev = g_rgb.device
    dx = torch.empty((M, F), dtype=torch.float32, device=dev)
    dview = torch.empty((M, Fv), dtype=torch.float32, device=dev)
    plan = _grad_plan(fn, view, g_rgb, g_dens, flat_params, 1, net_depth,
                      net_depth_condition, skip_index, compute_dtype,
                      classic=True)
    x_ws = v_ws = c_xws = None
    if chain_tf32_route(compute_dtype, plan['W'], plan['Wv'], net_depth,
                        net_depth_condition, F=F, Fv=Fv,
                        nd=flat_params[2 * net_depth].shape[1],
                        skip_index=skip_index):
        x_ws, v_ws = tf32_input_weights(flat_params, net_depth,
                                        net_depth_condition, skip_index)
        c_xws = _ptr_array(x_ws)
    prefix, chunk = mode_args(plan)
    prefix += [dx.data_ptr(), dview.data_ptr(), ctypes.addressof(c_xchain),
               kv.data_ptr(), None if c_xws is None else ctypes.addressof(c_xws),
               None if v_ws is None else v_ws.data_ptr()]
    grads = _grad_launch(fn, prefix, chunk, plan, view, g_rgb, g_dens,
                         flat_params, net_depth, net_depth_condition,
                         compute_dtype, None, classic=True)
    return dx, dview, grads


def mlp_bwd_saved(g_rgb, g_dens, saved, flat_params: Sequence[torch.Tensor],
                  net_depth: int, net_depth_condition: int, skip_index: int,
                  compute_dtype):
    """(head cotangents g_rgb [M, 3] / g_dens [M, nd] f32, saved from
    mlp_save_fwd, params) -> (dx [M, F], dview [M, Fv], f32 gradients of
    every parameter in param order)."""
    if _on_cpu(saved, 'mlp_bwd_saved'):
        return mlp_bwd_saved_plain(g_rgb, g_dens, saved, flat_params,
                                   net_depth, net_depth_condition,
                                   skip_index, compute_dtype)
    fn = 'mlp_bwd_saved'
    _classic_shapes_ok(fn, flat_params, net_depth)
    M = g_rgb.shape[0]
    F, W, Fv, Wv = _mlp_dims(flat_params, net_depth)
    Cs = saved_rows(F, W, Wv, net_depth, net_depth_condition, Fv)[-1]
    _dtype_flag(compute_dtype)
    _check(saved, (Cs, _round_up(M, TILE)), fn, 'saved stream',
           saved.device, compute_dtype)
    saved = saved.contiguous()
    # The backward reads the view from the stream's V rows; this [M, Fv]
    # stand-in (no storage of its own) carries the shape to the checks.
    view = torch.zeros(1, device=saved.device).expand(M, Fv)
    return _mlp_grad_launch(
        fn, lambda plan: ([saved.data_ptr()],
                          _round_up(plan['Mp'], plan['mc'])),
        view, g_rgb, g_dens, flat_params, net_depth, net_depth_condition,
        skip_index, compute_dtype)


def mlp_bwd_recompute(x, view, g_rgb, g_dens,
                      flat_params: Sequence[torch.Tensor], net_depth: int,
                      net_depth_condition: int, skip_index: int,
                      compute_dtype):
    """mlp_bwd_saved with the forward re-run by mlp_fwd's kernel chunk by
    chunk (recompute_chunk points at a time) instead of read back: (x
    [M, F], view [M, Fv] f32 per point, head cotangents, params) -> (dx,
    dview, grads).  No level-sized saved stream is allocated."""
    if _on_cpu(x, 'mlp_bwd_recompute'):
        return mlp_bwd_recompute_plain(x, view, g_rgb, g_dens, flat_params,
                                       net_depth, net_depth_condition,
                                       skip_index, compute_dtype)
    fn = 'mlp_bwd_recompute'
    _, _, F, Fv, W, Wv = _mlp_check(fn, x, view, flat_params, net_depth,
                                    net_depth_condition, compute_dtype)
    x, view = x.contiguous(), view.contiguous()
    ws, bs, w_ptrs, b_ptrs = _kernel_params(flat_params, compute_dtype)
    wt, wt_ptrs = _tf32_ptrs(flat_params, net_depth, net_depth_condition,
                             skip_index, compute_dtype, classic=True)
    Cs = saved_rows(F, W, Wv, net_depth, net_depth_condition, Fv)[-1]
    scratch = []

    def mode_args(plan):
        chunk = recompute_chunk(plan['Mp'], plan['mc'])
        scratch.append(torch.empty((Cs, min(chunk, plan['Mp'])),
                                   dtype=compute_dtype, device=x.device))
        return [x.data_ptr(), view.data_ptr(), ctypes.addressof(w_ptrs),
                ctypes.addressof(b_ptrs),
                None if wt is None else ctypes.addressof(wt_ptrs),
                scratch[0].data_ptr(), chunk], chunk
    return _mlp_grad_launch(fn, mode_args, view, g_rgb, g_dens, flat_params,
                            net_depth, net_depth_condition, skip_index,
                            compute_dtype)


class _Classic(torch.autograd.Function):
    """fused_mlp with its backward: 'save' keeps the stream of
    mlp_save_fwd, 'recompute' keeps only x and view; the backward returns
    the input cotangents dx and dview with the parameter gradients."""

    @staticmethod
    def forward(ctx, x, view, mode, cfg, *flat):
        ctx.mode, ctx.cfg, ctx.n_flat = mode, cfg, len(flat)
        if mode == 'save':
            rgb, density, saved = mlp_save_fwd(x, view, flat, *cfg)
            ctx.save_for_backward(saved, *flat)
        else:
            rgb, density = mlp_fwd(x, view, flat, *cfg)
            ctx.save_for_backward(x, view, *flat)
        return rgb, density

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rgb, g_dens):
        saved = ctx.saved_tensors
        kept, flat = saved[:-ctx.n_flat], saved[-ctx.n_flat:]
        g_rgb, g_dens = g_rgb.float().contiguous(), g_dens.float().contiguous()
        if ctx.mode == 'save':
            dx, dview, grads = mlp_bwd_saved(g_rgb, g_dens, kept[0], flat,
                                             *ctx.cfg)
        else:
            dx, dview, grads = mlp_bwd_recompute(kept[0], kept[1], g_rgb,
                                                 g_dens, flat, *ctx.cfg)
        return (dx, dview, None, None,
                *[g.reshape(p.shape) for g, p in zip(grads, flat)])


def fused_mlp(x, view, flat_params, net_depth: int, net_depth_condition: int,
              skip_index: int, compute_dtype=torch.bfloat16,
              mode: str = 'recompute'):
    """The Mip-NeRF MLP with input gradients: (x [M, F], view [M, Fv] per
    point, flat params) -> (rgb [M, 3], density [M, nd]) f32 raw heads,
    the JAX `fused_mlp` in its argument order.

    mode='recompute': the backward re-runs the forward chunk by chunk.
    mode='save': the forward also keeps every activation in the compute
    dtype and the backward reads them back.  The backward returns dx, dview
    and the parameter gradients.  Without gradients (a render) both modes
    run mlp_fwd: the stream would be the same values, unread."""
    if mode not in CLASSIC_MODES:
        raise ValueError(f'fused_mlp: mode must be one of {CLASSIC_MODES}, '
                         f'got {mode!r}')
    cfg = (net_depth, net_depth_condition, skip_index, compute_dtype)
    x, view = x.float(), view.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, view, *flat_params)):
        return _Classic.apply(x, view, mode, cfg, *flat_params)
    return mlp_fwd(x, view, flat_params, *cfg)
