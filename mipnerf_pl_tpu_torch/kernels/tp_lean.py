"""The tensor-parallel lean MLP: Megatron pair kernels (CUDA, sm_90a) under
a (data, model) mesh.

Counterpart of mipnerf_pl_tpu/kernels/tp_lean.py.  The trunk runs in
Megatron pairs: an even layer column-parallel, the odd layer after it
row-parallel.  Per pair and model shard ONE kernel computes

    partial = relu(h @ Wcol_local + bcol_local) @ Wrow_local

with the [rows, W / n] hidden activation kept on the chip, and the pair
boundary is one f32 sum over the mesh's `model` axis.  The two TPU kernels
become two hand-written kernels in csrc/tp_pair.cu, one wrapper each:

  tp_pair_fwd  `_pair_kernel` behind `_pair_call`: x [M, f_in] (f32 encode
               rows for the first pair, the compute dtype after), Wcol
               [f_in, W/n], bcol [1, W/n], Wrow [W/n, W] -> [M, W] f32
  tp_pair_bwd  `_pair_bwd_kernel` behind `_pair_bwd_call`: the same inputs
               and g [M, W] f32 -> dx [M, f_in], dWcol, dbcol, dWrow, f32;
               the hidden activation is recomputed; parameter gradients are
               per-range partial sums added in a fixed order (two runs give
               the same bits)

and `_pair` is the autograd Function over them whose residuals are the
pair's inputs only.  The kernels take a local width W/n that is a multiple
of 16 up to 512 and an output width W that is a multiple of 16; any f_in and
any row count.  At the widths of the slice (`pair_sm90_route` in bf16,
`pair_tf32_route` in f32: W/n a multiple of 64 up to 512, W a multiple of
64) both run on the wgmma / TMA kernel tp_pair_wg_kernel
(csrc/tp_pair_sm90.cuh), bf16 with f32 accumulators or 3xTF32, whose f32
form reads the transposed products' B split into tf32 hi and lo
(`pair_tf32_weights`, made once a call); other widths keep the mma.sync
kernels.  A plan the rule's kernel cannot make raises.  Each wrapper takes
its plain version (`_pair_plain`, `_pair_bwd_plain`) for tensors on the CPU,
and only there; on a CUDA tensor it launches its kernel or raises.
Launches are counted in kernels.mlp's `launches`, the kernel each call ran
on in its `pair_sm90_routes`, `pair_tf32_routes` and `pair_mma_routes`.

`tp_mlp_forward` is the MLP forward over a `parallel.mesh.Mesh`, at any
shape the JAX system trains under a model axis: rows split over `data`,
the trunk pairs, an odd depth's last layer, the bottleneck and the layer
that reads it over `model`.  The skip concat may land inside a pair (that
pair's row kernel is split into sharded h-rows and a replicated x-rows
panel whose term model rank 0 adds, once), at a pair boundary (the next
pair's column layer reads concat([h, x])) or after the last layer (the
heads read it).  Everything outside the pairs (the x-term, an odd depth's
last layer, the heads, the bottleneck and the layer after it) is
torch.matmul, as the JAX code leaves it to XLA.  The collectives are
Megatron's operators as the mesh provides them: into a column-parallel
product `copy_to_model` (identity forward, a sum over `model` backward),
out of a row-parallel one `reduce_from_model` (a sum forward, identity
backward), out of a column-parallel layer read whole `gather_from_model`.
Biases of odd layers and all heads are replicated and act after a sum: on
a single-process mesh they are computed once, on a multi-process mesh
every rank computes the same values and the same gradients for them.
`model_split_rows` is the one table of what is split and how: of the
compute, of the gradients' sums and of the panels of parameters and Adam
moments a process of a multi-process mesh holds (system.py), which this
function takes as they are (`local`).  `tp_lean_forward` is the
counterpart of the JAX function: its checks, then this split.

Its caller is the MLP under a model axis (models/mlp.py, MipNeRFSystem
with `parallel.model_axis > 1`): the training forward of every backend,
on the mesh's `model_view`, the pairs in these kernels for the Pallas
backends and in their plain versions (`plain=True`) for `xla`.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from mipnerf_pl_tpu_torch.kernels.mlp import (TILE, WGRAD_TILE, _call,
                                              _check, _dtype_flag, _on_cpu,
                                              _ptr_array, _round_up, _rounded,
                                              launches, recompute_chunk,
                                              tf32_split, wgrad_split)
from mipnerf_pl_tpu_torch.parallel.mesh import Mesh

MAX_LOCAL = 512     # widest local panel W / n the kernels' hidden tile takes
MAX_TILES = 192     # output tiles of the backward's weight-gradient products

# The shape rule of tp_pair_wg_kernel (csrc/tp_pair_sm90.cuh pair_wg_route):
# a ring of at least two and at most TP_MAX_STAGES stages (an A slab of 4 KB
# and 8 weight boxes of 4 KB) beside the hidden tile [W/n][64 points] in the
# compute dtype, the ring's three mbarriers a stage, the bias and the
# block's column sums (W/n f32 each), the warps' column partials (2 x 4 x
# 256 f32) and 1 KB of alignment, within the block's shared memory.
TP_MAX_STAGES, TP_STAGE, TP_SMEM_MAX = 4, 4096 + 8 * 4096, 232448


def pair_wg_smem(compute_dtype, Wl: int, stages: int) -> int:
    """Dynamic shared memory of tp_pair_wg_kernel's plan."""
    es = 2 if compute_dtype == torch.bfloat16 else 4
    return (stages * TP_STAGE + Wl * 64 * es + 8 * 3 * TP_MAX_STAGES
            + 4 * (2 * Wl + 2 * 4 * 256) + 1024)


def pair_wg_stages(compute_dtype, Wl: int) -> int:
    """The ring's stages: the most up to TP_MAX_STAGES that fit (0: fewer
    than two)."""
    for stages in range(TP_MAX_STAGES, 1, -1):
        if pair_wg_smem(compute_dtype, Wl, stages) <= TP_SMEM_MAX:
            return stages
    return 0


def _pair_wg_route(compute_dtype, f_in, Wl, Wout):
    return (f_in >= 1 and 64 <= Wl <= MAX_LOCAL and Wl % 64 == 0
            and Wout >= 64 and Wout % 64 == 0
            and pair_wg_stages(compute_dtype, Wl) >= 2)


def pair_sm90_route(compute_dtype, f_in: int, Wl: int, Wout: int) -> bool:
    """Whether tp_pair_fwd and tp_pair_bwd's chain run on the bf16 form of
    tp_pair_wg_kernel: bf16, a local width Wl a multiple of 64 up to
    MAX_LOCAL, an output width a multiple of 64, any f_in (any row count),
    and the plan within the block's shared memory."""
    return (compute_dtype == torch.bfloat16
            and _pair_wg_route(compute_dtype, f_in, Wl, Wout))


def pair_tf32_route(compute_dtype, f_in: int, Wl: int, Wout: int) -> bool:
    """Whether they run on its f32 form (3xTF32): f32 and the same rule."""
    return (compute_dtype == torch.float32
            and _pair_wg_route(compute_dtype, f_in, Wl, Wout))


def pair_tf32_weights(w_col, w_row, backward: bool):
    """The B operands of tp_pair_wg_kernel's f32 form, by product: each
    product's B [K, N] transposed, [N, K], split into [hi; lo] [2 N, K] f32
    (`tf32_split`): P1 Wcol^T [Wl, f_in] with K rounded up to 16 (zero
    columns); forward P2 Wrow^T [Wout, Wl]; backward P3 Wrow [Wl, Wout] and
    P4 Wcol [f_in, Wl] with N rounded up to 64 (zero rows); None where the
    pass has no such product."""
    def split(bt, n_pad=0, k_pad=0):
        bt = torch.nn.functional.pad(bt.float(), (0, k_pad, 0, n_pad))
        return torch.cat(tf32_split(bt), dim=0).contiguous()
    f_in = w_col.shape[0]
    p1 = split(w_col.t(), k_pad=_round_up(f_in, 16) - f_in)
    if not backward:
        return [p1, split(w_row.t()), None, None]
    return [p1, None, split(w_row),
            split(w_col, n_pad=_round_up(f_in, 64) - f_in)]


def _pair_plain(x, w_col, b_col, w_row, dtype):
    """`_pair_kernel` in plain PyTorch: x to the compute dtype, the bias
    added to the f32 sum, ReLU, cast, the second product summed in f32."""
    h = _rounded(x, dtype) @ _rounded(w_col, dtype) + b_col.float()
    return _rounded(torch.relu(h), dtype) @ _rounded(w_row, dtype)


def _pair_bwd_plain(x, w_col, b_col, w_row, g, dtype):
    """`_pair_bwd_kernel` in plain PyTorch -> (dx, dWcol, dbcol, dWrow) f32:
    g cast before every product, the mask from the f32 pre-activation,
    dbcol from the f32 dh, dWcol and dx from the cast one."""
    xr, wc, wr = (_rounded(t, dtype) for t in (x, w_col, w_row))
    hpre = xr @ wc + b_col.float()
    h = _rounded(torch.relu(hpre), dtype)
    gr = _rounded(g, dtype)
    dwr = h.t() @ gr
    dh = torch.where(hpre > 0.0, gr @ wr.t(), 0.0)
    dhd = _rounded(dh, dtype)
    return dhd @ wc.t(), xr.t() @ dhd, dh.sum(0, keepdim=True), dwr


def _pair_check(fn, x, w_col, b_col, w_row, dtype):
    """What the pair kernels take -> (flag, M, f_in, Wl, Wout)."""
    flag = _dtype_flag(dtype)
    dev = x.device
    M, f_in = x.shape
    Wl, Wout = w_row.shape
    if Wl % 16 or not 16 <= Wl <= MAX_LOCAL or Wout % 16 or Wout < 16:
        raise ValueError(f'{fn}: the kernel takes a local width that is a '
                         f'multiple of 16 up to {MAX_LOCAL} and an output '
                         f'width that is a multiple of 16, got {Wl} and '
                         f'{Wout}')
    if x.dtype not in (torch.float32, dtype) or M == 0:
        raise ValueError(f'{fn}: x must be float32 or {dtype} with rows, got '
                         f'{x.dtype} {tuple(x.shape)}')
    _check(x, (M, f_in), fn, 'x', dev, x.dtype)
    _check(w_col, (f_in, Wl), fn, 'w_col', dev, w_col.dtype)
    _check(b_col, (1, Wl), fn, 'b_col', dev, b_col.dtype)
    _check(w_row, (Wl, Wout), fn, 'w_row', dev, w_row.dtype)
    return flag, M, f_in, Wl, Wout


def _pair_call(x, w_col, b_col, w_row, dtype):
    """One model shard's half of a pair -> the f32 partial [M, Wout] before
    the sum over `model`: relu(x @ w_col + b_col) @ w_row."""
    if _on_cpu(x, 'tp_pair_fwd'):
        return _pair_plain(x, w_col, b_col, w_row, dtype)
    fn = 'tp_pair_fwd'
    flag, M, f_in, Wl, Wout = _pair_check(fn, x, w_col, b_col, w_row, dtype)
    x = x.detach().contiguous()
    wc = w_col.detach().to(dtype).contiguous()
    wr = w_row.detach().to(dtype).contiguous()
    bc = b_col.detach().float().reshape(-1).contiguous()
    out = torch.empty((M, Wout), dtype=torch.float32, device=x.device)
    wt = (pair_tf32_weights(wc, wr, backward=False)
          if pair_tf32_route(dtype, f_in, Wl, Wout) else None)
    _call(fn, x.device, x.data_ptr(), wc.data_ptr(), bc.data_ptr(),
          wr.data_ptr(), out.data_ptr(), M, f_in, Wl, Wout,
          int(x.dtype == torch.float32), flag,
          None if wt is None else _ptr_array(wt))
    launches[fn] += 1
    return out


def _pair_bwd_call(x, w_col, b_col, w_row, g, dtype):
    """The pair's backward from its inputs and the partial's cotangent g
    [M, Wout] f32 -> (dx [M, f_in], dWcol [f_in, Wl], dbcol [1, Wl], dWrow
    [Wl, Wout]), all f32."""
    if _on_cpu(x, 'tp_pair_bwd'):
        return _pair_bwd_plain(x, w_col, b_col, w_row, g, dtype)
    fn = 'tp_pair_bwd'
    flag, M, f_in, Wl, Wout = _pair_check(fn, x, w_col, b_col, w_row, dtype)
    dev = x.device
    _check(g, (M, Wout), fn, 'g', dev)
    tiles = -(-f_in // WGRAD_TILE) * -(-Wl // WGRAD_TILE) \
        + -(-Wl // WGRAD_TILE) * -(-Wout // WGRAD_TILE)
    if tiles > MAX_TILES:
        raise ValueError(f'{fn}: widths {f_in} x {Wl} x {Wout} make {tiles} '
                         f'weight-gradient tiles, the kernel takes '
                         f'{MAX_TILES}')
    x, g = x.detach().contiguous(), g.detach().contiguous()
    wc = w_col.detach().to(dtype).contiguous()
    bc = b_col.detach().float().reshape(-1).contiguous()
    Fp = _round_up(f_in, 16)
    wrT = w_row.detach().to(dtype).t().contiguous()
    wcT = torch.zeros((Wl, Fp), dtype=dtype, device=dev)
    wcT[:, :f_in] = wc.t()
    Mp = _round_up(M, TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mc = wgrad_split(Mp, tiles, 1, sms)
    chunk = recompute_chunk(Mp, mc)
    cap = min(chunk, Mp)
    # tp_pair_wg_kernel: one persistent block an SM; the mma.sync chain two.
    wg = (pair_sm90_route(dtype, f_in, Wl, Wout)
          or pair_tf32_route(dtype, f_in, Wl, Wout))
    n_blocks = min(cap // TILE, (1 if wg else 2) * sms)
    wt = (pair_tf32_weights(wc, w_row.detach().float(), backward=True)
          if pair_tf32_route(dtype, f_in, Wl, Wout) else None)
    PW = f_in * Wl + Wl * Wout
    f32 = dict(dtype=torch.float32, device=dev)
    S = torch.empty((Fp + 2 * Wl + Wout, cap), dtype=dtype, device=dev)
    db_part = torch.empty((-(-M // chunk) * n_blocks, Wl), **f32)
    partial = torch.zeros((-(-Mp // mc), PW), **f32)
    dx = torch.empty((M, f_in), **f32)
    dw = torch.empty(PW, **f32)
    db = torch.empty((1, Wl), **f32)
    _call(fn, dev, x.data_ptr(), wc.data_ptr(), bc.data_ptr(),
          wrT.data_ptr(), wcT.data_ptr(), g.data_ptr(), S.data_ptr(),
          dx.data_ptr(), db_part.data_ptr(), n_blocks, partial.data_ptr(),
          mc, chunk, dw.data_ptr(), db.data_ptr(), M, f_in, Wl, Wout,
          int(x.dtype == torch.float32), flag,
          None if wt is None else _ptr_array(wt))
    launches[fn] += 1
    return (dx, dw[:f_in * Wl].view(f_in, Wl), db,
            dw[f_in * Wl:].view(Wl, Wout))


class _Pair(torch.autograd.Function):
    """The differentiable pair: `_pair_call` forward, `_pair_bwd_call`
    backward, or with `plain` their plain versions on any device.  The
    residuals are the pair's inputs only: the hidden activation is
    recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, w_col, b_col, w_row, dtype, plain):
        ctx.save_for_backward(x, w_col, b_col, w_row)
        ctx.dtype, ctx.plain = dtype, plain
        return (_pair_plain if plain else _pair_call)(x, w_col, b_col, w_row,
                                                      dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w_col, b_col, w_row = ctx.saved_tensors
        bwd = _pair_bwd_plain if ctx.plain else _pair_bwd_call
        dx, dwc, dbc, dwr = bwd(x, w_col, b_col, w_row,
                                g.float().contiguous(), ctx.dtype)
        return (dx.to(x.dtype), dwc.to(w_col.dtype), dbc.to(b_col.dtype),
                dwr.to(w_row.dtype), None, None)


def _pair(x, w_col, b_col, w_row, dtype, plain=False):
    return _Pair.apply(x, w_col, b_col, w_row, dtype, plain)


def model_split_rows(flat_params, net_depth: int = 8,
                     net_depth_condition: int = 1,
                     use_viewdirs: bool = True):
    """The table of the model axis's split, one entry a tensor of the lean
    flat layout (kernels.mlp.flatten_params; with no view directions the
    trunk, the density head and the rgb head): (rows, axis), the leading
    rows of the [in, out] tensor that `model` splits and how.

      'col'  a column-parallel slot, kernel and bias: every even trunk layer
             (an odd depth's last layer too) and the bottleneck; all its
             rows, its columns in n panels.
      'row'  the first W rows of a kernel that reads a split activation:
             the odd trunk layers (the skip layer's h-rows of W + F) and the
             layer that reads the bottleneck (view_0, or the rgb head with
             net_depth_condition 0); those rows in n panels.
      (0, None)  replicated: the rest.

    The rows after a 'row' entry's are replicated too: a skip layer's
    x-rows, the view rows of the layer that reads the bottleneck.  Given
    flat params at full shapes the rows are the full tensor's; given a
    model rank's panels (each split region cut to its panel, the
    replicated rows after it) they are the panel's, since W is read from
    trunk_0's columns.  The one table of the split's compute
    (`tp_mlp_forward`), of the gradients' sums and of the state a process
    of a multi-process mesh holds (system.py).

    It differs from the JAX table (mipnerf_pl_tpu/parallel/tp.py
    `_spec_for`, kept by parallel/tp.py) in two places: a skip layer's
    x-rows are replicated where JAX splits all of its rows, and the layer
    that reads the bottleneck is split on its bottleneck rows, not on its
    outputs (JAX: view_0 column-parallel, an rgb head replicated); the view
    layers after view_0, column-parallel in JAX, are replicated here."""
    W = flat_params[0].shape[1]
    table = []
    for i in range(net_depth):
        table += ([(flat_params[2 * i].shape[0], 'col'), (1, 'col')]
                  if i % 2 == 0 else [(W, 'row'), (0, None)])
    table += [(0, None)] * 2                                  # density
    if not use_viewdirs:
        return table + [(0, None)] * 2                        # rgb
    table += [(flat_params[2 * net_depth + 2].shape[0], 'col'), (1, 'col')]
    table += [(W, 'row'), (0, None)]            # view_0, or the rgb head
    return table + [(0, None)] * (2 * net_depth_condition)


def tp_mlp_forward(x, view, flat_params, mesh: Mesh, num_samples: int,
                   net_depth: int = 8, net_depth_condition: int = 1,
                   skip_index: int = 4, compute_dtype=torch.bfloat16,
                   plain: bool = False, local: bool = False):
    """The Megatron split of the MLP at any shape, over `mesh`'s `model`
    axis, data-parallel over its `data` axis; differentiable in x, view
    and every parameter.

    x [M, F] f32 encode rows; view [M / num_samples, Fv] per ray, or None
    with no view directions; `flat_params` the flat layout
    (kernels.mlp.flatten_params) at full shapes, sliced here (`local`
    False), or on a multi-process mesh this model rank's panels
    (`model_split_rows`: the state system.py holds there).  Returns the
    raw heads (rgb [M, 3], density [M, nd]) f32.  `plain` runs the pairs
    on their plain versions.

    The trunk runs in pairs (e, e + 1), e even: one pair kernel a model
    rank, one sum over `model`.  A skip concat after layer e feeds layer
    e + 1 (skips = range(skip_index, net_depth, skip_index)): inside a pair
    the row layer's x-rows are a replicated term that model rank 0 adds
    once (on a multi-process mesh every rank takes the product and the
    others drop it, so the backward's sum over `model` hands every rank
    the gradients of x and of those rows); at a pair boundary the next
    column layer reads concat([h, x]) (f_in = W + F on the same kernel);
    after the last layer the heads read it.  An odd depth's last layer is
    column-parallel alone, its panels gathered (`gather_from_model`).  The
    bottleneck is column-parallel, and the layer that reads it (view_0, or
    the rgb head with net_depth_condition 0) sums its bottleneck rows' panel
    products over `model`, its view rows' per-ray term added to the sum.
    With no view directions the rgb head reads the trunk as the density
    head does.  Everything outside the pairs is torch.matmul."""
    n = mesh.shape['model']
    W = flat_params[0].shape[1]
    if local and not mesh.distributed:
        raise ValueError('a model rank\'s panels are held on a multi-process '
                         'mesh only')
    if not local and W % n:
        raise ValueError(f'net_width {W} not divisible by model={n}')
    table = model_split_rows(flat_params, net_depth, net_depth_condition,
                             view is not None)
    skips = set(range(skip_index, net_depth, skip_index))
    dtype = compute_dtype

    def panel(i, r):
        """Model rank r's panel of split tensor i of the flat layout."""
        t, (rows, axis) = flat_params[i], table[i]
        if local:
            return t if axis == 'col' else t[:rows]
        if axis == 'col':
            w = t.shape[1] // n
            return t[:, r * w:(r + 1) * w]
        return t[r * rows // n:(r + 1) * rows // n]

    def rest(i):
        """The replicated rows of tensor i: all of a replicated one."""
        return flat_params[i][table[i][0]:]

    def dense(h, k, b):
        return h.to(dtype).float() @ k.to(dtype).float() + b.float()

    def body(x, view):
        xs = x.to(dtype)
        h, e = x, 0
        while e < net_depth:
            if e - 1 in skips:              # a skip at the pair boundary
                h = torch.cat([h, xs], dim=-1)
            h_in = mesh.copy_to_model(h)
            if e + 1 == net_depth:          # an odd depth's last layer
                h = mesh.gather_from_model([
                    torch.relu(dense(h_in, panel(2 * e, r),
                                     panel(2 * e + 1, r))).to(dtype)
                    for r in mesh.model_ranks])
                break
            o = e + 1
            partials = []
            for r in mesh.model_ranks:
                partial = _pair(h_in, panel(2 * e, r), panel(2 * e + 1, r),
                                panel(2 * o, r), dtype, plain)
                if e in skips and (r == 0 or mesh.distributed):
                    term = (mesh.copy_to_model(x).to(dtype).float()
                            @ mesh.copy_to_model(rest(2 * o))
                            .to(dtype).float())
                    partial = partial + (term if r == 0 else 0.0 * term)
                partials.append(partial)
            h = mesh.reduce_from_model(partials) + rest(2 * o + 1).float()
            h = torch.relu(h).to(dtype)
            e += 2
        if net_depth - 1 in skips:          # a skip after the last layer
            h = torch.cat([h, xs], dim=-1)
        nd_i = 2 * net_depth
        density = dense(h, flat_params[nd_i], flat_params[nd_i + 1])
        if view is None:
            return dense(h, flat_params[nd_i + 2],
                         flat_params[nd_i + 3]), density
        h_in = mesh.copy_to_model(h)
        v_i = nd_i + 4                      # view_0, or the rgb head
        partials = []
        for r in mesh.model_ranks:
            bottleneck = dense(h_in, panel(nd_i + 2, r),
                               panel(nd_i + 3, r)).to(dtype)
            partials.append(bottleneck.float()
                            @ panel(v_i, r).to(dtype).float())
        per_ray = dense(view, rest(v_i), flat_params[v_i + 1])
        R, wv = per_ray.shape
        y = mesh.reduce_from_model(partials) + per_ray[:, None, :].expand(
            R, num_samples, wv).reshape(-1, wv)
        if net_depth_condition == 0:
            return y, density
        y = torch.relu(y).to(dtype)
        for j in range(1, net_depth_condition):
            y = torch.relu(dense(y, flat_params[v_i + 2 * j],
                                 flat_params[v_i + 2 * j + 1])).to(dtype)
        r_i = v_i + 2 * net_depth_condition
        return dense(y, flat_params[r_i], flat_params[r_i + 1]), density

    outs = [body(xs, vs) for xs, vs in mesh.split_rows(x, view, num_samples)]
    return (torch.cat([o[0] for o in outs], dim=0),
            torch.cat([o[1] for o in outs], dim=0))


def tp_lean_forward(x, view, flat_params, mesh: Mesh, num_samples: int,
                    net_depth: int = 8, net_depth_condition: int = 1,
                    skip_index: int = 4, compute_dtype=torch.bfloat16,
                    plain: bool = False):
    """Forward pass of the lean MLP, tensor-parallel over `mesh`'s `model`
    axis and data-parallel over its `data` axis; differentiable in x, view
    and every parameter: the counterpart of the JAX function, on
    `tp_mlp_forward`.

    x [M, F] f32 encode rows, view [M / num_samples, Fv], `flat_params` the
    lean flat layout (kernels.mlp.flatten_params) at FULL shapes: the
    sharding is internal.  Returns (raw_rgb [M, 3], raw_density [M, nd])
    f32, the raw heads of the single-device lean forward.  On a
    single-process mesh x and view are the whole batch, whose rays must
    divide among the data shards; on a multi-process mesh they are this
    process's rows.

    Requirements (the JAX function's): even net_depth, even skip_index (so
    the skip concat lands inside a pair), trunk width divisible by the
    model-axis size.  `tp_mlp_forward` takes the other shapes.  `plain`
    runs the pairs on their plain versions (`_pair_plain`,
    `_pair_bwd_plain`) on any device, launching no kernel.
    """
    n_model = mesh.shape['model']
    if net_depth % 2:
        raise ValueError('tp_lean_forward needs an even net_depth')
    if skip_index % 2:
        raise ValueError('tp_lean_forward needs an even skip_index')
    W = flat_params[0].shape[1]
    if W % n_model:
        raise ValueError(f'net_width {W} not divisible by model={n_model}')
    return tp_mlp_forward(x, view, flat_params, mesh, num_samples, net_depth,
                          net_depth_condition, skip_index, compute_dtype,
                          plain)
