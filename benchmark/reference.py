"""Plain float32 reference of the benchmark's configurations.

Mip-NeRF (arXiv:2103.13415; the semantics of the upstream `models/mip.py`,
`internal/math.py` and `train.py`) written from its equations in plain
torch: stratified sampling, conical-frustum Gaussians, the integrated
positional encoding, the 8x256 MLP with its skip and view branch,
volumetric compositing, blurpool resampling from the coarse weights, the
masked MSE of both levels plus the distortion loss of mip-NeRF 360
(arXiv:2111.12077, eq. 15, as the O(N^2) double sum), Adam and the mip LR
schedule.  With `nerf.unbounded` the configuration's unbounded mode: the
levels sample in inverse depth, the Gaussians (full covariances) are
contracted into the ball of radius 2 by their Jacobian (360's eq. 10-11)
and encoded on the 21 icosahedral directions of the configuration.

It imports nothing of the program and takes nothing the program made: the
rays are worked out here from the scene files the benchmark wrote (camera
poses, intrinsics and images, read back by each scene kind's `views` in
benchmark/scenes/ into `Views`), the batches from the seeded draw the data
pipeline's specification names (numpy's default_rng(seed).integers over
every training ray, one draw of K x B a dispatch), the stratified and
resampling jitter from one torch.Generator a step seeded from (seed, step),
and the weights are the ones the benchmark made.  Matrix products run with
TF32 off unless `precision` is 'tf32' (the control): then on a card with
TF32 on, and on the CPU with both operands rounded to TF32's 10-bit
mantissa; 'f64' and '3xtf32' are witnesses a calibration reads.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
F32_EPS = float(np.finfo(np.float32).eps)

# The configuration's icosahedral directions (columns), frozen.
ICOSA = np.array(
    [[0.8506508, 0.0, 0.5257311], [0.809017, 0.5, 0.309017],
     [0.5257311, 0.8506508, 0.0], [1.0, 0.0, 0.0],
     [0.809017, 0.5, -0.309017], [0.8506508, 0.0, -0.5257311],
     [0.309017, 0.809017, -0.5], [0.0, 0.5257311, -0.8506508],
     [0.5, 0.309017, -0.809017], [0.0, 1.0, 0.0],
     [-0.5257311, 0.8506508, 0.0], [-0.309017, 0.809017, -0.5],
     [0.0, 0.5257311, 0.8506508], [-0.309017, 0.809017, 0.5],
     [0.309017, 0.809017, 0.5], [0.5, 0.309017, 0.809017],
     [0.5, -0.309017, 0.809017], [0.0, 0.0, 1.0],
     [-0.5, 0.309017, 0.809017], [-0.809017, 0.5, 0.309017],
     [-0.809017, 0.5, -0.309017]], dtype=np.float32).T


class RayBatch(NamedTuple):
    origins: torch.Tensor    # [B, 3]
    directions: torch.Tensor  # [B, 3]
    viewdirs: torch.Tensor   # [B, 3]
    radii: torch.Tensor      # [B, 1]
    near: torch.Tensor       # [B, 1]
    far: torch.Tensor        # [B, 1]


# -- the scene's rays ------------------------------------------------------

def load_png(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float64) / 255.0


class Views:
    """Cameras and images of one split: every view h x w, its [3, 4]
    camera-to-world, a pixel -> camera-direction matrix (pixel centres
    folded in), near / far, and the RGB targets."""

    def __init__(self, c2w, pix2cam, near, far, images, h, w):
        self.c2w, self.pix2cam = c2w, pix2cam
        self.near, self.far = near, far
        self.images, self.h, self.w = images, h, w

    @property
    def num_rays(self) -> int:
        return len(self.c2w) * self.h * self.w

    def _dirs(self, view, y, x):
        pix = np.stack([x, y, np.ones_like(x)], -1).astype(np.float64)
        cam = pix @ self.pix2cam.T
        return np.einsum('bij,bj->bi', self.c2w[view][:, :, :3], cam)

    def rays(self, index: np.ndarray, device) -> RayBatch:
        """The rays of flat indices (view-major, then row, then column)."""
        view, rem = np.divmod(np.asarray(index), self.h * self.w)
        y, x = np.divmod(rem, self.w)
        d = self._dirs(view, y, x)
        # The cone radius from the distance to the next row's direction
        # (the last row takes the one before it), widened to the radius of
        # a disc of the pixel's footprint variance: dx * 2 / sqrt(12).
        yn = np.where(y == self.h - 1, y - 1, y + 1)
        dx = np.linalg.norm(d - self._dirs(view, yn, x), axis=-1)
        radii = dx * 2 / np.sqrt(12)
        o = self.c2w[view][:, :, 3]

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return RayBatch(t(o), t(d), t(d / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)),
                        t(radii[:, None]), t(self.near[view][:, None]),
                        t(self.far[view][:, None]))

    def pixels(self, index: np.ndarray, device) -> torch.Tensor:
        view, rem = np.divmod(np.asarray(index), self.h * self.w)
        y, x = np.divmod(rem, self.w)
        return torch.as_tensor(
            np.stack([self.images[v][yy, xx] for v, yy, xx in
                      zip(view, y, x)]).astype(np.float32), device=device)


def batch_indices(num_rays: int, seed: int, k: int, b: int) -> np.ndarray:
    """The first dispatch's [k, b] ray indices of the data pipeline's
    specification: one default_rng(seed).integers draw of k * b."""
    rng = np.random.default_rng(int(seed))
    return rng.integers(0, num_rays, size=(k * b,)).reshape(k, b)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """Step `step`'s jitter generator, seeded from (seed, step)."""
    s = np.random.SeedSequence([int(seed), int(step)])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0] >> 1))


# -- the model -------------------------------------------------------------

def xyz_features(hp) -> int:
    if hp.get('nerf.unbounded'):
        return 2 * ICOSA.shape[1]
    return 6 * (hp['nerf.max_deg_point'] - hp['nerf.min_deg_point'])


def view_features(hp) -> int:
    return 3 * (2 * hp['nerf.deg_view'] + int(bool(hp['nerf.append_identity'])))


def mlp_layout(hp) -> List[tuple]:
    """[(parameter prefix, fan in, fan out)] of the MLP in its layer order:
    the trunk (the encode appended after every skip_index-th layer), the
    density head, the bottleneck, the view layers and the rgb head."""
    depth, width = hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_width']
    skip, fx = hp['nerf.mlp.skip_index'], xyz_features(hp)
    layers, d_in = [], fx
    for i in range(depth):
        layers.append((f'mlp.trunk_{i}', d_in, width))
        d_in = width + (fx if i % skip == 0 and i > 0 else 0)
    layers.append(('mlp.density', d_in, hp['nerf.mlp.num_density_channels']))
    layers.append(('mlp.bottleneck', d_in, width))
    d_v = width + view_features(hp)
    for j in range(hp['nerf.mlp.net_depth_condition']):
        layers.append((f'mlp.view_{j}', d_v, hp['nerf.mlp.net_width_condition']))
        d_v = hp['nerf.mlp.net_width_condition']
    layers.append(('mlp.rgb', d_v, hp['nerf.mlp.num_rgb_channels']))
    return layers


class Precision:
    """How the MLP's products run: 'f32' (TF32 off), 'tf32', or '3xtf32'
    (each product as three TF32 products of the operands' high and low
    halves, the float32 emulation of the port's kernels; a witness of the
    round-off they carry, on a card only)."""

    def __init__(self, name: str, device):
        self.name, self.device = name, torch.device(device)

    @contextlib.contextmanager
    def scope(self):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.name in ('tf32', '3xtf32') and self.device.type == 'cuda'
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def linear(self, x, w, b):
        if self.name == 'tf32' and self.device.type != 'cuda':
            return _LinearTF32.apply(x, w, b)
        if self.name == '3xtf32':
            return _Linear3xTF32.apply(x, w, b)
        return F.linear(x, w, b)


def _round_tf32(x):
    """Round float32 to TF32's 10 explicit mantissa bits (to nearest)."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _LinearTF32(torch.autograd.Function):
    """x @ w.T + b with every product's operands rounded to TF32 and
    accumulated in float32, forward and backward, as TF32 tensor cores
    compute them."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = _round_tf32(x), _round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = _round_tf32(g)
        return gr @ wr, gr.t() @ xr, g.sum(0)


def _mm_3xtf32(a, b):
    """a @ b as TF32 products of the halves: hi hi + (hi lo + lo hi)."""
    a_hi, b_hi = _round_tf32(a), _round_tf32(b)
    a_lo, b_lo = a - a_hi, b - b_hi
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


class _Linear3xTF32(torch.autograd.Function):
    """x @ w.T + b with every product, forward and backward, on 3xTF32
    (TF32 on, set by Precision.scope)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _mm_3xtf32(x, w.t()) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _mm_3xtf32(g, w), _mm_3xtf32(g.t(), x), g.sum(0)


def mlp(params, prec: Precision, hp, x, view):
    """x [P, F] encoded samples, view [P, Fv] -> (raw rgb [P, 3], raw
    density [P, 1])."""
    def dense(name, t):
        return prec.linear(t, params[name + '.weight'], params[name + '.bias'])
    inputs, skip = x, hp['nerf.mlp.skip_index']
    for i in range(hp['nerf.mlp.net_depth']):
        x = torch.relu(dense(f'mlp.trunk_{i}', x))
        if i % skip == 0 and i > 0:
            x = torch.cat([x, inputs], -1)
    raw_density = dense('mlp.density', x)
    x = torch.cat([dense('mlp.bottleneck', x), view], -1)
    for j in range(hp['nerf.mlp.net_depth_condition']):
        x = torch.relu(dense(f'mlp.view_{j}', x))
    return dense('mlp.rgb', x), raw_density


def _frustum(t0, t1, radii):
    """Mip-NeRF eq. 7: the frustum's (t mean, t variance, r variance)."""
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    den = 3 * mu ** 2 + hw ** 2
    t_mean = mu + 2 * mu * hw ** 2 / den
    t_var = hw ** 2 / 3 - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) / den ** 2
    r_var = radii ** 2 * (mu ** 2 / 4 + (5 / 12) * hw ** 2
                          - (4 / 15) * hw ** 4 / den)
    return t_mean, t_var, r_var


def gaussians(t, rays: RayBatch, full: bool):
    """Segments of fenceposts t [B, N+1] -> means [B, N, 3] and covariances
    [B, N, 3] (diagonal) or [B, N, 3, 3]."""
    t_mean, t_var, r_var = _frustum(t[:, :-1], t[:, 1:], rays.radii)
    d = rays.directions
    mean = rays.origins[:, None] + d[:, None] * t_mean[..., None]
    d2 = torch.clamp((d ** 2).sum(-1, keepdim=True), min=1e-10)
    if not full:
        cov = (t_var[..., None] * (d ** 2)[:, None]
               + r_var[..., None] * (1 - d ** 2 / d2)[:, None])
        return mean, cov
    outer = d[:, :, None] * d[:, None, :]
    null = torch.eye(3, device=d.device, dtype=d.dtype) - outer / d2[..., None]
    return mean, (t_var[..., None, None] * outer[:, None]
                  + r_var[..., None, None] * null[:, None])


def ipe(mean, cov, lo: int, hi: int):
    """Integrated positional encoding (diagonal): E[sin] of y = 2^l x,
    degree-major, the sines then the cosines as sin(y + pi/2)."""
    scales = 2.0 ** torch.arange(lo, hi, device=mean.device,
                                 dtype=mean.dtype)
    y = (mean[..., None, :] * scales[:, None]).flatten(-2)
    y_var = (cov[..., None, :] * scales[:, None] ** 2).flatten(-2)
    both = torch.cat([y, y + 0.5 * math.pi], -1)
    return torch.exp(-0.5 * torch.cat([y_var, y_var], -1)) * torch.sin(both)


def ipe_360(mean, cov):
    """Contract the Gaussians by the Jacobian of x -> (2 - 1/|x|) x/|x|
    where |x| > 1, then the IPE on the icosahedral directions P:
    E[sin] of y = P^T x with var diag(P^T cov P)."""
    n = torch.clamp(mean.norm(dim=-1, keepdim=True), min=1e-10)
    u = mean / n
    g = (2 - 1 / n) / n
    eye = torch.eye(3, device=mean.device, dtype=mean.dtype)
    jac = (g[..., None] * eye
           + (1 / n ** 2 - g)[..., None] * u[..., :, None] * u[..., None, :])
    outside = n > 1
    mean = torch.where(outside, (2 - 1 / n) * u, mean)
    cov = torch.where(outside[..., None], jac @ cov @ jac.transpose(-1, -2),
                      cov)
    p = torch.as_tensor(ICOSA, device=mean.device, dtype=mean.dtype)
    y = mean @ p
    y_var = ((cov @ p) * p).sum(-2)
    both = torch.cat([y, y + 0.5 * math.pi], -1)
    return torch.exp(-0.5 * torch.cat([y_var, y_var], -1)) * torch.sin(both)


def view_encoding(viewdirs, deg: int, identity: bool):
    scales = 2.0 ** torch.arange(0, deg, device=viewdirs.device,
                                 dtype=viewdirs.dtype)
    xb = (viewdirs[..., None, :] * scales[:, None]).flatten(-2)
    feats = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], -1))
    return torch.cat([viewdirs, feats], -1) if identity else feats


def stratified(lo, hi, n: int, randomized: bool, gen):
    """n + 1 fenceposts from lo to hi [B, 1], each jittered within its
    neighbours' midpoints."""
    s = torch.linspace(0, 1, n + 1, device=lo.device, dtype=lo.dtype)
    t = lo * (1 - s) + hi * s
    if not randomized:
        return t
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    upper = torch.cat([mids, t[:, -1:]], -1)
    lower = torch.cat([t[:, :1], mids], -1)
    u = torch.rand(t.shape, device=t.device, generator=gen).to(t.dtype)
    return lower + (upper - lower) * u


def resample(bins, weights, padding: float, randomized: bool, gen):
    """Blurpool the weights (2-tap max, 2-tap mean, + padding), then
    inverse-CDF samples of their piecewise-constant PDF over bins [B, M+1]
    -> [B, M+1] ascending, each u compared with every CDF entry."""
    wp = torch.cat([weights[:, :1], weights, weights[:, -1:]], -1)
    wm = torch.maximum(wp[:, :-1], wp[:, 1:])
    w = 0.5 * (wm[:, :-1] + wm[:, 1:]) + padding
    wsum = w.sum(-1, keepdim=True)
    pad = torch.clamp(1e-5 - wsum, min=0)
    w, wsum = w + pad / w.shape[-1], wsum + pad
    cdf = torch.clamp(torch.cumsum(w / wsum, -1)[:, :-1], max=1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf,
                     torch.ones_like(cdf[:, :1])], -1)
    m = bins.shape[-1]
    if randomized:
        s = 1.0 / m
        u = torch.arange(m, device=bins.device, dtype=bins.dtype) * s
        u = u + torch.rand(bins.shape, device=bins.device,
                           generator=gen).to(bins.dtype) * (s - F32_EPS)
        u = torch.clamp(u, max=1 - F32_EPS)
    else:
        u = torch.linspace(0, 1 - F32_EPS, m, device=bins.device,
                           dtype=bins.dtype).expand(bins.shape)
    below = u[:, None, :] >= cdf[:, :, None]                  # [B, M+1, S]

    def interval(v):
        lo = torch.where(below, v[:, :, None], v[:, :1, None]).amax(1)
        hi = torch.where(~below, v[:, :, None], v[:, -1:, None]).amin(1)
        return lo, hi
    b0, b1 = interval(bins)
    c0, c1 = interval(cdf)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def composite(rgb, density, t, directions, white_bkgd: bool):
    """Alpha compositing over fenceposts t [B, N+1] (ascending distance)."""
    delta = (t[:, 1:] - t[:, :-1]) * directions.norm(dim=-1, keepdim=True)
    dd = density * delta
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[:, :1]),
                                  torch.cumsum(dd[:, :-1], -1)], -1))
    weights = (1 - torch.exp(-dd)) * trans
    comp = (weights[..., None] * rgb).sum(1)
    acc = weights.sum(-1)
    if white_bkgd:
        comp = comp + (1 - acc[:, None])
    return comp, acc, weights


class Level(NamedTuple):
    rgb: torch.Tensor
    acc: torch.Tensor
    weights: torch.Tensor
    t: torch.Tensor      # ascending fenceposts the distortion loss uses


def render_rays(params, rays: RayBatch, hp, randomized: bool, gen,
                prec: Precision) -> List[Level]:
    """Both levels of the rays, coarse first."""
    n = hp['nerf.num_samples']
    unbounded = bool(hp.get('nerf.unbounded'))
    view = view_encoding(rays.viewdirs, hp['nerf.deg_view'],
                         bool(hp['nerf.append_identity']))
    levels, t, weights = [], None, None
    for level in range(hp['nerf.num_levels']):
        if unbounded:
            # s = 1/t ascending here; the program's t_inv is its flip.
            if level == 0:
                s = torch.flip(stratified(1 / rays.near, 1 / rays.far, n,
                                          randomized, gen), (-1,))
            else:
                s = resample(s, weights, hp['nerf.resample_padding'],
                             randomized, gen).detach()
            t = torch.flip(1 / s, (-1,))
            mean, cov = gaussians(t, rays, full=True)
            enc = ipe_360(mean, cov)
        else:
            if level == 0:
                t = stratified(rays.near, rays.far, n, randomized, gen)
            else:
                t = resample(t, weights, hp['nerf.resample_padding'],
                             randomized, gen).detach()
            mean, cov = gaussians(t, rays, full=False)
            enc = ipe(mean, cov, hp['nerf.min_deg_point'],
                      hp['nerf.max_deg_point'])
        b, m = enc.shape[:2]
        raw_rgb, raw_density = mlp(
            params, prec, hp, enc.reshape(b * m, -1),
            view[:, None].expand(b, m, view.shape[-1]).reshape(b * m, -1))
        pad = hp['nerf.rgb_padding']
        rgb = torch.sigmoid(raw_rgb).reshape(b, m, 3) * (1 + 2 * pad) - pad
        density = F.softplus(raw_density.reshape(b, m)
                             + hp['nerf.density_bias'])
        if unbounded:
            # Samples run in ascending distance t; the weights go back to
            # the order of s for the resampling and the distortion loss.
            comp, acc, w_t = composite(rgb, density, t, rays.directions,
                                       bool(hp['train.white_bkgd']))
            weights = w_t.flip(-1)
            levels.append(Level(comp, acc, weights, s))
        else:
            comp, acc, weights = composite(rgb, density, t, rays.directions,
                                           bool(hp['train.white_bkgd']))
            levels.append(Level(comp, acc, weights, t))
    return levels


def distortion(weights, t):
    """mip-NeRF 360's distortion loss, batch mean of sum_ij w_i w_j |m_i -
    m_j| + 1/3 sum_i w_i^2 (t_i+1 - t_i), t ascending."""
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    pair = (weights[:, :, None] * weights[:, None, :]
            * (mids[:, :, None] - mids[:, None, :]).abs()).sum((1, 2))
    uni = (weights ** 2 * (t[:, 1:] - t[:, :-1])).sum(-1) / 3
    return (pair + uni).mean()


def loss(levels: List[Level], pixels, hp, rows=None):
    """The fine level's MSE + distloss_mult x its distortion, plus
    coarse_loss_mult x the same of each coarser level.  `rows` keeps a
    slice of the batch (the half-batch fault)."""
    total = 0.0
    for i, lv in enumerate(levels):
        rgb, w, t, gt = lv.rgb, lv.weights, lv.t, pixels
        if rows is not None:
            rgb, w, t, gt = rgb[rows], w[rows], t[rows], gt[rows]
        mse = ((rgb - gt) ** 2).sum() / rgb.shape[0]
        term = mse + hp['loss.distloss_mult'] * distortion(w, t)
        last = i == len(levels) - 1
        total = total + (term if last else hp['loss.coarse_loss_mult'] * term)
    return total


def learning_rate(hp, step: int) -> float:
    """The mip LR schedule: log-linear lr_init -> lr_final over max_steps,
    times the sine-eased delay lr_delay_mult -> 1 over lr_delay_steps."""
    delay = hp['optimizer.lr_delay_steps']
    mult = hp['optimizer.lr_delay_mult']
    rate = (mult + (1 - mult) * math.sin(0.5 * math.pi
                                        * min(max(step / delay, 0), 1))
            if delay > 0 else 1.0)
    t = min(max(step / hp['optimizer.max_steps'], 0), 1)
    return rate * math.exp(math.log(hp['optimizer.lr_init']) * (1 - t)
                           + math.log(hp['optimizer.lr_final']) * t)


def train(params0: Dict[str, torch.Tensor], batches, hp, seed: int,
          precision: str = 'f32', half_batch: bool = False,
          row_chunks: int = 1) -> dict:
    """Adam steps from params0 over batches [(RayBatch, pixels)], step k
    jittered by step_generator(seed, k) -> {'loss': [float a step],
    'grad': the first step's gradients, 'params': the parameters after
    the last step}.  `precision` 'f64' runs it all in float64 (a witness
    of the round-off a float32 run carries); `row_chunks` > 1 sums each
    gradient over that many slices of the batch's rows, another order of
    the same float32 sums (a witness of float32's own spread)."""
    device = next(iter(params0.values())).device
    prec = Precision(precision, device)
    dtype = torch.float64 if precision == 'f64' else torch.float32
    params = {k: v.detach().clone().to(dtype) for k, v in params0.items()}
    batches = [(RayBatch(*(f.to(dtype) for f in rays)), pixels.to(dtype))
               for rays, pixels in batches]
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {'loss': []}
    with prec.scope():
        for step, (rays, pixels) in enumerate(batches):
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            levels = render_rays(leaves, rays, hp, bool(hp['train.randomized']),
                                 step_generator(seed, step, device), prec)
            n = pixels.shape[0]
            if half_batch:
                value = loss(levels, pixels, hp, slice(0, n // 2))
                grads = torch.autograd.grad(value, list(leaves.values()))
            elif row_chunks > 1:
                value, grads = 0.0, None
                bounds = np.linspace(0, n, row_chunks + 1).astype(int)
                for i, (a, z) in enumerate(zip(bounds[:-1], bounds[1:])):
                    part = (loss(levels, pixels, hp, slice(a, z))
                            * ((z - a) / n))
                    g = torch.autograd.grad(part, list(leaves.values()),
                                            retain_graph=i < row_chunks - 1)
                    grads = g if grads is None else [
                        x + y for x, y in zip(grads, g)]
                    value = value + part.detach()
            else:
                value = loss(levels, pixels, hp)
                grads = torch.autograd.grad(value, list(leaves.values()))
            out['loss'].append(float(value.detach()))
            if step == 0:
                out['grad'] = {k: g.detach().clone()
                               for k, g in zip(leaves, grads)}
            lr = learning_rate(hp, step)
            with torch.no_grad():
                for (k, p), g in zip(leaves.items(), grads):
                    m[k] = B1 * m[k] + (1 - B1) * g
                    v2[k] = B2 * v2[k] + (1 - B2) * g * g
                    m_hat = m[k] / (1 - B1 ** (step + 1))
                    v_hat = v2[k] / (1 - B2 ** (step + 1))
                    params[k] = (p - lr * m_hat
                                 / (torch.sqrt(v_hat) + ADAM_EPS)).detach()
            del levels, value, grads, leaves
    out['params'] = {k: v.float() for k, v in params.items()}
    out['grad'] = {k: v.float() for k, v in out['grad'].items()}
    return out


@torch.no_grad()
def render(params, rays: RayBatch, hp, chunk: int,
           precision: str = 'f32') -> Dict[str, torch.Tensor]:
    """Both levels of rays with no jitter, `chunk` rays at a time ->
    {'coarse_rgb', 'fine_rgb', 'acc'}."""
    device = rays.origins.device
    prec = Precision(precision, device)
    parts = []
    with prec.scope():
        for i in range(0, rays.origins.shape[0], chunk):
            part = RayBatch(*(f[i:i + chunk] for f in rays))
            levels = render_rays(params, part, hp, False, None, prec)
            parts.append((levels[0].rgb, levels[-1].rgb, levels[-1].acc))
    return {name: torch.cat(col) for name, col in
            zip(('coarse_rgb', 'fine_rgb', 'acc'), zip(*parts))}
