"""Smoke run of the PyTorch port's render path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):
  1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  2. build the CUDA kernels from mipnerf_pl_tpu_torch/csrc with nvcc
     (sm_90a) and time the build;
  3. each kernel's wrapper against its plain PyTorch version at the lego
     shape (8x256 MLP, N = 128, one 8192-ray chunk) on numpy-seeded inputs:
     f32 max |d| <= 1e-4, bf16 max |d| / max |ref| <= 3e-2 against the f32
     plain version; CUDA-event times of both;
  4. the slice through its entry point: MipNeRFSystem (default lego schema,
     val.mlp_backend auto) -> render_camera of a 200x200 Blender view with
     seeded params (through convert.jax_params_to_torch); every kernel must
     launch 2 levels x 5 chunks times, the image must be finite, and the
     same frame through the plain path on the card must agree
     (max |d rgb|, max |d acc| <= 1e-3 in f32);
  5. the kernels' JSON line, the card's name and power limit, and last the
     line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --measure

adds, before phase 5, the frame times at 800x800 (kernel and plain paths,
f32 and bf16, in turns k p p k) and a torch.profiler table of one 200x200
kernel-path frame.

It imports torch, numpy and the port; never JAX.  With no CUDA device it
exits non-zero before printing any result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.convert import jax_params_to_torch
from mipnerf_pl_tpu_torch.kernels import _build
from mipnerf_pl_tpu_torch.kernels import mlp as km
from mipnerf_pl_tpu_torch.ops.camera import Camera, pix2cam_from_focal
from mipnerf_pl_tpu_torch.ops.math import cast_rays_cmajor, pos_enc
from mipnerf_pl_tpu_torch.ops.render import delta_mids
from mipnerf_pl_tpu_torch.ops.sampling import sample_along_rays
from mipnerf_pl_tpu_torch.system import MipNeRFSystem
from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses

CHUNK = 8192            # rays per level-chunk (val.chunk_size)
SIDE = 200              # frame side: 40000 rays = 5 chunks
FULL_SIDE = 800         # the lego test views' size (--measure)
F32_BAR = 1e-4
BF16_BAR = 3e-2
FRAME_BAR = 1e-3
ACT = (0.001, -1.0)


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flax_tree(system: MipNeRFSystem, seed: int) -> dict:
    """Numpy-seeded flax-layout params (Xavier-uniform kernels [in, out],
    zero biases) for the system's MLP, as the JAX package initializes."""
    rng = np.random.default_rng(seed)
    mlp = {}
    for key, value in system.eval_model.state_dict().items():
        _, name, kind = key.split('.')
        if kind == 'weight':
            fan_out, fan_in = value.shape
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            mlp.setdefault(name, {})['kernel'] = rng.uniform(
                -lim, lim, size=(fan_in, fan_out)).astype(np.float32)
        else:
            mlp.setdefault(name, {})['bias'] = np.zeros(value.shape,
                                                        np.float32)
    return {'params': {'mlp': mlp}}


def chunk_inputs(hp, dev, seed=0):
    """One level-chunk of the main path from numpy-seeded rays around the
    radius-4 orbit: moments [6, M], view [R, 27], delta/mids [R, N]."""
    rng = np.random.default_rng(seed)
    R, N = CHUNK, hp['nerf.num_samples']
    origins = rng.normal(size=(R, 3)) * 0.1 + np.array([0.0, 3.2, 2.35])
    target = rng.uniform(-1.0, 1.0, size=(R, 3))
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa
    o, d = t(origins), t(dirs)
    radii = t(np.full((R, 1), 5e-4))
    near, far = t(np.full((R, 1), 2.0)), t(np.full((R, 1), 6.0))
    t_samples, _ = sample_along_rays(o, d, radii, N, near, far, False, False,
                                     'cone')
    moments = cast_rays_cmajor(t_samples, o, d, radii).reshape(6, -1)
    view = pos_enc(d, 0, hp['nerf.deg_view'])
    delta, mids = delta_mids(t_samples, d)
    return moments.contiguous(), view, delta, mids


def compare_kernels(params, hp, dev):
    """Phase 3: each wrapper against its plain version, f32 and bf16."""
    N = hp['nerf.num_samples']
    depth = hp['nerf.mlp.net_depth']
    dcond = hp['nerf.mlp.net_depth_condition']
    skip = hp['nerf.mlp.skip_index']
    W = hp['nerf.mlp.net_width']
    enc = (hp['nerf.min_deg_point'], hp['nerf.max_deg_point'])
    # The converted params in param order, [in, out] kernels, as the main
    # path hands them to the kernels.
    flat = []
    for name in km.param_order(depth, dcond):
        flat.append(params[f'mlp.{name}.weight'].t())
        flat.append(params[f'mlp.{name}.bias'].reshape(1, -1))
    moments, view, delta, mids = chunk_inputs(hp, dev)
    iv = 2 * (depth + 2)
    # f32 plain references; bf16 kernels are held against these too.
    ref_vp = km.view_proj_plain(view, flat[iv], flat[iv + 1], W,
                                torch.float32)
    ref_rs = km.lean_mlp_plain(moments, ref_vp, flat, N, depth, dcond, skip,
                               torch.float32, ACT, enc)
    ref_pr, ref_w = km.lean_composite_plain(ref_rs, delta, mids, True)
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        calls = {
            'lean_view_proj': (
                lambda: km.view_proj(view, flat[iv], flat[iv + 1], W, dt),
                lambda: km.view_proj_plain(view, flat[iv], flat[iv + 1], W,
                                           dt),
                [ref_vp]),
            'lean_mlp': (
                lambda: km.lean_mlp(moments, ref_vp, flat, N, depth, dcond,
                                    skip, dt, ACT, enc),
                lambda: km.lean_mlp_plain(moments, ref_vp, flat, N, depth,
                                          dcond, skip, dt, ACT, enc),
                [ref_rs]),
            'lean_composite': (
                lambda: km.lean_composite(ref_rs, delta, mids, True),
                lambda: km.lean_composite_plain(ref_rs, delta, mids, True),
                [ref_pr, ref_w]),
        }
        for name, (kernel, plain, refs) in calls.items():
            if name == 'lean_composite' and dt != torch.float32:
                continue              # the composite is f32 in both modes
            got = kernel()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            err = max(float((g - r).abs().max()) for g, r in zip(got, refs))
            scale = max(float(r.abs().max()) for r in refs)
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            tag = 'f32' if dt == torch.float32 else 'bf16'
            if dt == torch.float32:
                ok = finite and err <= F32_BAR
                bar = f'max|d| <= {F32_BAR}'
            else:
                ok = finite and err / scale <= BF16_BAR
                bar = f'max|d|/max|ref| = {err / scale:.3e} <= {BF16_BAR}'
            log(f'[kernel] {name} {tag}: max|d| {err:.3e} ({bar}) '
                f'kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  '
                f'{"OK" if ok else "FAIL"}')
            if not ok:
                raise AssertionError(f'{name} {tag} disagrees with its plain '
                                     f'version: max|d| {err:.3e}')
            results[(name, tag)] = dict(err=err, ms=ms, plain_ms=plain_ms)
    return results


def render_frame(system, params, cam, side=None):
    side = side or SIDE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = system.render_camera(params, cam, side, side, chunk_size=CHUNK,
                               need_coarse=False)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def blender_camera(side, dev):
    """Blender view on the radius-4 orbit, focal scaled from 800 px,
    near 2, far 6."""
    pose = create_spheric_poses(4.0, n_poses=8)[1].astype(np.float32)
    p2c = pix2cam_from_focal(side, side, 1111.11 * side / 800)
    return Camera(torch.tensor(pose, device=dev),
                  torch.tensor(p2c, device=dev), 2.0, 6.0, 1.0)


def measure(hp, params, dev):
    """800x800 frame times, kernel vs plain path in turns, f32 and bf16;
    then a profiler table of one 200x200 kernel-path frame."""
    from torch.profiler import ProfilerActivity, profile
    cam = blender_camera(FULL_SIDE, dev)
    small = blender_camera(SIDE, dev)
    for dtype in ('float32', 'bfloat16'):
        pair = {}
        for backend in ('auto', 'xla'):
            sysb = MipNeRFSystem(dict(hp, **{'val.mlp_backend': backend,
                                             'train.compute_dtype': dtype}),
                                 device=dev)
            render_frame(sysb, params, small)              # warm-up
            pair['kernel' if backend == 'auto' else 'plain'] = sysb
        times = {'kernel': [], 'plain': []}
        for which in ('kernel', 'plain', 'plain', 'kernel'):
            torch.cuda.reset_peak_memory_stats()
            _, sec = render_frame(pair[which], params, cam, FULL_SIDE)
            times[which].append(sec)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f'[measure] {FULL_SIDE}x{FULL_SIDE} {dtype} {which}: '
                f'{sec:.3f} s/frame (peak {peak:.2f} GiB)')
        log(f'[measure] {FULL_SIDE}x{FULL_SIDE} {dtype}: kernel '
            f'{min(times["kernel"]):.3f} s/frame, plain '
            f'{min(times["plain"]):.3f} s/frame (best of 2 each)')
    sysk = MipNeRFSystem(hp, device=dev)
    render_frame(sysk, params, small)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, sec = render_frame(sysk, params, small)
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events)
    log(f'[measure] profile of one {SIDE}x{SIDE} f32 kernel-path frame: '
        f'wall {sec * 1e3:.1f} ms, device time {dev_us / 1e3:.1f} ms '
        f'(busy {dev_us / 1e4 / sec:.1f}%)')
    log(events.table(sort_by='self_device_time_total', row_limit=12,
                     max_name_column_width=60))


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this run needs an NVIDIA GPU',
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f'[device] {kind} x{torch.cuda.device_count()}  torch '
        f'{torch.__version__} cuda {torch.version.cuda}')
    log(f'[device] nvidia-smi: {smi}')

    rec = _build.build('lean_render')
    _build.load('lean_render')
    log(f'[build] nvcc {" ".join(_build.ARCH_FLAGS)} -> {rec["so"].name} in '
        f'{rec["seconds"]:.1f} s')
    for line in rec['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'[build] {line.strip()}')

    hp = config.default()
    system = MipNeRFSystem(hp, device=dev)
    if not system.eval_model._fused_render:
        raise AssertionError('val.mlp_backend=auto did not select the fused '
                             'lean-render path for the lego schema')
    params = jax_params_to_torch(flax_tree(system, seed=0), device=dev)

    results = compare_kernels(params, hp, dev)

    # Phase 4: the slice.
    cam = blender_camera(SIDE, dev)
    render_frame(system, params, cam)               # warm-up
    km.reset_launches()
    out, s_kernel = render_frame(system, params, cam)
    counts = dict(km.launches)
    n_chunks = -(-SIDE * SIDE // CHUNK)
    want = hp['nerf.num_levels'] * n_chunks
    log(f'[slice] render_camera {SIDE}x{SIDE}, chunk {CHUNK} '
        f'({n_chunks} chunks x {hp["nerf.num_levels"]} levels): '
        f'{s_kernel:.3f} s/frame; launches {counts}')
    if any(c != want for c in counts.values()):
        raise AssertionError(f'expected {want} launches of every kernel, '
                             f'got {counts}')
    for k, v in out.items():
        shape = (SIDE, SIDE, 3) if k.endswith('rgb') else (SIDE, SIDE)
        if v.shape != shape or not np.all(np.isfinite(v)):
            raise AssertionError(f'{k}: shape {v.shape} or non-finite')

    hp_plain = dict(hp, **{'val.mlp_backend': 'xla'})
    plain_system = MipNeRFSystem(hp_plain, device=dev)
    render_frame(plain_system, params, cam)
    km.reset_launches()
    ref, s_plain = render_frame(plain_system, params, cam)
    if any(km.launches.values()):
        raise AssertionError(f'plain path launched kernels: {km.launches}')
    d_rgb = float(np.abs(out['fine_rgb'] - ref['fine_rgb']).max())
    d_acc = float(np.abs(out['acc'] - ref['acc']).max())
    d_dist = float(np.abs(out['distance'] - ref['distance']).max())
    log(f'[slice] plain path: {s_plain:.3f} s/frame; kernel vs plain '
        f'max|d rgb| {d_rgb:.3e} max|d acc| {d_acc:.3e} (bar {FRAME_BAR}) '
        f'max|d distance| {d_dist:.3e}; mean rgb '
        f'{float(out["fine_rgb"].mean()):.4f} mean acc '
        f'{float(out["acc"].mean()):.4f}')
    if d_rgb > FRAME_BAR or d_acc > FRAME_BAR:
        raise AssertionError('kernel frame disagrees with the plain path')
    if '--measure' in sys.argv[1:]:
        measure(hp, params, dev)

    kernels = []
    for name in ('lean_view_proj', 'lean_mlp', 'lean_composite'):
        r = results[(name, 'f32')]
        kernels.append({'name': name, 'route': 'cuda', 'source': km.SOURCE,
                        'replaces': km.REPLACES, 'launches': counts[name],
                        'max_abs_err': r['err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms']})
    print(json.dumps({'kernels': kernels}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
