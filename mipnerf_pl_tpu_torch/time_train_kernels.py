"""Times the rows-form training kernels of one checkout on the card.

    cd <root of a checkout> && python3 <this file> <label> [--profile]

imports `mipnerf_pl_tpu_torch` from the working directory (so the same
script times a parent checkout and this one, in turns, within one call) and
prints one JSON line: the CUDA-event time in ms of lean_fwd,
lean_save_fwd, lean_param_grads, lean_param_grads_recompute,
lean_hybrid_fwd (the plain forward of mode 'hybrid') and
lean_param_grads_hybrid at the lego training level (3072 seeded rays x 128
stratified samples, encode rows, seeded Xavier weights and head
cotangents), f32 and bf16, the least of two means of 10 launches after a
warm-up; lean_fwd and
lean_save_fwd also on the level's [6, M] moments (`... moments`), and
lean_mlp at one render chunk (8192 seeded rays around the radius-4 orbit x
128 samples, their moments and the f32 vproj of their view rows); where the
checkout has them, the classic kernels of fused_mlp (mlp_fwd, mlp_save_fwd,
mlp_bwd_saved, mlp_bwd_recompute) on the same level with the view repeated
over the samples, also for the lego trunk with no view layer
(net_depth_condition 0: the rgb head reads concat(bottleneck, view); `...
no_view`), and the Megatron pair backward tp_pair_bwd at a lego level's
later pair (393,216 rows, 1024 -> 512 -> 1024).  It uses only names every
lean-training checkout has, and the others only if present.

With --steps it also times the lego training step on pallas_lean_save
(bench.py's synthetic rays, 3072 a step, make_train_many K = 5 steps a
call, the host clock to a synchronise): best and median ms/step of 6 calls
after a warm-up, bf16 and f32, and the device time of one step from a
torch.profiler window; and the same, bf16 and f32, on `pallas_hybrid`
(`step bf16 pallas_hybrid ...`) and on the classic backends `pallas` and
`pallas_save` with stop_resample_grad False (`step bf16 pallas ...`), also
for the model with no view layer (`step bf16 pallas no_view ...`).

With --frames it also times one 800x800 frame of render_camera (the lego
schema's model with seeded weights, chip_smoke.py's Blender camera on the
radius-4 orbit, 8192-ray chunks, the host clock to a synchronise, after a
200x200 warm-up), bf16 and f32.

With --profile it first prints, each on a line of its own (the kernels of
a split that share a name summed):
  * the device time of every kernel of one lean_param_grads call, bf16 and
    f32, from a torch.profiler window (the split of the backward into its
    chain, weight-gradient, reduction and per-ray kernels), and the same of
    lean_hybrid_fwd and lean_param_grads_hybrid where the checkout has
    them, with the peak memory of one hybrid forward and backward of the
    level above what was allocated before (`hybrid peak`);
  * the same split of the forwards: lean_save_fwd on rows and on the
    moments, and lean_mlp at the render chunk (the MLP kernel, the
    wrapper's casts of the weights and biases);
  * the yardstick of the weight gradients: torch.mm of each problem's
    activation rows against its cotangent rows (the same products the
    weight-gradient kernel computes, cuBLAS; never called by the port),
    summed over the problems, CUDA events;
  * view_proj's device time against torch.addmm's at the level's rays and
    at the render chunk's, from the profiler (kernel durations, not the
    host's issue time);
  * where the checkout has them, the same split of the classic kernels,
    bf16 and f32: mlp_save_fwd, mlp_bwd_saved (its chain with dx and dview,
    weight gradients and reductions) and mlp_bwd_recompute (its re-runs of
    the forward besides), with a view layer and without (`... no_view`).
"""

import json
import os
import sys

import numpy as np
import torch

RAYS = 3072
CHUNK = 8192            # rays of a render chunk (val.chunk_size)
FRAME_SIDES = (200, 800)   # --frames: a warm-up frame, the timed one
ACT = (0.001, -1.0)
TP_SHAPE = (393216, 1024, 512, 1024)


def cuda_ms(fn, iters=10, rounds=2):
    """The least of `rounds` means of `iters` launches after a warm-up (one
    disturbed round does not move the number)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float('inf')
    for _ in range(rounds):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_split(fn, iters=1):
    """{kernel name: device ms per call} of fn() from a torch.profiler
    window after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = (out.get(ev.key, 0.0)
                           + ev.self_device_time_total / 1e3 / iters)
    return out


def short_split(fn):
    """{short kernel name: device ms per call} of fn() (device_split), the
    kernels that share a short name summed."""
    out = {}
    for k, v in device_split(fn).items():
        out[short(k)] = out.get(short(k), 0.0) + v
    return {k: round(v, 4) for k, v in out.items()}


def short(name):
    """A kernel's name without its return type, namespaces, template
    arguments and signature."""
    name = name.replace('(anonymous namespace)::', '')
    if name.startswith('void '):
        name = name[len('void '):]
    return name.split('<')[0].split('(')[0].split('::')[-1]


def wgrad_yardstick(km, saved, flat, args, dt):
    """ms of torch.mm over every weight-gradient problem of the level: the
    activation rows [K, Mp] of the saved stream against cotangent rows [n,
    Mp] (seeded, as the chain would leave them) transposed."""
    N, depth, dcond, skip = args
    S = saved[0]
    F, W = flat[0].shape
    Wv = flat[2 * (depth + 2)].shape[1]
    Fp, hs, bott, ys, _ = km.saved_rows(F, W, Wv, depth, dcond)
    first = [0] + hs + [bott] + ys
    shapes = [tuple(t.shape) for t in flat[0::2]]
    probs = km.wgrad_problems(shapes, depth, dcond, skip)[0]
    Cg = sum(n for _, n in shapes)
    gen = torch.Generator(device=S.device).manual_seed(2)
    G = torch.randn((Cg, S.shape[1]), generator=gen, device=S.device).to(dt)
    blocks = [(S[first[a]:first[a] + K], G[g:g + n])
              for a, K, g, n, _, _ in probs]

    def run():
        for a, g in blocks:
            torch.mm(a, g.t())
    return cuda_ms(run)


def step_times(MipNeRFSystem, Rays, hp, dev, dtype, params,
               backend='pallas_lean_save', opts=None):
    """(best, median ms/step of 6 make_train_many calls of K = 5 steps,
    device ms of one step) on `backend` with hparams `opts`."""
    import time
    K, B = 5, RAYS
    rng = np.random.default_rng(0)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((B, 1), np.float32)
    o = rng.normal(size=(B, 3)).astype(np.float32) * 0.1
    fields = (o, d, d, ones * 0.005, ones, ones * 2.0, ones * 6.0)
    rays = Rays(*(torch.tensor(f, device=dev).expand(K, B, f.shape[1])
                  .contiguous() for f in fields))
    pix = torch.tensor(rng.uniform(size=(K, B, 3)).astype(np.float32),
                       device=dev)
    system = MipNeRFSystem(dict(hp, **{'nerf.mlp_backend': backend,
                                       'train.compute_dtype': dtype},
                                **(opts or {})), device=dev)
    fn = system.make_train_many()
    state = system.init_state(params=params)
    state, _ = fn(state, rays, pix, 0)
    secs = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = fn(state, rays, pix, K * (i + 1))
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) * 1e3 / K)
    dev_ms = sum(device_split(lambda: fn(state, rays, pix, 0)).values()) / K
    return min(secs), sorted(secs)[len(secs) // 2], dev_ms


def main():
    # The checkout to time is the working directory's.
    sys.path.insert(0, os.getcwd())
    from mipnerf_pl_tpu_torch import config
    from mipnerf_pl_tpu_torch.kernels import mlp as km
    from mipnerf_pl_tpu_torch.ops.math import (cast_rays_cmajor,
                                               integrated_pos_enc, pos_enc)
    from mipnerf_pl_tpu_torch.ops.sampling import sample_along_rays
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

    argv = [a for a in sys.argv[1:] if not a.startswith('--')]
    profile = '--profile' in sys.argv[1:]
    dev = torch.device('cuda')
    hp = config.default()
    depth, dcond = hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_depth_condition']
    params = MipNeRFSystem(hp, device=dev).init_params(seed=0)

    def flat_of(params, dcond):
        flat = []
        for name in km.param_order(depth, dcond):
            flat += [params[f'mlp.{name}.weight'].t(),
                     params[f'mlp.{name}.bias'].reshape(1, -1)]
        return flat
    flat = flat_of(params, dcond)
    # The same trunk with no view layer, for fused_mlp's kernels.
    hp_nv = dict(hp, **{'nerf.mlp.net_depth_condition': 0})
    params_nv = MipNeRFSystem(hp_nv, device=dev).init_params(seed=0)
    flat_nv = flat_of(params_nv, 0)
    rng = np.random.default_rng(1)
    d = rng.normal(size=(RAYS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    ones = np.ones((RAYS, 1))
    o_level = rng.normal(size=(RAYS, 3)) * 0.1
    t_level, means_covs = sample_along_rays(
        t(o_level), t(d), t(ones * 0.005),
        hp['nerf.num_samples'], t(ones * 2.0), t(ones * 6.0), False, False,
        'cone')
    x = integrated_pos_enc(means_covs, hp['nerf.min_deg_point'],
                           hp['nerf.max_deg_point'])
    x = x.reshape(-1, x.shape[-1]).contiguous()
    view = pos_enc(t(d), 0, hp['nerf.deg_view'])
    g_rgb, g_dens = (t(rng.normal(size=(x.shape[0], c))) for c in (3, 1))
    args = (hp['nerf.num_samples'], depth, dcond, hp['nerf.mlp.skip_index'])
    enc = (hp['nerf.min_deg_point'], hp['nerf.max_deg_point'])
    # The level's samples as moments [6, M] (the same samples as x).
    moments = cast_rays_cmajor(t_level, t(o_level), t(d), t(ones * 0.005))
    moments = moments.reshape(6, -1).contiguous()
    # One render chunk: CHUNK rays from near the radius-4 orbit towards the
    # scene, their moments and vproj.
    origins = rng.normal(size=(CHUNK, 3)) * 0.1 + np.array([0.0, 3.2, 2.35])
    dc = rng.uniform(-1.0, 1.0, size=(CHUNK, 3)) - origins
    dc /= np.linalg.norm(dc, axis=-1, keepdims=True)
    ones_c = np.ones((CHUNK, 1))
    t_chunk, _ = sample_along_rays(t(origins), t(dc), t(ones_c * 5e-4),
                                   hp['nerf.num_samples'], t(ones_c * 2.0),
                                   t(ones_c * 6.0), False, False, 'cone')
    c_moments = cast_rays_cmajor(t_chunk, t(origins), t(dc),
                                 t(ones_c * 5e-4)).reshape(6, -1).contiguous()
    c_view = pos_enc(t(dc), 0, hp['nerf.deg_view'])
    iv = 2 * (depth + 2)
    W = flat[0].shape[1]
    c_vproj = km.view_proj_plain(c_view, flat[iv], flat[iv + 1], W,
                                 torch.float32)
    out = {'label': argv[0] if argv else os.getcwd(),
           'device': torch.cuda.get_device_name(0)}
    if profile:
        for dt, tag in ((torch.bfloat16, 'bf16'), (torch.float32, 'f32')):
            fwds = {
                'lean_save_fwd': lambda: km.lean_save_fwd(
                    x, view, flat, *args, dt, ACT),
                'lean_save_fwd moments': lambda: km.lean_save_fwd(
                    moments, view, flat, *args, dt, ACT, encode=enc),
                'lean_mlp': lambda: km.lean_mlp(c_moments, c_vproj, flat,
                                                *args, dt, ACT, enc)}
            for name, fn in fwds.items():
                split = short_split(fn)
                print(json.dumps({f'split {name}': tag,
                                  'total_ms': round(sum(split.values()), 4),
                                  'kernels_ms': split}), flush=True)
            saved = km.lean_save_fwd(x, view, flat, *args, dt, ACT)[2]
            split = short_split(lambda: km.lean_param_grads(
                view, g_rgb, g_dens, saved, flat, *args, dt, ACT))
            print(json.dumps({'split lean_param_grads': tag,
                              'total_ms': round(sum(split.values()), 4),
                              'kernels_ms': split}), flush=True)
            if hasattr(km, 'lean_hybrid_fwd'):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                res = km.lean_hybrid_fwd(x, view, flat, *args, dt, ACT)[2]
                km.lean_param_grads_hybrid(view, g_rgb, g_dens, res, flat,
                                           *args, dt, ACT)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                runs = {'lean_hybrid_fwd': lambda: km.lean_hybrid_fwd(
                            x, view, flat, *args, dt, ACT),
                        'lean_param_grads_hybrid':
                            lambda: km.lean_param_grads_hybrid(
                                view, g_rgb, g_dens, res, flat, *args, dt,
                                ACT)}
                for name, fn in runs.items():
                    split = short_split(fn)
                    print(json.dumps({f'split {name}': tag,
                                      'total_ms': round(sum(split.values()),
                                                        4),
                                      'kernels_ms': split}), flush=True)
                print(json.dumps({'hybrid peak': tag,
                                  'GiB': round(peak / 2 ** 30, 4)}),
                      flush=True)
                res = None
            mm = wgrad_yardstick(km, saved, flat, args, dt)
            print(json.dumps({'yardstick': f'torch.mm weight gradients {tag}',
                              'ms': round(mm, 4)}), flush=True)
            for vw in (view, c_view):
                kv, bv, vv = (a.to(dt) for a in (flat[iv][W:], flat[iv + 1],
                                                 vw))
                vp = device_split(lambda: km.view_proj(vw, flat[iv],
                                                       flat[iv + 1], W, dt),
                                  iters=10)
                am = device_split(lambda: torch.addmm(bv, vv, kv), iters=10)
                print(json.dumps({
                    'view_proj device ms': tag, 'rays': vw.shape[0],
                    'lean_view_proj_kernel': round(sum(
                        v for k, v in vp.items() if 'view_proj' in k), 5),
                    'wrapper casts': round(sum(
                        v for k, v in vp.items() if 'view_proj' not in k), 5),
                    'torch.addmm': round(sum(am.values()), 5),
                    'kernels': {short(k): round(v, 5) for k, v in vp.items()},
                    'addmm kernels': {short(k): round(v, 5)
                                      for k, v in am.items()}}), flush=True)
            saved = None
            if hasattr(km, 'mlp_bwd_saved'):
                vp = view.repeat_interleave(args[0], dim=0).contiguous()
                for suffix, fl, dc in (('', flat, dcond),
                                       (' no_view', flat_nv, 0)):
                    cargs = (depth, dc, args[3], dt)
                    cs = km.mlp_save_fwd(x, vp, fl, *cargs)[2]
                    runs = {
                        'mlp_save_fwd': lambda: km.mlp_save_fwd(
                            x, vp, fl, *cargs),
                        'mlp_bwd_saved': lambda: km.mlp_bwd_saved(
                            g_rgb, g_dens, cs, fl, *cargs),
                        'mlp_bwd_recompute': lambda: km.mlp_bwd_recompute(
                            x, vp, g_rgb, g_dens, fl, *cargs)}
                    for name, fn in runs.items():
                        split = short_split(fn)
                        print(json.dumps({
                            f'split {name}{suffix}': tag,
                            'total_ms': round(sum(split.values()), 4),
                            'kernels_ms': split}), flush=True)
                    cs = None
    for dt, tag in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
        saved = km.lean_save_fwd(x, view, flat, *args, dt, ACT)[2]
        calls = {
            'lean_fwd': lambda: km.lean_fwd(x, view, flat, *args, dt, ACT),
            'lean_save_fwd': lambda: km.lean_save_fwd(x, view, flat, *args,
                                                      dt, ACT),
            'lean_fwd moments': lambda: km.lean_fwd(
                moments, view, flat, *args, dt, ACT, encode=enc),
            'lean_save_fwd moments': lambda: km.lean_save_fwd(
                moments, view, flat, *args, dt, ACT, encode=enc),
            'lean_mlp': lambda: km.lean_mlp(c_moments, c_vproj, flat, *args,
                                            dt, ACT, enc),
            'lean_param_grads': lambda: km.lean_param_grads(
                view, g_rgb, g_dens, saved, flat, *args, dt, ACT),
            'lean_param_grads_recompute':
                lambda: km.lean_param_grads_recompute(
                    x, view, g_rgb, g_dens, flat, *args, dt, ACT),
        }
        res = None
        if hasattr(km, 'lean_hybrid_fwd'):
            res = km.lean_hybrid_fwd(x, view, flat, *args, dt, ACT)[2]
            calls['lean_hybrid_fwd'] = lambda: km.lean_hybrid_fwd(
                x, view, flat, *args, dt, ACT)
            calls['lean_param_grads_hybrid'] = \
                lambda: km.lean_param_grads_hybrid(view, g_rgb, g_dens, res,
                                                   flat, *args, dt, ACT)
        for name, fn in calls.items():
            out[f'{name} {tag}'] = round(cuda_ms(fn), 4)
        calls.clear()
        saved = res = None
        if hasattr(km, 'mlp_bwd_saved'):
            vp = view.repeat_interleave(args[0], dim=0).contiguous()
            g_d = g_dens.contiguous()
            for suffix, fl, dc in (('', flat, dcond), (' no_view', flat_nv, 0)):
                cargs = (depth, dc, args[3], dt)
                cs = km.mlp_save_fwd(x, vp, fl, *cargs)[2]
                calls = {
                    'mlp_fwd': lambda: km.mlp_fwd(x, vp, fl, *cargs),
                    'mlp_save_fwd': lambda: km.mlp_save_fwd(x, vp, fl,
                                                            *cargs),
                    'mlp_bwd_saved': lambda: km.mlp_bwd_saved(
                        g_rgb, g_d, cs, fl, *cargs),
                    'mlp_bwd_recompute': lambda: km.mlp_bwd_recompute(
                        x, vp, g_rgb, g_d, fl, *cargs)}
                for name, fn in calls.items():
                    out[f'{name}{suffix} {tag}'] = round(cuda_ms(fn), 4)
                calls.clear()
                cs = None
        try:
            from mipnerf_pl_tpu_torch.kernels import tp_lean
        except ImportError:
            tp_lean = None
        if tp_lean is not None and hasattr(tp_lean, '_pair_bwd_call'):
            M, f_in, Wl, Wout = TP_SHAPE
            gen = torch.Generator(device=dev).manual_seed(3)
            xp = torch.relu(torch.randn(M, f_in, generator=gen,
                                        device=dev)).to(dt)
            wc = torch.randn(f_in, Wl, generator=gen, device=dev) / 32.0
            bc = torch.zeros(1, Wl, device=dev)
            wr = torch.randn(Wl, Wout, generator=gen, device=dev) / 22.6
            gp = torch.randn(M, Wout, generator=gen, device=dev)
            out[f'tp_pair_bwd {tag}'] = round(cuda_ms(
                lambda: tp_lean._pair_bwd_call(xp, wc, bc, wr, gp, dt),
                iters=4), 4)
            xp = gp = None
        torch.cuda.empty_cache()
    if '--frames' in sys.argv[1:]:
        import time
        import chip_smoke
        for dtype, tag in (('bfloat16', 'bf16'), ('float32', 'f32')):
            system = MipNeRFSystem(dict(hp, **{'train.compute_dtype': dtype}),
                                   device=dev)
            for side in FRAME_SIDES:
                cam = chip_smoke.blender_camera(side, dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                system.render_camera(params, cam, side, side,
                                     chunk_size=CHUNK, need_coarse=False)
                torch.cuda.synchronize()
            out[f'frame {side}x{side} {tag} s'] = round(time.perf_counter() - t0,
                                                  4)
            del system
    if '--steps' in sys.argv[1:]:
        from mipnerf_pl_tpu_torch.rays import Rays
        for dtype, tag in (('bfloat16', 'bf16'), ('float32', 'f32')):
            best, med, dev_ms = step_times(MipNeRFSystem, Rays, hp, dev,
                                           dtype, params)
            out[f'step {tag} best'] = round(best, 3)
            out[f'step {tag} median'] = round(med, 3)
            out[f'step {tag} device'] = round(dev_ms, 3)
        for dtype, tag in (('bfloat16', 'bf16'), ('float32', 'f32')):
            for backend, opts in (
                    ('pallas_hybrid', {}),
                    ('pallas', {'nerf.stop_resample_grad': False}),
                    ('pallas_save', {'nerf.stop_resample_grad': False})):
                best, med, dev_ms = step_times(
                    MipNeRFSystem, Rays, hp, dev, dtype, params, backend,
                    opts)
                out[f'step {tag} {backend} best'] = round(best, 3)
                out[f'step {tag} {backend} median'] = round(med, 3)
                out[f'step {tag} {backend} device'] = round(dev_ms, 3)
            for backend in ('pallas', 'pallas_save'):
                best, med, dev_ms = step_times(
                    MipNeRFSystem, Rays, hp_nv, dev, dtype, params_nv,
                    backend, {'nerf.stop_resample_grad': False})
                key = f'step {tag} {backend} no_view'
                out[f'{key} best'] = round(best, 3)
                out[f'{key} median'] = round(med, 3)
                out[f'{key} device'] = round(dev_ms, 3)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
