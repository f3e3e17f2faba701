"""Times the rows-form training kernels of one checkout on the card.

    cd <root of a checkout> && python3 <this file> <label> [--profile]

imports `mipnerf_pl_tpu_torch` from the working directory (so the same
script times a parent checkout and this one, in turns, within one call) and
prints one JSON line: the CUDA-event time in ms of lean_fwd,
lean_save_fwd, lean_param_grads, lean_param_grads_recompute and
lean_param_grads_hybrid at the lego training level (3072 seeded rays x 128
stratified samples, encode rows, seeded Xavier weights and head
cotangents), f32 and bf16, 10 launches each after a warm-up; where the
checkout has them, the classic kernels of fused_mlp (mlp_fwd, mlp_save_fwd,
mlp_bwd_saved, mlp_bwd_recompute) on the same level with the view repeated
over the samples, and the Megatron pair backward tp_pair_bwd at a lego
level's later pair (393,216 rows, 1024 -> 512 -> 1024).  It uses only
names every lean-training checkout has, and the others only if present.

With --steps it also times the lego training step on pallas_lean_save
(bench.py's synthetic rays, 3072 a step, make_train_many K = 5 steps a
call, the host clock to a synchronise): best and median ms/step of 6 calls
after a warm-up, bf16 and f32, and the device time of one step from a
torch.profiler window.

With --profile it first prints, each on a line of its own:
  * the device time of every kernel of one lean_param_grads call, bf16 and
    f32, from a torch.profiler window (the split of the backward into its
    chain, weight-gradient, reduction and per-ray kernels);
  * the yardstick of the weight gradients: torch.mm of each problem's
    activation rows against its cotangent rows (the same products the
    weight-gradient kernel computes, cuBLAS; never called by the port),
    summed over the problems, CUDA events;
  * view_proj's device time against torch.addmm's at the level's rays,
    from the profiler (kernel durations, not the host's issue time).
"""

import json
import os
import sys

import numpy as np
import torch

RAYS = 3072
ACT = (0.001, -1.0)
TP_SHAPE = (393216, 1024, 512, 1024)


def cuda_ms(fn, iters=10):
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


def step_times(MipNeRFSystem, Rays, hp, dev, dtype, params):
    """(best, median ms/step of 6 make_train_many calls of K = 5 steps,
    device ms of one step) on pallas_lean_save."""
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
    system = MipNeRFSystem(dict(hp, **{'nerf.mlp_backend': 'pallas_lean_save',
                                       'train.compute_dtype': dtype}),
                           device=dev)
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
    from mipnerf_pl_tpu_torch.ops.math import integrated_pos_enc, pos_enc
    from mipnerf_pl_tpu_torch.ops.sampling import sample_along_rays
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

    argv = [a for a in sys.argv[1:] if not a.startswith('--')]
    profile = '--profile' in sys.argv[1:]
    dev = torch.device('cuda')
    hp = config.default()
    depth, dcond = hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_depth_condition']
    params = MipNeRFSystem(hp, device=dev).init_params(seed=0)
    flat = []
    for name in km.param_order(depth, dcond):
        flat += [params[f'mlp.{name}.weight'].t(),
                 params[f'mlp.{name}.bias'].reshape(1, -1)]
    rng = np.random.default_rng(1)
    d = rng.normal(size=(RAYS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    ones = np.ones((RAYS, 1))
    _, means_covs = sample_along_rays(
        t(rng.normal(size=(RAYS, 3)) * 0.1), t(d), t(ones * 0.005),
        hp['nerf.num_samples'], t(ones * 2.0), t(ones * 6.0), False, False,
        'cone')
    x = integrated_pos_enc(means_covs, hp['nerf.min_deg_point'],
                           hp['nerf.max_deg_point'])
    x = x.reshape(-1, x.shape[-1]).contiguous()
    view = pos_enc(t(d), 0, hp['nerf.deg_view'])
    g_rgb, g_dens = (t(rng.normal(size=(x.shape[0], c))) for c in (3, 1))
    args = (hp['nerf.num_samples'], depth, dcond, hp['nerf.mlp.skip_index'])
    out = {'label': argv[0] if argv else os.getcwd(),
           'device': torch.cuda.get_device_name(0)}
    if profile:
        iv = 2 * (depth + 2)
        W = flat[0].shape[1]
        for dt, tag in ((torch.bfloat16, 'bf16'), (torch.float32, 'f32')):
            saved = km.lean_save_fwd(x, view, flat, *args, dt, ACT)[2]
            split = device_split(lambda: km.lean_param_grads(
                view, g_rgb, g_dens, saved, flat, *args, dt, ACT))
            split = {short(k): round(v, 4) for k, v in split.items()}
            print(json.dumps({'split lean_param_grads': tag,
                              'total_ms': round(sum(split.values()), 4),
                              'kernels_ms': split}), flush=True)
            mm = wgrad_yardstick(km, saved, flat, args, dt)
            print(json.dumps({'yardstick': f'torch.mm weight gradients {tag}',
                              'ms': round(mm, 4)}), flush=True)
            kv, bv, vv = (a.to(dt) for a in (flat[iv][W:], flat[iv + 1],
                                             view))
            vp = device_split(lambda: km.view_proj(view, flat[iv],
                                                   flat[iv + 1], W, dt),
                              iters=10)
            am = device_split(lambda: torch.addmm(bv, vv, kv), iters=10)
            print(json.dumps({
                'view_proj device ms': tag,
                'lean_view_proj_kernel': round(sum(
                    v for k, v in vp.items() if 'view_proj' in k), 5),
                'wrapper casts': round(sum(
                    v for k, v in vp.items() if 'view_proj' not in k), 5),
                'torch.addmm': round(sum(am.values()), 5),
                'kernels': {short(k): round(v, 5) for k, v in vp.items()},
                'addmm kernels': {short(k): round(v, 5)
                                  for k, v in am.items()}}), flush=True)
            saved = None
    for dt, tag in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
        saved = km.lean_save_fwd(x, view, flat, *args, dt, ACT)[2]
        calls = {
            'lean_fwd': lambda: km.lean_fwd(x, view, flat, *args, dt, ACT),
            'lean_save_fwd': lambda: km.lean_save_fwd(x, view, flat, *args,
                                                      dt, ACT),
            'lean_param_grads': lambda: km.lean_param_grads(
                view, g_rgb, g_dens, saved, flat, *args, dt, ACT),
            'lean_param_grads_recompute':
                lambda: km.lean_param_grads_recompute(
                    x, view, g_rgb, g_dens, flat, *args, dt, ACT),
        }
        res = None
        if hasattr(km, 'lean_hybrid_fwd'):
            res = km.lean_hybrid_fwd(x, view, flat, *args, dt, ACT)[2]
            calls['lean_param_grads_hybrid'] = \
                lambda: km.lean_param_grads_hybrid(view, g_rgb, g_dens, res,
                                                   flat, *args, dt, ACT)
        if hasattr(km, 'mlp_bwd_saved'):
            cargs = args[1:] + (dt,)
            vp = view.repeat_interleave(args[0], dim=0).contiguous()
            cs = km.mlp_save_fwd(x, vp, flat, *cargs)[2]
            g_d = g_dens.contiguous()
            calls.update({
                'mlp_fwd': lambda: km.mlp_fwd(x, vp, flat, *cargs),
                'mlp_save_fwd': lambda: km.mlp_save_fwd(x, vp, flat, *cargs),
                'mlp_bwd_saved': lambda: km.mlp_bwd_saved(
                    g_rgb, g_d, cs, flat, *cargs),
                'mlp_bwd_recompute': lambda: km.mlp_bwd_recompute(
                    x, vp, g_rgb, g_d, flat, *cargs),
            })
        for name, fn in calls.items():
            out[f'{name} {tag}'] = round(cuda_ms(fn), 4)
        calls.clear()
        saved = cs = res = None
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
    if '--steps' in sys.argv[1:]:
        from mipnerf_pl_tpu_torch.rays import Rays
        for dtype, tag in (('bfloat16', 'bf16'), ('float32', 'f32')):
            best, med, dev_ms = step_times(MipNeRFSystem, Rays, hp, dev,
                                           dtype, params)
            out[f'step {tag} best'] = round(best, 3)
            out[f'step {tag} median'] = round(med, 3)
            out[f'step {tag} device'] = round(dev_ms, 3)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
