"""Times the rows-form training kernels of one checkout on the card.

    cd <root of a checkout> && python3 <this file> <label>

imports `mipnerf_pl_tpu_torch` from the working directory (so the same
script times a parent checkout and this one, in turns, within one call) and
prints one JSON line: the CUDA-event time in ms of lean_fwd,
lean_save_fwd, lean_param_grads and lean_param_grads_recompute at the lego
training level (3072 seeded rays x 128 stratified samples, encode rows,
seeded Xavier weights and head cotangents), f32 and bf16, 10 launches each
after a warm-up; and, where the checkout has them, the classic kernels of
fused_mlp (mlp_fwd, mlp_save_fwd, mlp_bwd_saved, mlp_bwd_recompute) on the
same level with the view repeated over the samples.  It uses only names
every lean-training checkout has, and the classic names only if present.
"""

import json
import os
import sys

import numpy as np
import torch

RAYS = 3072
ACT = (0.001, -1.0)


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


def main():
    # The checkout to time is the working directory's.
    sys.path.insert(0, os.getcwd())
    from mipnerf_pl_tpu_torch import config
    from mipnerf_pl_tpu_torch.kernels import mlp as km
    from mipnerf_pl_tpu_torch.ops.math import integrated_pos_enc, pos_enc
    from mipnerf_pl_tpu_torch.ops.sampling import sample_along_rays
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

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
    out = {'label': sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
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
        saved = cs = None
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
