"""Training throughput of the port (rays/s) on the lego workload.

    python -m mipnerf_pl_tpu_torch.bench [--device cpu]

The workload of the root bench.py: the default (lego) schema in bf16, 3072
rays a step, 128 + 128 samples through the 8x256 MLP, Adam with the mip LR
schedule, masked MSE plus distloss, on synthetic rays drawn from
np.random.default_rng(0) (no dataset).  First a one-step gradient-parity
gate: the loss's gradient on one batch through the configured backend and
through the plain 'xla' backend, from the same parameters and the same
sampling draws; the largest leaf ||a - b|| / ||a|| must be at most
BENCH_PARITY_TOL (default 3e-2), else the run exits non-zero and prints no
line.  Then, for 'xla' and then the configured backend: two warm-up calls
of make_train_many with BENCH_K steps each (default 100), then 4 timed
calls ending in a synchronise.  Prints one JSON line a backend, the
configured backend's last:

  {"metric": "train_rays_per_sec_per_chip", "value": ..., "unit":
   "rays/s/chip", "ms_per_step": ..., "backend": ...,
   "parity_ok": ..., "parity_max_leaf_rel_err": ...}  (parity keys on the
   configured backend's line)

Environment: BENCH_MLP_BACKEND (default pallas_lean_save; 'xla' prints one
line), BENCH_K, BENCH_BATCH, BENCH_FUSE_RENDER (non-empty: nerf.fuse_render
on), BENCH_FUSE_ENCODE ('0' off, other non-empty on), BENCH_NET_WIDTH (the
trunk width; the line then says net_width), BENCH_PARITY_TOL.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

N_CALLS = 4
WARMUP_CALLS = 2
PARITY_SEED = 7


def bench_hparams(backend: str) -> dict:
    """The default schema in bf16 on `backend`, with the BENCH_* knobs."""
    from mipnerf_pl_tpu_torch.config import default
    hp = default()
    hp['train.compute_dtype'] = 'bfloat16'
    hp['nerf.mlp_backend'] = backend
    if os.environ.get('BENCH_FUSE_RENDER'):
        hp['nerf.fuse_render'] = True
    if os.environ.get('BENCH_FUSE_ENCODE'):
        hp['nerf.fuse_encode'] = os.environ['BENCH_FUSE_ENCODE'] != '0'
    if os.environ.get('BENCH_BATCH'):
        hp['train.batch_size'] = int(os.environ['BENCH_BATCH'])
    if os.environ.get('BENCH_NET_WIDTH'):
        hp['nerf.mlp.net_width'] = int(os.environ['BENCH_NET_WIDTH'])
    return hp


def synthetic_batch(batch_size: int):
    """bench.py's rays and pixels: unit directions, origins near the
    centre, radii 0.005, near 2, far 6, lossmult 1."""
    from mipnerf_pl_tpu_torch.rays import Rays
    rng = np.random.default_rng(0)
    d = rng.normal(size=(batch_size, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((batch_size, 1), np.float32)
    rays = Rays(
        origins=rng.normal(size=(batch_size, 3)).astype(np.float32) * 0.1,
        directions=d, viewdirs=d, radii=ones * 0.005, lossmult=ones,
        near=ones * 2.0, far=ones * 6.0)
    pixels = rng.uniform(size=(batch_size, 3)).astype(np.float32)
    return rays, pixels


def parity_gate(systems, rays, pixels) -> float:
    """The largest leaf ||g - g_xla|| / ||g_xla|| of one step's gradient:
    systems = (the 'xla' system, the configured one), each from its own
    init_state (one seed: the same parameters) and a generator of one
    seed (the same sampling draws)."""
    from mipnerf_pl_tpu_torch.rays import namedtuple_map
    grads = []
    for s in systems:
        state = s.init_state()
        r = namedtuple_map(s._on_device, rays)
        _, g = s.value_and_grad(state['params'], r, s._on_device(pixels),
                                s.step_generator(PARITY_SEED, 0))
        grads.append({k: v.detach().double().cpu() for k, v in g.items()})
    worst = 0.0
    for k, a in grads[0].items():
        b = grads[1][k]
        worst = max(worst, float(torch.linalg.norm(b - a)
                                 / (torch.linalg.norm(a) + 1e-12)))
    return worst


def time_backend(system, rays, pixels, k: int) -> float:
    """Seconds of N_CALLS calls of make_train_many with k steps each, after
    WARMUP_CALLS, the last ending in a synchronise."""
    from mipnerf_pl_tpu_torch.rays import namedtuple_map
    stack = namedtuple_map(
        lambda x: system._on_device(
            np.broadcast_to(x[None], (k, *x.shape)).copy()), rays)
    pix = system._on_device(np.broadcast_to(pixels[None],
                                            (k, *pixels.shape)).copy())
    state = system.init_state()
    train_many = system.make_train_many()
    for _ in range(WARMUP_CALLS):
        state, aux = train_many(state, stack, pix, 0)
        float(aux['loss'][-1])
    t0 = time.perf_counter()
    for _ in range(N_CALLS):
        state, aux = train_many(state, stack, pix, 0)
    float(aux['loss'][-1])
    system._synchronize()
    dt = time.perf_counter() - t0
    if not np.isfinite(float(aux['loss'][-1])):
        raise FloatingPointError(f'{system.model.mlp_backend}: the loss is '
                                 'not finite')
    return dt


def bench_line(hp: dict, seconds: float, k: int) -> dict:
    batch = int(hp['train.batch_size'])
    rays_per_sec = N_CALLS * k * batch / seconds
    line = {'metric': 'train_rays_per_sec_per_chip',
            'value': round(rays_per_sec, 1), 'unit': 'rays/s/chip',
            'backend': str(hp['nerf.mlp_backend']),
            'ms_per_step': round(1e3 * batch / rays_per_sec, 3)}
    if os.environ.get('BENCH_NET_WIDTH'):
        line['net_width'] = int(hp['nerf.mlp.net_width'])
    return line


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the bench; -> the exit code (1 when the parity gate fails)."""
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None, help='Device to train on '
                        '(default: cuda; cpu runs the kernels\' plain '
                        'versions).')
    args = parser.parse_args(argv)
    backend = os.environ.get('BENCH_MLP_BACKEND', 'pallas_lean_save')
    k = int(os.environ.get('BENCH_K', '100'))
    tol = float(os.environ.get('BENCH_PARITY_TOL', '3e-2'))

    plan = [('xla', MipNeRFSystem(bench_hparams('xla'), device=args.device))]
    if backend != 'xla':
        plan.append((backend, MipNeRFSystem(bench_hparams(backend),
                                            device=args.device)))
    rays, pixels = synthetic_batch(int(plan[0][1].hparams['train.batch_size']))
    parity = None
    if backend != 'xla':
        t0 = time.perf_counter()
        err = parity_gate([s for _, s in plan], rays, pixels)
        parity = {'parity_ok': bool(err <= tol),
                  'parity_max_leaf_rel_err': round(err, 6),
                  'parity_gate_s': round(time.perf_counter() - t0, 1)}
        print(f'# parity gate: {parity} (tolerance {tol})', file=sys.stderr,
              flush=True)
        if not parity['parity_ok']:
            print(f'# bench: {backend!r} failed the gradient-parity gate; no '
                  'line is printed', file=sys.stderr, flush=True)
            return 1
    for name, system in plan:
        line = bench_line(system.hparams, time_backend(system, rays, pixels,
                                                       k), k)
        if name != 'xla':
            line.update(parity)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
