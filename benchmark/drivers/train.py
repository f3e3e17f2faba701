"""The 'train' driver: MipNeRFSystem.make_train_many at
mix['steps_per_call'] steps a dispatch, fed by system.batcher over the
written scene, on one card.  Set-up drives the first dispatch through the
same call and feed in three pieces (step 1; steps 2-3; the rest), so that
the optimizer's state after step 1 and the parameters after step 3 can be
read; the reference follows those three steps."""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict

import torch

from benchmark import compare, harness, reference, scenes, trace, work
from benchmark.drivers import Phases, free, peak_bytes, sync


# The mix's sizes in the CPU tests' small checkout (benchmark/tests/tiny.py).
SMALL = {'steps_per_call': 4}


def run(config: dict, mix: dict, seed: int, seconds: float, traced: bool,
        devices, t_start: float, extra: tuple = ()) -> Dict:
    from torch.profiler import record_function

    from mipnerf_pl_tpu_torch.system import MipNeRFSystem

    device = devices[0]
    hp = harness.hparams(config, seed)
    k, b = int(mix['steps_per_call']), int(hp['train.batch_size'])
    tmp = tempfile.mkdtemp(prefix='bench_')
    phases = Phases(t_start)
    try:
        scene = scenes.write(config['scene'], ('train', 'val'), seed,
                             tmp + '/scene', device)
        phases('scene')
        system = MipNeRFSystem(hp, device=device)
        params0 = harness.weights(hp, seed, device)
        harness.check_layout(params0, system.model)
        system.setup(scene, config['scene']['dataset'],
                     prefetch=int(mix['prefetch']), seed=seed,
                     steps_per_call=k)
        state = system.init_state(params=params0)
        phases('program')
        train_many = system.make_train_many()
        opt = state['opt_state']

        # The first dispatch, through the window's call and feed, in pieces.
        rays, pixels = next(system.batcher)
        first = {'loss': []}
        for a, z in ((0, 1), (1, 3), (3, k)):
            piece = type(rays)(*(f[a:z] for f in rays))
            state, aux = train_many(state, piece, pixels[a:z], seed)
            first['loss'] += aux['loss'].tolist()
            if z == 1:
                # The first gradient as Adam got it: its first moment
                # after one step is (1 - b1) g (none if it never stepped).
                first['grad'] = {
                    name: opt.state[p].get('exp_avg', torch.zeros_like(p))
                    .detach().clone() / (1 - reference.B1)
                    for name, p in state['params'].items()}
            if z == 3:
                first['params'] = {name: p.detach().clone() for name, p in
                                   state['params'].items()}
        first['loss'] = first['loss'][:3]
        phases('first dispatch')
        for _ in range(int(mix['warm_dispatches'])):
            rays, pixels = next(system.batcher)
            state, aux = train_many(state, rays, pixels, seed)
        sync(device)
        setup_s = time.perf_counter() - t_start
        phases('warm')

        steps, wait_s, host_s, losses = 0, 0.0, 0.0, []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            rays, pixels = next(system.batcher)
            t1 = time.perf_counter()
            state, aux = train_many(state, rays, pixels, seed)
            t2 = time.perf_counter()
            wait_s += t1 - t
            host_s += t2 - t1
            losses.append(aux['loss'].detach())
            steps += k
            if t2 - t0 >= seconds:
                break
        sync(device)
        window_s = time.perf_counter() - t0
        losses = torch.cat(losses)
        failed = int((~torch.isfinite(losses)).sum())

        phases('window')
        traced_window = None
        if traced:
            def tail():
                for _ in range(int(mix['trace_dispatches'])):
                    with record_function('bench.batcher'):
                        r, p = next(system.batcher)
                    with record_function('bench.dispatch'):
                        train_many(state, r, p, seed)
                sync(device)
            traced_window = trace.profile(tail)
            phases('trace')
        peak = peak_bytes(device)
        system.batcher.close()
        del system, state, opt, train_many, rays, pixels, aux
        free(device)

        # The reference over the same three steps.
        views = scenes.views(config['scene'], scene, 'train',
                                      bool(hp['train.white_bkgd']))
        idx = reference.batch_indices(views.num_rays, seed, k, b)[:3]
        batches = [(views.rays(i, device), views.pixels(i, device))
                   for i in idx]
        ref = reference.train(params0, batches, hp, seed)
        numbers = compare.train_numbers(first, ref, params0)
        phases('reference')
        readings = _train_witnesses(first, ref, params0, batches, hp, seed,
                                    extra)
        phases.report()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        'kind': 'train', 'setup_s': setup_s, 'attempted': steps,
        'failed': failed,
        'end_to_end': {'train_rays_per_s': steps * b / window_s,
                       'setup_s': setup_s},
        'window': {'seconds': window_s, 'steps': steps,
                   'dispatch_host_s': host_s, 'batcher_wait_s': wait_s},
        'trace': traced_window,
        'traced_units': int(mix['trace_dispatches']) * k,
        'unit_flop': work.step_flop(hp), 'unit_bytes': work.step_bytes(hp),
        'peak_flops': work.PEAKS[config['peak']],
        'peak_bytes': peak, 'numbers': numbers, 'readings': readings,
    }


# The reference's variants a calibration reads beside the program.
TRAIN_WITNESSES = {
    'tf32': {'precision': 'tf32'},            # the control
    'half_batch': {'half_batch': True},       # a planted fault
    'f64': {'precision': 'f64'},
    '3xtf32': {'precision': '3xtf32'},
    'f32_rows2': {'row_chunks': 2},
    'f32_rows3': {'row_chunks': 3},
}


def _train_witnesses(first, ref, params0, batches, hp, seed, names) -> Dict:
    """Each named variant's numbers against the float32 reference; with
    'f64' also every variant's and the program's against the float64
    reference, and the leaves of the largest change gaps."""
    runs = {name: reference.train(params0, batches, hp, seed,
                                  **TRAIN_WITNESSES[name]) for name in names}
    out = {name: compare.train_numbers(r, ref, params0)
           for name, r in runs.items()}
    if not names:
        return out

    def worst(side, against):
        _, update = compare.train_leaf_gaps(side, against, params0)
        return sorted(update.items(), key=lambda kv: -kv[1])[:3]
    out['leaves'] = {'program': worst(first, ref),
                     'quiet': compare.quiet_leaves(ref['grad'])}
    if 'f64' in runs:
        f64 = runs['f64']
        sides = dict(program=first, f32=ref,
                     **{n: r for n, r in runs.items() if n != 'f64'})
        out['vs_f64'] = {n: compare.train_numbers(r, f64, params0)
                         for n, r in sides.items()}
        out['leaves_vs_f64'] = {n: worst(r, f64) for n, r in sides.items()}
    return out
