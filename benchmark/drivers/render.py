"""The 'render' driver: MipNeRFSystem.render_camera over the scene's
test cameras in turn, each frame on the host, on one card; the pixels
compared are drawn from the seed, mix['sample_pixels'] a frame."""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from benchmark import compare, harness, reference, scenes, trace, work
from benchmark.drivers import Phases, free, peak_bytes, sync


# The mix's sizes in the CPU tests' small checkout (benchmark/tests/tiny.py).
SMALL = {'chunk': 64, 'sample_pixels': 32}


def run(config: dict, mix: dict, seed: int, seconds: float, traced: bool,
        devices, t_start: float, extra: tuple = ()) -> Dict:
    from torch.profiler import record_function

    from mipnerf_pl_tpu_torch.system import MipNeRFSystem, make_dataset

    device = devices[0]
    hp = harness.hparams(config, seed)
    chunk, n_pix = int(mix['chunk']), int(mix['sample_pixels'])
    tmp = tempfile.mkdtemp(prefix='bench_')
    phases = Phases(t_start)
    try:
        scene = scenes.write(config['scene'], (mix['split'],), seed,
                             tmp + '/scene', device)
        phases('scene')
        system = MipNeRFSystem(hp, device=device)
        params = harness.weights(hp, seed, device)
        harness.check_layout(params, system.eval_model)
        data = make_dataset(hp, config['scene']['dataset'], scene,
                            mix['split'])
        cams = [data.camera(i) for i in range(len(data))]
        h, w = cams[0][1]
        phases('program')

        def frame(i):
            return system.render_camera(params, cams[i % len(cams)][0], h, w,
                                        chunk_size=chunk,
                                        need_coarse=bool(mix['need_coarse']))
        for i in range(int(mix['warm_frames'])):
            frame(i)
        sync(device)
        setup_s = time.perf_counter() - t_start
        phases('warm')

        rng = np.random.default_rng([int(seed), 2])
        kept, frames, failed = [], 0, 0
        t0 = time.perf_counter()
        while True:
            out = frame(frames)
            t = time.perf_counter()
            pix = rng.integers(0, h * w, size=n_pix)
            kept.append((frames % len(cams), pix,
                         {name: out[name].reshape(h * w, -1)[pix]
                          for name in ('coarse_rgb', 'fine_rgb', 'acc')}))
            failed += int(not all(np.isfinite(v).all() for v in out.values()))
            frames += 1
            if t - t0 >= seconds:
                break
        window_s = t - t0
        phases('window')

        traced_window = None
        if traced:
            def tail():
                for i in range(int(mix['trace_frames'])):
                    with record_function('bench.frame'):
                        frame(i)
            traced_window = trace.profile(tail)
            phases('trace')
        peak = peak_bytes(device)
        del system, data, out
        free(device)

        # The reference at the kept pixels of every frame.
        views = scenes.views(config['scene'], scene, mix['split'],
                                      bool(hp['train.white_bkgd']))
        index = np.concatenate([v * h * w + pix for v, pix, _ in kept])
        ref_rays = views.rays(index, device)
        side = {name: torch.as_tensor(np.concatenate(
            [o[name] for _, _, o in kept]), device=device)
            for name in ('coarse_rgb', 'fine_rgb', 'acc')}
        ref = reference.render(params, ref_rays, hp, chunk)
        ref['acc'] = ref['acc'][:, None]
        numbers = compare.render_numbers(side, ref)
        phases('reference')
        readings = {}
        if 'tf32' in extra:
            ctl = reference.render(params, ref_rays, hp, chunk, 'tf32')
            ctl['acc'] = ctl['acc'][:, None]
            readings['tf32'] = compare.render_numbers(ctl, ref)
        phases.report()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pixels = h * w
    return {
        'kind': 'render', 'setup_s': setup_s, 'attempted': frames,
        'failed': failed,
        'end_to_end': {'render_s_per_frame': window_s / frames,
                       'setup_s': setup_s},
        'window': {'seconds': window_s, 'frames': frames},
        'trace': traced_window,
        'traced_units': int(mix['trace_frames']),
        'unit_flop': work.frame_flop(hp, pixels),
        'unit_bytes': work.frame_bytes(hp, pixels),
        'peak_flops': work.PEAKS[config['peak']],
        'peak_bytes': peak, 'numbers': numbers, 'readings': readings,
    }
