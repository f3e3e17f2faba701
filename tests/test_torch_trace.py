"""The port's spans (mipnerf_pl_tpu_torch/utils/trace.py) on the CPU.

With no profiler a span is one shared no-op and a training dispatch and a
render enter no `record_function`.  Under torch.profiler a K = 2 dispatch
records one `mip.dispatch` holding each step's `mip.model`, `mip.backward`
and `mip.adam` in that order, and a frame one `mip.frame` holding a
`mip.model` a chunk and then its `mip.to_host`.  `fit`'s summary adds up
the phase spans into the phases and call counts it always printed.  A tiny
model (depth 2, width 32, 8 samples) on the kernels' plain versions, which
launch no kernel, so no `mip.launch` appears here.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers import make_blender_scene
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.ops.camera import (Camera, camera_rays,
                                             pix2cam_from_focal)
from mipnerf_pl_tpu_torch.rays import Rays
from mipnerf_pl_tpu_torch.system import MipNeRFSystem
from mipnerf_pl_tpu_torch.utils import trace
from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses

TINY = {'exp_name': 'tiny', 'train.batch_size': 16, 'nerf.num_samples': 8,
        'nerf.max_deg_point': 4, 'nerf.deg_view': 2, 'nerf.mlp.net_depth': 2,
        'nerf.mlp.net_width': 32, 'nerf.mlp.net_width_condition': 16,
        'val.chunk_size': 16, 'val.sample_num': 1, 'val.check_interval': 2,
        'train.steps_per_call': 2, 'optimizer.lr_delay_steps': 0}
SIDE = 8


def _system():
    hp = config.default()
    hp.update(TINY)
    return MipNeRFSystem(hp, device='cpu')


def _stack(k: int, b: int):
    """A [k, b, ...] dispatch stack of rays toward the origin, and pixels."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(k, b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((k, b, 1), np.float32)
    rays = Rays(-4.0 * d, d, d, ones * 0.005, ones, ones * 2.0, ones * 6.0)
    return (Rays(*(torch.from_numpy(f) for f in rays)),
            torch.from_numpy(rng.uniform(size=(k, b, 3)).astype(np.float32)))


def _camera():
    pose = create_spheric_poses(4.0, n_poses=4)[1].astype(np.float32)
    return Camera(torch.from_numpy(pose),
                  torch.from_numpy(pix2cam_from_focal(SIDE, SIDE, 10.0)),
                  2.0, 6.0, 1.0)


def _render(system, params, how: str):
    """A SIDE x SIDE frame in 16-ray chunks (4 chunks)."""
    cam = _camera()
    if how == 'camera':
        return system.render_camera(params, cam, SIDE, SIDE)
    return system.render_image(params, camera_rays(cam, SIDE, SIDE))


def _spans(prof):
    """[(name, start us, end us)] of the mip.* spans, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith('mip.')),
                  key=lambda s: s[1])


def _inside(spans, outer: str):
    (_, a, b), = [s for s in spans if s[0] == outer]
    inner = [s for s in spans if s[0] != outer]
    assert all(a <= s <= e <= b for _, s, e in inner), spans
    return [name for name, _, _ in inner]


def test_off_span_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert trace.span('mip.dispatch') is trace.span('mip.launch') \
        is trace._OFF


def test_off_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) with no profiler')
    monkeypatch.setattr(trace, 'record_function', refuse)
    system = _system()
    state = system.init_state()
    rays, pixels = _stack(2, 16)
    state, aux = system.make_train_many()(state, rays, pixels, 0)
    assert state['step'] == 2 and aux['loss'].shape == (2,)
    for how in ('camera', 'image'):
        out = _render(system, state['params'], how)
        assert out['fine_rgb'].shape == (SIDE, SIDE, 3)


def test_dispatch_spans_under_the_profiler():
    system = _system()
    state = system.init_state()
    rays, pixels = _stack(2, 16)
    train_many = system.make_train_many()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_many(state, rays, pixels, 0)
    assert _inside(_spans(prof), 'mip.dispatch') == [
        'mip.model', 'mip.backward', 'mip.adam'] * 2


@pytest.mark.parametrize('how', ['camera', 'image'])
def test_frame_spans_under_the_profiler(how):
    system = _system()
    params = system.init_params()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(system, params, how)
    assert _inside(_spans(prof), 'mip.frame') == ['mip.model'] * 4 + [
        'mip.to_host']


def test_phases_sum_only_while_collected():
    totals = trace.PhaseTotals()
    with trace.collect(totals):
        for _ in range(2):
            with trace.span('mip.batch'):
                pass
        with trace.span('mip.model'):       # not one of fit's phases
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span('mip.dispatch'):
                pass
    with trace.span('mip.batch'):
        pass
    assert totals.counts == {'data': 2, 'train_dispatch': 1}
    assert [s[0] for s in _spans(prof)] == ['mip.dispatch']


def test_fit_prints_its_phases(tmp_path, capsys):
    scene = make_blender_scene(str(tmp_path / 'scene'), n_frames=2,
                               size=SIDE)
    system = _system()
    system.fit(scene, 'blender', str(tmp_path / 'out'), max_steps=4)
    out = capsys.readouterr().out
    lines = out[out.index('profiler summary'):].splitlines()[1:]
    counts = {line.split()[0]: int(line.split('|')[1]) for line in lines
              if '|' in line}
    # Two dispatches of 2 steps, each followed by a validation.
    assert counts == {'data': 2, 'train_dispatch': 2, 'train_sync': 2,
                      'validate': 2, 'checkpoint': 2}
    assert system.fit_stats['steps'] == 4
    assert 0.0 < system.fit_stats['data_wait_share'] < 1.0
