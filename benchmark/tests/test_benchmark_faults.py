"""A run whose timed path is broken underneath reads `correct` false: once
for each fault a cell can have.  The runs skip the look for a card and
run on the CPU at a small size (one chip a cell: no exchange between
chips to leave out)."""

from __future__ import annotations

import time

import pytest

from benchmark.run import run_cell
from benchmark.tests import tiny


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp('checkout'))


def _run(small, cell):
    return run_cell(cell, 97, 0.1, False, 'cpu', time.perf_counter(),
                    root=small)


@pytest.mark.parametrize('cell', ['lego.train', 'real360.train'])
def test_sound_run_is_correct(small, cell):
    assert _run(small, cell)['correct']


@pytest.mark.parametrize('cell', ['lego.train', 'real360.train'])
def test_step_returning_its_state_unchanged(small, cell, monkeypatch):
    import mipnerf_pl_tpu_torch.system as system

    def no_update(opt, grads, step, schedule):
        return schedule(step)
    monkeypatch.setattr(system, 'adam_step', no_update)
    line = _run(small, cell)
    assert not line['correct']
    assert line['checks']['grad_gap']['value'] == pytest.approx(1.0)
    assert line['checks']['update_gap']['value'] > 0.9


@pytest.mark.parametrize('cell', ['lego.train', 'real360.train'])
def test_half_the_batch_left_out(small, cell, monkeypatch):
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    from mipnerf_pl_tpu_torch.rays import namedtuple_map
    whole = MipNeRFSystem.value_and_grad

    def half(self, params, rays, pixels, generator=None):
        n = pixels.shape[0] // 2
        return whole(self, params, namedtuple_map(lambda x: x[:n], rays),
                     pixels[:n], generator)
    monkeypatch.setattr(MipNeRFSystem, 'value_and_grad', half)
    line = _run(small, cell)
    assert not line['correct']


def test_render_answer_altered(small, monkeypatch):
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    render = MipNeRFSystem.render_camera

    def altered(self, *args, **kwargs):
        out = render(self, *args, **kwargs)
        out['fine_rgb'] = out['fine_rgb'] + 1e-3
        return out
    monkeypatch.setattr(MipNeRFSystem, 'render_camera', altered)
    line = _run(small, 'lego.render')
    assert not line['correct']
    assert line['checks']['rgb_gap']['value'] >= 9e-4


def test_train_loss_altered(small, monkeypatch):
    from mipnerf_pl_tpu_torch.system import MipNeRFSystem
    make = MipNeRFSystem.make_train_many

    def altered(self):
        many = make(self)

        def wrapped(*args):
            state, aux = many(*args)
            aux['loss'] = aux['loss'] * (1 + 1e-4)
            return state, aux
        return wrapped
    monkeypatch.setattr(MipNeRFSystem, 'make_train_many', altered)
    assert not _run(small, 'lego.train')['correct']
