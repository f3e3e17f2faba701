"""benchmark/spans.py and the readers of the port's spans on a hand-made
reduced trace: the union of a span's intervals (repeated and nested spans
of one name count once), a layer's own time less its child spans, the
division by the traced units, and None where the span is missing."""

from __future__ import annotations

import pytest

from benchmark import harness, spans

# Two dispatches of two steps (seconds from the window's start), the
# second dispatch holding a nested span of its own name, and a frame.
HOST = [
    ('mip.dispatch', 0.0, 1.0),
    ('mip.model', 0.1, 0.3), ('mip.backward', 0.3, 0.6),
    ('mip.adam', 0.6, 0.65),
    ('mip.model', 0.7, 0.8), ('aten::mm', 0.72, 0.74),
    ('mip.backward', 0.8, 0.9), ('mip.adam', 0.9, 0.95),
    ('mip.dispatch', 2.0, 2.5), ('mip.dispatch', 2.1, 2.2),
    ('mip.model', 2.1, 2.2),
    ('mip.frame', 3.0, 4.0), ('mip.model', 3.1, 3.5),
    ('mip.launch', 3.2, 3.3), ('mip.model', 3.5, 3.7),
    ('mip.to_host', 3.8, 4.0),
]


def _res(host, units=4):
    return {'trace': {'window_s': 5.0, 'device': [], 'host': host},
            'traced_units': units}


def test_a_span_is_the_union_of_its_intervals():
    # 1.0 + 0.5: the nested mip.dispatch lies inside the second.
    assert spans.ms_per_unit(_res(HOST), 'mip.dispatch') == \
        pytest.approx(1e3 * 1.5 / 4)
    assert spans.ms_per_unit(_res(HOST, units=1), 'mip.launch') == \
        pytest.approx(100.0)


def test_own_time_is_less_the_children():
    # 1.5 s of dispatch less 0.2 + 0.3 + 0.05 + 0.1 + 0.1 + 0.05 + 0.1.
    entry = spans.ms_per_unit(_res(HOST), 'mip.dispatch',
                              ('mip.model', 'mip.backward', 'mip.adam'))
    assert entry == pytest.approx(1e3 * (1.5 - 0.9) / 4)
    # A child outside its parent takes nothing from it: the frame's
    # mip.model counts against the frame only.
    frame = spans.ms_per_unit(_res(HOST, units=1), 'mip.frame',
                              ('mip.model', 'mip.to_host'))
    assert frame == pytest.approx(1e3 * (1.0 - 0.6 - 0.2))


def test_the_parts_tile_the_span():
    # The training spans apart from the frame (whose mip.model would count
    # in train.model_host_ms_per_step too).
    res_train = _res([e for e in HOST if e[1] < 3.0])
    parts = [harness.reader(f'train.{name}_host_ms_per_step')(res_train)
             for name in ('entry', 'model', 'backward', 'optimizer')]
    assert sum(parts) == pytest.approx(
        spans.ms_per_unit(res_train, 'mip.dispatch'))
    res_frame = _res([e for e in HOST if e[1] >= 3.0], units=1)
    parts = [harness.reader(f'render.{name}_ms_per_frame')(res_frame)
             for name in ('entry_host', 'model_host', 'to_host')]
    assert sum(parts) == pytest.approx(1e3)
    assert harness.reader('render.launch_host_ms_per_frame')(res_frame) == \
        pytest.approx(100.0)


@pytest.mark.parametrize('metric', [
    'train.entry_host_ms_per_step', 'train.model_host_ms_per_step',
    'train.backward_host_ms_per_step', 'train.optimizer_host_ms_per_step',
    'render.entry_host_ms_per_frame', 'render.model_host_ms_per_frame',
    'render.launch_host_ms_per_frame', 'render.to_host_ms_per_frame'])
def test_none_without_the_span(metric):
    read = harness.reader(metric)
    assert read({'trace': None, 'traced_units': 2}) is None
    assert read(_res([('aten::mm', 0.0, 1.0)])) is None
    assert read({'traced_units': 2}) is None
