"""Every cell end to end at a small size on the CPU, through the port's
plain versions of its kernels: the program against the plain reference
(`correct`), the end-to-end and host-side per-layer metrics, and the
yardstick's arithmetic (work counts, trace reduction)."""

from __future__ import annotations

import math
import time

import pytest
import torch

from benchmark import harness, readers, reference, trace, work
from benchmark.run import run_cell
from benchmark.tests import tiny

MAN = harness.manifest()
CELLS = [w['name'] for w in MAN['workloads']]
DEVICE_TIME_METRICS = [m['name'] for m in MAN['per_layer']
                       if '_ms_per_' in m['name']
                       and m['source'] == 'device_trace']


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp('checkout'))


@pytest.mark.parametrize('cell', CELLS)
def test_cell_end_to_end(small, cell):
    line = run_cell(cell, 2**31 + 17, 0.2, False, 'cpu', time.perf_counter(),
                    root=small)
    assert line['correct'], line['checks']
    assert line['failed'] == 0 and line['attempted'] > 0
    wl = harness.cell(cell, MAN, small)[0]
    want = {m['name'] for m in harness.metrics_of(wl, MAN, 'end_to_end')}
    assert set(line['metrics']) == want
    assert all(v['value'] > 0 for v in line['metrics'].values())
    assert list(line)[-1] == 'checks' and line['checks']
    assert line['device']['platform'] == 'cpu'


@pytest.mark.parametrize('cell', CELLS)
def test_cell_traced(small, cell):
    """On the CPU the trace has no device operation: the device readers
    return nothing, the host readers their numbers."""
    line = run_cell(cell, 23, 0.2, True, 'cpu', time.perf_counter(),
                    root=small)
    assert line['correct'], line['checks']
    wl = harness.cell(cell, MAN, small)[0]
    per_layer = {m['name']: m for m in harness.metrics_of(wl, MAN,
                                                          'per_layer')}
    assert set(line['metrics']) <= set(per_layer)
    for name, value in line['metrics'].items():
        assert per_layer[name]['source'] != 'device_trace'
        assert math.isfinite(value['value'])
    assert line['device']['busy_s'] == 0
    assert line['device']['window_s'] > 0
    assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}


@pytest.mark.parametrize('cell', ['lego.train', 'real360.train'])
def test_controls_read_larger_than_the_program(small, cell):
    line = run_cell(cell, 41, 0.1, False, 'cpu', time.perf_counter(),
                    ('tf32', 'half_batch', 'f64', '3xtf32', 'f32_rows2'),
                    root=small)
    prog, readings = line['checks'], line['readings']
    assert readings['tf32']['loss_gap'] > prog['loss_gap']['value']
    assert all(readings['half_batch'][k] > 10 * v['value']
               for k, v in prog.items())
    # The float32 witnesses: another order of the same sums reads the
    # program's own loss; every side is also read against float64.
    assert readings['f32_rows2']['loss_gap'] < 1e-6
    assert set(readings['vs_f64']) == {'program', 'f32', 'tf32',
                                       'half_batch', '3xtf32', 'f32_rows2'}


def test_same_seed_same_inputs(small):
    a = run_cell('lego.train', 7, 0.1, False, 'cpu', time.perf_counter(),
                 root=small)
    b = run_cell('lego.train', 7, 0.1, False, 'cpu', time.perf_counter(),
                 root=small)
    assert a['checks'] == b['checks']


def test_work_counts_of_the_published_configs():
    _, lego, _ = harness.cell('lego.train')
    hp = lego['hparams']
    assert work.step_flop(hp) == pytest.approx(2.786e12, rel=1e-3)
    assert work.frame_flop(hp, 800 * 800) == pytest.approx(198.9e12,
                                                           rel=1e-3)
    _, r360, _ = harness.cell('real360.train')
    assert work.xyz_features(r360['hparams']) == 42
    assert work.step_flop(r360['hparams']) < work.step_flop(hp)
    assert work.bound_s(work.step_flop(hp), work.step_bytes(hp),
                        work.PEAKS['tf32']) == pytest.approx(5.63e-3,
                                                             rel=1e-2)


def test_reference_layout_matches_the_work_counts():
    _, lego, _ = harness.cell('lego.train')
    shapes, _, _ = work.layer_shapes(lego['hparams'])
    layout = reference.mlp_layout(lego['hparams'])
    assert [(i, o) for _, i, o in layout] == shapes


def test_weights_from_the_seed():
    _, lego, _ = harness.cell('lego.train')
    a = harness.weights(lego['hparams'], 3, 'cpu')
    b = harness.weights(lego['hparams'], 3, 'cpu')
    c = harness.weights(lego['hparams'], 4, 'cpu')
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['mlp.trunk_0.weight'], c['mlp.trunk_0.weight'])
    w = a['mlp.trunk_0.weight']
    assert w.abs().max() <= (6 / sum(w.shape)) ** 0.5


def _events():
    return [('user_annotation', 'bench.window', 0, 1000, 1),
            ('cpu_op', 'aten::a', 100, 400, 1),
            ('cpu_op', 'aten::b', 150, 250, 1),
            ('cpu_op', 'producer', 0, 900, 2),
            ('gpu_user_annotation', 'bench.window', 0, 900, 0),
            ('kernel', 'void (anonymous namespace)::lean_fwd_kernel<>()',
             50, 120, 0),
            ('kernel', 'lean_chain_kernel', 260, 300, 0),
            ('kernel', 'void at::native::elementwise_kernel<>()', 500, 700,
             0),
            ('kernel', 'aten::a', 0, 5, 0)]


def test_trace_reduction():
    tr = trace.reduce_events(_events())
    assert tr['window_s'] == pytest.approx(1e-6)
    assert len(tr['device']) == 3           # the annotation mirrors dropped
    assert [h[0] for h in tr['host']] == ['aten::a', 'aten::b']
    assert trace.busy_s(tr) == pytest.approx(3.1e-7)
    library = readers.patterns('torch_library')
    assert trace.device_seconds(tr, library, True) == pytest.approx(2e-7)
    assert trace.device_seconds(tr, library, False) == pytest.approx(1.1e-7)
    gaps = dict(trace.breakdown(tr)['idle_gaps'])
    assert gaps['aten::b'] == pytest.approx(1.4e-7)
    assert sum(gaps.values()) == pytest.approx(1e-6 - 3.1e-7)


def test_trace_event_categories_without_activity_type():
    class Old:
        def __init__(self, name, device):
            self._n, self._d = name, device

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def start_ns(self):
            return 10

        def duration_ns(self):
            return 5

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    assert trace._event(Old('k', cuda))[0] == 'kernel'
    assert trace._event(Old('bench.window', cuda))[0] == 'gpu_user_annotation'
    assert trace._event(Old('bench.window', cpu))[0] == 'user_annotation'
    assert trace._event(Old('cudaLaunchKernel', cpu))[0] == 'cuda_runtime'
    assert trace._event(Old('aten::mm', cpu))[:4] == ('cpu_op', 'aten::mm',
                                                      10, 15)


@pytest.mark.parametrize('name', ['void at::native::vectorized_elementwise_kernel<4>()',
                                  'Memcpy HtoD (Pinned -> Device)',
                                  'void cutlass::Kernel2<x>()',
                                  'sm90_xmma_gemm_f32f32_tf32f32_f32_nn'])
def test_torch_library_kernels(name):
    for metric in DEVICE_TIME_METRICS:
        assert harness.metric_module(metric).LIBRARY.search(name)


@pytest.mark.parametrize('name', ['void (anonymous namespace)::lean_chain_tf32_kernel<false, false>(TcPlan)',
                                  '(anonymous namespace)::wgrad_tf32_kernel(WgradMaps)',
                                  'void (anonymous namespace)::ipe_fwd_kernel()'])
def test_port_kernels(name):
    for metric in DEVICE_TIME_METRICS:
        assert not harness.metric_module(metric).LIBRARY.search(name)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -12, 1.0 + 2 ** -10, -3.0 - 2 ** -11])
    r = reference._round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2 ** -10
    assert r[3] in (-3.0, -3.0 - 2 ** -10)
