"""BENCHMARK.json against the benchmark's contract: names, units, keys,
what each cell reports, and that every file a cell needs is there."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TOP = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
       'end_to_end', 'per_layer'}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def _names():
    out = []
    for kind in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        out += [(kind, e['name']) for e in MAN[kind]]
    out += [('config', w['config']) for w in MAN['workloads']]
    out += [('traffic', w['traffic']) for w in MAN['workloads']]
    out += [('reduced', k) for c in MAN['configs'] for k in c['reduced']]
    return out


def test_top_level_keys_and_sizes():
    assert set(MAN) == TOP
    assert 1 <= MAN['run_seconds'] <= 51
    assert 1 <= len(MAN['paths']) <= 16
    assert len(MAN['command']) <= 32
    assert (harness.ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024
    for path in MAN['paths']:
        assert re.fullmatch(r'[A-Za-z0-9_./-]{1,200}', path)
        assert not path.startswith('/') and '..' not in path


@pytest.mark.parametrize('kind,name', _names())
def test_name(kind, name):
    assert NAME.match(name), (kind, name)


def test_names_unique():
    for kind in ('configs', 'workloads'):
        names = [e['name'] for e in MAN[kind]]
        assert len(names) == len(set(names))
    metrics = [m['name'] for m in MAN['end_to_end'] + MAN['per_layer']]
    assert len(metrics) == len(set(metrics))
    pairs = [(w['config'], w['traffic']) for w in MAN['workloads']]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize('metric', [m['name'] for m in
                                    MAN['end_to_end'] + MAN['per_layer']])
def test_metric_entry(metric):
    m = {e['name']: e for e in MAN['end_to_end'] + MAN['per_layer']}[metric]
    assert UNIT.match(m['unit'])
    assert m['better'] in ('lower', 'higher')
    assert m['source'] in SOURCES
    if m in MAN['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    else:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert 1 <= len(m['layer']) <= 200 and '\n' not in m['layer']
        assert (harness.HERE / 'metrics' / f'{metric}.py').is_file()
        if 'roofline' in metric or 'mfu' in metric or 'share' in metric:
            assert m['unit'] == '%'


def test_setup_bound():
    setup = {m['name']: m for m in MAN['end_to_end']}['setup_s']
    assert setup['bound'] <= 0.25 and 'workloads' not in setup


@pytest.mark.parametrize('metric', [m['name'] for m in MAN['per_layer']])
def test_per_layer_cells_report_what_it_moves(metric):
    m = {e['name']: e for e in MAN['per_layer']}[metric]
    moved = {e['name']: e for e in MAN['end_to_end']}[m['moves']]
    for cell in m['workloads']:
        assert cell in {w['name'] for w in MAN['workloads']}
        assert 'workloads' not in moved or cell in moved['workloads']


def test_layer_names_are_consistent():
    layers = {}
    for m in MAN['per_layer']:
        layers.setdefault(m['layer'].split(':')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize('cell', [w['name'] for w in MAN['workloads']])
def test_cell(cell):
    wl, config, mix = harness.cell(cell)
    assert set(wl) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert wl['chips'] in (1, 4)
    assert 1 <= len(wl['why']) <= 200 and '\n' not in wl['why']
    assert (harness.HERE / 'drivers' / f'{mix["driver"]}.py').is_file()
    kind = config['scene']['kind']
    assert (harness.HERE / 'scenes' / f'{kind}.py').is_file()
    e2e = [m['name'] for m in harness.metrics_of(wl, MAN, 'end_to_end')]
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert harness.metrics_of(wl, MAN, 'per_layer')
    limits = config['limits'][mix['driver']]
    assert limits and all(v is None or v > 0 for v in limits.values())


@pytest.mark.parametrize('entry', MAN['configs'], ids=lambda c: c['name'])
def test_config(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert 1 <= len(entry['source']) <= 200 and '\n' not in entry['source']
    assert 'https://' in entry['source']
    assert entry['file'].startswith(tuple(p + '/' for p in MAN['paths']))
    with open(harness.ROOT / entry['file']) as f:
        config = json.load(f)
    assert config['name'] == entry['name']
    assert config['peak'] in __import__('benchmark.work').work.PEAKS
    for key in entry['reduced']:
        assert key in config, key
    assert len(entry['reduced']) <= 16
    used = [w for w in MAN['workloads'] if w['config'] == entry['name']]
    assert used


def test_four_chip_cells_at_most_a_quarter():
    four = [w for w in MAN['workloads'] if w['chips'] == 4]
    assert len(four) <= max(1, len(MAN['workloads']) // 4)


def test_a_full_check_fits_its_time():
    n = 24
    seconds = ((2 + 14 * n) * (MAN['run_seconds'] + 60) + n * 2 * 90
               + 1200)
    assert seconds <= 43200
