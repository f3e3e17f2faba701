"""The port's bench and render_bench on the CPU, at small sizes.

`python -m mipnerf_pl_tpu_torch.bench` prints the 'xla' line, then the
configured kernel backend's line last, with bench.py's keys and the
gradient-parity gate's; a gate it fails (BENCH_PARITY_TOL=0) exits non-zero
with no line on stdout.  render_bench prints its keys.  These runs check
the control flow and the lines' form: a CPU run gives no device time.
The bench runs at BENCH_BATCH 256, where the bf16 gate passes on the CPU
too (its error falls with the batch: 5.9e-2 at 16 rays, 2.3e-2 at 256).
"""

import json
import os
import subprocess
import sys

import pytest

from mipnerf_pl_tpu_torch import bench, render_bench

SMALL = {'BENCH_BATCH': '256', 'BENCH_K': '1', 'BENCH_NET_WIDTH': '64'}
KEYS = {'metric', 'value', 'unit', 'ms_per_step', 'backend'}


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith('{')]


def test_bench_prints_the_kernel_line_last(monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv('BENCH_MLP_BACKEND', raising=False)
    assert bench.main(['--device', 'cpu']) == 0
    lines = _lines(capsys.readouterr().out)
    assert [x['backend'] for x in lines] == ['xla', 'pallas_lean_save']
    for x in lines:
        assert KEYS <= set(x) and x['metric'] == \
            'train_rays_per_sec_per_chip' and x['value'] > 0
        assert x['net_width'] == 64 and x['unit'] == 'rays/s/chip'
        # Both come from one rate; value is rounded to 0.1 ray/s, which on
        # a loaded CPU (tens of rays/s) moves 1e3 * 256 / value by up to
        # 0.05 / value of itself.
        assert x['ms_per_step'] == pytest.approx(
            1e3 * 256 / x['value'], rel=0.06 / x['value'] + 1e-5)
    assert 'parity_max_leaf_rel_err' not in lines[0]
    assert lines[-1]['parity_ok'] is True
    assert lines[-1]['parity_max_leaf_rel_err'] <= 3e-2
    monkeypatch.setenv('BENCH_MLP_BACKEND', 'xla')
    assert bench.main(['--device', 'cpu']) == 0
    assert [x['backend'] for x in _lines(capsys.readouterr().out)] == ['xla']


def test_bench_failed_gate_exits_nonzero():
    env = dict(os.environ, BENCH_PARITY_TOL='0', **SMALL)
    env.pop('BENCH_MLP_BACKEND', None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, '-m', 'mipnerf_pl_tpu_torch.bench', '--device',
         'cpu'], capture_output=True, text=True, env=env, cwd=root,
        timeout=300)
    assert proc.returncode == 1
    assert _lines(proc.stdout) == []
    assert 'failed the gradient-parity gate' in proc.stderr


def test_bench_knobs(monkeypatch):
    for k, v in {'BENCH_FUSE_RENDER': '1', 'BENCH_FUSE_ENCODE': '0',
                 'BENCH_BATCH': '512', 'BENCH_NET_WIDTH': '128'}.items():
        monkeypatch.setenv(k, v)
    hp = bench.bench_hparams('pallas_lean')
    assert hp['nerf.fuse_render'] is True and hp['nerf.fuse_encode'] is False
    assert hp['train.batch_size'] == 512 and hp['nerf.mlp.net_width'] == 128
    assert hp['train.compute_dtype'] == 'bfloat16'
    assert hp['nerf.mlp_backend'] == 'pallas_lean'
    rays, pixels = bench.synthetic_batch(8)
    assert rays.origins.shape == (8, 3) and pixels.shape == (8, 3)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_render_bench_prints_its_keys(dtype, capsys):
    line = render_bench.main(['--device', 'cpu', '--side', '8',
                              'nerf.num_samples', '8', 'nerf.mlp.net_width',
                              '32', 'nerf.mlp.net_width_condition', '16',
                              'train.compute_dtype', dtype])
    printed = _lines(capsys.readouterr().out)
    assert printed == [line]
    assert {'sec_per_frame', 'rays_per_sec', 'val_backend',
            'chunk'} <= set(line)
    assert line['resolution'] == 8 and line['chunk'] == 8192
    assert line['val_backend'] == 'auto' and line['compute_dtype'] == dtype
    assert line['sec_per_frame'] > 0
