"""The port's multi-scale tools (acceptance, ablation, distloss_ablation)
and camera visualizer against the JAX package's (CPU).

The tools: each runs end to end with --device cpu through its subprocess
stages (cli.convert, cli.train, cli.eval) on a 16 px scene with a tiny
model, exits 0, and its report equals the one the JAX tool writes from the
same eval outputs (the JAX tool run with its stages stubbed, reading the
port's psnrs.txt / ssims.txt); a failed stage makes the tool exit
non-zero; with stubbed stages on both sides both reports agree byte for
byte but for the time stamp; per_scale and summarize_results equal the
JAX package's.  The visualizer: frusta, loaders and the HTML viewer equal
the JAX module's, and the PNG is written.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from helpers import make_blender_scene
from mipnerf_pl_tpu.utils import metrics as jmetrics
from mipnerf_pl_tpu.utils import visualize_cameras as jvis
from mipnerf_pl_tpu_torch.data.convert import convert_to_nerfdata
from mipnerf_pl_tpu_torch.tools import acceptance, ablation, distloss_ablation
from mipnerf_pl_tpu_torch.tools import stages
from mipnerf_pl_tpu_torch.utils import metrics
from mipnerf_pl_tpu_torch.utils import visualize_cameras as vis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {'acceptance': acceptance, 'ablation': ablation,
         'distloss_ablation': distloss_ablation}
# Each tool's report files, and the experiments it evaluates.
REPORTS = {'acceptance': ('ACCEPTANCE.md', 'acceptance.json'),
           'ablation': ('ABLATION.md', 'ablation.json'),
           'distloss_ablation': ('DISTLOSS.md', 'distloss.json')}
EXPERIMENTS = {'acceptance': ('acceptance_hard',),
               'ablation': ('multi_ipe', 'multi_pe', 'single_ipe'),
               'distloss_ablation': ('distloss_on', 'distloss_off')}
# A tiny model for the CPU, forwarded to every cli.train run.
TINY = ['train.batch_size', '64', 'nerf.num_samples', '4',
        'nerf.max_deg_point', '2', 'nerf.deg_view', '1',
        'nerf.mlp.net_depth', '3', 'nerf.mlp.net_width', '16',
        'nerf.mlp.net_width_condition', '16', 'nerf.mlp.skip_index', '2',
        'val.chunk_size', '256', 'train.steps_per_call', '2']
N_TEST = stages.SCENE_VIEWS['n_test']


def _env():
    """The stages' environment: this checkout on PYTHONPATH, one thread a
    process (torch's default of a thread a core oversubscribes the host
    beside the other pytest workers)."""
    return dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]))


def _jax_tool(name):
    """The root tools/<name>.py, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f'jax_tool_{name}', os.path.join(ROOT, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flags(args):
    """{--flag: value} of a command line's flags that take one value."""
    return {a: b for a, b in zip(args, args[1:]) if a.startswith('--')}


def _argv(name, out, n_down):
    base = ['--out', out, '--size', '16', '--steps', '2',
            '--n_down', str(n_down)]
    if name == 'acceptance':
        base += ['--scene', 'hard', '--val_interval', '2']
    return base


def _write_metrics(flags, n_down):
    """A stub eval: seeded psnrs.txt / ssims.txt for the checkpoint's
    experiment under --out_dir, N_TEST views x n_down buckets."""
    exp = os.path.basename(flags['--ckpt'].rstrip('/'))
    rng = np.random.default_rng(sum(map(ord, exp)))
    exp_dir = os.path.join(flags['--out_dir'], 'test', exp)
    os.makedirs(exp_dir, exist_ok=True)
    n = N_TEST * n_down
    for fname, lo, hi in (('psnrs.txt', 18.0, 32.0), ('ssims.txt', 0.5, 1.0)):
        with open(os.path.join(exp_dir, fname), 'w') as f:
            f.write(' '.join(str(v) for v in rng.uniform(lo, hi, n)))


def _run_jax_tool(name, out, n_down, monkeypatch):
    """The JAX tool's main with its stages stubbed: evals write seeded
    metrics unless the port's are there; -> its report files' text."""
    module = _jax_tool(name)

    def run(cmd, **kw):
        if 'eval.py' in cmd:
            flags = _flags(cmd)
            exp = os.path.basename(flags['--ckpt'].rstrip('/'))
            if not os.path.exists(os.path.join(out, 'test', exp,
                                               'psnrs.txt')):
                _write_metrics(flags, n_down)

    monkeypatch.setattr(module, 'run', run)
    monkeypatch.setattr(sys, 'argv', [name] + _argv(name, out, n_down))
    with contextlib.redirect_stdout(io.StringIO()):
        module.main()
    return [open(os.path.join(out, f)).read() for f in REPORTS[name]]


def _normal(text, out):
    """A report with its time stamp and output directory masked."""
    text = re.sub(r'generated: [0-9: -]+', 'generated: <time>', text)
    return text.replace(out, '<out>')


@pytest.mark.parametrize('name', sorted(TOOLS))
def test_reports_equal_jax_tool_on_the_same_metrics(name, tmp_path,
                                                    monkeypatch):
    """Stages stubbed on both sides (an eval writes seeded metrics): the
    port's report files equal the JAX tool's but for the time stamp and
    the output directory, and its JSON has the JAX tool's keys."""
    n_down = 4
    ours_out, theirs_out = str(tmp_path / 'ours'), str(tmp_path / 'theirs')
    commands = []

    def stage(module, argv):
        commands.append((module, argv))
        if module == stages.EVAL:
            _write_metrics(_flags(argv), n_down)

    with contextlib.redirect_stdout(io.StringIO()):
        result = TOOLS[name].main(_argv(name, ours_out, n_down)
                                  + ['--device', 'cpu'], stage=stage)
    theirs = _run_jax_tool(name, theirs_out, n_down, monkeypatch)
    ours = [open(os.path.join(ours_out, f)).read() for f in REPORTS[name]]
    assert _normal(ours[0], ours_out) == _normal(theirs[0], theirs_out)
    assert json.loads(_normal(ours[1], ours_out)) == \
        json.loads(_normal(theirs[1], theirs_out))
    assert json.loads(ours[1]) == json.loads(json.dumps(result))
    # The stages: one convert, a train and an eval per experiment, each
    # with --device.
    modules = [m for m, _ in commands]
    n = len(EXPERIMENTS[name])
    assert modules == [stages.CONVERT] + [stages.TRAIN] * n + \
        [stages.EVAL] * n
    for module, argv in commands[1:]:
        assert _flags(argv)['--device'] == 'cpu'


@pytest.fixture(scope='module')
def tool_runs(tmp_path_factory):
    """python -m mipnerf_pl_tpu_torch.tools.<name> --device cpu of each tool
    at 16 px, 2 steps, 2 levels and a tiny model, the three started at once
    (their stages are mostly process start-up); -> {name: (process, its
    --out, its output file)}.  None is left running afterwards."""
    runs = {}
    for name in sorted(TOOLS):
        root = tmp_path_factory.mktemp(name)
        out, log = str(root / 'ours'), str(root / 'log.txt')
        with open(log, 'w') as f:
            proc = subprocess.Popen(
                [sys.executable, '-m', f'mipnerf_pl_tpu_torch.tools.{name}']
                + _argv(name, out, 2) + ['--device', 'cpu'] + TINY,
                stdout=f, stderr=subprocess.STDOUT, env=_env())
        runs[name] = proc, out, log
    yield runs
    for proc, _, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@pytest.mark.parametrize('name', sorted(TOOLS))
def test_tool_runs_end_to_end_on_the_cpu(name, tool_runs, tmp_path,
                                         monkeypatch):
    """The tool exits 0 through its subprocess stages (cli.convert, and
    cli.train and cli.eval for each experiment); every experiment has its
    checkpoint and finite per-scale metrics; its report equals the one the
    JAX tool writes from the same eval outputs."""
    proc, out, log = tool_runs[name]
    code = proc.wait(timeout=240)
    with open(log) as f:
        text = f.read()
    assert code == 0, text[-3000:]
    assert text.count('+ python -m mipnerf_pl_tpu_torch.cli.') == \
        1 + 2 * len(EXPERIMENTS[name])
    for exp in EXPERIMENTS[name]:
        psnr, ssim = stages.per_scale(out, exp, 2)
        assert np.all(np.isfinite(psnr)) and np.all(np.isfinite(ssim))
        assert os.path.isdir(os.path.join(out, 'ckpt', exp, 'last', '2'))
    # The JAX tool's report from the port's eval outputs.
    theirs_out = str(tmp_path / 'theirs')
    shutil.copytree(os.path.join(out, 'test'),
                    os.path.join(theirs_out, 'test'))
    if name == 'acceptance':
        shutil.copytree(os.path.join(out, 'logs'),
                        os.path.join(theirs_out, 'logs'))
    theirs = _run_jax_tool(name, theirs_out, 2, monkeypatch)
    ours = [open(os.path.join(out, f)).read() for f in REPORTS[name]]
    assert json.loads(_normal(ours[1], out)) == \
        json.loads(_normal(theirs[1], theirs_out))
    assert _normal(ours[0], out) == _normal(theirs[0], theirs_out)


def test_a_failed_stage_fails_the_tool(tmp_path):
    """A stage that fails (cli.convert, its output directory taken by a
    file) stops the tool, which exits non-zero with the stage's
    CalledProcessError and runs no later stage."""
    out = tmp_path / 'out'
    out.mkdir()
    (out / 'multiscale').write_text('a file where the pyramid goes')
    proc = subprocess.run(
        [sys.executable, '-m', 'mipnerf_pl_tpu_torch.tools.distloss_ablation']
        + _argv('distloss_ablation', str(out), 2) + ['--device', 'cpu'],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode != 0
    assert 'CalledProcessError' in proc.stderr
    assert 'mipnerf_pl_tpu_torch.cli.convert' in proc.stdout
    assert 'mipnerf_pl_tpu_torch.cli.train' not in proc.stdout
    assert not (out / 'DISTLOSS.md').exists()


def test_per_scale_and_summary_equal_jax(tmp_path):
    """stages.per_scale equals the JAX tools' per_scale, and the port's
    summarize_results the JAX package's line, on the same files."""
    jax_ablation = _jax_tool('ablation')
    jax_distloss = _jax_tool('distloss_ablation')
    for n_down in (1, 2, 4):
        out = str(tmp_path / f'n{n_down}')
        for exp in ('a', 'b'):
            _write_metrics({'--ckpt': exp, '--out_dir': out}, n_down)
        for exp in ('a', 'b'):
            ours = stages.per_scale(out, exp, n_down)
            for theirs in (jax_ablation.per_scale(out, exp, n_down),
                           jax_distloss.per_scale(out, exp, n_down)):
                for o, t in zip(ours, theirs):
                    np.testing.assert_array_equal(o, t)
        for names in (['a'], ['a', 'b']):
            assert metrics.summarize_results(out, names, n_down) == \
                jmetrics.summarize_results(out, names, n_down)


# -- the camera visualizer -----------------------------------------------


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp('vis')
    blender = make_blender_scene(str(root / 'blender'), n_frames=3, size=16)
    multi = str(root / 'multi')
    convert_to_nerfdata(blender, multi, 2)
    return blender, multi


def test_camera_frustum_equals_jax():
    rng = np.random.default_rng(0)
    for size, focal, length in (((800, 800), 1111.0, 0.5),
                                ((64, 48), 57.3, 0.25)):
        c2w = rng.normal(size=(4, 4))
        ours = vis.get_camera_frustum(size, focal, c2w, length)
        theirs = jvis.get_camera_frustum(size, focal, c2w, length)
        for o, t in zip(ours, theirs):
            np.testing.assert_array_equal(o, t)


@pytest.mark.parametrize('split', ['train', 'test'])
def test_camera_loaders_equal_jax(scene, split):
    blender, multi = scene
    ours = vis.load_blender_cameras(blender, split)
    theirs = jvis.load_blender_cameras(blender, split)
    assert ours[:2] == theirs[:2]
    for o, t in zip(ours[2], theirs[2]):
        np.testing.assert_array_equal(o, t)
    ours = vis.load_multicam_cameras(multi, split)
    theirs = jvis.load_multicam_cameras(multi, split)
    assert len(ours) == len(theirs) == 3 * 2
    for (size, focal, c2w), (jsize, jfocal, jc2w) in zip(ours, theirs):
        assert size == jsize and focal == jfocal
        np.testing.assert_array_equal(c2w, jc2w)


@pytest.mark.parametrize('spheric_path', [False, True])
def test_export_html_writes_the_jax_bytes(scene, tmp_path, spheric_path):
    blender, multi = scene
    size, focal, c2ws = vis.load_blender_cameras(blender)
    sets = [('#4caf50', [(size, focal, c) for c in c2ws]),
            ('blue', vis.load_multicam_cameras(multi))]
    ours = vis.export_html(sets, str(tmp_path / 'ours.html'),
                           spheric_path=spheric_path)
    theirs = jvis.export_html(sets, str(tmp_path / 'theirs.html'),
                              spheric_path=spheric_path)
    with open(ours, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()


def test_visualizer_cli_writes_png_and_html(scene, tmp_path):
    blender, multi = scene
    with contextlib.redirect_stdout(io.StringIO()):
        png = vis.main(['--data_dir', blender,
                        '--out', str(tmp_path / 'c.png')])
        html = vis.main(['--data_dir', multi, '--multi_scale',
                         '--spheric_path', '--out', str(tmp_path / 'c.html')])
    with open(png, 'rb') as f:
        assert f.read(8) == b'\x89PNG\r\n\x1a\n'
    with open(html) as f:
        text = f.read()
    assert text.startswith('<!DOCTYPE html>') and 'const SEGS = [[' in text
    assert text.count('"red"') == 120 * 8


def test_png_without_matplotlib_names_it(scene, tmp_path, monkeypatch):
    blender, _ = scene
    size, focal, c2ws = vis.load_blender_cameras(blender)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='matplotlib'):
        vis.visualize_cameras([('green', [(size, focal, c2ws[0])])],
                              str(tmp_path / 'c.png'))
