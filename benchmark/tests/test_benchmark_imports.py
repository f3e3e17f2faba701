"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'mipnerf_pl_tpu'}
MODULES = sorted(p for p in harness.HERE.rglob('*.py')
                 if 'tests' not in p.parts)


def top_level_imports(path) -> set:
    """The top-level name (before the first dot) of every import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', MODULES,
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_port_is_not_the_jax_package():
    # A whole-name comparison: the port's name begins with the JAX
    # package's.
    assert 'mipnerf_pl_tpu_torch'.split('.')[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = top_level_imports(harness.HERE / 'reference.py')
    assert not names & (FORBIDDEN | {'mipnerf_pl_tpu_torch', 'benchmark'})


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole small run in a fresh interpreter, then sys.modules."""
    from benchmark.tests import tiny
    tiny.make(tmp_path)
    code = ('import time, json; from pathlib import Path; '
            'from benchmark.run import run_cell; from benchmark import harness; '
            f'run_cell("lego.train", 5, 0.1, False, "cpu", time.perf_counter(), '
            f'root=Path({str(tmp_path)!r})); '
            'print(json.dumps(harness.forbidden_modules()))')
    out = subprocess.run([sys.executable, '-c', code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'mipnerf_pl_tpu_torch_fake', object())
    assert 'mipnerf_pl_tpu' not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'flax.core', object())
    assert 'flax' in harness.forbidden_modules()
