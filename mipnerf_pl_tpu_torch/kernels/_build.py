"""Build the package's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled at first use
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

into `mipnerf_pl_tpu_torch/_build/` (git-ignored), keyed by a hash of the
source, of every header it includes from csrc/ (`#include "..."`) and of
the flags, and loaded with ctypes.  `build_all` starts one nvcc per source
at once.  No fast-math flag: the kernels rely on libm's exact expf and on the
IEEE FP64 roundings of csrc/ipe_core.cuh.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
FLAGS = ARCH_FLAGS + ['-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                      '-Xptxas', '-v']
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

# name -> ctypes library; a library stays loaded for the life of the process.
_LOADED: dict = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = Path('/usr/local/cuda/bin/nvcc')
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'source on the GPU machine (PATH or /usr/local/cuda)')


def sources(src: Path) -> list:
    """`src` and the csrc/ headers it includes, transitively, in order."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for path in sources(src):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(' '.join(FLAGS).encode())
    return h.hexdigest()[:16]


def build_all(names) -> dict:
    """Compile each csrc/<name>.cu unless its hashed library exists; the
    nvcc processes run in parallel.

    Returns {name: {'so': path, 'seconds': build time (0.0 if cached),
    'log': compiler output (register / shared-memory use per kernel)}}."""
    started, done = {}, {}
    for name in names:
        src = SRC_DIR / f'{name}.cu'
        so = BUILD_DIR / f'lib{name}-{_digest(src)}.so'
        log = so.with_suffix('.log')
        if so.exists():
            done[name] = {'so': so, 'seconds': 0.0,
                          'log': log.read_text() if log.exists() else ''}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *FLAGS, '-o', str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (src, so, tmp, cmd, proc, time.perf_counter())
    failed = []
    for name, (src, so, tmp, cmd, proc, t0) in started.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f'nvcc failed ({proc.returncode}) for {src}:\n'
                          f'{" ".join(cmd)}\n{text}')
            continue
        so.with_suffix('.log').write_text(text)
        os.replace(tmp, so)            # atomic: concurrent builders agree
        done[name] = {'so': so, 'seconds': seconds, 'log': text}
    if failed:
        raise RuntimeError('\n'.join(failed))
    return done


def load(name: str):
    """The ctypes handle of csrc/<name>.cu, building it on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build_all([name])[name]['so']))
    return _LOADED[name]
