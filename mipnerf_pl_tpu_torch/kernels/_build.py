"""Build the package's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled at first use
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

into `mipnerf_pl_tpu_torch/_build/` (git-ignored), keyed by a hash of the
source and the flags, and loaded with ctypes.  No fast-math flag: the
kernels rely on exact expf/sinf.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    h.update(' '.join(FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> dict:
    """Compile csrc/<name>.cu unless the hashed library already exists.

    Returns {'so': path, 'seconds': build time (0.0 if cached),
    'log': compiler output (register / shared-memory use per kernel)}."""
    src = SRC_DIR / f'{name}.cu'
    so = BUILD_DIR / f'lib{name}-{_digest(src)}.so'
    log = so.with_suffix('.log')
    if so.exists():
        return {'so': so, 'seconds': 0.0,
                'log': log.read_text() if log.exists() else ''}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *FLAGS, '-o', str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed ({proc.returncode}) for {src}:\n'
                           f'{" ".join(cmd)}\n{text}')
    log.write_text(text)
    os.replace(tmp, so)            # atomic: concurrent builders agree
    return {'so': so, 'seconds': seconds, 'log': text}


def load(name: str):
    """The ctypes handle of csrc/<name>.cu, building it on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)['so']))
    return _LOADED[name]

