"""The training sampler's batch gather in C++ (gather.cpp), through ctypes.

`gather_multi(arrays, idx)` returns `[a[idx] for a in arrays]`: the same
rows of several arrays.  The arrays that are C-contiguous and 2-D, of any
element type but object, are gathered in one pass over the indices by the
library, which copies rows as bytes; any other input takes numpy
indexing, with the same result.

The library is built with g++ at first use:

    g++ -O3 -shared -fPIC -std=c++17 -pthread -o _build/libgather-<hash>.so \\
        gather.cpp

into `mipnerf_pl_tpu_torch/_build/` (git-ignored), keyed by a hash of the
source, the flags and the compiler's version, as kernels/_build.py keys
the CUDA builds.  A build that fails raises, naming the compiler and its
output: the gather never drops to numpy without a word.  Nothing is built
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'gather.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17', '-pthread']
CXX = 'g++'

_LIB: Optional[ctypes.CDLL] = None
_LIB_PATH: Optional[Path] = None


def compiler() -> str:
    """The path of the C++ compiler; raises where there is none."""
    found = shutil.which(CXX)
    if not found:
        raise RuntimeError(f'the batch gather is built with {CXX!r}, which '
                           'is not on PATH')
    return found


def build() -> Path:
    """Compile gather.cpp unless its hashed library exists; -> its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    cxx = compiler()
    version = subprocess.run([cxx, '-dumpfullversion', '-dumpversion'],
                             capture_output=True, text=True).stdout.strip()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(' '.join([version, platform.machine(), *FLAGS]).encode())
    so = BUILD_DIR / f'libgather-{h.hexdigest()[:16]}.so'
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    cmd = [cxx, *FLAGS, '-o', str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f'{" ".join(cmd)} failed: {e}') from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'{cxx} failed ({proc.returncode}) building the '
                           f'batch gather:\n{" ".join(cmd)}\n{proc.stderr}')
    os.replace(tmp, so)            # atomic: concurrent builds agree
    return so


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB, _LIB_PATH
    if _LIB is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        lib.gather_multi_rows.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int]
        lib.gather_multi_rows.restype = None
        _LIB, _LIB_PATH = lib, path
    return _LIB


def loaded() -> Optional[Path]:
    """The path of the library this process loaded, or None."""
    return _LIB_PATH


def native_ok(a) -> bool:
    """Whether an array takes the library: C-contiguous 2-D, its elements
    plain bytes (no Python objects)."""
    return (isinstance(a, np.ndarray) and not a.dtype.hasobject
            and a.ndim == 2 and a.flags['C_CONTIGUOUS'])


def gather_multi(arrays: Sequence[np.ndarray], idx: np.ndarray,
                 n_threads: Optional[int] = None) -> List[np.ndarray]:
    """[a[idx] for a in arrays]: the arrays that are C-contiguous
    [N_f, W_f] in one pass over `idx` through the library, any other by
    numpy indexing.

    Args:
      arrays: the arrays to gather rows from.
      idx: integer [M] row indices, each in [0, N_f) of every array the
        library takes (IndexError otherwise).
      n_threads: threads of a gather of 4096 rows or more (default: up to
        4).
    """
    native = [a for a in arrays if native_ok(a)]
    if not native:
        return [a[idx] for a in arrays]
    lib = library()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError(f'idx must be 1-D, got shape {idx.shape}')
    n_idx = idx.shape[0]
    if n_idx and (idx.min() < 0
                  or idx.max() >= min(a.shape[0] for a in native)):
        raise IndexError('gather_multi: an index is out of range of the '
                         'arrays\' rows')
    outs = [np.empty((n_idx, a.shape[1]), a.dtype) for a in native]
    n = len(native)
    srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in native])
    dsts = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    row_bytes = (ctypes.c_int64 * n)(*[a.shape[1] * a.itemsize
                                       for a in native])
    if n_threads is None:
        n_threads = min(4, os.cpu_count() or 1)
    lib.gather_multi_rows(
        ctypes.cast(srcs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(dsts, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(row_bytes, ctypes.POINTER(ctypes.c_int64)), n,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_idx,
        int(n_threads))
    gathered = iter(outs)
    return [next(gathered) if native_ok(a) else a[idx] for a in arrays]
