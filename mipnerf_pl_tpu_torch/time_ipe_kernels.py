"""Build, check and time the standalone IPE kernels on one NVIDIA GPU.

    python3 mipnerf_pl_tpu_torch/time_ipe_kernels.py [checkout] [--composites]
        [--split]

Builds csrc/ipe.cu of `checkout` (default: the current directory), prints
what ptxas says of each kernel, and holds ipe_fwd and ipe_bwd against their
plain versions (forward max |d| <= 1e-5, dmeans and dcovs ||a - b|| / ||b||
<= 1e-5, two runs bit-equal) on these Gaussians:

  random  700 and 393,216 points, means 2 N(0, 1), covs U(0, 1e-3) and
          zeroed, degrees 0..16;
  level   a lego training level: the stratified samples of 3072 of bench.py's
          synthetic rays (as chip_smoke.py makes them), 128 a ray, 0..16;
  near    the level's means scaled to |mean| < 3.2, so that no argument
          mean 2^deg passes 105,615 (beyond it CUDA's exact sincosf takes
          its slow reduction);
  far     the level's means pushed out to |mean| + 3.25, so that every
          degree-15 argument passes 105,615;
  high    the random means at degrees 16..32 (arguments up to 2^34).

Then, at 393,216 points and 16 degrees, each kernel's device time (the sum
of its own kernels' durations in a torch.profiler window) beside its
CUDA-event time (which also counts the host's issue time of each call), the
plain version's event time and the kernel's bound: its bytes (each input
read once, each output written once) over 3.35 TB/s.  ipe_fwd and ipe_bwd
are timed on level, near and far (the split of what the slow reduction
costs).  ipe_moments is held against its plain version (max |d| <= 1e-5,
two runs bit-equal) and timed on the [6, M] moments of: the level; one
render chunk (chip_smoke.py's chunk_inputs: 8192 rays from near the
radius-4 orbit x 128 samples, 1,048,576 points); that chunk with its
means scaled to |mean| < 3.2 (`chunk near`); and the level's means pushed
out as in far (`far`).  --composites adds the device
and event times of lean_composite at a render chunk (8192 rays x 128) and
a training level (3072 x 128) and of lean_composite_bwd at the level.

--split (no checks) copies csrc/ to a temporary directory, adds a
compile-time mask IPE_OFF to the copies of ipe.cu and ipe_core.cuh
(nothing in the checkout changes), builds it once a mask with nvcc, all at
once, and prints the device time of ipe_fwd, ipe_bwd and ipe_moments at the
level, a line a mask: bit 1 their global traffic (the forwards' bulk
stores, the backward's loads of g), 2 the reductions and cores (a cast of
the turns instead), 4 the damping (expf).
A split, not a sum: with a part off the rest may rearrange.

Short enough to be a new kernel's first run on a card; run it on several
checkouts in turns to compare them.  It also prints which optional packages
(PIL, cv2, yaml, tensorboardX) the machine can import, since the run's
entry points use them where present.
"""

import ctypes
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_ARGS = [a for a in sys.argv[1:] if not a.startswith('--')]
sys.path.insert(0, _ARGS[0] if _ARGS else '.')

import chip_smoke as cs  # noqa: E402
from mipnerf_pl_tpu_torch import config  # noqa: E402
from mipnerf_pl_tpu_torch.kernels import _build, ipe  # noqa: E402
from mipnerf_pl_tpu_torch.kernels import mlp as km  # noqa: E402
from mipnerf_pl_tpu_torch.ops.sampling import sample_along_rays  # noqa: E402

DEGREES = (0, 16)
LEVEL_RAYS, SAMPLES = 3072, 128
HBM_RATE = 3.35e12      # bytes/s, NVIDIA H100 SXM data sheet
BAR = 1e-5

# --split: mask -> what it switches off; the edits of the copies of ipe.cu
# and ipe_core.cuh (file -> (text, the text behind the mask's bit, count)).
SPLIT = {0: 'all on', 1: 'global traffic off', 2: 'sin / cos off',
         4: 'damp off', 7: 'all three off'}
SPLIT_EDITS = {
    'ipe.cu': [
        ('      bulk_store(out + m0 * F, rows, whole * 4);',
         '      if (!(IPE_OFF & 1))\n'
         '        bulk_store(out + m0 * F, rows, whole * 4);', 1),
        ('    if (tile >= n_tiles) return;\n',
         '    if (tile >= n_tiles || (IPE_OFF & 1)) return;\n', 1),
        ('damp = expf(-(cov * pow2f(2 * deg - 1)));',
         'damp = (IPE_OFF & 4) ? cov : expf(-(cov * pow2f(2 * deg - 1)));', 1),
        ('damp = expf(-(cov * s2));',
         'damp = (IPE_OFF & 4) ? cov : expf(-(cov * s2));', 1)],
    'ipe_core.cuh': [
        ('float& sn, float& cs) {\n',
         'float& sn, float& cs) {\n  if (IPE_OFF & 2) {\n'
         '    sn = (float)(t.hi * scale);\n    cs = (float)(t.lo * scale);\n'
         '    return;\n  }\n', 1),
        ('  vs = damp * ipe_sin(fs, qs);\n  vc = damp * ipe_sin(fc, q);',
         '  vs = damp * ((IPE_OFF & 2) ? (float)(e.t.hi * scale) : '
         'ipe_sin(fs, qs));\n'
         '  vc = damp * ((IPE_OFF & 2) ? (float)(e.t.lo * scale) : '
         'ipe_sin(fc, q));', 1),
        ('  const float damp = expf(-0.5f * (e.cov * (s * s)));',
         '  const float damp = (IPE_OFF & 4) ? e.cov : '
         'expf(-0.5f * (e.cov * (s * s)));', 1)],
}


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name: str, iters: int = 20) -> float:
    """ms per call of the device kernels whose name holds `name`, from a
    torch.profiler window of `iters` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key
               ) / 1e3 / iters


def split_builds(tmp):
    """{mask: path of the library} built from csrc/ with SPLIT_EDITS."""
    src = os.path.join(tmp, 'csrc')
    shutil.copytree(_build.SRC_DIR, src)
    for name, edits in SPLIT_EDITS.items():
        path = os.path.join(src, name)
        text = open(path).read()
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f'{name} has not {count} of {old!r}')
            text = text.replace(old, new)
        open(path, 'w').write(text)
    path = os.path.join(src, 'ipe.cu')
    procs = {}
    for mask in SPLIT:
        so = os.path.join(tmp, f'libipe-{mask}.so')
        cmd = [_build.nvcc_path(), *_build.FLAGS, f'-DIPE_OFF={mask}', '-o',
               so, path]
        procs[mask] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    out = {}
    for mask, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(text)
        out[mask] = so
    return out


def split_run(m, c, g, moments):
    """--split: one line a mask."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = split_builds(tmp)
        print(f'split builds {time.perf_counter() - t0:.1f} s', flush=True)
        for mask, label in SPLIT.items():
            _build._LOADED['ipe'] = ctypes.CDLL(libs[mask])
            fwd = device_ms(lambda: ipe.ipe_fwd(m, c, *DEGREES),
                            'ipe_fwd_kernel')
            bwd = device_ms(lambda: ipe.ipe_bwd(m, c, g, *DEGREES),
                            'ipe_bwd_kernel')
            mom = device_ms(lambda: km.ipe_moments(moments, *DEGREES),
                            'ipe_moments_kernel')
            print(f'split IPE_OFF={mask} ({label}): ipe_fwd {fwd:.4f} ms, '
                  f'ipe_bwd {bwd:.4f} ms, ipe_moments {mom:.4f} ms',
                  flush=True)
        _build._LOADED.pop('ipe')


def rel(a, b) -> float:
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


def level_gaussians(dev):
    """(means, covs) [M, 3] of a lego training level, and its delta / mids
    [R, N]: bench.py's synthetic rays (normalised random directions,
    origins 0.1 N(0, 1), radius 0.005, near 2, far 6; seed 1)."""
    rng = np.random.default_rng(1)
    d = rng.normal(size=(LEVEL_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.normal(size=(LEVEL_RAYS, 3)).astype(np.float32) * 0.1
    ones = torch.ones((LEVEL_RAYS, 1), device=dev)
    o, d = torch.tensor(o, device=dev), torch.tensor(d, device=dev)
    t, (means, covs) = sample_along_rays(o, d, ones * 0.005, SAMPLES,
                                         ones * 2.0, ones * 6.0, False,
                                         False, 'cone')
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    delta = (t[:, 1:] - t[:, :-1]) * torch.linalg.norm(d, dim=-1,
                                                       keepdim=True)
    return (means.reshape(-1, 3).contiguous(),
            covs.reshape(-1, 3).contiguous(), delta.contiguous(),
            mids.contiguous())


def check(label, m, c, g, deg):
    out = ipe.ipe_fwd(m, c, *deg)
    dm, dc = ipe.ipe_bwd(m, c, g, *deg)
    rm, rc = ipe.ipe_bwd_plain(m, c, g, *deg)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in (out, dm, dc))
    err = float((out - ipe.ipe_fwd_plain(m, c, *deg)).abs().max())
    same = (torch.equal(out, ipe.ipe_fwd(m, c, *deg))
            and all(torch.equal(a, b) for a, b in zip(
                (dm, dc), ipe.ipe_bwd(m, c, g, *deg))))
    print(f'{label}, {m.shape[0]:,} points, degrees {deg[0]}..{deg[1]}: '
          f'forward max|d| {err:.3e}; dmeans {rel(dm, rm):.3e} dcovs '
          f'{rel(dc, rc):.3e} of their norms; two runs bit-equal {same}',
          flush=True)
    if not finite or err > BAR or max(rel(dm, rm), rel(dc, rc)) > BAR \
            or not same:
        raise AssertionError(f'the IPE kernels disagree with their plain '
                             f'versions ({label})')


def check_moments(label, moments, deg):
    got = km.ipe_moments(moments, *deg)
    torch.cuda.synchronize()
    err = float((got - km.ipe_moments_plain(moments, *deg)).abs().max())
    same = torch.equal(got, km.ipe_moments(moments, *deg))
    print(f'ipe_moments {label}, {moments.shape[1]:,} points, degrees '
          f'{deg[0]}..{deg[1]}: max|d| {err:.3e}; two runs bit-equal {same}',
          flush=True)
    if not bool(torch.isfinite(got).all()) or err > BAR or not same:
        raise AssertionError(f'ipe_moments disagrees with its plain version '
                             f'({label})')


def timing(name, kernel_name, fn, plain, nbytes, label=''):
    dev_ms, ev_ms = device_ms(fn, kernel_name), cuda_ms(fn)
    b_ms = nbytes / HBM_RATE * 1e3
    plain_txt = f', plain {cuda_ms(plain):.4f} ms (events)' if plain else ''
    print(f'  {name}{label}: device {dev_ms:.4f} ms, events {ev_ms:.4f} ms'
          f'{plain_txt}; bound {b_ms:.4f} ms (bytes): '
          f'{100 * b_ms / dev_ms:.1f} % of it', flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print('time_ipe_kernels: no CUDA device', file=sys.stderr)
        return 1
    for mod in ('PIL', 'cv2', 'yaml', 'tensorboardX'):
        try:
            importlib.import_module(mod)
            print(f'import {mod}: ok')
        except ImportError as e:
            print(f'import {mod}: missing ({e})')
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda)
    composites = '--composites' in sys.argv
    names = ['ipe'] + (['lean_render'] if composites else [])
    t0 = time.perf_counter()
    recs = _build.build_all(names)
    print(f'build {time.perf_counter() - t0:.1f} s\n{recs["ipe"]["log"]}')
    dev = torch.device('cuda')
    L = DEGREES[1] - DEGREES[0]
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.tensor(a.astype(np.float32), device=dev)

    for M in (700, 393216):
        m = tensor(2 * rng.normal(size=(M, 3)))
        c = tensor(rng.uniform(0, 1e-3, size=(M, 3)))
        g = tensor(rng.normal(size=(M, 6 * L)))
        for zero in (False, True):
            check(f'random, covs {"0" if zero else "> 0"}', m,
                  torch.zeros_like(c) if zero else c, g, DEGREES)
    check('high', m, c, g, (16, 32))
    means, covs, delta, mids = level_gaussians(dev)
    M = means.shape[0]
    g = tensor(rng.normal(size=(M, 6 * L)))
    if '--split' in sys.argv:
        split_run(means, covs, g, torch.cat([means.T, covs.T]).contiguous())
        return 0
    cases = {'level': means,
             'near': means * (3.2 / float(means.abs().max())),
             'far': torch.sign(means) * (means.abs() + 3.25)}
    for label, m in cases.items():
        check(label, m, covs, g, DEGREES)
    print(f'times at {M:,} points, degrees {DEGREES[0]}..{DEGREES[1]} '
          f'({torch.cuda.get_device_name(0)}):')
    for label, m in cases.items():
        timing('ipe_fwd', 'ipe_fwd_kernel',
               lambda: ipe.ipe_fwd(m, covs, *DEGREES),
               (lambda: ipe.ipe_fwd_plain(m, covs, *DEGREES))
               if label == 'level' else None, M * (24 + 24 * L), f' {label}')
        timing('ipe_bwd', 'ipe_bwd_kernel',
               lambda: ipe.ipe_bwd(m, covs, g, *DEGREES),
               (lambda: ipe.ipe_bwd_plain(m, covs, g, *DEGREES))
               if label == 'level' else None, M * (48 + 24 * L), f' {label}')
    chunk = cs.chunk_inputs(config.default(), dev)[0]
    scaled = chunk[:3] * (3.2 / float(chunk[:3].abs().max()))
    m_cases = {
        'level': torch.cat([means.T, covs.T]).contiguous(),
        'chunk': chunk,
        'chunk near': torch.cat([scaled, chunk[3:]]).contiguous(),
        'far': torch.cat([cases['far'].T, covs.T]).contiguous()}
    for label, mo in m_cases.items():
        check_moments(label, mo, DEGREES)
    for label, mo in m_cases.items():
        timing('ipe_moments', 'ipe_moments_kernel',
               lambda: km.ipe_moments(mo, *DEGREES),
               (lambda: km.ipe_moments_plain(mo, *DEGREES))
               if label == 'level' else None,
               mo.shape[1] * (24 + 24 * L), f' {label}')
    if composites:
        print(recs['lean_render']['log'])
        crng = np.random.default_rng(2)
        for R in (8192, LEVEL_RAYS):
            reps = -(-R // LEVEL_RAYS)
            dl = delta.repeat(reps, 1)[:R].contiguous()
            md = mids.repeat(reps, 1)[:R].contiguous()
            rgbsig = tensor(np.concatenate(
                [crng.uniform(size=(R * SAMPLES, 3)),
                 np.abs(crng.normal(size=(R * SAMPLES, 1))) * 5], -1))
            timing('lean_composite', 'lean_composite',
                   lambda: km.lean_composite(rgbsig, dl, md, True),
                   lambda: km.lean_composite_plain(rgbsig, dl, md, True),
                   R * SAMPLES * 28 + R * 32, f' {R} x {SAMPLES}')
            if R == LEVEL_RAYS:
                g_perray = tensor(crng.normal(size=(R, 8)))
                g_w = tensor(crng.normal(size=(R, SAMPLES)))
                args = (rgbsig, dl, md, g_perray, g_w, True)
                timing('lean_composite_bwd', 'lean_composite_bwd',
                       lambda: km.lean_composite_bwd(*args),
                       lambda: km.lean_composite_bwd_plain(*args),
                       R * SAMPLES * 44 + R * 32, f' {R} x {SAMPLES}')
    print('launches', {k: v for k, v in km.launches.items() if v})
    return 0


if __name__ == '__main__':
    sys.exit(main())
