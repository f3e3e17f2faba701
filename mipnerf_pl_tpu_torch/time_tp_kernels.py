"""Build, check and time the Megatron pair kernels on one NVIDIA GPU.

    python3 mipnerf_pl_tpu_torch/time_tp_kernels.py [checkout] [--profile]
        [--level]

Builds csrc/tp_pair.cu of `checkout` (default: the current directory),
prints what ptxas says of each kernel, and holds tp_pair_fwd and tp_pair_bwd
against their plain versions in f32 (`_pair_plain`; `_pair_bwd_plain` on x
and the panels rounded to the compute dtype, the cotangent zero in the rows
whose ReLU mask is in doubt) on seeded inputs: at small and ragged shapes, then at the pair shapes of
a lego level (393,216 rows) at net_width 1024 on a model axis of 2 (the
first pair, f_in 96 in f32, and a later pair, f_in 1024 in the compute
dtype) and at net_width 256 on a model axis of 4, f32 and bf16, two backward
runs bit-equal; and prints CUDA-event times of the kernels and the plain
versions.  Short enough to be a new kernel's first run on a card; run it on
several checkouts in turns to compare them.  Where the checkout's library
counts the pair kernels' routes (`pair_sm90_routes`, `pair_tf32_routes`,
`pair_mma_routes` in kernels/mlp.py), each line says which kernels the
calls ran on.

--level checks and times the level shapes only.  --slice then also times
tp_lean_forward's forward and forward + backward at a lego level on a
single-process mesh (slice_run; the TP slice of chip_smoke.py with seeded
weights).  --split (no checks)
copies csrc/ to a temporary directory, adds a compile-time mask TP_OFF to
the copy of tp_pair_sm90.cuh (nothing in the checkout changes), builds
tp_pair.cu once a mask with nvcc, all at once, and prints the device time
of tp_pair_wg_kernel (torch.profiler) in tp_pair_fwd and tp_pair_bwd at the
level's first and later pairs, both dtypes, a line a mask: bit 1 the
helpers' global loads of x and g, 2 the wgmma products, 4 the out / dx
stores, 8 the stores of the stream S (x, h, g, dh), 32 the weight slabs' TMA
loads.  A split, not a sum: with a part off the rest may rearrange.
--profile first prints,
for the first and the later pair of the level in each dtype, the device
time of every kernel of one tp_pair_fwd and of one tp_pair_bwd call from
a torch.profiler window (the backward's chain kernel, weight gradients and
sum_rows_kernel), the kernels that share a short name summed.
"""

import ctypes
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

from mipnerf_pl_tpu_torch.kernels import _build, tp_lean  # noqa: E402
from mipnerf_pl_tpu_torch.kernels import mlp as km  # noqa: E402

LEVEL = 393216
F32_BAR, BF16_BAR = 1e-4, 3e-2
# (rows, f_in, local width, output width): small ones (the mma.sync kernels'
# widths and the wgmma kernel's, ragged), then the pairs of a lego level.
SMALL = [(200, 24, 16, 32), (777, 96, 64, 128), (4097, 40, 272, 528),
         (333, 96, 512, 1024), (1000, 1024, 512, 1024), (4097, 256, 64, 256),
         (130, 40, 192, 320)]
LEVEL_SHAPES = [(LEVEL, 96, 512, 1024), (LEVEL, 1024, 512, 1024),
                (LEVEL, 256, 64, 256)]
SHAPES = SMALL + LEVEL_SHAPES


# --split: mask -> what it switches off; the edits of tp_pair_sm90.cuh.
SPLIT = {0: 'all on', 1: 'helper loads off', 2: 'products off',
         4: 'out / dx stores off', 8: 'S stores off',
         32: 'weight loads off'}
_KK_BF16 = ('#pragma unroll\n              for (int kk = 0; kk < 2; ++kk) {\n'
            '                const int t = 2 * ks + kk;')
_KK_F32 = ('#pragma unroll\n              for (int kk = 0; kk < 2; ++kk) {\n'
           '                const uint64_t dh')
SPLIT_EDITS = [
    ('#pragma once\n', '#pragma once\n#ifndef TP_OFF\n#define TP_OFF 0\n'
     '#endif\n'),
    ('      tp_load_row<KS>(v, is_x', '      if (!(TP_OFF & 1)) '
     'tp_load_row<KS>(v, is_x'),
    (_KK_BF16, 'if (!(TP_OFF & 2))\n' + _KK_BF16),
    (_KK_F32, 'if (!(TP_OFF & 2))\n' + _KK_F32),
    ('                if (m >= pl.M) continue;',
     '                if (m >= pl.M || (TP_OFF & 4)) continue;'),
    ('        if (pr.a < 2 && c.ps == 0) {',
     '        if (!(TP_OFF & 8) && pr.a < 2 && c.ps == 0) {'),
    ('            auto tile_to_s = [&](int s_row) {',
     '            auto tile_to_s = [&](int s_row) {\n'
     '              if (TP_OFF & 8) return;'),
    ('              mbar_expect_tx(full + s, (nb[0] + nb[1])',
     '              if (TP_OFF & 32) nb[0] = nb[1] = 0;\n'
     '              mbar_expect_tx(full + s, (nb[0] + nb[1])'),
    ('            const int nb[2] = {', '            int nb[2] = {'),
]


def split_builds(tmp):
    """{mask: path of the library} built from csrc/ with SPLIT_EDITS."""
    src = os.path.join(tmp, 'csrc')
    shutil.copytree(_build.SRC_DIR, src)
    path = os.path.join(src, 'tp_pair_sm90.cuh')
    text = open(path).read()
    for old, new in SPLIT_EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f'tp_pair_sm90.cuh has no single {old!r}')
        text = text.replace(old, new)
    open(path, 'w').write(text)
    procs = {}
    for mask in SPLIT:
        so = os.path.join(tmp, f'libtp_pair-{mask}.so')
        cmd = [_build.nvcc_path(), *_build.FLAGS, f'-DTP_OFF={mask}', '-o',
               so, os.path.join(src, 'tp_pair.cu')]
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


def split_run(dev):
    """--split: one line a mask."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs = split_builds(tmp)
        print(f'split builds {time.perf_counter() - t0:.1f} s', flush=True)
        inputs = {(shape, dt): pair_inputs(*shape, dt, dev)
                  for shape in LEVEL_SHAPES[:2]
                  for dt in (torch.float32, torch.bfloat16)}
        for mask, label in SPLIT.items():
            _build._LOADED['tp_pair'] = ctypes.CDLL(libs[mask])
            row = {}
            for (shape, dt), (x, wc, bc, wr, g) in inputs.items():
                tag = (f'{"first" if shape[1] != shape[3] else "later"} '
                       f'{"f32" if dt == torch.float32 else "bf16"}')
                for name, fn in (
                        ('fwd', lambda: tp_lean._pair_call(x, wc, bc, wr, dt)),
                        ('bwd', lambda: tp_lean._pair_bwd_call(x, wc, bc, wr,
                                                               g, dt))):
                    row[f'{tag} {name}'] = device_split(fn).get(
                        'tp_pair_wg_kernel')
            print(f'split TP_OFF={mask} ({label}): {row}', flush=True)
        _build._LOADED.pop('tp_pair')


# --slice: the TP slice's meshes (net_width, shards, model axis) and the
# lego level it runs (rays x samples, encode and view features).
SLICE_MESHES = ((1024, 2, 2), (256, 8, 4))
SLICE_RAYS, SLICE_SAMPLES, SLICE_F, SLICE_FV = 3072, 128, 96, 27


def slice_run(dev):
    """--slice: ms of tp_lean_forward's forward and forward + backward (a
    seeded linear loss of the raw heads) on a single-process mesh on the
    card, best of 4 to a synchronise, each mesh and dtype; the lego MLP
    (depth 8, skip 4, one 128-wide view layer) at the mesh's width, seeded
    Xavier kernels, zero biases."""
    from mipnerf_pl_tpu_torch.kernels.tp_lean import tp_lean_forward
    from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh
    rng = np.random.default_rng(5)
    M = SLICE_RAYS * SLICE_SAMPLES

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape, np.float32) * scale,
                            device=dev)
    x, view = t(M, SLICE_F), t(SLICE_RAYS, SLICE_FV)
    g_rgb, g_dens = t(M, 3), t(M, 1)
    for W, shards, n_model in SLICE_MESHES:
        shapes = [(SLICE_F, W)] + [(W + (SLICE_F if i == 5 else 0), W)
                                   for i in range(1, 8)]
        shapes += [(W, 1), (W, W), (W + SLICE_FV, 128), (128, 3)]
        flat = []
        for k, n in shapes:
            flat += [t(k, n, scale=np.sqrt(2.0 / (k + n))),
                     torch.zeros(1, n, device=dev)]
        leaves = [a.requires_grad_(True) for a in [x, view] + flat]
        mesh = create_mesh(shards, n_model, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            def run(backward):
                rgb, dens = tp_lean_forward(leaves[0], leaves[1], leaves[2:],
                                            mesh, SLICE_SAMPLES, 8, 1, 4, dt)
                if backward:
                    torch.autograd.grad((rgb * g_rgb).sum()
                                        + (dens * g_dens).sum(), leaves)
            out = []
            for backward in (False, True):
                best = float('inf')
                with torch.set_grad_enabled(backward):
                    for i in range(5):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        run(backward)
                        torch.cuda.synchronize()
                        if i:
                            best = min(best, time.perf_counter() - t0)
                out.append(best * 1e3)
            tag = 'f32' if dt == torch.float32 else 'bf16'
            print(f'slice net_width {W} model {n_model} {tag}: forward '
                  f'{out[0]:.1f} ms, forward + backward {out[1]:.1f} ms '
                  f'(best of 4 after a warm-up)', flush=True)
        del leaves, flat
        torch.cuda.empty_cache()


def cuda_ms(fn, iters: int = 4) -> float:
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


def device_split(fn, iters: int = 2) -> dict:
    """{short kernel name: device ms per call} of fn() from a torch.profiler
    window after a warm-up call (kernels that share a short name summed)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.replace('(anonymous namespace)::', '')
            if name.startswith('void '):
                name = name[len('void '):]
            name = name.split('<')[0].split('(')[0].split('::')[-1]
            out[name] = (out.get(name, 0.0)
                         + ev.self_device_time_total / 1e3 / iters)
    return {k: round(v, 4) for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def route_of(name: str) -> str:
    """Which kernels the calls of wrapper `name` since the last
    reset_launches ran on, by the library's own counts, where the checkout
    counts them."""
    tables = [(t, getattr(km, t)) for t in ('pair_sm90_routes',
                                            'pair_tf32_routes',
                                            'pair_mma_routes')
              if hasattr(km, t)]
    return ' '.join(f'{t}={c[name]}' for t, c in tables) or 'not counted'


def rel(a, b) -> float:
    return float(torch.linalg.norm((a - b).double())
                 / (torch.linalg.norm(b.double()) + 1e-30))


def pair_inputs(M, f_in, Wl, Wout, dtype, dev, seed=0):
    """A pair's inputs as tp_lean_forward hands them over: x f32 encode
    rows when f_in is not the trunk width, else post-ReLU activations in
    the compute dtype; f32 parameters; an f32 cotangent."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    x = normal(M, f_in)
    if f_in == Wout:
        x = torch.relu(x).to(dtype)
    w_col = normal(f_in, Wl) / np.sqrt(f_in)
    b_col = torch.tensor(rng.normal(size=(1, Wl)).astype(np.float32) * 0.1,
                         device=dev)
    w_row = normal(Wl, Wout) / np.sqrt(Wl)
    return x, w_col, b_col, w_row, normal(M, Wout)


def check_pair(shape, dtype, dev, timed):
    """One shape: forward and backward against the f32 plain versions; ->
    the line to print."""
    M, f_in, Wl, Wout = shape
    tag = 'f32' if dtype == torch.float32 else 'bf16'
    x, w_col, b_col, w_row, g = pair_inputs(*shape, dtype, dev)
    args = (x, w_col, b_col, w_row)
    # The backward kernel takes its ReLU mask from its own sums, ~1e-6 from
    # the plain version's: no cotangent in the rows where a pre-activation
    # is within 1e-4 of zero, so that no mask in doubt moves a gradient.
    hpre = x.to(dtype).float() @ w_col.to(dtype).float() + b_col
    keep = (hpre.abs() > 1e-4).all(dim=1, keepdim=True)
    g = g * keep
    del hpre
    km.reset_launches()
    out = tp_lean._pair_call(*args, dtype)
    got = tp_lean._pair_bwd_call(*args, g, dtype)
    again = tp_lean._pair_bwd_call(*args, g, dtype)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    ref = tp_lean._pair_plain(*args, torch.float32)
    f_abs = float((out - ref).abs().max())
    f_rel = f_abs / float(ref.abs().max())
    del ref, out
    # The f32 backward on the operands as the kernel rounds them: both then
    # recompute the same pre-activation and take the same ReLU mask.
    want = tp_lean._pair_bwd_plain(x.to(dtype), w_col.to(dtype), b_col,
                                   w_row.to(dtype), g, torch.float32)
    errs = [rel(a, b) for a, b in zip(got, want)]
    del want, got
    finite = np.isfinite(f_abs) and all(np.isfinite(e) for e in errs)
    if dtype == torch.float32:
        ok = finite and same and f_abs <= F32_BAR and max(errs) <= F32_BAR
    else:
        ok = finite and same and f_rel <= BF16_BAR and max(errs) <= BF16_BAR
    line = (f'{shape} {tag}: forward max|d| {f_abs:.3e} (of max|ref| '
            f'{f_rel:.3e}); dx dWcol dbcol dWrow '
            f'{" ".join(f"{e:.3e}" for e in errs)} of their norms '
            f'({100 * float(keep.float().mean()):.2f} % of the rows carry a '
            f'cotangent); two backward runs bit-equal {same}  '
            f'{"OK" if ok else "FAIL"}\n    routes: tp_pair_fwd '
            f'{route_of("tp_pair_fwd")}; tp_pair_bwd {route_of("tp_pair_bwd")}')
    if timed:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms_f = cuda_ms(lambda: tp_lean._pair_call(*args, dtype))
        ms_b = cuda_ms(lambda: tp_lean._pair_bwd_call(*args, g, dtype))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        pl_f = cuda_ms(lambda: tp_lean._pair_plain(*args, dtype), 2)
        pl_b = cuda_ms(lambda: tp_lean._pair_bwd_plain(*args, g, dtype), 2)
        line += (f'\n    tp_pair_fwd {ms_f:.3f} ms (plain {pl_f:.3f}), '
                 f'tp_pair_bwd {ms_b:.3f} ms (plain {pl_b:.3f}), kernel '
                 f'scratch and outputs peak {peak:.3f} GiB')
    if not ok:
        raise AssertionError(f'the pair kernels disagree with their plain '
                             f'versions: {line}')
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print('time_tp_kernels: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda)
    t0 = time.perf_counter()
    rec = _build.build_all(['tp_pair'])['tp_pair']
    print(f'build {time.perf_counter() - t0:.1f} s\n{rec["log"]}', flush=True)
    dev = torch.device('cuda')
    if '--split' in sys.argv:
        split_run(dev)
        return 0
    if '--profile' in sys.argv:
        for shape in LEVEL_SHAPES[:2]:
            for dtype in (torch.float32, torch.bfloat16):
                x, w_col, b_col, w_row, g = pair_inputs(*shape, dtype, dev)
                args = (x, w_col, b_col, w_row)
                tag = 'f32' if dtype == torch.float32 else 'bf16'
                fwd = device_split(lambda: tp_lean._pair_call(*args, dtype))
                bwd = device_split(
                    lambda: tp_lean._pair_bwd_call(*args, g, dtype))
                print(f'split {shape} {tag}: tp_pair_fwd {fwd}; tp_pair_bwd '
                      f'{bwd}', flush=True)
                del x, w_col, b_col, w_row, g, args
    shapes = LEVEL_SHAPES if '--level' in sys.argv else SHAPES
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            print(check_pair(shape, dtype, dev, shape[0] == LEVEL),
                  flush=True)
    print('launches', {k: v for k, v in km.launches.items() if v})
    if '--slice' in sys.argv:
        slice_run(dev)
    return 0


if __name__ == '__main__':
    sys.exit(main())
