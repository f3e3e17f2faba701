"""Build, check and time the Megatron pair kernels on one NVIDIA GPU.

    python3 mipnerf_pl_tpu_torch/time_tp_kernels.py [checkout]

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
several checkouts in turns to compare them.
"""

import sys
import time

import numpy as np
import torch

sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1 else '.')

from mipnerf_pl_tpu_torch.kernels import _build, tp_lean  # noqa: E402
from mipnerf_pl_tpu_torch.kernels import mlp as km  # noqa: E402

LEVEL = 393216
F32_BAR, BF16_BAR = 1e-4, 3e-2
# (rows, f_in, local width, output width); the last three are a lego level.
SHAPES = [(200, 24, 16, 32), (777, 96, 64, 128), (4097, 40, 272, 528),
          (LEVEL, 96, 512, 1024), (LEVEL, 1024, 512, 1024),
          (LEVEL, 256, 64, 256)]


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
            f'{"OK" if ok else "FAIL"}')
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
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            print(check_pair(shape, dtype, dev, shape[0] == LEVEL),
                  flush=True)
    print('launches', {k: v for k, v in km.launches.items() if v})
    return 0


if __name__ == '__main__':
    sys.exit(main())
