"""Build, check and time the standalone IPE kernels on one NVIDIA GPU.

    python3 mipnerf_pl_tpu_torch/time_ipe_kernels.py [checkout]

Builds csrc/ipe.cu of `checkout` (default: the current directory), prints
what ptxas says of each kernel, holds ipe_fwd and ipe_bwd against their
plain versions at 700 and at 393,216 points (a lego training level, degrees
0..16), with covariances and with them zeroed, and prints CUDA-event times
of the kernels and the plain versions.  Short enough to be a new kernel's
first run on a card; run it on several checkouts in turns to compare them.
It also prints which optional packages (PIL, cv2, yaml, tensorboardX) the
machine can import, since the run's entry points use them where present.
"""

import importlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1 else '.')

from mipnerf_pl_tpu_torch.kernels import _build, ipe  # noqa: E402
from mipnerf_pl_tpu_torch.kernels import mlp as km  # noqa: E402

DEGREES = (0, 16)


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


def rel(a, b) -> float:
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


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
    t0 = time.perf_counter()
    rec = _build.build_all(['ipe'])['ipe']
    print(f'build {time.perf_counter() - t0:.1f} s\n{rec["log"]}')
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    for M in (700, 393216):
        for zero in (False, True):
            m = torch.tensor((2 * rng.normal(size=(M, 3))).astype(np.float32),
                             device=dev)
            c = torch.tensor(rng.uniform(0, 1e-3, size=(M, 3)
                                         ).astype(np.float32), device=dev)
            if zero:
                c = torch.zeros_like(c)
            g = torch.tensor(rng.normal(size=(M, 96)).astype(np.float32),
                             device=dev)
            out = ipe.ipe_fwd(m, c, *DEGREES)
            dm, dc = ipe.ipe_bwd(m, c, g, *DEGREES)
            rm, rc = ipe.ipe_bwd_plain(m, c, g, *DEGREES)
            torch.cuda.synchronize()
            err = float((out - ipe.ipe_fwd_plain(m, c, *DEGREES)).abs().max())
            same = (torch.equal(out, ipe.ipe_fwd(m, c, *DEGREES))
                    and all(torch.equal(a, b) for a, b in zip(
                        (dm, dc), ipe.ipe_bwd(m, c, g, *DEGREES))))
            print(f'{M:,} points, covs {"0" if zero else "> 0"}: forward '
                  f'max|d| {err:.3e}; dmeans {rel(dm, rm):.3e} dcovs '
                  f'{rel(dc, rc):.3e} of their norms; two runs bit-equal '
                  f'{same}')
            if err > 1e-5 or max(rel(dm, rm), rel(dc, rc)) > 1e-5 or not same:
                raise AssertionError('the IPE kernels disagree with their '
                                     'plain versions')
            if M > 1000:
                print(f'  ipe_fwd {cuda_ms(lambda: ipe.ipe_fwd(m, c, *DEGREES)):.4f} ms'  # noqa: E501
                      f' (plain {cuda_ms(lambda: ipe.ipe_fwd_plain(m, c, *DEGREES)):.4f})'  # noqa: E501
                      f'  ipe_bwd {cuda_ms(lambda: ipe.ipe_bwd(m, c, g, *DEGREES)):.4f} ms'  # noqa: E501
                      f' (plain {cuda_ms(lambda: ipe.ipe_bwd_plain(m, c, g, *DEGREES)):.4f})')  # noqa: E501
    print('launches', {k: v for k, v in km.launches.items() if v})
    return 0


if __name__ == '__main__':
    sys.exit(main())
