"""What the multi-scale tools share (tools/acceptance.py, tools/ablation.py,
tools/distloss_ablation.py): the synthetic scene, its multi-scale pyramid,
the stages they run through the port's CLIs, and the per-scale means of an
eval.

A stage is `python -m <module> <argv>` for one of the port's CLIs
(`cli.convert`, `cli.train`, `cli.eval`).  By default it runs in a
process of its own with this checkout on PYTHONPATH (`subprocess_stage`);
a caller that wants to read what a stage did (the kernels' launch counts)
passes `in_process_stage`, or a stage of its own, which calls the CLI's
`main(argv)` in its process.  A stage that fails raises, so a tool stops
at it and exits non-zero.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# The root of the checkout that holds this package.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCALE_NAMES = ['full res', '1/2 res', '1/4 res', '1/8 res']
CONVERT = 'mipnerf_pl_tpu_torch.cli.convert'
TRAIN = 'mipnerf_pl_tpu_torch.cli.train'
EVAL = 'mipnerf_pl_tpu_torch.cli.eval'
# The synthetic scene's views of each split.
SCENE_VIEWS = {'n_train': 48, 'n_val': 4, 'n_test': 8}

Stage = Callable[[str, Sequence[str]], object]


def subprocess_stage(module: str, argv: Sequence[str]) -> None:
    """`python -m module argv` in a process of its own, from the checkout's
    root with the checkout first on PYTHONPATH; raises CalledProcessError
    if it exits non-zero."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO] + [p for p in [env.get('PYTHONPATH')] if p])
    subprocess.run([sys.executable, '-m', module, *argv], check=True,
                   cwd=REPO, env=env)


def in_process_stage(module: str, argv: Sequence[str]):
    """`module.main(argv)` in this process; -> what it returns."""
    return importlib.import_module(module).main(list(argv))


def run(module: str, argv: Sequence[str],
        stage: Optional[Stage] = None):
    """Print the stage's command line, run it through `stage` (default:
    subprocess_stage), print its seconds; -> what the stage returned."""
    print('+ python -m', module, ' '.join(argv), flush=True)
    t0 = time.time()
    result = (stage or subprocess_stage)(module, list(argv))
    print(f'  ({time.time() - t0:.0f} s)', flush=True)
    return result


def device_args(device: Optional[str]) -> List[str]:
    """cli.train / cli.eval's --device flag, where one was given."""
    return ['--device', device] if device else []


def make_scene(out: str, size: int, scene: str = 'hard') -> str:
    """The synthetic Blender scene <out>/scene_src/<scene> (SCENE_VIEWS of
    `size` px; the ground truth supersampled 2x), written unless it
    exists; -> its directory."""
    from mipnerf_pl_tpu_torch.data.synthetic import make_sphere_scene

    scene_dir = os.path.join(out, 'scene_src', scene)
    if not os.path.exists(os.path.join(scene_dir, 'transforms_test.json')):
        print(f'generating synthetic {scene!r} scene at {size}px',
              flush=True)
        make_sphere_scene(scene_dir, size=size, scene=scene, supersample=2,
                          **SCENE_VIEWS)
    return scene_dir


def make_pyramid(out: str, scene_dir: str, n_down: int,
                 stage: Optional[Stage] = None) -> str:
    """cli.convert of a Blender scene directory into <out>/multiscale/
    <scene> with n_down levels, unless its metadata.json exists; -> that
    directory."""
    scene_dir = scene_dir.rstrip('/')
    name = os.path.basename(scene_dir)
    multi_dir = os.path.join(out, 'multiscale')
    data_dir = os.path.join(multi_dir, name)
    if not os.path.exists(os.path.join(data_dir, 'metadata.json')):
        run(CONVERT, ['--blender_dir', os.path.dirname(scene_dir),
                      '--object_name', name, '--out_dir', multi_dir,
                      '--n_down', str(n_down)], stage)
    return data_dir


def train_options(steps: int, val_interval: int,
                  val_images: Optional[int] = 2) -> List[str]:
    """The hparams every tool's training runs take: bf16, validation every
    `val_interval` steps on `val_images` views (None: the schema's), the
    LR schedule over `steps`."""
    views = [] if val_images is None else ['val.sample_num', str(val_images)]
    return (['train.compute_dtype', 'bfloat16',
             'val.check_interval', str(val_interval)] + views
            + ['optimizer.max_steps', str(max(steps, 1))])


def per_scale(out_dir: str, exp_name: str, n_down: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(PSNR, SSIM) means of each of the n_down scale buckets of cli.eval's
    psnrs.txt / ssims.txt under <out_dir>/test/<exp_name>: entry i falls
    in bucket i % n_down."""
    exp_dir = os.path.join(out_dir, 'test', exp_name)
    psnr = np.atleast_1d(np.loadtxt(os.path.join(exp_dir, 'psnrs.txt')))
    ssim = np.atleast_1d(np.loadtxt(os.path.join(exp_dir, 'ssims.txt')))
    return (psnr.reshape(-1, n_down).mean(axis=0),
            ssim.reshape(-1, n_down).mean(axis=0))
