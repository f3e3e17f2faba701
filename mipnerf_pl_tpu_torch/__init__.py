"""mipnerf_pl_tpu_torch — the PyTorch + CUDA (Hopper) port of mipnerf_pl_tpu.

The JAX package `mipnerf_pl_tpu` stays the reference; this package mirrors
its module names so every function has an obvious counterpart:

  rays.py           ray container + chunking      (= mipnerf_pl_tpu/rays.py)
  config.py         flat dotted-key schema, parse_args (= config.py)
  ops/              camera, cone math, sampling, compositing (plain torch)
  kernels/mlp.py    the MLP kernels' wrappers: hand-written CUDA for sm_90a
                    (csrc/lean_render.cu, csrc/lean_train.cu) + their plain
                    versions; kernels/ipe.py the standalone IPE and its VJP
                    (csrc/ipe.cu)
  models/           MLP and the bounded MipNerf forward
  convert.py        flax param tree <-> this package's state dict
  data/             Blender dataset, synthetic scenes, the train batcher
  train/            LR schedule, Adam, checkpoints
  utils/            metrics (PSNR, SSIM, summaries), image saving, poses
  system.py         MipNeRFSystem: train step, renders, validate, fit
  cli/              the train and eval command lines

It imports torch and numpy only: never jax, flax, optax, orbax or the JAX
package.
"""

__version__ = "0.1.0"

from mipnerf_pl_tpu_torch.rays import Rays, namedtuple_map  # noqa: F401
