"""The benchmark's scenes, one module a kind (`benchmark/scenes/<kind>.py`),
found by the configuration's scene['kind'].  Each kind module has

  write(scene, splits, seed, root, device) -> root
      the scene's files for the splits named, written from the seed into
      root (inside the run's TMPDIR), in the layout the port's dataset of
      that kind reads
  views(scene, root, split, white_bkgd) -> reference.Views
      the cameras and images of a split read back from those files for the
      plain reference, with nothing of the program

`scene` is the configuration's 'scene' entry.  Every kind draws the same
analytic scene (hard.py).
"""

from __future__ import annotations

import importlib


def kind(scene: dict):
    """The module of the scene's kind."""
    return importlib.import_module(f'benchmark.scenes.{scene["kind"]}')


def write(scene: dict, splits, seed: int, root: str, device) -> str:
    return kind(scene).write(scene, splits, seed, root, device)


def views(scene: dict, root: str, split: str, white_bkgd: bool):
    return kind(scene).views(scene, root, split, white_bkgd)
