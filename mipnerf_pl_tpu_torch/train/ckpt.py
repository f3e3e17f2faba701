"""Checkpoint management (torch.save).

Counterpart of mipnerf_pl_tpu/train/ckpt.py: keeps the top-k checkpoints by
validation PSNR plus the most recent one, and the hparams next to the
weights, so that eval restores a model from the directory alone.

Layout:
  {out_dir}/ckpt/{exp_name}/
    hparams.json              # flat dotted-key config (tuples -> lists)
    best/<step>/state.pt      # top-k by val_psnr, with val_psnr.json
    last/<step>/state.pt      # the most recent

A state is {'params': {name: tensor}, 'opt_state': ..., 'step': int}, saved
with its tensors on the CPU, written under a temporary name and renamed.
In a run of several processes one manager writes (`write=True` on the
first process: the hparams, the saves and the top-k retention) and every
process restores from the same directory.
An eval restore reads 'params' and 'step' and nothing else, whatever the
checkpoint's optimizer state holds.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

_STATE = 'state.pt'
_METRIC = 'val_psnr.json'


def _jsonable(hparams: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in hparams.items()}


def host_copy(tree):
    """The same nest of dicts / lists / tuples with every tensor copied to
    the CPU: a snapshot that later steps, which update a state in place,
    leave as it is."""
    if torch.is_tensor(tree):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def _steps(root: str) -> List[int]:
    """The steps with a finished state under root, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and os.path.exists(
                      os.path.join(root, d, _STATE)))


def _write(root: str, step: int, state: Dict[str, Any],
           val_psnr: Optional[float] = None) -> None:
    d = os.path.join(root, str(step))
    os.makedirs(d, exist_ok=True)
    if val_psnr is not None:
        with open(os.path.join(d, _METRIC), 'w') as f:
            json.dump({'val_psnr': float(val_psnr)}, f)
    tmp = os.path.join(d, f'{_STATE}.{os.getpid()}.tmp')
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(d, _STATE))


def _read(root: str, step: int) -> Dict[str, Any]:
    return torch.load(os.path.join(root, str(step), _STATE),
                      map_location='cpu', weights_only=True)


class CheckpointManager:
    """Top-k-on-PSNR + save-last checkpointing of {params, opt_state,
    step}."""

    def __init__(self, ckpt_dir: str, hparams: Optional[dict] = None,
                 save_top_k: int = 2, write: bool = True):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.save_top_k = int(save_top_k)
        self.write = write
        self._best = os.path.join(self.ckpt_dir, 'best')
        self._last = os.path.join(self.ckpt_dir, 'last')
        if not write:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if hparams is not None:
            with open(os.path.join(self.ckpt_dir, 'hparams.json'), 'w') as f:
                json.dump(_jsonable(hparams), f, indent=2)

    def _best_scores(self) -> Dict[int, float]:
        scores = {}
        for step in _steps(self._best):
            with open(os.path.join(self._best, str(step), _METRIC)) as f:
                scores[step] = float(json.load(f)['val_psnr'])
        return scores

    def save(self, step: int, state: Dict[str, Any],
             val_psnr: Optional[float] = None) -> None:
        """Save `state` at `step` as the last checkpoint and, given
        val_psnr, among the best if it ranks in the top k.  A manager that
        does not write refuses."""
        if not self.write:
            raise RuntimeError(f'this process does not write checkpoints to '
                               f'{self.ckpt_dir}')
        step = int(step)
        state = host_copy(state)
        _write(self._last, step, state)
        for old in _steps(self._last):
            if old != step:
                shutil.rmtree(os.path.join(self._last, str(old)))
        if val_psnr is None or self.save_top_k < 1:
            return
        _write(self._best, step, state, val_psnr)
        scores = self._best_scores()
        # The k best; of equal scores the later step stays.
        keep = sorted(scores, key=lambda s: (scores[s], s),
                      reverse=True)[:self.save_top_k]
        for old in scores:
            if old not in keep:
                shutil.rmtree(os.path.join(self._best, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = _steps(self._last)
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        scores = self._best_scores()
        if not scores:
            return None
        return max(scores, key=lambda s: (scores[s], s))

    def restore_last(self) -> Tuple[int, Dict[str, Any]]:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f'no checkpoint under {self._last}')
        return step, _read(self._last, step)

    def restore_best(self) -> Tuple[int, Dict[str, Any]]:
        step = self.best_step()
        if step is None:
            return self.restore_last()
        return step, _read(self._best, step)

    def close(self) -> None:
        """Every save is finished when `save` returns; kept for the JAX
        manager's interface."""


def load_hparams(ckpt_path: str) -> dict:
    """Read hparams.json from a checkpoint root (or a subdirectory of one)."""
    d = os.path.abspath(ckpt_path)
    for _ in range(5):
        cand = os.path.join(d, 'hparams.json')
        if os.path.exists(cand):
            with open(cand) as f:
                h = json.load(f)
            return {k: tuple(v) if isinstance(v, list) else v
                    for k, v in h.items()}
        d = os.path.dirname(d)
    raise FileNotFoundError(f'hparams.json not found above {ckpt_path}')


def restore_for_eval(ckpt_path: str, prefer_best: bool = True
                     ) -> Tuple[int, Dict[str, Any]]:
    """(step, {'params', 'step'}) of the best (or last) checkpoint under
    the checkpoint root: the optimizer state is dropped unread by the
    caller, so eval never depends on what wrote it."""
    if not os.path.isdir(ckpt_path):
        raise FileNotFoundError(f'no checkpoint directory {ckpt_path}')
    mgr = CheckpointManager(ckpt_path, write=False)
    step, state = mgr.restore_best() if prefer_best else mgr.restore_last()
    return step, {'params': state['params'], 'step': int(state['step'])}
