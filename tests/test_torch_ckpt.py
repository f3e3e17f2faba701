"""The port's checkpoint manager (train/ckpt.py), on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.rays import Rays
from mipnerf_pl_tpu_torch.system import MipNeRFSystem
from mipnerf_pl_tpu_torch.train.ckpt import (CheckpointManager, load_hparams,
                                             restore_for_eval)


def _hparams(**overrides):
    hp = config.default()
    hp.update({'nerf.num_samples': 8, 'nerf.max_deg_point': 4,
               'nerf.deg_view': 2, 'nerf.mlp.net_depth': 2,
               'nerf.mlp.net_width': 16, 'nerf.mlp.net_width_condition': 8,
               'train.randomized': False})
    hp.update(overrides)
    return hp


def _trained_state(system, steps=2):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(8, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((8, 1), np.float32)
    rays = Rays(d * 0.1, d, d, ones * 0.005, ones, ones * 2.0, ones * 6.0)
    state = system.init_state(seed=1)
    for _ in range(steps):
        state, _ = system.train_step(
            state, rays, rng.uniform(size=(8, 3)).astype(np.float32))
    return state, rays


def _moments(opt):
    return [(s['exp_avg'], s['exp_avg_sq'], s['step'])
            for s in opt.state_dict()['state'].values()]


def test_save_restore_last_bit_exact(tmp_path):
    system = MipNeRFSystem(_hparams(), device='cpu')
    state, rays = _trained_state(system)
    mgr = CheckpointManager(str(tmp_path / 'ck'), hparams=system.hparams)
    mgr.save(2, system.host_state(state), val_psnr=10.0)
    step, host = CheckpointManager(str(tmp_path / 'ck')).restore_last()
    assert step == 2 and host['step'] == 2
    back = system.load_state(host)
    assert back['step'] == 2
    for k, v in state['params'].items():
        assert torch.equal(back['params'][k], v), k
        assert back['params'][k].requires_grad
    for a, b in zip(_moments(back['opt_state']), _moments(state['opt_state'])):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # The restored state trains on exactly as the live one.
    pixels = np.full((8, 3), 0.5, np.float32)
    system.train_step(state, rays, pixels)
    system.train_step(back, rays, pixels)
    for k, v in state['params'].items():
        assert torch.equal(back['params'][k], v), k
    assert not [f for f in os.listdir(tmp_path / 'ck' / 'last' / '2')
                if f.endswith('.tmp')]


def test_top_k_keeps_the_best_and_the_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_top_k=2)
    scores = {10: 20.0, 20: 25.0, 30: 22.0, 40: 19.0, 50: 24.0}
    for step, psnr in scores.items():
        mgr.save(step, {'params': {'w': torch.full((2,), float(step))},
                        'opt_state': {}, 'step': step}, val_psnr=psnr)
        assert mgr.latest_step() == step
        assert os.listdir(tmp_path / 'last') == [str(step)]
    assert sorted(os.listdir(tmp_path / 'best')) == ['20', '50']
    assert mgr.best_step() == 20
    step, state = mgr.restore_best()
    assert step == 20 and float(state['params']['w'][0]) == 20.0
    step, state = mgr.restore_last()
    assert step == 50 and float(state['params']['w'][0]) == 50.0
    mgr.save(60, {'params': {}, 'opt_state': {}, 'step': 60})   # no score
    assert sorted(os.listdir(tmp_path / 'best')) == ['20', '50']
    assert mgr.latest_step() == 60
    mgr.close()
    empty = CheckpointManager(str(tmp_path / 'none'))
    assert empty.latest_step() is None and empty.best_step() is None
    with pytest.raises(FileNotFoundError):
        empty.restore_last()


@pytest.mark.parametrize('prefer_best', [True, False])
def test_restore_for_eval_ignores_the_optimizer_state(tmp_path, prefer_best):
    """Eval reads params and step, whatever sits under opt_state."""
    system = MipNeRFSystem(_hparams(), device='cpu')
    state, _ = _trained_state(system, steps=1)
    host = system.host_state(state)
    host['opt_state'] = {'junk': [1, 2, 3], 'layout': 'unknown'}
    mgr = CheckpointManager(str(tmp_path / 'ck'), hparams=system.hparams)
    mgr.save(1, host, val_psnr=12.5)
    step, got = restore_for_eval(str(tmp_path / 'ck'), prefer_best)
    assert step == 1 and set(got) == {'params', 'step'} and got['step'] == 1
    for k, v in state['params'].items():
        assert torch.equal(got['params'][k], v.detach()), k
    with pytest.raises(FileNotFoundError):
        restore_for_eval(str(tmp_path / 'missing'))
    assert not os.path.exists(tmp_path / 'missing')


def test_load_hparams_from_subdirectory_and_tuples(tmp_path):
    hp = _hparams(**{'exp_name': 'e', 'some.tuple': (1, 2, 3),
                     'data.factor': None})
    CheckpointManager(str(tmp_path / 'ck'), hparams=hp).save(
        3, {'params': {}, 'opt_state': {}, 'step': 3}, val_psnr=1.0)
    with open(tmp_path / 'ck' / 'hparams.json') as f:
        assert json.load(f)['some.tuple'] == [1, 2, 3]
    for sub in ('', 'best', 'last/3', 'best/3'):
        got = load_hparams(str(tmp_path / 'ck' / sub))
        assert got == hp and got['some.tuple'] == (1, 2, 3)
    with pytest.raises(FileNotFoundError):
        load_hparams(str(tmp_path))
