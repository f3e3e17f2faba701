"""What every cell shares: the manifest, a cell's configuration and mix,
its driver, its hyperparameters and weights, the per-layer readers and the
check that no JAX module was loaded.

Everything is found by name.  A cell is an entry of BENCHMARK.json; its
configuration is the file the manifest names, its traffic mix
`benchmark/mixes/<traffic>.json` (data: the driver that runs it and with
what parameters), the driver `benchmark/drivers/<driver>.py`, the scene
`benchmark/scenes/<kind>.py`, and each per-layer metric's reader
`benchmark/metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'mipnerf_pl_tpu')


def manifest(root: Path = ROOT) -> dict:
    with open(root / 'BENCHMARK.json') as f:
        return json.load(f)


def cell(name: str, man: Optional[dict] = None, root: Path = ROOT):
    """(workload entry, configuration, mix) of the cell `name`."""
    man = man or manifest(root)
    workloads = {w['name']: w for w in man['workloads']}
    if name not in workloads:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    wl = workloads[name]
    entry = {c['name']: c for c in man['configs']}[wl['config']]
    with open(root / entry['file']) as f:
        config = json.load(f)
    with open(root / 'benchmark' / 'mixes' / f'{wl["traffic"]}.json') as f:
        mix = json.load(f)
    return wl, config, mix


def driver(name: str):
    """The `run` of benchmark/drivers/<name>.py."""
    return importlib.import_module(f'benchmark.drivers.{name}').run


def metrics_of(wl: dict, man: dict, kind: str) -> list:
    """The cell's metrics of `kind` ('end_to_end' or 'per_layer')."""
    return [m for m in man[kind]
            if 'workloads' not in m or wl['name'] in m['workloads']]


def hparams(config: dict, seed: int) -> Dict:
    """The program's default schema, then every key of the configuration,
    then the run's seed."""
    from mipnerf_pl_tpu_torch.config import default
    hp = default()
    hp.update(config['hparams'])
    hp['seed'] = int(seed)
    return hp


def weights(hp, seed: int, device) -> Dict[str, torch.Tensor]:
    """The MLP's initial parameters from the seed, made on the device in
    one draw: Xavier-uniform weights [out, in], zero biases (the Dense
    init of the configuration's source)."""
    from benchmark.reference import mlp_layout
    layout = mlp_layout(hp)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(i * o for _, i, o in layout)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, fan_in, fan_out in layout:
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        w = u[at:at + fan_in * fan_out].view(fan_out, fan_in)
        out[f'{name}.weight'] = (2 * w - 1) * bound
        out[f'{name}.bias'] = torch.zeros(fan_out, device=device)
        at += fan_in * fan_out
    return out


def check_layout(params: Dict[str, torch.Tensor], module) -> None:
    """Raise unless the program's model has exactly these parameters."""
    theirs = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    ours = {k: tuple(v.shape) for k, v in params.items()}
    if theirs != ours:
        raise RuntimeError(f'the program\'s parameters {theirs} are not the '
                           f'configuration\'s {ours}')


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metric_module(metric: str):
    """benchmark/metrics/<metric>.py (its name has dots, so it is loaded
    from its path)."""
    path = HERE / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{metric.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The `read(res)` of benchmark/metrics/<metric>.py."""
    return metric_module(metric).read
