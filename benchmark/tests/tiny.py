"""A small copy of the benchmark's checkout for the CPU tests: the same
BENCHMARK.json, every configuration and mix at a size a test can hold (a
32-wide MLP, 64 rays of 8 samples; each scene kind's and each driver's
SMALL sizes), the same code."""

from __future__ import annotations

import importlib
import json
import shutil
from pathlib import Path

from benchmark import harness, scenes

SMALL = {'train.batch_size': 64, 'nerf.num_samples': 8,
         'nerf.mlp.net_width': 32, 'nerf.mlp.net_width_condition': 16,
         'val.chunk_size': 64}


def make(root: Path) -> Path:
    """Write the small checkout under root and return root."""
    man = harness.manifest()
    shutil.copy(harness.ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
    for entry in man['configs']:
        with open(harness.ROOT / entry['file']) as f:
            config = json.load(f)
        config['hparams'].update(SMALL)
        config['scene'].update(scenes.kind(config['scene']).SMALL)
        path = root / entry['file']
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(config))
    mixes = root / 'benchmark' / 'mixes'
    mixes.mkdir(parents=True, exist_ok=True)
    for wl in man['workloads']:
        with open(harness.HERE / 'mixes' / f'{wl["traffic"]}.json') as f:
            mix = json.load(f)
        mix.update(importlib.import_module(
            f'benchmark.drivers.{mix["driver"]}').SMALL)
        (mixes / f'{wl["traffic"]}.json').write_text(json.dumps(mix))
    return root
