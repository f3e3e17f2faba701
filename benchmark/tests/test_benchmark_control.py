"""The control of each cell on the card at the cell's own size: the plain
reference in TF32 (the precision below the configurations' float32 with
TF32 off) put in the program's place fails at least one compared number,
and so does each planted fault a training cell can have (the half-batch
loss; a state left unchanged reads 1 by construction), while the program
itself passes.  Run on the card with

    python3 -m pytest benchmark/tests -m cuda
"""

from __future__ import annotations

import json
import time

import pytest

from benchmark import harness
from benchmark.run import run_cell

CELLS = [w['name'] for w in harness.manifest()['workloads']]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the control runs at the cell\'s '
                    'own size on the card')
    return 'cuda'


def _fails(numbers: dict, limits: dict) -> bool:
    return any(limits.get(k) is not None and v > limits[k]
               for k, v in numbers.items())


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_and_program_passes(card, cell):
    _, config, mix = harness.cell(cell)
    controls = (('tf32', 'half_batch') if mix['driver'] == 'train'
                else ('tf32',))
    seconds = 0.5 if mix['driver'] == 'train' else 10.0
    line = run_cell(cell, 3000000777, seconds, False, card,
                    time.perf_counter(), controls)
    print(json.dumps(line['checks']), json.dumps(line['readings']))
    assert line['correct']
    limits = config['limits'][mix['driver']]
    for name in controls:
        assert _fails(line['readings'][name], limits), name
