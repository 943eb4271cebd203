"""The control of each cell on the card: the reference in TF32, one
precision below the configurations' float32 with TF32 off, comes out not
correct against the float32 reference, and so does a step that leaves
half its batch out.  At the cell's own size and one seed (``control.py``
reads more seeds).  Marked ``cuda``: it skips without a card."""

import pytest
import torch

from benchmark import run

CELLS = [w['name'] for w in run.load_json(run.ROOT,
                                          'BENCHMARK.json')['workloads']]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: TF32 exists only there')
    return 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_the_control_and_half_a_batch_fail(card, cell):
    from benchmark.tests.control import readings
    from benchmark.yardstick.compare import judge
    limits = run.load_json(run.HERE, 'workloads', cell + '.json')['limits']
    out = readings(cell, 2 ** 31 + 3, card)
    for kind in ('control', 'half_batch'):
        assert not all(c['ok'] for c in judge(out[kind], limits)), out
