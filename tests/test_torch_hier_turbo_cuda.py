"""The hier turbo decode on the card: the propose loop replayed from a
captured CUDA graph against the same loop run eagerly, bit for bit (the
same kernels in the same order), ``nei_sum`` at the propose step's four
sums against its plain version, and the card's propose trace against the
CPU port's on the trained ``hier-prop`` checkpoint's 16 golden molecules.
Needs an NVIDIA GPU and ``nvcc``; on the card, from the root of the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hier_turbo_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which the card's machine
does not have.)  Without a card every test skips, decided inside the
``card`` fixture, never at import.
"""

import os

import numpy as np
import pytest
import torch

from ggpm_tpu_torch import kernel_bench
from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models import decode
from ggpm_tpu_torch.models.api import encode

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hier_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hier_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
T = 150
BEAM = 5
N_GOLDEN = 16
FLOAT_COLS = [0] + list(range(2, 2 + BEAM))
INT_COLS = [c for c in range(9 + 3 * BEAM) if c not in FLOAT_COLS]
TRACE_ATOL = 1e-4


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    model, vocab = load_model(CKPT, VOCAB, device='cuda')
    rows = prune_to_vocab(read_csv_data(DATA), vocab,
                          verbose=False)[:N_GOLDEN]
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    return dict(model=model, vocab=vocab, z=encode(model, batch)[0],
                budgets=decode.hier_budgets(vocab, common_atom_vocab))


def _round(model, vocab, z, budgets, graph):
    """One propose round over latents ``z``: replayed from a CUDA graph
    with the turbo decode's lookahead, or eagerly one step at a time
    (on the CPU when ``z`` is there)."""
    tabs, mask = decode._device_vocab(vocab, common_atom_vocab, z.device)
    with torch.inference_mode():
        prop = decode.HierProposer(model, mask, tabs, BEAM, T, len(z),
                                   graph=graph, budgets=budgets)
        return decode.propose_round(
            prop, z, lookahead=decode.CUDA_LOOKAHEAD if graph else 0)[0]


def test_graph_round_equals_eager_round(card):
    """A round replayed from the captured graph gives the eager round's
    trace, roots and flags bit for bit."""
    c = card
    graphed = _round(c['model'], c['vocab'], c['z'], c['budgets'], True)
    eager = _round(c['model'], c['vocab'], c['z'], c['budgets'], False)
    assert graphed[3] == eager[3] > 5
    for a, b in zip(graphed[:3] + graphed[4:], eager[:3] + eager[4:]):
        np.testing.assert_array_equal(a, b)


def test_propose_sites_kernel_equals_plain(card):
    """``nei_sum`` at the propose step's four sums (step 20 of a round)
    equals its plain version within 1e-5 and the in-order sum bit for
    bit."""
    c = card
    cases = kernel_bench.hier_turbo_cases(c['model'], c['vocab'], [c['z']])
    assert [x['case'] for x in cases] == [
        f'hier-turbo-{site}-B{N_GOLDEN}'
        for site in kernel_bench.HIER_PROPOSE_NAMES]
    for x in cases:
        out = x['call']()
        assert (out - x['plain']()).abs().max().item() <= 1e-5, x['case']
        assert torch.equal(out, x['exact']()), x['case']


def test_card_trace_equals_cpu_trace(card):
    """The card's propose round over the 16 golden molecules' latents
    gives the CPU port's: roots and ``poisoned`` equal, integer columns
    equal, floats within 1e-4."""
    c = card
    model_cpu, vocab_cpu = load_model(CKPT, VOCAB, device='cpu')
    ours = _round(c['model'], c['vocab'], c['z'], c['budgets'], True)
    theirs = _round(model_cpu, vocab_cpu, c['z'].cpu(), c['budgets'], False)
    for k in (1, 2, 4):
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ours[3] == theirs[3]
    np.testing.assert_array_equal(ours[0][..., INT_COLS],
                                  theirs[0][..., INT_COLS])
    np.testing.assert_allclose(ours[0][..., FLOAT_COLS],
                               theirs[0][..., FLOAT_COLS], rtol=0,
                               atol=TRACE_ATOL)
