"""The hier family on the card: the trained ``hier-prop`` checkpoint's
encode, exact decode and kernel call sites on the GPU against the port on
the CPU.  On the card, from the root of the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hier_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which the card's
machine does not have.)  Without a card every test skips, decided inside
the ``card`` fixture, never at import.
"""

import json
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
from ggpm_tpu_torch.models.api import encode, tree_to_device
from ggpm_tpu_torch.ops import gather_rows, nei_sum, transpose_sum
from ggpm_tpu_torch.profile_serve import HIER_CKPT, HIER_VOCAB

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'decode_hier_hopv16.json')
N_MOLS = 64
# 20 LSTM rounds a level at width 250, three levels, in another summation
# order than the CPU's
LATENT_ATOL = 1e-4
KERNEL_ATOL = 1e-5


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    model, vocab = load_model(HIER_CKPT, HIER_VOCAB, device='cuda')
    model_cpu, _ = load_model(HIER_CKPT, HIER_VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:N_MOLS]
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    with open(GOLDEN) as f:
        golden = json.load(f)
    return dict(model=model, model_cpu=model_cpu, vocab=vocab, rows=rows,
                batch=batch, golden=golden)


def _levels(model, batch, device):
    tree = tree_to_device(batch['tree'], device,
                          ('fnode', 'fmess', 'agraph', 'bgraph', 'scope',
                           'cgraph'))
    graph = tree_to_device(batch['graph'], device)
    with torch.inference_mode():
        return [t.cpu().numpy() for t in model.encoder(tree, graph)]


def test_encoder_levels_on_the_card_are_the_cpus(card):
    """Root, motif, attachment and atom hiddens, and the latents."""
    for ours, cpu in zip(_levels(card['model'], card['batch'], 'cuda'),
                         _levels(card['model_cpu'], card['batch'], 'cpu')):
        np.testing.assert_allclose(ours, cpu, rtol=0, atol=LATENT_ATOL)
    z = encode(card['model'], card['batch'])[0].cpu().numpy()
    z_cpu = encode(card['model_cpu'], card['batch'])[0].numpy()
    np.testing.assert_allclose(z, z_cpu, rtol=0, atol=LATENT_ATOL)


def test_encode_launches(card):
    """5 ``nei_sum`` (three level readouts, the cluster sum, the root) and
    depthG + 2·depthT ``gather_rows`` an encode, no ``transpose_sum``."""
    cfg = card['model'].cfg
    before = [w.launches for w in (nei_sum, gather_rows, transpose_sum)]
    encode(card['model'], card['batch'])
    torch.cuda.synchronize()
    after = [w.launches for w in (nei_sum, gather_rows, transpose_sum)]
    assert [a - b for a, b in zip(after, before)] == \
        [5, cfg.depthG + 2 * cfg.depthT, 0]


def test_decode_on_the_card_is_the_golden(card):
    """The exact decode of the golden molecules' card latents gives the
    golden strings, 5 ``nei_sum`` a step."""
    g = card['golden']
    n = len(g['inputs'])
    batch = to_model_batch(tensorize(card['rows'][:n], card['vocab'],
                                     common_atom_vocab),
                           card['vocab'].mask, pad=False)
    z = encode(card['model'], batch)[0]
    before = nei_sum.launches
    _, smiles = decode.decode_hier(card['model'], card['vocab'],
                                   common_atom_vocab, z,
                                   max_decode_step=g['max_decode_step'])
    assert nei_sum.launches - before == 5 * decode.HIER_STATS['steps']
    assert smiles == g['reconstruct']


def test_kernels_at_the_hier_sites(card):
    """Each call site's inputs: the kernel within 1e-5 of the plain
    version and equal bit for bit to the sum in order."""
    cases = kernel_bench.hier_cases(card['model'], card['vocab'],
                                    card['rows'])
    assert len(cases) == 12
    for c in cases:
        out, ref = c['call'](), c['plain']()
        exact = (c['exact'] or c['plain'])()
        assert (out - ref).abs().max().item() <= KERNEL_ATOL, c['case']
        assert torch.equal(out, exact), c['case']
