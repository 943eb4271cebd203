"""The latent search on the card: the trained HOPV model's heads searched
on the GPU against the same search on the CPU, with rows resetting their
patience along the way, and the safety cap.  On the card, from the root of
the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_latent_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which the card's
machine does not have.)  Without a card every test skips, decided inside
the ``card`` fixture, never at import.
"""

import os

import numpy as np
import pytest
import torch

from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.latent.control import LatentOptimizer
from ggpm_tpu_torch.models.api import encode
from ggpm_tpu_torch.profile_serve import OPTIMIZE_SETTINGS, optimize_targets

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
N_MOLS = 64
ATOL = 1e-5
# latents searched at OPTIMIZE_SETTINGS: five steps at lr 500 amplify the
# heads' rounding with the distance they move a row (port against the JAX
# package on the CPU: 4.0e-5 at most)
AMPLIFIED_ATOL = 1e-4
# settings that move the latents by about 1 without that amplification,
# each row taking a fixed number of steps (no decision near a threshold)
MILD = {'soft': dict(latent_lr=100.0, property_delta=2e-4,
                     patience_threshold=1.0),
        'patience': dict(latent_lr=100.0, patience_threshold=1.0),
        'hard': {}}
# rows reset their patience along the way: at lr 30 and threshold 0.5,
# 10 iterations for patience on the CPU, two rows resetting, every
# decision at least 3.6 % of its threshold away from it.  (At threshold
# 0.1 the search runs about 173 iterations, and latents 1e-6 apart end
# up to 6 iterations apart on the CPU: no device can match another there.)
RESETS = {'soft': dict(latent_lr=30.0, patience_threshold=0.5,
                       property_delta=2e-4),
          'patience': dict(latent_lr=30.0, patience_threshold=0.5),
          'hard': {}}
SETTINGS = {'mild': MILD, 'resets': RESETS}


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    model, vocab = load_model(CKPT, VOCAB, device='cuda')
    model_cpu, _ = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:N_MOLS]
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    # both devices search from the same latents: the CPU encoder's
    z = encode(model_cpu, batch)[0]
    homo, lumo = optimize_targets(rows)
    return dict(model=model, model_cpu=model_cpu, z=z, homo=homo, lumo=lumo)


def _search(model, z, homo, lumo, policy, **kw):
    opt = LatentOptimizer(model, optimize_type=policy, **kw)
    out = opt.optimize(z, homo, lumo)
    return out.cpu().numpy(), opt.stats()


@pytest.mark.parametrize('settings', ['mild', 'resets', 'chip_smoke'])
@pytest.mark.parametrize('policy', ['soft', 'patience', 'hard'])
def test_search_on_the_card_is_the_cpus(card, policy, settings):
    kw = (OPTIMIZE_SETTINGS if settings == 'chip_smoke' else
          SETTINGS[settings])[policy]
    c = card
    got, stats = _search(c['model'], c['z'].cuda(), c['homo'], c['lumo'],
                         policy, **kw)
    want, wstats = _search(c['model_cpu'], c['z'], c['homo'], c['lumo'],
                           policy, **kw)
    assert stats == wstats
    if settings == 'resets' and policy == 'patience':
        # some row kept its patience past its first steps
        assert stats['iterations'] > 6
    np.testing.assert_allclose(got, want, rtol=0, atol=AMPLIFIED_ATOL if
                               settings == 'chip_smoke' else ATOL)
    with torch.no_grad():
        preds = [m.predict_properties(torch.from_numpy(x).to(d))
                 for m, x, d in ((c['model'], got, 'cuda'),
                                 (c['model_cpu'], want, 'cpu'))]
    for a, b in zip(*preds):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize('policy', ['soft', 'patience'])
def test_search_cap_on_the_card(card, policy):
    """A search that never stops runs exactly max(20·steps, 1000)
    iterations on the card too, and leaves the latents as they were."""
    c = card
    got, st = _search(c['model'], c['z'].cuda(), c['homo'], c['lumo'],
                      policy, latent_lr=0.0, property_optim_step=60,
                      property_delta=-1.0, patience=10 ** 9)
    assert st == dict(iterations=1200, by_delta=[], by_patience=[])
    np.testing.assert_array_equal(got, c['z'].numpy())


def test_search_under_inference_mode_on_the_card(card):
    c = card
    want, _ = _search(c['model'], c['z'].cuda(), c['homo'], c['lumo'],
                      'soft', **MILD['soft'])
    with torch.inference_mode():
        got, _ = _search(c['model'], c['z'].cuda(), c['homo'], c['lumo'],
                         'soft', **MILD['soft'])
    np.testing.assert_array_equal(got, want)
