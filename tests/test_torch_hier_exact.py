"""The port's hier family at full width against the JAX package's exact
path, on the CPU (``tests/test_torch_hier.py`` holds the port's server to
the JAX package's answers, recomputed into the committed golden).

On the trained HOPV ``hier-prop`` checkpoint
(``runs/QUALITY_hier_hopv.json.ckpt``) with the first 16 HOPV molecules:
latents within 1e-4 relative, and the exact decode's per-step logs equal,
its topology probabilities within 1e-5.  The JAX server decodes a hier
model's greedy requests through ``decode_hier_turbo`` and the port through
the exact ``decode_hier``: the JAX exact path gives the golden's
``/reconstruct`` strings, which ``tests/test_torch_hier.py`` holds equal to
the JAX server's.
"""

import json

import numpy as np
import pytest
import torch

from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models import api, decode
from test_torch_hier import (CKPT, DATA, GOLDEN, LATENT_RTOL,
                             MAX_DECODE_STEP, N_GOLDEN, VOCAB, close_logs,
                             jax_latents)


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def trained():
    from ggpm_tpu.graph import mol_graph as jax_mg
    saved = jax_mg.MolGraph.FRAGMENTS
    jmodel, params, jvocab, _, z = jax_latents()
    exact = jax_decode.decode_hier(jmodel, params, jvocab, jax_avocab, z,
                                   greedy=True,
                                   max_decode_step=MAX_DECODE_STEP,
                                   log_steps=True)
    jax_mg.MolGraph.FRAGMENTS = saved
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), vocab,
                          verbose=False)[:N_GOLDEN]
    return dict(z=z, exact=exact, model=model, vocab=vocab, rows=rows)


def test_jax_turbo_is_the_jax_exact_path(trained):
    """On the golden latents the JAX exact ``decode_hier``, which the port
    follows, gives the golden's strings: those of the JAX server's
    ``decode_hier_turbo``."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert trained['exact'][1] == golden['reconstruct']
    assert all(s is not None for s in trained['exact'][1])


def test_latents_full_width(trained):
    t = trained
    mb = tensorize(t['rows'], t['vocab'], common_atom_vocab)
    z, _ = api.encode(t['model'], to_model_batch(mb, t['vocab'].mask,
                                                 pad=False))
    np.testing.assert_allclose(z.numpy(), t['z'], rtol=0,
                               atol=LATENT_RTOL * np.abs(t['z']).max())


def test_decode_hier_full_width_logs(trained):
    """The exact path with per-step logs, from the JAX latents."""
    t = trained
    res, smiles = decode.decode_hier(t['model'], t['vocab'],
                                     common_atom_vocab, t['z'], greedy=True,
                                     max_decode_step=MAX_DECODE_STEP,
                                     log_steps=True)
    assert smiles == t['exact'][1]
    close_logs(res, t['exact'][0])
