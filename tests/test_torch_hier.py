"""The port's server on the trained hier family at full width against the
JAX package's answers, on the CPU, and those answers, which chip_smoke.py
holds the card's hier requests to (``tests/test_torch_hier_exact.py``
holds the latents and the exact decode's logs at full width,
``tests/test_torch_hier_small.py`` every encoder level, decode step and
endpoint at small width).

The JAX functions are called directly: the JAX hier decode oracles
(``tests/test_decode.py`` through ``tiny_model_setup``) read reference
data that are absent from the test machines.

On the trained HOPV ``hier-prop`` checkpoint
(``runs/QUALITY_hier_hopv.json.ckpt``) with the first 16 HOPV molecules:
the committed golden equals the JAX package's answers, recomputed, and the
port server's ``/encode`` (latents within 1e-4 relative), ``/reconstruct``
and ``/sample`` (8 at seed 0) equal them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hier.py

rewrites ``ggpm_tpu_torch/goldens/decode_hier_hopv16.json`` from the JAX
package.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.cli.common import read_csv_data as jax_read_csv
from ggpm_tpu.data.batching import to_model_batch as jax_to_model_batch
from ggpm_tpu.data.dataset import prune_to_vocab as jax_prune
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu.models.api import encode as jax_encode
from ggpm_tpu.models.vae import HierPropertyVAE as JaxHierPropertyVAE
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu_torch.bridge import load_model, read_checkpoint
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.serve import GgpmServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hier_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hier_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'decode_hier_hopv16.json')
# the trained checkpoint's configuration (scripts/quality_run.py:135-140)
TRAINED = dict(rnn_type='LSTM', hidden_size=250, embed_size=250,
               latent_size=24, linear_hidden_size=128, depthT=20, depthG=20,
               diterT=1, diterG=3, dropout=0.0)
ATOL = 1e-5
LATENT_RTOL = 1e-4
N_GOLDEN = 16
GOLDEN_SAMPLE = {'n': 8, 'seed': 0}
MAX_DECODE_STEP = 150


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def jax_fragments():
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


def close_logs(ours, theirs):
    """Per-step logs equal: probabilities within ATOL (relative above 1)."""
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if isinstance(a, float) or isinstance(b, float):
            assert abs(a - b) <= ATOL * max(1.0, abs(b)), (a, b)
        elif isinstance(a, (list, tuple)):
            assert type(a) is type(b)
            close_logs(a, b)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            close_logs([a[k] for k in a], [b[k] for k in a])
        else:
            assert a == b


def jax_batch(rows, jvocab):
    return jax.tree.map(jnp.asarray, jax_to_model_batch(
        jax_mg.tensorize(rows, jvocab, jax_avocab), jvocab.mask, pad=False))


# -- full width, the trained hier-prop checkpoint -----------------------------

def _jax_trained():
    """The JAX model, params and vocab of the trained checkpoint (the vocab
    loader sets the class-level fragment set)."""
    vocab, _ = jax_load_vocab(VOCAB)
    hv, iv = vocab.size()
    model = JaxHierPropertyVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, **TRAINED))
    return model, read_checkpoint(CKPT), vocab


def jax_latents():
    """The JAX model, params and vocab of the trained checkpoint, the first
    16 in-vocab HOPV molecules and their latents by the JAX encoder."""
    model, params, vocab = _jax_trained()
    rows = jax_prune(jax_read_csv(DATA), vocab, verbose=False)[:N_GOLDEN]
    z = np.asarray(jax_encode(model, params, jax_batch(rows, vocab))[0])
    return model, params, vocab, rows, z


def jax_reference():
    """The JAX package's answers to chip_smoke.py's hier requests, on the
    CPU: the latents of the first 16 HOPV molecules, their ``decode_best``
    (the JAX server's ``/reconstruct``) and ``sample_prior`` of 8 at seed
    0 (``/sample``).  Returns the golden and the latents."""
    model, params, vocab, rows, z = jax_latents()
    _, rec = jax_decode.decode_best(model, params, vocab, jax_avocab, z,
                                    greedy=True,
                                    max_decode_step=MAX_DECODE_STEP)
    _, sam = jax_decode.sample_prior(
        model, params, vocab, jax_avocab, GOLDEN_SAMPLE['n'],
        rng=np.random.default_rng(GOLDEN_SAMPLE['seed']),
        max_decode_step=MAX_DECODE_STEP)
    golden = dict(inputs=[r[0] for r in rows], sample_request=GOLDEN_SAMPLE,
                  max_decode_step=MAX_DECODE_STEP, reconstruct=rec,
                  sample=sam)
    return golden, z


@pytest.fixture(scope='module')
def trained(jax_fragments):
    golden, z = jax_reference()
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), vocab,
                          verbose=False)[:N_GOLDEN]
    return dict(golden=golden, z=z, model=model, vocab=vocab, rows=rows)


def test_golden_is_the_jax_answer(trained):
    """The committed golden is the JAX package's answer, recomputed; its
    inputs are the port's first 16 in-vocab HOPV molecules."""
    with open(GOLDEN) as f:
        assert json.load(f) == trained['golden']
    assert [r[0] for r in trained['rows']] == trained['golden']['inputs']


def post(port, path, payload):
    import urllib.request
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_server_answers_as_jax(trained):
    """``/encode``, ``/reconstruct`` and ``/sample`` of the port's server
    on the trained hier checkpoint: the JAX package's latents (within 1e-4
    relative) and strings."""
    t = trained
    srv = GgpmServer(t['model'], t['vocab'], device='cpu')
    assert srv.is_hier
    port = srv.start(port=0).server_address[1]
    try:
        smiles = t['golden']['inputs']
        lat = np.asarray(post(port, '/encode', {'smiles': smiles})['latents'])
        np.testing.assert_allclose(lat, t['z'], rtol=0,
                                   atol=LATENT_RTOL * np.abs(t['z']).max())
        assert post(port, '/reconstruct', {'smiles': smiles}) == \
            {'smiles': t['golden']['reconstruct']}
        assert post(port, '/sample', GOLDEN_SAMPLE) == \
            {'smiles': t['golden']['sample']}
        assert 'error' in _post_error(port, '/properties',
                                      {'smiles': smiles[:2]})
    finally:
        srv.stop()


def _post_error(port, path, payload):
    import urllib.error
    try:
        return post(port, path, payload)
    except urllib.error.HTTPError as e:
        assert e.code == 500
        return json.loads(e.read())


if __name__ == '__main__':
    with open(GOLDEN, 'w') as f:
        json.dump(jax_reference()[0], f, indent=1)
        f.write('\n')
