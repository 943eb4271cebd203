"""The port's encoder, latents and property heads against the JAX modules,
in fp32 with no latent noise.

Small width (hidden 16, depth 3) with random params copied through the
bridge: tolerance 1e-5.  Full width with the trained HOPV checkpoint on 8
molecules: tolerance 1e-4, for 20 LSTM rounds at width 250 summed in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.data.batching import to_model_batch as jax_to_model_batch
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropOptVAE as JaxPropOptVAE
from ggpm_tpu_torch.bridge import load_flax_params, load_model, read_checkpoint
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import PairVocab, common_atom_vocab
from ggpm_tpu_torch.models.api import encode, tree_to_device
from ggpm_tpu_torch.models.vae import ModelConfig, PropOptVAE

torch.set_num_threads(1)

CKPT = 'runs/QUALITY_hopv.json.ckpt'
VOCAB = 'runs/QUALITY_hopv.json.vocab.txt'
SMALL = dict(embed_size=16, hidden_size=16, latent_size=8,
             linear_hidden_size=8, depthT=3)


def _close(ours, theirs, atol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=0, atol=atol)


@pytest.fixture(scope='module')
def jax_fragments():
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


@pytest.fixture(scope='module')
def small(jax_fragments, golden_smiles):
    """A small JAX PropOptVAE over the golden molecules, its params with
    noise added to every leaf (so zero-initialised biases are checked too),
    and the port model with the same params through the bridge."""
    jax_mg.MolGraph.FRAGMENTS = set()
    labels = set()
    for s in golden_smiles:
        h = jax_mg.MolGraph(s)
        for _, d in h.mol_tree.nodes(data=True):
            labels.add(d['label'])
            for _, anc in d['inter_label']:
                labels.add((d['smiles'], anc))
    pairs = sorted(labels)
    jvocab, vocab = JaxPairVocab(pairs), PairVocab(pairs)
    rows = [[s, None, None] for s in golden_smiles[:8]]
    jbatch = jax_to_model_batch(jax_mg.tensorize(rows, jvocab, jax_avocab),
                                jvocab.mask, pad=False)
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    hv, iv = vocab.size()
    jmodel = JaxPropOptVAE(cfg=JaxModelConfig(hvocab_size=hv, ivocab_size=iv,
                                              rnn_type='LSTM', dropout=0.0,
                                              **SMALL))
    key = jax.random.PRNGKey(0)
    params = jmodel.init({'params': key, 'dropout': key},
                         jax.tree.map(jnp.asarray, jbatch), 0.1, key, True,
                         True)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.1, x.shape)).astype(
            np.float32), params)
    model = PropOptVAE(ModelConfig(hvocab_size=hv, ivocab_size=iv, **SMALL))
    aside = load_flax_params(model, params)
    assert aside and all(k.startswith('vae/decoder/') for k in aside)
    return dict(jmodel=jmodel, params=params, model=model.eval(),
                tree=tree_to_device(batch['tree'], torch.device('cpu')),
                jtree=jax.tree.map(jnp.asarray, jbatch['tree']), batch=batch)


def test_lstm_cell_small(small):
    rng = np.random.default_rng(1)
    tree = small['tree']
    e = tree['fmess'].shape[0]
    x = rng.normal(0, 1, (e, SMALL['embed_size'] + 20)).astype(np.float32)
    h, c = small['jmodel'].apply(
        small['params'], jnp.asarray(x), small['jtree']['bgraph'],
        method=lambda m, x, b: m.vae.encoder.tree_encoder.rnn(x, b))
    with torch.no_grad():
        ours = small['model'].vae.encoder.tree_encoder.rnn(
            torch.from_numpy(x), tree['bgraph'])
    _close(ours[0], h, 1e-5)
    _close(ours[1], c, 1e-5)


def test_motif_encoder_small(small):
    root, node = small['jmodel'].apply(
        small['params'], small['jtree'],
        method=lambda m, t: m.vae.encoder(t))
    with torch.no_grad():
        ours = small['model'].vae.encoder(small['tree'])
    _close(ours[0], root, 1e-5)
    _close(ours[1], node, 1e-5)


def test_latent_and_properties_small(small):
    jm, params = small['jmodel'], small['params']
    z, kl = jm.apply(params, small['jtree'],
                     method=lambda m, t: m.encode_latent(t, None, False))
    homo, lumo = jm.apply(params, z,
                          method=lambda m, zz: m.predict_properties(zz))
    ours_z, ours_kl = encode(small['model'], small['batch'])
    with torch.no_grad():
        ours_h, ours_l = small['model'].predict_properties(ours_z)
    _close(ours_z, z, 1e-5)
    _close(ours_kl, kl, 1e-5)
    _close(ours_h, homo, 1e-5)
    _close(ours_l, lumo, 1e-5)


def test_rsample_with_noise_small(small):
    """The reparameterised sample from the same eps: z = μ + exp(lv/2)·eps
    with lv = −|W_var r|, μ and lv from the JAX heads."""
    jm, params = small['jmodel'], small['params']
    root, _ = jm.apply(params, small['jtree'],
                       method=lambda m, t: m.vae.encoder(t))
    mean = np.asarray(jm.apply(params, root,
                               method=lambda m, r: m.vae.R_mean(r)))
    log_var = -np.abs(np.asarray(jm.apply(
        params, root, method=lambda m, r: m.vae.R_var(r))))
    eps = np.random.default_rng(2).normal(0, 1, mean.shape).astype(np.float32)
    ours, _ = encode(small['model'], small['batch'], torch.from_numpy(eps))
    _close(ours, mean + np.exp(log_var / 2) * eps, 1e-5)


@pytest.fixture(scope='module')
def trained(jax_fragments):
    jvocab, _ = jax_load_vocab(VOCAB)
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data('data/hopv15.csv')[:8], vocab,
                          verbose=False)
    assert len(rows) == 8
    jbatch = jax_to_model_batch(jax_mg.tensorize(rows, jvocab, jax_avocab),
                                jvocab.mask, pad=False)
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    hv, iv = vocab.size()
    jmodel = JaxPropOptVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, rnn_type='LSTM', hidden_size=250,
        embed_size=250, latent_size=24, linear_hidden_size=128, depthT=20,
        dropout=0.0))
    return dict(model=model, batch=batch, jmodel=jmodel,
                params=read_checkpoint(CKPT),
                jtree=jax.tree.map(jnp.asarray, jbatch['tree']))


def test_trained_encoder_full_width(trained):
    root, node = trained['jmodel'].apply(
        trained['params'], trained['jtree'],
        method=lambda m, t: m.vae.encoder(t))
    with torch.no_grad():
        ours = trained['model'].vae.encoder(
            tree_to_device(trained['batch']['tree'], torch.device('cpu')))
    _close(ours[0], root, 1e-4)
    _close(ours[1], node, 1e-4)


def test_trained_latent_and_properties_full_width(trained):
    jm, params = trained['jmodel'], trained['params']
    z, kl = jm.apply(params, trained['jtree'],
                     method=lambda m, t: m.encode_latent(t, None, False))
    homo, lumo = jm.apply(params, z,
                          method=lambda m, zz: m.predict_properties(zz))
    ours_z, ours_kl = encode(trained['model'], trained['batch'])
    with torch.no_grad():
        ours_h, ours_l = trained['model'].predict_properties(ours_z)
    assert ours_z.shape == (8, 24)
    _close(ours_z, z, 1e-4)
    _close(ours_kl, kl, 1e-4)
    _close(ours_h, homo, 1e-4)
    _close(ours_l, lumo, 1e-4)
