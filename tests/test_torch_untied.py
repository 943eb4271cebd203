"""Untied embeddings (``tie_embedding`` False) in both families against the
JAX package's, on the CPU, and what reads them (ROADMAP A5): each
encoder and decoder owns its ``E_c_mod``/``E_i_mod``, the fine-tuning
groups route the encoder's to the encoder group, the decodes read the
decoder's own tables, the bridge carries the leaves byte for byte and
``load_model`` tells a GRU model and untied embeddings from the tree, and
``serve.py`` answers every endpoint for a GRU + untied ``prop-opt``
checkpoint that the JAX package wrote.

The models at the small widths of ``tests/torch_a5.py`` (hidden = embed =
32, latent 8, depth 3) by its f32 rule: losses within 1e-5 relative, each
gradient leaf within 1e-4 of its largest entry (floor 1e-3 of any
leaf's).  Optimizer updates within 1e-6 relative or 2e-7 (a few ulps of
updates of about lr, as ``tests/test_torch_propopt.py``).  Decodes: 8
prior latents, greedy, strings equal and per-step logs within 1e-5.  The
server: latents and property predictions within 1e-5 of JAX's
``GgpmServer`` on the same checkpoint, strings equal.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_untied.py

rewrites ``ggpm_tpu_torch/goldens/decode_gru_hopv16.json`` (chip_smoke.py
phase 14's decodes of a GRU + untied model of each family) from the JAX
package on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggpm_tpu.data.batching import to_model_batch as jax_to_model_batch
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu.models import vae as jax_vae
from ggpm_tpu.models.api import encode as jax_encode
from ggpm_tpu.serve import GgpmServer as JaxGgpmServer
from ggpm_tpu.train import checkpoint as jax_ckpt
from ggpm_tpu.train.optim import default_group_fn as jax_group_fn
from ggpm_tpu.train.optim import make_multi_optimizer as jax_multi
from ggpm_tpu_torch import bridge, profile_train
from ggpm_tpu_torch.bridge import (flatten, load_flax_params, load_model,
                                   msgpack_serialize, read_checkpoint,
                                   to_flax_tree)
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file
from ggpm_tpu_torch.models import decode
from ggpm_tpu_torch.models.vae import (HierPropOptVAE, PropertyVAE,
                                       PropOptVAE, init_params)
from ggpm_tpu_torch.profile_serve import HIER_VOCAB
from ggpm_tpu_torch.serve import GgpmServer
from ggpm_tpu_torch.train import checkpoint as ckpt
from ggpm_tpu_torch.train.optim import default_group_fn, make_multi_optimizer
from test_torch_hier import close_logs
from torch_a5 import (CLASSES, HOPV_CSV, ROOT, check_f32, configs,
                      hier_data, motif_data, port_model, small_params,
                      write_golden)

GRU_UNTIED = dict(rnn_type='GRU', tie_embedding=False)
MAX_STEP = 20
LRS = {'encoder': 1e-2, 'decoder': 5e-3, 'homo': 2e-3, 'lumo': 1e-3}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_untied_trees_own_their_embeddings():
    """Untied, the VAE has no ``E_c``/``E_i``: the encoder and decoder
    each register their own tables (flax ``encoder/E_c_mod`` ...); tied,
    one shared pair at the root, which neither registers."""
    data = motif_data()
    untied = PropertyVAE(configs(data, tie_embedding=False)[0])
    tied = PropertyVAE(configs(data)[0])
    paths = set(flatten(to_flax_tree(untied)))
    for owner in ('encoder', 'decoder'):
        for t in ('E_c_mod', 'E_i_mod'):
            assert f'params/{owner}/{t}/embedding' in paths
    assert not any(p.startswith(('params/E_c/', 'params/E_i/'))
                   for p in paths)
    assert untied.encoder._embed[0] is untied.encoder.E_c_mod
    assert untied.decoder._embed[0] is not untied.encoder._embed[0]
    tpaths = set(flatten(to_flax_tree(tied)))
    assert {'params/E_c/embedding', 'params/E_i/embedding'} <= tpaths
    assert not any('_mod' in p for p in tpaths)
    assert tied.decoder._embed[0] is tied.encoder._embed[0] is tied.E_c


@pytest.mark.parametrize('name', ['prop-opt', 'prop-opt-sched'])
def test_untied_motif_model_matches_jax(name):
    check_f32(name, motif_data(), i=1, tie_embedding=False)


def test_untied_hier_model_matches_jax():
    check_f32('hier-prop-opt', hier_data(), tie_embedding=False)


@pytest.mark.parametrize('name', ['prop-opt', 'hier-prop-opt'])
def test_fine_tuning_groups_match_jax(name):
    """One update of each group's random gradients (the encoder's large
    enough to be clipped at 3) through ``make_multi_optimizer`` against
    JAX's ``make_multi_optimizer`` (``optax.multi_transform`` labelled by
    its ``default_group_fn``): the untied encoder's embeddings fall in the
    encoder group, the decoder's in the decoder group, in both."""
    data = hier_data() if name.startswith('hier') else motif_data()
    cls = CLASSES[name][0]
    cfg, _ = configs(data, tie_embedding=False)
    params = small_params(cls, cfg, 4)
    model = port_model(cls, cfg, params)
    names = dict(model.named_parameters())
    for path in flatten(params):
        if 'E_c_mod' in path:
            owner = 'encoder' if '/encoder/' in path else 'decoder'
            name_ = '.'.join(path.split('/')[1:-1] + ['weight'])
            assert default_group_fn(name_) == owner
            key = ''.join(f"['{m}']" for m in path.split('/'))
            assert jax_group_fn(key) == owner
    rng = np.random.default_rng(6)
    grads = {k: (rng.normal(0, 1, v.shape) *
                 (1.0 if '/encoder/' in k else 0.01)).astype(np.float32)
             for k, v in flatten(params).items()}
    tx = jax_multi(jax_group_fn, LRS, clip_norm=3.0)
    jp = jax.tree.map(jnp.asarray, params)
    upd, _ = jax.jit(tx.update)(jax.tree.map(jnp.asarray,
                                             ckpt._unflatten(grads)),
                                tx.init(jp), jp)
    want = flatten(jax.tree.map(np.asarray, optax.apply_updates(jp, upd)))
    state = make_multi_optimizer(default_group_fn, LRS,
                                 clip_norm=3.0).attach(names)
    template = cls(cfg)
    load_flax_params(template, ckpt._unflatten(grads))
    for n, p in template.named_parameters():
        names[n].grad = p.detach().clone()
    state.step()
    assert float(state.group_norms['encoder']) > 3.0
    got = flatten(to_flax_tree(model))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=2e-7,
                                   err_msg=k)


@pytest.mark.parametrize('family', ['motif', 'hier'])
@pytest.mark.parametrize('kw', [GRU_UNTIED, dict(tie_embedding=False),
                                dict(rnn_type='GRU')],
                         ids=['gru-untied', 'untied', 'gru'])
def test_bridge_round_trip_and_detection(family, kw, tmp_path):
    """A checkpoint the JAX package writes of a GRU and/or untied model:
    ``read_checkpoint`` → the port → ``to_flax_tree`` →
    ``msgpack_serialize`` is its bytes, and ``load_model`` finds the
    family, the cell (``rnn_type``) and the tying (``tied``)."""
    name = 'hier-prop-opt' if family == 'hier' else 'prop-opt'
    data = hier_data() if family == 'hier' else motif_data()
    cfg, _ = configs(data, **kw)
    params = small_params(CLASSES[name][0], cfg, 5)
    path = str(tmp_path / 'model.ckpt')
    jax_ckpt.save_params(jax.tree.map(jnp.asarray, params), path)
    with open(path, 'rb') as f:
        raw = f.read()
    tree = read_checkpoint(path)
    assert bridge.rnn_type(tree) == kw.get('rnn_type', 'LSTM')
    assert bridge.tied(tree) == kw.get('tie_embedding', True)
    model = port_model(CLASSES[name][0], cfg, tree)
    assert msgpack_serialize(to_flax_tree(model)) == raw
    vocab_file = tmp_path / 'vocab.txt'
    vocab_file.write_text(''.join(f'{a} {b}\n'
                                  for a, b in data['vocab'].vocab))
    if family == 'motif':
        # load_model builds ModelConfig's default widths: a full-width
        # checkpoint of the same options
        full, _ = configs(data, **kw)
        full.embed_size = full.hidden_size = 250
        full.latent_size, full.linear_hidden_size, full.depthT = 24, 128, 20
        wide = CLASSES[name][0](full)
        jax_ckpt.save_params(to_flax_tree(wide), path)
        loaded, _ = load_model(path, str(vocab_file), device='cpu')
        assert type(loaded) is PropOptVAE
        assert loaded.cfg.rnn_type == kw.get('rnn_type', 'LSTM')
        assert loaded.cfg.tie_embedding == kw.get('tie_embedding', True)
        assert msgpack_serialize(to_flax_tree(loaded)) == \
            msgpack_serialize(to_flax_tree(wide))
    else:
        assert bridge.model_class(tree) is HierPropOptVAE


@pytest.fixture(scope='module')
def gru_motif():
    data = motif_data()
    cfg, jcfg = configs(data, **GRU_UNTIED)
    params = small_params(CLASSES['prop-opt'][0], cfg, 3)
    return dict(data=data, params=params,
                jmodel=CLASSES['prop-opt'][1](cfg=jcfg),
                model=port_model(CLASSES['prop-opt'][0], cfg,
                                 params).eval(),
                z=np.random.default_rng(5).normal(
                    size=(8, cfg.latent_size)).astype(np.float32))


def test_gru_untied_decode_motif_matches_jax(gru_motif):
    """The exact ``decode_motif`` and the turbo ``decode_motif_turbo`` of
    a GRU + untied ``prop-opt``: JAX's strings and per-step logs; the
    turbo's strings equal the exact path's."""
    s = gru_motif
    kw = dict(greedy=True, max_decode_step=MAX_STEP)
    jres, jsmiles = jax_decode.decode_motif(
        s['jmodel'], s['params'], s['data']['jvocab'], jax_avocab, s['z'],
        log_steps=True, **kw)
    res, smiles = decode.decode_motif(s['model'], s['data']['vocab'],
                                      common_atom_vocab, s['z'],
                                      log_steps=True, **kw)
    assert smiles == jsmiles
    close_logs(res, jres)
    _, jturbo = jax_decode.decode_motif_turbo(
        s['jmodel'], s['params'], s['data']['jvocab'], jax_avocab, s['z'],
        **kw)
    _, turbo = decode.decode_motif_turbo(s['model'], s['data']['vocab'],
                                         common_atom_vocab, s['z'], **kw)
    assert turbo == jturbo == smiles
    carry = s['model'].vae.decoder.propose_carry(2, 4, 3, 8, 12, 'cpu')
    assert 'h' in carry and 'c' not in carry


@pytest.fixture(scope='module')
def servers(gru_motif, tmp_path_factory):
    """The port's ``GgpmServer`` on a GRU + untied ``prop-opt`` checkpoint
    the JAX package wrote (full width, ``load_model`` reads only the
    options; flax's initialisers, seeded, without noise), and JAX's
    ``GgpmServer`` on the same params."""
    data = gru_motif['data']
    tmp = tmp_path_factory.mktemp('serve')
    cfg, jcfg = configs(data, **GRU_UNTIED)
    for c in (cfg, jcfg):
        c.embed_size = c.hidden_size = 250
        c.latent_size, c.linear_hidden_size, c.depthT = 24, 128, 20
    params = to_flax_tree(init_params(CLASSES['prop-opt'][0](cfg),
                                      torch.Generator().manual_seed(7)))
    path = str(tmp / 'model.ckpt')
    jax_ckpt.save_params(jax.tree.map(jnp.asarray, params), path)
    vocab_file = tmp / 'vocab.txt'
    vocab_file.write_text(''.join(f'{a} {b}\n'
                                  for a, b in data['vocab'].vocab))
    model, vocab = load_model(path, str(vocab_file), device='cpu')
    port = GgpmServer(model, vocab, max_decode_step=MAX_STEP, device='cpu')
    jax_server = JaxGgpmServer(CLASSES['prop-opt'][1](cfg=jcfg),
                               jax.tree.map(jnp.asarray, params),
                               data['jvocab'], max_decode_step=MAX_STEP)
    return dict(port=port, jax=jax_server,
                smiles=[r[0] for r in data['rows'][:4]])


def test_gru_untied_server_matches_jax(servers):
    """``/encode`` and ``/properties`` within 1e-5, ``/reconstruct`` and
    ``/sample`` (turbo) equal strings, ``/optimize`` (hard) equal strings
    and predictions within 1e-5."""
    port, jax_server, smiles = servers['port'], servers['jax'], \
        servers['smiles']
    np.testing.assert_allclose(port.encode(smiles)['latents'],
                               jax_server.encode(smiles)['latents'], rtol=0,
                               atol=1e-5)
    for k, v in jax_server.properties(smiles).items():
        np.testing.assert_allclose(port.properties(smiles)[k], v, rtol=0,
                                   atol=1e-5)
    assert port.reconstruct(smiles) == jax_server.reconstruct(smiles)
    assert port.sample(6, seed=3) == jax_server.sample(6, seed=3)
    homo, lumo = [-5.0] * 2, [-2.5] * 2
    want = jax_server.optimize(smiles[:2], homo, lumo)
    got = port.optimize(smiles[:2], homo, lumo)
    assert got['smiles'] == want['smiles']
    for k in ('homo', 'lumo'):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


# -- the phase-14 decode golden -----------------------------------------------

GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'decode_gru_hopv16.json')
N_GOLDEN = 16


def _golden_rows(vocab_path):
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        jvocab, _ = jax_load_vocab(vocab_path)
        rows = prune_to_vocab(read_csv_data(HOPV_CSV),
                              load_vocab_file(vocab_path),
                              verbose=False)[:N_GOLDEN]
        jbatch = jax.tree.map(jnp.asarray, jax_to_model_batch(
            jax_mg.tensorize([[r[0], None, None] for r in rows], jvocab,
                             jax_avocab), jvocab.mask, pad=False))
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    return rows, jvocab, jbatch


def jax_reference():
    """chip_smoke.py phase 14's decode golden: for each of
    ``profile_train.gru_serve_models`` (``prop-opt`` and ``hier-prop``
    with GRU and untied embeddings, full width, ``init_params`` seeded
    with ``A5_SEED``), the JAX package's latents of the first 16 in-vocab
    HOPV molecules and its greedy ``decode_best`` of them.  The models are
    untrained, so every decode runs to the step cap (a probe: repeats of
    40 characters and more within 20 steps); ``A5_DECODE_STEP`` keeps the
    molecules small enough that a near-tie stays rare."""
    out = dict(init='ggpm_tpu_torch.models.vae.init_params',
               seed=profile_train.A5_SEED,
               max_decode_step=profile_train.A5_DECODE_STEP, models={})
    for (model, _), (name, vocab_path) in zip(
            profile_train.gru_serve_models(),
            (('prop-opt', profile_train.VOCAB), ('hier-prop', HIER_VOCAB))):
        rows, jvocab, jbatch = _golden_rows(vocab_path)
        cfg = dict(vars(model.cfg), compute_dtype='float32')
        cfg.pop('hvocab_size'), cfg.pop('ivocab_size')
        hv, iv = jvocab.size()
        jmodel = CLASSES[name][1](cfg=jax_vae.ModelConfig(
            hvocab_size=hv, ivocab_size=iv, **cfg))
        params = jax.tree.map(jnp.asarray, to_flax_tree(model))
        z = np.asarray(jax_encode(jmodel, params, jbatch)[0])
        _, smiles = jax_decode.decode_best(
            jmodel, params, jvocab, jax_avocab, z, greedy=True,
            max_decode_step=profile_train.A5_DECODE_STEP, log_steps=False)
        out['models'][name] = dict(
            config=dict(rnn_type='GRU', tie_embedding=False),
            vocab=os.path.relpath(vocab_path, ROOT),
            inputs=[r[0] for r in rows], latents=z.tolist(),
            reconstruct=smiles)
    return out


@pytest.mark.slow
def test_port_on_the_cpu_meets_the_decode_golden():
    """chip_smoke.py phase 14's decodes on the CPU: from the golden's
    latents, the port's turbo and exact decodes of both models give the
    golden's strings (about 2 minutes: hence ``slow``)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    for (model, vocab), name in zip(profile_train.gru_serve_models(),
                                    ('prop-opt', 'hier-prop')):
        g = golden['models'][name]
        z = np.asarray(g['latents'], np.float32)
        kw = dict(greedy=True, max_decode_step=golden['max_decode_step'])
        _, turbo = decode.decode_best(model.eval(), vocab, common_atom_vocab,
                                      z, **kw)
        exact_fn = decode.decode_hier if name == 'hier-prop' else \
            decode.decode_motif
        _, exact = exact_fn(model, vocab, common_atom_vocab, z,
                            log_steps=False, **kw)
        assert turbo == exact == g['reconstruct'], name


if __name__ == '__main__':
    write_golden(GOLDEN, jax_reference())
