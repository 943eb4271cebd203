"""The port's attention heads (``use_attention``) against the JAX
package's, on the CPU, in all four model families, with the decode that
threads the attention memory (``decode_motif(src_mem=, src_scope=)``) and
the paths that refuse such a model; the ``vae_test`` and
``dump_latents`` CLIs against the JAX package's; and the JAX references
that chip_smoke.py phase 13 holds the card's attention models to.

Small width (hidden = embed = 32, latent 8, depth 3, dropout 0, the
latent's mean) with the same params in both packages (an init with noise
on every leaf, through the bridge): the motif families on batches of 8
molecules of ``data/chem_data/train.csv`` (lane-packed and unpacked), the
hier family on batches of 6 HOPV molecules in the trained hier vocab.
The decode at full width: the trained HOPV prop-opt checkpoint with its
attention heads from the port's init seeded with
``profile_train.HEADS_SEED`` (no trained checkpoint has them).  The JAX
functions are called directly: the JAX package's own attention test
(``test_models.py::test_attention_variant``) reads reference data absent
from the test machines.

Tolerances: losses within 1e-5 relative, accuracies within 1e-7; each
gradient leaf within 1e-4 of its largest entry in magnitude (or of 1e-3 of
the largest entry of any leaf); decode logs as tests/test_torch_decode.py
holds them (probabilities within 1e-5, scores within 1e-5 relative);
latents within 1e-5.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_attention.py

rewrites ``ggpm_tpu_torch/goldens/train_propopt_att_hopv.json``,
``train_hier_att_hopv.json`` (the JAX package's first 3 steps) and
``decode_att_hopv16.json`` (the strings of the JAX package's
``decode_motif``) on the CPU, about 5 minutes.
"""

import csv
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.cli import dump_latents as jax_dump_latents
from ggpm_tpu.cli import vae_test as jax_vae_test
from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.dataset import prune_to_vocab as jax_prune
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu.models.api import encode as jax_encode
from ggpm_tpu.models.vae import HierPropertyVAE as JaxHierPropertyVAE
from ggpm_tpu.models.vae import HierPropOptVAE as JaxHierPropOptVAE
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropertyVAE as JaxPropertyVAE
from ggpm_tpu.models.vae import PropOptVAE as JaxPropOptVAE
from ggpm_tpu.train import checkpoint as jax_ckpt
from ggpm_tpu.train import loop as jax_loop
from ggpm_tpu.train.loop import init_params_on_cpu, make_train_step
from ggpm_tpu.train.optim import default_group_fn as jax_group_fn
from ggpm_tpu.train.optim import make_multi_optimizer as jax_multi
from ggpm_tpu.train.optim import make_optimizer as jax_make_optimizer
from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import (flatten, load_flax_params, load_model,
                                   msgpack_serialize, to_flax_tree)
from ggpm_tpu_torch.cli import dump_latents, vae_test, vae_train
from ggpm_tpu_torch.cli.common import setup_model
from ggpm_tpu_torch.configs import Configs
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import MolGraph, tensorize
from ggpm_tpu_torch.graph.vocab import (PairVocab, common_atom_vocab,
                                        load_vocab_file)
from ggpm_tpu_torch.models import decode
from ggpm_tpu_torch.models.api import encode
from ggpm_tpu_torch.models.vae import (HierPropertyVAE, HierPropOptVAE,
                                       ModelConfig, PropertyVAE, PropOptVAE,
                                       init_params)
from ggpm_tpu_torch.profile_serve import HIER_VOCAB
from ggpm_tpu_torch.serve import GgpmServer
from ggpm_tpu_torch.train.loop import Trainer, to_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CSV = os.path.join(ROOT, 'data', 'chem_data', 'train.csv')
HOPV = os.path.join(ROOT, 'data', 'hopv15.csv')
GOLDENS = {name: os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens', name)
           for name in ('train_propopt_att_hopv.json',
                        'train_hier_att_hopv.json', 'decode_att_hopv16.json')}
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3,
             linear_hidden_size=16)
HIER_SMALL = dict(SMALL, depthG=3, diterT=1, diterG=3)
# the trained checkpoints' configurations (scripts/quality_run.py:134-140)
TRAINED = dict(rnn_type='LSTM', hidden_size=250, embed_size=250,
               latent_size=24, linear_hidden_size=128, depthT=20, dropout=0.0)
HIER_TRAINED = dict(TRAINED, depthG=20, diterT=1, diterG=3)
BATCH = 8
HIER_BATCH = 6
N_MOLS = 32
N_DECODE = 16        # the golden's molecules; the logs are held for 8
MAX_DECODE_STEP = 150
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ATOL = 1e-5
BETA = 0.1
HEADS = ('A_mem', 'A_topo', 'A_cls', 'A_assm')


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module', autouse=True)
def jax_fragments():
    """The JAX vocab loader sets the class-level fragment set that JAX's
    ``tensorize`` reads; restore it after the module."""
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


def _rows():
    with open(TRAIN_CSV) as f:
        rows = [[r['SMILES'].strip(), float(r['HOMO']), float(r['LUMO'])]
                for r in csv.DictReader(f)][:N_MOLS]
    rows[3][1] = None
    return rows


@pytest.fixture(scope='module')
def motif_data():
    """Vocabularies over the molecules (no fragments), and each package's
    model batches of 8 of them, unpacked and lane-packed."""
    jax_mg.MolGraph.FRAGMENTS = set()
    rows = _rows()
    labels = set()
    for s, _, _ in rows:
        for _, d in MolGraph(s, frozenset()).mol_tree.nodes(data=True):
            labels.add(d['label'])
            labels.update((d['smiles'], a) for _, a in d['inter_label'])
    pairs = sorted(labels)
    jvocab, vocab = JaxPairVocab(pairs), PairVocab(pairs)
    batches = {False: [], True: []}
    for i in range(0, N_MOLS, BATCH):
        g = rows[i:i + BATCH]
        jb = jax_batching.to_model_batch(jax_batching.pad_batch(
            jax_mg.tensorize(g, jvocab, jax_avocab)), jvocab.mask, pad=False)
        pb = batching.to_model_batch(batching.pad_batch(
            tensorize(g, vocab, common_atom_vocab)), vocab.mask, pad=False)
        batches[False].append((jb, pb))
        batches[True].append((
            dict(jb, plan=jax_batching.compact_plan_dict(
                {k: np.asarray(v) for k, v in jb['plan'].items()})),
            dict(pb, plan=batching.compact_plan_dict(
                {k: np.asarray(v) for k, v in pb['plan'].items()}))))
    hv, iv = vocab.size()
    return dict(rows=rows, pairs=pairs, vocab=vocab, batches=batches, hv=hv,
                iv=iv)


@pytest.fixture(scope='module')
def hier_data():
    """The hier vocab on both sides and two padded, unpacked batches of 6
    HOPV molecules, each package's own."""
    jvocab, _ = jax_load_vocab(HIER_VOCAB)
    vocab = load_vocab_file(HIER_VOCAB)
    rows = prune_to_vocab(read_csv_data(HOPV), vocab, verbose=False)
    batches = []
    for i in range(2):
        r = rows[HIER_BATCH * i:HIER_BATCH * (i + 1)]
        batches.append((
            jax_batching.to_model_batch(jax_batching.pad_batch(
                jax_mg.tensorize(r, jvocab, jax_avocab)), jvocab.mask,
                pad=False),
            batching.to_model_batch(batching.pad_batch(
                tensorize(r, vocab, common_atom_vocab)), vocab.mask,
                pad=False)))
    hv, iv = vocab.size()
    return dict(vocab=vocab, batches=batches, hv=hv, iv=iv)


FAMILIES = {'prop': (PropertyVAE, JaxPropertyVAE),
            'prop-opt': (PropOptVAE, JaxPropOptVAE),
            'hier-prop': (HierPropertyVAE, JaxHierPropertyVAE),
            'hier-prop-opt': (HierPropOptVAE, JaxHierPropOptVAE)}


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
        0, 0.1, x.shape)).astype(np.float32), tree)


def _family(name, data):
    """The small JAX model of family ``name`` with the attention heads,
    its params (the motif family's from a flax init, the hier family's
    from the port's, noise on every leaf) and a port model factory."""
    cls, jcls = FAMILIES[name]
    hier = name.startswith('hier')
    small = HIER_SMALL if hier else SMALL
    cfg = dict(hvocab_size=data['hv'], ivocab_size=data['iv'],
               use_attention=True, **small)
    jmodel = jcls(cfg=JaxModelConfig(rnn_type='LSTM', dropout=0.0, **cfg))
    if hier:
        params = to_flax_tree(init_params(cls(ModelConfig(**cfg)),
                                          torch.Generator().manual_seed(1)))
    else:
        params = init_params_on_cpu(jmodel, data['batches'][True][0][0],
                                    jax.random.PRNGKey(0))
    params = _noisy(params, 0)

    def port():
        model = cls(ModelConfig(**cfg))
        load_flax_params(model, params)
        return model
    return dict(jmodel=jmodel, params=params, port=port, hier=hier)


def _assert_grads(ours, theirs):
    theirs = flatten(jax.tree.map(np.asarray, theirs))
    assert set(ours) == set(theirs)
    top = max(np.abs(v).max() for v in theirs.values())
    for k, v in theirs.items():
        scale = max(np.abs(v).max(), 1e-3 * top)
        np.testing.assert_allclose(ours[k], v, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def _assert_metrics(metrics, jmet):
    assert set(metrics) == set(jmet)
    for k, v in jmet.items():
        if k in ('Word', 'I-Word', 'Topo', 'Assm'):
            assert float(metrics[k]) == pytest.approx(float(v), abs=1e-7), k
        else:
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=LOSS_RTOL,
                                       atol=1e-9 if 'MSE' in k else 0,
                                       err_msg=k)


@pytest.mark.parametrize('case', ['prop-unpacked', 'prop-packed',
                                  'prop-opt-unpacked', 'prop-opt-packed',
                                  'hier-prop', 'hier-prop-opt'])
def test_attention_loss_and_grads_match_jax(motif_data, hier_data, case):
    """Each family's forward with ``use_attention`` against
    ``jax.value_and_grad`` of the JAX model (latent's mean, dropout off):
    the total, every metric and every gradient; the attention heads
    (``A_mem`` and the decoder's ``A_topo``, ``A_cls``, ``A_assm``) are the
    only leaves the option adds, and each kernel's gradient is not
    zero."""
    name = case.removesuffix('-packed').removesuffix('-unpacked')
    hier = name.startswith('hier')
    data = hier_data if hier else motif_data
    fam = _family(name, data)
    jb, pb = (data['batches'][0] if hier else
              data['batches'][case.endswith('-packed')][1])
    jbd = jax.tree.map(jnp.asarray, jb)

    def jloss(p):
        total, metrics, _ = fam['jmodel'].apply(p, jbd, BETA,
                                                jax.random.PRNGKey(3), False,
                                                True)
        return total, metrics
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        fam['params'])
    model = fam['port']()
    tables = batching.hier_train_tables if hier else batching.train_tables
    total, metrics, _ = model(to_device(tables(pb), 'cpu'), BETA,
                              perturb_z=False)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jl), rtol=LOSS_RTOL)
    _assert_metrics(metrics, jmet)
    grads = flatten(to_flax_tree(model, lambda p: p.grad))
    _assert_grads(grads, jg)
    heads = {k for k in grads if k.split('/')[-2] in HEADS}
    prefix = {'prop': 'params/', 'prop-opt': 'params/vae/',
              'hier-prop': 'params/', 'hier-prop-opt': 'params/hier/'}[name]
    assert heads == {f'{prefix}{"" if h == "A_mem" else "decoder/"}{h}/{leaf}'
                     for h in HEADS for leaf in ('kernel', 'bias')}
    for k in heads:
        if k.endswith('kernel'):
            assert np.abs(grads[k]).max() > 0, k


def test_from_configs_reads_use_attention(motif_data):
    """``use_attention: true`` in a config builds the heads, as the JAX
    package's ``ModelConfig.from_configs`` does."""
    cfg = ModelConfig.from_configs(Configs(args=dict(use_attention=True,
                                                      **SMALL)),
                                   motif_data['vocab'])
    assert cfg.use_attention
    model = PropertyVAE(cfg)
    assert hasattr(model, 'A_mem') and hasattr(model.decoder, 'A_assm')
    assert not ModelConfig.from_configs(Configs(args=SMALL),
                                        motif_data['vocab']).use_attention


@pytest.mark.parametrize('hier', [False, True], ids=['prop-opt', 'hier-prop'])
def test_load_model_builds_the_attention_heads(tmp_path, hier):
    """``bridge.load_model`` builds a model with the attention heads from a
    checkpoint whose tree holds ``A_mem`` (the trained checkpoints with
    seeded heads, ``profile_train.attention_model``), its family from the
    rest of the tree, with every leaf the file's."""
    model, _ = profile_train.attention_model(hier)
    tree = to_flax_tree(model)
    (tmp_path / 'ckpt').write_bytes(msgpack_serialize(tree))
    vocab = HIER_VOCAB if hier else profile_train.VOCAB
    loaded, _ = load_model(str(tmp_path / 'ckpt'), vocab, device='cpu')
    assert type(loaded) is type(model) and loaded.cfg.use_attention
    mine, want = flatten(to_flax_tree(loaded)), flatten(tree)
    assert set(mine) == set(want)
    assert all(np.array_equal(mine[k], want[k]) for k in want)
    plain, _ = load_model(profile_train.CKPT if not hier else
                          profile_train.HIER_CKPT, vocab, device='cpu')
    assert not plain.cfg.use_attention


# -- the decode that threads the attention memory ---------------------------

def _jax_att_model():
    """The JAX prop-opt model of the trained HOPV checkpoint with the
    attention heads, its params (``profile_train.attention_model``'s
    weights, bridged) and vocab."""
    jvocab, _ = jax_load_vocab(profile_train.VOCAB)
    hv, iv = jvocab.size()
    jmodel = JaxPropOptVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, use_attention=True, **TRAINED))
    model, _ = profile_train.attention_model()
    return jmodel, to_flax_tree(model), jvocab


def _jax_att_inputs(jmodel, params, jvocab, rows):
    """The JAX encoder's latents, attention memory and scopes of
    ``rows``."""
    batch = jax.tree.map(jnp.asarray, jax_batching.to_model_batch(
        jax_mg.tensorize(rows, jvocab, jax_avocab), jvocab.mask, pad=False))
    z = np.asarray(jax_encode(jmodel, params, batch)[0])
    mem, scope = jmodel.apply(params, batch['tree'], method=lambda m, t:
                              m.encode_attention_memory(t))
    return z, np.asarray(mem), np.asarray(scope)


@pytest.fixture(scope='module')
def trained_att():
    jmodel, params, jvocab = _jax_att_model()
    model, vocab = profile_train.attention_model()
    rows = prune_to_vocab(read_csv_data(HOPV), vocab,
                          verbose=False)[:N_DECODE]
    z, mem, scope = _jax_att_inputs(jmodel, params, jvocab, rows[:8])
    return dict(jmodel=jmodel, params=params, jvocab=jvocab,
                model=model.eval(), vocab=vocab, rows=rows, z=z, mem=mem,
                scope=scope)


def _close_logs(ours, theirs):
    """Per-step logs equal: probabilities within ATOL, scores within ATOL
    relative (tests/test_torch_decode.py)."""
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if isinstance(a, float) or isinstance(b, float):
            assert abs(a - b) <= ATOL * max(1.0, abs(b)), (a, b)
        elif isinstance(a, (list, tuple)):
            assert type(a) is type(b)
            _close_logs(a, b)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            _close_logs([a[k] for k in a], [b[k] for k in a])
        else:
            assert a == b


def test_attention_memory_matches_jax(trained_att):
    """``encode_attention_memory`` on the port: the JAX encoder's memory
    and scopes, and the latents, within 1e-5."""
    t = trained_att
    batch = batching.to_model_batch(tensorize(
        t['rows'][:8], t['vocab'], common_atom_vocab), t['vocab'].mask,
        pad=False)
    z, _ = encode(t['model'], batch)
    with torch.no_grad():
        mem, scope = t['model'].encode_attention_memory(
            to_device(batch['tree'], 'cpu'))
    np.testing.assert_allclose(z.numpy(), t['z'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(mem.numpy(), t['mem'], rtol=0, atol=ATOL)
    assert np.array_equal(scope.numpy(), t['scope'])


def test_decode_motif_with_src_mem_matches_jax(trained_att):
    """``decode_motif`` greedy with the attention memory of 8 HOPV
    molecules against the JAX package's from the same latents, memory and
    scopes: the same strings and the same per-step logs."""
    t = trained_att
    jres, jsmiles = jax_decode.decode_motif(
        t['jmodel'], t['params'], t['jvocab'], jax_avocab, t['z'],
        greedy=True, max_decode_step=MAX_DECODE_STEP, log_steps=True,
        src_mem=t['mem'], src_scope=t['scope'])
    res, smiles = decode.decode_motif(
        t['model'], t['vocab'], common_atom_vocab, t['z'], greedy=True,
        max_decode_step=MAX_DECODE_STEP, log_steps=True, src_mem=t['mem'],
        src_scope=t['scope'])
    assert smiles == jsmiles
    _close_logs(res, jres)
    # the memory changes the answers: the heads are not the latent's
    _, plain = decode.decode_motif(
        load_model(profile_train.CKPT, profile_train.VOCAB, 'cpu')[0],
        t['vocab'], common_atom_vocab, t['z'], greedy=True,
        max_decode_step=MAX_DECODE_STEP, log_steps=False)
    assert plain != smiles


def _jax_refusal(t):
    with pytest.raises(NotImplementedError) as e:
        jax_decode._check_no_attention(t['jmodel'])
    return str(e.value)


REFUSALS = ('decode_motif', 'decode_motif_turbo', 'decode_hier',
            'decode_hier_turbo', 'sample_prior')


@pytest.mark.parametrize('path', REFUSALS)
def test_decode_paths_refuse_an_attention_model(trained_att, hier_data,
                                                path):
    """The paths that do not thread the attention memory refuse a
    ``use_attention`` model with the JAX package's message: the exact
    motif decode without memory, both turbo decodes, the exact hier
    decode (which has no attention), and prior sampling."""
    t = trained_att
    want = _jax_refusal(t)
    if 'hier' in path:
        model = _family('hier-prop', hier_data)['port']().eval()
        vocab = hier_data['vocab']
    else:
        model, vocab = t['model'], t['vocab']
    z = t['z'][:2, :model.cfg.latent_size]
    with pytest.raises(NotImplementedError) as e:
        if path == 'sample_prior':
            decode.sample_prior(model, vocab, common_atom_vocab, 2)
        else:
            getattr(decode, path)(model, vocab, common_atom_vocab, z)
    assert str(e.value) == want


def test_server_refuses_an_attention_decode(trained_att):
    """The server's ``/sample`` and ``/reconstruct`` of an attention model
    answer 500 with the refusal as the error body (the JAX server's
    ``{"error": str(e)}``); ``/encode`` answers."""
    import urllib.error
    import urllib.request
    t = trained_att
    srv = GgpmServer(t['model'], t['vocab'], device='cpu')
    port = srv.start(port=0).server_address[1]
    try:
        def post(path, payload):
            req = urllib.request.Request(
                f'http://127.0.0.1:{port}{path}',
                data=json.dumps(payload).encode(),
                headers={'Content-Type': 'application/json'})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())
        smiles = [r[0] for r in t['rows'][:2]]
        assert post('/sample', {'n': 2}) == (500, {'error': _jax_refusal(t)})
        assert post('/reconstruct', {'smiles': smiles}) == (
            500, {'error': _jax_refusal(t)})
        status, enc = post('/encode', {'smiles': smiles})
        assert status == 200 and len(enc['latents']) == 2
    finally:
        srv.stop()


def jax_decode_reference():
    """The JAX package's ``decode_motif`` (greedy, max_decode_step 150)
    with the attention memory of the first 16 in-vocab HOPV molecules, on
    the trained checkpoint with its heads seeded
    (``profile_train.attention_model``)."""
    jmodel, params, jvocab = _jax_att_model()
    rows = jax_prune(read_csv_data(HOPV), jvocab, verbose=False)[:N_DECODE]
    z, mem, scope = _jax_att_inputs(jmodel, params, jvocab, rows)
    _, smiles = jax_decode.decode_motif(
        jmodel, params, jvocab, jax_avocab, z, greedy=True,
        max_decode_step=MAX_DECODE_STEP, log_steps=False, src_mem=mem,
        src_scope=scope)
    return dict(checkpoint='runs/QUALITY_hopv.json.ckpt (full prop-opt '
                           'tree), attention heads seeded',
                heads_seed=profile_train.HEADS_SEED, vocab=
                'runs/QUALITY_hopv.json.vocab.txt', data='data/hopv15.csv',
                inputs=[r[0] for r in rows], max_decode_step=MAX_DECODE_STEP,
                reconstruct=smiles)


def test_port_on_the_cpu_meets_the_decode_golden(trained_att):
    """chip_smoke.py phase 13's attention decode on the CPU: the port's
    encoder and ``decode_motif`` with memory give the golden's strings."""
    t = trained_att
    with open(GOLDENS['decode_att_hopv16.json']) as f:
        golden = json.load(f)
    assert golden['inputs'] == [r[0] for r in t['rows']]
    batch = batching.to_model_batch(tensorize(
        t['rows'], t['vocab'], common_atom_vocab), t['vocab'].mask,
        pad=False)
    z, _ = encode(t['model'], batch)
    with torch.no_grad():
        mem, scope = t['model'].encode_attention_memory(
            to_device(batch['tree'], 'cpu'))
    _, smiles = decode.decode_motif(
        t['model'], t['vocab'], common_atom_vocab, z, greedy=True,
        max_decode_step=golden['max_decode_step'], log_steps=False,
        src_mem=mem, src_scope=scope)
    assert smiles == golden['reconstruct']


def test_decode_golden_is_the_jax_reference():
    """The committed decode golden is the JAX package's answer now (about
    20 s on one thread)."""
    with open(GOLDENS['decode_att_hopv16.json']) as f:
        assert json.load(f) == json.loads(json.dumps(jax_decode_reference()))


# -- the CLIs ------------------------------------------------------------------

def _write_csv(path, rows):
    with open(path, 'w') as f:
        f.write('SMILES,HOMO,LUMO\n')
        f.writelines(f'{s},{"" if h is None else h},{"" if l is None else l}\n'
                     for s, h, l in rows)
    return str(path)


def test_vae_train_cli_with_attention_one_epoch(motif_data, tmp_path):
    """``vae_train --model-type prop`` with ``use_attention: true`` trains
    one epoch on the CPU and writes a checkpoint with the heads, which the
    JAX package loads into its own attention model's params."""
    (tmp_path / 'vocab.txt').write_text(
        ''.join(f'{a} {b}\n' for a, b in motif_data['pairs']))
    data = _write_csv(tmp_path / 'data.csv', motif_data['rows'][:2 * BATCH])
    cfg = dict(vocab_=str(tmp_path / 'vocab.txt'),
               save_dir=str(tmp_path / 'out'), batch_size=BATCH, epoch=1,
               print_iter=1, seed=2, use_attention=True, **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    model = vae_train.main(['--path-to-config', str(tmp_path / 'cfg.json'),
                            '--model-type', 'prop', '--data-csv', data,
                            '--device', 'cpu'])
    assert model.cfg.use_attention
    jmodel = JaxPropertyVAE(cfg=JaxModelConfig(
        hvocab_size=motif_data['hv'], ivocab_size=motif_data['iv'],
        use_attention=True, **SMALL))
    template = init_params_on_cpu(jmodel, motif_data['batches'][True][0][0],
                                  jax.random.PRNGKey(0))
    jparams = jax_ckpt.load_params(template, str(tmp_path / 'out' / 'model.0'))
    mine = flatten(to_flax_tree(model))
    theirs = flatten(jax.tree.map(np.asarray, jparams))
    assert set(theirs) == set(mine) and 'params/A_mem/kernel' in mine
    for k, v in theirs.items():
        np.testing.assert_array_equal(v, mine[k])


def test_dump_latents_cli_matches_jax(tmp_path):
    """``dump_latents --model-type prop-opt`` on the trained HOPV
    checkpoint (7 molecules in batches of 3, one out of the vocab) against
    the JAX package's ``dump_latents.main`` on the same files: latents
    within 1e-5, the same ``.smiles.txt``."""
    vocab = load_vocab_file(profile_train.VOCAB)
    rows = read_csv_data(HOPV)
    inv = prune_to_vocab(rows[:40], vocab, verbose=False)
    out = [r for r in rows[:40] if r not in inv][:1]
    data = _write_csv(tmp_path / 'test.csv', inv[:3] + out + inv[3:6])
    cfg = dict(vocab_=profile_train.VOCAB, output_model=profile_train.CKPT,
               test_data=data)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    argv = ['--path-to-config', str(tmp_path / 'cfg.json'), '--model-type',
            'prop-opt', '--batch-size', '3']
    jax_dump_latents.main(argv + ['--output', str(tmp_path / 'jax.npy')])
    z = dump_latents.main(argv + ['--output', str(tmp_path / 'port.npy'),
                                  '--device', 'cpu'])
    want = np.load(tmp_path / 'jax.npy')
    assert want.shape == (6, 24)
    np.testing.assert_array_equal(np.load(tmp_path / 'port.npy'), z)
    np.testing.assert_allclose(z, want, rtol=0, atol=ATOL)
    assert (tmp_path / 'port.npy.smiles.txt').read_text() == \
        (tmp_path / 'jax.npy.smiles.txt').read_text()


def test_vae_test_cli_matches_jax(motif_data, tmp_path, capsys,
                                  monkeypatch):
    """``vae_test --model-type prop`` for one epoch from the same params
    (the port's init, which the JAX ``Trainer.init`` is made to return)
    and without latent noise in either package (the same ε, zero): it
    prints the JAX package's ``org … dec …`` pairs."""
    (tmp_path / 'vocab.txt').write_text(
        ''.join(f'{a} {b}\n' for a, b in motif_data['pairs']))
    data = _write_csv(tmp_path / 'data.csv', motif_data['rows'][:2 * BATCH])
    test = _write_csv(tmp_path / 'test.csv',
                      motif_data['rows'][2 * BATCH:3 * BATCH])
    cfg = dict(vocab_=str(tmp_path / 'vocab.txt'), data=data, test_data=test,
               batch_size=BATCH, epoch=1, print_iter=50, seed=2, dropout=0.0,
               **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    argv = ['--path-to-config', str(tmp_path / 'cfg.json'), '--model-type',
            'prop', '--recon-count', str(BATCH)]
    model, _, _ = setup_model(Configs(args=cfg), 'prop', seed=2)
    start = jax.tree.map(jnp.asarray, to_flax_tree(model))
    monkeypatch.setattr(jax_loop, 'make_train_step', functools.partial(
        jax_loop.make_train_step, perturb_z=False))
    monkeypatch.setattr(jax_loop, 'make_scan_train_step', functools.partial(
        jax_loop.make_scan_train_step, perturb_z=False))
    monkeypatch.setattr(jax_loop.Trainer, 'init', lambda self, b: (
        start, self.optimizer.init(start)))
    monkeypatch.setattr(vae_test, 'Trainer', functools.partial(
        Trainer, perturb_z=False))
    jax_mg.MolGraph.FRAGMENTS = set()

    def pairs():
        return [line for line in capsys.readouterr().out.splitlines()
                if line.startswith('org ')]
    jax_vae_test.main(argv)
    want = pairs()
    vae_test.main(argv + ['--device', 'cpu'])
    got = pairs()
    assert len(want) == BATCH and got == want


# -- the full-width references of chip_smoke.py phase 13 --------------------

def jax_train_reference(hier: bool = False):
    """The JAX package's first 3 steps of ``profile_train.
    attention_trainer``'s configuration on the first three HOPV batches
    of 20 (the motif family's lane-packed, the hier family's unpacked), at
    dropout 0 with the latent's mean: prop-opt with the attention heads
    from the trained checkpoint, one Adam a group at
    ``FINETUNE_LRS``; or, with ``hier``, hier-prop from the trained hier
    checkpoint with ``OPTIMIZER``.  Recorded as the other training
    goldens are (per-step metrics, per leaf the update along the gradient
    and the gradient's norm, each group's norm for prop-opt), but the
    gradients are taken before the step, not read from Adam's first
    moment: the clip binds at these steps."""
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        jvocab, _ = jax_load_vocab(HIER_VOCAB if hier else
                                   profile_train.VOCAB)
        model, vocab = profile_train.attention_model(hier)
        rows = profile_train.hopv_rows(vocab)
        batches = []
        for i in range(profile_train.GOLDEN_STEPS):
            b = jax_batching.to_model_batch(jax_batching.pad_batch(
                jax_mg.tensorize(rows[20 * i:20 * i + 20], jvocab,
                                 jax_avocab)), jvocab.mask, pad=False)
            if not hier:
                b = dict(b, plan=jax_batching.compact_plan_dict(
                    {k: np.asarray(v) for k, v in b['plan'].items()}))
            batches.append(b)
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = jvocab.size()
    params = to_flax_tree(model)
    opt_kw = {k: v for k, v in profile_train.OPTIMIZER.items() if k != 'lr'}
    if hier:
        jmodel = JaxHierPropertyVAE(cfg=JaxModelConfig(
            hvocab_size=hv, ivocab_size=iv, use_attention=True,
            **HIER_TRAINED))
        tx = jax_make_optimizer(**profile_train.OPTIMIZER)
    else:
        jmodel = JaxPropOptVAE(cfg=JaxModelConfig(
            hvocab_size=hv, ivocab_size=iv, use_attention=True, **TRAINED))
        tx = jax_multi(jax_group_fn, profile_train.FINETUNE_LRS, **opt_kw)
    step = make_train_step(jmodel, tx, beta=profile_train.BETA,
                           perturb_z=False)
    # the gradients before clipping (the random heads' make the decoder
    # group's exceed the clip), as the port records them
    grad_fn = jax.jit(jax.grad(lambda q, b: jmodel.apply(
        q, b, profile_train.BETA, None, False, True)[0]))
    p = jax.tree.map(jnp.asarray, params)
    st = tx.init(p)
    rng = jax.random.PRNGKey(0)
    steps = []
    for i, b in enumerate(batches):
        b = jax.tree.map(jnp.asarray, b)
        grad = flatten(jax.tree.map(np.array, grad_fn(p, b)))
        before = flatten(jax.tree.map(np.array, p))
        p, st, metrics, _, rng = step(p, st, b, rng, float(i))
        after = flatten(jax.tree.map(np.array, p))
        steps.append(dict(
            {k: float(v) for k, v in sorted(metrics.items())},
            update_norms=profile_train.update_norms(before, after, grad),
            grad_norms={k: float(np.linalg.norm(v))
                        for k, v in grad.items()}))
        if not hier:
            groups = {}
            for k, v in grad.items():
                g = jax_group_fn(k)
                groups[g] = groups.get(g, 0.0) + float(
                    (v.astype(np.float64) ** 2).sum())
            steps[-1]['group_norms'] = {g: float(np.sqrt(v))
                                        for g, v in sorted(groups.items())}
    out = dict(checkpoint='runs/QUALITY_hier_hopv.json.ckpt' if hier else
               'runs/QUALITY_hopv.json.ckpt (full prop-opt tree)',
               vocab='runs/QUALITY_hier_hopv.json.vocab.txt' if hier else
               'runs/QUALITY_hopv.json.vocab.txt', data='data/hopv15.csv',
               batch_size=20, model='hier-prop' if hier else 'prop-opt',
               use_attention=True, heads_seed=profile_train.HEADS_SEED,
               beta=profile_train.BETA, steps=steps)
    if hier:
        out.update(optimizer=profile_train.OPTIMIZER)
    else:
        out.update(lrs=profile_train.FINETUNE_LRS, optimizer=opt_kw)
    return out


TRAIN_GOLDENS = {False: 'train_propopt_att_hopv.json',
                 True: 'train_hier_att_hopv.json'}


def _train_golden(hier):
    with open(GOLDENS[TRAIN_GOLDENS[hier]]) as f:
        return json.load(f)


def _rule(hier):
    return (profile_train.hier_rule() if hier else dict(
        later_update_rtol=profile_train.FINETUNE_LATER_UPDATE_RTOL))


@pytest.mark.slow
@pytest.mark.parametrize('hier', [False, True], ids=['prop-opt', 'hier-prop'])
def test_train_golden_is_the_jax_reference(hier):
    """The committed training goldens are what the JAX package computes
    now (about a minute for prop-opt and three for hier-prop on the CPU:
    hence ``slow``)."""
    got, want = _train_golden(hier), jax_train_reference(hier)
    assert {k: v for k, v in got.items() if k != 'steps'} == json.loads(
        json.dumps({k: v for k, v in want.items() if k != 'steps'}))
    for g, w in zip(got['steps'], want['steps']):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, dict):
                for leaf, x in v.items():
                    assert g[k][leaf] == pytest.approx(x, rel=1e-5, abs=1e-9)
            else:
                assert g[k] == pytest.approx(v, rel=1e-5, abs=1e-12), k


def _cpu_steps(hier):
    trainer, vocab = profile_train.attention_trainer('cpu', hier)
    _, batches = profile_train.hopv_batches(profile_train.GOLDEN_STEPS, vocab)
    return profile_train.golden_steps('cpu', trainer, batches)


def test_port_on_the_cpu_meets_the_propopt_att_golden():
    """chip_smoke.py phase 13's prop-opt attention steps on the CPU: the
    port's 3 steps at full width held to the golden by its rule."""
    assert profile_train.check_golden(_cpu_steps(False), _train_golden(False),
                                      **_rule(False)) == []


@pytest.mark.slow
def test_port_on_the_cpu_meets_the_hier_att_golden():
    """The same for hier-prop with attention (about 40 s a step on one
    thread: hence ``slow``)."""
    assert profile_train.check_golden(_cpu_steps(True), _train_golden(True),
                                      **_rule(True)) == []


if __name__ == '__main__':
    for hier in (False, True):
        with open(GOLDENS[TRAIN_GOLDENS[hier]], 'w') as f:
            json.dump(jax_train_reference(hier), f, indent=1)
            f.write('\n')
    with open(GOLDENS['decode_att_hopv16.json'], 'w') as f:
        json.dump(jax_decode_reference(), f, indent=1)
        f.write('\n')
