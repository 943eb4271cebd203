"""The port's decode path against the JAX package's, on the CPU, and the
JAX reference answers that chip_smoke.py holds the card's decoding to.

The JAX functions are called directly (the JAX ``models/api`` and server
tests fail where their reference data are absent, so they are no oracle).
Small width (hidden 16) with random params through the bridge: every decode
step within 1e-5.  Full width on the trained HOPV checkpoint: the same
SMILES, and the same per-step logs from the same latents (the JAX
encoder's), with topology probabilities within 1e-5 and log-probability
scores within 1e-5 relative (scores reach magnitude 20 and more, where
products of width 250 summed in another order differ by a few ulps).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_decode.py

rewrites ``ggpm_tpu_torch/goldens/decode_hopv64.json`` from the JAX package.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.chem import valid_fast as jax_valid_fast
from ggpm_tpu.cli.common import read_csv_data as jax_read_csv
from ggpm_tpu.data.batching import to_model_batch as jax_to_model_batch
from ggpm_tpu.data.dataset import prune_to_vocab as jax_prune
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu.models import inc_graph as jax_inc
from ggpm_tpu.models.api import encode as jax_encode
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropOptVAE as JaxPropOptVAE
from ggpm_tpu_torch.bridge import load_flax_params, load_model, read_checkpoint
from ggpm_tpu_torch.chem import get_mol, valid_fast
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import PairVocab, common_atom_vocab
from ggpm_tpu_torch.models import decode, inc_graph
from ggpm_tpu_torch.models.api import reconstruct
from ggpm_tpu_torch.models.vae import ModelConfig, PropOptVAE
from ggpm_tpu_torch.serve import GgpmServer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens', 'decode_hopv64.json')
SMALL = dict(embed_size=16, hidden_size=16, latent_size=8,
             linear_hidden_size=8, depthT=3)
ATOL = 1e-5
N_FULL = 16
GOLDEN_MOLS = 64
GOLDEN_SAMPLE = {'n': 64, 'seed': 0}
MAX_DECODE_STEP = 150


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=0, atol=atol)


@pytest.fixture(scope='module')
def jax_fragments():
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


# -- hier_topk ---------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_hier_topk_matches_jax_with_ties(seed):
    """Exact indices, planted ties included: equal motif scores, equal
    attachment scores, and motifs whose masks allow the same attachments
    (equal joint scores)."""
    rng = np.random.default_rng(seed)
    b, hv, iv, k = 6, 11, 17, 5
    cls = rng.normal(size=(b, hv)).astype(np.float32)
    icls = rng.normal(size=(b, iv)).astype(np.float32)
    cls[:, 3] = cls[:, 7] = cls[:, 1]
    icls[:, 5] = icls[:, 9] = icls[:, 2]
    cls[0] = 0.0                              # one row of all-equal scores
    mask = np.where(rng.random((hv, iv)) < 0.5, 0.0, -1000.0).astype(np.float32)
    mask[:, 0] = 0.0
    mask[7] = mask[3] = mask[1]
    theirs = jax_decode.hier_topk(jnp.asarray(cls), jnp.asarray(icls),
                                  jnp.asarray(mask), k)
    ours = decode.hier_topk(torch.from_numpy(cls), torch.from_numpy(icls),
                            torch.from_numpy(mask), k)
    _close(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))


def test_topk_small_breaks_ties_to_the_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    vals, idx = decode._topk_small(x, 4)
    assert idx.tolist() == [[1, 2, 4, 0]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0]]


# -- the decode steps at small width ------------------------------------------

@pytest.fixture(scope='module')
def small(jax_fragments, golden_smiles):
    """A small JAX PropOptVAE over the golden molecules with noise on every
    param leaf, the port model with the same params, and one step's worth
    of inputs: a state with row 0 zero, B = 5 lanes of which lane 3 is
    invalid, neighbour tables with padding."""
    jax_mg.MolGraph.FRAGMENTS = set()
    labels = set()
    for s in golden_smiles:
        for _, d in jax_mg.MolGraph(s).mol_tree.nodes(data=True):
            labels.add(d['label'])
            for _, anc in d['inter_label']:
                labels.add((d['smiles'], anc))
    pairs = sorted(labels)
    jvocab, vocab = JaxPairVocab(pairs), PairVocab(pairs)
    rows = [[s, None, None] for s in golden_smiles[:4]]
    jbatch = jax_to_model_batch(jax_mg.tensorize(rows, jvocab, jax_avocab),
                                jvocab.mask, pad=False)
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
    load_flax_params(model, params)
    b, n_rows, a, h = 5, 40, 12, SMALL['hidden_size']
    state = [rng.normal(0, 0.5, (n_rows, h)).astype(np.float32)
             for _ in range(2)]
    for s in state:
        s[0] = 0.0

    def table(shape):
        t = rng.integers(0, n_rows, shape).astype(np.int32)
        t[rng.random(shape) < 0.4] = 0
        return t
    inputs = dict(
        state=state, rows=np.array([31, 32, 33, 0, 35], np.int32),
        src_clab=rng.integers(0, hv, b).astype(np.int32),
        pos=np.array([0, 3, 19, 25, 7], np.int32),
        bgraph_rows=table((b, a)), agraph_rows=table((b, a)),
        v_clab=rng.integers(0, hv, b).astype(np.int32),
        root_vecs=rng.normal(size=(b, SMALL['latent_size'])).astype(np.float32),
        can_expand=np.array([True, True, False, True, True]),
        bt_valid=np.array([True, False, True, False, True]),
        bt_pos=np.array([1, 0, 4, 0, 2], np.int32), bt_bg=table((b, a)),
        mask=vocab.mask)
    return dict(jmodel=jmodel, params=params, model=model.eval(), x=inputs)


def _jax_dec(small, name, *args):
    return small['jmodel'].apply(
        small['params'], *args,
        method=lambda m, *a: getattr(m._decoder(), name)(*a))


def _torch_args(x, keys):
    return [tuple(torch.from_numpy(s.copy()) for s in x[k]) if k == 'state'
            else torch.from_numpy(np.array(x[k])) for k in keys]


def _jax_args(x, keys):
    return [tuple(jnp.asarray(s) for s in x[k]) if k == 'state'
            else jnp.asarray(x[k]) for k in keys]


def _step(small, name, keys, extra=()):
    x = small['x']
    theirs = _jax_dec(small, name, *_jax_args(x, keys), *extra)
    with torch.inference_mode():
        ours = getattr(small['model']._decoder(), name)(
            *_torch_args(x, keys), *extra)
    return ours, theirs


def test_dec_init_state_small(small):
    x = small['x']
    theirs = _jax_dec(small, 'dec_init_state', 40, jnp.asarray(x['root_vecs']))
    with torch.inference_mode():
        ours = small['model']._decoder().dec_init_state(
            40, torch.from_numpy(x['root_vecs']))
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_dec_update_small(small):
    ours, theirs = _step(small, 'dec_update',
                         ('state', 'rows', 'src_clab', 'pos', 'bgraph_rows'))
    for o, t in zip(ours, theirs):
        _close(o, t)
    assert not ours[0][0].any() and not ours[1][0].any()


def test_dec_topo_small(small):
    ours, theirs = _step(small, 'dec_topo',
                         ('state', 'v_clab', 'agraph_rows', 'root_vecs'))
    _close(ours, theirs)


def test_dec_cls_small(small):
    ours, theirs = _step(small, 'dec_cls', ('state', 'rows', 'root_vecs'))
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_dec_root_cls_small(small):
    ours, theirs = _step(small, 'dec_root_cls', ('root_vecs',))
    for o, t in zip(ours, theirs):
        _close(o, t)


@pytest.mark.parametrize('u', [0.5, 'random'])
def test_dec_step_fused_small(small, u):
    """The packed output (topo logit, choice, beam scores, motif and
    attachment ids) and the new state; ids and choices exactly."""
    x = dict(small['x'])
    b = len(x['rows'])
    x['u'] = (np.full(b, 0.5, np.float32) if u == 0.5 else
              np.random.default_rng(3).random(b).astype(np.float32))
    x['new_rows'] = np.array([31, 32, 33, 34, 35], np.int32)
    keys = ('state', 'v_clab', 'agraph_rows', 'can_expand', 'u', 'new_rows',
            'v_clab', 'agraph_rows', 'bt_valid', 'v_clab', 'bt_pos', 'bt_bg',
            'root_vecs', 'mask')
    small = dict(small, x=x)
    (state, packed), (jstate, jpacked) = _step(small, 'dec_step_fused', keys,
                                               (5,))
    packed, jpacked = packed.numpy(), np.asarray(jpacked)
    _close(packed[:, 0], jpacked[:, 0])
    np.testing.assert_array_equal(packed[:, 1], jpacked[:, 1])
    _close(packed[:, 2:7], jpacked[:, 2:7])
    np.testing.assert_array_equal(packed[:, 7:], jpacked[:, 7:])
    for o, t in zip(state, jstate):
        _close(o, t)


# -- incremental trees and graphs --------------------------------------------

def _tree_record(mod):
    """A decode-shaped sequence of tree edits: super root, two roots, an
    expand, a reserved-row expand, a backtrack."""
    tree = mod.IncTree(2, max_nodes=10, max_edges=12)
    sup = tree.add_node()
    roots = [tree.add_node((3, 7)), tree.add_node((1, 2))]
    for r in roots:
        tree.add_edge(sup, r)
        tree.register_cgraph(r, [1, 2, 3], [1, 2], [1])
    child = tree.add_node()
    tree.add_edge(roots[0], child, (roots[0], child, 0))
    first = tree.reserve_edges(2)
    other = tree.add_node((5, 9))
    tree.add_edge(roots[1], other, (roots[1], other, 0), row=first + 1)
    tree.add_edge(child, roots[0], (child, roots[0], tree.in_degree(roots[0])))
    tree.update_attached(roots[0], [(1, 0), (2, 1)])
    return dict(fnode=tree.fnode, fmess=tree.fmess, agraph=tree.agraph,
                bgraph=tree.bgraph, cgraph=tree.cgraph,
                edges=sorted(tree.edge_dict.items()),
                cluster=tree.get_cluster(roots[0]),
                can_expand=[tree.can_expand(i) for i in range(tree.n_nodes)])


def test_inc_tree_matches_jax():
    ours, theirs = _tree_record(inc_graph), _tree_record(jax_inc)
    assert ours.keys() == theirs.keys()
    for k in ours:
        if isinstance(ours[k], np.ndarray):
            np.testing.assert_array_equal(ours[k], theirs[k])
        else:
            assert ours[k] == theirs[k], k


def test_inc_graph_assembly_matches_jax():
    """The JAX package's ``test_inc_graph_assembly`` scenario on both."""
    out = []
    for mod, avocab in ((inc_graph, common_atom_vocab),
                        (jax_inc, jax_avocab)):
        g = mod.IncGraph(avocab, batch_size=1, max_nodes=50, max_edges=80)
        added = g.add_mol(0, 'C1=CC=CC=C1', [], 0)
        out.append((added, g.get_smiles(), bool(g.try_add_mol(0, 'C', [])),
                    g.agraph.copy(), g.bgraph.copy(), g.fmess.copy()))
    assert out[0][:3] == out[1][:3]
    for o, t in zip(out[0][3:], out[1][3:]):
        np.testing.assert_array_equal(o, t)


# root motif, then motifs attached one after the other, from the HOPV vocab
# (two-anchor, one-anchor and ring-fused attachments)
CHAINS = [
    ['C=1C=[CH:1]C=[CH:2]C=1', '[CH3:1]C=1C=[CH:2]SC=1',
     'C1=[CH:2]SC2=[CH:1]S[CH:2]=C12'],
    ['C=1C=[CH:1][CH:1]=[CH:2]C=1', 'C=1C=[CH:2][NH:1][CH:2]=1',
     '[CH3:2]C=[CH:1][CH3:2]'],
    ['CN1C2=CC=[CH:1]C=C2C2=C[CH:2]=CC=C21', 'C=1[CH:1]=CS[CH:2]=1',
     'C=1C=C[CH2:1][CH2:1]C=1'],
]


def _assemble(mod, avocab, chain):
    """Grow one molecule along ``chain`` as the decoder does: candidates
    on the last motif's atoms, the first that passes the validity check is
    grafted.  Returns every intermediate answer."""
    g = mod.IncGraph(avocab, batch_size=1, max_nodes=60, max_edges=120)
    atoms, _, attached = g.add_mol(0, chain[0], [], 0)
    record = [(atoms, attached)]
    used = []
    for nth, ismiles in enumerate(chain[1:], start=1):
        cands, anchors, points = g.get_assm_cands(atoms, used, ismiles)
        record.append((cands, anchors, points))
        for cand in cands:
            pairs = list(zip(cand, points))
            ok = bool(g.try_add_mol(0, ismiles, pairs))
            record.append((cand, ok))
            if ok:
                atoms, _, attached = g.add_mol(0, ismiles, pairs, nth)
                used.extend(x for x, _ in pairs)
                record.append((atoms, attached))
                break
    record.append(g.get_smiles())
    return record, g


@pytest.mark.parametrize('chain', CHAINS, ids=lambda c: c[0])
def test_inc_graph_chain_matches_jax(chain):
    ours, g = _assemble(inc_graph, common_atom_vocab, chain)
    theirs, jg = _assemble(jax_inc, jax_avocab, chain)
    assert ours == theirs
    assert ours[-1][0] is not None
    for name in ('fnode', 'fmess', 'agraph', 'bgraph'):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name))


@pytest.mark.parametrize('smiles', ['c1ccccc1', 'C1=CC=CC=C1C(=O)O',
                                    'CC(C)(C)(C)C', 'c1cccc1'])
def test_valid_fast_matches_jax(smiles):
    from ggpm_tpu.chem import get_mol as jax_get_mol
    ours, theirs = get_mol(smiles), jax_get_mol(smiles)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert valid_fast(ours) == jax_valid_fast(theirs)


# -- full width, the trained HOPV checkpoint ----------------------------------

def _jax_trained():
    """The JAX model, params and vocab of the trained checkpoint (the vocab
    loader sets the class-level fragment set)."""
    vocab, _ = jax_load_vocab(VOCAB)
    hv, iv = vocab.size()
    model = JaxPropOptVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, rnn_type='LSTM', hidden_size=250,
        embed_size=250, latent_size=24, linear_hidden_size=128, depthT=20,
        dropout=0.0))
    return model, read_checkpoint(CKPT), vocab


def _jax_latents(model, params, vocab, rows):
    batch = jax.tree.map(jnp.asarray, jax_to_model_batch(
        jax_mg.tensorize(rows, vocab, jax_avocab), vocab.mask, pad=False))
    return np.asarray(jax_encode(model, params, batch)[0])


def jax_reference():
    """The JAX package's answers to chip_smoke.py's decoding requests:
    ``decode_best`` on the CPU of the JAX encoder's latents of the first 64
    in-vocab HOPV molecules, and of 64 prior samples at seed 0."""
    model, params, vocab = _jax_trained()
    rows = jax_prune(jax_read_csv(DATA), vocab, verbose=False)[:GOLDEN_MOLS]
    z = _jax_latents(model, params, vocab, rows)
    _, rec = jax_decode.decode_best(model, params, vocab, jax_avocab, z,
                                    greedy=True,
                                    max_decode_step=MAX_DECODE_STEP)
    _, sam = jax_decode.sample_prior(
        model, params, vocab, jax_avocab, GOLDEN_SAMPLE['n'],
        rng=np.random.default_rng(GOLDEN_SAMPLE['seed']),
        max_decode_step=MAX_DECODE_STEP)
    return dict(inputs=[r[0] for r in rows], sample_request=GOLDEN_SAMPLE,
                max_decode_step=MAX_DECODE_STEP, reconstruct=rec, sample=sam)


@pytest.fixture(scope='module')
def trained(jax_fragments):
    jmodel, params, jvocab = _jax_trained()
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:N_FULL]
    z = _jax_latents(jmodel, params, jvocab, rows)
    return dict(jmodel=jmodel, params=params, jvocab=jvocab, model=model,
                vocab=vocab, rows=rows, z=z)


def _close_logs(ours, theirs):
    """Per-step logs equal: probabilities within ATOL, scores within ATOL
    relative (module docstring)."""
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


def test_decode_motif_full_width(trained):
    t = trained
    jres, jsmiles = jax_decode.decode_motif(
        t['jmodel'], t['params'], t['jvocab'], jax_avocab, t['z'],
        greedy=True, max_decode_step=MAX_DECODE_STEP, log_steps=True)
    res, smiles = decode.decode_motif(t['model'], t['vocab'],
                                      common_atom_vocab, t['z'], greedy=True,
                                      max_decode_step=MAX_DECODE_STEP,
                                      log_steps=True)
    assert smiles == jsmiles
    assert all(s is not None for s in smiles)
    _close_logs(res, jres)


def test_sample_prior_full_width(trained):
    t = trained
    _, jsmiles = jax_decode.sample_prior(
        t['jmodel'], t['params'], t['jvocab'], jax_avocab, N_FULL,
        rng=np.random.default_rng(0), max_decode_step=MAX_DECODE_STEP)
    _, smiles = decode.sample_prior(t['model'], t['vocab'], common_atom_vocab,
                                    N_FULL, rng=np.random.default_rng(0),
                                    max_decode_step=MAX_DECODE_STEP)
    assert smiles == jsmiles


def test_non_greedy_decode_full_width(trained):
    """Stochastic topology and beam order from the same numpy seed."""
    t = trained
    _, jsmiles = jax_decode.decode_motif(
        t['jmodel'], t['params'], t['jvocab'], jax_avocab, t['z'][:8],
        greedy=False, max_decode_step=MAX_DECODE_STEP, log_steps=False,
        rng=np.random.default_rng(5))
    _, smiles = decode.decode_motif(
        t['model'], t['vocab'], common_atom_vocab, t['z'][:8], greedy=False,
        max_decode_step=MAX_DECODE_STEP, log_steps=False,
        rng=np.random.default_rng(5))
    assert smiles == jsmiles


def _hier_routes(trained, monkeypatch):
    """``decode_best`` of a hier model, greedy or not, with or without
    logs, with the motif paths refusing it: for each call that reached a
    hier path, the path (``decode_hier_turbo`` or ``decode_hier``) and its
    keyword arguments."""
    class HierPropOptVAE:
        pass
    calls = []

    def refuse(*a, **kw):
        raise AssertionError('a motif path took a hier model')

    def record(path):
        return lambda *a, **kw: calls.append((path, kw)) or ([], [])
    monkeypatch.setattr(decode, 'decode_motif', refuse)
    monkeypatch.setattr(decode, 'decode_motif_turbo', refuse)
    monkeypatch.setattr(decode, 'decode_hier', record('decode_hier'))
    monkeypatch.setattr(decode, 'decode_hier_turbo',
                        record('decode_hier_turbo'))
    for greedy, logs in ((True, False), (True, True), (False, False)):
        decode.decode_best(HierPropOptVAE(), trained['vocab'],
                           common_atom_vocab, trained['z'], greedy=greedy,
                           log_steps=logs, chunk=8)
    return calls


def test_decode_best_refuses_the_hier_family(trained, monkeypatch):
    """``decode_best`` refuses the motif paths to a hier model: none of
    its calls reaches ``decode_motif`` or ``decode_motif_turbo`` (the hier
    family's own decode is held by tests/test_torch_hier*.py)."""
    assert len(_hier_routes(trained, monkeypatch)) == 3


def test_decode_best_routes_the_hier_family_to_decode_hier(trained,
                                                           monkeypatch):
    """A hier model's greedy decode without logs goes to the hier turbo
    path, with the turbo path's ``chunk``, as the JAX package's
    ``decode_best`` sends it; a decode with logs, or a sampled one, to the
    exact hier path, without ``chunk``."""
    calls = _hier_routes(trained, monkeypatch)
    assert [(path, kw.get('greedy'), kw.get('log_steps', False))
            for path, kw in calls] == [
        ('decode_hier_turbo', True, False), ('decode_hier', True, True),
        ('decode_hier', False, False)]
    assert calls[0][1]['chunk'] == 8
    assert not any('chunk' in kw for _, kw in calls[1:])


@pytest.fixture(scope='module')
def server(trained):
    srv = GgpmServer(trained['model'], trained['vocab'], device='cpu')
    port = srv.start(port=0).server_address[1]
    yield port
    srv.stop()


def _post(port, path, payload):
    import urllib.request
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_reconstruct_endpoint_matches_jax(trained, server):
    t = trained
    _, jsmiles = jax_decode.decode_best(
        t['jmodel'], t['params'], t['jvocab'], jax_avocab, t['z'][:4],
        greedy=True, max_decode_step=MAX_DECODE_STEP)
    out = _post(server, '/reconstruct',
                {'smiles': [r[0] for r in t['rows'][:4]]})
    assert out == {'smiles': jsmiles}


def test_sample_endpoint_matches_jax(trained, server):
    t = trained
    _, jsmiles = jax_decode.sample_prior(
        t['jmodel'], t['params'], t['jvocab'], jax_avocab, 4,
        rng=np.random.default_rng(3), max_decode_step=MAX_DECODE_STEP)
    assert _post(server, '/sample', {'n': 4, 'seed': 3}) == {'smiles': jsmiles}


def test_sample_endpoint_defaults_as_the_reference(trained, server):
    """No ``n`` and no ``seed``: 8 samples at seed 0, as the JAX server."""
    t = trained
    _, jsmiles = jax_decode.sample_prior(
        t['jmodel'], t['params'], t['jvocab'], jax_avocab, 8,
        rng=np.random.default_rng(0), max_decode_step=MAX_DECODE_STEP)
    assert _post(server, '/sample', {}) == {'smiles': jsmiles}


def test_chip_smoke_decode_reference(jax_fragments):
    """The committed reference is the JAX package's answer; the port on
    the CPU gives the same."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden == jax_reference()
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), vocab,
                          verbose=False)[:GOLDEN_MOLS]
    assert [r[0] for r in rows] == golden['inputs']
    mb = tensorize(rows, vocab, common_atom_vocab)
    _, (_, rec) = reconstruct(model, mb, vocab,
                              max_decode_step=MAX_DECODE_STEP)
    assert rec == golden['reconstruct']
    _, sam = decode.sample_prior(
        model, vocab, common_atom_vocab, GOLDEN_SAMPLE['n'],
        rng=np.random.default_rng(GOLDEN_SAMPLE['seed']),
        max_decode_step=MAX_DECODE_STEP)
    assert sam == golden['sample']


if __name__ == '__main__':
    with open(GOLDEN, 'w') as f:
        json.dump(jax_reference(), f, indent=1)
        f.write('\n')
