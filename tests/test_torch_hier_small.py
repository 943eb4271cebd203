"""The port's hier family at small width against the JAX package's, on
the CPU: ``HierMPNEncoder`` level by level, every decode step of
``HierDecoder`` and its assembly scores, the whole ``decode_hier`` loop,
and ``HierPropOptVAE``'s ``/properties`` and ``/optimize`` behind the
server (``tests/test_torch_hier.py`` holds the trained checkpoint at full
width).

The model: hidden 16, depths 3, diterG 3, over the trained hier vocab,
with random params (flax's initialisers, perturbed) laid out as a flax
tree for the JAX model and bridged into the port's.  Every encoder level
and readout, every decode step and the assembly scores within 1e-5; the
decode's per-step logs and SMILES equal; ``/properties`` within 1e-5 and
``/optimize`` (soft, patience and hard) equal to JAX's search, its
predictions within 1e-5, as ``tests/test_torch_latent.py`` holds the motif
family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.latent.control import LatentOptimizer as JaxLatentOptimizer
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu.models.api import encode as jax_encode
from ggpm_tpu.models.vae import HierPropertyVAE as JaxHierPropertyVAE
from ggpm_tpu.models.vae import HierPropOptVAE as JaxHierPropOptVAE
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu_torch import kernel_bench
from ggpm_tpu_torch.bridge import load_flax_params, to_flax_tree
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file
from ggpm_tpu_torch.models import api, decode, encoder, hier_decoder, rnn
from ggpm_tpu_torch.models.api import tree_to_device
from ggpm_tpu_torch.models.hier_decoder import scatter_rows_
from ggpm_tpu_torch.models.vae import (HierPropertyVAE, HierPropOptVAE,
                                       ModelConfig, init_params)
from ggpm_tpu_torch.ops import gather_rows, nei_sum
from ggpm_tpu_torch.serve import GgpmServer
from test_torch_hier import DATA, VOCAB, close_logs, jax_batch

SMALL = dict(embed_size=16, hidden_size=16, latent_size=8,
             linear_hidden_size=8, depthT=3, depthG=3, diterT=1, diterG=3)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def jax_fragments():
    from ggpm_tpu.graph import mol_graph as jax_mg
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=0, atol=atol)


def _small_params(cls, cfg, seed):
    """Flax-layout params of ``cls(cfg)`` from flax's initialisers,
    perturbed on every leaf, and the port model bridged from them."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (x + rng.normal(0, 0.1, x.shape)).astype(np.float32),
        to_flax_tree(init_params(cls(cfg), torch.Generator().manual_seed(
            seed))))
    model = cls(cfg)
    load_flax_params(model, params)
    return params, model.eval()


# -- the small model ---------------------------------------------------------

@pytest.fixture(scope='module')
def small(jax_fragments):
    """A small HierPropertyVAE over the trained vocab, initialised as flax
    initialises it (``init_params``) and perturbed on every leaf, laid out
    as a flax tree for the JAX model and bridged back into the port model,
    8 HOPV molecules as a model batch on both sides, and one step's worth
    of decode inputs: a state with row 0 zero, B = 5 lanes of which lane 3
    is invalid, index tables with padding."""
    jvocab, _ = jax_load_vocab(VOCAB)
    vocab = load_vocab_file(VOCAB)
    hv, iv = vocab.size()
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:8]
    jbatch = jax_batch(rows, jvocab)
    jmodel = JaxHierPropertyVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, rnn_type='LSTM', dropout=0.0,
        **SMALL))
    params, model = _small_params(
        HierPropertyVAE, ModelConfig(hvocab_size=hv, ivocab_size=iv, **SMALL),
        0)
    rng = np.random.default_rng(1)
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)

    b, h, a, ga = 5, SMALL['hidden_size'], 12, 10
    n_tree, n_graph, n_gnodes, n_tnodes = 40, 60, 50, 30
    ke, kn = 6, 5

    def buf(n):
        x = rng.normal(0, 0.5, (n, h)).astype(np.float32)
        x[0] = 0.0
        return x

    def table(shape, n):
        t = rng.integers(1, n, shape).astype(np.int32)
        t[rng.random(shape) < 0.4] = 0
        return t

    def distinct(shape, n):
        """Rows of ``shape`` [B, K]: distinct ids of 1..n-1, padded by 0."""
        t = rng.permutation(np.arange(1, n))[:np.prod(shape)].reshape(shape)
        t = t.astype(np.int32)
        t[rng.random(shape) < 0.3] = 0
        return t

    state = ((buf(n_tree), buf(n_tree)), (buf(n_tree), buf(n_tree)),
             (buf(n_graph), buf(n_graph)), buf(n_gnodes), buf(n_tnodes))
    g_rows = distinct((b, ke), n_graph)
    g_rows[3] = 0
    g_nodes = distinct((b, kn), n_gnodes)
    g_nodes[3] = 0
    x = dict(
        state=state, g_rows=g_rows,
        g_src_av=rng.integers(0, 38, (b, ke)).astype(np.int32),
        g_bt=rng.integers(0, 5, (b, ke)).astype(np.int32),
        g_nth=rng.integers(0, 25, (b, ke)).astype(np.int32),
        g_bg_rows=table((b, ke, ga), n_graph), g_nodes=g_nodes,
        g_node_av=rng.integers(0, 38, (b, kn)).astype(np.int32),
        g_ag_rows=table((b, kn, ga), n_graph),
        v_nodes=np.array([3, 7, 11, 0, 20], np.int32),
        v_clab=rng.integers(0, hv, b).astype(np.int32),
        v_ilab=rng.integers(0, iv, b).astype(np.int32),
        v_cgraph=table((b, kn), n_gnodes), v_ag_rows=table((b, a), n_tree),
        rows=np.array([31, 32, 33, 0, 35], np.int32),
        src_nodes=np.array([3, 7, 11, 0, 20], np.int32),
        pos=np.array([0, 3, 19, 25, 7], np.int32),
        bg_rows=table((b, a), n_tree),
        can_expand=np.array([True, True, False, True, True]),
        new_rows=np.array([31, 32, 33, 34, 35], np.int32),
        bt_valid=np.array([True, False, True, False, True]),
        bt_pos=np.array([1, 0, 4, 0, 2], np.int32),
        bt_bg=table((b, a), n_tree),
        root_vecs=rng.normal(size=(b, SMALL['latent_size'])).astype(
            np.float32),
        mask=vocab.mask,
        cand=rng.integers(0, n_gnodes, (4, 7, 2)).astype(np.int32),
        icls=rng.integers(0, iv, (4, 2)).astype(np.int32),
        n_icls=np.array([1, 2, 2, 1], np.int32),
        nth=np.array([0, 3, 19, 30], np.int32),
        ctx=rng.normal(size=(4, SMALL['latent_size'])).astype(np.float32))
    return dict(jmodel=jmodel, params=params, model=model,
                vocab=vocab, jvocab=jvocab, rows=rows, batch=batch,
                jbatch=jbatch, x=x, sizes=(n_tree, n_graph, n_gnodes,
                                           n_tnodes))


def _jax_dec(small, name, *args):
    return small['jmodel'].apply(
        small['params'], *args,
        method=lambda m, *a: getattr(m._decoder(), name)(*a))


def _torch(v):
    if isinstance(v, tuple):
        return tuple(_torch(s) for s in v)
    return torch.from_numpy(np.array(v))


def _jax(v):
    if isinstance(v, tuple):
        return tuple(_jax(s) for s in v)
    return jnp.asarray(v)


def _flat(state):
    """The state's buffers in order, as numpy."""
    out = []
    for s in state:
        out.extend(_flat(s) if isinstance(s, tuple) else [np.asarray(s)])
    return out


def _step(small, name, keys, extra=()):
    x = small['x']
    theirs = _jax_dec(small, name, *[_jax(x[k]) for k in keys], *extra)
    with torch.inference_mode():
        ours = getattr(small['model']._decoder(), name)(
            *[_torch(x[k]) for k in keys], *extra)
    return ours, theirs


def test_hier_encoder_levels_small(small):
    """Every level's node readout (atoms, attachments, motifs) and the root
    readout; the cluster readout ``nei_sum(hatom, cgraph)`` too."""
    s = small
    jt, jg = s['jbatch']['tree'], s['jbatch']['graph']
    theirs = s['jmodel'].apply(s['params'], jt, jg,
                               method=lambda m, t, g: m.encoder(t, g))
    device = torch.device('cpu')
    tree = tree_to_device(s['batch']['tree'], device,
                          ('fnode', 'fmess', 'agraph', 'bgraph', 'scope',
                           'cgraph'))
    graph = tree_to_device(s['batch']['graph'], device)
    with torch.inference_mode():
        ours = s['model'].encoder(tree, graph)
    names = ('hroot', 'hnode', 'hinter', 'hatom')
    for name, o, t in zip(names, ours, theirs):
        assert o.shape == t.shape, name
        _close(o, t)
    assert not ours[3][0].any()            # cgraph's padding reads row 0
    _close(nei_sum(ours[3], tree['cgraph']),
           np.asarray(theirs[3])[np.asarray(jt['cgraph'])].sum(1))


def test_hier_latents_small(small):
    s = small
    theirs = jax_encode(s['jmodel'], s['params'], s['jbatch'])
    ours = api.encode(s['model'], s['batch'])
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_hdec_init_small(small):
    x = small['x']
    sizes = small['sizes']
    theirs = _jax_dec(small, 'hdec_init', *sizes, jnp.asarray(x['root_vecs']))
    with torch.inference_mode():
        ours = small['model']._decoder().hdec_init(
            *sizes, torch.from_numpy(x['root_vecs']))
    for o, t in zip(_flat(ours), _flat(theirs)):
        _close(o, t)


GRAPH_KEYS = ('state', 'g_rows', 'g_src_av', 'g_bt', 'g_nth', 'g_bg_rows',
              'g_nodes', 'g_node_av', 'g_ag_rows')
TOPO_KEYS = ('v_nodes', 'v_clab', 'v_ilab', 'v_cgraph', 'v_ag_rows')


def test_hdec_graph_update_small(small):
    ours, theirs = _step(small, 'hdec_graph_update', GRAPH_KEYS)
    for o, t in zip(_flat(ours), _flat(theirs)):
        _close(o, t)
    assert all(not b[0].any() for b in _flat(ours))


def test_hdec_topo_small(small):
    (state, logits), (jstate, jlogits) = _step(
        small, 'hdec_topo', ('state',) + TOPO_KEYS + ('root_vecs',))
    _close(logits, jlogits)
    for o, t in zip(_flat(state), _flat(jstate)):
        _close(o, t)


def test_hdec_mess_update_small(small):
    ours, theirs = _step(small, 'hdec_mess_update', (
        'state', 'rows', 'src_nodes', 'v_clab', 'v_ilab', 'v_cgraph', 'pos',
        'bg_rows', 'bt_bg'))
    for o, t in zip(_flat(ours), _flat(theirs)):
        _close(o, t)
    assert all(not b[0].any() for b in _flat(ours))


def test_hdec_cls_small(small):
    ours, theirs = _step(small, 'hdec_cls', ('state', 'rows', 'root_vecs'))
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_hdec_root_cls_small(small):
    x = small['x']
    theirs = small['jmodel'].apply(
        small['params'], jnp.asarray(x['root_vecs']),
        method=lambda m, v: tuple(
            f(jnp.concatenate([m._decoder().root_vecs_to_hidden(v), v], -1),
              True) for f in (m._decoder().clsNN, m._decoder().iclsNN)))
    with torch.inference_mode():
        ours = small['model']._decoder().hdec_root_cls(
            torch.from_numpy(x['root_vecs']))
    for o, t in zip(ours, theirs):
        _close(o, t)


@pytest.mark.parametrize('u', [0.5, 'random'])
def test_hdec_step_fused_small(small, u):
    """The packed output (topo logit, choice, beam scores, motif and
    attachment ids; ids and choices exactly) and the new state."""
    x = dict(small['x'])
    b = len(x['rows'])
    x['u'] = (np.full(b, 0.5, np.float32) if u == 0.5 else
              np.random.default_rng(3).random(b).astype(np.float32))
    keys = GRAPH_KEYS + TOPO_KEYS + (
        'can_expand', 'u', 'new_rows', 'v_ag_rows', 'bt_valid', 'bt_pos',
        'bt_bg', 'root_vecs', 'mask')
    (state, packed), (jstate, jpacked) = _step(
        dict(small, x=x), 'hdec_step_fused', keys, (5,))
    packed, jpacked = packed.numpy(), np.asarray(jpacked)
    _close(packed[:, 0], jpacked[:, 0])
    np.testing.assert_array_equal(packed[:, 1], jpacked[:, 1])
    _close(packed[:, 2:7], jpacked[:, 2:7])
    np.testing.assert_array_equal(packed[:, 7:], jpacked[:, 7:])
    for o, t in zip(_flat(state), _flat(jstate)):
        _close(o, t)


def test_hdec_assm_small(small):
    """One case as JAX's ``hdec_assm`` takes it, and the queued cases of a
    step batched as its ``assm_batch`` (a vmap) takes them."""
    x = small['x']
    keys = ('cand', 'icls', 'n_icls', 'nth', 'ctx')
    state = _torch(x['state'])
    jstate = _jax(x['state'])
    dec = small['model']._decoder()

    def one(c, ic, n, nt, cx):
        return small['jmodel'].apply(
            small['params'], jstate, c, ic, n, nt, cx,
            method=lambda m, *a: m._decoder().hdec_assm(*a))
    theirs = jax.vmap(one)(*[jnp.asarray(x[k]) for k in keys])
    with torch.inference_mode():
        ours = dec.hdec_assm(state, *[torch.from_numpy(x[k]) for k in keys])
        single = dec.hdec_assm(state, *[torch.as_tensor(x[k][1])
                                        for k in keys])
    _close(ours, theirs)
    _close(single, one(*[jnp.asarray(x[k][1]) for k in keys]))


def test_duplicate_rows_must_agree():
    """On the card ``index_put_`` keeps one arbitrary writer of a row that
    appears twice, so the CPU refuses duplicates that disagree."""
    buf = torch.zeros(6, 3)
    rows = torch.tensor([2, 0, 2, 0, 4], dtype=torch.int32)
    vals = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    vals[1] = vals[3] = 0.0
    vals[2] = vals[0]
    scatter_rows_(buf, rows, vals)
    _close(buf[[2, 4]], vals[[0, 4]])
    vals[2] += 1.0
    with pytest.raises(AssertionError, match=r'values: \[2\]$'):
        scatter_rows_(buf, rows, vals)


@pytest.mark.parametrize('greedy', [True, False], ids=['greedy', 'sampled'])
def test_decode_hier_small(small, greedy):
    """The whole decode loop: per-step logs and SMILES, greedy (batched
    assembly scoring) and sampled (topology and beam order from the same
    numpy seed, candidates scored one case a call)."""
    s = small
    z = np.asarray(jax_encode(s['jmodel'], s['params'], s['jbatch'])[0])
    kw = dict(greedy=greedy, max_decode_step=40, log_steps=True)
    jres, jsmiles = jax_decode.decode_hier(
        s['jmodel'], s['params'], s['jvocab'], jax_avocab, z,
        rng=np.random.default_rng(7), **kw)
    res, smiles = decode.decode_hier(s['model'], s['vocab'],
                                     common_atom_vocab, z,
                                     rng=np.random.default_rng(7), **kw)
    assert smiles == jsmiles
    close_logs(res, jres)


def test_every_hier_kernel_call_has_its_site(small):
    """``kernel_bench.hier_sites`` puts each kernel call of an encode and
    of a decode at the site that made it: the five readouts once an
    encode, the atom level's gather depthG times and the tree levels'
    2·depthT times, each frontier sum once a step, and no call elsewhere;
    on the CPU no call launches a kernel."""
    s = small
    with kernel_bench.hier_sites() as enc:
        api.encode(s['model'], s['batch'])
    # prior latents: this model's decode of its encodes stops at step 1
    z = np.random.default_rng(3).standard_normal(
        (8, SMALL['latent_size'])).astype(np.float32)
    with kernel_bench.hier_sites() as dec:
        decode.decode_hier(s['model'], s['vocab'], common_atom_vocab, z,
                           max_decode_step=40)
    steps = decode.HIER_STATS['steps']
    assert steps > 5
    # (the turbo decode's propose sites, and its graph replays, unused)
    unused = {**{site: 0 for site in kernel_bench.HIER_PROPOSE_NAMES},
              'replay': 0}
    assert {k: v['calls'] for k, v in enc.items()} == {
        **{site: 1 for site, _ in kernel_bench.HIER_ENCODE_SITES},
        **{site: 0 for site, _ in kernel_bench.HIER_STEP_SITES},
        'atom-gather': SMALL['depthG'], 'tree-gather': 2 * SMALL['depthT'],
        None: 0, **unused}
    assert {k: v['calls'] for k, v in dec.items()} == {
        **{site: steps for site, _ in kernel_bench.HIER_STEP_SITES},
        **{site: 0 for site in kernel_bench.HIER_SITE_NAMES
           if site not in dict(kernel_bench.HIER_STEP_SITES)}, None: 0,
        **unused}
    assert not any(v['launches'] for v in (*enc.values(), *dec.values()))
    # the wrappers are put back
    assert (encoder.nei_sum, hier_decoder.nei_sum, rnn.gather_rows) == \
        (nei_sum, nei_sum, gather_rows)


def test_hier_cases_small(small):
    """``kernel_bench.hier_cases`` takes each site's inputs from its last
    call (this model's decode of its encodes stops at step 1): the
    encode's tables are the batch's."""
    s = small
    cases = {c['case']: c for c in kernel_bench.hier_cases(
        s['model'], s['vocab'], s['rows'], decode_rows=4, step=1)}
    assert list(cases) == [f'hier-{site}'
                           for site in kernel_bench.HIER_SITE_NAMES]
    tree, graph = s['batch']['tree'], s['batch']['graph']
    n_roots = tree['scope'].shape[0]
    h, a = SMALL['hidden_size'], tree['agraph'].shape[1]
    assert cases['hier-atom-readout']['shape'] == dict(
        h=[graph['fmess'].shape[0], h], graph=list(graph['agraph'].shape))
    assert cases['hier-cluster']['shape'] == dict(
        h=[graph['fnode'].shape[0], h], graph=list(tree['cgraph'].shape))
    for site in ('inter-readout', 'tree-readout'):
        assert cases[f'hier-{site}']['shape'] == dict(
            h=[tree['fmess'].shape[0], h], graph=list(tree['agraph'].shape))
    assert cases['hier-root']['shape'] == dict(
        h=[tree['fmess'].shape[0], h], graph=[n_roots, a])
    assert cases['hier-atom-gather']['shape'] == dict(
        src=[graph['fmess'].shape[0], 3 * h],
        graph=list(graph['bgraph'].shape))
    assert cases['hier-tree-gather']['shape'] == dict(
        src=[tree['fmess'].shape[0], 3 * h],
        graph=list(tree['bgraph'].shape))
    for c in cases.values():
        _close(c['call'](), c['plain']())


# -- HierPropOptVAE behind the server ---------------------------------------

# soft and patience with their stopping rules in play (as
# tests/test_torch_latent.py's small search)
SMALL_SEARCH = dict(latent_lr=0.05, property_optim_step=20,
                    property_delta=0.3, patience=3, patience_threshold=0.02)


@pytest.fixture(scope='module')
def propopt(jax_fragments):
    jvocab, _ = jax_load_vocab(VOCAB)
    vocab = load_vocab_file(VOCAB)
    hv, iv = vocab.size()
    cfg = ModelConfig(hvocab_size=hv, ivocab_size=iv, **SMALL)
    params, model = _small_params(HierPropOptVAE, cfg, 5)
    jmodel = JaxHierPropOptVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, rnn_type='LSTM', dropout=0.0,
        **SMALL))
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[8:14]
    z = np.asarray(jax_encode(jmodel, params, jax_batch(rows, jvocab))[0])
    srv = GgpmServer(model, vocab, device='cpu', max_decode_step=40)
    yield dict(params=params, jmodel=jmodel, jvocab=jvocab, srv=srv,
               rows=rows, z=z)
    srv.stop()


def test_properties_endpoint_small(propopt):
    p = propopt
    port = p['srv'].start(port=0).server_address[1]
    from test_torch_hier import post
    out = post(port, '/properties', {'smiles': [r[0] for r in p['rows']]})
    h, l = p['jmodel'].apply(p['params'], jnp.asarray(p['z']),
                             method=lambda m, z: m.predict_properties(z))
    _close(out['homo'], h)
    _close(out['lumo'], l)


@pytest.mark.parametrize('policy', ['soft', 'patience', 'hard'])
def test_optimize_small(propopt, policy):
    """``GgpmServer.optimize``: the JAX search from the JAX latents, its
    predictions, and the JAX decode of the searched latents (exact and
    turbo alike)."""
    p = propopt
    homo = np.array([r[1] for r in p['rows']], np.float32) + 0.3
    lumo = np.array([r[2] for r in p['rows']], np.float32) - 0.3
    opt = JaxLatentOptimizer(p['jmodel'], p['params'], optimize_type=policy,
                             **SMALL_SEARCH)
    z_opt = np.asarray(opt.optimize(jnp.asarray(p['z']), homo, lumo))
    h, l = p['jmodel'].apply(p['params'], jnp.asarray(z_opt),
                             method=lambda m, z: m.predict_properties(z))
    kw = dict(greedy=True, max_decode_step=40)
    _, exact = jax_decode.decode_hier(p['jmodel'], p['params'], p['jvocab'],
                                      jax_avocab, z_opt, **kw)
    _, turbo = jax_decode.decode_best(p['jmodel'], p['params'], p['jvocab'],
                                      jax_avocab, z_opt, **kw)
    assert exact == turbo
    out = p['srv'].optimize([r[0] for r in p['rows']], homo, lumo, policy,
                            **SMALL_SEARCH)
    _close(out['homo'], h)
    _close(out['lumo'], l)
    assert out['smiles'] == exact
    assert np.abs(z_opt - p['z']).max() > 1e-3           # the search moved
