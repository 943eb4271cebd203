"""``Trainer.scan_steps``, the port's counterpart of the JAX package's
``make_scan_train_step``, on the CPU: against the JAX scan, against K
``train_step``s of the port (bit for bit), and the device scalars a
captured step reads (learning rate, bias corrections, β) against the host
floats the step used to compute.  On the CPU ``scan_steps`` is K eager
steps; tests/test_torch_scan_cuda.py holds the card's graph replays to the
same eager steps.

Small width (hidden = embed = 32, latent 8, depthT 3, dropout 0) on the
five HOPV batches of 20 that share one shape signature (the trained
model's vocab), ``steps_per_epoch`` 3 so that the learning rate decays
inside the five steps, and β warmed up over 4 steps from step 2.  The JAX
model and ``make_scan_train_step`` are called directly: the JAX package's
own ``tests/test_train.py::test_scan_steps_matches_sequential`` reads
reference data absent from the test machines.

Tolerances: the JAX scan's per-step metrics within 1e-4 relative (the
accuracies within 1e-7), and each leaf's update over the five steps within
1e-3 of JAX's, ``‖Δport − Δjax‖ / ‖Δjax‖`` over its entries whose gradient
is not rounding noise (as tests/test_torch_train.py's trajectory).
Everything else is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropertyVAE as JaxPropertyVAE
from ggpm_tpu.train.loop import make_scan_train_step, stack_batches
from ggpm_tpu.train.optim import make_optimizer as jax_make_optimizer
from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import flatten, load_flax_params, to_flax_tree
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.models.vae import (ModelConfig, PropertyVAE, PropOptVAE,
                                       init_params)
from ggpm_tpu_torch.ops import build_transpose
from ggpm_tpu_torch.train.loop import (MetricAccumulator, Trainer,
                                       count_clipped, signature, to_device)
from ggpm_tpu_torch.train.optim import (default_group_fn, make_multi_optimizer,
                                        make_optimizer)

SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3)
STEPS_PER_EPOCH = 3
WARMUP = 4
STEP0 = 2
METRIC_RTOL = 1e-4
UPDATE_RTOL = 1e-3
FINETUNE_LRS = {'encoder': 1e-3, 'decoder': 2e-3, 'homo': 5e-4,
                'lumo': 3e-4}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def hopv():
    """The port's 17 HOPV batches, the indices of the five that share a
    signature (the first such bucket), and the JAX package's batches at
    those indices, with the trained model's vocab in both."""
    vocab, mbs = profile_train.hopv_batches()
    sigs = [signature(batching.to_model_batch(mb, vocab.mask, pad=False))
            for mb in mbs]
    idx = next([i for i, s in enumerate(sigs) if s == t]
               for t in sigs if sigs.count(t) == 5)
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        jvocab, _ = jax_load_vocab(profile_train.VOCAB)
        rows = profile_train.hopv_rows(vocab)
        jbs = []
        for i in idx:
            jmb = jax_batching.pad_batch(jax_mg.tensorize(
                rows[20 * i:20 * i + 20], jvocab, jax_avocab))
            jb = jax_batching.to_model_batch(jmb, jvocab.mask, pad=False)
            jbs.append(dict(jb, plan=jax_batching.compact_plan_dict(
                {k: np.asarray(v) for k, v in jb['plan'].items()})))
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = vocab.size()
    return dict(vocab=vocab, mbs=mbs, idx=idx, jbs=jbs, hv=hv, iv=iv)


def _port_model(hopv, kind, seed=0):
    cfg = ModelConfig(hvocab_size=hopv['hv'], ivocab_size=hopv['iv'],
                      linear_hidden_size=16, **SMALL)
    model = (PropertyVAE if kind == 'prop' else PropOptVAE)(cfg)
    return init_params(model, torch.Generator().manual_seed(seed))


def _trainer(hopv, kind, model=None):
    model = model if model is not None else _port_model(hopv, kind)
    if kind == 'prop':
        opt = make_optimizer(lr=1e-3, clip_norm=20.0,
                             steps_per_epoch=STEPS_PER_EPOCH)
    else:
        opt = make_multi_optimizer(default_group_fn, FINETUNE_LRS,
                                   clip_norm=1.0,
                                   steps_per_epoch=STEPS_PER_EPOCH)
    tr = Trainer(model, opt, hopv['vocab'].mask, beta=0.1,
                 beta_warmup_steps=WARMUP, perturb_z=kind != 'prop',
                 seed=5, device='cpu')
    tr.total_step = STEP0
    return tr


def _device_batches(tr, hopv):
    return [tr.device_batch(tr.host_batch(hopv['mbs'][i]))
            for i in hopv['idx']]


# -- the device scalars against the host floats ---------------------------

@pytest.mark.parametrize('steps_per_epoch', [1, 3, 17])
def test_lr_and_bias_corrections_are_the_host_floats(steps_per_epoch):
    """For counts 1..3·steps_per_epoch: the device learning rate and bias
    corrections equal, bit for bit, the floats the host computed for the
    same update (``Adam.schedule`` and ``1 - b ** count`` of a float32
    tensor)."""
    opt = make_optimizer(lr=1e-3, anneal_rate=0.9,
                         steps_per_epoch=steps_per_epoch)
    state = opt.attach([torch.nn.Parameter(torch.zeros(2))])
    for count in range(1, 3 * steps_per_epoch + 1):
        n = torch.tensor(count)
        bc1, bc2 = state.bias_corrections(n)
        lr = state.schedule_t(n - 1)
        assert all(v.dtype == torch.float32 for v in (bc1, bc2, lr))
        assert float(bc1) == float(
            1 - torch.tensor(opt.b1, dtype=torch.float32) ** count)
        assert float(bc2) == float(
            1 - torch.tensor(opt.b2, dtype=torch.float32) ** count)
        assert float(lr) == opt.schedule(count - 1)


@pytest.mark.parametrize('warmup', [0, 4, 7])
def test_beta_is_the_host_float(hopv, warmup):
    """β of steps 0..3·warmup+2 equals, in float32, the host's
    ``beta · min(step / warmup, 1)`` in float64, as the model's ``beta ·
    kl`` rounded it."""
    tr = Trainer(_port_model(hopv, 'prop'), make_optimizer(),
                 hopv['vocab'].mask, beta=0.1, beta_warmup_steps=warmup,
                 device='cpu')
    for step in range(3 * warmup + 3):
        tr.total_step = step
        tr._sync_step()
        want = 0.1 * min(step / warmup, 1.0) if warmup else 0.1
        got = tr._beta_t()
        got = float(got) if isinstance(got, torch.Tensor) else np.float32(got)
        assert got == np.float32(want), step


# -- scan_steps ------------------------------------------------------------

def _leaf_updates(before, after):
    return {k: np.asarray(after[k], np.float64) - np.asarray(before[k],
                                                             np.float64)
            for k in before}


def _noise(grads, masks=None):
    """Per leaf, the entries whose gradient is rounding noise (below 1e-6
    of the whole gradient's norm), or'ed into ``masks`` from earlier
    steps (tests/test_torch_train.py)."""
    total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                        for v in grads.values()))
    masks = dict(masks or {})
    for k, v in grads.items():
        m = np.abs(v) < 1e-6 * total
        masks[k] = m | masks[k] if k in masks else m
    return masks


def test_scan_steps_matches_the_jax_scan(hopv):
    """Five ``prop`` steps through ``scan_steps`` against JAX's
    ``make_scan_train_step`` from step 2 (``step0``): the stacked metrics
    of every step, β warming up and the learning rate decaying between
    steps 3 and 4, and every leaf's update over the five steps."""
    jcfg = JaxModelConfig(rnn_type='LSTM', dropout=0.0,
                          hvocab_size=hopv['hv'], ivocab_size=hopv['iv'],
                          **SMALL)
    jmodel = JaxPropertyVAE(cfg=jcfg)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({'params': key, 'dropout': key},
                         jax.tree.map(jnp.asarray, hopv['jbs'][0]), 0.1,
                         key, False, True)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    tx = jax_make_optimizer(lr=1e-3, clip_norm=20.0,
                            steps_per_epoch=STEPS_PER_EPOCH)
    scan = make_scan_train_step(jmodel, tx, beta=0.1, perturb_z=False,
                                beta_warmup_steps=WARMUP)
    p = jax.tree.map(jnp.asarray, params)
    p, _, jmet, _, _ = scan(p, tx.init(p), stack_batches(
        [jax.tree.map(jnp.asarray, b) for b in hopv['jbs']]), key,
        float(STEP0))
    want = flatten(jax.tree.map(np.asarray, p))

    model = PropertyVAE(ModelConfig(hvocab_size=hopv['hv'],
                                    ivocab_size=hopv['iv'], **SMALL))
    load_flax_params(model, params)
    tr = _trainer(hopv, 'prop', model)
    tr.perturb_z = False
    masks = []
    step = tr.train_step

    def recording_step(batch):
        out = step(batch)
        masks.append(_noise(flatten(to_flax_tree(tr.model, lambda q: q.grad)),
                            masks[-1] if masks else None))
        return out
    tr.train_step = recording_step
    init = flatten(to_flax_tree(tr.model))
    metrics, aux = tr.scan_steps(_device_batches(tr, hopv))
    assert len(masks) == 5 and aux['clipped'] is False
    assert tr.total_step == STEP0 + 5 and tr.opt_state.count == 5
    assert set(metrics) == set(jmet)
    for k, v in jmet.items():
        v = np.asarray(v)
        assert metrics[k].shape == v.shape == (5,), k
        if k in ('Word', 'I-Word', 'Topo', 'Assm'):
            np.testing.assert_allclose(metrics[k].numpy(), v, rtol=0,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_allclose(metrics[k].numpy(), v,
                                       rtol=METRIC_RTOL, err_msg=k)
    ours = _leaf_updates(init, flatten(to_flax_tree(tr.model)))
    theirs = _leaf_updates(flatten(jax.tree.map(np.asarray, params)), want)
    for k, d in theirs.items():
        keep = ~masks[-1][k]
        den = np.linalg.norm(d[keep])
        err = np.linalg.norm(ours[k][keep] - d[keep])
        assert err <= UPDATE_RTOL * den, (k, err, den)


def _state(tr):
    """Everything a step changes, as tensors."""
    groups = getattr(tr.opt_state, 'groups', {'': tr.opt_state})
    out = {'gen': tr.gen.get_state(), 'step_dev': tr._step_dev}
    for g, st in groups.items():
        out.update({f'{g}/flat': st.flat, f'{g}/mu': st.mu,
                    f'{g}/nu': st.nu, f'{g}/count': st.count_dev})
    return out


def _bits(t):
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize('kind', ['prop', 'prop-opt'])
def test_scan_steps_equal_sequential_steps(hopv, kind):
    """``scan_steps`` over the five batches and five ``train_step``s from
    the same state: the same metrics, breaker flags and group norms of
    every step, and the same parameters, moments, counts and generator
    after, bit for bit.  prop-opt draws ``eps`` and ``clip_eps`` from the
    trainer's generator and clips its encoder group."""
    a, b = _trainer(hopv, kind), _trainer(hopv, kind)
    metrics, aux = a.scan_steps(_device_batches(a, hopv))
    steps = []
    for db in _device_batches(b, hopv):
        m, x = b.train_step(db)
        steps.append((m, x, dict(getattr(b.opt_state, 'group_norms', {}))))
    assert set(metrics) == set(steps[0][0])
    for k in metrics:
        assert torch.equal(_bits(metrics[k]), _bits(torch.stack(
            [m[k] for m, _, _ in steps]))), k
    if kind == 'prop':
        assert aux['clipped'] is False and 'group_norms' not in aux
    else:
        assert torch.equal(aux['clipped'], torch.stack(
            [x['clipped'] for _, x, _ in steps]))
        assert set(aux['group_norms']) == set(FINETUNE_LRS)
        for g, v in aux['group_norms'].items():
            assert torch.equal(_bits(v), _bits(torch.stack(
                [n[g] for _, _, n in steps]))), g
        assert float(aux['group_norms']['encoder'].min()) > 1.0
    sa, sb = _state(a), _state(b)
    for k in sa:
        assert torch.equal(_bits(sa[k]), _bits(sb[k])), k
    assert a.total_step == b.total_step == STEP0 + 5
    assert a.opt_state.count == b.opt_state.count == 5


def test_train_epoch_scans_each_flush(hopv, monkeypatch):
    """``train_epoch`` runs a flush of two or more batches through
    ``scan_steps`` and a flush of one through ``train_step``, in the JAX
    order, and counts each step once."""
    tr = _trainer(hopv, 'prop')
    calls = []
    scan = tr.scan_steps
    monkeypatch.setattr(tr, 'scan_steps', lambda dbs, **kw: calls.append(
        len(dbs)) or scan(dbs, **kw))
    i0 = hopv['idx'][0]
    other = next(i for i in range(len(hopv['mbs']))
                 if i not in hopv['idx'])
    order = [i0, other, hopv['idx'][1]]
    assert not tr.train_epoch([hopv['mbs'][i] for i in order], scan_chunk=2,
                              log=lambda *_: None)
    assert calls == [2]
    assert tr.total_step == STEP0 + 3 and tr.opt_state.count == 3
    ref = _trainer(hopv, 'prop')
    for i in (i0, hopv['idx'][1], other):
        ref.train_step(ref.device_batch(ref.host_batch(hopv['mbs'][i])))
    assert torch.equal(_bits(tr.opt_state.flat), _bits(ref.opt_state.flat))


@pytest.mark.parametrize('graph,calls_want', [(None, [2, 1]), (False, [2])],
                         ids=['graphs', 'graph-false'])
def test_train_epoch_replays_a_flush_of_one_with_graphs(hopv, monkeypatch,
                                                        graph, calls_want):
    """Where the trainer's steps run through graphs
    (``graphs_by_default``, here patched on, as on the card), ``train_epoch``
    runs a flush of one batch through ``scan_steps`` too, whose graph it
    then replays (here ``scan_steps`` runs without graphs, the CPU's plain
    version of the same step); with ``graph=False`` given, a flush of one
    is still a ``train_step``.  The parameter trajectory is ``train_step``'s
    in the JAX order, bit for bit, either way."""
    tr = _trainer(hopv, 'prop')
    monkeypatch.setattr(tr, 'graphs_by_default', lambda: True)
    calls = []
    scan = tr.scan_steps
    monkeypatch.setattr(tr, 'scan_steps', lambda dbs, **kw: calls.append(
        len(dbs)) or scan(dbs, graph=False))
    i0 = hopv['idx'][0]
    other = next(i for i in range(len(hopv['mbs']))
                 if i not in hopv['idx'])
    order = [i0, other, hopv['idx'][1]]
    assert not tr.train_epoch([hopv['mbs'][i] for i in order], scan_chunk=2,
                              log=lambda *_: None, graph=graph)
    assert calls == calls_want
    assert tr.total_step == STEP0 + 3 and tr.opt_state.count == 3
    ref = _trainer(hopv, 'prop')
    for i in (i0, hopv['idx'][1], other):
        ref.train_step(ref.device_batch(ref.host_batch(hopv['mbs'][i])))
    assert torch.equal(_bits(tr.opt_state.flat), _bits(ref.opt_state.flat))
    assert torch.equal(_bits(tr.opt_state.mu), _bits(ref.opt_state.mu))
    assert torch.equal(tr.gen.get_state(), ref.gen.get_state())


def test_metric_rows_and_flags_count_every_step():
    """``MetricAccumulator`` and ``count_clipped`` take a step's scalars
    and a scan's [K] rows alike: the mean and the count over every
    step."""
    acc = MetricAccumulator()
    acc.add({'Loss': torch.tensor(1.0)})
    acc.add({'Loss': torch.tensor([2.0, 3.0, 6.0])})
    assert acc.mean() == {'Loss': 3.0}
    assert count_clipped([False, True, torch.tensor(True),
                          torch.tensor([True, False, True])]) == 4


@pytest.mark.parametrize('case', ['complete', 'lost', 'short', 'wrapper',
                                  'invented'])
def test_replay_windows_hold_complete_windows(case):
    """``profile_train.check_replay_windows``: the wrappers' launches and
    those that ran by the kernels' own device counts are held in every
    window; the profiler's records may fall short of those that ran (its
    loss is reported, not held) but never exceed them."""
    want = {'nei_sum': 3.0, 'transpose_sum': 22.0, 'gather_rows': 20.0}
    windows = [dict(launches=dict(want), ran=dict(want), device=dict(want),
                    records=6500) for _ in range(3)]
    if case == 'lost':
        windows[1].update(records=6486, device=dict(want, gather_rows=6.0))
        for w in windows[::2]:
            w['device'] = dict(want, gather_rows=19.0)
    elif case == 'short':
        for w in windows[:2]:
            w['ran'] = w['device'] = dict(want, gather_rows=19.0)
    elif case == 'wrapper':
        windows[1]['launches'] = dict(want, nei_sum=2.0)
    elif case == 'invented':
        windows[2]['device'] = dict(want, transpose_sum=23.0)
    bad, lost = profile_train.check_replay_windows(windows, want)
    assert lost == ([(0, {'gather_rows': 1.0}), (1, {'gather_rows': 14.0}),
                     (2, {'gather_rows': 1.0})] if case == 'lost' else [])
    assert bad == {'complete': [], 'lost': [],
                   'short': [(0, 'ran', windows[0]['ran']),
                             (1, 'ran', windows[1]['ran'])],
                   'wrapper': [(1, 'launches', windows[1]['launches'])],
                   'invented': [(2, 'device', windows[2]['device'])]}[case]


# -- static transpose widths -----------------------------------------------

def test_static_widths_give_the_host_signatures(hopv):
    """Over the 17 HOPV batches the device batches have as many
    signatures as the host batches (5), each a function of the host's."""
    tr = _trainer(hopv, 'prop')
    pairs = {}
    for mb in hopv['mbs']:
        host = tr.host_batch(mb)
        pairs.setdefault(signature(host), set()).add(
            signature(batching.train_tables(host)))
    assert len(pairs) == 5
    assert all(len(v) == 1 for v in pairs.values())


@pytest.mark.parametrize('i', [0, 2, 15])
def test_static_widths_give_the_same_loss_and_grads(hopv, i):
    """Loss, metrics and every gradient of a training forward over the
    static tables equal those over tables sized from the data
    (``build_transpose`` without a width), bit for bit: the extra columns
    are masked."""
    model = _port_model(hopv, 'prop')
    tr = Trainer(model, make_optimizer(), hopv['vocab'].mask, perturb_z=False,
                 device='cpu')
    host = tr.host_batch(hopv['mbs'][i])
    static = batching.train_tables(host)
    tree, plan = dict(static['tree']), dict(static['plan'])
    n_mess = tree['fmess'].shape[0]
    for level, name, table, rows in (
            (tree, 'agraph', tree['agraph'], n_mess),
            (tree, 'root', tree['agraph'][tree['scope'][:, 0]], n_mess),
            (plan, 'frontier', plan['frontier'],
             n_mess + len(plan['root_clab']))):
        level[name + '_t'], level[name + '_tm'] = build_transpose(table,
                                                                  rows)
    tables = [static, dict(static, tree=tree, plan=plan)]
    widths = [t['plan']['frontier_t'].shape[1] for t in tables]
    assert widths[0] == tables[0]['plan']['frontier'].shape[1] > widths[1]
    results = []
    for t in tables:
        db = to_device(t, 'cpu', tr._mask_dev)
        for p in tr.opt_state.params:
            p.grad = None
        loss, metrics, _ = model(db, 0.1, perturb_z=False)
        loss.backward()
        results.append((loss.detach().clone(),
                        {k: v.detach().clone() for k, v in metrics.items()},
                        tr.opt_state.flat_grad().clone()))
    (la, ma, ga), (lb, mb, gb) = results
    assert torch.equal(_bits(la), _bits(lb))
    for k in ma:
        assert torch.equal(_bits(ma[k]), _bits(mb[k])), k
    assert torch.equal(_bits(ga), _bits(gb))
