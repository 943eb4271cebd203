"""The port's hier training path against the JAX package's, on the CPU, and
the JAX reference steps that chip_smoke.py holds the card's hier training
to.

Small width (hidden = embed = 32, latent 8, depthT = depthG = 3, diterT 1,
diterG 3, dropout 0) over the trained hier vocab, with the same params in
both packages (a flax-style init with noise on every leaf, through the
bridge), on padded, unpacked batches of 6 HOPV molecules.  The JAX models
are called directly (``apply``, ``jax.value_and_grad``): the JAX fixtures
read reference data absent from the test machines.  The latent noise is
injected: the port takes the ε that JAX draws from its key.

Tolerances: losses within 1e-5 relative (the issue allows 1e-4) and
accuracies exact; each gradient leaf within 1e-4 of its largest entry in
magnitude, or of 1e-3 of the largest entry of any leaf for a leaf whose
exact gradient is zero (``decoder/W_assm/bias``: every assembly slot holds
``bias·z``, so its terms cancel, leaving rounding noise of 2e-7); the
transposes of the ten sums equal the plain gradient within 1e-6 (a few
terms in another order); updates of a 3-step trajectory within 1e-3 per
leaf whose gradient is not rounding noise.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hier_train.py

rewrites ``ggpm_tpu_torch/goldens/train_hier_hopv.json`` and
``train_hier_propopt_hopv.json`` from the JAX package (about 2 minutes
each: a full-width JAX step on the CPU takes 10 s after a 30 s compile).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models.vae import HierPropertyVAE as JaxHierPropertyVAE
from ggpm_tpu.models.vae import HierPropOptVAE as JaxHierPropOptVAE
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.train import checkpoint as jax_ckpt
from ggpm_tpu.train.loop import make_train_step
from ggpm_tpu.train.optim import default_group_fn as jax_group_fn
from ggpm_tpu.train.optim import make_multi_optimizer as jax_multi
from ggpm_tpu.train.optim import make_optimizer as jax_make_optimizer
from ggpm_tpu_torch import kernel_bench, profile_train
from ggpm_tpu_torch.bridge import (flatten, load_flax_params, read_checkpoint,
                                   to_flax_tree)
from ggpm_tpu_torch.cli import vae_fine_tune, vae_train
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file
from ggpm_tpu_torch.models import hier_decoder
from ggpm_tpu_torch.models.vae import (HierPropertyVAE, HierPropOptVAE,
                                       ModelConfig, init_params)
from ggpm_tpu_torch.ops import graph_ops
from ggpm_tpu_torch.profile_serve import HIER_CKPT, HIER_VOCAB
from ggpm_tpu_torch.train import checkpoint as ckpt
from ggpm_tpu_torch.train.loop import Trainer, signature, to_device
from ggpm_tpu_torch.train.optim import (default_group_fn, make_multi_optimizer,
                                        make_optimizer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = {ft: os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens', name)
           for ft, name in ((False, 'train_hier_hopv.json'),
                            (True, 'train_hier_propopt_hopv.json'))}
# the trained checkpoint's configuration (scripts/quality_run.py:135-140)
TRAINED = dict(rnn_type='LSTM', hidden_size=250, embed_size=250,
               latent_size=24, linear_hidden_size=128, depthT=20, depthG=20,
               diterT=1, diterG=3, dropout=0.0)
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8,
             linear_hidden_size=8, depthT=3, depthG=3, diterT=1, diterG=3)
BATCH = 6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-3
SUM_ATOL = 1e-6
BETA = 0.1


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module', autouse=True)
def jax_fragments():
    """The JAX vocab loader sets the class-level fragment set that JAX's
    ``tensorize`` reads: the hier vocab's while this module runs."""
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


@pytest.fixture(scope='module')
def data(jax_fragments):
    """The hier vocab on both sides, and three padded batches of 6 HOPV
    molecules of one shape signature: the port's ``MolGraphBatch``es and
    their model-batch dicts, and the JAX package's from its own
    tensorize."""
    jvocab, _ = jax_load_vocab(HIER_VOCAB)
    vocab = load_vocab_file(HIER_VOCAB)
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)
    mbs, jbs, pbs = [], [], []
    for i in range(0, len(rows) - BATCH + 1, BATCH):
        r = rows[i:i + BATCH]
        mb = batching.pad_batch(tensorize(r, vocab, common_atom_vocab))
        pb = batching.to_model_batch(mb, vocab.mask, pad=False)
        if mbs and signature(pb) != signature(pbs[0]):
            continue
        mbs.append(mb)
        pbs.append(pb)
        jbs.append(jax_batching.to_model_batch(jax_batching.pad_batch(
            jax_mg.tensorize(r, jvocab, jax_avocab)), jvocab.mask,
            pad=False))
        if len(mbs) == 3:
            break
    hv, iv = vocab.size()
    return dict(vocab=vocab, jvocab=jvocab, rows=rows, mbs=mbs, jbs=jbs,
                pbs=pbs, hv=hv, iv=iv)


def _config(data, **kw):
    return ModelConfig(hvocab_size=data['hv'], ivocab_size=data['iv'],
                       **SMALL, **kw)


def _jax_config(data, **kw):
    return JaxModelConfig(hvocab_size=data['hv'], ivocab_size=data['iv'],
                          rnn_type='LSTM', dropout=0.0, **SMALL, **kw)


def _small_params(cls, cfg, seed):
    """Flax-layout params of ``cls(cfg)`` from the port's flax-style init,
    perturbed on every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (x + rng.normal(0, 0.1, x.shape)).astype(np.float32),
        to_flax_tree(init_params(cls(cfg), torch.Generator().manual_seed(
            seed))))


def _port(cls, cfg, params):
    model = cls(cfg)
    load_flax_params(model, params)
    return model


def _value_and_grad(jmodel):
    """``jax.value_and_grad`` of the JAX model's ``__call__`` (dropout off,
    the latent perturbed by the key), jitted once a model."""
    def jloss(p, b, rng):
        total, metrics, aux = jmodel.apply(p, b, BETA, rng, True, True)
        return total, (metrics, aux)
    return jax.jit(jax.value_and_grad(jloss, has_aux=True))


@pytest.fixture(scope='module')
def prop(data):
    """The small ``hier-prop`` models of both packages on the same params,
    and the JAX model's jitted loss and gradient."""
    params = _small_params(HierPropertyVAE, _config(data), 0)
    jmodel = JaxHierPropertyVAE(cfg=_jax_config(data))
    return dict(params=params, vag=_value_and_grad(jmodel),
                port=lambda p=params: _port(HierPropertyVAE, _config(data),
                                            p))


@pytest.fixture(scope='module')
def propopt(data):
    """The small ``hier-prop-opt`` models with loss scaling (its
    log-variances at zero: the unweighed losses), as ``prop``."""
    cfg = _config(data, loss_scaling=True)
    params = _small_params(HierPropOptVAE, cfg, 1)
    for v in params['params']['loss_weigh'].values():
        v[:] = 0
    jmodel = JaxHierPropOptVAE(cfg=_jax_config(data, loss_scaling=True))
    return dict(params=params, vag=_value_and_grad(jmodel),
                port=lambda p=params: _port(HierPropOptVAE, cfg, p))


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
            np.testing.assert_allclose(metrics[k].item(), float(v),
                                       rtol=LOSS_RTOL, atol=1e-9, err_msg=k)


def _device(data, i):
    return to_device(batching.hier_train_tables(data['pbs'][i]), 'cpu')


# -- the batch tables --------------------------------------------------------

def test_tensorize_matches_jax(data):
    """Each package's own padded batch of the same molecules is the same
    arrays, so the port's tables index what the JAX scan reads."""
    for pb, jb in zip(data['pbs'], data['jbs']):
        mine, theirs = flatten(pb), flatten(jb)
        assert set(mine) == set(theirs)
        for k, v in theirs.items():
            assert np.array_equal(np.asarray(mine[k]), np.asarray(v)), k


def test_step_transposes_are_per_step_build_transposes():
    """``step_transposes`` of T tables equals ``build_transpose`` of each
    step's table; a state row read twice in one step breaks width 1."""
    rng = np.random.default_rng(0)
    T, N, A, M = 5, 7, 3, 40
    tables = np.stack([rng.permutation(M)[:N * A].reshape(N, A)
                       for _ in range(T)]).astype(np.int32)
    tables[rng.random(tables.shape) < 0.3] = 0
    t_idx, t_mask = batching.step_transposes(tables, M, 1)
    assert t_idx.shape == t_mask.shape == (T, M, 1)
    for t in range(T):
        want = graph_ops.build_transpose(tables[t], M, 1)
        assert np.array_equal(t_idx[t], want[0])
        assert np.array_equal(t_mask[t], want[1])
    tables[2, 1, 0] = tables[2, 0, 0] = 5
    with pytest.raises(ValueError, match='exceeds static bound'):
        batching.step_transposes(tables, M, 1)


def test_hier_train_tables_keep_the_hopv_signatures():
    """The 17 HOPV batches of 20 in the hier vocab fall into 5 shape
    signatures (the JAX ``Trainer``'s buckets: T 64 or 96, two size
    classes, tree ``bgraph`` width 4 or 6), and ``hier_train_tables``
    keeps them at 5: every table's width is a bound of the bucket
    shapes."""
    vocab, mbs = profile_train.hopv_batches(vocab=load_vocab_file(
        HIER_VOCAB))
    hosts = [batching.to_model_batch(mb, vocab.mask, pad=False)
             for mb in mbs]
    devs = [batching.hier_train_tables(h) for h in hosts]
    assert len(mbs) == 17
    assert len({signature(h) for h in hosts}) == 5
    assert len({signature(d) for d in devs}) == 5
    assert all((signature(a) == signature(b)) == (signature(c) ==
                                                  signature(d))
               for a, c in zip(hosts, devs) for b, d in zip(hosts, devs))
    assert sorted({d['plan']['mess'].shape[0] for d in devs}) == [64, 96]


SITES = tuple(site for site, _ in kernel_bench.HIER_TRAIN_SITES)


@pytest.mark.parametrize('name', SITES)
def test_sum_transposes_are_the_plain_gradient(data, name):
    """At each of the ten sums of a step, the kernel's transpose
    (``transpose_sum`` over the batch's table, which leaves row 0 out)
    equals autograd of the plain gather-sum ``h[graph].sum(1)`` on every
    row but row 0, at every scan step for the decoder's, whose row 0 the
    scan keeps a constant zero; and the per-step tables are the ones the
    JAX scan indexes (``agraph[gstep_nodes[t]]``, ``cgraph[src]``,
    ``cgraph[xid[t]]``, ``agraph[xid[t]]``, ``agraph_dec[xid[t]]``)."""
    db = _device(data, 0)
    plan, tree, graph = db['plan'], db['tree'], db['graph']
    T = plan['mess'].shape[0] if name.startswith('dec-') else 1
    gen = torch.Generator().manual_seed(SITES.index(name))
    tables = []
    for t in range(T):
        rows, table, t_idx, t_mask = kernel_bench.hier_train_site(db, name,
                                                                  t)
        h = torch.randn((rows, 5), generator=gen, requires_grad=True)
        g = torch.randn((table.shape[0], 5), generator=gen)
        graph_ops.nei_sum(h, table.long()).backward(g)
        got = graph_ops.transpose_sum(g, t_idx, t_mask, table.shape[1])
        want = h.grad.clone()
        want[0] = 0
        torch.testing.assert_close(got, want, rtol=0, atol=SUM_ATOL)
        tables.append(table)
    xid = plan['xid'].long()
    expect = {
        'dec-atom': graph['agraph'][plan['gstep_nodes'].long()].flatten(
            1, 2),
        'dec-cluster-src': tree['cgraph'][
            tree['fmess'][:, 0].long()[plan['mess'].long()]],
        'dec-cluster-x': tree['cgraph'][xid],
        'dec-inter': tree['agraph'][xid],
        'dec-tree': tree['agraph_dec'][xid]}.get(name)
    if expect is not None:
        assert torch.equal(torch.stack(tables).long(), expect.long())


def test_kernel_cases_of_a_hier_step(data):
    """``kernel_bench.hier_train_cases`` on the CPU: each case's call (the
    plain version here) equals its in-order sum and the library call, at
    the shapes of the batch's tables."""
    db = _device(data, 0)
    cases = kernel_bench.hier_train_cases(
        db, torch.Generator().manual_seed(0), hidden=8, step=3)
    gathers = ['hier-train-atom-gather', 'hier-train-atom-update']
    assert [c['case'] for c in cases] == \
        [f'hier-train-{s}' for s in SITES] + gathers + \
        [f'hier-train-{s}-bwd' for s in SITES if s != 'enc-tree'] + \
        [f'{g}-bwd' for g in gathers]
    for c in cases:
        out, ref = c['call'](), c['plain']()
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        torch.testing.assert_close((c['exact'] or c['plain'])(), ref,
                                   rtol=0, atol=1e-6)
        torch.testing.assert_close(c['library'](), ref, rtol=0, atol=1e-5)
        assert c['bytes'] > 0


def _launch_counter(monkeypatch):
    """Counts of the plain versions the kernels' wrappers take on the CPU:
    ``nei_sum``'s, ``transpose_sum``'s and ``gather_rows``'."""
    counts = dict(nei_sum=0, transpose_sum=0, gather_rows=0)
    for name, fn in (('nei_sum', 'nei_sum'), ('transpose_sum',
                                              'transpose_sum'),
                     ('gather_rows', 'gather_nd')):
        orig = getattr(graph_ops, fn)

        def counted(*a, orig=orig, name=name):
            counts[name] += 1
            return orig(*a)
        monkeypatch.setattr(graph_ops, fn, counted)
    return counts


def test_step_calls_each_kernel_as_derived(data, prop, monkeypatch):
    """One training step calls the kernels' wrappers as PERF.md derives
    it, for T scan steps and U = 2·(diterG + 2·diterT) message-update
    gathers a step (h and c of each round of the three levels):
    ``nei_sum`` 5 + 5·T (the encoder's five readouts, the scan's five sums
    a step), ``gather_rows`` D + U·T (D = depthG + 2·depthT, the three
    depth loops), ``transpose_sum`` 4 + D + (5 + U)·T − 5: the backward of
    every one of them but the motif level's node readout, which the loss
    does not read, and five gathers of step 0 whose states need no
    gradient yet (the atom level's first round, the attachment level's,
    the motif level's ``c``)."""
    counts = _launch_counter(monkeypatch)
    db = _device(data, 0)
    T = db['plan']['mess'].shape[0]
    model = prop['port']()
    total, _, _ = model(db, BETA, perturb_z=False)
    total.backward()
    d = SMALL['depthG'] + 2 * SMALL['depthT']
    u = 2 * (SMALL['diterG'] + 2 * SMALL['diterT'])
    assert counts == dict(nei_sum=5 + 5 * T, gather_rows=d + u * T,
                          transpose_sum=4 + d + (5 + u) * T - 5)


def test_duplicate_writers_must_agree():
    """The scan's writes (``put_rows``, out of place) keep
    ``scatter_rows_``'s CPU check: writers of one row must agree, as
    ``index_put`` on the card keeps one arbitrary writer."""
    buf = torch.zeros((5, 2))
    out = hier_decoder.put_rows(buf, torch.tensor([0, 3, 0]),
                                torch.tensor([[0., 0], [1, 2], [0, 0]]))
    assert out[3].tolist() == [1, 2] and not buf.any()
    with pytest.raises(AssertionError, match=r'\[3\]'):
        hier_decoder.put_rows(buf, torch.tensor([3, 1, 3]),
                              torch.tensor([[0., 0], [1, 2], [0, 1]]))


# -- the forwards: losses, metrics, gradients --------------------------------

@pytest.mark.parametrize('i', [0, 1])
def test_hier_prop_loss_and_grads_match_jax(data, prop, i):
    """``HierPropertyVAE.forward`` with the JAX key's ε injected against
    ``jax.value_and_grad`` of the JAX model: the total, the decoder's loss
    (the total less β·KL), KL, the four accuracies, and every parameter's
    gradient, the decoder's and the encoder's."""
    rng = jax.random.PRNGKey(7 + i)
    (jl, (jmet, _)), jg = prop['vag'](prop['params'], jax.tree.map(
        jnp.asarray, data['jbs'][i]), rng)
    eps = torch.from_numpy(np.array(jax.random.normal(
        rng, (BATCH, SMALL['latent_size']))))
    model = prop['port']()
    total, metrics, aux = model(_device(data, i), BETA, eps=eps)
    total.backward()
    assert aux == {'clipped': False}
    np.testing.assert_allclose(total.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        (total - BETA * metrics['KL']).item(),
        float(jl) - BETA * float(jmet['KL']), rtol=LOSS_RTOL)
    _assert_metrics(metrics, jmet)
    _assert_grads(flatten(to_flax_tree(model, lambda p: p.grad)), jg)


def test_hier_propopt_loss_and_grads_match_jax(data, propopt):
    """``HierPropOptVAE.forward`` (loss scaling on) with ε and the
    breaker's noise injected: the total, which leaves β·KL out, every
    metric (KL reported) and every gradient, the log-variances' too."""
    rng = jax.random.PRNGKey(3)
    (jl, (jmet, jaux)), jg = propopt['vag'](propopt['params'], jax.tree.map(
        jnp.asarray, data['jbs'][0]), rng)
    assert not bool(jaux['clipped'])
    rz, rc = jax.random.split(rng)
    eps = torch.from_numpy(np.array(jax.random.normal(
        rz, (BATCH, SMALL['latent_size']))))
    clip_eps = torch.tensor(float(jax.random.normal(rc, ())))
    model = propopt['port']()
    total, metrics, aux = model(_device(data, 0), BETA, eps=eps,
                                clip_eps=clip_eps)
    total.backward()
    assert not bool(aux['clipped'])
    np.testing.assert_allclose(total.item(), float(jl), rtol=LOSS_RTOL)
    want = metrics['Recs_Loss'] + metrics['HOMO_MSE'] + metrics['LUMO_MSE']
    assert total.item() == pytest.approx(want.item(), rel=1e-6)
    assert metrics['KL'].item() > 0
    _assert_metrics(metrics, jmet)
    _assert_grads(flatten(to_flax_tree(model, lambda p: p.grad)), jg)


# the breaker's batch: the first batch's molecules, every one labelled
# HOMO -5.0 and LUMO -2.0
BREAKER_LABELS = (-5.0, -2.0)


def test_hier_propopt_circuit_breaker(data, propopt):
    """A total at or below zero becomes 0.5 + 0.5·ε and is flagged.  The
    params: the heads predict each label plus 0.01 (a zero last kernel),
    and each log-variance is the log of its unweighed loss, so each
    weighed term is 1 + its log, about 1 + log 1e-4 for each property.
    The JAX model draws ε from its key's second half, the port takes it
    injected, and neither passes a gradient."""
    jax_load_vocab(HIER_VOCAB)
    rows = [[s, *BREAKER_LABELS] for s, _, _ in data['rows'][:BATCH]]
    jb = jax_batching.to_model_batch(jax_batching.pad_batch(
        jax_mg.tensorize(rows, data['jvocab'], jax_avocab)),
        data['jvocab'].mask, pad=False)
    db = to_device(batching.hier_train_tables(batching.to_model_batch(
        batching.pad_batch(tensorize(rows, data['vocab'],
                                     common_atom_vocab)),
        data['vocab'].mask, pad=False)), 'cpu')
    p = jax.tree.map(np.array, propopt['params'])
    po = p['params']['property_optim']
    for k, label in zip(('homo_linear', 'lumo_linear'), BREAKER_LABELS):
        po[k]['Dense_1']['kernel'][:] = 0
        po[k]['Dense_1']['bias'][:] = label + 0.01
    _, met, _ = propopt['port'](p)(db, BETA, perturb_z=False)
    lw = p['params']['loss_weigh']
    for k, m in (('recon', 'Recs_Loss'), ('homo', 'HOMO_MSE'),
                 ('lumo', 'LUMO_MSE')):
        lw[f'{k}_log_var'][:] = np.log(float(met[m]))
    rng = jax.random.PRNGKey(5)
    (jl, (jmet, jaux)), jg = propopt['vag'](p, jax.tree.map(jnp.asarray, jb),
                                            rng)
    assert bool(jaux['clipped'])
    rz, rc = jax.random.split(rng)
    eps = torch.from_numpy(np.array(jax.random.normal(
        rz, (BATCH, SMALL['latent_size']))))
    clip_eps = float(jax.random.normal(rc, ()))
    model = propopt['port'](p)
    total, metrics, aux = model(db, BETA, eps=eps,
                                clip_eps=torch.tensor(clip_eps))
    assert bool(aux['clipped']) and aux['clipped'].dtype == torch.bool
    assert total.item() == pytest.approx(0.5 + 0.5 * clip_eps, abs=1e-7)
    assert total.item() == pytest.approx(float(jl), abs=1e-7)
    _assert_metrics(metrics, jmet)
    total.backward()
    for name, q in model.named_parameters():
        assert q.grad is None or not q.grad.any(), name
    assert all(not np.asarray(v).any() for v in jax.tree.leaves(jg))


# -- the trainer, the optimizer groups, checkpoints, the CLIs ----------------

def test_three_step_trajectory_matches_optax(data, prop):
    """Three ``Trainer.train_step``s of ``hier-prop`` with ε injected
    against the JAX gradients of the same steps under optax's Adam (clip
    20, lr 1e-3): the metrics and each leaf's update, where its gradient is
    not rounding noise, within 1e-3."""
    tx = jax_make_optimizer(lr=1e-3, clip_norm=20.0, anneal_rate=0.9,
                            steps_per_epoch=3)
    p = jax.tree.map(jnp.asarray, prop['params'])
    st = tx.init(p)
    trainer = Trainer(prop['port'](), make_optimizer(
        lr=1e-3, clip_norm=20.0, anneal_rate=0.9, steps_per_epoch=3),
        data['vocab'].mask, beta=BETA, device='cpu')
    for i in range(3):
        rng = jax.random.PRNGKey(20 + i)
        (jl, (jmet, _)), jg = prop['vag'](p, jax.tree.map(
            jnp.asarray, data['jbs'][i]), rng)
        upd, st = tx.update(jg, st, p)
        before = flatten(jax.tree.map(np.asarray, p))
        p = optax.apply_updates(p, upd)
        eps = torch.from_numpy(np.array(jax.random.normal(
            rng, (BATCH, SMALL['latent_size']))))
        mine0 = flatten(to_flax_tree(trainer.model))
        metrics, _ = trainer.train_step(trainer.device_batch(
            trainer.host_batch(data['mbs'][i])), eps=eps)
        _assert_metrics({k: v for k, v in metrics.items() if k != 'GNorm'},
                        jmet)
        mine = flatten(to_flax_tree(trainer.model))
        theirs = flatten(jax.tree.map(np.asarray, p))
        grads = flatten(jax.tree.map(np.asarray, jg))
        top = max(np.linalg.norm(g) for g in grads.values())
        for k, g in grads.items():
            if np.linalg.norm(g) < 1e-6 * top:
                continue
            want = theirs[k] - before[k]
            got = mine[k] - mine0[k]
            assert np.linalg.norm(got - want) <= UPDATE_RTOL * \
                np.linalg.norm(want), (i, k)


def test_group_routing_matches_jax(data):
    """``default_group_fn`` routes every ``hier-prop-opt`` parameter to the
    group JAX's ``default_group_fn`` gives its flax path (``hier/E_c`` and
    ``hier/E_i`` in ``decoder``), and ``MultiAdam`` gives each group its
    parameters."""
    model = HierPropOptVAE(_config(data))
    paths = flatten(to_flax_tree(model))
    names = dict(model.named_parameters())
    for path in paths:
        *mods, leaf = path.split('/')[1:]
        key = "".join(f"['{m}']" for m in ['params', *mods, leaf])
        name = '.'.join(mods + [{'kernel': 'weight',
                                 'embedding': 'weight'}.get(leaf, leaf)])
        assert name in names
        assert default_group_fn(name) == jax_group_fn(key), path
    assert default_group_fn('hier.E_c.weight') == 'decoder'
    st = make_multi_optimizer(default_group_fn, {
        g: 1e-3 for g in ('encoder', 'decoder', 'homo', 'lumo')}).attach(
        names)
    assert {g: len(s.params) for g, s in st.groups.items()} == {
        g: sum(default_group_fn(n) == g for n in names)
        for g in ('encoder', 'decoder', 'homo', 'lumo')}


@pytest.mark.parametrize('cls', [HierPropertyVAE, HierPropOptVAE],
                         ids=['hier-prop', 'hier-prop-opt'])
def test_checkpoint_round_trip_through_flax(data, tmp_path, cls):
    """A checkpoint the port saves loads into the JAX model's own param
    template (flax's reader, the template from ``jax.eval_shape`` of the
    JAX init) and back into the port, unchanged."""
    cfg = _config(data)
    model = _port(cls, cfg, _small_params(cls, cfg, 2))
    path = str(tmp_path / 'model.0')
    ckpt.save_params(to_flax_tree(model), path)
    jcls = JaxHierPropertyVAE if cls is HierPropertyVAE else \
        JaxHierPropOptVAE
    jb = jax.tree.map(jnp.asarray, data['jbs'][0])
    shapes = jax.eval_shape(
        lambda: jcls(cfg=_jax_config(data)).init(
            {'params': jax.random.PRNGKey(0),
             'dropout': jax.random.PRNGKey(1)}, jb, BETA,
            jax.random.PRNGKey(2), True, True))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jparams = jax_ckpt.load_params(template, path)
    mine = flatten(to_flax_tree(model))
    theirs = flatten(jax.tree.map(np.asarray, jparams))
    assert set(mine) == set(theirs)
    assert all(np.array_equal(mine[k], theirs[k]) for k in mine)
    back = cls(cfg)
    load_flax_params(back, ckpt.load_params(to_flax_tree(back), path))
    assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                 model.state_dict().values()))


def _cli_files(data, tmp_path):
    vocab_file = tmp_path / 'vocab.txt'
    vocab_file.write_text(''.join(f'{a} {b}\n'
                                  for a, b in data['vocab'].vocab))
    csv_file = tmp_path / 'data.csv'
    with open(csv_file, 'w') as f:
        f.write('SMILES,HOMO,LUMO\n')
        f.writelines(f'{s},{h},{l}\n' for s, h, l in data['rows'][:2 * BATCH])
    cfg = dict(vocab_=str(vocab_file), save_dir=str(tmp_path / 'out'),
               batch_size=BATCH, epoch=1, print_iter=1, seed=2, **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    return str(tmp_path / 'cfg.json'), str(csv_file)


def test_vae_train_cli_hier_prop_one_epoch(data, tmp_path, capsys):
    """``vae_train --model-type hier-prop`` trains one epoch on the CPU
    and writes a checkpoint the JAX package's reader loads."""
    cfg, csv_file = _cli_files(data, tmp_path)
    model = vae_train.main(['--path-to-config', cfg, '--model-type',
                            'hier-prop', '--data-csv', csv_file, '--device',
                            'cpu'])
    assert isinstance(model, HierPropertyVAE)
    assert '[1] Beta' in capsys.readouterr().out
    tree = jax_ckpt.load_params(jax.tree.map(np.asarray, to_flax_tree(
        model)), str(tmp_path / 'out' / 'model.0'))
    for k, v in flatten(jax.tree.map(np.asarray, tree)).items():
        assert np.isfinite(v).all(), k


def test_fine_tune_cli_hier_propopt_one_epoch(data, tmp_path, capsys):
    """``vae_fine_tune --model-type hier-prop-opt --indv-opt`` fine-tunes
    one epoch on the CPU, validating on the same CSV, with one Adam a
    group."""
    cfg, csv_file = _cli_files(data, tmp_path)
    spec = json.loads(open(cfg).read())
    spec.update(data=csv_file, val_data=csv_file, homo_lr=5e-4)
    open(cfg, 'w').write(json.dumps(spec))
    model = vae_fine_tune.main(['--path-to-config', cfg, '--model-type',
                                'hier-prop-opt', '--indv-opt', '--device',
                                'cpu'])
    assert isinstance(model, HierPropOptVAE)
    out = capsys.readouterr().out
    assert 'val ' in out and 'HOMO_MSE' in out
    assert (tmp_path / 'out' / 'model.0').exists()
    assert (tmp_path / 'out' / 'model.best').exists()


def _mu_by_leaf(opt_state):
    """Adam's first moment per flax leaf, across the groups of an
    ``optax.multi_transform`` state, or of a single chain's."""
    if not hasattr(opt_state, 'inner_states'):
        return {k: np.asarray(v) for k, v in flatten(opt_state[1].mu).items()}
    out = {}
    for st in opt_state.inner_states.values():
        for k, v in flatten(st.inner_state[1].mu).items():
            if not isinstance(v, optax.MaskedNode):
                out[k] = np.asarray(v)
    return out


def jax_reference(finetune: bool = False):
    """The JAX package's first 3 steps of the hier family on the first three
    HOPV batches of 20 in the hier vocab (padded, unpacked), at dropout 0
    with the latent's mean: ``hier-prop`` from the trained checkpoint with
    ``profile_train.OPTIMIZER``, or with ``finetune`` ``hier-prop-opt``
    (``profile_train.hier_model``: the checkpoint under ``hier/``, property
    heads from the port's flax-style init seeded with ``HEADS_SEED``) with
    one Adam a group at ``FINETUNE_LRS``.  Per-step metrics, per leaf the
    update along the gradient and the gradient's norm (read from Adam's
    first moment; no clip binds), and for the fine-tune each group's
    gradient norm."""
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        jvocab, _ = jax_load_vocab(HIER_VOCAB)
        vocab = profile_train.load_vocab_file(HIER_VOCAB)
        rows = profile_train.hopv_rows(vocab)
        batches = [jax_batching.to_model_batch(jax_batching.pad_batch(
            jax_mg.tensorize(rows[20 * i:20 * i + 20], jvocab, jax_avocab)),
            jvocab.mask, pad=False)
            for i in range(profile_train.GOLDEN_STEPS)]
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = jvocab.size()
    cfg = JaxModelConfig(hvocab_size=hv, ivocab_size=iv, **TRAINED)
    opt_kw = {k: v for k, v in profile_train.OPTIMIZER.items() if k != 'lr'}
    if finetune:
        jmodel = JaxHierPropOptVAE(cfg=cfg)
        params = to_flax_tree(profile_train.hier_model(True, vocab)[0])
        tx = jax_multi(jax_group_fn, profile_train.FINETUNE_LRS, **opt_kw)
    else:
        jmodel = JaxHierPropertyVAE(cfg=cfg)
        params = read_checkpoint(HIER_CKPT)
        tx = jax_make_optimizer(**profile_train.OPTIMIZER)
    step = make_train_step(jmodel, tx, beta=profile_train.BETA,
                           perturb_z=False)
    p = jax.tree.map(jnp.asarray, params)
    st = tx.init(p)
    rng = jax.random.PRNGKey(0)
    mu_prev = {k: 0.0 for k in flatten(params)}
    steps = []
    for i, b in enumerate(batches):
        before = flatten(jax.tree.map(np.array, p))
        p, st, metrics, _, rng = step(p, st, jax.tree.map(jnp.asarray, b),
                                      rng, float(i))
        after = flatten(jax.tree.map(np.array, p))
        mu = _mu_by_leaf(st)
        grad = {k: (mu[k] - 0.9 * mu_prev[k]) / 0.1 for k in mu}
        mu_prev = mu
        steps.append(dict(
            {k: float(v) for k, v in sorted(metrics.items())},
            update_norms=profile_train.update_norms(before, after, grad),
            grad_norms={k: float(np.linalg.norm(v))
                        for k, v in grad.items()}))
        if finetune:
            groups = {}
            for k, v in grad.items():
                g = jax_group_fn(k)
                groups[g] = groups.get(g, 0.0) + float(
                    (v.astype(np.float64) ** 2).sum())
            assert all(np.sqrt(v) < opt_kw['clip_norm']
                       for v in groups.values())
            steps[-1]['group_norms'] = {g: float(np.sqrt(v))
                                        for g, v in sorted(groups.items())}
    out = dict(checkpoint='runs/QUALITY_hier_hopv.json.ckpt',
               vocab='runs/QUALITY_hier_hopv.json.vocab.txt',
               data='data/hopv15.csv', batch_size=20,
               model='hier-prop-opt' if finetune else 'hier-prop',
               config=TRAINED, beta=profile_train.BETA, steps=steps)
    if finetune:
        out.update(heads_seed=profile_train.HEADS_SEED,
                   lrs=profile_train.FINETUNE_LRS, optimizer=opt_kw)
    else:
        out.update(optimizer=profile_train.OPTIMIZER)
    return out



@pytest.fixture(scope='module', params=[False, True],
                ids=['hier-prop', 'hier-prop-opt'])
def golden(request):
    with open(GOLDENS[request.param]) as f:
        return request.param, json.load(f)


@pytest.mark.slow
def test_golden_is_the_jax_reference(golden):
    """The committed golden is what the JAX package computes now (about 2
    minutes a golden on the CPU: hence ``slow``)."""
    finetune, got = golden
    want = jax_reference(finetune)
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


@pytest.mark.slow
def test_port_on_the_cpu_meets_the_golden(golden):
    """chip_smoke.py's hier golden steps on the CPU: the port's 3 steps at
    full width held to the golden by ``profile_train``'s rule for it
    (about 40 s a step on one thread: hence ``slow``)."""
    finetune, want = golden
    got = profile_train.golden_steps('cpu', finetune=finetune, hier=True)
    assert profile_train.check_golden(got, want, **profile_train.hier_rule(finetune)) == []
    if finetune:
        for g in got:
            assert set(g['group_norms']) == {'encoder', 'decoder', 'homo',
                                             'lumo'}


@pytest.mark.parametrize('off', [0.01, 0.03])
def test_golden_rule_holds_the_assembly_within_its_ties(golden, off):
    """``check_golden`` passes a hier golden's own steps; an assembly
    accuracy off by 0.01 (about one tie of a step's events) passes, and
    one off by 0.03 fails, at every step."""
    finetune, want = golden
    steps = [dict(s) for s in want['steps']]
    assert profile_train.check_golden(steps, want, **profile_train.hier_rule(finetune)) == []
    steps = [dict(s, Assm=s['Assm'] - off) for s in steps]
    bad = profile_train.check_golden(steps, want, **profile_train.hier_rule(finetune))
    assert bad == ([] if off < profile_train.HIER_ASSM_ATOL else [
        f'step {i + 1} Assm: {s["Assm"]} vs {w["Assm"]}'
        for i, (s, w) in enumerate(zip(steps, want['steps']))])

if __name__ == '__main__':
    for ft, path in GOLDENS.items():
        with open(path, 'w') as f:
            json.dump(jax_reference(ft), f, indent=1)
            f.write('\n')
