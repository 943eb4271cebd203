"""The port's training path against the JAX package's, on the CPU, and the
JAX reference steps that chip_smoke.py holds the card's training to.

Small width (hidden = embed = 32, latent 8, depthT 3, dropout 0) with the
same params in both packages (a flax init with noise on every leaf, through
the bridge), on lane-packed and unpacked batches of 8 molecules of
``data/chem_data/train.csv``.  The JAX model is built here and called
directly (``PropertyVAE.apply``, ``make_train_step``): the JAX fixtures and
CLI tests read reference data absent from the test machines.

Tolerances: values of the transpose gathers within 1e-6 and their
gradients within 1e-5 (sums of a few terms in another order); losses and
KL within 1e-5 relative and accuracies exact; each gradient leaf within
1e-4 of its largest entry in magnitude, or of 1e-3 of the largest entry of
any leaf for a leaf whose exact gradient is zero (``decoder/W_assm/bias``:
the assembly loss's terms cancel in it, leaving rounding noise of 1e-9);
updates of a 3-step trajectory within 1e-3 per leaf,
``‖Δport − Δjax‖ / ‖Δjax‖``, for every leaf whose gradient is not
rounding noise (Adam turns noise of either sign into a step of about the
learning rate).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train.py

rewrites ``ggpm_tpu_torch/goldens/train_hopv.json`` from the JAX package.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models.decoder import MotifDecoder as JaxMotifDecoder
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropertyVAE as JaxPropertyVAE
from ggpm_tpu.ops import graph_ops as jax_ops
from ggpm_tpu.train import checkpoint as jax_ckpt
from ggpm_tpu.train.loop import MetricAccumulator as JaxMetricAccumulator
from ggpm_tpu.train.loop import Trainer as JaxTrainer
from ggpm_tpu.train.loop import (make_eval_step, make_scan_train_step,
                                 make_train_step)
from ggpm_tpu.train.optim import make_optimizer as jax_make_optimizer
from ggpm_tpu_torch import kernel_bench, profile_train
from ggpm_tpu_torch.bridge import (flatten, load_flax_params,
                                   msgpack_serialize, read_checkpoint,
                                   to_flax_tree)
from ggpm_tpu_torch.cli import vae_train
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.graph.mol_graph import MolGraph, tensorize
from ggpm_tpu_torch.graph.vocab import PairVocab, common_atom_vocab
from ggpm_tpu_torch.models.vae import ModelConfig, PropertyVAE, init_params
from ggpm_tpu_torch.ops import gather_nd_t, nei_sum_t, graph_ops
from ggpm_tpu_torch.train import checkpoint as ckpt
from ggpm_tpu_torch.train.loop import Trainer, signature, to_device
from ggpm_tpu_torch.train.optim import make_optimizer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CSV = os.path.join(ROOT, 'data', 'chem_data', 'train.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens', 'train_hopv.json')
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3)
BATCH = 8
N_MOLS = 48
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-3


def _rows():
    with open(TRAIN_CSV) as f:
        return [[r['SMILES'].strip(), float(r['HOMO']), float(r['LUMO'])]
                for r in csv.DictReader(f)][:N_MOLS]


@pytest.fixture(scope='module')
def jax_fragments():
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


@pytest.fixture(scope='module')
def data(jax_fragments):
    """Vocabularies over the first 48 molecules of train.csv (no
    fragments), and each package's padded batches of 8 of them."""
    jax_mg.MolGraph.FRAGMENTS = set()
    rows = _rows()
    labels = set()
    for s, _, _ in rows:
        for _, d in MolGraph(s, frozenset()).mol_tree.nodes(data=True):
            labels.add(d['label'])
            labels.update((d['smiles'], a) for _, a in d['inter_label'])
    pairs = sorted(labels)
    jvocab, vocab = JaxPairVocab(pairs), PairVocab(pairs)
    groups = [rows[i:i + BATCH] for i in range(0, N_MOLS, BATCH)]
    jmbs = [jax_batching.pad_batch(jax_mg.tensorize(g, jvocab, jax_avocab))
            for g in groups]
    mbs = [batching.pad_batch(tensorize(g, vocab, common_atom_vocab))
           for g in groups]
    hv, iv = vocab.size()
    return dict(jvocab=jvocab, vocab=vocab, jmbs=jmbs, mbs=mbs, hv=hv, iv=iv)


def _model_batch(d, i, packed):
    """The i-th batch as each package's model-batch dict."""
    jb = jax_batching.to_model_batch(d['jmbs'][i], d['jvocab'].mask,
                                     pad=False)
    pb = batching.to_model_batch(d['mbs'][i], d['vocab'].mask, pad=False)
    if packed:
        jb = dict(jb, plan=jax_batching.compact_plan_dict(
            {k: np.asarray(v) for k, v in jb['plan'].items()}))
        pb = dict(pb, plan=batching.compact_plan_dict(
            {k: np.asarray(v) for k, v in pb['plan'].items()}))
    return jb, pb


def _noisy_params(model, batch, seed=0):
    key = jax.random.PRNGKey(seed)
    params = model.init({'params': key, 'dropout': key},
                        jax.tree.map(jnp.asarray, batch), 0.1, key, False,
                        True)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
        0, 0.1, x.shape)).astype(np.float32), params)


@pytest.fixture(scope='module')
def models(data):
    """The small JAX ``PropertyVAE``, its params, and a port model factory
    loading the same params."""
    cfg = dict(hvocab_size=data['hv'], ivocab_size=data['iv'], **SMALL)
    jmodel = JaxPropertyVAE(cfg=JaxModelConfig(rnn_type='LSTM', dropout=0.0,
                                               **cfg))
    params = _noisy_params(jmodel, _model_batch(data, 0, True)[0])

    def port(tree=params):
        model = PropertyVAE(ModelConfig(**cfg))
        load_flax_params(model, tree)
        return model
    return dict(jmodel=jmodel, params=params, port=port, cfg=cfg)


def _port_grads(model):
    """The port model's gradients in the JAX layout (zeros where a
    parameter got none)."""
    return flatten(to_flax_tree(model, lambda p: p.grad))


def _assert_grads(ours, theirs):
    theirs = flatten(jax.tree.map(np.asarray, theirs))
    assert set(ours) == set(theirs)
    top = max(np.abs(v).max() for v in theirs.values())
    for k, v in theirs.items():
        scale = max(np.abs(v).max(), 1e-3 * top)
        np.testing.assert_allclose(ours[k], v, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


# -- the transpose gathers -------------------------------------------------

def _tables(d):
    """(name, table [N, A], source rows) at every call site of a training
    step, from a packed batch."""
    _, pb = _model_batch(d, 1, True)
    t = batching.train_tables(pb)
    tree, plan = t['tree'], t['plan']
    n_mess = tree['fmess'].shape[0]
    return {'agraph': (tree['agraph'], n_mess),
            'root': (tree['agraph'][tree['scope'][:, 0]], n_mess),
            'bgraph': (tree['bgraph'], n_mess),
            'frontier': (plan['frontier'],
                         n_mess + len(plan['root_clab']))}


@pytest.mark.parametrize('site', ['agraph', 'root', 'bgraph', 'frontier'])
@pytest.mark.parametrize('op', ['nei_sum_t', 'gather_nd_t'])
def test_transpose_gathers_match_jax_vjp(data, op, site):
    """Values and gradients of ``nei_sum_t``/``gather_nd_t`` at each call
    site's table against ``jax.vjp`` of the JAX functions, with row 0 of
    the source zero as at every call site."""
    graph, m = _tables(data)[site]
    t_idx, t_mask = graph_ops.build_transpose(graph, m)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(m, 20)).astype(np.float32)
    h[0] = 0
    jfn = getattr(jax_ops, op)
    out, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(graph), t_idx, t_mask),
                       jnp.asarray(h))
    cot = rng.normal(size=out.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(cot))
    fn = nei_sum_t if op == 'nei_sum_t' else gather_nd_t
    x = torch.from_numpy(h).requires_grad_()
    ours = fn(x, torch.from_numpy(graph), torch.from_numpy(t_idx),
              torch.from_numpy(t_mask))
    ours.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-5)
    # and the plain gather's own gradient wherever row 0 is not involved
    y = torch.from_numpy(h).requires_grad_()
    plain = y[torch.from_numpy(graph).long()]
    (plain.sum(-2) if op == 'nei_sum_t' else plain).backward(
        torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy()[1:], y.grad.numpy()[1:],
                               rtol=0, atol=1e-5)
    assert not x.grad[0].any()


def test_transpose_sum_plain_matches_in_order_sum():
    """The plain transpose (``graph_ops.transpose_sum``) is the masked sum
    of the kernel's definition, for div 1 and div A."""
    rng = np.random.default_rng(4)
    graph = rng.integers(0, 30, (40, 5)).astype(np.int32)
    t_idx, t_mask = graph_ops.build_transpose(graph, 30)
    for div, rows in ((1, 200), (5, 40)):
        g = torch.from_numpy(rng.normal(size=(rows, 7)).astype(np.float32))
        out = graph_ops.transpose_sum(g, torch.from_numpy(t_idx),
                                      torch.from_numpy(t_mask), div)
        want = torch.zeros_like(out)
        for mrow in range(t_idx.shape[0]):
            for k in range(t_idx.shape[1]):
                if t_mask[mrow, k]:
                    want[mrow] += g[t_idx[mrow, k] // div]
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_scatter_rows_and_zero_row0_match_jax():
    """The out-of-place row writes: values, and gradients through them."""
    rng = np.random.default_rng(8)
    buf = rng.normal(size=(9, 4)).astype(np.float32)
    rows = rng.normal(size=(3, 4)).astype(np.float32)
    index = np.array([4, 0, 7], np.int32)
    jfn = lambda b, r: jax_ops.scatter_rows(b, jnp.asarray(index), r)
    want, vjp = jax.vjp(jfn, jnp.asarray(buf), jnp.asarray(rows))
    cot = rng.normal(size=want.shape).astype(np.float32)
    gb, gr = vjp(jnp.asarray(cot))
    b, r = (torch.from_numpy(x).requires_grad_() for x in (buf, rows))
    got = graph_ops.scatter_rows(b, torch.from_numpy(index), r)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(b.grad.numpy(), np.asarray(gb))
    np.testing.assert_array_equal(r.grad.numpy(), np.asarray(gr))
    z = torch.from_numpy(buf).requires_grad_()
    graph_ops.zero_row0(z).backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(z.grad.numpy(), np.asarray(jax.vjp(
        jax_ops.zero_row0, jnp.asarray(buf))[1](jnp.asarray(cot))[0]))


# -- batches ---------------------------------------------------------------

@pytest.fixture(scope='module')
def hopv(jax_fragments):
    """The first three HOPV batches of 20 in each package, padded as the
    CLI pads them, with the trained model's vocab."""
    jvocab, _ = jax_load_vocab(profile_train.VOCAB)
    vocab, mbs = profile_train.hopv_batches(3)
    rows = profile_train.hopv_rows(vocab)
    jmbs = [jax_batching.pad_batch(jax_mg.tensorize(
        rows[20 * i:20 * i + 20], jvocab, jax_avocab)) for i in range(3)]
    return dict(jvocab=jvocab, vocab=vocab, jmbs=jmbs, mbs=mbs)


@pytest.mark.parametrize('i', [0, 1, 2])
def test_compact_plan_dict_matches_jax(hopv, i):
    jb = jax_batching.to_model_batch(hopv['jmbs'][i], hopv['jvocab'].mask,
                                     pad=False)
    pb = batching.to_model_batch(hopv['mbs'][i], hopv['vocab'].mask,
                                 pad=False)
    jp = jax_batching.compact_plan_dict(
        {k: np.asarray(v) for k, v in jb['plan'].items()})
    pp = batching.compact_plan_dict(
        {k: np.asarray(v) for k, v in pb['plan'].items()})
    assert sorted(jp) == sorted(pp)
    for k in jp:
        np.testing.assert_array_equal(pp[k], jp[k], err_msg=k)
    assert pp['mess'].shape[1] < pb['plan']['mess'].shape[1]


def test_frontier_table_is_the_masked_readout(data):
    """``nei_sum`` over ``frontier_table`` equals the JAX scan's
    visibility-masked readout over a state whose row 0 is zero."""
    jb, pb = _model_batch(data, 2, True)
    tree, plan = jb['tree'], jb['plan']
    n_rows = tree['fmess'].shape[0] + len(plan['root_clab'])
    T, L = plan['mess'].shape
    rng = np.random.default_rng(5)
    h = rng.normal(size=(n_rows, 6)).astype(np.float32)
    h[0] = 0
    never = T + 1
    ws = np.full(n_rows, never)
    ws[tree['fmess'].shape[0]:] = -1
    valid = plan['mess'] > 0
    ws[plan['mess'][valid]] = np.broadcast_to(np.arange(T)[:, None],
                                              (T, L))[valid]
    ag = tree['agraph_dec'][plan['xid']]
    vis = ws[ag] <= np.arange(T)[:, None, None]
    want = (h[ag] * vis[..., None]).sum(-2).reshape(T * L, -1)
    fr = batching.frontier_table(pb['tree'], pb['plan'])
    got = graph_ops.nei_sum(torch.from_numpy(h), torch.from_numpy(fr))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- the decoder and the whole model ---------------------------------------

@pytest.mark.parametrize('packed', [False, True], ids=['unpacked', 'packed'])
def test_decoder_loss_and_grads_match_jax(data, models, packed):
    """``MotifDecoder.forward`` and ``mean_forward``: loss, accuracies,
    per-sample losses, and the gradient of every decoder parameter and of
    the latent."""
    jb, pb = _model_batch(data, 1, packed)
    B = len(pb['plan']['root_clab'])
    z = np.random.default_rng(6).normal(
        size=(B, SMALL['latent_size'])).astype(np.float32)
    cfg = models['cfg']
    jdec = JaxMotifDecoder(hvocab_size=cfg['hvocab_size'],
                           ivocab_size=cfg['ivocab_size'], atom_vocab_size=38,
                           embed_size=SMALL['embed_size'],
                           hidden_size=SMALL['hidden_size'],
                           latent_size=SMALL['latent_size'])
    full = models['params']['params']
    dparams = {'params': dict(full['decoder'], E_c_mod=full['E_c'],
                              E_i_mod=full['E_i'])}
    jbd = jax.tree.map(jnp.asarray, jb)

    def jloss(p, zz):
        loss, metrics, per = jdec.apply(p, jbd['tree'], jbd['plan'], zz,
                                        jbd['vocab_mask'],
                                        method=JaxMotifDecoder.mean_forward)
        return loss, (metrics, per)
    (jl, (jm, jper)), (jg, jgz) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(dparams, jnp.asarray(z))

    model = models['port']()
    dev = to_device(batching.train_tables(pb), 'cpu')
    zt = torch.from_numpy(z).requires_grad_()
    loss, metrics, per = model.decoder.mean_forward(
        dev['tree'], dev['plan'], zt, dev['vocab_mask'])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper),
                               rtol=LOSS_RTOL, atol=1e-5)
    for k, v in jm.items():
        assert float(metrics[k]) == pytest.approx(float(v), abs=1e-7), k
    plain, _ = model.decoder(dev['tree'], dev['plan'], zt.detach(),
                             dev['vocab_mask'])
    np.testing.assert_allclose(plain.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgz), rtol=0,
                               atol=GRAD_RTOL * np.abs(jgz).max())
    ours = {k: v for k, v in _port_grads(model).items()
            if k.startswith('params/decoder/')}
    jg = jg['params']
    want = {'params': {'decoder': {k: v for k, v in jg.items()
                                   if not k.endswith('_mod')}}}
    _assert_grads(ours, want)
    _assert_grads({k: v for k, v in _port_grads(model).items()
                   if k.split('/')[1] in ('E_c', 'E_i')},
                  {'params': {'E_c': jg['E_c_mod'], 'E_i': jg['E_i_mod']}})


@pytest.mark.parametrize('noise', ['mean', 'same-eps'])
@pytest.mark.parametrize('packed', [False, True], ids=['unpacked', 'packed'])
def test_property_vae_loss_and_grads_match_jax(data, models, packed, noise):
    """``PropertyVAE.forward``: total loss, KL, accuracies and every
    parameter's gradient, with the latent's mean, then with the noise JAX
    draws injected into the port."""
    jb, pb = _model_batch(data, 2, packed)
    jm, params = models['jmodel'], models['params']
    rng = jax.random.PRNGKey(11)
    perturb = noise == 'same-eps'
    jbd = jax.tree.map(jnp.asarray, jb)

    def jloss(p):
        total, metrics, _ = jm.apply(p, jbd, 0.1, rng, perturb, True)
        return total, metrics
    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    eps = None
    if perturb:
        B = len(pb['plan']['root_clab'])
        eps = torch.from_numpy(np.array(jax.random.normal(
            rng, (B, SMALL['latent_size']))))
    model = models['port']()
    total, metrics, aux = model(to_device(batching.train_tables(pb), 'cpu'),
                                0.1, eps=eps, perturb_z=perturb)
    total.backward()
    assert aux == {'clipped': False}
    assert set(metrics) == set(jmet)
    np.testing.assert_allclose(total.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics['KL'].item(), float(jmet['KL']),
                               rtol=LOSS_RTOL)
    for k in ('Word', 'I-Word', 'Topo', 'Assm'):
        assert float(metrics[k]) == pytest.approx(float(jmet[k]), abs=1e-7)
    _assert_grads(_port_grads(model), jg)


# -- optimizer and trajectories --------------------------------------------

def _leaf_updates(before, after):
    return {k: np.asarray(after[k], np.float64) - np.asarray(before[k],
                                                             np.float64)
            for k in before}


def _noise(grads, masks=None):
    """Per leaf, the entries whose gradient is rounding noise (below 1e-6
    of the whole gradient's norm, exact zeros included), or'ed into
    ``masks`` from earlier steps: Adam's moments carry a noisy step on."""
    total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                        for v in grads.values()))
    masks = dict(masks or {})
    for k, v in grads.items():
        m = np.abs(v) < 1e-6 * total
        masks[k] = m | masks[k] if k in masks else m
    return masks


def _assert_updates(ours, theirs, noise):
    """``‖Δport − Δjax‖ ≤ 1e-3 ‖Δjax‖`` per leaf over its entries that
    are not noise."""
    for k, d in theirs.items():
        keep = ~noise[k]
        den = np.linalg.norm(d[keep])
        err = np.linalg.norm(ours[k][keep] - d[keep])
        assert err <= UPDATE_RTOL * den, (k, err, den)


@pytest.mark.parametrize('clip', [20.0, 0.5])
def test_adam_matches_optax(clip):
    """Three updates of random gradients, clipped (0.5) or not (20), with
    the schedule crossing an epoch (steps_per_epoch 2)."""
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = jax_make_optimizer(lr=1e-2, clip_norm=clip, anneal_rate=0.5,
                            steps_per_epoch=2)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    state = make_optimizer(lr=1e-2, clip_norm=clip, anneal_rate=0.5,
                           steps_per_epoch=2).attach(ps)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x)
        gnorm = state.step()
        np.testing.assert_allclose(float(gnorm), np.sqrt(sum(
            (x.astype(np.float64) ** 2).sum() for x in g)), rtol=1e-6)
        for p, q in zip(ps, jp):
            # a few ulps: the moments are rounded in another order
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       rtol=1e-6, atol=1e-7)


def _jax_steps(jmodel, params, batches, opt_kw, steps_per_epoch):
    tx = jax_make_optimizer(steps_per_epoch=steps_per_epoch, **opt_kw)
    step = make_train_step(jmodel, tx, beta=0.1, perturb_z=False)
    p = jax.tree.map(jnp.asarray, params)
    st = tx.init(p)
    rng = jax.random.PRNGKey(0)
    out = []
    for i, b in enumerate(batches):
        before = flatten(jax.tree.map(np.array, p))
        p, st, metrics, _, rng = step(p, st, jax.tree.map(jnp.asarray, b),
                                      rng, float(i))
        out.append((before, flatten(jax.tree.map(np.array, p)),
                    {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.mark.parametrize('clip', [20.0, 1.0])
def test_three_step_trajectory_matches_jax(data, models, clip):
    """Three Trainer steps on three packed batches against JAX's
    ``make_train_step(..., perturb_z=False)``: per-step losses, metrics
    and ``GNorm``, and every leaf's update.  At clip 1.0 every step is
    clipped."""
    pairs = [_model_batch(data, i, True) for i in range(3)]
    jsteps = _jax_steps(models['jmodel'], models['params'],
                        [j for j, _ in pairs], dict(lr=1e-3, clip_norm=clip),
                        steps_per_epoch=2)
    trainer = Trainer(models['port'](), make_optimizer(
        lr=1e-3, clip_norm=clip, steps_per_epoch=2), data['vocab'].mask,
        perturb_z=False, device='cpu')
    noise = None
    for (_, pb), (before, after, jmet) in zip(pairs, jsteps):
        ours_before = flatten(to_flax_tree(trainer.model))
        if noise is not None:
            for k in before:
                np.testing.assert_allclose(ours_before[k][~noise[k]],
                                           before[k][~noise[k]], rtol=0,
                                           atol=1e-5, err_msg=k)
        metrics, _ = trainer.train_step(trainer.device_batch(pb))
        for k, v in jmet.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=GRAD_RTOL,
                                       err_msg=k)
        if clip < 20:
            assert jmet['GNorm'] > clip
        noise = _noise(_port_grads(trainer.model), noise)
        _assert_updates(
            _leaf_updates(ours_before, flatten(to_flax_tree(trainer.model))),
            _leaf_updates(before, after), noise)


def _jax_trainer_epoch(jmodel, params, jmbs, vocab_mask, scan_chunk):
    tx = jax_make_optimizer(lr=1e-3, steps_per_epoch=len(jmbs))
    tr = JaxTrainer(jmodel, tx, vocab_mask, print_iter=10 ** 6)
    tr.step_fn = make_train_step(jmodel, tx, 0.1, perturb_z=False)
    tr._scan_fn = make_scan_train_step(jmodel, tx, 0.1, perturb_z=False)
    p = jax.tree.map(jnp.asarray, params)
    p, _, stop = tr.train_epoch(p, tx.init(p), jmbs, scan_chunk=scan_chunk)
    assert not stop and tr.total_step == len(jmbs)
    return flatten(jax.tree.map(np.asarray, p))


def test_train_epoch_takes_the_jax_order(data, models):
    """One ``train_epoch`` over batches of two shape signatures, arriving
    A, B, A with scan_chunk 2: both packages step A, A, B.  Stepping in
    arrival order ends elsewhere, so the check can tell the orders
    apart."""
    sigs = []
    for mb in data['mbs']:
        b = batching.to_model_batch(mb, data['vocab'].mask, pad=False)
        sigs.append(signature(dict(b, plan=batching.compact_plan_dict(
            {k: np.asarray(v) for k, v in b['plan'].items()}))))
    a = [i for i in range(len(sigs)) if sigs[i] == sigs[0]]
    b = [i for i in range(len(sigs)) if sigs[i] != sigs[0]]
    assert len(a) >= 2 and b, sigs
    order = [a[0], b[0], a[1]]
    start = models['params']
    want = _jax_trainer_epoch(models['jmodel'], start,
                              [data['jmbs'][i] for i in order],
                              data['jvocab'].mask, scan_chunk=2)

    def port_epoch(batches, chunk):
        tr = Trainer(models['port'](), make_optimizer(
            lr=1e-3, steps_per_epoch=3), data['vocab'].mask, print_iter=10 ** 6,
            perturb_z=False, device='cpu')
        step, masks = tr.train_step, []

        def recording_step(batch):
            out = step(batch)
            masks.append(_noise(_port_grads(tr.model),
                                masks[-1] if masks else None))
            return out
        tr.train_step = recording_step
        assert not tr.train_epoch(batches, scan_chunk=chunk)
        return flatten(to_flax_tree(tr.model)), masks[-1]

    got, noise = port_epoch([data['mbs'][i] for i in order], 2)
    arrival, _ = port_epoch([data['mbs'][i] for i in order], 1)
    init = flatten(jax.tree.map(np.asarray, start))
    want_d, got_d = _leaf_updates(init, want), _leaf_updates(init, got)
    _assert_updates(got_d, want_d, noise)
    arr_d = _leaf_updates(init, arrival)
    worst = max(np.linalg.norm((arr_d[k] - want_d[k])[~noise[k]]) /
                np.linalg.norm(want_d[k][~noise[k]])
                for k in want_d if (~noise[k]).any())
    assert worst > 10 * UPDATE_RTOL


def test_evaluate_matches_jax_eval_step(data, models):
    """``Trainer.evaluate``: the mean metrics of JAX's eval step (no
    noise, no dropout) over the same batches."""
    jm, params = models['jmodel'], models['params']
    step = make_eval_step(jm, 0.1)
    acc = JaxMetricAccumulator()
    for i in (1, 2):
        jb = jax_batching.to_model_batch(data['jmbs'][i], data['jvocab'].mask,
                                         pad=False)
        jb = dict(jb, plan=jax_batching.compact_plan_dict(
            {k: np.asarray(v) for k, v in jb['plan'].items()}))
        acc.add(step(params, jax.tree.map(jnp.asarray, jb),
                     jax.random.PRNGKey(0))[1])
    want = acc.mean()
    tr = Trainer(models['port'](), make_optimizer(), data['vocab'].mask,
                 device='cpu')
    got = tr.evaluate([data['mbs'][1], data['mbs'][2]])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-7), k
    assert not tr.model.training


def test_train_epoch_logs_and_saves(data, models, tmp_path):
    """``print_iter`` and ``save_iter`` boundaries: a log line per print
    boundary with mols/s and the mean metrics, and a checkpoint per save
    boundary that loads back into the model it was taken from."""
    lines = []
    tr = Trainer(models['port'](), make_optimizer(steps_per_epoch=4),
                 data['vocab'].mask, print_iter=2, save_dir=str(tmp_path),
                 save_iter=2, perturb_z=False, device='cpu')
    assert not tr.train_epoch(data['mbs'][:4], log=lines.append,
                              scan_chunk=1)
    assert tr.total_step == 4 and tr.mols_seen == 4 * BATCH
    assert [ln.split(']')[0] for ln in lines] == ['[2', '[4']
    assert all('mols/s' in ln and 'GNorm' in ln and 'Loss' in ln
               for ln in lines)
    assert sorted(os.listdir(tmp_path)) == ['model.0', 'model.1']
    back = models['port'](ckpt.load_params(to_flax_tree(tr.model),
                                           str(tmp_path / 'model.1')))
    for (_, a), (_, b) in zip(back.named_parameters(),
                              tr.model.named_parameters()):
        assert torch.equal(a, b)


# -- checkpoints, init, CLI ------------------------------------------------

@pytest.mark.parametrize('direction', ['port-to-jax', 'jax-to-port'])
def test_checkpoint_round_trip(models, tmp_path, direction):
    path = str(tmp_path / 'model.0')
    params = models['params']
    if direction == 'port-to-jax':
        model = models['port']()
        ckpt.save_params(to_flax_tree(model), path)
        loaded = jax_ckpt.load_params(params, path)
        want = flatten(to_flax_tree(model))
        got = flatten(jax.tree.map(np.asarray, loaded))
    else:
        jax_ckpt.save_params(params, path)
        model = models['port'](ckpt.load_params(to_flax_tree(
            models['port']()), path))
        want = flatten(jax.tree.map(np.asarray, params))
        got = flatten(to_flax_tree(model))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('tree', ['small', 'hopv'])
def test_msgpack_serialize_matches_flax(models, tree):
    """The port writes the bytes flax writes: for the small model's params
    and for the trained HOPV checkpoint (read back, written again)."""
    if tree == 'small':
        t = jax.tree.map(np.asarray, models['params'])
        assert msgpack_serialize(t) == serialization.to_bytes(t)
    else:
        path = profile_train.CKPT
        with open(path, 'rb') as f:
            assert msgpack_serialize(read_checkpoint(path)) == f.read()


def test_copy_matching_and_encoder_match_jax(models):
    src = models['params']
    model = PropertyVAE(ModelConfig(**models['cfg']))
    init_params(model, torch.Generator().manual_seed(3))
    target = to_flax_tree(model)
    jt = jax.tree.map(jnp.asarray, target)
    for ours, theirs in ((ckpt.copy_matching(target, src),
                          jax_ckpt.copy_matching(jt, src)),
                         (ckpt.copy_encoder(target, src),
                          jax_ckpt.copy_encoder(jt, src))):
        assert ours[1] == theirs[1]
        a, b = flatten(ours[0]), flatten(jax.tree.map(np.asarray, theirs[0]))
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ckpt.copy_encoder(target, src)[1] < ckpt.copy_matching(
        target, src)[1]


def test_early_stopping(tmp_path):
    es = ckpt.EarlyStopping(patience=2, path=str(tmp_path / 'best'))
    tree = {'params': {'w': np.ones(3, np.float32)}}
    for loss, stop in ((1.0, False), (0.5, False), (0.7, False),
                       (0.6, True)):
        es(loss, tree)
        assert es.early_stop == stop
    assert es.val_loss_min == 0.5
    assert os.path.exists(tmp_path / 'best')


def test_init_follows_flax_defaults(models):
    """``init_params``: every leaf zero where flax's init is zero, and of
    flax's scale (std within 15 %, truncated at 2 / 0.88 of it) where not;
    the same numbers from the same generator seed."""
    cfg = dict(models['cfg'], embed_size=64, hidden_size=64)
    model = init_params(PropertyVAE(ModelConfig(**cfg)),
                        torch.Generator().manual_seed(0))
    again = init_params(PropertyVAE(ModelConfig(**cfg)),
                        torch.Generator().manual_seed(0))
    for (_, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b)
    ours = flatten(to_flax_tree(model))
    for k, v in ours.items():
        leaf = k.rsplit('/', 1)[1]
        if leaf == 'bias':
            assert not v.any(), k
            continue
        fan = v.shape[0] if leaf == 'kernel' else v.shape[1]
        std = np.sqrt(1.0 / fan)
        if v.size >= 1000:
            assert abs(v.std() / std - 1) < 0.15, k
        if leaf == 'kernel':
            assert np.abs(v).max() <= 2 * std / 0.87962566103423978 + 1e-6


def test_vae_train_cli_one_epoch(data, tmp_path):
    """The port's ``vae_train`` for one epoch on the CPU: it writes a
    checkpoint that the JAX package loads into its own model's params."""
    vocab_file = tmp_path / 'vocab.txt'
    vocab_file.write_text(''.join(f'{a} {b}\n' for a, b in data['vocab'].vocab))
    csv_file = tmp_path / 'data.csv'
    with open(csv_file, 'w') as f:
        f.write('SMILES,HOMO,LUMO\n')
        f.writelines(f'{s},{h},{l}\n' for s, h, l in _rows()[:2 * BATCH])
    cfg = dict(vocab_=str(vocab_file), save_dir=str(tmp_path / 'out'),
               batch_size=BATCH, epoch=1, print_iter=1, seed=2, **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    args = ['--path-to-config', str(tmp_path / 'cfg.json'), '--model-type',
            'prop', '--data-csv', str(csv_file), '--device', 'cpu']
    model = vae_train.main(args)
    path = tmp_path / 'out' / 'model.0'
    assert path.exists() and (tmp_path / 'out' / 'configs.json').exists()
    jparams = jax_ckpt.load_params(jax.tree.map(np.asarray, to_flax_tree(
        model)), str(path))
    for k, v in flatten(jax.tree.map(np.asarray, jparams)).items():
        assert np.isfinite(v).all(), k
    # --n-devices 2 trains in two ranks (tests/test_torch_parallel.py);
    # --tp needs several devices
    with pytest.raises(ValueError, match='several devices'):
        vae_train.main(args + ['--tp', '2'])
    # without --data-csv it reads the config's shards, and this config
    # names none
    with pytest.raises(ValueError, match='no training data'):
        vae_train.main(args[:4] + ['--device', 'cpu'])
    # pretrain -> fine-tune: the encoder of the first run's checkpoint
    cfg.update(saved_model=str(path), load_encoder_only=True, epoch=0,
               save_dir=str(tmp_path / 'out2'))
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    again = vae_train.main(args)
    mine, theirs = (flatten(to_flax_tree(m)) for m in (again, model))
    assert all(np.array_equal(mine[k], theirs[k]) == ('encoder' in k)
               for k in mine if not k.startswith('params/E_'))


@pytest.mark.parametrize('packed', [False, True], ids=['unpacked', 'packed'])
def test_kernel_cases_of_a_training_step(data, packed):
    """The training step's kernel cases that chip_smoke.py times
    (``kernel_bench.train_cases``) on the CPU: every call is its plain
    version, the library yardstick computes the same function, and each
    bound counts bytes."""
    _, pb = _model_batch(data, 3, packed)
    dev = to_device(batching.train_tables(pb), 'cpu')
    cases = kernel_bench.train_cases(dev, torch.Generator().manual_seed(0),
                                     hidden=16)
    assert [c['kernel'] for c in cases] == (
        ['gather_rows'] + ['transpose_sum'] * 4 + ['nei_sum'])
    for c in cases:
        out, ref, lib = c['call'](), c['plain'](), c['library']()
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        torch.testing.assert_close((c['exact'] or c['plain'])(), ref,
                                   rtol=0, atol=1e-6)
        torch.testing.assert_close(lib, ref, rtol=0, atol=1e-5)
        assert c['bytes'] > 0


# -- the full-width reference of chip_smoke.py's train phase ---------------

def jax_reference():
    """The JAX package's first 3 steps of the canonical configuration from
    the ``vae/`` weights of the trained HOPV checkpoint, on the first three
    HOPV batches of 20 (padded, lane-packed), at dropout 0 with the
    latent's mean: per-step metrics, and per leaf the update's norm and the
    norm of the (clipped) gradient, read from Adam's first moment."""
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        jvocab, _ = jax_load_vocab(profile_train.VOCAB)
        vocab = profile_train.load_vocab_file(profile_train.VOCAB)
        rows = profile_train.hopv_rows(vocab)
        batches = []
        for i in range(profile_train.GOLDEN_STEPS):
            mb = jax_batching.pad_batch(jax_mg.tensorize(
                rows[20 * i:20 * i + 20], jvocab, jax_avocab))
            b = jax_batching.to_model_batch(mb, jvocab.mask, pad=False)
            batches.append(dict(b, plan=jax_batching.compact_plan_dict(
                {k: np.asarray(v) for k, v in b['plan'].items()})))
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = jvocab.size()
    jmodel = JaxPropertyVAE(cfg=JaxModelConfig(hvocab_size=hv, ivocab_size=iv))
    params = {'params': read_checkpoint(profile_train.CKPT)['params']['vae']}
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
        mu = flatten(jax.tree.map(np.array, st[1].mu))
        grad = {k: (mu[k] - 0.9 * mu_prev[k]) / 0.1 for k in mu}
        mu_prev = mu
        steps.append(dict(
            {k: float(v) for k, v in sorted(metrics.items())},
            update_norms=profile_train.update_norms(before, after, grad),
            grad_norms={k: float(np.linalg.norm(v)) for k, v in
                        grad.items()}))
    return dict(checkpoint='runs/QUALITY_hopv.json.ckpt (vae/ subtree)',
                vocab='runs/QUALITY_hopv.json.vocab.txt',
                data='data/hopv15.csv', batch_size=20,
                optimizer=profile_train.OPTIMIZER, beta=profile_train.BETA,
                steps=steps)


@pytest.fixture(scope='module')
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_is_the_jax_reference(golden):
    want = jax_reference()
    assert {k: v for k, v in golden.items() if k != 'steps'} == \
        {k: v for k, v in want.items() if k != 'steps'}
    for g, w in zip(golden['steps'], want['steps']):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, dict):
                for leaf, x in v.items():
                    assert g[k][leaf] == pytest.approx(x, rel=1e-5, abs=1e-9)
            else:
                assert g[k] == pytest.approx(v, rel=1e-5), k


def test_port_on_the_cpu_meets_the_golden(golden):
    """chip_smoke.py's train phase on the CPU: the port's 3 steps at full
    width held to the golden by the same rule."""
    got = profile_train.golden_steps('cpu')
    assert profile_train.check_golden(got, golden) == []



@pytest.mark.parametrize('step', [0, 1, 2])
@pytest.mark.parametrize('leaf', ['strong', 'weak'])
def test_golden_rule_holds_the_strong_leaves_of_every_step(golden, step,
                                                          leaf):
    """``check_golden`` on the golden itself passes; an update along the
    gradient off by 2e-3 fails at every step for a leaf whose gradient is
    at least ``STRONG`` of the step's GNorm, and only at step 1 for a
    weaker one."""
    steps = [dict(s) for s in golden['steps']]
    assert profile_train.check_golden(steps, golden) == []
    want = golden['steps'][step]
    floor = profile_train.STRONG * want['GNorm']
    k = next(k for k, w in sorted(want['update_norms'].items())
             if w is not None and
             (want['grad_norms'][k] >= floor) == (leaf == 'strong'))
    w = want['update_norms'][k]
    steps[step] = dict(steps[step], update_norms=dict(
        steps[step]['update_norms'], **{k: w * 1.002}))
    held = step == 0 or leaf == 'strong'
    assert profile_train.check_golden(steps, golden) == (
        [f'step {step + 1} update of {k}: {w * 1.002} vs {w}'] if held
        else [])


def test_gather_case_of_a_serve_tree(hopv):
    """The depth loop's gather case that chip_smoke.py times at the serve
    path's shapes (``kernel_bench.gather_case``) on a tree of numpy arrays:
    its call is the plain copy on the CPU, its library call the same
    function, and its bytes count the distinct rows read."""
    tree = batching.to_model_batch(hopv['mbs'][0], hopv['vocab'].mask,
                                   pad=False)['tree']
    c = kernel_bench.gather_case('serve', tree,
                                 torch.Generator().manual_seed(0), hidden=8)
    out = c['call']()
    assert out.shape == (*tree['bgraph'].shape, 24)
    assert torch.equal(out, c['plain']()) and torch.equal(out, c['library']())
    n = tree['bgraph'].size
    rows = len(np.unique(tree['bgraph']))
    assert c['bytes'] == 4 * (rows * 24 + n + n * 24) and c['ops'] == 0


if __name__ == '__main__':
    with open(GOLDEN, 'w') as f:
        json.dump(jax_reference(), f, indent=1)
        f.write('\n')
