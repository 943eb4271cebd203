"""The port's prop-opt fine-tuning path against the JAX package's, on the
CPU, and the JAX reference steps that chip_smoke.py holds the card's
fine-tuning to.

Small width (hidden = embed = 32, latent 8, depthT 3, dropout 0) with the
same params in both packages (a flax init with noise on every leaf,
through the bridge), on lane-packed batches of 8 molecules of
``data/chem_data/train.csv``, some of them without a HOMO or LUMO label.
The JAX model and ``make_train_step`` are called directly: the JAX CLI
and fixture tests read reference data absent from the test machines.

The full-width CLIs are held in tests/test_torch_cli_opt.py.

Tolerances: losses within 1e-5 relative, the property losses within 1e-5
relative or 1e-9 absolute; each gradient leaf within 1e-4 of its largest
entry in magnitude (or of 1e-3 of the largest entry of any leaf);
optimizer steps of random gradients within 1e-6 relative or 2e-7.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_propopt.py

rewrites ``ggpm_tpu_torch/goldens/train_propopt_hopv.json`` from the JAX
package.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropOptVAE as JaxPropOptVAE
from ggpm_tpu.train import checkpoint as jax_ckpt
from ggpm_tpu.train.loop import init_params_on_cpu, make_train_step
from ggpm_tpu.train.optim import default_group_fn as jax_group_fn
from ggpm_tpu.train.optim import make_multi_optimizer as jax_multi
from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import (flatten, load_flax_params, load_model,
                                   msgpack_serialize, read_checkpoint,
                                   to_flax_tree)
from ggpm_tpu_torch.cli import vae_fine_tune, vae_fine_tune_indv_opt
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.graph.mol_graph import MolGraph, tensorize
from ggpm_tpu_torch.graph.vocab import PairVocab, common_atom_vocab
from ggpm_tpu_torch.models.vae import (ModelConfig, PropertyVAE, PropOptVAE,
                                       init_params)
from ggpm_tpu_torch.train import checkpoint as ckpt
from ggpm_tpu_torch.train.loop import Trainer, count_clipped, to_device
from ggpm_tpu_torch.train.optim import (default_group_fn,
                                        make_multi_optimizer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CSV = os.path.join(ROOT, 'data', 'chem_data', 'train.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'train_propopt_hopv.json')
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3,
             linear_hidden_size=16)
BATCH = 8
N_MOLS = 32
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# rows without a label: HOMO of 3 and 9, LUMO of 5 and 9
NO_HOMO, NO_LUMO = (3, 9), (5, 9)


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rows():
    with open(TRAIN_CSV) as f:
        rows = [[r['SMILES'].strip(), float(r['HOMO']), float(r['LUMO'])]
                for r in csv.DictReader(f)][:N_MOLS]
    for i in NO_HOMO:
        rows[i][1] = None
    for i in NO_LUMO:
        rows[i][2] = None
    return rows


@pytest.fixture(scope='module')
def jax_fragments():
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


@pytest.fixture(scope='module')
def data(jax_fragments):
    """Vocabularies over the molecules (no fragments), and each package's
    model batches of 8 of them, lane-packed."""
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
    mbs = [batching.pad_batch(tensorize(g, vocab, common_atom_vocab))
           for g in groups]
    jbs, pbs = [], []
    for g, mb in zip(groups, mbs):
        jmb = jax_batching.pad_batch(jax_mg.tensorize(g, jvocab, jax_avocab))
        jb = jax_batching.to_model_batch(jmb, jvocab.mask, pad=False)
        pb = batching.to_model_batch(mb, vocab.mask, pad=False)
        jbs.append(dict(jb, plan=jax_batching.compact_plan_dict(
            {k: np.asarray(v) for k, v in jb['plan'].items()})))
        pbs.append(dict(pb, plan=batching.compact_plan_dict(
            {k: np.asarray(v) for k, v in pb['plan'].items()})))
    hv, iv = vocab.size()
    return dict(rows=rows, pairs=pairs, jvocab=jvocab, vocab=vocab, mbs=mbs,
                jbs=jbs, pbs=pbs, hv=hv, iv=iv)


def _noisy_params(model, batch, seed=0):
    key = jax.random.PRNGKey(seed)
    params = init_params_on_cpu(model, batch, key)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
        0, 0.1, x.shape)).astype(np.float32), params)


def _models(data, scaling):
    cfg = dict(hvocab_size=data['hv'], ivocab_size=data['iv'], **SMALL)
    jmodel = JaxPropOptVAE(cfg=JaxModelConfig(
        rnn_type='LSTM', dropout=0.0, loss_scaling=scaling, **cfg))
    params = _noisy_params(jmodel, data['jbs'][0])

    def port(tree=params):
        model = PropOptVAE(ModelConfig(loss_scaling=scaling, **cfg))
        load_flax_params(model, tree)
        return model
    return dict(jmodel=jmodel, params=params, port=port, cfg=cfg,
                scaling=scaling)


@pytest.fixture(scope='module', params=[False, True],
                ids=['unscaled', 'loss_scaling'])
def models(request, data):
    """The small JAX ``PropOptVAE`` (with loss scaling or without), its
    params, and a port model factory loading the same params."""
    return _models(data, request.param)


@pytest.fixture(scope='module')
def scaled(data):
    """``models`` with loss scaling, which a negative total needs."""
    return _models(data, True)


def _assert_grads(ours, theirs):
    theirs = flatten(jax.tree.map(np.asarray, theirs))
    assert set(ours) == set(theirs)
    top = max(np.abs(v).max() for v in theirs.values())
    for k, v in theirs.items():
        scale = max(np.abs(v).max(), 1e-3 * top)
        np.testing.assert_allclose(ours[k], v, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def _jax_value_and_grad(jmodel, params, jb, rng=jax.random.PRNGKey(11)):
    jbd = jax.tree.map(jnp.asarray, jb)

    def jloss(p, b):
        total, metrics, aux = jmodel.apply(p, b, 0.1, rng, False, True)
        return total, (metrics, aux)
    return jax.jit(jax.value_and_grad(jloss, has_aux=True))(params, jbd)


def _assert_metrics(metrics, jmet):
    assert set(metrics) == set(jmet)
    for k, v in jmet.items():
        if k in ('HOMO_MSE', 'LUMO_MSE'):
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
        elif k in ('Word', 'I-Word', 'Topo', 'Assm'):
            assert float(metrics[k]) == pytest.approx(float(v), abs=1e-7), k
        else:
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=LOSS_RTOL, err_msg=k)


# -- the forward: losses, metrics, gradients ---------------------------------

@pytest.mark.parametrize('i', [0, 1])
def test_propopt_loss_and_grads_match_jax(data, models, i):
    """``PropOptVAE.forward`` against ``jax.value_and_grad`` of the JAX
    model's ``__call__`` (latent's mean, dropout off): the total, every
    metric (the property MSEs over the labelled rows only) and every
    parameter's gradient, the log-variances' too under loss scaling."""
    (jl, (jmet, jaux)), jg = _jax_value_and_grad(models['jmodel'],
                                                 models['params'],
                                                 data['jbs'][i])
    assert not bool(jaux['clipped'])
    model = models['port']()
    total, metrics, aux = model(to_device(batching.train_tables(
        data['pbs'][i]), 'cpu'), 0.1, perturb_z=False)
    total.backward()
    assert isinstance(aux['clipped'], torch.Tensor)
    assert not bool(aux['clipped'])
    np.testing.assert_allclose(total.item(), float(jl), rtol=LOSS_RTOL)
    _assert_metrics(metrics, jmet)
    _assert_grads(flatten(to_flax_tree(model, lambda p: p.grad)), jg)
    assert ('loss_weigh' in models['params']['params']) == models['scaling']


# the breaker's batch: the first 8 molecules, every one labelled HOMO
# -5.0 and LUMO -2.0
BREAKER_LABELS = (-5.0, -2.0)


@pytest.fixture(scope='module')
def breaker_batch(data):
    """Each package's packed batch of the breaker's molecules, and the
    port's padded ``MolGraphBatch`` of them."""
    rows = [[s, *BREAKER_LABELS] for s, _, _ in data['rows'][:BATCH]]
    mb = batching.pad_batch(tensorize(rows, data['vocab'], common_atom_vocab))
    jmb = jax_batching.pad_batch(jax_mg.tensorize(rows, data['jvocab'],
                                                  jax_avocab))
    jb = jax_batching.to_model_batch(jmb, data['jvocab'].mask, pad=False)
    pb = batching.to_model_batch(mb, data['vocab'].mask, pad=False)
    return dict(mb=mb, jb=dict(jb, plan=jax_batching.compact_plan_dict(
        {k: np.asarray(v) for k, v in jb['plan'].items()})),
        pb=dict(pb, plan=batching.compact_plan_dict(
            {k: np.asarray(v) for k, v in pb['plan'].items()})))


def _breaker_params(models, batch):
    """Params under which the total of the breaker's batch is negative:
    the heads predict each label plus 0.01 (a zero last kernel), and each
    log-variance is the log of its unweighed loss, so each weighed term is
    1 + log loss: about 1 + log 10 for the reconstruction and 1 + log 1e-4
    for each property."""
    jmodel, params = models['jmodel'], models['params']
    p = jax.tree.map(np.array, params)
    po = p['params']['property_optim']
    for k, label in zip(('homo_linear', 'lumo_linear'), BREAKER_LABELS):
        po[k]['Dense_1']['kernel'][:] = 0
        po[k]['Dense_1']['bias'][:] = label + 0.01
    lw = p['params']['loss_weigh']
    for v in lw.values():
        v[:] = 0          # the metrics are then the unweighed losses
    (_, (met, _)), _ = _jax_value_and_grad(jmodel, p, batch['jb'])
    lw['recon_log_var'][:] = np.log(float(met['Recs_Loss']))
    lw['homo_log_var'][:] = np.log(float(met['HOMO_MSE']))
    lw['lumo_log_var'][:] = np.log(float(met['LUMO_MSE']))
    return p


def test_circuit_breaker_with_injected_noise(breaker_batch, scaled):
    """A total at or below zero becomes 0.5 + 0.5·ε: the JAX model draws ε
    from its key's second half, the port takes it injected; both flag the
    step and pass no gradient."""
    models = scaled
    p = _breaker_params(models, breaker_batch)
    rng = jax.random.PRNGKey(11)
    (jl, (jmet, jaux)), jg = _jax_value_and_grad(models['jmodel'], p,
                                                 breaker_batch['jb'], rng)
    assert bool(jaux['clipped'])
    eps = float(jax.random.normal(jax.random.split(rng)[1], ()))
    model = models['port'](p)
    batch = to_device(batching.train_tables(breaker_batch['pb']), 'cpu')
    total, metrics, aux = model(batch, 0.1, perturb_z=False,
                                clip_eps=torch.tensor(eps))
    assert bool(aux['clipped']) and aux['clipped'].dtype == torch.bool
    assert total.item() == pytest.approx(0.5 + 0.5 * eps, abs=1e-7)
    assert total.item() == pytest.approx(float(jl), abs=1e-7)
    _assert_metrics(metrics, jmet)
    total.backward()
    for name, q in model.named_parameters():
        assert q.grad is None or not q.grad.any(), name
    assert all(not np.asarray(v).any() for v in jax.tree.leaves(jg))
    # with a generator, the noise is drawn from it
    gen = torch.Generator().manual_seed(3)
    want = 0.5 + 0.5 * torch.randn((), generator=torch.Generator()
                                   .manual_seed(3)).item()
    total, _, _ = model(batch, 0.1, perturb_z=False, generator=gen)
    assert total.item() == pytest.approx(want, abs=1e-7)


def test_trainer_counts_clipped_steps(data, breaker_batch, scaled):
    """The Trainer counts the breaker's device flags at print boundaries
    and at the epoch's end; ``clip_break_count`` of them stop the run."""
    models = scaled
    p = _breaker_params(models, breaker_batch)
    mb = breaker_batch['mb']
    lines = []
    tr = Trainer(models['port'](p), make_multi_optimizer(
        default_group_fn, {g: 1e-3 for g in ('encoder', 'decoder', 'homo',
                                             'lumo')}),
                 data['vocab'].mask, print_iter=2, clip_break_count=2,
                 perturb_z=False, device='cpu')
    assert tr.train_epoch([mb] * 3, log=lines.append,
                          scan_chunk=1)
    assert tr.total_step == 2 and tr.n_clipped == 2
    assert lines == ['[2] negative-loss clip count reached 2; aborting run']
    # at the epoch's end, no boundary reached
    tr = Trainer(models['port'](p), make_multi_optimizer(
        default_group_fn, {g: 1e-3 for g in ('encoder', 'decoder', 'homo',
                                             'lumo')}),
                 data['vocab'].mask, print_iter=100, clip_break_count=3,
                 perturb_z=False, device='cpu')
    assert not tr.train_epoch([mb] * 2, log=lines.append)
    assert tr.n_clipped == 2
    assert tr.train_epoch([mb], log=lines.append)
    assert count_clipped([False, True, torch.tensor(True),
                          torch.tensor(False)]) == 2


def test_trainer_steps_match_jax(data, models):
    """Three fine-tuning steps through the port's Trainer against the JAX
    ``make_train_step`` with ``make_multi_optimizer``: per-step metrics,
    and each leaf's update within 1e-3 of JAX's over the entries whose
    gradient is not rounding noise."""
    lrs = {'encoder': 1e-3, 'decoder': 2e-3, 'homo': 5e-4, 'lumo': 3e-4}
    tx = jax_multi(jax_group_fn, lrs, clip_norm=20.0, steps_per_epoch=2)
    step = make_train_step(models['jmodel'], tx, beta=0.1, perturb_z=False)
    jp = jax.tree.map(jnp.asarray, models['params'])
    st = tx.init(jp)
    rng = jax.random.PRNGKey(0)
    tr = Trainer(models['port'](), make_multi_optimizer(
        default_group_fn, lrs, clip_norm=20.0, steps_per_epoch=2),
        data['vocab'].mask, perturb_z=False, device='cpu')
    noise = None
    for i in range(3):
        before = flatten(jax.tree.map(np.array, jp))
        ours_before = flatten(to_flax_tree(tr.model))
        jp, st, jmet, _, rng = step(jp, st, jax.tree.map(
            jnp.asarray, data['jbs'][i]), rng, float(i))
        metrics, aux = tr.train_step(tr.device_batch(data['pbs'][i]))
        assert not bool(aux['clipped'])
        for k, v in jmet.items():
            np.testing.assert_allclose(
                float(metrics[k]), float(v), rtol=GRAD_RTOL,
                atol=1e-9 if k in ('HOMO_MSE', 'LUMO_MSE') else 0, err_msg=k)
        noise = _noise(flatten(to_flax_tree(tr.model, lambda p: p.grad)),
                       noise)
        _assert_updates(
            _leaf_updates(ours_before, flatten(to_flax_tree(tr.model))),
            _leaf_updates(before, flatten(jax.tree.map(np.array, jp))),
            noise)


def _leaf_updates(before, after):
    return {k: np.asarray(after[k], np.float64) - np.asarray(before[k],
                                                             np.float64)
            for k in before}


def _noise(grads, masks=None):
    """Per leaf, the entries whose gradient is rounding noise (below 1e-6
    of the whole gradient's norm, exact zeros included), or'ed into
    ``masks`` from earlier steps: Adam turns noise of either sign into a
    step of about the learning rate, and its moments carry that on."""
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
        assert err <= 1e-3 * den, (k, err, den)


# -- the per-group optimizer -------------------------------------------------

def _group_of_leaves(model, opt_state):
    """Flax path -> group of the port's parameters after ``attach``."""
    index = {id(p): g for g, st in opt_state.groups.items()
             for p in st.params}
    names = sorted(opt_state.groups)
    tree = flatten(to_flax_tree(model, lambda p: torch.full_like(
        p, float(names.index(index[id(p)])))))
    return {k: names[int(v.reshape(-1)[0])] for k, v in tree.items()}


def test_groups_follow_the_flax_paths(models):
    """Every parameter falls in the group ``default_group_fn`` gives its
    flax path in the JAX package; the tied embeddings (flax
    ``vae/E_c``, ``vae/E_i``) in the decoder's."""
    model = models['port']()
    state = make_multi_optimizer(default_group_fn, {
        g: 1e-3 for g in ('encoder', 'decoder', 'homo', 'lumo')}).attach(
        dict(model.named_parameters()))
    ours = _group_of_leaves(model, state)
    flat = jax.tree_util.tree_flatten_with_path(models['params'])[0]
    theirs = {'/'.join(k.key for k in path): jax_group_fn(
        jax.tree_util.keystr(path)) for path, _ in flat}
    assert ours == theirs
    assert ours['params/vae/E_c/embedding'] == 'decoder'
    assert ours['params/vae/E_i/embedding'] == 'decoder'
    assert {'encoder', 'decoder', 'homo', 'lumo'} == set(ours.values())


@pytest.mark.parametrize('clip', [20.0, 3.0])
def test_multi_optimizer_matches_optax(models, clip):
    """Three updates of random gradients of the model's leaves against
    ``optax.multi_transform`` (``make_multi_optimizer``), the schedule
    crossing an epoch: each group clipped by its own gradients' norm.  At
    clip 3 the encoder's gradients (norm about 10) are clipped and the
    others (below 1) are not."""
    lrs = {'encoder': 1e-2, 'decoder': 5e-3, 'homo': 2e-3, 'lumo': 1e-3}
    params = jax.tree.map(np.asarray, models['params'])
    rng = np.random.default_rng(5)
    shapes = {k: v.shape for k, v in flatten(params).items()}
    n_enc = sum('encoder' in k for k in shapes)
    grads = []
    for _ in range(3):
        g = {}
        for k, shape in shapes.items():
            # group norms about 10 for the encoder, below 1 for the others
            scale = (10.0 / np.sqrt(n_enc) if 'encoder' in k else 0.1) \
                / np.sqrt(max(int(np.prod(shape)), 1))
            g[k] = (rng.normal(0, 1, shape) * scale).astype(np.float32)
        grads.append(g)
    tx = jax_multi(jax_group_fn, lrs, clip_norm=clip, anneal_rate=0.5,
                   steps_per_epoch=2)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    update = jax.jit(tx.update)
    model = models['port']()
    state = make_multi_optimizer(default_group_fn, lrs, clip_norm=clip,
                                 anneal_rate=0.5, steps_per_epoch=2).attach(
        dict(model.named_parameters()))
    group = _group_of_leaves(model, state)
    by_name = dict(model.named_parameters())
    for g in grads:
        jg = ckpt._unflatten({k: jnp.asarray(v) for k, v in g.items()})
        upd, st = update(jg, st, jp)
        jp = optax.apply_updates(jp, upd)
        # the port's gradients, laid out as its parameters
        bridged = PropOptVAE(model.cfg)
        load_flax_params(bridged, ckpt._unflatten(g))
        for name, p in bridged.named_parameters():
            by_name[name].grad = p.detach().clone()
        gnorm = state.step()
        norms = {n: np.sqrt(sum(float((g[k].astype(np.float64) ** 2).sum())
                                for k in g if group[k] == n))
                 for n in lrs}
        for n, v in norms.items():
            np.testing.assert_allclose(float(state.group_norms[n]), v,
                                       rtol=1e-6)
        np.testing.assert_allclose(float(gnorm), np.sqrt(sum(
            v * v for v in norms.values())), rtol=1e-6)
        assert (norms['encoder'] > clip) == (clip < 20)
        assert all(norms[n] < clip for n in ('decoder', 'homo', 'lumo'))
        want = flatten(jax.tree.map(np.asarray, jp))
        got = flatten(to_flax_tree(model))
        for k in want:
            # a few ulps of the updates (about lr each), whose moments are
            # rounded in another order
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=2e-7,
                                       err_msg=k)
    assert state.count == 3


# -- the bridge ----------------------------------------------------------------

@pytest.mark.parametrize('direction', ['port-to-jax', 'jax-to-port'])
def test_propopt_checkpoint_round_trip(models, tmp_path, direction):
    """The full prop-opt tree (``vae/``, ``property_optim/`` and, under
    loss scaling, ``loss_weigh/``) through each package's checkpoint
    files: the same values, and the same bytes written by either."""
    path = str(tmp_path / 'model.0')
    params = jax.tree.map(np.asarray, models['params'])
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
        want = flatten(params)
        got = flatten(to_flax_tree(model))
    assert set(got) == set(want)
    assert any(k.startswith('params/property_optim/') for k in got)
    assert any(k.startswith('params/loss_weigh/') for k in got) == \
        models['scaling']
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax_tree = loaded if direction == 'port-to-jax' else params
    assert msgpack_serialize(to_flax_tree(model)) == \
        serialization.to_bytes(jax_tree)


def test_load_model_reads_loss_weigh(tmp_path):
    """``bridge.load_model`` builds the model with loss scaling when the
    checkpoint holds ``loss_weigh`` and loads its log-variances."""
    tree = read_checkpoint(profile_train.CKPT)
    model, _ = load_model(profile_train.CKPT, profile_train.VOCAB,
                          device='cpu')
    assert not model.cfg.loss_scaling and not hasattr(model, 'loss_weigh')
    tree['params'] = dict(tree['params'], loss_weigh={
        k: np.array([v], np.float32) for k, v in (
            ('homo_log_var', 0.25), ('lumo_log_var', -0.5),
            ('recon_log_var', 1.5))})
    path = str(tmp_path / 'ckpt')
    ckpt.save_params(tree, path)
    model, _ = load_model(path, profile_train.VOCAB, device='cpu')
    assert model.cfg.loss_scaling
    assert model.loss_weigh.lumo_log_var.item() == -0.5


# -- the CLIs ----------------------------------------------------------------

def _write_inputs(tmp_path, data, rows, name):
    (tmp_path / 'vocab.txt').write_text(
        ''.join(f'{a} {b}\n' for a, b in data['pairs']))
    path = tmp_path / name
    with open(path, 'w') as f:
        f.write('SMILES,HOMO,LUMO\n')
        f.writelines(f'{s},{"" if h is None else h},{"" if l is None else l}\n'
                     for s, h, l in rows)
    return str(path)


def test_fine_tune_cli_indv_opt_one_epoch(data, tmp_path):
    """``vae_fine_tune_indv_opt`` (``vae_fine_tune --indv-opt``) for one
    epoch on the CPU from a ``prop`` checkpoint: the ``vae/`` weights are
    copied across the nesting, each group gets its own Adam, it validates,
    keeps the best model and writes the epoch's checkpoint, which the JAX
    package loads into its own prop-opt model's params."""
    train = _write_inputs(tmp_path, data, data['rows'][:2 * BATCH],
                          'train.csv')
    val = _write_inputs(tmp_path, data, data['rows'][2 * BATCH:3 * BATCH],
                        'val.csv')
    hv, iv = data['hv'], data['iv']
    pre = PropertyVAE(ModelConfig(hvocab_size=hv, ivocab_size=iv, **SMALL))
    init_params(pre, torch.Generator().manual_seed(8))
    ckpt.save_params(to_flax_tree(pre), str(tmp_path / 'pre'))
    cfg = dict(vocab_=str(tmp_path / 'vocab.txt'), data=train, val_data=val,
               save_dir=str(tmp_path / 'out'), batch_size=BATCH, epoch=1,
               print_iter=1, seed=2, saved_model=str(tmp_path / 'pre'),
               encoder_lr=1e-3, decoder_lr=1e-3, homo_lr=5e-4, lumo_lr=5e-4,
               **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    args = ['--path-to-config', str(tmp_path / 'cfg.json'), '--device', 'cpu']
    # epoch 0: the transfer alone
    cfg0 = dict(cfg, epoch=0, save_dir=str(tmp_path / 'out0'))
    (tmp_path / 'cfg0.json').write_text(json.dumps(cfg0))
    copied = vae_fine_tune.main(['--path-to-config',
                                 str(tmp_path / 'cfg0.json'), '--device',
                                 'cpu'])
    mine, src = flatten(to_flax_tree(copied)), flatten(to_flax_tree(pre))
    for k, v in src.items():
        np.testing.assert_array_equal(mine['params/vae/' + k[7:]], v)
    model = vae_fine_tune_indv_opt.main(args)
    assert isinstance(model, PropOptVAE)
    out = tmp_path / 'out'
    assert sorted(os.listdir(out)) == ['configs.json', 'model.0',
                                       'model.best']
    template = jax.tree.map(np.asarray, to_flax_tree(model))
    jparams = jax_ckpt.load_params(template, str(out / 'model.0'))
    for k, v in flatten(jax.tree.map(np.asarray, jparams)).items():
        assert np.isfinite(v).all(), k
        np.testing.assert_array_equal(v, flatten(template)[k])


# -- the full-width reference of chip_smoke.py's finetune phase ---------------

def _mu_by_leaf(opt_state):
    """Adam's first moment per flax leaf, across the groups of an
    ``optax.multi_transform`` state."""
    out = {}
    for st in opt_state.inner_states.values():
        mu = st.inner_state[1].mu
        for k, v in flatten(mu).items():
            if not isinstance(v, optax.MaskedNode):
                out[k] = np.asarray(v)
    return out


def jax_reference():
    """The JAX package's first 3 fine-tuning steps of the full trained
    checkpoint (``make_train_step`` with ``make_multi_optimizer`` at
    ``profile_train.FINETUNE_LRS``) on the first three HOPV batches of 20
    (padded, lane-packed), at dropout 0 with the latent's mean: per-step
    metrics, per leaf the update along the gradient and the gradient's
    norm (read from Adam's first moment; no group's clip binds), and each
    group's gradient norm."""
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
    jmodel = JaxPropOptVAE(cfg=JaxModelConfig(hvocab_size=hv,
                                              ivocab_size=iv))
    params = read_checkpoint(profile_train.CKPT)
    opt_kw = {k: v for k, v in profile_train.OPTIMIZER.items() if k != 'lr'}
    tx = jax_multi(jax_group_fn, profile_train.FINETUNE_LRS, **opt_kw)
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
        leaf_norms = {k: float(np.linalg.norm(v)) for k, v in grad.items()}
        groups = {}
        for k, v in grad.items():
            g = jax_group_fn(k)
            groups[g] = groups.get(g, 0.0) + float(
                (v.astype(np.float64) ** 2).sum())
        assert all(np.sqrt(v) < opt_kw['clip_norm'] for v in groups.values())
        steps.append(dict(
            {k: float(v) for k, v in sorted(metrics.items())},
            update_norms=profile_train.update_norms(before, after, grad),
            grad_norms=leaf_norms,
            group_norms={g: float(np.sqrt(v)) for g, v in
                         sorted(groups.items())}))
    return dict(checkpoint='runs/QUALITY_hopv.json.ckpt (full prop-opt tree)',
                vocab='runs/QUALITY_hopv.json.vocab.txt',
                data='data/hopv15.csv', batch_size=20, model='prop-opt',
                lrs=profile_train.FINETUNE_LRS, optimizer=opt_kw,
                beta=profile_train.BETA, steps=steps)


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
                assert g[k] == pytest.approx(v, rel=1e-5, abs=1e-12), k


def test_port_on_the_cpu_meets_the_finetune_golden(golden):
    """chip_smoke.py's finetune phase on the CPU: the port's 3 steps at
    full width held to the golden by ``profile_train``'s rule for it, and
    the property losses within a tenth of their tolerance."""
    got = profile_train.golden_steps('cpu', finetune=True)
    assert profile_train.check_golden(
        got, golden, profile_train.FINETUNE_LATER_UPDATE_RTOL) == []
    for g, w in zip(got, golden['steps']):
        assert set(g['group_norms']) == {'encoder', 'decoder', 'homo', 'lumo'}
        for k in profile_train.PROPERTY_KEYS:
            assert abs(g[k] - w[k]) <= 0.1 * profile_train.PROPERTY_ATOL, k



@pytest.mark.parametrize('key', ['Loss', 'KL', 'GNorm', 'HOMO_MSE',
                                 'group_norms'])
def test_golden_rule_needs_the_core_keys(golden, key):
    """``check_golden`` holds a golden's own steps; a golden without the
    property losses or the per-group norms (a prop golden) skips them,
    while one without Loss, KL or GNorm is refused."""
    steps = [dict(s) for s in golden['steps']]
    assert profile_train.check_golden(
        steps, golden, profile_train.FINETUNE_LATER_UPDATE_RTOL) == []
    cut = dict(golden, steps=[{k: v for k, v in s.items() if k != key}
                              for s in golden['steps']])
    if key in ('HOMO_MSE', 'group_norms'):
        assert profile_train.check_golden(
            steps, cut, profile_train.FINETUNE_LATER_UPDATE_RTOL) == []
    else:
        with pytest.raises(KeyError):
            profile_train.check_golden(
                steps, cut, profile_train.FINETUNE_LATER_UPDATE_RTOL)

if __name__ == '__main__':
    with open(GOLDEN, 'w') as f:
        json.dump(jax_reference(), f, indent=1)
        f.write('\n')
