"""The port's prop-opt-sched path (``PropOptSchedulingVAE``,
``MotifDecoder.scheduled_forward``) against the JAX package's, on the
CPU, and the JAX reference that chip_smoke.py phase 13 holds the card's
scheduled fine-tuning to.

Small width (hidden = embed = 32, latent 8, depthT 3, dropout 0, the
latent's mean) with the same params in both packages (a flax init with
noise on every leaf, through the bridge), on batches of 8 molecules of
``data/chem_data/train.csv``, lane-packed and unpacked.  The coins of
``tf_ratio`` < 1 are JAX's (``uniform(split(rng)[1], (T, L)) > tf_ratio``),
injected into the port.  The JAX models are called directly: the JAX
oracles of this path (``test_models.py::test_scheduled_tf1_matches_
standard``, ``test_eval.py::test_scheduled_model``) read reference data
absent from the test machines.

Tolerances: losses within 1e-5 relative, the property losses within 1e-5
relative or 1e-9 absolute, accuracies within 1e-7; each gradient leaf
within 1e-4 of its largest entry in magnitude (or of 1e-3 of the largest
entry of any leaf); the fed-back embeddings within 1e-6 (rows copied from
one of two tables).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sched.py

rewrites ``ggpm_tpu_torch/goldens/train_propsched_hopv.json`` from the
JAX package.
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

from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropOptSchedulingVAE as JaxSchedVAE
from ggpm_tpu.train import checkpoint as jax_ckpt
from ggpm_tpu.train.loop import init_params_on_cpu, make_train_step
from ggpm_tpu.train.optim import default_group_fn as jax_group_fn
from ggpm_tpu.train.optim import make_multi_optimizer as jax_multi
from ggpm_tpu_torch import kernel_bench, profile_train
from ggpm_tpu_torch.bridge import flatten, load_flax_params, to_flax_tree
from ggpm_tpu_torch.cli import vae_fine_tune, vae_train
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.graph.mol_graph import MolGraph, tensorize
from ggpm_tpu_torch.graph.vocab import PairVocab, common_atom_vocab
from ggpm_tpu_torch.models.vae import ModelConfig, PropOptSchedulingVAE
from ggpm_tpu_torch.train.loop import Trainer, to_device
from ggpm_tpu_torch.train.optim import (default_group_fn,
                                        make_multi_optimizer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CSV = os.path.join(ROOT, 'data', 'chem_data', 'train.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'train_propsched_hopv.json')
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3,
             linear_hidden_size=16)
BATCH = 8
N_MOLS = 32
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
RNG = jax.random.PRNGKey(11)


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
    rows[3][1] = None
    rows[5][2] = None
    return rows


@pytest.fixture(scope='module')
def data():
    """Vocabularies over the molecules (no fragments), and each package's
    model batches of 8 of them, unpacked and lane-packed."""
    saved = jax_mg.MolGraph.FRAGMENTS
    jax_mg.MolGraph.FRAGMENTS = set()
    try:
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
                jax_mg.tensorize(g, jvocab, jax_avocab)), jvocab.mask,
                pad=False)
            pb = batching.to_model_batch(batching.pad_batch(
                tensorize(g, vocab, common_atom_vocab)), vocab.mask,
                pad=False)
            batches[False].append((jb, pb))
            batches[True].append((
                dict(jb, plan=jax_batching.compact_plan_dict(
                    {k: np.asarray(v) for k, v in jb['plan'].items()})),
                dict(pb, plan=batching.compact_plan_dict(
                    {k: np.asarray(v) for k, v in pb['plan'].items()}))))
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = vocab.size()
    return dict(rows=rows, pairs=pairs, vocab=vocab, batches=batches, hv=hv,
                iv=iv)


@pytest.fixture(scope='module')
def models(data):
    """The small JAX ``PropOptSchedulingVAE``, its params (a flax init
    with noise on every leaf), and a port model factory loading them."""
    cfg = dict(hvocab_size=data['hv'], ivocab_size=data['iv'], **SMALL)
    jmodel = JaxSchedVAE(cfg=JaxModelConfig(rnn_type='LSTM', dropout=0.0,
                                             **cfg))
    params = init_params_on_cpu(jmodel, data['batches'][True][0][0],
                                jax.random.PRNGKey(0))
    noise = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (np.asarray(x) + noise.normal(
        0, 0.1, x.shape)).astype(np.float32), params)

    def port():
        model = PropOptSchedulingVAE(ModelConfig(**cfg))
        load_flax_params(model, params)
        return model
    return dict(jmodel=jmodel, params=params, port=port, cfg=cfg)


def jax_coins(plan, tf_ratio, rng=RNG):
    """JAX's coins of ``PropOptSchedulingVAE`` called with ``rng``."""
    T, L = np.shape(plan['xid'])
    return np.asarray(jax.random.uniform(jax.random.split(rng)[1], (T, L))
                      > tf_ratio)


def _jax_value_and_grad(jmodel, params, jb, tf_ratio):
    jbd = jax.tree.map(jnp.asarray, jb)

    def jloss(p):
        total, metrics, _ = jmodel.apply(p, jbd, 0.1, RNG, False, True,
                                         tf_ratio)
        return total, metrics
    return jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)


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


def _port_batch(pb):
    return to_device(batching.train_tables(pb), 'cpu')


@pytest.mark.parametrize('tf_ratio', [1.0, 0.5, 0.0])
@pytest.mark.parametrize('packed', [False, True], ids=['unpacked', 'packed'])
def test_sched_loss_and_grads_match_jax(data, models, packed, tf_ratio):
    """``PropOptSchedulingVAE.forward`` against ``jax.value_and_grad`` of
    the JAX model at the same ``tf_ratio``, JAX's coins injected: the
    total (the decoder loss + β·KL + 20 × the property losses), every
    metric and every parameter's gradient.  At 1.0 the port draws no coin
    and the loss is the port's own teacher-forced ``forward``'s."""
    jb, pb = data['batches'][packed][1]
    (jl, jmet), jg = _jax_value_and_grad(models['jmodel'], models['params'],
                                         jb, tf_ratio)
    model = models['port']()
    batch = _port_batch(pb)
    coins = jax_coins(jb['plan'], tf_ratio)
    used = coins & np.asarray(pb['plan']['has_cls'], bool) & \
        (np.asarray(pb['plan']['mess']) > 0)
    assert used.any() == (tf_ratio < 1.0)
    total, metrics, aux = model(batch, 0.1, perturb_z=False,
                                tf_ratio=tf_ratio,
                                coins=None if tf_ratio == 1.0 else
                                torch.from_numpy(coins))
    total.backward()
    assert aux['clipped'] is False
    np.testing.assert_allclose(total.item(), float(jl), rtol=LOSS_RTOL)
    _assert_metrics(metrics, jmet)
    assert metrics['Loss'].item() == pytest.approx(
        metrics['Recs_Loss'].item() + 20 * (metrics['HOMO_MSE'].item() +
                                            metrics['LUMO_MSE'].item()),
        rel=1e-6)
    _assert_grads(flatten(to_flax_tree(model, lambda p: p.grad)), jg)
    if tf_ratio == 1.0:
        z, _ = model.encode_latent(batch['tree'])
        dec = model.vae.decoder
        sched, smet = dec.scheduled_forward(batch['tree'], batch['plan'], z,
                                            batch['vocab_mask'])
        plain, pmet = dec(batch['tree'], batch['plan'], z,
                          batch['vocab_mask'])
        np.testing.assert_allclose(sched.item(), plain.item(),
                                   rtol=LOSS_RTOL)
        assert {k: float(v) for k, v in smet.items()} == \
            pytest.approx({k: float(v) for k, v in pmet.items()}, abs=1e-7)


def _jax_emb_buf(monkeypatch, models, jb, n_nodes, tf_ratio):
    """The motif embeddings after JAX's scheduled scan: its final carry,
    caught from ``jax.lax.scan`` while the model runs eagerly."""
    carries = []
    real = jax.lax.scan

    def scan(f, init, xs=None, *args, **kwargs):
        out = real(f, init, xs, *args, **kwargs)
        carries.append(out[0])
        return out
    monkeypatch.setattr(jax.lax, 'scan', scan)
    models['jmodel'].apply(models['params'], jax.tree.map(jnp.asarray, jb),
                           0.1, RNG, False, True, tf_ratio)
    monkeypatch.undo()
    bufs = [c[1] for c in carries if isinstance(c, tuple) and len(c) == 2
            and getattr(c[1], 'shape', None) == (n_nodes,
                                                 SMALL['embed_size'])]
    assert len(bufs) == 1
    return np.asarray(bufs[0])


@pytest.mark.parametrize('packed', [False, True], ids=['unpacked', 'packed'])
def test_emb_buf_matches_jax(data, models, monkeypatch, packed):
    """At ``tf_ratio`` 0.5 with JAX's coins, the motif embeddings the
    scan fed its last step (``MotifDecoder.sched_hook``) equal JAX's
    ``emb_buf`` after its scan, and differ from the gold embeddings at
    every node a fed-back prediction replaced with another motif."""
    jb, pb = data['batches'][packed][2]
    n_nodes = len(pb['tree']['fnode'])
    want = _jax_emb_buf(monkeypatch, models, jb, n_nodes, 0.5)
    model = models['port']()
    record = {}
    model.vae.decoder.sched_hook = record.update
    model(_port_batch(pb), 0.1, perturb_z=False, tf_ratio=0.5,
          coins=torch.from_numpy(jax_coins(jb['plan'], 0.5)))
    got = record['emb_buf'].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    gold = model.vae.E_c.weight.detach()[
        torch.as_tensor(pb['tree']['fnode'][:, 0]).long()].numpy()
    use = record['use']
    mess = torch.as_tensor(pb['plan']['mess']).long()
    dst = torch.as_tensor(pb['tree']['fmess'][:, 1]).long()[mess][use]
    clab = torch.as_tensor(pb['plan']['clab']).long()[use]
    flipped = dst[record['pred'][use] != clab]
    changed = np.nonzero(np.abs(got - gold).max(1) > 0)[0]
    assert len(flipped) > 0
    assert sorted(changed.tolist()) == sorted(flipped.tolist())


def test_trainer_steps_match_jax(data, models):
    """Three fine-tuning steps of prop-opt-sched through the port's
    ``Trainer`` (``tf_ratio`` 1, as the JAX ``Trainer`` steps it) against
    the JAX ``make_train_step`` with ``make_multi_optimizer``: per-step
    metrics and gradient norms."""
    lrs = {'encoder': 1e-3, 'decoder': 2e-3, 'homo': 5e-4, 'lumo': 3e-4}
    tx = jax_multi(jax_group_fn, lrs, clip_norm=20.0, steps_per_epoch=2)
    step = make_train_step(models['jmodel'], tx, beta=0.1, perturb_z=False)
    jp = jax.tree.map(jnp.asarray, models['params'])
    st = tx.init(jp)
    rng = jax.random.PRNGKey(0)
    tr = Trainer(models['port'](), make_multi_optimizer(
        default_group_fn, lrs, clip_norm=20.0, steps_per_epoch=2),
        data['vocab'].mask, perturb_z=False, device='cpu')
    for i in range(3):
        jb, pb = data['batches'][True][i]
        jp, st, jmet, _, rng = step(jp, st, jax.tree.map(jnp.asarray, jb),
                                    rng, float(i))
        metrics, aux = tr.train_step(tr.device_batch(pb))
        assert aux['clipped'] is False
        for k, v in jmet.items():
            np.testing.assert_allclose(
                float(metrics[k]), float(v), rtol=GRAD_RTOL,
                atol=1e-9 if 'MSE' in k else 0, err_msg=k)


@pytest.mark.parametrize('packed', [False, True], ids=['unpacked', 'packed'])
def test_kernel_cases_of_the_scheduled_readout(data, packed):
    """The scheduled readout's kernel cases that chip_smoke.py times
    (``kernel_bench.sched_cases``) on the CPU: each call is its plain
    version, the library yardstick computes the same function, and the
    readout is the masked frontier table the scan reads."""
    _, pb = data['batches'][packed][0]
    dev = _port_batch(pb)
    cases = kernel_bench.sched_cases(dev, torch.Generator().manual_seed(0),
                                     hidden=16)
    assert [(c['kernel'], c['case']) for c in cases] == [
        ('nei_sum', 'sched-readout'), ('transpose_sum', 'sched-readout-bwd')]
    assert cases[0]['shape']['graph'] == list(dev['plan']['frontier'].shape)
    for c in cases:
        out, ref, lib = c['call'](), c['plain'](), c['library']()
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        torch.testing.assert_close(c['exact'](), ref, rtol=0, atol=1e-6)
        torch.testing.assert_close(lib, ref, rtol=0, atol=1e-5)
        assert c['bytes'] > 0


def test_sched_site_counts_the_scheduled_readout(data, models):
    """``kernel_bench.sched_site`` (the kernels line's ``sched_sites``)
    counts one call at the scheduled readout and one in its backward for
    a tf_ratio 0.5 step, none for the teacher-forced readout, which
    shares ``_readout``; no launch on the CPU; the wrapper is restored."""
    from ggpm_tpu_torch.models import decoder
    original = decoder.nei_sum_t
    jb, pb = data['batches'][True][0]
    model = models['port']()
    batch = _port_batch(pb)
    with kernel_bench.sched_site() as site:
        total, _, _ = model(batch, 0.1, perturb_z=False, tf_ratio=0.5,
                            coins=torch.from_numpy(jax_coins(jb['plan'],
                                                             0.5)))
        assert site['sched-readout-bwd']['calls'] == 0
        total.backward()
        z, _ = model.encode_latent(batch['tree'])
        loss, _ = model.vae.decoder(batch['tree'], batch['plan'], z,
                                    batch['vocab_mask'])
        loss.backward()
    assert site == {'sched-readout': dict(calls=1, launches=0),
                    'sched-readout-bwd': dict(calls=1, launches=0)}
    assert decoder.nei_sum_t is original


def _cli_inputs(tmp_path, data):
    (tmp_path / 'vocab.txt').write_text(
        ''.join(f'{a} {b}\n' for a, b in data['pairs']))
    paths = []
    for name, rows in (('train.csv', data['rows'][:2 * BATCH]),
                       ('val.csv', data['rows'][2 * BATCH:3 * BATCH])):
        with open(tmp_path / name, 'w') as f:
            f.write('SMILES,HOMO,LUMO\n')
            f.writelines(f'{s},{"" if h is None else h},'
                         f'{"" if l is None else l}\n' for s, h, l in rows)
        paths.append(str(tmp_path / name))
    return paths


@pytest.mark.parametrize('cli', ['vae_fine_tune', 'vae_train'])
def test_cli_trains_prop_opt_sched(data, tmp_path, cli):
    """``--model-type prop-opt-sched`` trains one epoch on the CPU through
    ``vae_fine_tune`` and ``vae_train`` (which refused it before the
    model was ported), and writes a checkpoint that the JAX package loads
    into its own ``PropOptSchedulingVAE``'s params."""
    train, val = _cli_inputs(tmp_path, data)
    cfg = dict(vocab_=str(tmp_path / 'vocab.txt'), data=train, val_data=val,
               save_dir=str(tmp_path / 'out'), batch_size=BATCH, epoch=1,
               print_iter=1, seed=2, **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    args = ['--path-to-config', str(tmp_path / 'cfg.json'), '--model-type',
            'prop-opt-sched', '--device', 'cpu']
    if cli == 'vae_train':
        model = vae_train.main(args + ['--data-csv', train])
    else:
        model = vae_fine_tune.main(args)
    assert isinstance(model, PropOptSchedulingVAE)
    jmodel = JaxSchedVAE(cfg=JaxModelConfig(
        hvocab_size=data['hv'], ivocab_size=data['iv'], **SMALL))
    template = init_params_on_cpu(jmodel, data['batches'][True][0][0],
                                  jax.random.PRNGKey(0))
    jparams = jax_ckpt.load_params(template,
                                   str(tmp_path / 'out' / 'model.0'))
    mine = flatten(to_flax_tree(model))
    for k, v in flatten(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_array_equal(v, mine[k])


# -- the full-width reference of chip_smoke.py phase 13 ----------------------

def _mu_by_leaf(opt_state):
    """Adam's first moment per flax leaf, across the groups of an
    ``optax.multi_transform`` state."""
    out = {}
    for st in opt_state.inner_states.values():
        for k, v in flatten(st.inner_state[1].mu).items():
            if not isinstance(v, optax.MaskedNode):
                out[k] = np.asarray(v)
    return out


def jax_reference():
    """The JAX package's first 3 prop-opt-sched fine-tuning steps of the
    full trained checkpoint (``make_train_step`` with
    ``make_multi_optimizer`` at ``profile_train.FINETUNE_LRS``, tf_ratio 1
    as the JAX ``Trainer`` steps it) on the first three HOPV batches of 20
    (padded, lane-packed), at dropout 0 with the latent's mean, recorded
    as tests/test_torch_propopt.py records prop-opt's; and one forward at
    ``profile_train.SCHED_TF`` on the first batch from the checkpoint,
    its coins drawn from ``PRNGKey(profile_train.SCHED_SEED)`` (stored as
    one string of 0 and 1 a step), with its metrics."""
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
    jmodel = JaxSchedVAE(cfg=JaxModelConfig(hvocab_size=hv, ivocab_size=iv))
    params = profile_train.read_checkpoint(profile_train.CKPT)
    rng = jax.random.PRNGKey(profile_train.SCHED_SEED)
    b0 = jax.tree.map(jnp.asarray, batches[0])
    _, met, _ = jax.jit(lambda p, b: jmodel.apply(
        p, b, profile_train.BETA, rng, False, True,
        profile_train.SCHED_TF))(jax.tree.map(jnp.asarray, params), b0)
    coins = jax_coins(batches[0]['plan'], profile_train.SCHED_TF, rng)
    sched = dict(tf_ratio=profile_train.SCHED_TF,
                 rng=f'split(PRNGKey({profile_train.SCHED_SEED}))[1]',
                 coins=[''.join('1' if c else '0' for c in row)
                        for row in coins],
                 metrics={k: float(v) for k, v in sorted(met.items())})

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
        groups = {}
        for k, v in grad.items():
            g = jax_group_fn(k)
            groups[g] = groups.get(g, 0.0) + float(
                (v.astype(np.float64) ** 2).sum())
        assert all(np.sqrt(v) < opt_kw['clip_norm'] for v in groups.values())
        steps.append(dict(
            {k: float(v) for k, v in sorted(metrics.items())},
            update_norms=profile_train.update_norms(before, after, grad),
            grad_norms={k: float(np.linalg.norm(v)) for k, v in grad.items()},
            group_norms={g: float(np.sqrt(v)) for g, v in
                         sorted(groups.items())}))
    return dict(checkpoint='runs/QUALITY_hopv.json.ckpt (full prop-opt tree)',
                vocab='runs/QUALITY_hopv.json.vocab.txt',
                data='data/hopv15.csv', batch_size=20, model='prop-opt-sched',
                lrs=profile_train.FINETUNE_LRS, optimizer=opt_kw,
                beta=profile_train.BETA, steps=steps, sched_step=sched)


@pytest.fixture(scope='module')
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_is_the_jax_reference(golden):
    want = jax_reference()
    skip = ('steps', 'sched_step')
    assert {k: v for k, v in golden.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert golden['sched_step']['coins'] == want['sched_step']['coins']
    assert golden['sched_step']['metrics'] == pytest.approx(
        want['sched_step']['metrics'], rel=1e-5)
    for g, w in zip(golden['steps'], want['steps']):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, dict):
                for leaf, x in v.items():
                    assert g[k][leaf] == pytest.approx(x, rel=1e-5, abs=1e-9)
            else:
                assert g[k] == pytest.approx(v, rel=1e-5), k


def test_port_on_the_cpu_meets_the_sched_golden(golden):
    """chip_smoke.py phase 13 on the CPU: the port's 3 prop-opt-sched
    steps at full width held to the golden by the prop-opt fine-tuning
    rule, and its tf_ratio 0.5 step with the golden's coins by
    ``check_sched_step`` (against itself for the gradients): every
    fed-back prediction away from a near-tie, the metrics the golden's."""
    trainer, vocab = profile_train.sched_trainer('cpu')
    _, batches = profile_train.hopv_batches(profile_train.GOLDEN_STEPS, vocab)
    db = trainer.device_batch(trainer.host_batch(batches[0]))
    got = profile_train.sched_step(trainer.model, db, profile_train.sched_coins(
        golden, 'cpu'))
    assert got['use'].sum() > 0
    assert profile_train.check_sched_step(got, got, golden) == ([], [])
    steps = profile_train.golden_steps('cpu', trainer, batches)
    assert profile_train.check_golden(
        steps, golden, profile_train.FINETUNE_LATER_UPDATE_RTOL) == []


def test_sched_step_rule_holds_gradients_and_ties(golden):
    """``check_sched_step`` on synthetic records: a gradient off by 2e-3
    of its leaf's largest entry fails, one off by 2.5e-4 passes; a
    fed-back prediction that differs fails unless the CPU margin is below
    ``NEAR_TIE``, and then only what the scan does not reach is held: KL,
    the property losses and the property heads' gradients."""
    T, L = len(golden['sched_step']['coins']), len(
        golden['sched_step']['coins'][0])
    dec, head = 'params/vae/decoder/W_root/kernel', \
        'params/property_optim/homo_linear/Dense_0/kernel'
    grads = {dec: np.array([1.0, -2.0]), head: np.array([0.5, 0.25])}
    cpu = dict(metrics=dict(golden['sched_step']['metrics']), grads=grads,
               pred=torch.zeros((T, L), dtype=torch.long),
               margin=torch.full((T, L), 1.0),
               use=torch.zeros((T, L), dtype=torch.bool))
    cpu['use'][1, 0] = True
    assert profile_train.check_sched_step(cpu, cpu, golden) == ([], [])
    off = dict(cpu, grads=dict(grads, **{dec: np.array([1.0, -2.0 + 4e-3])}))
    bad, _ = profile_train.check_sched_step(off, cpu, golden)
    assert len(bad) == 1 and bad[0].startswith(f'gradient of {dec}:')
    near = dict(cpu, grads=dict(grads, **{dec: np.array([1.0, -2.0 + 5e-4])}))
    assert profile_train.check_sched_step(near, cpu, golden) == ([], [])
    flip = dict(cpu, pred=cpu['pred'].clone())
    flip['pred'][1, 0] = 7
    bad, ties = profile_train.check_sched_step(flip, cpu, golden)
    assert len(ties) == 1 and len(bad) == 1
    near = dict(cpu, margin=cpu['margin'].clone())
    near['margin'][1, 0] = 5e-5
    bad, ties = profile_train.check_sched_step(flip, near, golden)
    assert bad == [] and len(ties) == 1
    # after the flip the scan's values are not held, the rest is
    m = golden['sched_step']['metrics']
    flip_off = dict(flip, grads=off['grads'], metrics=dict(
        m, Recs_Loss=m['Recs_Loss'] * 1.01, Word=m['Word'] - 0.5))
    assert profile_train.check_sched_step(flip_off, near, golden)[0] == []
    for grads_off, metrics_off in (
            ({head: np.array([0.5, 0.25 + 5e-3])}, {}),
            ({}, {'KL': m['KL'] * 1.01}),
            ({}, {'HOMO_MSE': m['HOMO_MSE'] + 1e-5})):
        bad, _ = profile_train.check_sched_step(dict(
            flip, grads=dict(grads, **grads_off),
            metrics=dict(m, **metrics_off)), near, golden)
        assert len(bad) == 1, bad


if __name__ == '__main__':
    with open(GOLDEN, 'w') as f:
        json.dump(jax_reference(), f, indent=1)
        f.write('\n')
