"""Shared builders of the tests of the port's GRU cell, untied embeddings
and bf16 encoders (``tests/test_torch_gru*.py``, ``test_torch_untied.py``,
``test_torch_bf16*.py``): each family's small batches in both packages,
noisy flax params, the JAX models' jitted loss and gradient, and the two
tolerance rules.

The f32 rule: losses within 1e-5 relative, each gradient leaf within 1e-4
of its largest entry in magnitude (or of 1e-3 of the largest entry of any
leaf).  The bf16 rule (``assert_bf16_rule``): the port's bf16 is no farther
from JAX's bf16, in the total and in each leaf's relative gradient norm
(floor 1e-3 of the largest leaf norm), than JAX's bf16 is from JAX's f32
on the same batch, both measured in the test.  Two kinds of leaf are held
to JAX's worst leaf instead of to themselves: the biases of the bf16
layers (the encoders' cells and ``W_o``), whose JAX gradient is a row sum
that XLA accumulates in bf16 in an order of its own (the port sums in f32
and rounds once, as its kernels do), and ``decoder/W_assm/bias``, whose
gradient is cancellation noise in both precisions.
"""

import csv
import functools
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import vae as jax_vae
from ggpm_tpu.train.loop import make_train_step
from ggpm_tpu.train.optim import default_group_fn as jax_group_fn
from ggpm_tpu.train.optim import make_multi_optimizer as jax_multi
from ggpm_tpu.train.optim import make_optimizer as jax_make_optimizer
from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import flatten, load_flax_params, to_flax_tree
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import MolGraph, tensorize
from ggpm_tpu_torch.graph.vocab import (PairVocab, common_atom_vocab,
                                        load_vocab_file)
from ggpm_tpu_torch.models import vae
from ggpm_tpu_torch.models.vae import ModelConfig, init_params
from ggpm_tpu_torch.profile_serve import HIER_VOCAB
from ggpm_tpu_torch.train import checkpoint as ckpt
from ggpm_tpu_torch.train.loop import signature, to_device
from test_torch_hier_train import _mu_by_leaf
from test_torch_sched import jax_coins

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CSV = os.path.join(ROOT, 'data', 'chem_data', 'train.csv')
HOPV_CSV = os.path.join(ROOT, 'data', 'hopv15.csv')
# the small widths (tests/test_torch_propopt.py, test_torch_hier_train.py)
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3,
             linear_hidden_size=16)
HSMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3,
              depthG=3, diterT=1, diterG=2, linear_hidden_size=8)
BATCH, HBATCH = 8, 6
BETA = 0.1
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
FLOOR = 1e-3
# registry name -> (port class, JAX class)
CLASSES = {'prop': (vae.PropertyVAE, jax_vae.PropertyVAE),
           'prop-opt': (vae.PropOptVAE, jax_vae.PropOptVAE),
           'prop-opt-sched': (vae.PropOptSchedulingVAE,
                              jax_vae.PropOptSchedulingVAE),
           'hier-prop': (vae.HierPropertyVAE, jax_vae.HierPropertyVAE),
           'hier-prop-opt': (vae.HierPropOptVAE, jax_vae.HierPropOptVAE)}


def _pack(plan_dict, pkg):
    return pkg.compact_plan_dict({k: np.asarray(v)
                                  for k, v in plan_dict.items()})


@functools.lru_cache(maxsize=None)
def motif_data(n_mols: int = 24):
    """A vocab over ``n_mols`` molecules of ``data/chem_data/train.csv``
    (no fragments) and each package's lane-packed model batches of 8 of
    them, rows 3 and 5 without a HOMO and a LUMO label."""
    saved = jax_mg.MolGraph.FRAGMENTS
    jax_mg.MolGraph.FRAGMENTS = set()
    try:
        with open(TRAIN_CSV) as f:
            rows = [[r['SMILES'].strip(), float(r['HOMO']), float(r['LUMO'])]
                    for r in csv.DictReader(f)][:n_mols]
        rows[3][1] = rows[5][2] = None
        labels = set()
        for s, _, _ in rows:
            for _, d in MolGraph(s, frozenset()).mol_tree.nodes(data=True):
                labels.add(d['label'])
                labels.update((d['smiles'], a) for _, a in d['inter_label'])
        pairs = sorted(labels)
        jvocab, vocab = JaxPairVocab(pairs), PairVocab(pairs)
        mbs, jbs, pbs = [], [], []
        for i in range(0, n_mols, BATCH):
            g = rows[i:i + BATCH]
            mb = batching.pad_batch(tensorize(g, vocab, common_atom_vocab))
            jb = jax_batching.to_model_batch(jax_batching.pad_batch(
                jax_mg.tensorize(g, jvocab, jax_avocab)), jvocab.mask,
                pad=False)
            pb = batching.to_model_batch(mb, vocab.mask, pad=False)
            mbs.append(mb)
            jbs.append(dict(jb, plan=_pack(jb['plan'], jax_batching)))
            pbs.append(dict(pb, plan=_pack(pb['plan'], batching)))
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = vocab.size()
    return dict(rows=rows, vocab=vocab, jvocab=jvocab, mbs=mbs, jbs=jbs,
                pbs=pbs, hv=hv, iv=iv, hier=False)


@functools.lru_cache(maxsize=None)
def hier_data(n_batches: int = 2):
    """The trained hier vocab in both packages and ``n_batches`` padded,
    unpacked batches of 6 HOPV molecules of one shape signature."""
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        jvocab, _ = jax_load_vocab(HIER_VOCAB)
        vocab = load_vocab_file(HIER_VOCAB)
        rows = prune_to_vocab(read_csv_data(HOPV_CSV), vocab, verbose=False)
        mbs, jbs, pbs, batch_rows = [], [], [], []
        for i in range(0, len(rows) - HBATCH + 1, HBATCH):
            r = rows[i:i + HBATCH]
            mb = batching.pad_batch(tensorize(r, vocab, common_atom_vocab))
            pb = batching.to_model_batch(mb, vocab.mask, pad=False)
            if pbs and signature(pb) != signature(pbs[0]):
                continue
            batch_rows.append(r)
            mbs.append(mb)
            pbs.append(pb)
            jbs.append(jax_batching.to_model_batch(jax_batching.pad_batch(
                jax_mg.tensorize(r, jvocab, jax_avocab)), jvocab.mask,
                pad=False))
            if len(mbs) == n_batches:
                break
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = vocab.size()
    return dict(rows=rows, vocab=vocab, jvocab=jvocab, mbs=mbs, jbs=jbs,
                pbs=pbs, hv=hv, iv=iv, hier=True, batch_rows=batch_rows)


def configs(data, **kw):
    """The port's and the JAX package's ``ModelConfig`` at the small width
    of ``data``'s family, dropout 0, with ``kw``."""
    small = HSMALL if data['hier'] else SMALL
    cfg = dict(hvocab_size=data['hv'], ivocab_size=data['iv'], dropout=0.0,
               **small, **kw)
    return ModelConfig(**cfg), jax_vae.ModelConfig(**cfg)


def small_params(cls, cfg, seed):
    """Flax-layout params of ``cls(cfg)`` from the port's flax-style init,
    perturbed on every leaf (and the log-variances of loss scaling at 0)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (x + rng.normal(0, 0.1, x.shape)).astype(np.float32),
        to_flax_tree(init_params(cls(cfg), torch.Generator().manual_seed(
            seed))))
    for v in params['params'].get('loss_weigh', {}).values():
        v[:] = 0
    return params


def port_model(cls, cfg, params):
    model = cls(cfg)
    load_flax_params(model, params)
    return model


@functools.lru_cache(maxsize=None)
def _jit_vag(jmodel):
    def jloss(p, b, rng):
        total, metrics, aux = jmodel.apply(p, b, BETA, rng, True, True)
        return total, (metrics, aux)
    return jax.jit(jax.value_and_grad(jloss, has_aux=True))


def eps_of(name, rng, data):
    """The latent noise JAX's model ``name`` draws from ``rng`` (``prop``
    and ``hier-prop`` from the key, the others from the first half of its
    split), and the breaker's (from the second)."""
    n = HBATCH if data['hier'] else BATCH
    rz, rc = jax.random.split(rng)
    if name in ('prop', 'hier-prop'):
        rz = rng
    return (torch.from_numpy(np.array(jax.random.normal(
        rz, (n, SMALL['latent_size'])))),
        torch.tensor(float(jax.random.normal(rc, ()))))


def device_batch(data, i):
    pb = data['pbs'][i]
    tables = (batching.hier_train_tables if data['hier'] else
              batching.train_tables)
    return to_device(tables(pb), 'cpu')


def jax_loss_and_grads(name, jcfg, params, data, i, rng):
    """The JAX model's total, metrics and gradient tree on batch ``i``."""
    jmodel = CLASSES[name][1](cfg=jcfg)
    (jl, (jmet, _)), jg = _jit_vag(jmodel)(
        params, jax.tree.map(jnp.asarray, data['jbs'][i]), rng)
    return float(jl), jmet, flatten(jax.tree.map(np.asarray, jg))


def port_loss_and_grads(name, cfg, params, data, i, eps=None,
                        clip_eps=None):
    """The port's total, metrics and flat gradient tree on batch ``i``
    (the latent's noise ``eps``, else its mean)."""
    model = port_model(CLASSES[name][0], cfg, params)
    kw = {}
    if clip_eps is not None and name in ('prop-opt', 'hier-prop-opt'):
        kw['clip_eps'] = clip_eps
    total, metrics, _ = model(device_batch(data, i), BETA,
                              eps=eps, perturb_z=eps is not None, **kw)
    total.backward()
    return total.item(), metrics, flatten(to_flax_tree(model,
                                                       lambda p: p.grad))


def check_f32(name, data, i=0, seed=0, tf_ratio=1.0, **kw):
    """The port's model ``name`` (config ``kw``) against the JAX model on
    batch ``i`` by the f32 rule: the total, every metric and every
    gradient leaf, both on the same noisy params.  The latent is sampled
    with JAX's noise, injected (the scheduled model takes its mean and
    JAX's coins at ``tf_ratio``).  Returns the port model after its
    backward."""
    cfg, jcfg = configs(data, **kw)
    params = small_params(CLASSES[name][0], cfg, seed)
    rng = jax.random.PRNGKey(7 + i)
    jmodel = CLASSES[name][1](cfg=jcfg)
    jb = jax.tree.map(jnp.asarray, data['jbs'][i])
    sched = name == 'prop-opt-sched'
    extra = (tf_ratio,) if sched else ()

    def jloss(p):
        total, metrics, _ = jmodel.apply(p, jb, BETA, rng, not sched, True,
                                         *extra)
        return total, metrics
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model = port_model(CLASSES[name][0], cfg, params)
    if sched:
        coins = jax_coins(data['jbs'][i]['plan'], tf_ratio, rng)
        kwargs = dict(perturb_z=False, tf_ratio=tf_ratio,
                      coins=None if tf_ratio == 1.0 else
                      torch.from_numpy(coins.copy()))
    else:
        eps, clip_eps = eps_of(name, rng, data)
        kwargs = dict(eps=eps)
        if name in ('prop-opt', 'hier-prop-opt'):
            kwargs['clip_eps'] = clip_eps
    total, metrics, _ = model(device_batch(data, i), BETA, **kwargs)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jl), rtol=LOSS_RTOL)
    assert_metrics(metrics, jmet)
    assert_grads(flatten(to_flax_tree(model, lambda p: p.grad)),
                 flatten(jax.tree.map(np.asarray, jg)),
                 data['hier'] and not kw.get('use_attention'))
    return model


# the hier decoder's ``W_assm/bias`` without attention: every assembly slot
# holds ``bias·z``, so its terms cancel and its exact gradient is zero
# (tests/test_torch_hier_train.py); both packages' values are rounding
# noise
ZERO_GRAD = 'decoder/W_assm/bias'
NOISE = 1e-6


def assert_grads(ours, theirs, hier=False):
    """The f32 rule on every leaf of two flat gradient trees.  With
    ``hier`` (the hier family without attention, whose assembly context is
    the latent) the leaf whose exact gradient is zero (``ZERO_GRAD``, under
    any prefix) is held, in both packages, below ``NOISE`` of the largest
    gradient entry of any leaf."""
    assert set(ours) == set(theirs)
    top = max(np.abs(v).max() for v in theirs.values())
    for k, v in theirs.items():
        if hier and k.endswith(ZERO_GRAD):
            assert np.abs(v).max() <= NOISE * top, k
            assert np.abs(ours[k]).max() <= NOISE * top, k
            continue
        scale = max(np.abs(v).max(), FLOOR * top)
        np.testing.assert_allclose(ours[k], v, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def assert_metrics(metrics, jmet):
    assert set(metrics) == set(jmet)
    for k, v in jmet.items():
        got = float(torch.as_tensor(metrics[k]).detach())
        if k in ('Word', 'I-Word', 'Topo', 'Assm'):
            assert abs(got - float(v)) <= 1e-7, k
        else:
            np.testing.assert_allclose(got, float(v), rtol=LOSS_RTOL,
                                       atol=1e-9, err_msg=k)


def grad_distances(a, b, ref):
    """Each leaf's ``|a - b| / max(|ref|, FLOOR · the largest |ref| of any
    leaf)``, norms over the leaf's entries."""
    top = max(np.linalg.norm(v) for v in ref.values())
    return {k: float(np.linalg.norm(a[k] - b[k]) /
                     max(np.linalg.norm(ref[k]), FLOOR * top))
            for k in ref}


def _own_bound(path):
    """Whether leaf ``path`` is held to its own JAX distance by the bf16
    rule (see the module docstring)."""
    bf16_bias = '_encoder/' in path and path.endswith('/bias')
    return not (bf16_bias or path.endswith(ZERO_GRAD))


def assert_bf16_rule(port_bf16, jax_bf16, jax_f32):
    """The bf16 rule on (loss, flat gradient tree) pairs of one batch;
    returns the distances (``bf16_distances``) for the docstrings."""
    ld, jld, pd, jd = bf16_distances(port_bf16, jax_bf16, jax_f32)
    assert ld <= jld, (ld, jld)
    worst = max(jd.values())
    over = {k: (pd[k], jd[k]) for k in pd
            if pd[k] > (jd[k] if _own_bound(k) else worst)}
    assert not over, over
    return ld, jld, max(pd.values()), worst


def case_ids(cases):
    return [f'{n}-{kw.get("rnn_type", "LSTM")}'
            f'{"-untied" if not kw.get("tie_embedding", True) else ""}'
            f'-b{i}{"-eps" if perturb else ""}'
            for n, kw, i, perturb in cases]


def bf16_references(data, cases, tmpdir):
    """JAX's strict bf16 and f32 totals, metrics and gradients of each case
    ``(name, options, batch, latent sampled)`` on seed-0 params, in one
    process (``jax_references``)."""
    specs = []
    for name, kw, i, perturb in cases:
        cfg, jcfg = configs(data, compute_dtype='bf16', **kw)
        specs.append(dict(
            name=name, params=flatten(small_params(CLASSES[name][0], cfg, 0)),
            cfg={k: v for k, v in vars(jcfg).items()
                 if k != 'compute_dtype'},
            batch=data['jbs'][i], rng=7 + i, perturb=perturb))
    return jax_references(specs, tmpdir)


def check_bf16(data, case, ref):
    """The port's bf16 case against its JAX references by the bf16 rule;
    returns the distances."""
    name, kw, i, perturb = case
    cfg, _ = configs(data, compute_dtype='bf16', **kw)
    params = small_params(CLASSES[name][0], cfg, 0)
    noise = eps_of(name, jax.random.PRNGKey(7 + i), data) if perturb \
        else (None, None)
    loss, _, grads = port_loss_and_grads(name, cfg, params, data, i, *noise)
    assert loss != ref['f32'][0]
    return assert_bf16_rule((loss, grads), ref['bf16'][::2],
                            ref['f32'][::2])


def bf16_distances(port_bf16, jax_bf16, jax_f32):
    """(port's loss distance, JAX's, port's leaf distances, JAX's): each
    argument a (loss, flat gradient tree) pair on one batch."""
    (pl, pg), (jl, jg), (fl, fg) = port_bf16, jax_bf16, jax_f32
    return (abs(pl - jl) / abs(jl), abs(jl - fl) / abs(fl),
            grad_distances(pg, jg, jg), grad_distances(jg, fg, fg))


# -- JAX's bf16 references, strict -------------------------------------------
#
# XLA:CPU rounds every bf16 primitive of a jitted forward (the port's bf16
# forward equals JAX's ``apply`` to the last bit at these widths), but in a
# gradient program it may keep some bf16 intermediates in f32 (its flag
# ``xla_allow_excess_precision``, on by default): that program's forward
# then differs from the model's own forward (by 2e-5 of the hier loss), so
# it is not one bf16 computation.  The references run with the flag off, in
# a process of their own (the flag is read once, when the backend starts),
# where the gradient program's forward equals ``apply``'s bit for bit.

STRICT_BF16 = '--xla_allow_excess_precision=false'


def jax_references(specs, tmpdir):
    """For each spec ``dict(name, cfg, params, batch, rng, perturb)`` (the
    registry name, the JAX ``ModelConfig`` keywords without
    ``compute_dtype``, a flat flax param dict, a JAX model batch of numpy
    arrays, the key's seed, whether the latent is sampled), JAX's total,
    metrics and flat gradient tree in bf16 and in f32, from a process with
    XLA's excess precision off: a list of ``{'bf16': (loss, metrics,
    grads), 'f32': (...)}``."""
    src, dst = os.path.join(tmpdir, 'specs.pkl'), os.path.join(tmpdir,
                                                               'refs.pkl')
    with open(src, 'wb') as f:
        pickle.dump(specs, f)
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=ROOT,
               XLA_FLAGS=STRICT_BF16)
    subprocess.run([sys.executable, os.path.abspath(__file__), src, dst],
                   env=env, check=True, cwd=ROOT)
    with open(dst, 'rb') as f:
        return pickle.load(f)


def _references(src, dst):
    torch.set_num_threads(1)
    with open(src, 'rb') as f:
        specs = pickle.load(f)
    out = []
    for s in specs:
        params = ckpt._unflatten(s['params'])
        batch = jax.tree.map(jnp.asarray, s['batch'])
        rng = jax.random.PRNGKey(s['rng'])
        refs = {}
        for key, dt in (('bf16', 'bf16'), ('f32', 'float32')):
            jmodel = CLASSES[s['name']][1](cfg=jax_vae.ModelConfig(
                compute_dtype=dt, **s['cfg']))

            def jloss(p, b, r, jmodel=jmodel):
                total, metrics, _ = jmodel.apply(p, b, BETA, r,
                                                 s['perturb'], True)
                return total, metrics
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                jloss, has_aux=True))(params, batch, rng)
            refs[key] = (float(loss), {k: float(v) for k, v in
                                       metrics.items()},
                         flatten(jax.tree.map(np.asarray, grads)))
        out.append(refs)
    with open(dst, 'wb') as f:
        pickle.dump(out, f)


# -- full-width JAX goldens of chip_smoke.py phase 14 ------------------------

def jax_train_steps(name, cfg_kw, params, vocab_path, hier, finetune):
    """The JAX package's first ``profile_train.GOLDEN_STEPS`` steps of the
    registry model ``name`` (JAX ``ModelConfig`` keywords ``cfg_kw``, flax
    ``params``) on the first HOPV batches of 20 in the vocab at
    ``vocab_path`` (padded; the motif family's lane-packed), at dropout 0
    with the latent's mean, β ``profile_train.BETA``: ``OPTIMIZER``, or with
    ``finetune`` one Adam a group at ``FINETUNE_LRS``.  Per-step metrics,
    per leaf the update along the gradient and the gradient's norm (read
    from Adam's first moment), and each group's gradient norm under the
    per-group optimizer; as ``profile_train.golden_steps`` records the
    port's."""
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        jvocab, _ = jax_load_vocab(vocab_path)
        rows = profile_train.hopv_rows(load_vocab_file(vocab_path))
        batches = []
        for i in range(profile_train.GOLDEN_STEPS):
            b = jax_batching.to_model_batch(jax_batching.pad_batch(
                jax_mg.tensorize(rows[20 * i:20 * i + 20], jvocab,
                                 jax_avocab)), jvocab.mask, pad=False)
            batches.append(b if hier else dict(b, plan=_pack(b['plan'],
                                                             jax_batching)))
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = jvocab.size()
    jmodel = CLASSES[name][1](cfg=jax_vae.ModelConfig(
        hvocab_size=hv, ivocab_size=iv, **cfg_kw))
    opt_kw = {k: v for k, v in profile_train.OPTIMIZER.items() if k != 'lr'}
    tx = (jax_multi(jax_group_fn, profile_train.FINETUNE_LRS, **opt_kw)
          if finetune else jax_make_optimizer(**profile_train.OPTIMIZER))
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
            steps[-1]['group_norms'] = {g: float(np.sqrt(v))
                                        for g, v in sorted(groups.items())}
    return steps


def strict_bf16_process():
    """Re-run this script in a process with XLA's excess precision off
    (``STRICT_BF16``) unless it is one already; call first in a golden
    writer that computes bf16."""
    if STRICT_BF16 not in os.environ.get('XLA_FLAGS', ''):
        env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=ROOT,
                   XLA_FLAGS=STRICT_BF16)
        os.execve(sys.executable, [sys.executable] + sys.argv, env)


def write_golden(path, golden):
    with open(path, 'w') as f:
        json.dump(golden, f, indent=1)
        f.write('\n')


if __name__ == '__main__':
    _references(*sys.argv[1:3])
