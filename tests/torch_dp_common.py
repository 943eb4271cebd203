"""What tests/test_torch_parallel.py and tests/test_torch_parallel_tp.py
share: the small ``prop`` and ``hier-prop`` setups of both packages, the
spawned gloo ranks (``tests/torch_dp_worker.py``) and the checks that hold
their steps to JAX's (the module docstring of test_torch_parallel.py
states the tolerances)."""

import csv
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models.vae import HierPropertyVAE as JaxHierPropertyVAE
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropertyVAE as JaxPropertyVAE
from ggpm_tpu.parallel.mesh import make_dp_train_step as jax_dp_step
from ggpm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ggpm_tpu.parallel.mesh import shard_model_batches
from ggpm_tpu.train.optim import make_optimizer as jax_make_optimizer
from ggpm_tpu_torch.bridge import flatten, to_flax_tree
from ggpm_tpu_torch.data import batching
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import MolGraph, tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file
from ggpm_tpu_torch.models.vae import HierPropertyVAE, ModelConfig, init_params
from ggpm_tpu_torch.profile_serve import HIER_VOCAB
from ggpm_tpu_torch.train.loop import signature

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_dp_worker.py')
TRAIN_CSV = os.path.join(ROOT, 'data', 'chem_data', 'train.csv')
HOPV = os.path.join(ROOT, 'data', 'hopv15.csv')
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3)
HIER_SMALL = dict(embed_size=32, hidden_size=32, latent_size=8,
                  linear_hidden_size=8, depthT=3, depthG=3, diterT=1,
                  diterG=3)
BATCH = 8
N_MOLS = 96
OPT = dict(lr=1e-3, clip_norm=20.0, anneal_rate=0.9, steps_per_epoch=3)
BETA = 0.1
# small enough that the 126-row attachment embedding and the 126-wide icls
# kernel of the small vocab are split (into 2 × 63 rows; JAX's device_put
# needs a split dimension to divide evenly)
TP_MIN_DIM = 40
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-3
ACCURACIES = ('Word', 'I-Word', 'Topo', 'Assm')


@pytest.fixture(scope='module', autouse=True)
def jax_fragments():
    """The JAX vocab loader sets the class-level fragment set that JAX's
    ``tensorize`` reads: restored after the module."""
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


def _train_rows():
    with open(TRAIN_CSV) as f:
        return [[r['SMILES'].strip(), float(r['HOMO']), float(r['LUMO'])]
                for r in csv.DictReader(f)][:N_MOLS]


def _packed(b):
    return dict(b, plan=jax_batching.compact_plan_dict(
        {k: np.asarray(v) for k, v in b['plan'].items()}))


@pytest.fixture(scope='module')
def prop(jax_fragments):
    """The small ``prop`` setup: the vocab of the first 96 molecules'
    motifs, the JAX model with noisy params, and each 8-molecule batch's
    JAX model batch (lane-packed)."""
    jax_mg.MolGraph.FRAGMENTS = set()
    rows = _train_rows()
    labels = set()
    for s, _, _ in rows:
        for _, d in MolGraph(s, frozenset()).mol_tree.nodes(data=True):
            labels.add(d['label'])
            labels.update((d['smiles'], a) for _, a in d['inter_label'])
    pairs = sorted(labels)
    jvocab = JaxPairVocab(pairs)
    jbs = [_packed(jax_batching.to_model_batch(jax_batching.pad_batch(
        jax_mg.tensorize(rows[i:i + BATCH], jvocab, jax_avocab)),
        jvocab.mask, pad=False)) for i in range(0, N_MOLS, BATCH)]
    hv, iv = jvocab.size()
    cfg = dict(hvocab_size=hv, ivocab_size=iv, **SMALL)
    jmodel = JaxPropertyVAE(cfg=JaxModelConfig(rnn_type='LSTM', dropout=0.0,
                                               **cfg))
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda b: jmodel.init({'params': key, 'dropout': key},
                                           b, BETA, key, False, True))(
        jax.tree.map(jnp.asarray, jbs[0]))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (np.asarray(x) + rng.normal(
        0, 0.1, x.shape)).astype(np.float32), params)
    return dict(rows=rows, pairs=pairs, jvocab=jvocab, jbs=jbs, cfg=cfg,
                jmodel=jmodel, params=params)


@pytest.fixture(scope='module')
def hier(jax_fragments):
    """The small ``hier-prop`` setup over the trained hier vocab: two
    unpacked batches of 6 HOPV molecules of one signature, and the params
    (the port's flax-style init with noise)."""
    jvocab, _ = jax_load_vocab(HIER_VOCAB)
    vocab = load_vocab_file(HIER_VOCAB)
    rows = prune_to_vocab(read_csv_data(HOPV), vocab, verbose=False)
    picked, jbs, sig0 = [], [], None
    for i in range(0, len(rows) - 6 + 1, 6):
        pb = batching.to_model_batch(batching.pad_batch(tensorize(
            rows[i:i + 6], vocab, common_atom_vocab)), vocab.mask, pad=False)
        sig0 = sig0 or signature(pb)
        if signature(pb) != sig0:
            continue
        picked.append(i)
        jbs.append(jax_batching.to_model_batch(jax_batching.pad_batch(
            jax_mg.tensorize(rows[i:i + 6], jvocab, jax_avocab)),
            jvocab.mask, pad=False))
        if len(picked) == 2:
            break
    hv, iv = vocab.size()
    cfg = dict(hvocab_size=hv, ivocab_size=iv, **HIER_SMALL)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: (x + rng.normal(0, 0.1, x.shape)).astype(np.float32),
        to_flax_tree(init_params(HierPropertyVAE(ModelConfig(**cfg)),
                                 torch.Generator().manual_seed(0))))
    jmodel = JaxHierPropertyVAE(cfg=JaxModelConfig(rnn_type='LSTM',
                                                   dropout=0.0, **cfg))
    return dict(rows=rows, starts=picked, jbs=jbs, cfg=cfg, jmodel=jmodel,
                params=params)


# -- spawned ranks -------------------------------------------------------------

def _spawn(tmp_path, world, spec):
    """Start ``world`` worker ranks on ``spec`` (a dict, pickled into
    ``tmp_path``); returns a function that waits for them and loads each
    rank's report."""
    spec = dict(spec, init=f'file://{tmp_path}/rendezvous',
                out=str(tmp_path / 'rank'))
    path = tmp_path / 'spec.pkl'
    with open(path, 'wb') as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    env.pop('JAX_PLATFORMS', None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(path), str(r),
                               str(world)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def wait():
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f'rank {r}:\n{out}'
        reports = []
        for r in range(world):
            with open(f'{spec["out"]}{r}.pkl', 'rb') as f:
                reports.append(pickle.load(f))
        return reports
    return wait


def _prop_spec(prop, groups, **kw):
    return dict(model='prop', cfg=prop['cfg'], pairs=prop['pairs'],
                rows=prop['rows'], batch=BATCH, groups=groups,
                params=prop['params'], opt=OPT, beta=BETA, **kw)


# -- the checks ------------------------------------------------------------------

def _assert_grads(ours, theirs):
    assert set(ours) == set(theirs)
    top = max(np.abs(v).max() for v in theirs.values())
    for k, v in theirs.items():
        scale = max(np.abs(v).max(), 1e-3 * top)
        np.testing.assert_allclose(ours[k], v, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def _noise(grads, masks=None):
    """Per leaf, the entries whose gradient is rounding noise, or'ed into
    ``masks`` of earlier steps (Adam's moments carry a noisy step on)."""
    total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                        for v in grads.values()))
    return {k: (np.abs(v) < 1e-6 * total) | (
        masks[k] if masks is not None else False) for k, v in grads.items()}


def _assert_updates(before, after, jbefore, jafter, noise):
    for k in jbefore:
        d = np.asarray(jafter[k], np.float64) - jbefore[k]
        ours = np.asarray(after[k], np.float64) - before[k]
        keep = ~noise[k]
        assert np.linalg.norm(ours[keep] - d[keep]) <= \
            UPDATE_RTOL * np.linalg.norm(d[keep]), k


def _assert_metrics(ours, theirs, rtol):
    for k, v in theirs.items():
        v = float(v)
        if k in ACCURACIES:
            assert ours[k] == pytest.approx(v, abs=1e-7), k
        else:
            assert ours[k] == pytest.approx(v, rel=rtol, abs=1e-9), k


def _assert_same_on_every_rank(reports):
    for step in range(len(reports[0]['steps'])):
        digests = {r['steps'][step]['digest'] for r in reports}
        assert len(digests) == 1, (step, digests)


def _hold(reports, jstep, params, jbs, groups, place=None):
    """Run JAX's step over ``groups`` and hold every rank's steps to it:
    metrics, the mean gradient at the first step (read from Adam's first
    moment), each leaf's update at every step."""
    tx = jax_make_optimizer(**OPT)
    p = jax.tree.map(jnp.asarray, params)
    st = tx.init(p)
    noise = [None] * len(reports)
    for i, group in enumerate(groups):
        jbefore = flatten(jax.tree.map(np.array, p))
        stacked = shard_model_batches([jbs[j] for j in group], jstep.mesh)
        if place is not None:
            p, st, stacked = place(p, st, stacked)
        p, st, metrics, _ = jstep(p, st, stacked, jax.random.PRNGKey(i))
        jafter = flatten(jax.tree.map(np.array, p))
        for n, r in enumerate(reports):
            s = r['steps'][i]
            _assert_metrics(s['metrics'], metrics,
                            LOSS_RTOL if i == 0 else GRAD_RTOL)
            if i == 0:
                # Adam's first moment holds the clipped gradient
                clip = min(1.0, OPT['clip_norm'] / s['metrics']['GNorm'])
                mu = flatten(jax.tree.map(np.asarray, st[1].mu))
                _assert_grads({k: v * clip for k, v in s['grads'].items()},
                              {k: v / 0.1 for k, v in mu.items()})
            noise[n] = _noise(s['grads'], noise[n])
            _assert_updates(s['before'], s['after'], jbefore, jafter,
                            noise[n])
    _assert_same_on_every_rank(reports)


def _jax_dp(jmodel, n):
    mesh = jax_make_mesh(n)
    step = jax_dp_step(jmodel, jax_make_optimizer(**OPT), mesh, beta=BETA,
                       perturb_z=False)
    step.mesh = mesh
    return step


