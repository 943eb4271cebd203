"""The port's latent search (``ggpm_tpu_torch/latent/control.py``) against
the JAX package's ``LatentOptimizer``, on the CPU, and the JAX reference
answers that chip_smoke.py holds the card's ``/optimize`` to.

The JAX functions are called directly: the JAX server and model-API tests
that would be the oracles read reference data absent from the test
machines.  The JAX package's search runs as one jitted ``while_loop`` and
reports only the searched latents, so the iterations it ran and why each
row stopped come from ``jax_masked_stats``, which replays the loop step
by step with the JAX optimizer's own ``_batched_losses`` and
``_grad_step`` and is held to its latents.

Tolerances: searched latents and predictions within 1e-5 absolute (the
heads' products in another summation order, through the steps), the
latents within 1e-4 at chip_smoke.py's settings, whose large steps
amplify that order; iterations and stop reasons equal.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_latent.py

rewrites ``ggpm_tpu_torch/goldens/optimize_hopv64.json`` from the JAX
package: for the 64 HOPV molecules of chip_smoke.py, with targets each
molecule's own HOMO + 0.01 and LUMO − 0.01 (Hartree), the JAX encoder's
latents searched by the JAX ``LatentOptimizer`` under each policy's
settings (``SEARCH``), the predictions there, the iterations, the rows
stopped by delta and by patience, the rows whose decisions came within
``NEAR`` of a threshold, and ``decode_best``'s strings.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.cli.common import read_csv_data as jax_read_csv
from ggpm_tpu.data.batching import to_model_batch as jax_to_model_batch
from ggpm_tpu.data.dataset import prune_to_vocab as jax_prune
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.latent.control import LatentOptimizer as JaxLatentOptimizer
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu.models.api import encode as jax_encode
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropOptVAE as JaxPropOptVAE
from ggpm_tpu_torch import profile_serve
from ggpm_tpu_torch.bridge import load_model, read_checkpoint, to_flax_tree
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.latent.control import LatentOptimizer
from ggpm_tpu_torch.models.decode import decode_best
from ggpm_tpu_torch.models.vae import ModelConfig, PropOptVAE, init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'optimize_hopv64.json')
DECODE_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                             'decode_hopv64.json')
ATOL = 1e-5
AMPLIFIED_ATOL = 1e-4   # searched latents at SEARCH's settings (amplified)
N_MOLS = 64
N_STRINGS = 8        # strings the test decodes again (all 64 in the golden)
MAX_DECODE_STEP = 150
OFFSETS = profile_serve.OPTIMIZE_OFFSETS
NEAR = 1e-6
# chip_smoke.py's settings (why these: profile_serve.OPTIMIZE_SETTINGS)
SEARCH = profile_serve.OPTIMIZE_SETTINGS
SMALL = dict(hvocab_size=12, ivocab_size=20, embed_size=16, hidden_size=16,
             latent_size=8, linear_hidden_size=16, depthT=2)


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def jax_fragments():
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


# -- the JAX side ----------------------------------------------------------

def jax_masked_stats(opt, z, h_tar, l_tar, use_delta):
    """The JAX ``_masked_optimize`` replayed step by step with the optimizer's
    own ``_batched_losses`` and ``_grad_step``: the searched latents, the
    iterations run, the rows stopped by delta and by patience, and per row
    the smallest distance of a decision from its threshold (the loss from
    delta, the loss from the previous one, the relative change from the
    patience threshold) over the iterations the row took part in."""
    half = z.shape[-1] // 2
    h, l = jnp.asarray(z[:, :half]), jnp.asarray(z[:, half:])
    h_tar, l_tar = jnp.asarray(h_tar), jnp.asarray(l_tar)
    b = z.shape[0]
    prev = np.zeros(b, np.float32)
    patience = np.full(b, opt.patience)
    done = np.zeros(b, bool)
    by_delta = np.zeros(b, bool)
    by_patience = np.zeros(b, bool)
    margin = np.full(b, np.inf)
    losses_fn, step_fn = jax.jit(opt._batched_losses), jax.jit(opt._grad_step)
    it = 0
    while not done.all() and it < max(opt.steps * 20, 1000):
        losses = np.asarray(losses_fn(h, l, h_tar, l_tar))
        hit = (losses <= opt.delta) if use_delta else np.zeros(b, bool)
        rel = np.abs(losses - prev) / np.maximum(np.abs(prev), 1e-12)
        worse = (losses > prev) | (rel <= opt.threshold)
        p_new = np.where(worse, patience - 1, opt.patience)
        live = ~done
        # how far the patience decision is from going the other way: the
        # stronger of its two clauses when it holds, the weaker when not
        m = np.where(worse, np.maximum(opt.threshold - rel, losses - prev),
                     np.minimum(rel - opt.threshold, prev - losses))
        if use_delta:
            m = np.minimum(m, np.abs(losses - opt.delta))
        margin = np.where(live, np.minimum(margin, m), margin)
        nh, nl, _ = step_fn(h, l, h_tar, l_tar)
        stepping = ~(done | hit)
        h = jnp.where(stepping[:, None], nh, h)
        l = jnp.where(stepping[:, None], nl, l)
        prev = np.where(stepping, losses, prev)
        patience = np.where(stepping, p_new, patience)
        spent = stepping & (p_new <= 0)
        by_delta |= live & hit
        by_patience |= spent
        done |= hit | spent
        it += 1
    return (np.concatenate([np.asarray(h), np.asarray(l)], -1), it,
            np.flatnonzero(by_delta).tolist(),
            np.flatnonzero(by_patience).tolist(), margin)


def jax_search(jmodel, params, z, h_tar, l_tar, policy, **kw):
    """The JAX package's searched latents and stats under ``policy``."""
    opt = JaxLatentOptimizer(jmodel, params, optimize_type=policy, **kw)
    z_opt = np.asarray(opt.optimize(jnp.asarray(z), h_tar, l_tar))
    if policy in ('hard', 'fixed'):
        return z_opt, dict(iterations=opt.steps, by_delta=[], by_patience=[],
                           near=[])
    z_rep, it, bd, bp, margin = jax_masked_stats(
        opt, z, np.asarray(h_tar, np.float32), np.asarray(l_tar, np.float32),
        policy == 'soft')
    # the replay is the JAX search
    np.testing.assert_allclose(z_rep, z_opt, rtol=0, atol=1e-6)
    return z_opt, dict(iterations=it, by_delta=bd, by_patience=bp,
                       near=np.flatnonzero(margin < NEAR).tolist())


def _jax_trained():
    vocab, _ = jax_load_vocab(VOCAB)
    hv, iv = vocab.size()
    model = JaxPropOptVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, rnn_type='LSTM', hidden_size=250,
        embed_size=250, latent_size=24, linear_hidden_size=128, depthT=20,
        dropout=0.0))
    return model, read_checkpoint(CKPT), vocab


def _jax_predict(jmodel, params, z):
    h, l = jmodel.apply(params, jnp.asarray(z),
                        method=lambda m, zz: m.predict_properties(zz))
    return np.asarray(h), np.asarray(l)


def hopv_inputs():
    """The JAX model, params and vocab, the 64 molecules, the JAX encoder's
    latents of them, and the targets."""
    jmodel, params, vocab = _jax_trained()
    rows = jax_prune(jax_read_csv(DATA), vocab, verbose=False)[:N_MOLS]
    batch = jax.tree.map(jnp.asarray, jax_to_model_batch(
        jax_mg.tensorize(rows, vocab, jax_avocab), vocab.mask, pad=False))
    z = np.asarray(jax_encode(jmodel, params, batch)[0])
    h_tar = np.array([r[1] for r in rows], np.float32) + OFFSETS['homo']
    l_tar = np.array([r[2] for r in rows], np.float32) + OFFSETS['lumo']
    return dict(jmodel=jmodel, params=params, vocab=vocab, rows=rows, z=z,
                homo=h_tar, lumo=l_tar)


def jax_reference():
    """The JAX package's answers to chip_smoke.py's /optimize requests."""
    t = hopv_inputs()
    out = dict(inputs=[r[0] for r in t['rows']], offsets=OFFSETS,
               homo=t['homo'].tolist(), lumo=t['lumo'].tolist(),
               max_decode_step=MAX_DECODE_STEP, near=NEAR, policies={})
    for policy, kw in SEARCH.items():
        z_opt, stats = jax_search(t['jmodel'], t['params'], t['z'],
                                  t['homo'], t['lumo'], policy, **kw)
        h, l = _jax_predict(t['jmodel'], t['params'], z_opt)
        _, smiles = jax_decode.decode_best(
            t['jmodel'], t['params'], t['vocab'], jax_avocab, z_opt,
            greedy=True, max_decode_step=MAX_DECODE_STEP)
        out['policies'][policy] = dict(settings=kw, homo=h.tolist(),
                                       lumo=l.tolist(), smiles=smiles,
                                       **stats)
    return out


# -- the small model ---------------------------------------------------------

@pytest.fixture(scope='module')
def small():
    """A small port PropOptVAE (random weights, the heads' biases
    perturbed) and the JAX model with the same weights."""
    model = PropOptVAE(ModelConfig(**SMALL))
    gen = torch.Generator().manual_seed(4)
    init_params(model, gen)
    with torch.no_grad():
        for p in model.property_optim.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    jmodel = JaxPropOptVAE(cfg=JaxModelConfig(rnn_type='LSTM', dropout=0.0,
                                              **SMALL))
    rng = np.random.default_rng(9)
    b = 10
    z = rng.normal(0, 1, (b, SMALL['latent_size'])).astype(np.float32)
    h_tar = rng.normal(-1.0, 0.5, b).astype(np.float32)
    l_tar = rng.normal(0.5, 0.5, b).astype(np.float32)
    return dict(model=model.eval(), jmodel=jmodel,
                params=to_flax_tree(model), z=z, homo=h_tar, lumo=l_tar)


# soft and patience with their stopping rules in play: rows stop by delta
# and by patience, and patience is reset along the way
SMALL_SEARCH = dict(latent_lr=0.05, property_optim_step=20,
                    property_delta=0.3, patience=3, patience_threshold=0.02)


def _port_search(model, z, h_tar, l_tar, policy, **kw):
    opt = LatentOptimizer(model, optimize_type=policy, **kw)
    z_opt = opt.optimize(z, h_tar, l_tar)
    return z_opt.numpy(), opt.stats()


@pytest.mark.parametrize('policy', ['soft', 'patience', 'fixed', 'hard'])
def test_policy_matches_jax_small(small, policy):
    s = small
    want, wstats = jax_search(s['jmodel'], s['params'], s['z'], s['homo'],
                              s['lumo'], policy, **SMALL_SEARCH)
    got, stats = _port_search(s['model'], s['z'], s['homo'], s['lumo'],
                              policy, **SMALL_SEARCH)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got - s['z']).max() > 1e-3          # the search moved
    assert {k: stats[k] for k in ('iterations', 'by_delta', 'by_patience')} \
        == {k: wstats[k] for k in ('iterations', 'by_delta', 'by_patience')}
    if policy == 'soft':
        assert stats['by_delta'] and stats['by_patience']
    if policy == 'patience':
        # some row kept its patience past the first few steps
        assert stats['iterations'] > SMALL_SEARCH['patience'] + 1


def _torch_replica(model, z, h_tar, l_tar, use_delta, lr, delta, patience,
                   threshold):
    """Per-sample replica of the reference's soft/patience control flow
    (property_control.py:71-157, as tests/test_latent.py replays it for the
    JAX package): the loss, then (soft) the delta break before the step,
    then patience against the previous loss, then the step, then the
    ``while patience > 0`` check; the iteration that exhausts patience
    still takes its step.  A batch of one row: the sum is its own loss."""
    one = LatentOptimizer(model, optimize_type='hard', latent_lr=lr)
    po = model.property_optim
    heads = [[(m.weight.detach(), m.bias.detach())
              for m in (h.Dense_0, h.Dense_1)]
             for h in (po.homo_linear, po.lumo_linear)]
    half = z.shape[1] // 2
    out = []
    for i in range(z.shape[0]):
        h = torch.from_numpy(z[i:i + 1, :half])
        l = torch.from_numpy(z[i:i + 1, half:])
        ht, lt = (torch.from_numpy(t[i:i + 1]) for t in (h_tar, l_tar))
        prev, left = 0.0, patience
        while left > 0:
            losses, nh, nl = one._losses_and_step(heads, h, l, ht, lt, False)
            loss = float(losses[0])
            if use_delta and loss <= delta:
                break
            if loss > prev or abs(loss - prev) / max(abs(prev), 1e-12) \
                    <= threshold:
                left -= 1
            else:
                left = patience
            prev = loss
            h, l = nh, nl
        out.append(torch.cat([h, l], -1).numpy())
    return np.concatenate(out)


@pytest.mark.parametrize('policy', ['soft', 'patience'])
def test_masked_search_takes_the_reference_order(small, policy):
    s = small
    kw = {k: SMALL_SEARCH[k] for k in ('latent_lr', 'property_delta',
                                       'patience', 'patience_threshold')}
    got, _ = _port_search(s['model'], s['z'], s['homo'], s['lumo'], policy,
                          **kw)
    want = _torch_replica(s['model'], s['z'], s['homo'], s['lumo'],
                          policy == 'soft', kw['latent_lr'],
                          kw['property_delta'], kw['patience'],
                          kw['patience_threshold'])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize('policy', ['soft', 'patience', 'hard'])
def test_nan_targets_as_jax_gives_them(small, policy):
    """A NaN target makes its row's half NaN under hard and patience, as
    the JAX package's masked loss back-propagates 0 · 2(x − NaN); under
    soft a row whose loss, with its NaN terms left out, is within delta
    stops at once.  The port gives what JAX gives, NaN for NaN."""
    s = small
    h_tar, l_tar = s['homo'].copy(), s['lumo'].copy()
    h_tar[[1, 4]] = np.nan
    l_tar[[4, 7]] = np.nan
    kw = dict(SMALL_SEARCH, property_delta=1e-3)
    want, wstats = jax_search(s['jmodel'], s['params'], s['z'], h_tar, l_tar,
                              policy, **kw)
    got, stats = _port_search(s['model'], s['z'], h_tar, l_tar, policy, **kw)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    half = SMALL['latent_size'] // 2
    if policy == 'soft':
        # row 4 has no label at all: loss 0, stopped by delta, unmoved
        assert 4 in stats['by_delta']
        np.testing.assert_array_equal(got[4], s['z'][4])
    else:
        assert np.isnan(got[1, :half]).all() and np.isnan(got[7, half:]).all()
        assert not np.isnan(got[1, half:]).any()
    assert stats['by_delta'] == wstats['by_delta']


def test_unknown_policy_raises_the_jax_text(small):
    with pytest.raises(ValueError) as ours:
        LatentOptimizer(small['model'], optimize_type='bogus')
    with pytest.raises(ValueError) as theirs:
        JaxLatentOptimizer(small['jmodel'], small['params'],
                           optimize_type='bogus')
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize('policy', ['soft', 'patience'])
def test_rows_search_alone_as_in_the_batch(small, policy):
    """A finished row is frozen while the others go on: each row searched
    alone gives its row of the batched search and its stop reason, and the
    batch runs as many iterations as its longest row."""
    s = small
    batched, st = _port_search(s['model'], s['z'], s['homo'], s['lumo'],
                               policy, **SMALL_SEARCH)
    longest = 0
    for i in range(len(s['z'])):
        row, sti = _port_search(s['model'], s['z'][i:i + 1],
                                s['homo'][i:i + 1], s['lumo'][i:i + 1],
                                policy, **SMALL_SEARCH)
        np.testing.assert_allclose(row[0], batched[i], rtol=0, atol=ATOL)
        assert (sti['by_delta'] == [0]) == (i in st['by_delta'])
        assert (sti['by_patience'] == [0]) == (i in st['by_patience'])
        longest = max(longest, sti['iterations'])
    assert st['iterations'] == longest


@pytest.mark.parametrize('policy', ['soft', 'patience', 'fixed', 'hard'])
def test_search_runs_inside_inference_mode(small, policy):
    """The server and the profilers may call it under inference_mode (or
    no_grad), with an inference tensor for the latents."""
    s = small
    want, _ = _port_search(s['model'], s['z'], s['homo'], s['lumo'], policy,
                           **SMALL_SEARCH)
    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            z = torch.from_numpy(s['z'])
            opt = LatentOptimizer(s['model'], optimize_type=policy,
                                  **SMALL_SEARCH)
            got = opt.optimize(z, s['homo'], s['lumo'])
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want - s['z']).max() > 0


@pytest.mark.parametrize('policy', ['soft', 'patience'])
def test_search_cap_is_exact(small, policy):
    """A search that never stops runs exactly max(20·steps, 1000)
    iterations."""
    s = small
    for steps, cap in ((60, 1200), (20, 1000)):
        opt = LatentOptimizer(s['model'], optimize_type=policy, latent_lr=0.0,
                              property_optim_step=steps, property_delta=-1.0,
                              patience=10 ** 9)
        got = opt.optimize(s['z'], s['homo'], s['lumo'])
        assert opt.stats() == dict(iterations=cap, by_delta=[],
                                   by_patience=[])
        np.testing.assert_array_equal(got.numpy(), s['z'])


# -- the trained heads on the 64 HOPV latents --------------------------------

@pytest.fixture(scope='module')
def hopv(jax_fragments):
    t = hopv_inputs()
    t['model'], t['pvocab'] = load_model(CKPT, VOCAB, device='cpu')
    return t


@pytest.fixture(scope='module')
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


# settings that move the latents at the trained heads without the
# amplification of SEARCH's (``patience`` keeps the default threshold, and
# rows reset their patience along the 173 iterations)
TRAINED_SEARCH = {
    'soft': dict(latent_lr=100.0, property_delta=2e-4, patience_threshold=1.0),
    'patience': dict(latent_lr=30.0),
    'fixed': {}, 'hard': {},
}


def _assert_same_search(t, policy, kw):
    """The port's search against the JAX package's from the same latents:
    the iterations and stop reasons equal; returns both searched latents
    and both predictions there."""
    want, wstats = jax_search(t['jmodel'], t['params'], t['z'], t['homo'],
                              t['lumo'], policy, **kw)
    got, stats = _port_search(t['model'], t['z'], t['homo'], t['lumo'],
                              policy, **kw)
    assert {k: stats[k] for k in ('iterations', 'by_delta', 'by_patience')} \
        == {k: wstats[k] for k in ('iterations', 'by_delta', 'by_patience')}
    with torch.no_grad():
        pred = [x.numpy() for x in t['model'].predict_properties(
            torch.from_numpy(got))]
    jpred = _jax_predict(t['jmodel'], t['params'], want)
    for a, b in zip(pred, jpred):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    return got, want, jpred, wstats


@pytest.mark.parametrize('policy', ['soft', 'patience', 'fixed', 'hard'])
def test_trained_heads_match_jax(hopv, policy):
    """Each policy at the trained heads on the JAX encoder's latents of
    the 64 molecules (``fixed`` is ``hard``): searched latents and
    predictions within 1e-5, the same iterations and stop reasons."""
    kw = TRAINED_SEARCH[policy]
    got, want, _, _ = _assert_same_search(hopv, policy, kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(want - hopv['z']).max() > 1e-3


@pytest.mark.parametrize('policy', sorted(SEARCH))
def test_golden_settings_match_jax_and_the_golden(hopv, golden, policy):
    """chip_smoke.py's settings: the port against the JAX package, and the
    JAX package against the golden (predictions, iterations, stop reasons
    and near rows), and the first strings decoded by both packages.  At
    latent_lr 500 the five steps move rows by up to 20 and amplify the
    heads' rounding differences with them (4.0e-5 at most on the CPU), so
    the searched latents are held within ``AMPLIFIED_ATOL``; the
    predictions there within 1e-5."""
    t = hopv
    kw = SEARCH[policy]
    got, want, (jh, jl), wstats = _assert_same_search(t, policy, kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=AMPLIFIED_ATOL)
    g = golden['policies'][policy]
    assert g['settings'] == kw
    np.testing.assert_allclose(jh, g['homo'], rtol=0, atol=1e-7)
    np.testing.assert_allclose(jl, g['lumo'], rtol=0, atol=1e-7)
    assert {k: wstats[k] for k in ('iterations', 'by_delta', 'by_patience',
                                   'near')} == \
        {k: g[k] for k in ('iterations', 'by_delta', 'by_patience', 'near')}
    _, jsmiles = jax_decode.decode_best(
        t['jmodel'], t['params'], t['vocab'], jax_avocab, want[:N_STRINGS],
        greedy=True, max_decode_step=MAX_DECODE_STEP)
    _, smiles = decode_best(t['model'], t['pvocab'], common_atom_vocab,
                            got[:N_STRINGS], max_decode_step=MAX_DECODE_STEP)
    assert smiles == jsmiles == g['smiles'][:N_STRINGS]


def test_control_decode_matches_jax(hopv):
    """``control_decode`` (encode, search, predict, the exact decode with
    per-step logs) on 4 molecules against the JAX package's, hard at lr
    20."""
    from ggpm_tpu.latent.control import control_decode as jax_control
    from ggpm_tpu_torch.data.batching import to_model_batch
    from ggpm_tpu_torch.graph.mol_graph import tensorize
    from ggpm_tpu_torch.latent.control import control_decode
    t = hopv
    rows = t['rows'][:4]
    homo, lumo = t['homo'][:4], t['lumo'][:4]
    jbatch = jax.tree.map(jnp.asarray, jax_to_model_batch(
        jax_mg.tensorize(rows, t['vocab'], jax_avocab), t['vocab'].mask,
        pad=False))
    (jh, jl), jres, jsmiles = jax_control(
        t['jmodel'], t['params'], t['vocab'], jax_avocab, jbatch, homo, lumo,
        JaxLatentOptimizer(t['jmodel'], t['params'], optimize_type='hard',
                           latent_lr=20.0))
    batch = to_model_batch(tensorize(rows, t['pvocab'], common_atom_vocab),
                           t['pvocab'].mask, pad=False)
    (h, l), res, smiles = control_decode(
        t['model'], t['pvocab'], common_atom_vocab, batch, homo, lumo,
        LatentOptimizer(t['model'], optimize_type='hard', latent_lr=20.0))
    assert smiles == jsmiles
    np.testing.assert_allclose(h, np.asarray(jh), rtol=0, atol=ATOL)
    np.testing.assert_allclose(l, np.asarray(jl), rtol=0, atol=ATOL)
    assert [len(r) for r in res] == [len(r) for r in jres]


def test_golden_inputs_and_settings(golden):
    """The golden is for chip_smoke.py's request, and its soft and
    patience settings change at least half of the 64 decodes from the
    plain reconstruction (decode_hopv64.json)."""
    rows = prune_to_vocab(read_csv_data(DATA), load_model(
        CKPT, VOCAB, device='cpu')[1], verbose=False)[:N_MOLS]
    assert golden['inputs'] == [r[0] for r in rows]
    np.testing.assert_allclose(golden['homo'], [r[1] + 0.01 for r in rows],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(golden['lumo'], [r[2] - 0.01 for r in rows],
                               rtol=0, atol=1e-7)
    assert {p: g['settings'] for p, g in golden['policies'].items()} == SEARCH
    with open(DECODE_GOLDEN) as f:
        rec = json.load(f)['reconstruct']
    for policy in ('soft', 'patience'):
        g = golden['policies'][policy]
        assert sum(a != b for a, b in zip(g['smiles'], rec)) >= N_MOLS // 2
        assert len(g['smiles']) == N_MOLS
    assert golden['policies']['soft']['by_delta']


if __name__ == '__main__':
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        ref = jax_reference()
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    with open(GOLDEN, 'w') as f:
        json.dump(ref, f, indent=1)
        f.write('\n')
