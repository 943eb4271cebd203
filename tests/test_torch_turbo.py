"""The port's turbo decode against the JAX package's, on the CPU: the
assembly oracle's tables, the propose loop's traces (JAX ``dec_propose``
against a round of the port's ``Proposer``, run eagerly), the host replay (``_replay_pinned``), and ``decode_motif_turbo`` against the
exact path and against the JAX package's answers.

Small width: the noisy small JAX model of ``tests/test_torch_decode.py``
over the golden molecules, bridged to the port.  Full width: the trained
HOPV checkpoint.  Integer columns of a trace (choice, motif and attachment
ids, committed beam, committed attachment, feasibility bits) and the root
motifs are held exactly; the topology logits and beam scores within 1e-5
absolute plus 1e-5 relative (scores reach magnitude 20 and more, where
products of width 250 summed in another order differ by a few ulps).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import PairVocab as JaxPairVocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import PairVocab, common_atom_vocab
from ggpm_tpu_torch.graph.vocab import load_vocab_file
from ggpm_tpu_torch.models import decode
from ggpm_tpu_torch.models.api import encode
from ggpm_tpu_torch.ops.nei_sum import count_launch
from test_torch_decode import (CKPT, DATA, GOLDEN, VOCAB,  # noqa: F401
                               _jax_latents, _jax_trained, jax_fragments,
                               small)

torch.set_num_threads(1)

POLYMERS_VOCAB = CKPT.replace('QUALITY_hopv.json.ckpt',
                              'QUALITY_polymers_test_full.json.vocab.txt')
BEAM = 5
C = 5 + 3 * BEAM
INT_COLS = [1] + list(range(2 + BEAM, C))
FLOAT_COLS = [0] + list(range(2, 2 + BEAM))
TOL = 1e-5


def _golden_pairs(golden_smiles):
    """The small model's vocab pairs (as the ``small`` fixture builds them)."""
    jax_mg.MolGraph.FRAGMENTS = set()
    labels = set()
    for s in golden_smiles:
        for _, d in jax_mg.MolGraph(s).mol_tree.nodes(data=True):
            labels.add(d['label'])
            for _, anc in d['inter_label']:
                labels.add((d['smiles'], anc))
    return sorted(labels)


@pytest.fixture(scope='module')
def tiny(small, golden_smiles):
    pairs = _golden_pairs(golden_smiles)
    jvocab, vocab = JaxPairVocab(pairs), PairVocab(pairs)
    model = small['model']
    rows = [[s, None, None] for s in golden_smiles]
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    z_rec = encode(model, batch)[0].numpy()
    return dict(small, jvocab=jvocab, vocab=vocab, z_rec=z_rec,
                jtabs=jax_decode._assm_tables(jvocab, jax_avocab))


@pytest.fixture(scope='module')
def hopv(jax_fragments):
    jmodel, params, jvocab = _jax_trained()
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:64]
    z = np.array(_jax_latents(jmodel, params, jvocab, rows))
    return dict(jmodel=jmodel, params=params, jvocab=jvocab, model=model,
                vocab=vocab, z=z,
                jtabs=jax_decode._assm_tables(jvocab, jax_avocab))


# -- the oracle's tables -------------------------------------------------------

@pytest.mark.parametrize('path', [VOCAB, POLYMERS_VOCAB],
                         ids=['hopv', 'polymers'])
def test_assm_tables_match_jax(jax_fragments, path):
    jvocab, _ = jax_load_vocab(path)
    vocab = load_vocab_file(path)
    theirs = jax_decode._assm_tables(jvocab, jax_avocab)
    ours = decode._assm_tables(vocab, common_atom_vocab)
    assert ours.keys() == theirs.keys()
    for k, t in theirs.items():
        t, o = np.asarray(t), ours[k].numpy()
        assert o.dtype == t.dtype, k
        np.testing.assert_array_equal(o, t, err_msg=k)
    assert decode._assm_tables(vocab, common_atom_vocab) is ours


# -- the propose loop's traces -----------------------------------------------

def _round(model, vocab, z, pins, T, lookahead=0):
    """One eager propose round of the port's turbo decode (``Proposer``
    driven by ``_Round`` through the ``_RoundQueue``, as ``_turbo`` drives
    it) over latents ``z`` and pins [3, T, B]: (packed, root_cls,
    root_icls, steps active) as numpy, the steps run, and the carry."""
    tabs, mask = decode._device_vocab(vocab, common_atom_vocab,
                                      torch.device('cpu'))
    with torch.inference_mode():
        prop = decode.Proposer(model, mask, tabs, BEAM, T, len(z),
                               graph=False)
        out, queued = decode.propose_round(prop, torch.from_numpy(z), pins,
                                           lookahead)
        return out, queued, prop.carry


def _propose_both(setup, z, pins, T):
    """JAX ``dec_propose`` through ``MotifDecodeKernel.propose`` and the
    port's propose round, on the same latents and pins ([3, T, B] op, clab,
    ilab), u = 0.5; returns both (packed, root_cls, root_icls) as numpy."""
    kern = jax_decode._get_kernel(jax_decode.MotifDecodeKernel,
                                  setup['jmodel'], setup['params'],
                                  setup['jvocab'].mask, BEAM)
    u = np.full((T, z.shape[0]), 0.5, np.float32)
    theirs = kern.propose(jnp.asarray(z), jnp.asarray(u),
                          *(jnp.asarray(p.astype(np.int32)) for p in pins),
                          setup['jtabs'])
    ours = _round(setup['model'], setup['vocab'], z, pins, T)[0][:3]
    return [np.asarray(x) for x in theirs], list(ours)


def _check_trace(theirs, ours):
    (jp, jrc, jri), (p, rc, ri) = theirs, ours
    np.testing.assert_array_equal(rc, jrc)
    np.testing.assert_array_equal(ri, jri)
    assert p.shape == jp.shape
    np.testing.assert_array_equal(p[..., INT_COLS], jp[..., INT_COLS])
    np.testing.assert_allclose(p[..., FLOAT_COLS], jp[..., FLOAT_COLS],
                               rtol=TOL, atol=TOL)
    # rows past the loop's end are zero in both
    live = np.abs(jp).sum(axis=(1, 2)) > 0
    np.testing.assert_array_equal(np.abs(p).sum(axis=(1, 2)) > 0, live)
    return int(live.sum())


def _jax_pins(setup, z, T):
    """Every sample's ``rs.pins`` after the JAX package replays its free
    trace: the executed prefix, with ops 1, 2 and 3 where they occurred."""
    (jp, jrc, jri), _ = _propose_both(setup, z, np.zeros((3, T, len(z)),
                                                         np.int64), T)
    pins = np.zeros((3, T, len(z)), np.int64)
    for j in range(len(z)):
        rs = jax_decode._ReplayState(setup['jvocab'], jax_avocab, 400, 500,
                                     12)
        jax_decode._replay_pinned(jp[:, j], jrc[j], jri[j], rs,
                                  setup['jvocab'], BEAM)
        for t, pin in enumerate(rs.pins):
            pins[:, t, j] = pin
    return pins


def _prior(n, seed, scale=1.5, latent=8):
    return (np.random.default_rng(seed).normal(size=(n, latent)) *
            scale).astype(np.float32)


@pytest.mark.parametrize('case', ['free', 'pinned', 'short'])
def test_dec_propose_small_matches_jax(tiny, case):
    z = _prior(6, 7)
    T = 8 if case == 'short' else 40
    pins = np.zeros((3, T, len(z)), np.int64)
    if case == 'pinned':
        pins = _jax_pins(tiny, z, T)
        assert {1, 2, 3} <= set(pins[0].ravel().tolist())
    live = _check_trace(*_propose_both(tiny, z, pins, T))
    assert live == T          # a sample is still active at the last step


@pytest.mark.parametrize('T', [40, 150])
def test_dec_propose_full_width_matches_jax(hopv, T):
    z = hopv['z'][:8]
    live = _check_trace(*_propose_both(
        hopv, z, np.zeros((3, T, len(z)), np.int64), T))
    if T == 150:                 # the loop ended early, as JAX's did
        assert live < T


@pytest.mark.parametrize('ahead', [1, 3])
def test_proposer_blocks_match_the_eager_loop(hopv, ahead):
    """Steps queued ``ahead`` of the host's check (the card's schedule,
    eagerly): the same trace as one step at a time, zero rows after the
    loop's end, and ``ahead`` steps run past the one that ended it; no
    real atom id reaches the oracle's sink atom."""
    z = hopv['z'][:8]
    pins = np.zeros((3, 150, 8), np.int64)
    out = []
    for la in (0, ahead):
        res, run, carry = _round(hopv['model'], hopv['vocab'], z, pins, 150,
                                 la)
        out.append((res, run))
        assert int(carry['atom_cnt'].max()) < decode.ORACLE_ATOMS - 1
    ((p1, rc1, ri1, n1), run1), ((pk, rck, rik, nk), runk) = out
    for a, b in ((p1, pk), (rc1, rck), (ri1, rik)):
        np.testing.assert_array_equal(a, b)
    assert n1 == nk == run1 < 150
    assert not np.abs(p1[n1:]).any()
    assert runk == min(nk + ahead, 150)


def test_a_graph_needs_cuda_tensors(hopv):
    tabs, mask = decode._device_vocab(hopv['vocab'], common_atom_vocab,
                                      torch.device('cpu'))
    with torch.inference_mode(), pytest.raises(ValueError):
        decode.Proposer(hopv['model'], mask, tabs, BEAM, 8, 2, graph=True)


def test_a_replay_counts_the_launches_its_capture_recorded(hopv,
                                                          monkeypatch):
    """A kernel launch that a capture records counts in ``captured``, not
    in ``launches``; each replay of the graph adds the capture's count."""
    def wrapper():
        pass
    wrapper.launches = wrapper.captured = 0
    for capturing in (True, False):
        monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                            lambda c=capturing: c)
        count_launch(wrapper)
    assert (wrapper.launches, wrapper.captured) == (1, 1)

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1
    tabs, mask = decode._device_vocab(hopv['vocab'], common_atom_vocab,
                                      torch.device('cpu'))
    with torch.inference_mode():
        prop = decode.Proposer(hopv['model'], mask, tabs, BEAM, 8, 2,
                               graph=False)
    prop.graph, prop.replay_launches = Graph(), [(wrapper, 2)]
    prop.run_step()
    prop.run_step()
    assert (prop.graph.replays, wrapper.launches) == (2, 5)


# -- the host replay ---------------------------------------------------------

def _replays(mod, vocab, avocab, trace, rc, ri, final):
    out = []
    for j in range(trace.shape[1]):
        rs = mod._ReplayState(vocab, avocab, 400, 500, 12)
        status, smiles = mod._replay_pinned(trace[:, j], rc[j], ri[j], rs,
                                            vocab, BEAM, final=final)
        out.append((status, smiles, list(rs.pins), list(rs.stack)))
    return out


@pytest.mark.parametrize('final', [True, False])
def test_replay_pinned_matches_jax(tiny, hopv, final):
    cases = [(tiny, _prior(6, 7), 150), (tiny, _prior(6, 7), 8),
             (hopv, hopv['z'][:8], 40)]
    statuses = set()
    for setup, z, T in cases:
        (jp, jrc, jri), _ = _propose_both(
            setup, z, np.zeros((3, T, len(z)), np.int64), T)
        theirs = _replays(jax_decode, setup['jvocab'], jax_avocab, jp, jrc,
                          jri, final)
        ours = _replays(decode, setup['vocab'], common_atom_vocab, jp, jrc,
                        jri, final)
        assert ours == theirs
        statuses |= {s[0] for s in ours}
    assert statuses == ({'done', 'diverge'} if final else
                        {'done', 'diverge', 'continue'})


# -- decode_motif_turbo on the small model -----------------------------------

def _decode(tiny, z, turbo, **kw):
    fn = decode.decode_motif_turbo if turbo else decode.decode_motif
    if not turbo:
        kw['log_steps'] = False
    return fn(tiny['model'], tiny['vocab'], common_atom_vocab, z,
              greedy=True, **kw)[1]


def test_turbo_matches_exact_reconstruction(tiny):
    z = tiny['z_rec']
    exact = _decode(tiny, z, False, max_decode_step=60)
    assert _decode(tiny, z, True, max_decode_step=60) == exact
    assert decode.TURBO_STATS['rounds'] == 1, decode.TURBO_STATS
    assert decode.TURBO_STATS['fallbacks'] == 0, decode.TURBO_STATS
    print('reconstruct TURBO_STATS', decode.TURBO_STATS, exact)
    _, jsmiles = jax_decode.decode_motif_turbo(
        tiny['jmodel'], tiny['params'], tiny['jvocab'], jax_avocab, z,
        greedy=True, max_decode_step=60)
    assert jsmiles == exact


def test_turbo_matches_exact_prior(tiny):
    z = _prior(8, 7)
    assert _decode(tiny, z, True, max_decode_step=40) == \
        _decode(tiny, z, False, max_decode_step=40)


def test_turbo_chunked_matches_unchunked(tiny):
    z = _prior(9, 3)
    whole = _decode(tiny, z, True, max_decode_step=40)
    assert _decode(tiny, z, True, max_decode_step=40, chunk=4) == whole
    assert decode.TURBO_STATS['pending_per_round'][:3] == [4, 4, 1]


def test_turbo_ladder_escalates_and_matches_exact(tiny):
    """Prior latents (the small model's reconstructions end within 4
    steps).  Sample 1 grows a 246-atom molecule whose bonds outgrow one
    sample's share of ``IncGraph``'s message rows ((max_edges + 100) per
    sample, pooled over the batch): the JAX package's exact path, decoding
    the batch in one graph, borrows the other samples' rows, while its
    turbo path (and the port's) replays each sample in a graph of its own,
    as the exact path decodes that latent alone.  The test holds both paths
    to the JAX package's and names that sample."""
    z = _prior(8, 7)
    exact = _decode(tiny, z, False, max_decode_step=60)
    turbo = _decode(tiny, z, True, max_decode_step=60, ladder=(4, 16))
    assert decode.TURBO_STATS['rungs'][0] == 4
    assert len(decode.TURBO_STATS['rungs']) >= 2
    args = (tiny['jmodel'], tiny['params'], tiny['jvocab'], jax_avocab)
    _, jexact = jax_decode.decode_motif(*args, z, greedy=True,
                                        max_decode_step=60, log_steps=False)
    _, jturbo = jax_decode.decode_motif_turbo(*args, z, greedy=True,
                                              max_decode_step=60,
                                              ladder=(4, 16))
    _, jalone = jax_decode.decode_motif(*args, z[1:2], greedy=True,
                                        max_decode_step=60, log_steps=False)
    assert (turbo, exact) == (jturbo, jexact)
    assert [i for i in range(len(z)) if turbo[i] != exact[i]] == [1]
    assert turbo[1] == jalone[0]


def test_turbo_round_cap_falls_back_to_the_exact_path(tiny):
    """A ladder of one-step rungs with a cap of 2 rounds leaves samples
    pending: they take the exact path, and the answers stay the same."""
    z = tiny['z_rec']
    exact = _decode(tiny, z, False, max_decode_step=60)
    assert _decode(tiny, z, True, max_decode_step=60, ladder=(1, 2),
                   max_rounds=2) == exact
    assert decode.TURBO_STATS['rounds'] == 2
    assert decode.TURBO_STATS['fallbacks'] > 0
    # the exact path's steps for them, each a launch of B1 on the card
    assert decode.TURBO_STATS['eager_steps'] > 0


def test_turbo_decodes_from_many_threads(tiny):
    """The tables' and proposers' caches are shared by every caller in the
    process: 12 threads decoding at once, with a short switch interval,
    each get the serial answer."""
    import sys
    import threading
    z = _prior(4, 11)
    serial = _decode(tiny, z, True, max_decode_step=20)
    decode._PROPOSERS.clear()
    got, errors = [], []

    def work():
        try:
            got.append(_decode(tiny, z, True, max_decode_step=20))
        except Exception as e:          # reported below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and got == [serial] * 12


# -- full width: the JAX package's answers -------------------------------------

def test_turbo_full_width_matches_the_jax_answers(hopv):
    with open(GOLDEN) as f:
        golden = json.load(f)
    model, vocab = hopv['model'], hopv['vocab']
    _, rec = decode.decode_motif_turbo(model, vocab, common_atom_vocab,
                                       hopv['z'], max_decode_step=150)
    print('reconstruct TURBO_STATS', decode.TURBO_STATS)
    assert rec == golden['reconstruct']
    _, sam = decode.sample_prior(model, vocab, common_atom_vocab, 64,
                                 rng=np.random.default_rng(0),
                                 max_decode_step=150)
    print('sample TURBO_STATS', decode.TURBO_STATS)
    assert sam == golden['sample']
    assert decode.TURBO_STATS['fallbacks'] == 0


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize('greedy,log_steps,route', [
    (True, False, 'turbo'), (True, True, 'exact'), (False, False, 'exact')])
def test_decode_best_routes_as_jax(tiny, monkeypatch, greedy, log_steps,
                                   route):
    calls = []
    for name, tag in (('decode_motif_turbo', 'turbo'),
                      ('decode_motif', 'exact')):
        monkeypatch.setattr(decode, name,
                            lambda *a, tag=tag, **kw: calls.append(
                                (tag, kw)) or ([], []))
    decode.decode_best(tiny['model'], tiny['vocab'], common_atom_vocab,
                       tiny['z_rec'], greedy=greedy, log_steps=log_steps,
                       chunk=4)
    assert [c[0] for c in calls] == [route]
    assert ('chunk' in calls[0][1]) == (route == 'turbo')
