"""The port's hier turbo decode against the JAX package's, on the CPU: the
propose loop's pieces (``_sparse_local``, ``_graft_rows_vec``), a whole
propose round (``HierProposer``, run eagerly) against JAX
``hdec_propose``, the four K1 sites of its step, and
``decode_hier_turbo`` on the trained checkpoint against JAX's, its
fallbacks, and ``decode_best``'s routing.

Small width: hidden = embed = 32, latent 8, depths 3, diterG 3, over the
trained hier vocab, with random params laid out as a flax tree for the JAX
model and bridged into the port's (``tests/test_torch_hier_small.py``'s
setup).  Integer columns of a trace (choice, motif and attachment ids,
committed beam and attachment, the candidate's kind and slot, the
feasibility bit masks), the root motifs and ``poisoned`` are held exactly;
the topology logits and beam scores within 1e-5.  Full width: the trained
``hier-prop`` checkpoint and the 16 golden latents of
``tests/test_torch_hier.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu.models.hier_decoder import HierDecoder as JaxHierDecoder
from ggpm_tpu.models.vae import HierPropertyVAE as JaxHierPropertyVAE
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu_torch import kernel_bench
from ggpm_tpu_torch.bridge import load_flax_params, load_model
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file
from ggpm_tpu_torch.models import decode, hier_decoder
from ggpm_tpu_torch.models.api import encode
from ggpm_tpu_torch.models.vae import HierPropertyVAE, ModelConfig
from test_torch_hier import (CKPT, DATA, MAX_DECODE_STEP, VOCAB,
                             jax_fragments, jax_latents)  # noqa: F401
from test_torch_hier_small import _small_params

SMALL = dict(embed_size=32, hidden_size=32, latent_size=8,
             linear_hidden_size=8, depthT=3, depthG=3, diterT=1, diterG=3)
BEAM = 5
C = 9 + 3 * BEAM
FLOAT_COLS = [0] + list(range(2, 2 + BEAM))
INT_COLS = [c for c in range(C) if c not in FLOAT_COLS]
ATOL = 1e-5
T_SMALL = 40
TOPO_SHIFT = 0.6
BUDGETS = (decode.HIER_A_BUDGET, decode.HIER_EG_BUDGET,
           decode.HIER_NBG_BUDGET)


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def small(jax_fragments):
    """The small hier model on both sides, 6 latents of HOPV molecules by
    the port's encoder and 12 prior draws, the oracle tables on both
    sides, and the vocab's cluster-row budget KE."""
    jvocab, _ = jax_load_vocab(VOCAB)
    vocab = load_vocab_file(VOCAB)
    hv, iv = vocab.size()
    jmodel = JaxHierPropertyVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, rnn_type='LSTM', dropout=0.0,
        **SMALL))
    cfg = ModelConfig(hvocab_size=hv, ivocab_size=iv, **SMALL)
    params, _ = _small_params(HierPropertyVAE, cfg, 4)
    # a topology bias that makes the random model expand: its decodes
    # then graft motifs, backtrack by force, and outrun a small budget
    topo = params['params']['decoder']['topoNN']['Dense_1']
    topo['bias'] = topo['bias'] + np.float32(TOPO_SHIFT)
    model = HierPropertyVAE(cfg)
    load_flax_params(model, params)
    model.eval()
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:6]
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    with torch.inference_mode():
        z_enc = encode(model, batch)[0].numpy()
    z_prior = np.random.default_rng(5).standard_normal(
        (12, SMALL['latent_size'])).astype(np.float32)
    ke = decode.hier_budgets(vocab, common_atom_vocab)[3]
    return dict(jmodel=jmodel, params=params, model=model, vocab=vocab,
                jvocab=jvocab, z=np.concatenate([z_enc, z_prior]),
                jtabs=jax_decode._assm_tables(jvocab, jax_avocab),
                tabs=decode._assm_tables(vocab, common_atom_vocab), ke=ke)


def _jax_propose(s, z, T, budgets):
    """JAX ``hdec_propose`` of the small model (jitted), as
    ``HierDecodeKernel.propose`` calls it."""
    a, eg, nbg, ke = budgets

    def f(params, rv, u_seq, tabs):
        return s['jmodel'].apply(
            params, rv, jnp.asarray(s['jvocab'].mask), u_seq, tabs, BEAM,
            method=lambda m, *x: m._decoder().hdec_propose(
                *x, A=a, Eg=eg, NBG=nbg, KE=ke))
    out = jax.jit(f)(s['params'], jnp.asarray(z),
                     jnp.full((T, len(z)), 0.5, jnp.float32), s['jtabs'])
    return jax.tree.map(np.asarray, out)


def _round(model, vocab, z, T, budgets, device='cpu'):
    """One eager propose round of the port's hier turbo decode
    (``HierProposer`` driven by ``_Round`` through the ``_RoundQueue``, as
    ``_hier_turbo`` drives it): (packed, root_cls, root_icls, steps
    active, poisoned) as numpy, the steps run, and the carry."""
    tabs, mask = decode._device_vocab(vocab, common_atom_vocab,
                                      torch.device(device))
    with torch.inference_mode():
        prop = decode.HierProposer(model, mask, tabs, BEAM, T, len(z),
                                   graph=False, budgets=budgets)
        out, queued = decode.propose_round(
            prop, torch.as_tensor(z, device=device))
        return out, queued, prop.carry


def assert_trace_equal(ours, theirs, samples=None):
    """Packed traces [T, B, C]: integer columns equal, floats within ATOL
    (over ``samples`` only, if given)."""
    if samples is not None:
        ours, theirs = ours[:, samples], theirs[:, samples]
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours[..., INT_COLS], theirs[..., INT_COLS])
    np.testing.assert_allclose(ours[..., FLOAT_COLS], theirs[..., FLOAT_COLS],
                               rtol=0, atol=ATOL)


# -- the propose loop's pieces -------------------------------------------------

def test_sparse_local_is_sparse_direct_small(small):
    """``_sparse_local`` equals ``_sparse_direct`` bit for bit and JAX's
    ``_sparse_local`` within 1e-5, on rows with padding lanes whose
    predecessors lie inside and outside the updated set."""
    s = small
    dec = s['model']._decoder()
    rng = np.random.default_rng(2)
    n, H, R, NB = 60, SMALL['hidden_size'], 12, 8
    state = tuple(rng.normal(0, 0.5, (n, H)).astype(np.float32)
                  for _ in range(2))
    for x in state:
        x[0] = 0
    rows = rng.permutation(np.arange(1, n))[:R].astype(np.int32)
    rows[[2, 7]] = 0
    bg = rng.integers(1, n, (R, NB)).astype(np.int32)
    inside = rng.random((R, NB)) < 0.4
    bg[inside] = rows[rng.integers(0, R, inside.sum())]
    bg[rng.random((R, NB)) < 0.2] = 0
    x = rng.normal(0, 1, (R, dec.graph_rnn.W_i.in_features - H)).astype(
        np.float32)
    with torch.inference_mode():
        local, direct = (
            fn(dec.graph_rnn, tuple(torch.from_numpy(a.copy()) for a in state),
               torch.from_numpy(rows), torch.from_numpy(x),
               torch.from_numpy(bg), 3)
            for fn in (dec._sparse_local, dec._sparse_direct))
    theirs = s['jmodel'].apply(
        s['params'], method=lambda m: m._decoder()._sparse_local(
            m._decoder().graph_rnn, tuple(jnp.asarray(a) for a in state),
            jnp.asarray(rows), jnp.asarray(x), jnp.asarray(bg), 3))
    for o, d, t in zip(local, direct, theirs):
        assert torch.equal(o, d)
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=0,
                                   atol=ATOL)
        assert not o[0].any()


def _graft_calls(s, z, budgets):
    """The arguments and carry (as numpy) of every ``_graft_rows_vec``
    call in one propose round of the port, the root's first."""
    calls = []
    graft = hier_decoder.HierDecoder._graft_rows_vec
    keys = ('a_av', 'e_av', 'e_bt', 'e_nth', 'e_bg', 'in_g', 'in_cnt',
            'out_g', 'out_dst', 'out_cnt', 'edge_cnt', 'clist', 'ccnt')

    def spy(tabs, cy, *args):
        before = {k: cy[k].numpy().copy() for k in keys}
        graft(tabs, cy, *args)
        calls.append((before, [a.numpy().copy() for a in args],
                       {k: cy[k].numpy().copy() for k in keys}))
    hier_decoder.HierDecoder._graft_rows_vec = staticmethod(spy)
    try:
        _round(s['model'], s['vocab'], z, T_SMALL, budgets)
    finally:
        hier_decoder.HierDecoder._graft_rows_vec = staticmethod(graft)
    return calls


def test_graft_rows_vec_small(small):
    """Every graft of a propose round, the root's included, fed to JAX's
    ``_graft_rows_vec`` on the same carry gives the port's carry: over a
    round with ring motifs grafted and, with a 40-atom budget, grafts that
    the budget guard stopped (their rows untouched)."""
    s = small
    budgets = (40,) + BUDGETS[1:] + (s['ke'],)
    calls = _graft_calls(s, s['z'], budgets)
    keys = ('a_av', 'e_av', 'e_bt', 'e_nth', 'e_bg', 'in_g', 'in_cnt',
            'out_g', 'out_dst', 'out_cnt', 'edge_cnt', 'clist', 'ccnt')
    tabs = s['tabs']
    B = len(s['z'])
    n_nodes = T_SMALL + 2
    rings = stopped = 0
    for before, args, after in calls:
        b_of, new_ilab, ch_atom_f, do_c, nth_edge, skip_anchor, nn_flat = args
        nb, na = tabs['nbond'].numpy()[new_ilab], tabs['n_at'].numpy()[
            new_ilab]
        rings += int((do_c & (nb >= na) & (na >= 5)).sum())
        stopped += int((~do_c & (ch_atom_f.sum(1) == 0)).sum())
        # JAX's tables have no sink: drop it, and clist is [B, n, KE]
        carry = tuple(jnp.asarray(
            before[k][:-1] if k in ('e_av', 'e_bt', 'e_nth', 'e_bg', 'in_g',
                                    'in_cnt', 'out_g', 'out_dst', 'out_cnt',
                                    'clist') else before[k]).astype(jnp.int32)
            for k in keys)
        carry = carry[:11] + (carry[11].reshape(B, n_nodes, -1),) + carry[12:]
        theirs = JaxHierDecoder._graft_rows_vec(
            None, s['jtabs'], carry, *(jnp.asarray(a) for a in args),
            None, budgets[2], budgets[3])
        for k, t in zip(keys, theirs):
            ours = after[k][:-1] if k in ('e_av', 'e_bt', 'e_nth', 'e_bg',
                                          'in_g', 'in_cnt', 'out_g',
                                          'out_dst', 'out_cnt', 'clist') \
                else after[k]
            np.testing.assert_array_equal(ours.reshape(np.shape(t)),
                                          np.asarray(t), err_msg=k)
    assert len(calls) > 10 and rings > 0 and stopped > 0


# -- a whole round ----------------------------------------------------------

@pytest.mark.parametrize('a_budget', [decode.HIER_A_BUDGET, 40],
                         ids=['budgets', 'poisoning'])
def test_propose_round_matches_jax_small(small, a_budget):
    """A round of ``propose_step_`` gives JAX ``hdec_propose``'s packed
    trace, root motifs and ``poisoned``: at the turbo decode's budgets,
    and with a 40-atom budget, under which some samples are poisoned (a
    poisoned sample's later rows are the same but their contents no
    longer matter: its trace is held up to its poisoning only by the
    flag)."""
    s = small
    budgets = (a_budget,) + BUDGETS[1:] + (s['ke'],)
    (packed, rc, ri, n_run, poisoned), steps_run, cy = _round(
        s['model'], s['vocab'], s['z'], T_SMALL, budgets)
    jpacked, jrc, jri, jpoisoned = _jax_propose(s, s['z'], T_SMALL, budgets)
    np.testing.assert_array_equal(rc, jrc)
    np.testing.assert_array_equal(ri, jri)
    np.testing.assert_array_equal(poisoned, jpoisoned)
    assert_trace_equal(packed, jpacked, np.flatnonzero(~poisoned))
    # the JAX loop stops at the last active step, as the port's round does
    # (its alive flag is read after each step); the rows past it are zero
    active = np.flatnonzero(jpacked.any(axis=(1, 2)))
    assert n_run == active[-1] + 1 == steps_run
    assert not packed[n_run:].any()
    if a_budget == 40:
        assert 0 < poisoned.sum() < len(poisoned)
    else:
        assert packed[:, :, 1].sum() > 20


def test_propose_sites_small(small):
    """Each of the propose step's four ``nei_sum`` calls is made at its
    site (``kernel_bench.hier_sites``), once a step run; no other hier
    site is called, and on the CPU nothing launches."""
    s = small
    budgets = BUDGETS + (s['ke'],)
    with kernel_bench.hier_sites() as sites:
        _, steps_run, _ = _round(s['model'], s['vocab'], s['z'], T_SMALL,
                                 budgets)
    assert steps_run > 5
    assert {k: v['calls'] for k, v in sites.items()} == {
        **{site: steps_run for site in kernel_bench.HIER_PROPOSE_NAMES},
        **{site: 0 for site in kernel_bench.HIER_SITE_NAMES},
        None: 0, 'replay': 0}
    assert not any(v['launches'] for v in sites.values())


def test_hier_turbo_cases_small(small):
    """``kernel_bench.hier_turbo_cases`` takes each propose site's inputs
    from a round's step: the atom readout over the bond-row state and
    ``in_g`` [B·S, NBG], the cluster sum over the atom hiddens and the
    frontier's S slots, the attachment and tree frontiers over their
    states and ``agraph`` [B, 12]."""
    s = small
    B, H = len(s['z']), SMALL['hidden_size']
    a, eg, nbg, _ = BUDGETS + (s['ke'],)
    S = decode.ORACLE_SLOTS
    cases = {c['case']: c for c in kernel_bench.hier_turbo_cases(
        s['model'], s['vocab'], [torch.from_numpy(s['z'])], step=3,
        T=T_SMALL)}
    shapes = {'propose-atom': ([1 + B * eg, H], [B * S, nbg]),
              'propose-cluster': ([1 + B * a, H], [B, S]),
              'propose-inter': ([1 + B * (T_SMALL + 1), H], [B, 12]),
              'propose-tree': ([1 + B * (T_SMALL + 1), H], [B, 12])}
    assert list(cases) == [f'hier-turbo-{site}-B{B}'
                           for site in kernel_bench.HIER_PROPOSE_NAMES]
    for site, (h, g) in shapes.items():
        c = cases[f'hier-turbo-{site}-B{B}']
        assert c['shape'] == dict(h=h, graph=g), site
        assert torch.equal(c['call'](), c['plain']())


# -- full width: the trained checkpoint --------------------------------------

@pytest.fixture(scope='module')
def trained(jax_fragments):
    jmodel, params, jvocab, rows, z = jax_latents()
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    return dict(jmodel=jmodel, params=params, jvocab=jvocab, z=z,
                model=model, vocab=vocab)


def test_decode_hier_turbo_matches_jax(trained):
    """``decode_hier_turbo`` of the 16 golden latents gives JAX
    ``decode_hier_turbo``'s strings and ``TURBO_STATS`` (rounds, rungs,
    pending samples per round, fallbacks), and ``decode_best`` of a hier
    model takes it."""
    t = trained
    _, jsmiles = jax_decode.decode_hier_turbo(
        t['jmodel'], t['params'], t['jvocab'], jax_avocab, t['z'],
        max_decode_step=MAX_DECODE_STEP)
    jstats = dict(jax_decode.TURBO_STATS)
    decode.TURBO_STATS.clear()
    _, smiles = decode.decode_best(t['model'], t['vocab'], common_atom_vocab,
                                   t['z'], max_decode_step=MAX_DECODE_STEP)
    assert smiles == jsmiles
    for k in ('rounds', 'batch', 'fallbacks', 'pending_per_round', 'rungs'):
        assert decode.TURBO_STATS[k] == jstats[k], k
    assert len(decode.TURBO_STATS['steps_run']) == jstats['rounds']


def test_fallbacks_give_the_exact_strings(trained, monkeypatch):
    """Samples that are poisoned (a 30-atom budget) and samples whose
    trace is corrupted (a committed attachment's feasibility bit masks
    zeroed, so the replay diverges) take the exact path, and every
    string is ``decode_hier``'s."""
    t = trained
    z = t['z'][:6]
    _, exact = decode.decode_hier(t['model'], t['vocab'], common_atom_vocab,
                                  z, max_decode_step=MAX_DECODE_STEP)
    _, smiles = decode.decode_hier_turbo(t['model'], t['vocab'],
                                         common_atom_vocab, z,
                                         max_decode_step=MAX_DECODE_STEP,
                                         a_budget=30)
    assert smiles == exact
    assert 0 < decode.TURBO_STATS['fallbacks'] < len(z)
    assert decode.TURBO_STATS['exact_steps'] > 0

    replay = decode._replay_hier
    corrupted = []

    def corrupt(trace_b, *args):
        hit = [r for r in range(len(trace_b)) if trace_b[r, 1] > 0.5 and
               trace_b[r, 2 + 3 * BEAM] >= 0 and trace_b[r, -3:].any()]
        if hit and len(corrupted) < 2:
            trace_b = trace_b.copy()
            trace_b[hit[0], -3:] = 0
            corrupted.append(hit[0])
        return replay(trace_b, *args)
    monkeypatch.setattr(decode, '_replay_hier', corrupt)
    _, smiles = decode.decode_hier_turbo(t['model'], t['vocab'],
                                         common_atom_vocab, z,
                                         max_decode_step=MAX_DECODE_STEP)
    assert smiles == exact
    assert len(corrupted) == 2
    assert decode.TURBO_STATS['fallbacks'] == 2
