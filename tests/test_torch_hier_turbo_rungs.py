"""The port's hier turbo decode against the JAX package's where a round
does not finish every sample, on the CPU at full width (the trained
``hier-prop`` checkpoint): samples whose stack outlives a short rung
re-enter at the next rung, and a round of 16 or fewer pending samples of a
wider batch narrows to 16 columns; a sample poisoned after re-entry falls
back to the exact path.  Strings, rounds, rungs, pending samples per round
and fallbacks are held to JAX's ``decode_hier_turbo`` on the same latents
and ladder.

``ggpm_tpu_torch/goldens/hier_turbo_prior120.json`` holds JAX's answer to
the 120 prior draws that chip_smoke.py's phase 12 decodes on the card: its
strings, rounds, rungs and which samples fell back and why.  The port's
fallback samples are held to it here.  Rewrite it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hier_turbo_rungs.py

(about a minute).
"""

import json
import os

import numpy as np
import pytest
import torch

from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models import decode
from test_torch_hier import (CKPT, MAX_DECODE_STEP, ROOT, VOCAB,
                             _jax_trained, jax_fragments,  # noqa: F401
                             jax_latents)

PRIOR_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                            'hier_turbo_prior120.json')
PRIOR = dict(seed=0, n=120)
LADDER = (24,)
STATS = ('rounds', 'batch', 'fallbacks', 'pending_per_round', 'rungs')


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def prior_latents(latent_size: int) -> np.ndarray:
    """chip_smoke.py's 120 prior draws."""
    return np.random.default_rng(PRIOR['seed']).standard_normal(
        (PRIOR['n'], latent_size)).astype(np.float32)


def jax_turbo_causes(jmodel, params, jvocab, z, **kwargs):
    """JAX ``decode_hier_turbo`` of latents ``z``, with why each sample
    that fell back did: 'poisoned' if its last propose round flagged it,
    else 'diverged' (the host replay refused its trace).  Returns the
    strings, ``TURBO_STATS`` and [[sample, cause], ...] by sample."""
    rounds, spied_on = [], []
    get_kernel = jax_decode._get_kernel

    def spied(cls, *args, **kw):
        kern = get_kernel(cls, *args, **kw)
        if any(k is kern for k, _ in spied_on):
            return kern
        propose = kern.propose
        spied_on.append((kern, propose))

        def record(rv, u_seq, tabs):
            out = propose(rv, u_seq, tabs)
            rounds.append((np.asarray(rv), np.asarray(out[3])))
            return out
        kern.propose = record
        return kern
    fell = []
    decode_hier = jax_decode.decode_hier

    def exact(model, params, vocab, avocab, root_vecs, **kw):
        fell.extend(np.asarray(root_vecs))
        return decode_hier(model, params, vocab, avocab, root_vecs, **kw)
    jax_decode._get_kernel, jax_decode.decode_hier = spied, exact
    try:
        _, smiles = jax_decode.decode_hier_turbo(
            jmodel, params, jvocab, jax_avocab, z,
            max_decode_step=MAX_DECODE_STEP, **kwargs)
    finally:
        jax_decode._get_kernel, jax_decode.decode_hier = get_kernel, \
            decode_hier
        for kern, propose in spied_on:
            kern.propose = propose
    stats = dict(jax_decode.TURBO_STATS)

    def index(row):
        return int(np.flatnonzero((z == row).all(axis=1))[0])
    poisoned = {}
    for rv, flags in rounds:            # the last round of each sample wins
        for row, flag in zip(rv, flags):
            poisoned[index(row)] = bool(flag)
    causes = sorted([index(row), 'poisoned' if poisoned[index(row)]
                     else 'diverged'] for row in fell)
    return smiles, stats, causes


@pytest.fixture(scope='module')
def trained(jax_fragments):
    jmodel, params, jvocab, _, z = jax_latents()
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    return dict(jmodel=jmodel, params=params, jvocab=jvocab, z=z,
                model=model, vocab=vocab,
                prior=prior_latents(z.shape[1]))


@pytest.mark.parametrize('which', ['golden16', 'prior17'])
def test_rung_reentry_matches_jax(trained, which):
    """With a 24-step first rung, samples still alive re-enter at 150:
    the 16 golden latents, and 16 prior draws with the one that JAX's
    decode of the 120 poisons (the second round narrows to 16 columns;
    that sample falls back after re-entry).  The strings, ``TURBO_STATS``
    and the fallbacks' causes are JAX's."""
    t = trained
    if which == 'golden16':
        z = t['z']
    else:
        with open(PRIOR_GOLDEN) as f:
            golden = json.load(f)
        z = t['prior'][list(range(16)) + golden['fallback']]
    jsmiles, jstats, jcauses = jax_turbo_causes(
        t['jmodel'], t['params'], t['jvocab'], z, ladder=LADDER)
    _, smiles = decode.decode_hier_turbo(
        t['model'], t['vocab'], common_atom_vocab, z,
        max_decode_step=MAX_DECODE_STEP, ladder=LADDER)
    stats = decode.TURBO_STATS
    assert smiles == jsmiles
    for k in STATS:
        assert stats[k] == jstats[k], k
    assert stats['fallback_causes'] == jcauses
    assert stats['rounds'] == 2 and stats['rungs'] == [24, 150]
    assert 0 < stats['pending_per_round'][1] < len(z)
    if which == 'prior17':
        # (rung, width) of the model's proposers: the second round's 16
        shapes = {(k[4], k[5]) for k in decode._PROPOSERS
                  if k[1] == id(t['model'])}
        assert (150, 16) in shapes and (150, 17) not in shapes
        assert stats['fallbacks'] == 1 and jcauses == [[16, 'poisoned']]


def test_prior_fallbacks_are_jax(trained):
    """The samples that JAX's decode of the 120 prior draws sent back (the
    golden), with three that it did not, decoded by the port at the CPU
    ladder: the same samples fall back for the same cause, and every
    string is JAX's."""
    t = trained
    with open(PRIOR_GOLDEN) as f:
        golden = json.load(f)
    assert golden['seed'] == PRIOR['seed'] and golden['n'] == PRIOR['n']
    picked = [0, 1, 2] + golden['fallback']
    _, smiles = decode.decode_hier_turbo(
        t['model'], t['vocab'], common_atom_vocab, t['prior'][picked],
        max_decode_step=MAX_DECODE_STEP)
    assert smiles == [golden['smiles'][i] for i in picked]
    assert [[picked[j], why] for j, why in
            decode.TURBO_STATS['fallback_causes']] == \
        golden['fallback_causes']
    assert decode.TURBO_STATS['rounds'] == golden['rounds']


def jax_prior_golden() -> dict:
    """JAX ``decode_hier_turbo`` of the 120 prior draws at its CPU ladder."""
    jmodel, params, jvocab = _jax_trained()
    z = prior_latents(jmodel.cfg.latent_size)
    smiles, stats, causes = jax_turbo_causes(jmodel, params, jvocab, z)
    return dict(PRIOR, max_decode_step=MAX_DECODE_STEP, smiles=smiles,
                **{k: stats[k] for k in STATS},
                fallback=[b for b, _ in causes], fallback_causes=causes)


if __name__ == '__main__':
    golden = jax_prior_golden()
    with open(PRIOR_GOLDEN, 'w') as f:
        json.dump(golden, f, indent=1)
        f.write('\n')
    print(f'wrote {PRIOR_GOLDEN}')
