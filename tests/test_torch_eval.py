"""The port's evaluation suite against the JAX package's, on the CPU: leaf
atoms, BRICS fragments, Morgan bits and SA scores on every HOPV molecule,
the metrics over the JAX decode golden's strings, the result helpers and
the ``evaluate`` CLI, and the ChemNet of every layer kind."""

import json
import os

import numpy as np
import pytest
import torch

from ggpm_tpu import chem as jax_chem
from ggpm_tpu.cli import evaluate as jax_evaluate
from ggpm_tpu.eval import chemnet as jax_chemnet
from ggpm_tpu.eval import metrics as jax_metrics
from ggpm_tpu.eval import results as jax_results
from ggpm_tpu.graph import chemutils as jax_chemutils
from ggpm_tpu_torch import chem
from ggpm_tpu_torch.cli import evaluate
from ggpm_tpu_torch.data.dataset import read_csv_data
from ggpm_tpu_torch.eval import chemnet, metrics, results
from ggpm_tpu_torch.graph import chemutils

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DECODE_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                             'decode_hopv64.json')
METRIC_TOL = 1e-12
CHEMNET_RTOL = 1e-5
FCD_RTOL = 1e-4


@pytest.fixture(scope='module')
def hopv():
    return [r[0] for r in read_csv_data(DATA)]


@pytest.fixture(scope='module')
def decode_golden():
    with open(DECODE_GOLDEN) as f:
        return json.load(f)


def _equal_metrics(ours, theirs, tol=METRIC_TOL):
    assert ours.keys() == theirs.keys()
    for k, w in theirs.items():
        g = ours[k]
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), k
        elif isinstance(w, float):
            assert abs(g - w) <= tol * max(1.0, abs(w)), (k, g, w)
        else:
            assert g == w, k


# -- (e) chemistry of the suite ----------------------------------------------

def test_leaves_brics_morgan_match_jax_on_hopv(hopv):
    """``get_leaves``, BRICS cut bonds and fragments, and Morgan bits at
    radius 2 and 3 equal the JAX package's on all 350 HOPV molecules."""
    assert len(hopv) == 350
    for s in hopv:
        ours, theirs = chem.get_mol(s), jax_chem.get_mol(s)
        assert chemutils.get_leaves(ours) == jax_chemutils.get_leaves(theirs)
        assert chem.find_brics_bonds(ours) == jax_chem.find_brics_bonds(theirs)
        assert chem.brics_fragments(ours) == jax_chem.brics_fragments(theirs)
        for radius in (2, 3):
            assert chem.morgan_bits(ours, radius) == \
                jax_chem.morgan_bits(theirs, radius)
    assert chem.brics_decompose('not a smiles') is None
    assert chem.tanimoto_smiles(hopv[0], hopv[1]) == \
        jax_chem.tanimoto_smiles(hopv[0], hopv[1])


def test_sa_scores_match_jax_on_hopv(hopv, tmp_path):
    """The SA score of every HOPV molecule, with fragment contributions
    fitted on the HOPV set, equals the JAX package's; the fitted table
    saves and loads to the same scores."""
    ours_mols = [chem.get_mol(s) for s in hopv]
    theirs_mols = [jax_chem.get_mol(s) for s in hopv]
    ours_fs = chem.FragmentScores.fit(ours_mols)
    theirs_fs = jax_chem.FragmentScores.fit(theirs_mols)
    assert ours_fs.scores == theirs_fs.scores
    ours = [chem.calculate_sa(m, ours_fs) for m in ours_mols]
    assert ours == [jax_chem.calculate_sa(m, theirs_fs) for m in theirs_mols]
    ours_fs.save(str(tmp_path / 'fs.json'))
    loaded = chem.FragmentScores.load(str(tmp_path / 'fs.json'))
    assert [chem.calculate_sa(m, loaded) for m in ours_mols[:20]] == ours[:20]


# -- (f) metrics, results and the evaluate CLI --------------------------------

def test_recon_metrics_match_jax_on_decode_golden(decode_golden):
    """The suite over the JAX decode golden's reconstructions and prior
    samples (against the 64 inputs) equals the JAX package's to 1e-12."""
    ref = decode_golden['inputs']
    for gen, k in ((decode_golden['reconstruct'], None),
                   (decode_golden['sample'], 10)):
        ours = metrics.Metrics(device='cpu').get_recon_n_sample_metrics(
            gen, ref, k)
        theirs = jax_metrics.Metrics().get_recon_n_sample_metrics(gen, ref, k)
        _equal_metrics(ours, theirs)
        assert ours['FCD'] is None
    frag = ('motif',)
    for f in frag:
        assert metrics.Metrics().frag_similarity(gen, ref, f) == \
            jax_metrics.Metrics().frag_similarity(gen, ref, f)
    for s in ref[:10]:
        m, jm = chem.get_mol(s), jax_chem.get_mol(s)
        assert metrics.mol_weight(m) == jax_metrics.mol_weight(jm)
        assert metrics.sa_proxy(m) == jax_metrics.sa_proxy(jm)
    assert metrics.wasserstein1([], [1.0]) != metrics.wasserstein1([], [1.0])


def test_optimization_metrics_match_jax(decode_golden):
    rng = np.random.default_rng(0)
    n = len(decode_golden['inputs'])
    gen = (decode_golden['inputs'], decode_golden['reconstruct'])
    org, new, tgt = ([rng.normal(size=n), rng.normal(size=n)]
                     for _ in range(3))
    tgt[0][3] = np.nan
    ours = metrics.Metrics().get_optimization_metrics(gen, org, new, tgt)
    theirs = jax_metrics.Metrics().get_optimization_metrics(gen, org, new,
                                                            tgt)
    _equal_metrics(ours, theirs)


@pytest.fixture
def recon_csv(tmp_path, decode_golden):
    """A reconstruction CSV as the CLIs write it, with a missing
    reconstruction, pandas NA strings and a missing original."""
    rows = list(zip(decode_golden['inputs'], decode_golden['reconstruct']))
    lines = ['original,reconstructed']
    for i, (o, d) in enumerate(rows[:40]):
        if i == 3:
            d = None
        if i == 5:
            d = 'NA'
        if i == 7:
            o = ''
        lines.append(f'{o},{d or ""}')
    path = tmp_path / 'recon.csv'
    path.write_text('\n'.join(lines) + '\n')
    return str(path)


def test_evaluate_cli_matches_jax(recon_csv):
    ours = evaluate.main(['--reconstructions', recon_csv, '--device', 'cpu'])
    theirs = jax_evaluate.main(['--reconstructions', recon_csv])
    _equal_metrics(ours, theirs)
    ours = evaluate.main(['--reconstructions', recon_csv, '--k', '5',
                          '--device', 'cpu'])
    theirs = jax_evaluate.main(['--reconstructions', recon_csv, '--k', '5'])
    _equal_metrics(ours, theirs)


def test_results_helpers_match_jax(tmp_path, decode_golden):
    """``split_result_column`` returns pandas' two columns as lists and
    writes pandas' CSV byte for byte; the other helpers equal JAX's."""
    pairs = list(zip(decode_golden['inputs'], decode_golden['reconstruct']))
    lines = ['id,result']
    for i, (o, d) in enumerate(pairs[:12]):
        cell = o if i == 2 else f"{o} ['{d}']"
        lines.append(f'{i},"{cell}"' if i != 4 else f'{i},')
    src = tmp_path / 'res.csv'
    src.write_text('\n'.join(lines) + '\n')
    ours = results.split_result_column(str(src),
                                       out_path=str(tmp_path / 'a.csv'))
    theirs = jax_results.split_result_column(
        str(src), out_path=str(tmp_path / 'b.csv'))
    assert ours == {k: [None if isinstance(v, float) else v
                        for v in theirs[k]] for k in theirs.columns}
    assert (tmp_path / 'a.csv').read_bytes() == \
        (tmp_path / 'b.csv').read_bytes()
    gen = [d for _, d in pairs]
    assert results.validity_report(gen + [None, 'xx']) == \
        jax_results.validity_report(gen + [None, 'xx'])
    origs = [o for o, _ in pairs]
    assert results.reconstruction_accuracy(origs, gen) == \
        jax_results.reconstruction_accuracy(origs, gen)
    assert results.vocab_stats(VOCAB) == jax_results.vocab_stats(VOCAB)


# -- (g) ChemNet ------------------------------------------------------------

def _spec_checkpoint(path, kinds, seed=0, hidden=12):
    """A checkpoint with one layer of each of ``kinds`` after a conv."""
    rng = np.random.default_rng(seed)
    C = len(chemnet.CHARSET)

    def r(*shape):
        return rng.normal(0, 0.3, size=shape).astype(np.float32)
    spec = [{'kind': 'conv1d', 'w': 'c_w', 'b': 'c_b', 'stride': 3,
             'act': 'selu'},
            {'kind': 'maxpool', 'size': 2}]
    w = {'c_w': r(4, C, 8), 'c_b': r(8)}
    width = 8
    for i, kind in enumerate(kinds):
        if kind in ('gru', 'gru2'):
            spec.append({'kind': 'gru', 'wx': f'{i}wx', 'wh': f'{i}wh',
                         'b': f'{i}b'})
            w.update({f'{i}wx': r(width, 3 * hidden),
                      f'{i}wh': r(hidden, 3 * hidden),
                      f'{i}b': r(2, 3 * hidden) if kind == 'gru2'
                      else r(3 * hidden)})
            width = hidden
        elif kind == 'bigru':
            spec.append({'kind': 'bigru', **{
                f'{n}_{d}': f'{i}{n}_{d}' for n in ('wx', 'wh', 'b')
                for d in ('fwd', 'bwd')}})
            for d in ('fwd', 'bwd'):
                w.update({f'{i}wx_{d}': r(width, 3 * hidden),
                          f'{i}wh_{d}': r(hidden, 3 * hidden),
                          f'{i}b_{d}': r(3 * hidden)})
            width = 2 * hidden
        elif kind == 'lstm':
            spec.append({'kind': 'lstm', 'wx': f'{i}wx', 'wh': f'{i}wh',
                         'b': f'{i}b'})
            w.update({f'{i}wx': r(width, 4 * hidden),
                      f'{i}wh': r(hidden, 4 * hidden),
                      f'{i}b': r(4 * hidden)})
            width = hidden
        else:
            spec.append({'kind': 'dense', 'w': f'{i}w', 'b': f'{i}b',
                         'act': kind.split('-')[1]})
            w.update({f'{i}w': r(width, 10), f'{i}b': r(10)})
            width = 10
    np.savez(path, spec=np.array(json.dumps(spec)), **w)
    return str(path)


@pytest.mark.parametrize('kinds', [
    ['gru', 'dense-selu'], ['gru2', 'dense-relu'], ['bigru', 'dense-tanh'],
    ['lstm', 'dense-sigmoid'], ['lstm', 'dense-linear']],
    ids=['gru', 'gru-dual-bias', 'bigru', 'lstm', 'lstm-linear'])
def test_chemnet_layers_match_jax(tmp_path, hopv, kinds):
    path = _spec_checkpoint(tmp_path / 'c.npz', kinds)
    smiles = hopv[:20] + ['ClBr?[Si]']
    ours = chemnet.ChemNet.load(path, 'cpu').activations(smiles,
                                                         batch_size=8)
    theirs = jax_chemnet.ChemNet.load(path).activations(smiles, batch_size=8)
    np.testing.assert_allclose(ours, theirs, rtol=CHEMNET_RTOL, atol=1e-6)


def test_chemnet_random_checkpoint_and_fcd_match_jax(tmp_path, hopv):
    """``random_checkpoint`` writes the JAX package's file; activations and
    FCD of it match JAX's numpy network; ``Metrics(fcd_ckpt=...)``
    reports it; featurize and tokenize are JAX's."""
    ours_path = chemnet.random_checkpoint(str(tmp_path / 'a.npz'), seed=2)
    theirs_path = jax_chemnet.random_checkpoint(str(tmp_path / 'b.npz'),
                                                seed=2)
    with np.load(ours_path) as a, np.load(theirs_path) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    acts = chemnet.ChemNet.load(ours_path, 'cpu').activations(hopv[:40])
    np.testing.assert_allclose(
        acts, jax_chemnet.ChemNet.load(ours_path).activations(hopv[:40]),
        rtol=CHEMNET_RTOL, atol=1e-6)
    # a forward recurrence ends on the strings' zero padding, so the random
    # checkpoint's activations barely vary (its FCD is ~1e-13 in both
    # packages): FCD is held on a network whose backward GRU ends on the
    # strings' first characters
    fcd_path = _spec_checkpoint(tmp_path / 'c.npz', ['bigru', 'dense-selu'])
    gen, ref = hopv[:30] + [None], hopv[30:70]
    ours = chemnet.compute_fcd(gen, ref, fcd_path, device='cpu')
    theirs = jax_chemnet.compute_fcd(gen, ref, fcd_path)
    assert theirs > 1e-2
    assert abs(ours - theirs) <= FCD_RTOL * abs(theirs)
    out = metrics.Metrics(fcd_ckpt=fcd_path, device='cpu') \
        .get_recon_n_sample_metrics(gen, ref)
    assert out['FCD'] == ours
    assert np.isnan(chemnet.compute_fcd(['C'], ref, fcd_path, 'cpu'))
    for s in ('ClBr?', 'c1ccsc1[Si](C)(C)Cl', 'C#N.[Na+]'):
        assert chemnet.tokenize(s) == jax_chemnet.tokenize(s)
    np.testing.assert_array_equal(chemnet.featurize(hopv[:5], 120),
                                  jax_chemnet.featurize(hopv[:5], 120))
