"""The port's enum-root reconstruction and its quality-run twin against the
JAX package's, on the CPU, and the JAX goldens that chip_smoke.py holds the
card's quality run to.

The goldens are ``scripts/quality_run.py`` run eval-only on the trained
HOPV checkpoint (``--data data/hopv15.csv --min-freq 10 --load-ckpt
runs/QUALITY_hopv.json.ckpt --epochs 0 --ft-epochs 0 --enum-root 6``, at
``--n-test`` 8 and 60): its JSON without its wall-clock fields, its
reconstructions and predictions (``--dump-recon``), its prior samples and
enum-root triples, and its train metrics unrounded (the script's own calls,
recorded while it runs).  ``enum_roots_hopv8.json`` adds the rootings that
``MolEnumRootDataset`` gives the first 8 molecules.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_quality.py

rewrites the three goldens (about three minutes).
"""

import importlib.util
import json
import os
import runpy
import sys
import tempfile

import numpy as np
import pytest
import torch

from ggpm_tpu.data import dataset as jax_dataset
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu_torch import quality_run
from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.data.dataset import (MolEnumRootDataset, prune_to_vocab,
                                         read_csv_data)
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models.api import reconstruct_enum_roots
from ggpm_tpu_torch.models.decode import decode_best

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
GOLDENS = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens')
ENUM_GOLDEN = os.path.join(GOLDENS, 'enum_roots_hopv8.json')
N_ENUM = 8
# the script's flags of every golden but --n-test, --out and --dump-recon
FLAGS = ['--data', DATA, '--min-freq', '10', '--load-ckpt', CKPT,
         '--epochs', '0', '--ft-epochs', '0', '--enum-root', '6']
# the script's wall-clock fields, which no golden keeps
CLOCK_KEYS = ('wall_seconds', 'decode_seconds', 'decode_mols_per_sec',
              'enum_root_seconds')


def quality_golden_path(n_test: int) -> str:
    return os.path.join(GOLDENS, f'quality_hopv{n_test}.json')


@pytest.fixture(autouse=True)
def jax_fragments():
    """JAX ``build_vocab`` and ``load_vocab_file`` set the class state
    ``MolGraph.FRAGMENTS`` for the whole process."""
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


def _first_rows(n):
    model_vocab = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(DATA), model_vocab[1],
                          verbose=False)[:n]
    return model_vocab, rows


# -- enum-root reconstruction ----------------------------------------------

def test_reconstruct_enum_roots_matches_jax_golden():
    """The triples of the first 8 in-vocab HOPV molecules and the rootings
    ``MolEnumRootDataset`` gives them equal the JAX package's."""
    with open(ENUM_GOLDEN) as f:
        golden = json.load(f)
    (model, vocab), rows = _first_rows(N_ENUM)
    smiles = [r[0] for r in rows]
    assert smiles == [t[0] for t in golden['triples']]
    ds = MolEnumRootDataset(smiles, vocab, common_atom_vocab)
    assert len(ds) == N_ENUM
    assert [None if mb is None else mb.smiles for mb in ds] == \
        golden['rootings']
    out = reconstruct_enum_roots(model, smiles, vocab, max_roots=6,
                                 max_decode_step=150, ncpu=1)
    assert [list(t) for t in out] == golden['triples']


def test_enum_root_dataset_matches_jax_live():
    """``MolEnumRootDataset``'s tensors equal the JAX package's, array for
    array, for a molecule with several rootings."""
    (_, vocab), rows = _first_rows(2)
    jvocab, _ = jax_load_vocab(VOCAB)
    for row in rows:
        ours = MolEnumRootDataset([row[0]], vocab, common_atom_vocab)[0]
        theirs = jax_dataset.MolEnumRootDataset([row[0]], jvocab,
                                                jax_avocab)[0]
        assert ours.smiles == theirs.smiles
        for level in ('tree', 'graph'):
            a, b = getattr(ours, level), getattr(theirs, level)
            for k in ('fnode', 'fmess', 'agraph', 'bgraph', 'scope'):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# -- the quality-run twin ----------------------------------------------------

@pytest.fixture(scope='module')
def quality8(tmp_path_factory):
    """The twin's eval-only run at ``--n-test 8`` on the CPU: its result,
    its output path and the JAX golden of the same settings."""
    tmp = tmp_path_factory.mktemp('quality8')
    with open(quality_golden_path(N_ENUM)) as f:
        golden = json.load(f)
    out = str(tmp / 'q.json')
    res = quality_run.main(FLAGS + ['--n-test', str(N_ENUM), '--out', out,
                                    '--dump-recon', str(tmp / 'r.csv'),
                                    '--device', 'cpu'])
    return res, out, golden


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quality_run_eval_only_matches_jax_golden(quality8):
    """The twin's eval-only run at ``--n-test 8`` on the CPU meets the JAX
    golden of the same settings by ``quality_run.compare``, with every
    string equal, and writes the same JSON keys, dump and vocab."""
    res, out, golden = quality8
    check = quality_run.compare(res, golden)
    assert check['bad'] == []
    assert check['differing'] == {'recon': [], 'sampled': [],
                                  'enum_root': []}
    with open(out) as f:
        written = json.load(f)
    assert set(written) - {'device_name'} == \
        set(golden['qual']) | set(CLOCK_KEYS)
    assert written['platform'] == 'cpu'
    with open(os.path.join(os.path.dirname(out), 'r.csv')) as f:
        lines = f.read().splitlines()
    assert lines[0] == 'original,reconstructed,org_homo,org_lumo,homo,lumo'
    assert [ln.split(',')[:2] for ln in lines[1:]] == \
        [[o, d or ''] for o, d in golden['recon']]
    with open(out + '.vocab.txt') as f, open(VOCAB) as g:
        assert f.read() == g.read()


def test_near_tie_rule_reads_the_rows_the_run_decoded(quality8):
    """chip_smoke.py's near-tie rule for the quality twin decodes the rows
    the run decoded: on the CPU the CPU port's encode of the run's padded
    batches gives the run's latents bit for bit (a reconstruction's row,
    every rooting of an enum-root molecule, a prior draw), and a logged
    decode of a reconstruction's row gives the run's string.  A string
    said to differ where the two sides' logs never part is no near-tie and
    raises, as do more than 2 differing strings."""
    res, _, golden = quality8
    smoke = _chip_smoke()
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    dec = res['decoded']
    for kind, i in (('recon', 5), ('enum_root', 3), ('sampled', 2)):
        card, cpu, steps = smoke.decoded_rows(model, vocab, res, kind, i)
        assert torch.equal(card, cpu), kind
        if kind == 'enum_root':
            assert len(card) == dec['enum_root']['src'].count(i) > 0
    card, _, steps = smoke.decoded_rows(model, vocab, res, 'recon', 5)
    assert steps == 150
    assert torch.equal(card[0], dec['recon']['z'][5])
    _, smiles = decode_best(model, vocab, common_atom_vocab, card,
                            max_decode_step=steps, log_steps=True)
    assert smiles == [res['recon'][5][1]]
    with pytest.raises(AssertionError, match='beyond an fp32 near-tie'):
        smoke.quality_near_ties(model, model, vocab, res, golden,
                                {'recon': [5], 'sampled': [],
                                 'enum_root': []})
    with pytest.raises(AssertionError, match='3 strings differ'):
        smoke.quality_near_ties(model, model, vocab, res, golden,
                                {'recon': [0, 1], 'sampled': [0],
                                 'enum_root': []})


# -- the goldens -----------------------------------------------------------

def jax_quality(n_test: int) -> dict:
    """``scripts/quality_run.py`` eval-only at ``n_test``, run in this
    process with its sampling, enum-root and evaluation calls recorded."""
    from ggpm_tpu.models import api as jax_api
    from ggpm_tpu.models import decode as jax_decode
    from ggpm_tpu.train import loop as jax_loop
    seen = {}
    sample, enum, evaluate = (jax_decode.sample_prior,
                              jax_api.reconstruct_enum_roots,
                              jax_loop.Trainer.evaluate)

    def record(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] = fn(*args, **kwargs)
            return seen[name]
        return wrapped
    jax_decode.sample_prior = record('sampled', sample)
    jax_api.reconstruct_enum_roots = record('enum_root', enum)
    jax_loop.Trainer.evaluate = record('train_metrics', evaluate)
    argv = sys.argv
    with tempfile.TemporaryDirectory() as tmp:
        sys.argv = ['quality_run.py', *FLAGS, '--n-test', str(n_test),
                    '--out', os.path.join(tmp, 'q.json'),
                    '--dump-recon', os.path.join(tmp, 'r.csv')]
        try:
            runpy.run_path(os.path.join(ROOT, 'scripts', 'quality_run.py'),
                           run_name='__main__')
        finally:
            sys.argv = argv
            jax_decode.sample_prior = sample
            jax_api.reconstruct_enum_roots = enum
            jax_loop.Trainer.evaluate = evaluate
        with open(os.path.join(tmp, 'q.json')) as f:
            qual = json.load(f)
        with open(os.path.join(tmp, 'r.csv')) as f:
            import csv
            dump = list(csv.DictReader(f))
    return dict(
        command=('scripts/quality_run.py ' + ' '.join(
            os.path.relpath(a, ROOT) if a.startswith(ROOT) else a
            for a in FLAGS) + f' --n-test {n_test}'),
        qual={k: v for k, v in qual.items() if k not in CLOCK_KEYS},
        recon=[[r['original'], r['reconstructed'] or None] for r in dump],
        homo=[float(r['homo']) for r in dump],
        lumo=[float(r['lumo']) for r in dump],
        sampled=list(seen['sampled'][1]),
        enum_root=[list(t) for t in seen['enum_root']],
        train_metrics={k: float(v) for k, v in seen['train_metrics'].items()})


def write_goldens():
    for n_test in (N_ENUM, 60):
        golden = jax_quality(n_test)
        with open(quality_golden_path(n_test), 'w') as f:
            json.dump(golden, f, indent=1)
        if n_test == N_ENUM:
            jvocab, _ = jax_load_vocab(VOCAB)
            smiles = [t[0] for t in golden['enum_root']]
            ds = jax_dataset.MolEnumRootDataset(smiles, jvocab, jax_avocab)
            with open(ENUM_GOLDEN, 'w') as f:
                json.dump(dict(triples=golden['enum_root'], rootings=[
                    None if mb is None else mb.smiles for mb in ds]),
                    f, indent=1)
        print(f'wrote {quality_golden_path(n_test)}', flush=True)


if __name__ == '__main__':
    write_goldens()
