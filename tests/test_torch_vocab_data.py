"""The port's data CLIs against the JAX package's, on the CPU: vocabulary
extraction and merging, preprocessed pickle shards, ``DataFolder`` over the
JAX package's shards, ``vae_train`` from shards, and QM9 parsing.

JAX ``build_vocab`` and ``load_vocab_file`` set ``MolGraph.FRAGMENTS`` for
the whole process; a fixture restores it around every test.
"""

import collections
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from ggpm_tpu.cli.common import read_csv_data as jax_read_csv
from ggpm_tpu.data import qm9 as jax_qm9
from ggpm_tpu.data import vocab_extract as jax_vx
from ggpm_tpu.data.dataset import MolPairDataset as JaxMolPairDataset
from ggpm_tpu.data.dataset import prune_to_vocab as jax_prune
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.cli import get_vocab, merge_vocab, preprocess, vae_train
from ggpm_tpu_torch.cli.common import read_csv_columns, write_csv
from ggpm_tpu_torch.data import qm9, vocab_extract
from ggpm_tpu_torch.data.dataset import (DataFolder, MolPairDataset,
                                         load_shard, prune_to_vocab,
                                         read_csv_data)
from ggpm_tpu_torch.graph.mol_graph import (DecodePlan, LevelTensors,
                                            MolGraphBatch)
from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
N_SHARD_ROWS = 60
BATCH = 20
SMALL = dict(embed_size=16, hidden_size=16, latent_size=8,
             linear_hidden_size=8, depthT=3)


@pytest.fixture(autouse=True)
def jax_fragments():
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


@pytest.fixture(scope='module')
def in_vocab_rows():
    """The first 60 in-vocab HOPV rows (the same for both packages; every
    HOPV molecule is in the vocab)."""
    vocab = load_vocab_file(VOCAB)
    rows = prune_to_vocab(read_csv_data(DATA)[:N_SHARD_ROWS], vocab,
                          verbose=False)
    saved = jax_mg.MolGraph.FRAGMENTS
    jvocab, _ = jax_vx.load_vocab_file(VOCAB)
    assert jax_prune(jax_read_csv(DATA)[:N_SHARD_ROWS], jvocab,
                     verbose=False) == rows
    assert len(rows) == N_SHARD_ROWS
    jax_mg.MolGraph.FRAGMENTS = saved
    return rows


@pytest.fixture(scope='module')
def jax_shards(tmp_path_factory, in_vocab_rows):
    """The JAX package's shards of the rows (seed 1, batch 20)."""
    out = str(tmp_path_factory.mktemp('jax_shards'))
    saved = jax_mg.MolGraph.FRAGMENTS
    jvocab, _ = jax_vx.load_vocab_file(VOCAB)
    n = jax_vx.preprocess_to_shards(in_vocab_rows, jvocab, jax_avocab, out,
                                    batch_size=BATCH, seed=1)
    jax_mg.MolGraph.FRAGMENTS = saved
    assert n == N_SHARD_ROWS // BATCH
    return out


def assert_same_batch(ours, theirs, path='batch'):
    """Every field of two batches (dataclasses of numpy arrays) equal, in
    dtype, shape and value."""
    if dataclasses.is_dataclass(theirs):
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(theirs)], path
        for f in dataclasses.fields(theirs):
            assert_same_batch(getattr(ours, f.name), getattr(theirs, f.name),
                              f'{path}.{f.name}')
    elif isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        np.testing.assert_array_equal(ours, theirs, err_msg=path)
    else:
        assert ours == theirs, path


# -- (a) vocabulary ----------------------------------------------------------

def test_get_vocab_cli_writes_the_checkpoint_vocab(tmp_path):
    """The port's ``get_vocab`` on ``data/hopv15.csv`` at 10 writes the
    trained checkpoint's vocab byte for byte, which is what JAX
    ``write_vocab`` writes of JAX ``build_vocab``'s rows."""
    out = tmp_path / 'vocab.txt'
    get_vocab.main(['--data', DATA, '--min_frequency', '10',
                    '--output', str(out)])
    with open(VOCAB) as f:
        assert out.read_text() == f.read()
    rows, frags = jax_vx.build_vocab([r[0] for r in jax_read_csv(DATA)], 10)
    jax_vx.write_vocab(rows, str(tmp_path / 'jax.txt'))
    assert (tmp_path / 'jax.txt').read_text() == out.read_text()
    assert len(frags) == 31


@pytest.mark.parametrize('min_frequency', [2, 5])
def test_build_vocab_matches_jax(min_frequency):
    """Rows and frequent fragments of the first 80 HOPV molecules equal JAX
    ``build_vocab``'s, with pass 2 reading the fragments it is given."""
    smiles = [r[0] for r in read_csv_data(DATA)[:80]]
    ours = vocab_extract.build_vocab(smiles, min_frequency)
    theirs = jax_vx.build_vocab(smiles, min_frequency)
    assert ours == theirs


def test_get_vocab_reads_csv_as_pandas_does(tmp_path, monkeypatch):
    """Missing cells and pandas' NA strings are dropped, the first of
    duplicates kept, each cell stripped, as the JAX CLI's pandas calls
    read them; a ``.txt`` is read line by line; any other extension raises
    ``TypeError``."""
    import pandas as pd
    csv_file = tmp_path / 'd.csv'
    csv_file.write_text('SMILES,HOMO\nCCO,1\n,2\nNA,3\nCCO,4\n c1ccccc1 ,5\n'
                        'CCN,6\nnan,7\nNone,8\n"C(Cl)Cl",9\nCCN ,10\n')
    assert read_csv_columns(str(csv_file))['SMILES'] == \
        ['CCO', None, None, 'CCO', ' c1ccccc1 ', 'CCN', None, None,
         'C(Cl)Cl', 'CCN ']
    df = pd.read_csv(csv_file).dropna(subset=['SMILES'])
    df = df.drop_duplicates(subset=['SMILES']).reset_index(drop=True)
    want = [s.strip() for s in df['SMILES']]
    seen = []
    monkeypatch.setattr(get_vocab, 'build_vocab',
                        lambda data, *a: (seen.append(data), ([], set()))[1])
    get_vocab.main(['--data', str(csv_file), '--output',
                    str(tmp_path / 'v.txt')])
    assert seen.pop() == want == ['CCO', 'c1ccccc1', 'CCN', 'C(Cl)Cl', 'CCN']
    txt = tmp_path / 'd.txt'
    txt.write_text('CCO\n\n CCN \n')
    get_vocab.main(['--data', str(txt), '--output', str(tmp_path / 'v.txt')])
    assert seen.pop() == ['CCO', 'CCN']
    with pytest.raises(TypeError):
        get_vocab.main(['--data', str(tmp_path / 'd.smi')])


def test_merge_vocab_matches_jax(tmp_path):
    """Overlapping rows merge, and a row flagged in one file and not in the
    other merges into one flagged row, as JAX ``merge_vocabs`` merges."""
    a, b = tmp_path / 'a.txt', tmp_path / 'b.txt'
    a.write_text('C1=CC=CC=C1 C1=CC=C[CH:1]=C1 False\nCC CC True\n'
                 'CO C[OH:1] False\n')
    b.write_text('CO C[OH:1] True\nCC CC False\nCN C[NH2:1]\n\nbad\n')
    ours = vocab_extract.merge_vocabs([str(a), str(b)])
    assert ours == jax_vx.merge_vocabs([str(a), str(b)])
    assert ours == ['C1=CC=CC=C1 C1=CC=C[CH:1]=C1 False', 'CC CC True',
                    'CO C[OH:1] True', 'CN C[NH2:1] False']
    merge_vocab.main(['--vocabs', str(a), str(b), '--output',
                      str(tmp_path / 'm.txt')])
    assert (tmp_path / 'm.txt').read_text() == '\n'.join(ours)


# -- (b) shards ----------------------------------------------------------------

@pytest.mark.parametrize('ncpu', [1, 2])
def test_preprocess_shards_equal_jax(tmp_path, in_vocab_rows, jax_shards,
                                     ncpu):
    """The port's ``preprocess_to_shards`` (in one process and on a pool)
    writes the JAX package's batches, every array of every batch equal."""
    out = str(tmp_path / 'ours')
    n = vocab_extract.preprocess_to_shards(
        in_vocab_rows, load_vocab_file(VOCAB), common_atom_vocab, out,
        batch_size=BATCH, seed=1, ncpu=ncpu)
    assert n == N_SHARD_ROWS // BATCH
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_shards)) == \
        ['tensors-0.pkl']
    ours = load_shard(os.path.join(out, 'tensors-0.pkl'))
    theirs = load_shard(os.path.join(jax_shards, 'tensors-0.pkl'))
    assert len(ours) == len(theirs) == n
    for a, b in zip(ours, theirs):
        assert type(a) is MolGraphBatch
        assert_same_batch(a, b)


def test_preprocess_cli_splits_shards(tmp_path, in_vocab_rows):
    """The CLI writes ``--batches-per-shard`` batches a file."""
    csv_file = str(tmp_path / 'd.csv')
    write_csv(csv_file, [dict(SMILES=s, HOMO=h, LUMO=l)
                         for s, h, l in in_vocab_rows])
    out = tmp_path / 'shards'
    preprocess.main(['--train', csv_file, '--vocab', VOCAB, '--out-dir',
                     str(out), '--batches-per-shard', '2', '--ncpu', '1'])
    assert sorted(os.listdir(out)) == ['tensors-0.pkl', 'tensors-1.pkl']
    assert [len(load_shard(str(out / f))) for f in sorted(os.listdir(out))] \
        == [2, 1]


# -- (c) DataFolder ------------------------------------------------------------

def test_datafolder_reads_jax_shards(jax_shards):
    """The JAX package's shards load into the port's classes, with the
    arrays the JAX package pickled."""
    with open(os.path.join(jax_shards, 'tensors-0.pkl'), 'rb') as f:
        theirs = pickle.load(f)
    ours = list(DataFolder(jax_shards, BATCH, shuffle=False))
    assert len(ours) == len(theirs) == N_SHARD_ROWS // BATCH
    for a, b in zip(ours, theirs):
        assert (type(a), type(a.tree), type(a.plan)) == \
            (MolGraphBatch, LevelTensors, DecodePlan)
        assert type(b).__module__ == 'ggpm_tpu.graph.mol_graph'
        assert_same_batch(a, b)
    shuffled = list(DataFolder(jax_shards, BATCH, seed=3))
    assert sorted(mb.smiles for mb in shuffled) == \
        sorted(mb.smiles for mb in ours)


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize('payload', [
    _Evil(), {'x': 1, 'f': dataclasses.field}, np.random.default_rng(0),
    collections.Counter('ab')],
    ids=['os-call', 'module-function', 'numpy-generator', 'counter'])
def test_datafolder_refuses_other_globals(tmp_path, payload):
    d = tmp_path / 'shards'
    d.mkdir()
    with open(d / 'tensors-0.pkl', 'wb') as f:
        pickle.dump([payload], f, pickle.HIGHEST_PROTOCOL)
    with pytest.raises(pickle.UnpicklingError, match='may not name'):
        list(DataFolder(str(d), BATCH))


def test_datafolder_partitions_files(tmp_path, jax_shards):
    """``num_shards=2``: the two readers take alternate files, disjoint and
    covering; ``__len__`` counts 1000 batches a file."""
    d = tmp_path / 'shards'
    d.mkdir()
    batches = load_shard(os.path.join(jax_shards, 'tensors-0.pkl'))
    for i in range(5):
        with open(d / f'tensors-{i}.pkl', 'wb') as f:
            pickle.dump([batches[i % len(batches)]], f)
    parts = [DataFolder(str(d), BATCH, num_shards=2, shard_index=k)
             for k in (0, 1)]
    assert [p.data_files for p in parts] == [
        ['tensors-0.pkl', 'tensors-2.pkl', 'tensors-4.pkl'],
        ['tensors-1.pkl', 'tensors-3.pkl']]
    assert [len(p) for p in parts] == [3000, 2000]
    assert [len(list(p)) for p in parts] == [3, 2]


def test_mol_pair_dataset_matches_jax(in_vocab_rows):
    pairs = [(in_vocab_rows[i][0], in_vocab_rows[i + 1][0]) for i in range(4)]
    ours = MolPairDataset(pairs, load_vocab_file(VOCAB), common_atom_vocab, 3)
    saved = jax_mg.MolGraph.FRAGMENTS
    jvocab, _ = jax_vx.load_vocab_file(VOCAB)
    theirs = JaxMolPairDataset(pairs, jvocab, jax_avocab, 3)
    assert len(ours) == len(theirs) == 2
    for k in range(2):
        for a, b in zip(ours[k], theirs[k]):
            assert_same_batch(a, b)
    jax_mg.MolGraph.FRAGMENTS = saved


# -- (d) vae_train from shards ----------------------------------------------

def test_vae_train_from_shards_matches_csv_path(tmp_path, jax_shards):
    """One epoch of ``vae_train`` from the JAX package's shards on the CPU
    (the tiny configuration of ``test_vae_train_cli_one_epoch``): each
    step's metrics equal the CSV path's over a CSV of the same batches in
    the order the shards gave them."""
    cfg = dict(vocab_=VOCAB, save_dir=str(tmp_path / 'out'),
               batch_size=BATCH, epoch=1, print_iter=1, seed=2,
               data=jax_shards, **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    args = ['--path-to-config', str(tmp_path / 'cfg.json'), '--model-type',
            'prop', '--device', 'cpu']
    with profile_train.recorded_epochs() as shards:
        vae_train.main(args)
    assert (tmp_path / 'out' / 'model.0').exists()
    csv_file = str(tmp_path / 'd.csv')
    write_csv(csv_file, [dict(SMILES=s, HOMO=float(h), LUMO=float(l))
                         for mb in shards['batches']
                         for s, h, l in zip(mb.smiles, mb.homos, mb.lumos)])
    with profile_train.recorded_epochs() as rows:
        vae_train.main(args + ['--data-csv', csv_file])
    assert len(shards['steps']) == len(rows['steps']) == \
        N_SHARD_ROWS // BATCH
    for a, b in zip(shards['steps'], rows['steps']):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # the shards path anneals every 1000 steps, as the JAX CLI does
    assert [t.opt_state.opt.steps_per_epoch for t in
            shards['trainers'] + rows['trainers']] == [1000, 3]


# -- (h) QM9 -----------------------------------------------------------------

def test_qm9_parse_and_featurize_match_jax(tmp_path):
    xyz = ('3\ngdb 1\tA\tB\tC\tmu\talpha\t-0.25\t0.08\tX\n'
           'O\t0.1\t-0.2\t1.5*^-3\t0\nH\t0\t0.7\t0\t0\nH\t0.7\t0\t0\t0\n'
           'freq\nCCO\tCCO\nInChI\n')
    single = '1\ngdb 2\tA\tB\tC\tmu\talpha\t-0.3\t0.1\tX\nC\t0\t0\t0\t0\n' \
        'freq\nC\tC\nInChI\n'
    (tmp_path / 'mol1.xyz').write_text(xyz)
    (tmp_path / 'mol2.xyz').write_text(single)
    (tmp_path / 'bad.xyz').write_text('x\n')
    files = sorted(os.listdir(tmp_path))
    assert qm9.read_and_extract(files, str(tmp_path)) == \
        jax_qm9.read_and_extract(files, str(tmp_path)) == \
        [['CCO', -0.25, 0.08]]
    out = tmp_path.parent / (tmp_path.name + '_csv')
    out.mkdir()
    ours = qm9.extract_qm9_csv(str(tmp_path), str(out / 'a.csv'))
    theirs = jax_qm9.extract_qm9_csv(str(tmp_path), str(out / 'b.csv'))
    assert ours == theirs
    assert (out / 'a.csv').read_text() == (out / 'b.csv').read_text()
    pos = qm9.read_xyz_positions(str(tmp_path / 'mol1.xyz'))
    np.testing.assert_array_equal(
        pos, jax_qm9.read_xyz_positions(str(tmp_path / 'mol1.xyz')))
    for smiles in ('CCO', 'c1ccccc1C#N', 'C=CC(=O)O', 'xx'):
        a = qm9.QM9Dataset([smiles], [pos])[0]
        b = jax_qm9.QM9Dataset([smiles], [pos])[0]
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
