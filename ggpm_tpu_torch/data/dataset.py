"""Datasets and the sharded training-data iterator (counterpart of
``ggpm_tpu/data/dataset.py``, with ``read_csv_data`` of
``ggpm_tpu/cli/common.py``; reference ggpm/dataset.py:17-118).

Tensorized batches are ``MolGraphBatch`` objects (padded numpy), ready for
``to_model_batch``.  ``DataFolder`` reads the pickle shards that
``vocab_extract.preprocess_to_shards`` writes, the port's or the JAX
package's: an unpickler maps the JAX package's ``MolGraphBatch``,
``LevelTensors`` and ``DecodePlan`` to the port's classes (their fields
are the same, in the same order) and refuses every global but those and
numpy's array reconstructors, so JAX-written shards load where JAX is not
installed.
"""

from __future__ import annotations

import csv
import gc
import os
import pickle
import random
from typing import List, Optional, Sequence

import numpy as np

from ..chem import get_mol, mol_to_smiles
from ..graph import mol_graph
from ..graph.chemutils import get_leaves
from ..graph.mol_graph import MolGraph, tensorize


def read_csv_data(path: str) -> List[list]:
    """Read (SMILES, HOMO, LUMO) rows; drops rows with missing SMILES
    (reference preprocess.py:45-50)."""
    out = []
    with open(path) as f:
        for row in csv.DictReader(f):
            s = (row.get('SMILES') or '').strip()
            if not s:
                continue

            def num(key):
                v = (row.get(key) or '').strip()
                try:
                    return float(v)
                except ValueError:
                    return None
            out.append([s, num('HOMO'), num('LUMO')])
    return out


def prune_to_vocab(data: Sequence, vocab, verbose: bool = True) -> List:
    """Drop molecules whose motif or attachment labels fall outside the vocab
    (reference MoleculeDataset.__init__, dataset.py:19-34)."""
    safe_data = []
    for row in data:
        mol_s = row[0]
        try:
            hmol = MolGraph(mol_s, vocab.fragments)
        except Exception:
            continue
        ok = True
        for _, attr in hmol.mol_tree.nodes(data=True):
            smiles = attr['smiles']
            ok &= attr['label'] in vocab
            for _, s in attr['inter_label']:
                ok &= (smiles, s) in vocab
        if ok:
            safe_data.append(list(row))
    if verbose:
        print(f'After pruning {len(data)} -> {len(safe_data)}')
    return safe_data


class MoleculeDataset:
    """Prunes out-of-vocab molecules, then tensorizes per batch on access
    (JAX ``MoleculeDataset``; the last batch may be short)."""

    def __init__(self, data, vocab, avocab, batch_size: int):
        safe_data = prune_to_vocab(data, vocab)
        self.batches = [safe_data[i:i + batch_size]
                        for i in range(0, len(safe_data), batch_size)]
        self.vocab = vocab
        self.avocab = avocab

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, idx):
        return tensorize(self.batches[idx], self.vocab, self.avocab)


class MolEnumRootDataset:
    """Enumerate alternative SMILES rootings at leaves for robust
    reconstruction (reference dataset.py:46-75): item ``idx`` is the
    tensorized batch of the in-vocab rootings of molecule ``idx``, or None
    if it has none."""

    def __init__(self, data: Sequence[str], vocab, avocab):
        self.batches = list(data)
        self.vocab = vocab
        self.avocab = avocab

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, idx):
        mol = get_mol(self.batches[idx])
        if mol is None:
            return None
        leaves = get_leaves(mol)
        smiles_list = sorted({mol_to_smiles(mol, root=i) for i in leaves})
        safe_list = []
        for s in smiles_list:
            try:
                hmol = MolGraph(s, self.vocab.fragments)
            except Exception:
                continue
            if all(attr['label'] in self.vocab
                   for _, attr in hmol.mol_tree.nodes(data=True)):
                safe_list.append(s)
        if not safe_list:
            return None
        return tensorize([[s, None, None] for s in safe_list],
                         self.vocab, self.avocab)


class MolPairDataset:
    """Graph-to-graph (x → y) pairs (reference dataset.py:78-92)."""

    def __init__(self, data, vocab, avocab, batch_size: int):
        self.batches = [data[i:i + batch_size]
                        for i in range(0, len(data), batch_size)]
        self.vocab = vocab
        self.avocab = avocab

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, idx):
        x, y = zip(*self.batches[idx])
        xb = tensorize([[s, None, None] for s in x], self.vocab, self.avocab)
        yb = tensorize([[s, None, None] for s in y], self.vocab, self.avocab)
        return xb, yb


_SHARD_CLASSES = ('MolGraphBatch', 'LevelTensors', 'DecodePlan')


def _shard_globals() -> dict:
    """(module, name) → object of every global a shard may name: the batch
    classes under the port's and the JAX package's module paths, and numpy's
    array reconstructors under numpy 1's and numpy 2's."""
    allowed = {}
    for module in ('ggpm_tpu.graph.mol_graph', mol_graph.__name__):
        for name in _SHARD_CLASSES:
            allowed[(module, name)] = getattr(mol_graph, name)
    for prefix in ('numpy.core', 'numpy._core'):
        allowed[(f'{prefix}.multiarray', '_reconstruct')] = \
            np.ndarray.__reduce__(np.zeros(0))[0]
        allowed[(f'{prefix}.multiarray', 'scalar')] = \
            np.int64(0).__reduce__()[0]
        allowed[(f'{prefix}.numeric', '_frombuffer')] = \
            np.zeros(1).__reduce_ex__(5)[0]
    allowed[('numpy', 'ndarray')] = np.ndarray
    allowed[('numpy', 'dtype')] = np.dtype
    return allowed


_SHARD_GLOBALS = _shard_globals()


class ShardUnpickler(pickle.Unpickler):
    """Loads a training shard; refuses a global outside ``_shard_globals``."""

    def find_class(self, module, name):
        try:
            return _SHARD_GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f'a training shard may not name {module}.{name}') from None


def load_shard(path: str) -> list:
    """The batches of one pickle shard (the port's or the JAX package's)."""
    with open(path, 'rb') as f:
        return ShardUnpickler(f).load()


class DataFolder:
    """Iterator over preprocessed pickle shards, shuffling batch order per
    shard (reference dataset.py:95-118).  With ``num_shards``/``shard_index``
    set, each process reads a disjoint subset of the files."""

    def __init__(self, data_folder: str, batch_size: int, shuffle: bool = True,
                 num_shards: int = 1, shard_index: int = 0,
                 seed: Optional[int] = None):
        self.data_folder = data_folder
        files = sorted(os.listdir(data_folder))
        self.data_files = files[shard_index::num_shards]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.data_files) * 1000

    def __iter__(self):
        for fn in self.data_files:
            batches = load_shard(os.path.join(self.data_folder, fn))
            if self.shuffle:
                self.rng.shuffle(batches)
            yield from batches
            del batches
            gc.collect()
