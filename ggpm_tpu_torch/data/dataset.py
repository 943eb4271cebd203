"""Reading molecules, pruning them to a vocabulary and tensorizing them per
batch (the part of ``ggpm_tpu/data/dataset.py`` and
``ggpm_tpu/cli/common.py`` that serving and the CLIs need)."""

from __future__ import annotations

import csv
from typing import List, Sequence

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
