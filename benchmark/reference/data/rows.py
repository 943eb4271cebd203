"""The training rows: (SMILES, HOMO, LUMO) read from a CSV, and the
molecules whose motifs and attachments the vocab holds (a frozen copy of
the port's ``data/dataset.py:read_csv_data`` and ``prune_to_vocab``)."""

from __future__ import annotations

import csv
from typing import List, Sequence

from ..graph.mol_graph import MolGraph


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


def prune_to_vocab(data: Sequence, vocab) -> List:
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
    return safe_data
