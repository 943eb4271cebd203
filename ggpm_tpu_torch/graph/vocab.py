"""Motif and atom vocabularies (copy of ``ggpm_tpu/graph/vocab.py``;
reference ggpm/vocab.py).

``PairVocab`` maps (motif SMILES, attachment-annotated iSMILES) pairs to a
coarse motif index and a fine attachment index, and carries the additive
log-mask restricting attachment choices per motif.  The mask is built as a
numpy array (device placement is the caller's concern).

Unlike the JAX package, which keeps the vocab file's frequent fragments in
the class attribute ``MolGraph.FRAGMENTS``, the port's ``PairVocab`` carries
them (``fragments``) and every decomposition reads them from the vocab it is
given.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, List, Sequence, Tuple

import numpy as np

from ..chem import canon_smiles, get_mol

MASK_NEG = -1000.0


class Vocab:
    def __init__(self, item_list: Sequence):
        self.vocab = list(item_list)
        self.vmap = {x: i for i, x in enumerate(self.vocab)}

    def __getitem__(self, item):
        return self.vmap[item]

    def __contains__(self, item):
        return item in self.vmap

    def get_smiles(self, idx: int):
        return self.vocab[idx]

    def size(self) -> int:
        return len(self.vocab)


class PairVocab:
    """(smiles, ismiles) pair vocabulary with coarse/fine indices and the
    per-motif attachment mask (reference vocab.py:23-61).  ``fragments``
    are the canonical SMILES of the frequent fragments that motif pooling
    merges (``MolGraph.pool_clusters``)."""

    def __init__(self, smiles_pairs: Sequence[Tuple[str, str]],
                 fragments: Iterable[str] = ()):
        self.fragments: FrozenSet[str] = frozenset(fragments)
        cls = [x[0] for x in smiles_pairs]
        self.hvocab = sorted(set(cls))
        self.hmap = {x: i for i, x in enumerate(self.hvocab)}

        self.vocab = [tuple(x) for x in smiles_pairs]
        self.inter_size = [count_inters(x[1]) for x in self.vocab]
        self.vmap = {x: i for i, x in enumerate(self.vocab)}

        mask = np.full((len(self.hvocab), len(self.vocab)), MASK_NEG, dtype=np.float32)
        for h, s in smiles_pairs:
            mask[self.hmap[h], self.vmap[(h, s)]] = 0.0
        self.mask = mask

    def __getitem__(self, x) -> Tuple[int, int]:
        assert isinstance(x, tuple)
        return self.hmap[x[0]], self.vmap[x]

    def __contains__(self, x) -> bool:
        return x in self.vmap

    def get_smiles(self, idx: int) -> str:
        return self.hvocab[idx]

    def get_ismiles(self, idx: int) -> str:
        return self.vocab[idx][1]

    def size(self) -> Tuple[int, int]:
        return len(self.hvocab), len(self.vocab)

    def get_mask(self, cls_idx):
        return self.mask[np.asarray(cls_idx)]

    def get_inter_size(self, icls_idx: int) -> int:
        return self.inter_size[icls_idx]


# 38 (symbol, formal charge) atom types (reference vocab.py:64-69).
COMMON_ATOMS: List[Tuple[str, int]] = [
    ('B', 0), ('B', -1), ('Br', 0), ('Br', -1), ('Br', 2), ('C', 0), ('C', 1),
    ('C', -1), ('Cl', 0), ('Cl', 1), ('Cl', -1), ('Cl', 2), ('Cl', 3),
    ('F', 0), ('F', 1), ('F', -1), ('I', -1), ('I', 0), ('I', 1), ('I', 2),
    ('I', 3), ('N', 0), ('N', 1), ('N', -1), ('O', 0), ('O', 1), ('O', -1),
    ('P', 0), ('P', 1), ('P', -1), ('S', 0), ('S', 1), ('S', -1), ('Se', 0),
    ('Se', 1), ('Se', -1), ('Si', 0), ('Si', -1),
]
common_atom_vocab = Vocab(COMMON_ATOMS)


def count_inters(s: str) -> int:
    """Number of mapped (attachment) atoms in an iSMILES (reference
    vocab.py:72-76)."""
    mol = get_mol(s)
    if mol is None:
        return 1
    inters = [a for a in mol.atoms if a.map_num > 0]
    return max(1, len(inters))


def load_vocab_file(path: str) -> PairVocab:
    """Load a vocab file written by ``ggpm_tpu.data.vocab_extract``.

    Accepts the 3-column ``smiles ismiles bool`` format, whose ``True`` rows
    are the frequent fragments (stored canonicalised, as
    ``MolGraph.load_fragments`` does), and the reference's 2-column
    ``smiles ismiles`` files, which carry none."""
    with open(path) as f:
        lines = [x.strip('\r\n ').split() for x in f if x.strip()]
    return PairVocab([(x[0], x[1]) for x in lines],
                     fragments=canon_fragments(
                         x[0] for x in lines
                         if len(x) >= 3 and x[-1] == 'True'))


def canon_fragments(fragments: Iterable[str]) -> FrozenSet[str]:
    """The canonical forms of ``fragments``, as motif pooling compares them
    (JAX ``MolGraph.load_fragments``)."""
    canon = (canon_smiles(x) for x in fragments)
    return frozenset(c for c in canon if c is not None)
