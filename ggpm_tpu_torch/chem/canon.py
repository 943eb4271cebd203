"""Canonical atom ranking (Morgan refinement) (copy of ``ggpm_tpu/chem/canon.py``).

Provides the equivalent of ``Chem.CanonicalRankAtoms(mol, breakTies=False)``
(used for symmetry detection in assembly-candidate enumeration, reference
chemutils.py:187) and the tie-broken total order that drives canonical SMILES
output.
"""

from __future__ import annotations

from typing import List

from .elements import ATOMIC_NUM
from .mol import Mol


def _initial_invariants(mol: Mol, use_maps: bool = True) -> List[tuple]:
    inv = []
    for i, a in enumerate(mol.atoms):
        inv.append((
            mol.degree(i),
            ATOMIC_NUM.get(a.symbol, 99),
            a.charge,
            mol.total_h(i),
            1 if mol.atom_in_ring(i) else 0,
            1 if a.aromatic else 0,
            a.map_num if use_maps else 0,
            a.isotope,
        ))
    return inv


def _refine(mol: Mol, ranks: List[int]) -> List[int]:
    """Iteratively refine a rank partition with neighbourhood signatures."""
    n = mol.num_atoms
    nclasses = len(set(ranks))
    while True:
        sigs = []
        for i in range(n):
            neigh = sorted(
                (b.order if not b.aromatic else 9, ranks[b.other(i)])
                for b in mol.bonds_of(i)
            )
            sigs.append((ranks[i], tuple(neigh)))
        order = sorted(range(n), key=lambda i: sigs[i])
        new_ranks = [0] * n
        r = 0
        for k, i in enumerate(order):
            if k > 0 and sigs[i] != sigs[order[k - 1]]:
                r += 1
            new_ranks[i] = r
        new_nclasses = len(set(new_ranks))
        if new_nclasses == nclasses:
            return new_ranks
        ranks, nclasses = new_ranks, new_nclasses


def canonical_ranks(mol: Mol, break_ties: bool = False, use_maps: bool = True) -> List[int]:
    """Rank atoms canonically.  With ``break_ties`` the result is a
    permutation of 0..n-1; otherwise symmetric atoms share a rank."""
    n = mol.num_atoms
    if n == 0:
        return []
    inv = _initial_invariants(mol, use_maps)
    order = sorted(range(n), key=lambda i: inv[i])
    ranks = [0] * n
    r = 0
    for k, i in enumerate(order):
        if k > 0 and inv[i] != inv[order[k - 1]]:
            r += 1
        ranks[i] = r
    ranks = _refine(mol, ranks)
    if not break_ties:
        return ranks
    # canonical tie-breaking: repeatedly single out the lowest-index atom in
    # the first non-singleton class, then re-refine.
    while len(set(ranks)) < n:
        counts = {}
        for x in ranks:
            counts[x] = counts.get(x, 0) + 1
        target = min(x for x, c in counts.items() if c > 1)
        chosen = min(i for i in range(n) if ranks[i] == target)
        ranks = [x * 2 + (0 if i == chosen and x == target else 1)
                 if x == target else x * 2 for i, x in enumerate(ranks)]
        # normalize then refine
        ranks = _normalize(ranks)
        ranks = _refine(mol, ranks)
    return ranks


def _normalize(ranks: List[int]) -> List[int]:
    mapping = {x: k for k, x in enumerate(sorted(set(ranks)))}
    return [mapping[x] for x in ranks]
