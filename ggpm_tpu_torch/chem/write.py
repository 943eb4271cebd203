"""Canonical SMILES writer (copy of ``ggpm_tpu/chem/write.py``).

Equivalent in role to ``Chem.MolToSmiles`` with both ``kekuleSmiles=True``
(the reference's ``get_smiles``, chemutils.py:24-25) and the default aromatic
form (used for fragment vocabulary keys, chemutils.py:76-88), plus
``rootedAtAtom`` (reference dataset.py:59).  Atom maps are emitted, matching
RDKit's behaviour on mapped motifs (``ismiles`` labels like ``[CH:1]#[CH:2]``).
"""

from __future__ import annotations

from typing import List, Optional

from .canon import canonical_ranks
from .elements import ORGANIC_SUBSET, implicit_h_count
from .mol import Mol

_BOND_SYM = {1: '', 2: '=', 3: '#'}


def mol_to_smiles(mol: Mol, kekule: bool = False, root: Optional[int] = None,
                  canonical: bool = True) -> str:
    if mol.num_atoms == 0:
        return ''
    if canonical:
        ranks = canonical_ranks(mol, break_ties=True)
    else:
        ranks = list(range(mol.num_atoms))

    comps = mol.connected_components()
    # deterministic component order: by min rank inside component
    comps.sort(key=lambda comp: min(ranks[i] for i in comp))
    parts = []
    for comp in comps:
        cset = set(comp)
        if root is not None and root in cset:
            start = root
        else:
            start = min(comp, key=lambda i: ranks[i])
        parts.append(_write_component(mol, start, ranks, kekule))
    return '.'.join(parts)


def _write_component(mol: Mol, start: int, ranks: List[int], kekule: bool) -> str:
    visited = set()
    closure_bonds = {}   # bond idx -> digit
    digits_free = list(range(1, 100))
    open_digits = {}     # atom -> list of (digit, bond_idx)
    out: List[str] = []

    # Pass 1: find ring-closure (back) edges with the same traversal order as
    # the writing pass, so digit assignment is deterministic.
    tree_children = {}   # atom -> ordered list of (bond_idx, child)
    back_edges = {}      # atom -> list of bond_idx (opened here)
    stack = [(start, -1)]
    seen = {start}
    order_key = lambda item: (ranks[item[1]], item[0])

    # iterative DFS to define traversal
    def neighbors_sorted(v, parent_bond):
        items = []
        for b in mol._adj[v]:
            if b == parent_bond:
                continue
            items.append((b, mol.bonds[b].other(v)))
        items.sort(key=order_key)
        return items

    all_back = set()

    def explore(v, pb):
        tree_children[v] = []
        back_edges.setdefault(v, [])
        for b, w in neighbors_sorted(v, pb):
            if w in seen:
                if b not in all_back:
                    all_back.add(b)
                    back_edges[v].append(b)
            else:
                seen.add(w)
                tree_children[v].append((b, w))
                explore(w, b)

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        explore(start, -1)
    finally:
        sys.setrecursionlimit(old_limit)

    # assign digits: a back edge gets a digit when first end is written, freed
    # when the second end closes it.
    def write_atom(v, pb):
        out.append(_atom_token(mol, v, kekule))
        # ring closures opened or closed at this atom, in canonical order
        closing = [b for b in mol._adj[v]
                   if b != pb and b in all_back]
        closing.sort(key=lambda b: (ranks[mol.bonds[b].other(v)], b))
        for b in closing:
            bond = mol.bonds[b]
            if b in closure_bonds:
                d = closure_bonds.pop(b)
                digits_free.insert(0, d)
                digits_free.sort()
                out.append(_bond_token(bond, kekule, mol) + _digit_token(d))
            else:
                d = digits_free.pop(0)
                closure_bonds[b] = d
                out.append(_bond_token(bond, kekule, mol) + _digit_token(d))
        children = tree_children[v]
        for k, (b, w) in enumerate(children):
            bond = mol.bonds[b]
            last = (k == len(children) - 1)
            if not last:
                out.append('(')
            out.append(_bond_token(bond, kekule, mol))
            write_atom(w, b)
            if not last:
                out.append(')')

    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        write_atom(start, -1)
    finally:
        sys.setrecursionlimit(old_limit)
    return ''.join(out)


def _digit_token(d: int) -> str:
    return str(d) if d < 10 else f'%{d:02d}'


def _bond_token(bond, kekule: bool, mol: Optional[Mol] = None) -> str:
    if not kekule:
        if bond.aromatic:
            return ''
        if bond.order == 1 and mol is not None and \
                mol.atoms[bond.a1].aromatic and mol.atoms[bond.a2].aromatic:
            # explicit single between two aromatic atoms (biphenyl bridge);
            # otherwise a reader would infer an aromatic bond
            return '-'
    return _BOND_SYM.get(bond.order, '')


def _atom_token(mol: Mol, idx: int, kekule: bool) -> str:
    a = mol.atoms[idx]
    sym = a.symbol
    aromatic_out = a.aromatic and not kekule
    total_h = mol.total_h(idx)

    needs_bracket = (
        a.charge != 0
        or a.map_num > 0
        or a.isotope != 0
        or sym not in ORGANIC_SUBSET
    )
    if not needs_bracket and a.explicit_h is not None:
        # bracket only if the H count is not what a bare atom would imply
        implied = implicit_h_count(sym, a.charge, mol.bonded_valence(idx))
        if a.explicit_h != implied:
            needs_bracket = True
    if not needs_bracket and aromatic_out and sym == 'N' and total_h > 0:
        needs_bracket = True  # pyrrole [nH]
    if not needs_bracket and aromatic_out:
        # aromatic bare atoms: verify the reader would recover the H count
        implied = implicit_h_count(sym, a.charge, mol.bonded_valence(idx))
        if total_h != implied:
            needs_bracket = True

    body = sym.lower() if aromatic_out else sym
    if not needs_bracket:
        return body
    token = '['
    if a.isotope:
        token += str(a.isotope)
    token += body
    if total_h == 1:
        token += 'H'
    elif total_h > 1:
        token += f'H{total_h}'
    if a.charge == 1:
        token += '+'
    elif a.charge == -1:
        token += '-'
    elif a.charge > 1:
        token += f'+{a.charge}'
    elif a.charge < -1:
        token += f'-{-a.charge}'
    if a.map_num:
        token += f':{a.map_num}'
    token += ']'
    return token
