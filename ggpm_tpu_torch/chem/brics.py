"""BRICS retrosynthetic fragmentation (Degen et al., ChemMedChem 2008).

Backs the Frag metric with the fragment definition MOSES uses
(reference the reference evaluation/metrics.py:230-247 →
``moses.get_all_metrics`` → RDKit ``BRICS.BRICSDecompose``), replacing the
motif-decomposition proxy previously used by ``eval/metrics.py``.

The published rule set is a fixed table: 16 link-atom environments (L1..L16,
with L2 merged into L5 and L7 split into the two ends of a double bond, as in
RDKit's implementation) plus a compatibility matrix of environment pairs
whose connecting bond is retrosynthetically cleavable.  RDKit expresses the
environments as SMARTS; this kernel has no SMARTS engine, so each environment
is an explicit predicate over (mol, atom, bond) implementing the same
chemistry.  Deviations (documented):

* fragments are emitted as canonical SMILES of the cut-out sub-molecules
  without ``[n*]`` dummy attachment atoms — attachment-class information is
  dropped, which merges a few fragment classes in the Frag histogram (both
  sides of the comparison use the same convention, so the cosine similarity
  remains well-defined);
* charged-nitrogen and protecting-group corner cases of the SMARTS
  recursions are approximated by the element/ring/degree predicates below.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from .mol import Mol

_HETERO_RING = ('N', 'O', 'S')
_CNOS = ('C', 'N', 'O', 'S')


def _has_double_o(mol: Mol, i: int) -> bool:
    return any(b.order == 2 and mol.atom(b.other(i)).symbol == 'O'
               for b in mol.bonds_of(i))


def _all_single(mol: Mol, i: int) -> bool:
    return all(b.order == 1 and not b.aromatic for b in mol.bonds_of(i))


def _sym(mol: Mol, i: int) -> str:
    return mol.atom(i).symbol


def _arom(mol: Mol, i: int) -> bool:
    return mol.atom(i).aromatic


# --- environment predicates -------------------------------------------------
# each takes (mol, i, j): is atom i in environment Lx, attached through the
# candidate bond i-j?

def _L1(mol, i, j):
    # [C;D3]([#0,#6,#7,#8])(=O): acyl carbon
    return (_sym(mol, i) == 'C' and not _arom(mol, i) and mol.degree(i) == 3
            and _has_double_o(mol, i)
            and _sym(mol, j) in ('C', 'N', 'O'))


def _L3(mol, i, j):
    # [O;D2]-;!@: ether/ester oxygen
    return (_sym(mol, i) == 'O' and not _arom(mol, i)
            and mol.degree(i) == 2)


def _L4(mol, i, j):
    # [C;!D1;!$(C=*)]-;!@[#6]: non-terminal carbon with no multiple bonds
    # and a single non-ring bond to SOME carbon.  The [#6] is a neighbour
    # requirement of the recursive SMARTS, NOT the cut partner — L4 pairs
    # with L3's oxygen across the cut (RDKit reactionDefs row L3).
    if (_sym(mol, i) != 'C' or _arom(mol, i) or mol.degree(i) <= 1
            or any(b.order > 1 for b in mol.bonds_of(i))):
        return False
    return any(b.order == 1 and not b.aromatic
               and not mol.bond_in_ring(i, b.other(i))
               and _sym(mol, b.other(i)) == 'C'
               for b in mol.bonds_of(i))


def _L5(mol, i, j):
    # amine nitrogen: no multiple bonds, only C/S/H neighbours, not lactam N
    if _sym(mol, i) != 'N' or _arom(mol, i) or mol.degree(i) <= 1:
        return False
    if any(b.order > 1 or b.aromatic for b in mol.bonds_of(i)):
        return False
    if any(_sym(mol, nb) not in ('C', 'S') for nb in mol.neighbors(i)):
        return False
    if mol.atom_in_ring(i):
        for nb in mol.neighbors(i):
            if (mol.bond_in_ring(i, nb) and _sym(mol, nb) == 'C'
                    and _has_double_o(mol, nb)):
                return False  # lactam
    return True


def _L6(mol, i, j):
    # [C;D3;!R](=O)-;!@[#0,#6,#7,#8]: acyclic acyl carbon
    return _L1(mol, i, j) and not mol.atom_in_ring(i)


def _L7(mol, i, j):
    # [C;D2,D3]-[#6]: one end of a cleavable C=C double bond; must carry a
    # SINGLE bond to some carbon besides the double bond itself (the -[#6]
    # neighbour requirement), so terminal =CH2 ends never match
    return (_sym(mol, i) == 'C' and not _arom(mol, i)
            and mol.degree(i) in (2, 3)
            and any(b.order == 1 and _sym(mol, b.other(i)) == 'C'
                    for b in mol.bonds_of(i)))


def _L8(mol, i, j):
    # [C;!R;!D1;!$(C!-*)]: acyclic all-single-bond carbon
    return (_sym(mol, i) == 'C' and not _arom(mol, i)
            and not mol.atom_in_ring(i) and mol.degree(i) > 1
            and _all_single(mol, i))


def _L9(mol, i, j):
    # [n;+0;$(n(:[c,n,o,s]):[c,n,o,s])]: aromatic ring nitrogen
    if _sym(mol, i) != 'N' or not _arom(mol, i) or mol.atom(i).charge != 0:
        return False
    ar_nb = [nb for nb in mol.neighbors(i)
             if _arom(mol, nb) and _sym(mol, nb) in _CNOS]
    return len(ar_nb) >= 2


def _L10(mol, i, j):
    # [N;R;$(N(@C(=O))@[C,N,O,S])]: lactam nitrogen
    if _sym(mol, i) != 'N' or _arom(mol, i) or not mol.atom_in_ring(i):
        return False
    has_acyl = any(mol.bond_in_ring(i, nb) and _sym(mol, nb) == 'C'
                   and _has_double_o(mol, nb) for nb in mol.neighbors(i))
    has_other = any(mol.bond_in_ring(i, nb) and _sym(mol, nb) in _CNOS
                    for nb in mol.neighbors(i))
    return has_acyl and has_other


def _L11(mol, i, j):
    # [S;D2](-;!@[#0,#6]): thioether sulfur
    return (_sym(mol, i) == 'S' and not _arom(mol, i) and mol.degree(i) == 2
            and _sym(mol, j) == 'C')


def _L12(mol, i, j):
    # [S;D4]([#6,#0])(=O)(=O): sulfonyl sulfur
    if _sym(mol, i) != 'S' or mol.degree(i) != 4:
        return False
    n_double_o = sum(1 for b in mol.bonds_of(i)
                     if b.order == 2 and _sym(mol, b.other(i)) == 'O')
    return n_double_o == 2


def _L13(mol, i, j):
    # [C;$(C(-;@[C,N,O,S])-;@[N,O,S])]: aliphatic ring C next to ring hetero
    if _sym(mol, i) != 'C' or _arom(mol, i) or not mol.atom_in_ring(i):
        return False
    ring_nb = [nb for nb in mol.neighbors(i) if mol.bond_in_ring(i, nb)]
    has_het = any(_sym(mol, nb) in _HETERO_RING for nb in ring_nb)
    has_any = any(_sym(mol, nb) in _CNOS for nb in ring_nb)
    return has_het and has_any and len(ring_nb) >= 2


def _L14(mol, i, j):
    # [c;$(c(:[c,n,o,s]):[n,o,s])]: aromatic C next to aromatic hetero
    if _sym(mol, i) != 'C' or not _arom(mol, i):
        return False
    ar_nb = [nb for nb in mol.neighbors(i) if _arom(mol, nb)]
    return (any(_sym(mol, nb) in _HETERO_RING for nb in ar_nb)
            and len(ar_nb) >= 2)


def _L15(mol, i, j):
    # [C;$(C(-;@C)-;@C)]: aliphatic ring C between two ring carbons
    if _sym(mol, i) != 'C' or _arom(mol, i) or not mol.atom_in_ring(i):
        return False
    ring_c = [nb for nb in mol.neighbors(i)
              if mol.bond_in_ring(i, nb) and _sym(mol, nb) == 'C'
              and not _arom(mol, nb)]
    return len(ring_c) >= 2


def _L16(mol, i, j):
    # [c;$(c(:c):c)]: benzene-like aromatic carbon
    if _sym(mol, i) != 'C' or not _arom(mol, i):
        return False
    ar_c = [nb for nb in mol.neighbors(i)
            if _arom(mol, nb) and _sym(mol, nb) == 'C']
    return len(ar_c) >= 2


_ENVS = {'1': _L1, '3': _L3, '4': _L4, '5': _L5, '6': _L6, '7': _L7,
         '8': _L8, '9': _L9, '10': _L10, '11': _L11, '12': _L12,
         '13': _L13, '14': _L14, '15': _L15, '16': _L16}

# compatibility matrix (RDKit reactionDefs; bond order '-' single except 7-7)
_PAIRS_SINGLE = [
    ('1', '3'), ('1', '5'), ('1', '10'),
    ('3', '4'), ('3', '13'), ('3', '14'), ('3', '15'), ('3', '16'),
    ('4', '5'), ('4', '11'),
    ('5', '12'), ('5', '13'), ('5', '14'), ('5', '15'), ('5', '16'),
    ('6', '13'), ('6', '14'), ('6', '15'), ('6', '16'),
    ('8', '9'), ('8', '10'), ('8', '13'), ('8', '14'), ('8', '15'),
    ('8', '16'),
    ('9', '13'), ('9', '14'), ('9', '15'), ('9', '16'),
    ('10', '13'), ('10', '14'), ('10', '15'), ('10', '16'),
    ('11', '13'), ('11', '14'), ('11', '15'), ('11', '16'),
    ('13', '14'), ('13', '15'), ('13', '16'),
    ('14', '14'), ('14', '15'), ('14', '16'),
    ('15', '16'),
    ('16', '16'),
]


def find_brics_bonds(mol: Mol) -> List[Tuple[int, int]]:
    """All cleavable bonds as (a, b) atom-index pairs."""
    out: List[Tuple[int, int]] = []
    seen: Set[Tuple[int, int]] = set()
    for b in mol.bonds:
        a1, a2 = b.a1, b.a2
        key = (min(a1, a2), max(a1, a2))
        if key in seen:
            continue
        if b.aromatic or mol.bond_in_ring(a1, a2):
            continue
        if b.order == 1:
            pairs = _PAIRS_SINGLE
        elif b.order == 2:
            pairs = [('7', '7')]
        else:
            continue
        for x, y in pairs:
            fx, fy = _ENVS[x], _ENVS[y]
            if (fx(mol, a1, a2) and fy(mol, a2, a1)) or \
               (fx(mol, a2, a1) and fy(mol, a1, a2)):
                out.append(key)
                seen.add(key)
                break
    return out


def brics_fragments(mol: Mol) -> List[str]:
    """Canonical SMILES of the BRICS fragments of ``mol`` (attachment dummy
    atoms dropped; see module docstring)."""
    from .api import get_smiles_aromatic, get_sub_mol, sanitize

    cuts = find_brics_bonds(mol)
    if not cuts:
        work = mol
    else:
        work = mol.clone()
        for a1, a2 in cuts:
            work.remove_bond(a1, a2)
    frags: List[str] = []
    for comp in work.connected_components():
        try:
            sub = sanitize(get_sub_mol(work, comp), kekule=False)
            if sub is None:
                continue
            s = get_smiles_aromatic(sub)
            if s:
                frags.append(s)
        except Exception:
            continue
    return frags


def brics_decompose(smiles: str) -> Optional[List[str]]:
    from .api import get_mol
    m = get_mol(smiles)
    if m is None:
        return None
    return brics_fragments(m)
