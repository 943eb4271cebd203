"""SMILES parser (copy of ``ggpm_tpu/chem/parse.py``).

Covers the SMILES dialect used by the GGPM datasets (QM9, HOPV15, polymer OPV
sets and the motif vocabularies): organic subset + bracket atoms with charge /
explicit-H / atom maps, aromatic lowercase forms, ring closures including
``%nn``, branches, wildcard ``*``, and directional/chirality markers (parsed
and discarded — GGPM never relies on stereochemistry; the reference decodes
with ``isomericSmiles=False`` in the one place it matters, dataset.py:59).

Plays the role of ``Chem.MolFromSmiles`` (reference chemutils.py:19).
"""

from __future__ import annotations

import re
from typing import Optional

from .mol import AROMATIC, DOUBLE, SINGLE, TRIPLE, Atom, Mol

_BRACKET_RE = re.compile(
    r'^(?P<isotope>\d+)?'
    r'(?P<symbol>\*|[A-Z][a-z]?|[a-z][a-z]?)'
    r'(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d+|OH\d+)?)?'
    r'(?P<hcount>H\d*)?'
    r'(?P<charge>\+{1,3}|-{1,3}|\+\d|-\d)?'
    r'(?::(?P<map>\d+))?$'
)

_TWO_LETTER = {'Cl', 'Br', 'Si', 'Se'}
_AROMATIC_ORGANIC = {'b', 'c', 'n', 'o', 'p', 's', 'se', 'si'}


class SmilesError(ValueError):
    pass


def _parse_bracket(body: str) -> Atom:
    m = _BRACKET_RE.match(body)
    if m is None:
        raise SmilesError(f'bad bracket atom [{body}]')
    sym = m.group('symbol')
    aromatic = False
    if sym.islower():
        if sym not in _AROMATIC_ORGANIC:
            raise SmilesError(f'bad aromatic symbol {sym}')
        aromatic = True
        sym = sym.capitalize() if len(sym) > 1 else sym.upper()
    h = m.group('hcount')
    if h is None:
        hcount = 0
    elif h == 'H':
        hcount = 1
    else:
        hcount = int(h[1:])
    c = m.group('charge')
    if c is None:
        charge = 0
    elif c[-1].isdigit():
        charge = int(c[1:]) * (1 if c[0] == '+' else -1)
    else:
        charge = len(c) * (1 if c[0] == '+' else -1)
    map_num = int(m.group('map')) if m.group('map') else 0
    isotope = int(m.group('isotope')) if m.group('isotope') else 0
    return Atom(sym, charge, hcount, aromatic, map_num, isotope)


def mol_from_smiles(smiles: str, sanitize: bool = True) -> Optional[Mol]:
    """Parse SMILES into a Mol.  Returns None on failure when ``sanitize``
    (mirrors MolFromSmiles behaviour); raises SmilesError when sanitize=False
    and the string is syntactically invalid."""
    try:
        mol = _parse(smiles.strip())
    except SmilesError:
        return None
    if sanitize:
        from .api import sanitize_in_place
        if not sanitize_in_place(mol):
            return None
    return mol


def _parse(s: str) -> Mol:
    mol = Mol()
    prev_stack = []          # branch stack of atom indices
    prev: Optional[int] = None
    pending_order = None     # explicit bond symbol awaiting next atom
    ring_map = {}            # digit -> (atom_idx, order)
    i, n = 0, len(s)

    def close_or_open_ring(num, order):
        nonlocal mol
        if num in ring_map:
            a_prev, o_prev = ring_map.pop(num)
            o = order if order is not None else o_prev
            if prev is None:
                raise SmilesError('ring closure with no atom')
            if o is None:
                a1, a2 = mol.atoms[a_prev], mol.atoms[prev]
                o = AROMATIC if (a1.aromatic and a2.aromatic) else SINGLE
            if a_prev == prev or mol.bond_between(a_prev, prev) is not None:
                raise SmilesError('bad ring closure')
            mol.add_bond(a_prev, prev, o if o != AROMATIC else SINGLE,
                         aromatic=(o == AROMATIC))
        else:
            ring_map[num] = (prev, order)

    def attach(idx):
        nonlocal prev, pending_order
        if prev is not None:
            o = pending_order
            if o is None:
                a1, a2 = mol.atoms[prev], mol.atoms[idx]
                o = AROMATIC if (a1.aromatic and a2.aromatic) else SINGLE
            mol.add_bond(prev, idx, o if o != AROMATIC else SINGLE,
                         aromatic=(o == AROMATIC))
        pending_order = None
        prev = idx

    while i < n:
        ch = s[i]
        if ch == '(':
            if prev is None:
                raise SmilesError('branch with no atom')
            prev_stack.append(prev)
            i += 1
        elif ch == ')':
            if not prev_stack:
                raise SmilesError('unbalanced )')
            prev = prev_stack.pop()
            pending_order = None
            i += 1
        elif ch == '[':
            j = s.find(']', i)
            if j < 0:
                raise SmilesError('unterminated bracket')
            idx = mol.add_atom(_parse_bracket(s[i + 1:j]))
            attach(idx)
            i = j + 1
        elif ch in '-=#:/\\~':
            if ch == '=':
                pending_order = DOUBLE
            elif ch == '#':
                pending_order = TRIPLE
            elif ch == ':':
                pending_order = AROMATIC
            else:  # '-', '/', '\\' all single; '~' treated as single
                pending_order = SINGLE
            i += 1
        elif ch == '%':
            if i + 2 >= n or not s[i + 1:i + 3].isdigit():
                raise SmilesError('bad %ring closure')
            close_or_open_ring(int(s[i + 1:i + 3]), pending_order)
            pending_order = None
            i += 3
        elif ch.isdigit():
            close_or_open_ring(int(ch), pending_order)
            pending_order = None
            i += 1
        elif ch == '.':
            prev = None
            pending_order = None
            i += 1
        else:
            # organic subset atom, possibly two letters
            two = s[i:i + 2]
            if two in _TWO_LETTER:
                idx = mol.add_atom(Atom(two))
                attach(idx)
                i += 2
            elif two == 'se' or two == 'si':
                idx = mol.add_atom(Atom(two.capitalize(), aromatic=True))
                attach(idx)
                i += 2
            elif ch in 'BCNOPSFI*':
                if ch == 'F' and s[i:i + 1] == 'F':
                    pass
                idx = mol.add_atom(Atom(ch))
                attach(idx)
                i += 1
            elif ch in 'bcnops':
                idx = mol.add_atom(Atom(ch.upper(), aromatic=True))
                attach(idx)
                i += 1
            else:
                raise SmilesError(f'unexpected character {ch!r} at {i} in {s!r}')
    if ring_map:
        raise SmilesError('unclosed ring bond')
    if prev_stack:
        raise SmilesError('unbalanced (')
    return mol
