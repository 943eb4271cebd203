"""Molecular graph data model (copy of ``ggpm_tpu/chem/mol.py``).

A minimal, editable molecule representation that supplies everything the GGPM
pipeline needs from RDKit's ``Mol``/``RWMol`` (cf. reference usage in
the reference ggpm/chemutils.py and the reference ggpm/inc_graph.py):
atoms with symbol/charge/H-count/aromaticity/atom-map, typed bonds, editing
(add/remove atoms and bonds with RDKit-style reindex-on-delete), ring
membership, and SSSR ring perception.

Bond orders are integers 1/2/3; the ``aromatic`` flag on atoms and bonds is
carried separately (molecules are kept kekulized, mirroring the reference's
``get_mol`` which calls ``Chem.Kekulize`` on load).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .elements import implicit_h_count, max_valence

SINGLE, DOUBLE, TRIPLE, AROMATIC = 1, 2, 3, 4
# Bond-type order must match the reference's feature indexing
# (MolGraph.BOND_LIST = [SINGLE, DOUBLE, TRIPLE, AROMATIC],
#  the reference ggpm/mol_graph.py:14-15).
BOND_TYPES = (SINGLE, DOUBLE, TRIPLE, AROMATIC)


class Atom:
    __slots__ = ('symbol', 'charge', 'explicit_h', 'aromatic', 'map_num', 'isotope')

    def __init__(self, symbol: str, charge: int = 0, explicit_h: Optional[int] = None,
                 aromatic: bool = False, map_num: int = 0, isotope: int = 0):
        self.symbol = symbol
        self.charge = charge
        # None = implicit-H determined by the valence model; an int means the
        # count came from a bracket atom and is frozen.
        self.explicit_h = explicit_h
        self.aromatic = aromatic
        self.map_num = map_num
        self.isotope = isotope

    def clone(self) -> 'Atom':
        return Atom(self.symbol, self.charge, self.explicit_h, self.aromatic,
                    self.map_num, self.isotope)

    def __repr__(self):
        return f'Atom({self.symbol}{"+" * max(0, self.charge)}{"-" * max(0, -self.charge)})'


class Bond:
    __slots__ = ('a1', 'a2', 'order', 'aromatic')

    def __init__(self, a1: int, a2: int, order: int = SINGLE, aromatic: bool = False):
        self.a1 = a1
        self.a2 = a2
        self.order = order
        self.aromatic = aromatic

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1

    def clone(self) -> 'Bond':
        return Bond(self.a1, self.a2, self.order, self.aromatic)


class Mol:
    """Editable molecular graph (plays both Mol and RWMol roles)."""

    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        # adjacency: atom idx -> list of bond indices
        self._adj: List[List[int]] = []
        self._ring_info = None  # invalidated on edit

    # -- construction / editing -------------------------------------------
    def add_atom(self, atom: Atom) -> int:
        self.atoms.append(atom)
        self._adj.append([])
        self._ring_info = None
        return len(self.atoms) - 1

    def add_bond(self, a1: int, a2: int, order: int = SINGLE, aromatic: bool = False) -> int:
        if a1 == a2:
            raise ValueError('self-bond')
        if self.bond_between(a1, a2) is not None:
            raise ValueError(f'duplicate bond {a1}-{a2}')
        self.bonds.append(Bond(a1, a2, order, aromatic))
        bidx = len(self.bonds) - 1
        self._adj[a1].append(bidx)
        self._adj[a2].append(bidx)
        self._ring_info = None
        return bidx

    def remove_bond(self, a1: int, a2: int) -> None:
        bidx = self.bond_idx_between(a1, a2)
        if bidx is None:
            return
        self.bonds.pop(bidx)
        # reindex bond references
        self._rebuild_adj()

    def remove_atom(self, idx: int) -> None:
        """Remove atom ``idx``; atoms after it shift down by one (RDKit
        RemoveAtom semantics, relied on by incremental assembly rollback,
        reference inc_graph.py:236-239)."""
        self.bonds = [b for b in self.bonds if b.a1 != idx and b.a2 != idx]
        for b in self.bonds:
            if b.a1 > idx:
                b.a1 -= 1
            if b.a2 > idx:
                b.a2 -= 1
        self.atoms.pop(idx)
        self._rebuild_adj()

    def _rebuild_adj(self):
        self._adj = [[] for _ in self.atoms]
        for i, b in enumerate(self.bonds):
            self._adj[b.a1].append(i)
            self._adj[b.a2].append(i)
        self._ring_info = None

    # -- queries -----------------------------------------------------------
    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def atom(self, idx: int) -> Atom:
        return self.atoms[idx]

    def neighbors(self, idx: int) -> List[int]:
        return [self.bonds[b].other(idx) for b in self._adj[idx]]

    def bonds_of(self, idx: int) -> List[Bond]:
        return [self.bonds[b] for b in self._adj[idx]]

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def bond_idx_between(self, a1: int, a2: int) -> Optional[int]:
        for b in self._adj[a1]:
            bond = self.bonds[b]
            if bond.other(a1) == a2:
                return b
        return None

    def bond_between(self, a1: int, a2: int) -> Optional[Bond]:
        b = self.bond_idx_between(a1, a2)
        return self.bonds[b] if b is not None else None

    def bonded_valence(self, idx: int) -> int:
        """Sum of bond orders at an atom (kekulized orders)."""
        return sum(b.order for b in self.bonds_of(idx))

    def total_h(self, idx: int) -> int:
        a = self.atoms[idx]
        if a.explicit_h is not None:
            return a.explicit_h
        return implicit_h_count(a.symbol, a.charge, self.bonded_valence(idx))

    def valence_ok(self, idx: int) -> bool:
        a = self.atoms[idx]
        if a.symbol == '*':
            return True
        bonded = self.bonded_valence(idx) + (a.explicit_h or 0)
        mv = max_valence(a.symbol, a.charge)
        return mv == 0 or bonded <= mv

    # -- ring perception ---------------------------------------------------
    def ring_info(self):
        if self._ring_info is None:
            self._ring_info = _perceive_rings(self)
        return self._ring_info

    def atom_in_ring(self, idx: int) -> bool:
        return idx in self.ring_info().ring_atoms

    def bond_in_ring(self, a1: int, a2: int) -> bool:
        b = self.bond_idx_between(a1, a2)
        return b is not None and b in self.ring_info().ring_bonds

    def sssr(self) -> List[Tuple[int, ...]]:
        return self.ring_info().sssr

    # -- misc --------------------------------------------------------------
    def clone(self) -> 'Mol':
        m = Mol()
        for a in self.atoms:
            m.add_atom(a.clone())
        for b in self.bonds:
            m.add_bond(b.a1, b.a2, b.order, b.aromatic)
        return m

    def set_atom_maps(self, num: int = 0) -> 'Mol':
        for a in self.atoms:
            a.map_num = num
        return self

    def connected_components(self) -> List[List[int]]:
        seen = [False] * self.num_atoms
        comps = []
        for start in range(self.num_atoms):
            if seen[start]:
                continue
            comp, stack = [], [start]
            seen[start] = True
            while stack:
                v = stack.pop()
                comp.append(v)
                for n in self.neighbors(v):
                    if not seen[n]:
                        seen[n] = True
                        stack.append(n)
            comps.append(sorted(comp))
        return comps


class _RingInfo:
    __slots__ = ('ring_atoms', 'ring_bonds', 'sssr')

    def __init__(self, ring_atoms, ring_bonds, sssr):
        self.ring_atoms = ring_atoms
        self.ring_bonds = ring_bonds
        self.sssr = sssr


def _perceive_rings(mol: Mol) -> _RingInfo:
    """Ring membership via bridge-finding plus an SSSR built from a minimum
    cycle basis (equivalent in role to ``Chem.GetSymmSSSR``, reference
    mol_graph.py:55)."""
    # 1. find bridges (Tarjan) — a bond is in a ring iff it is not a bridge.
    n = mol.num_atoms
    disc = [-1] * n
    low = [0] * n
    bridges = set()
    timer = [0]
    for root in range(n):
        if disc[root] != -1:
            continue
        # iterative DFS
        stack = [(root, -1, iter(mol._adj[root]))]
        disc[root] = low[root] = timer[0]
        timer[0] += 1
        while stack:
            v, parent_bond, it = stack[-1]
            advanced = False
            for bidx in it:
                if bidx == parent_bond:
                    continue
                w = mol.bonds[bidx].other(v)
                if disc[w] == -1:
                    disc[w] = low[w] = timer[0]
                    timer[0] += 1
                    stack.append((w, bidx, iter(mol._adj[w])))
                    advanced = True
                    break
                else:
                    low[v] = min(low[v], disc[w])
            if not advanced:
                stack.pop()
                if stack:
                    u, _, _ = stack[-1]
                    low[u] = min(low[u], low[v])
                    if low[v] > disc[u]:
                        bridges.add(parent_bond)
    ring_bonds = {i for i in range(mol.num_bonds) if i not in bridges}
    ring_atoms = set()
    for i in ring_bonds:
        ring_atoms.add(mol.bonds[i].a1)
        ring_atoms.add(mol.bonds[i].a2)

    sssr = _min_cycle_basis(mol, ring_bonds)
    return _RingInfo(ring_atoms, ring_bonds, sssr)


def _min_cycle_basis(mol: Mol, ring_bonds) -> List[Tuple[int, ...]]:
    """Smallest-set-of-smallest-rings over the ring subgraph.

    Greedy Horton-style construction: collect the shortest cycle through every
    ring bond, sort by length, and keep cycles that are independent in GF(2)
    edge space until the basis has rank ``E - V + C``.
    """
    if not ring_bonds:
        return []
    # restrict to ring subgraph
    sub_adj = {}
    for bidx in ring_bonds:
        b = mol.bonds[bidx]
        sub_adj.setdefault(b.a1, []).append((b.a2, bidx))
        sub_adj.setdefault(b.a2, []).append((b.a1, bidx))
    nverts = len(sub_adj)
    ncomp = _count_components(sub_adj)
    rank_needed = len(ring_bonds) - nverts + ncomp

    candidates = []
    for bidx in ring_bonds:
        cyc = _shortest_cycle_through(mol, sub_adj, bidx)
        if cyc is not None:
            candidates.append(cyc)
    # dedupe and sort by size then lexicographic for determinism
    seen = set()
    uniq = []
    for atoms, bonds in candidates:
        key = frozenset(bonds)
        if key not in seen:
            seen.add(key)
            uniq.append((atoms, bonds))
    uniq.sort(key=lambda c: (len(c[1]), sorted(c[0])))

    basis_rows = []  # GF(2)-reduced bond-bitmask rows
    chosen = []
    for atoms, bonds in uniq:
        if len(chosen) >= rank_needed:
            break
        vec = 0
        for b in bonds:
            vec |= (1 << b)
        cur = vec
        for row in basis_rows:
            cur = min(cur, cur ^ row)
        if cur != 0:
            basis_rows.append(cur)
            basis_rows.sort(reverse=True)
            chosen.append(tuple(atoms))
    return chosen


def _count_components(adj) -> int:
    seen = set()
    comps = 0
    for start in adj:
        if start in seen:
            continue
        comps += 1
        stack = [start]
        seen.add(start)
        while stack:
            v = stack.pop()
            for w, _ in adj[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
    return comps


def _shortest_cycle_through(mol: Mol, sub_adj, bidx):
    """Shortest cycle containing bond ``bidx`` = bond + shortest path between
    its endpoints avoiding the bond itself (BFS)."""
    b = mol.bonds[bidx]
    src, dst = b.a1, b.a2
    prev = {src: (None, None)}
    queue = [src]
    while queue:
        nxt = []
        for v in queue:
            for w, eb in sub_adj[v]:
                if eb == bidx or w in prev:
                    continue
                prev[w] = (v, eb)
                if w == dst:
                    atoms, bonds = [], [bidx]
                    cur = w
                    while cur is not None:
                        atoms.append(cur)
                        cur, eb2 = prev[cur]
                        if eb2 is not None:
                            bonds.append(eb2)
                    return atoms, bonds
                nxt.append(w)
        queue = nxt
    return None
