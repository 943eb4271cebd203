"""Aromaticity perception and kekulization (copy of ``ggpm_tpu/chem/aromatic.py``).

Fills the role of RDKit's sanitization aromaticity model + ``Chem.Kekulize``
(used at every molecule load in the reference, chemutils.py:17-21).  The model
is a pragmatic Hückel 4n+2 over SSSR rings with a fused-ring fixpoint pass —
internally consistent (the only requirement for the rebuilt pipeline, since
motif vocabularies are produced by this same kernel), though not guaranteed
byte-identical to RDKit on exotic systems.
"""

from __future__ import annotations

from typing import Optional

from .mol import DOUBLE, Mol


def _pi_contribution(mol: Mol, idx: int, in_system) -> Optional[int]:
    """Electrons atom ``idx`` contributes to an aromatic π system, or None if
    it cannot sit in one.  ``in_system(j)`` says whether neighbour j is part of
    the candidate ring system."""
    a = mol.atoms[idx]
    sym, chg = a.symbol, a.charge
    deg = mol.degree(idx)
    h = mol.total_h(idx)
    # double bonds from this atom
    dbl_in = any(b.order == DOUBLE and in_system(b.other(idx)) for b in mol.bonds_of(idx))
    dbl_out = any(b.order == DOUBLE and not in_system(b.other(idx)) for b in mol.bonds_of(idx))
    if any(b.order == 3 for b in mol.bonds_of(idx)):
        return None
    if sym == 'C':
        if dbl_in:
            return 1
        if dbl_out:
            # exocyclic C=O/C=N contributes no electrons but stays planar;
            # exocyclic C=C (fulvene-like) blocks aromaticity
            for b in mol.bonds_of(idx):
                if b.order == DOUBLE and not in_system(b.other(idx)):
                    if mol.atoms[b.other(idx)].symbol == 'C':
                        return None
            return 0
        if chg == -1 and deg + h <= 3:
            return 2  # carbanion (cyclopentadienyl)
        if chg == 1 and deg + h <= 3:
            return 0  # tropylium
        if a.aromatic:
            # aromatic-flagged carbon awaiting kekulization: contributes one
            return 1
        return None
    if sym in ('N', 'P'):
        if dbl_in:
            return 1
        if dbl_out:
            return 1 if chg == 1 else 0  # N-oxide style
        # pyrrole-type: three sigma neighbours or an H, lone pair in the ring
        if h > 0 or deg >= 3 or chg == -1:
            return 2
        if a.aromatic:
            return 1  # pyridine-type awaiting kekulization
        return None
    if sym in ('O', 'S', 'Se'):
        if dbl_in:
            return 1 if chg == 1 else None
        if deg == 2:
            return 2
        return None
    if sym == 'B':
        return 0
    if sym == 'Si':
        return 1 if dbl_in else None
    return None


def perceive_aromaticity(mol: Mol) -> None:
    """Set aromatic flags on atoms/bonds of rings passing the Hückel test.

    Works from kekulized bond orders; iterates to a fixpoint so that fused
    systems whose individual rings only pass once a neighbour ring is aromatic
    (e.g. azulene-like frameworks) are found.
    """
    rings = [r for r in mol.sssr() if len(r) <= 8]
    aromatic_atoms = set()
    changed = True
    while changed:
        changed = False
        for ring in rings:
            rset = set(ring)
            if rset <= aromatic_atoms:
                continue

            def in_system(j, rset=rset):
                return j in rset or j in aromatic_atoms

            contribs = []
            ok = True
            for idx in ring:
                c = _pi_contribution(mol, idx, in_system)
                if c is None:
                    ok = False
                    break
                contribs.append(c)
            if not ok:
                continue
            if sum(contribs) % 4 == 2:
                aromatic_atoms |= rset
                changed = True
    # commit flags definitively: atom aromatic iff in an aromatic ring; bond
    # aromatic iff it lies inside an aromatic ring (a single bond bridging two
    # aromatic rings, e.g. biphenyl, is NOT aromatic).
    aromatic_ring_bonds = set()
    for ring in rings:
        rset = set(ring)
        if rset <= aromatic_atoms:
            m = len(ring)
            for k in range(m):
                b = mol.bond_idx_between(ring[k], ring[(k + 1) % m])
                if b is None:
                    # SSSR rings are stored as BFS paths; recover edges from
                    # pairwise adjacency instead
                    continue
                aromatic_ring_bonds.add(b)
            # also catch edges between non-consecutive listed atoms
            for i in ring:
                for bb in mol._adj[i]:
                    if mol.bonds[bb].other(i) in rset:
                        aromatic_ring_bonds.add(bb)
    for i, a in enumerate(mol.atoms):
        a.aromatic = i in aromatic_atoms
    for bi, b in enumerate(mol.bonds):
        b.aromatic = bi in aromatic_ring_bonds


def kekulize(mol: Mol) -> bool:
    """Assign alternating single/double orders to aromatic bonds.

    Finds a perfect matching on the subgraph of aromatic atoms that need one
    π double bond, restricted to aromatic bonds.  Returns False when no
    valid assignment exists (the reference treats that as an unparseable
    molecule, chemutils.py:28-34).
    """
    # Re-sanitize support: when any aromatic-FLAGGED bond already carries a
    # concrete double order, the input is a previously-kekulized molecule
    # whose flags were set by perceive_aromaticity (a fresh aromatic-SMILES
    # parse has all flagged bonds at order 1, and kekulé-written input has
    # no flags).  In that state implicit hydrogens are derivable from the
    # concrete valence, which _needs_pi_bond must use — e.g. a kekulé
    # pyrrole N (no double bond, one implicit H) needs no π bond, while in
    # a fresh aromatic parse an H-less N defaults to pyridine-type.
    pre_kekulized = any(b.aromatic and b.order == DOUBLE for b in mol.bonds)
    needs = set()
    for idx, a in enumerate(mol.atoms):
        if not a.aromatic:
            continue
        if _needs_pi_bond(mol, idx, assume_kekulized=pre_kekulized):
            needs.add(idx)
    arom_bonds = [i for i, b in enumerate(mol.bonds) if b.aromatic]
    if not needs:
        for i in arom_bonds:
            if mol.bonds[i].order != DOUBLE:
                mol.bonds[i].order = 1
        return True

    # adjacency among needs-atoms through aromatic bonds
    adj = {v: [] for v in needs}
    for i in arom_bonds:
        b = mol.bonds[i]
        if b.a1 in needs and b.a2 in needs:
            adj[b.a1].append((b.a2, i))
            adj[b.a2].append((b.a1, i))

    match = _perfect_matching(adj, needs)
    if match is None:
        return False
    matched_bonds = set(match.values())
    for i in arom_bonds:
        mol.bonds[i].order = DOUBLE if i in matched_bonds else 1
    return True


def _needs_pi_bond(mol: Mol, idx: int, assume_kekulized: bool = False) -> bool:
    a = mol.atoms[idx]
    sym, chg = a.symbol, a.charge
    deg = mol.degree(idx)
    h = mol.total_h(idx) if a.explicit_h is not None else None
    has_double = any(b.order == DOUBLE for b in mol.bonds_of(idx))
    if has_double:
        return False  # already has its π bond (pre-kekulized input)
    if sym == 'C':
        if chg != 0:
            return False
        return True
    if sym in ('N', 'P'):
        if chg == -1:
            return False
        if chg == 1:
            return deg <= 2 if a.explicit_h in (None, 0) else (deg + (a.explicit_h or 0)) <= 3
        # neutral: pyrrole type (H present or 3 sigma bonds) has no π bond
        n_h = a.explicit_h or 0
        if n_h == 0 and assume_kekulized and a.explicit_h is None:
            # concrete orders: the implicit H count is valence-derived
            n_h = mol.total_h(idx)
        if n_h > 0:
            return False
        if deg >= 3:
            return False
        return True
    if sym in ('O', 'S', 'Se'):
        return chg == 1
    return False


def _perfect_matching(adj, needs):
    """Perfect matching on a small general graph via backtracking.

    Aromatic subsystems in the GGPM data are unions of 5/6-rings (thiophenes,
    benzenes, fused heteroaromatics); backtracking with a
    lowest-degree-first order is effectively linear there.
    """
    unmatched = set(needs)
    match = {}

    def bt():
        if not unmatched:
            return True
        # pick unmatched vertex with fewest unmatched neighbours
        v = min(unmatched, key=lambda x: sum(1 for w, _ in adj[x] if w in unmatched))
        cands = [(w, bi) for w, bi in adj[v] if w in unmatched]
        if not cands:
            return False
        for w, bi in cands:
            unmatched.discard(v)
            unmatched.discard(w)
            match[(v, w)] = bi
            if bt():
                return True
            del match[(v, w)]
            unmatched.add(v)
            unmatched.add(w)
        return False

    if bt():
        return match
    return None
