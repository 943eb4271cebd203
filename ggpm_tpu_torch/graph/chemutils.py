"""Motif extraction and attachment labeling utilities (copy of
``ggpm_tpu/graph/chemutils.py``, less the decode-time helpers).

Re-implements the semantics of the reference's chemistry helpers
(ggpm/chemutils.py:45-249) on top of the port's chem kernel:
fragment (motif) extraction by breaking non-ring bonds around rings,
attachment-point ("inter") labeling with atom maps 1/2, anchor SMILES, and
symmetry-aware assembly-candidate enumeration via canonical ranks.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

from ..chem import (Mol, canonical_ranks, copy_atom, get_clique_mol,
                    get_smiles, get_smiles_aromatic)


def idx_of(atom) -> int:
    """Original-molecule index recovered from an atom map (reference
    ``idxfunc``, chemutils.py:8: map numbers are 1-based indices)."""
    return atom.map_num - 1


def find_fragments(mol: Mol) -> List[Tuple[str, Set[int]]]:
    """Break non-ring bonds touching rings/high-degree atoms and return
    (canonical aromatic SMILES, original atom index set) per fragment
    (reference ``find_fragments``, chemutils.py:45-90)."""
    work = mol.clone()
    for i, a in enumerate(work.atoms):
        a.map_num = i

    for b in list(mol.bonds):
        if mol.bond_in_ring(b.a1, b.a2):
            continue
        a1, a2 = b.a1, b.a2
        a1_ring = mol.atom_in_ring(a1)
        a2_ring = mol.atom_in_ring(a2)
        if a1_ring and a2_ring:
            work.remove_bond(a1, a2)
        elif a1_ring and mol.degree(a2) > 1:
            new_idx = work.add_atom(copy_atom(mol.atoms[a1]))
            work.atoms[new_idx].map_num = a1
            work.add_bond(new_idx, a2, b.order)
            work.remove_bond(a1, a2)
        elif a2_ring and mol.degree(a1) > 1:
            new_idx = work.add_atom(copy_atom(mol.atoms[a2]))
            work.atoms[new_idx].map_num = a2
            work.add_bond(new_idx, a1, b.order)
            work.remove_bond(a1, a2)

    hopts = []
    for comp in work.connected_components():
        indices = {work.atoms[i].map_num for i in comp}
        fmol = get_clique_mol(mol, sorted(indices))
        if fmol is None:
            continue
        fsmiles = get_smiles_aromatic(fmol.set_atom_maps(0))
        hopts.append((fsmiles, indices))
    return hopts


def get_leaves(mol: Mol) -> List[int]:
    """Leaf atoms + representative atoms of leaf rings (reference
    ``get_leaves``, chemutils.py:93-113); used for root enumeration."""
    leaf_atoms = [i for i in range(mol.num_atoms) if mol.degree(i) == 1]

    clusters = []
    for b in mol.bonds:
        if not mol.bond_in_ring(b.a1, b.a2):
            clusters.append({b.a1, b.a2})
    rings = [set(r) for r in mol.sssr()]
    clusters.extend(rings)

    leaf_rings = []
    for r in rings:
        inters = [c for c in clusters if r != c and len(r & c) > 0]
        if len(inters) > 1:
            continue
        nodes = [i for i in r if mol.degree(i) == 2]
        if nodes:
            leaf_rings.append(max(nodes))
    return leaf_atoms + leaf_rings


def is_anchor(mol: Mol, atom_idx: int, inter_atoms) -> bool:
    """An attachment atom that also touches the motif interior
    (reference ``is_anchor``, chemutils.py:233-237; neighbours are taken in the
    clique molecule and identified by their original-molecule maps)."""
    for n in mol.neighbors(atom_idx):
        if idx_of(mol.atoms[n]) not in inter_atoms:
            return True
    return False


def get_anchor_smiles(mol: Mol, anchor: int, by_index: bool = False) -> str:
    """Canonical kekulé SMILES with only the anchor atom mapped :1
    (reference ``get_anchor_smiles``, chemutils.py:240-249).  ``by_index``
    identifies the anchor by position instead of by stored atom map (the
    decode-time variant, reference inc_graph.py:268)."""
    copy_mol = mol.clone()
    for i, a in enumerate(copy_mol.atoms):
        key = i if by_index else idx_of(mol.atoms[i])
        a.map_num = 1 if key == anchor else 0
    return get_smiles(copy_mol)


def get_inter_label(mol: Mol, atoms: Sequence[int], inter_atoms: Set[int],
                    atom_cls) -> Tuple[Mol, List[Tuple[int, str]]]:
    """Extract the motif molecule and label its attachment atoms (reference
    ``get_inter_label``, chemutils.py:207-230).

    ``mol`` must carry 1-based atom maps (set by ``label_tree``).  Returns the
    clique Mol re-mapped with 1 (attachment), 2 (shared-with-other-cluster), 0
    — plus [(original atom idx, anchor SMILES)] for each anchor.
    """
    new_mol = get_clique_mol(mol, atoms)
    if new_mol is None:
        raise ValueError('unsanitizable clique')
    if new_mol.num_bonds == 0:
        inter_atom = sorted(inter_atoms)[0]
        new_mol.set_atom_maps(0)
        return new_mol, [(inter_atom, get_smiles_aromatic(new_mol))]

    inter_label = []
    for i, a in enumerate(new_mol.atoms):
        idx = idx_of(a)
        if idx in inter_atoms and is_anchor(new_mol, i, inter_atoms):
            inter_label.append((idx, get_anchor_smiles(new_mol, idx)))

    for a in new_mol.atoms:
        idx = idx_of(a)
        if idx in inter_atoms:
            a.map_num = 1
        elif len(atom_cls[idx]) > 1:
            a.map_num = 2
        else:
            a.map_num = 0
    return new_mol, inter_label


def get_assm_cands(mol: Mol, atoms: Sequence[int], inter_label, cluster,
                   inter_size: int):
    """Enumerate symmetry-distinct attachment candidates in the parent cluster
    (reference ``get_assm_cands``, chemutils.py:182-204).  The gold label is
    candidate 0 by construction."""
    atoms = list(set(atoms))
    cmol = get_clique_mol(mol, atoms)
    if cmol is None:
        return []
    atom_map = [idx_of(a) for a in cmol.atoms]
    cmol.set_atom_maps(0)
    ranks_list = canonical_ranks(cmol, break_ties=False)
    rank: Dict[int, int] = {x: y for x, y in zip(atom_map, ranks_list)}

    pos, icls = zip(*inter_label)
    if inter_size == 1:
        cands = [pos[0]] + [x for x in cluster if rank[x] != rank[pos[0]]]
    elif icls[0] == icls[1]:  # symmetric attachment
        shift = cluster[inter_size - 1:] + cluster[:inter_size - 1]
        pairs = zip(cluster, shift)
        cands = [tuple(pos)] + [
            (x, y) for x, y in pairs
            if (rank[min(x, y)], rank[max(x, y)]) != (rank[min(pos)], rank[max(pos)])]
    else:
        shift = cluster[inter_size - 1:] + cluster[:inter_size - 1]
        pairs = zip(cluster + shift, shift + cluster)
        cands = [tuple(pos)] + [
            (x, y) for x, y in pairs
            if (rank[x], rank[y]) != (rank[pos[0]], rank[pos[1]])]
    return cands
