"""Incremental decode state: growing junction tree + molecular graph (copy
of ``ggpm_tpu/models/inc_graph.py``, less the full-sanitize oracle of
``try_add_mol``, which the JAX package's tests hold).

Host-side counterpart of ggpm/inc_graph.py:10-301, built on the port's chem
kernel instead of RDKit.  The tensor bookkeeping is numpy (uploaded to the
device per decode step by ``ggpm_tpu_torch.models.decode``); the molecule
itself is a single shared editable ``Mol`` where atom 0 is a dummy so node
indexing stays 1-based and aligned with the message-passing tables.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chem import (Atom, Mol, atom_equal, bond_match, copy_atom,
                    get_mol_shared, get_sub_mol, sanitize_smiles_fast)
from ..chem.elements import max_valence
from ..graph.chemutils import get_anchor_smiles
from ..graph.mol_graph import bond_type_index


class IncBase:
    """Growing DAG with agraph/bgraph message bookkeeping (reference
    inc_graph.py:10-57)."""

    def __init__(self, batch_size: int, max_nodes: int = 400,
                 max_edges: int = 500, max_nb: int = 12):
        self.max_nb = max_nb
        self.n_nodes = 1                      # node 0 = padding
        self.next_edge = 1                    # edge row 0 = padding
        self.edge_dict: Dict[Tuple[int, int], int] = {}
        self.preds: Dict[int, List[int]] = defaultdict(list)   # node -> predecessor nodes
        self.succs: Dict[int, List[int]] = defaultdict(list)
        cap_n = max_nodes * batch_size
        cap_e = max_edges * batch_size
        self.fnode = np.zeros((cap_n, 2), dtype=np.int32)
        self.fmess = np.zeros((cap_e, 3), dtype=np.int32)
        self.agraph = np.zeros((cap_n, max_nb), dtype=np.int32)
        self.bgraph = np.zeros((cap_e, max_nb), dtype=np.int32)

    def add_node(self, feature=None) -> int:
        idx = self.n_nodes
        self.n_nodes += 1
        if feature is not None:
            self.fnode[idx, :len(feature)] = feature
        return idx

    def set_node_feature(self, idx: int, feature) -> None:
        self.fnode[idx, :len(feature)] = feature

    def in_degree(self, idx: int) -> int:
        return len(self.preds[idx])

    def can_expand(self, idx: int) -> bool:
        return self.in_degree(idx) < self.max_nb

    def reserve_edges(self, n: int) -> int:
        """Reserve ``n`` consecutive edge rows (speculative decode: rows are
        promised to the device before the branch decision; unused
        reservations are burned).  Returns the first reserved row."""
        first = self.next_edge
        self.next_edge += n
        return first

    def add_edge(self, i: int, j: int, feature=None, row: int = None) -> int:
        if (i, j) in self.edge_dict:
            return self.edge_dict[(i, j)]
        if row is not None:
            idx = row
        else:
            idx = self.next_edge
            self.next_edge += 1
        self.edge_dict[(i, j)] = idx
        self.preds[j].append(i)
        self.succs[i].append(j)
        self.agraph[j, self.in_degree(j) - 1] = idx
        if feature is not None:
            self.fmess[idx, :len(feature)] = feature
        in_edges = [self.edge_dict[(k, i)] for k in self.preds[i] if k != j]
        self.bgraph[idx, :len(in_edges)] = in_edges
        for k in self.succs[j]:
            if k == i:
                continue
            nei_idx = self.edge_dict[(j, k)]
            self.bgraph[nei_idx, self.in_degree(j) - 2] = idx
        return idx


class IncTree(IncBase):
    """Junction tree under construction (reference inc_graph.py:60-91)."""

    def __init__(self, batch_size: int, max_nodes: int = 400,
                 max_edges: int = 500, max_nb: int = 12, max_sub_nodes: int = 30):
        super().__init__(batch_size, max_nodes, max_edges, max_nb)
        self.cgraph = np.zeros((max_nodes * batch_size, max_sub_nodes),
                               dtype=np.int32)
        self.cluster: Dict[int, list] = {}
        self.cluster_edges: Dict[int, list] = {}
        self.attached: Dict[int, list] = {}

    def register_cgraph(self, i: int, nodes, edges, attached) -> None:
        self.cgraph[i, :len(nodes)] = nodes
        self.cluster[i] = nodes
        self.cluster_edges[i] = edges
        self.attached[i] = attached

    def update_attached(self, i: int, attached) -> None:
        if len(self.cluster[i]) > 1:
            used = [x for x, _ in attached]
            self.attached[i].extend(used)

    def get_cluster(self, node_idx: int):
        return self.cluster[node_idx], self.cluster_edges[node_idx], \
            self.attached[node_idx]

    def get_cluster_nodes(self, node_list):
        return [c for n in node_list for c in self.cluster[n]]

    def get_cluster_edges(self, node_list):
        return [e for n in node_list for e in self.cluster_edges[n]]


class IncGraph(IncBase):
    """Molecular graph under construction (reference inc_graph.py:94-301)."""

    def __init__(self, avocab, batch_size: int, max_nodes: int = 400,
                 max_edges: int = 600, max_nb: int = 10):
        super().__init__(batch_size, max_nodes, max_edges, max_nb)
        self.avocab = avocab
        self.mol = Mol()
        self.mol.add_atom(Atom('C'))  # dummy atom 0 keeps 1-based indexing
        self.batch: Dict[int, List[int]] = defaultdict(list)

    def get_smiles(self) -> List[Optional[str]]:
        """Per-sample canonical SMILES of the assembled molecules (reference
        ``get_mol``, inc_graph.py:107-131)."""
        out: List[Optional[str]] = [None] * (max(self.batch.keys()) + 1 if self.batch else 0)
        for bid, atoms in self.batch.items():
            sub = get_sub_mol(self.mol, atoms)
            sub.set_atom_maps(0)
            out[bid] = sanitize_smiles_fast(sub)
        return out

    def add_mol(self, batch_idx: int, ismiles: str, inter_label, nth_child: int):
        """Graft a motif onto the shared molecule via attachment-atom map
        (reference inc_graph.py:136-187).  ``inter_label`` pairs
        (existing mol atom, motif atom)."""
        emol = get_mol_shared(ismiles)
        atom_map = {y: x for x, y in inter_label}
        new_atoms, new_bonds, attached = [], [], []
        interior_atoms = []

        for i, atom in enumerate(emol.atoms):
            if i in atom_map:
                idx = atom_map[i]
                new_atoms.append(idx)
                attached.append(idx)
            else:
                new_atom = copy_atom(atom, with_map=False)
                new_atom.map_num = batch_idx
                idx = self.mol.add_atom(new_atom)
                # fnode carries the atom-vocab index (one-hot on device;
                # reference get_atom_feature, inc_graph.py:243-247)
                try:
                    av = self.avocab[(atom.symbol, atom.charge)]
                except KeyError:
                    av = 0
                node_idx = self.add_node((av,))
                assert idx == node_idx, 'mol and message graph must stay aligned'
                atom_map[i] = idx
                new_atoms.append(idx)
                self.batch[batch_idx].append(idx)
                if atom.map_num == 1:
                    attached.append(idx)
                if atom.map_num == 0:
                    interior_atoms.append(idx)

        for b in emol.bonds:
            a1, a2 = atom_map[b.a1], atom_map[b.a2]
            if a1 == a2:
                continue
            if self.mol.bond_between(a1, a2) is None:
                self.mol.add_bond(a1, a2, b.order, b.aromatic)
                bt = bond_type_index(emol, b)
                # fmess rows carry (source atom type, bond type, nth_child) —
                # the raw features of the reference's get_mess_feature
                # (inc_graph.py:249-257), one-hot-expanded on device
                self.add_edge(a1, a2, (self.fnode[a1, 0], bt,
                                       nth_child if a2 in attached else 0))
                self.add_edge(a2, a1, (self.fnode[a2, 0], bt,
                                       nth_child if a1 in attached else 0))
            else:
                attached.extend([(a1, a2), (a2, a1)])
            new_bonds.extend([self.edge_dict[(a1, a2)], self.edge_dict[(a2, a1)]])

        if emol.num_atoms == 1:
            attached = []
        else:
            attached = attached + interior_atoms
        return new_atoms, new_bonds, attached

    def try_add_mol(self, batch_idx: int, ismiles: str, inter_label) -> bool:
        """Chemical-validity dry run (reference inc_graph.py:190-241).

        The reference grafts the candidate onto the shared RWMol, sanitizes,
        and reverts on failure.  Both the literal mutate-and-rollback port
        and the round-2 copy-merge-serialize-sanitize formulation paid
        milliseconds per call (they dominated decode wall time).  The check
        reduces EXACTLY to an incremental valence test: the sanitize this
        dry-run runs is kekulize + aromaticity-perception + valence
        (chem/api.py sanitize_in_place), and on a graft of a kekulized motif
        onto a kekulized, already-valid partial molecule the first two
        cannot fail (all bond orders are concrete; perception never fails) —
        only atoms INCIDENT TO NEW BONDS can become over-valent.  So score
        just those ~2-6 attachment atoms against the valence model, no copy,
        no serialization (differential-tested against the full-sanitize path
        in tests/test_decode.py)."""
        emol = get_mol_shared(ismiles)
        if emol is None:
            return False
        for x, y in inter_label:
            if not atom_equal(self.mol.atoms[x], emol.atoms[y]):
                return False

        atom_map = {y: x for x, y in inter_label}   # motif idx -> shared-mol idx
        extra: Dict[int, int] = {}                  # added bonded valence per existing atom
        for b in emol.bonds:
            m1 = atom_map.get(b.a1)
            m2 = atom_map.get(b.a2)
            if m1 is not None and m2 is not None:
                if m1 == m2:
                    return False
                if self.mol.bond_between(m1, m2) is None:
                    extra[m1] = extra.get(m1, 0) + b.order
                    extra[m2] = extra.get(m2, 0) + b.order
            elif m1 is not None:
                extra[m1] = extra.get(m1, 0) + b.order
            elif m2 is not None:
                extra[m2] = extra.get(m2, 0) + b.order
            # bonds between two NEW atoms replicate the motif's own (valid)
            # internal valence — nothing to check
        for idx, add in extra.items():
            a = self.mol.atoms[idx]
            if a.symbol == '*':
                continue
            bonded = self.mol.bonded_valence(idx) + add + (a.explicit_h or 0)
            mv = max_valence(a.symbol, a.charge)
            if mv != 0 and bonded > mv:
                return False
        return True

    def get_assm_cands(self, cluster, used, ismiles: str):
        """Enumerate attachment sites on the frontier cluster for a predicted
        motif (reference inc_graph.py:259-301)."""
        emol = get_mol_shared(ismiles)
        if emol is None:
            return [], [], []

        if emol.num_atoms == 1:
            attach_points = [0]
        else:
            attach_points = [i for i, a in enumerate(emol.atoms) if a.map_num == 1]

        inter_size = len(attach_points)
        anchors = attach_points

        if inter_size == 1:
            anchor_smiles = [ismiles]
        elif inter_size == 2:
            anchor_smiles = [get_anchor_smiles(emol, a, by_index=True) for a in anchors]
        else:
            anchors = [a for a in attach_points
                       if is_anchor_self(emol, a, attach_points)]
            attach_points = [a for a in attach_points if a not in anchors]
            if len(anchors) < 2:
                return [], [], []
            attach_points = [anchors[0]] + attach_points + [anchors[1]]
            anchor_smiles = [get_anchor_smiles(emol, a, by_index=True) for a in anchors]

        if len(anchors) > 2:
            return [], [], []

        if inter_size == 1:
            cands = [[x] for x in cluster if x not in used]
        elif anchor_smiles[0] == anchor_smiles[1]:
            cluster2 = list(cluster) + list(cluster)
            cands = [cluster2[i:i + inter_size] for i in range(len(cluster))]
            cands = [c for c in cands if (c[0], c[-1]) not in used and
                     bond_match(self.mol, c[0], c[-1], emol,
                                attach_points[0], attach_points[-1])]
        else:
            cluster2 = list(cluster) + list(cluster)
            cands = [cluster2[i:i + inter_size] for i in range(len(cluster))]
            rev = cluster2[::-1]
            cands += [rev[i:i + inter_size] for i in range(len(cluster))]
            cands = [c for c in cands if (c[0], c[-1]) not in used and
                     bond_match(self.mol, c[0], c[-1], emol,
                                attach_points[0], attach_points[-1])]
        return cands, anchor_smiles, attach_points


def is_anchor_self(emol: Mol, atom_idx: int, inter_atoms) -> bool:
    """Anchor test with identity indexing: the motif here is standalone, so
    'outside the intersection' means a neighbour that is not an attachment
    atom (reference inc_graph.py:277 passes ``[0]`` — atoms with map != 1)."""
    return any(n not in inter_atoms for n in emol.neighbors(atom_idx))
