"""QM9 raw-file parsing and 3-D featurization (copy of
``ggpm_tpu/data/qm9.py``).

Reference: data/preprocess_qm9.py (xyz-style file → (SMILES, HOMO, LUMO)
CSV, skipping C/N/O singletons) and the torch-geometric ``QM9Dataset``
featurizer (ggpm/dataset.py:121-191).  The featurizer produces plain numpy
arrays (one-hot atom types, atomic numbers, aromaticity/hybridization-proxy
flags, 3-D positions, typed edges) — no torch-geometric dependency.  The
CSV is written without pandas, as pandas writes it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..chem import get_mol
from ..chem.elements import ATOMIC_NUM
from .vocab_extract import pool

QM9_ATOMS = {'H': 0, 'C': 1, 'N': 2, 'O': 3, 'F': 4}


def read_and_extract(files: Sequence[str], path_dir: str) -> List[list]:
    """Parse QM9 ``.xyz``-style files into [SMILES, HOMO, LUMO] rows.
    The two orbital energies are fields 6:8 of the scalar-property line;
    single-heavy-atom molecules (C/N/O) are skipped."""
    files = files if isinstance(files, (list, tuple)) else [files]
    rows = []
    for fname in files:
        try:
            with open(os.path.join(path_dir, fname)) as f:
                lines = f.read().split('\n')
            n_atoms = int(lines[0])
            smiles = lines[3 + n_atoms].split('\t')[0]
            if smiles in ('C', 'N', 'O'):
                continue
            props = lines[1].split(' ')[-1].split('\t')
            homo, lumo = float(props[6]), float(props[7])
            rows.append([smiles, homo, lumo])
        except (ValueError, IndexError):
            continue
    return rows


def extract_qm9_csv(data_dir: str, out_csv: Optional[str] = None,
                    ncpu: int = 1) -> List[list]:
    files = sorted(os.listdir(data_dir))
    if ncpu > 1:
        bs = len(files) // ncpu + 1
        chunks = [(files[i:i + bs], data_dir) for i in range(0, len(files), bs)]
        with pool(ncpu) as p:
            results = p.starmap(read_and_extract, chunks)
        rows = [r for c in results for r in c]
    else:
        rows = read_and_extract(files, data_dir)
    if out_csv:
        from ..cli.common import write_csv
        write_csv(out_csv, [dict(SMILES=s, HOMO=h, LUMO=l)
                            for s, h, l in rows],
                  columns=['SMILES', 'HOMO', 'LUMO'])
    return rows


def read_xyz_positions(path: str) -> Optional[np.ndarray]:
    """3-D coordinates from a QM9 xyz file ([n_atoms, 3], heavy+H)."""
    try:
        with open(path) as f:
            lines = f.read().split('\n')
        n = int(lines[0])
        pos = []
        for line in lines[2:2 + n]:
            parts = line.replace('*^', 'e').split('\t')
            pos.append([float(x) for x in parts[1:4]])
        return np.asarray(pos, dtype=np.float32)
    except (ValueError, IndexError):
        return None


def featurize_qm9(smiles: str, pos: Optional[np.ndarray] = None) -> Optional[Dict[str, np.ndarray]]:
    """Per-molecule features mirroring the reference QM9Dataset item
    (dataset.py:131-191): one-hot type, atomic number, aromatic flag,
    hybridization proxies (sp/sp2/sp3 by unsaturation), H counts, typed
    directed edge list, optional 3-D positions."""
    mol = get_mol(smiles)
    if mol is None:
        return None
    n = mol.num_atoms
    type_idx = np.zeros(n, dtype=np.int64)
    z = np.zeros(n, dtype=np.int64)
    aromatic = np.zeros(n, dtype=np.float32)
    sp = np.zeros(n, dtype=np.float32)
    sp2 = np.zeros(n, dtype=np.float32)
    sp3 = np.zeros(n, dtype=np.float32)
    num_hs = np.zeros(n, dtype=np.float32)
    for i, a in enumerate(mol.atoms):
        type_idx[i] = QM9_ATOMS.get(a.symbol, len(QM9_ATOMS))
        z[i] = ATOMIC_NUM.get(a.symbol, 0)
        aromatic[i] = 1.0 if a.aromatic else 0.0
        orders = [b.order for b in mol.bonds_of(i)]
        if 3 in orders or orders.count(2) >= 2:
            sp[i] = 1.0
        elif 2 in orders or a.aromatic:
            sp2[i] = 1.0
        else:
            sp3[i] = 1.0
        num_hs[i] = mol.total_h(i)

    rows, cols, etype = [], [], []
    for b in mol.bonds:
        bt = 3 if b.aromatic else b.order - 1
        rows += [b.a1, b.a2]
        cols += [b.a2, b.a1]
        etype += [bt, bt]
    edge_index = np.asarray([rows, cols], dtype=np.int64)
    order = np.argsort(edge_index[0] * n + edge_index[1])
    edge_index = edge_index[:, order]
    etype = np.asarray(etype, dtype=np.int64)[order]
    edge_attr = np.eye(4, dtype=np.float32)[etype]

    x1 = np.eye(len(QM9_ATOMS) + 1, dtype=np.float32)[type_idx]
    x2 = np.stack([z.astype(np.float32), aromatic, sp, sp2, sp3, num_hs],
                  axis=1)
    return {'x': np.concatenate([x1, x2], axis=1), 'z': z,
            'pos': pos, 'edge_index': edge_index, 'edge_attr': edge_attr}


class QM9Dataset:
    """Iterable of featurized QM9 molecules (reference dataset.py:121-191)."""

    def __init__(self, data: Sequence[str], positions: Optional[Sequence] = None):
        self.data = list(data)
        self.positions = positions

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        pos = self.positions[idx] if self.positions is not None else None
        return featurize_qm9(self.data[idx], pos)
