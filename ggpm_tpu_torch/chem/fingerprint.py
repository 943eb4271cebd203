"""Morgan (ECFP-style) fingerprints and Tanimoto similarity (copy of
``ggpm_tpu/chem/fingerprint.py``).

Replaces ``AllChem.GetMorganFingerprintAsBitVect`` + ``DataStructs
.TanimotoSimilarity`` (reference nnutils.py:175-179) and backs the
SNN / internal-diversity evaluation metrics (reference evaluation/metrics.py).
"""

from __future__ import annotations

from typing import Set

from .elements import ATOMIC_NUM
from .mol import Mol

_MASK64 = (1 << 64) - 1


def _mix(*vals: int) -> int:
    h = 0xcbf29ce484222325
    for v in vals:
        h ^= (v & _MASK64)
        h = (h * 0x100000001b3) & _MASK64
    return h


def morgan_bits(mol: Mol, radius: int = 3, n_bits: int = 2048) -> Set[int]:
    """Set of on-bits of a Morgan fingerprint."""
    n = mol.num_atoms
    inv = []
    for i, a in enumerate(mol.atoms):
        inv.append(_mix(ATOMIC_NUM.get(a.symbol, 99), a.charge & 0xff,
                        mol.degree(i), mol.total_h(i),
                        1 if a.aromatic else 0,
                        1 if mol.atom_in_ring(i) else 0))
    bits = set()
    for h in inv:
        bits.add(h % n_bits)
    cur = inv
    for _ in range(radius):
        nxt = [0] * n
        for i in range(n):
            neigh = sorted(
                _mix(b.order if not b.aromatic else 9, cur[b.other(i)])
                for b in mol.bonds_of(i)
            )
            nxt[i] = _mix(cur[i], *neigh)
            bits.add(nxt[i] % n_bits)
        cur = nxt
    return bits


def tanimoto(bits_a: Set[int], bits_b: Set[int]) -> float:
    if not bits_a and not bits_b:
        return 1.0
    inter = len(bits_a & bits_b)
    union = len(bits_a | bits_b)
    return inter / union if union else 0.0


def tanimoto_smiles(smiles_a: str, smiles_b: str, radius: int = 3,
                    n_bits: int = 2048) -> float:
    """Tanimoto distance on Morgan fingerprints from SMILES (reference
    ``get_tanimoto_dist``, nnutils.py:175-179)."""
    from .api import get_mol
    ma, mb = get_mol(smiles_a), get_mol(smiles_b)
    if ma is None or mb is None:
        return 0.0
    return round(tanimoto(morgan_bits(ma, radius, n_bits),
                          morgan_bits(mb, radius, n_bits)), 3)
