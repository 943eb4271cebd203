"""High-level chemistry API: the pure-Python path of ``ggpm_tpu/chem/api.py``.

The functional surface the graph layer programs against — the replacement for
the RDKit calls in the reference's chemistry layer (ggpm/chemutils.py:17-34,
126-179).  The JAX package can route canonicalisation through a native
library; the port keeps only the Python path, which that library mirrors
exactly (tests/test_native.py).
"""

from __future__ import annotations

import functools
from typing import Iterable, Optional

from .aromatic import kekulize, perceive_aromaticity
from .mol import Atom, Mol
from .parse import mol_from_smiles
from .write import mol_to_smiles


def sanitize_in_place(mol: Mol) -> bool:
    """Kekulize + perceive aromaticity + valence-check.  Returns False when
    the molecule is chemically invalid (over-valent atom or un-kekulizable
    aromatic system)."""
    try:
        if not kekulize(mol):
            return False
    except Exception:
        return False
    perceive_aromaticity(mol)
    for i in range(mol.num_atoms):
        if not mol.valence_ok(i):
            return False
    return True


def get_mol(smiles: str) -> Optional[Mol]:
    """Parse + sanitize + kekulize (reference ``get_mol``, chemutils.py:17-21).
    The returned Mol always carries concrete 1/2/3 bond orders; aromaticity is
    recorded via flags."""
    if smiles is None:
        return None
    return mol_from_smiles(smiles)


@functools.lru_cache(maxsize=16384)
def get_mol_shared(smiles: str) -> Optional[Mol]:
    """Memoized ``get_mol`` for decode-time motif lookups, which parse the
    same vocab ismiles many times.  The result is READ-ONLY: callers must
    clone it before any edit."""
    return get_mol(smiles)


def valid_fast(mol: Mol) -> bool:
    """Validity check (kekulize + aromaticity perception + valence); the
    JAX package's native route computes the same."""
    return sanitize_in_place(mol)


def sanitize_smiles_fast(mol: Mol) -> Optional[str]:
    """Sanitize, then canonical aromatic SMILES; None when the molecule is
    chemically invalid."""
    if sanitize_in_place(mol):
        return mol_to_smiles(mol, kekule=False)
    return None


def get_smiles(mol: Mol) -> str:
    """Canonical kekulé SMILES (reference ``get_smiles``, chemutils.py:24-25)."""
    return mol_to_smiles(mol, kekule=True)


def get_smiles_aromatic(mol: Mol) -> str:
    """Canonical aromatic-form SMILES (RDKit MolToSmiles default)."""
    return mol_to_smiles(mol, kekule=False)


def sanitize(mol: Optional[Mol], kekule: bool = True) -> Optional[Mol]:
    """Round-trip through SMILES, mirroring the reference's ``sanitize``
    (chemutils.py:28-34): returns a fresh canonical Mol or None."""
    if mol is None:
        return None
    try:
        smiles = mol_to_smiles(mol, kekule=kekule)
        return mol_from_smiles(smiles)
    except Exception:
        return None


def canon_smiles(smiles: str) -> Optional[str]:
    """Canonicalize a SMILES string (aromatic form); None if unparseable."""
    mol = get_mol(smiles)
    return get_smiles_aromatic(mol) if mol is not None else None


def copy_atom(atom: Atom, with_map: bool = True) -> Atom:
    """Shallow atom copy keeping symbol/charge(/map) only (reference
    ``copy_atom``, chemutils.py:126-132)."""
    a = Atom(atom.symbol, atom.charge)
    if with_map:
        a.map_num = atom.map_num
    return a


def get_sub_mol(mol: Mol, sub_atoms: Iterable[int]) -> Mol:
    """Induced subgraph on ``sub_atoms`` (reference ``get_sub_mol``,
    chemutils.py:136-153).  Atom attributes are copied wholesale (including
    explicit-H and aromatic flags); bonds keep their kekulized orders."""
    sub_atoms = list(sub_atoms)
    new_mol = Mol()
    atom_map = {}
    for idx in sub_atoms:
        atom_map[idx] = new_mol.add_atom(mol.atoms[idx].clone())
    sset = set(sub_atoms)
    for idx in sset:
        for b in mol.bonds_of(idx):
            j = b.other(idx)
            if j in sset and idx < j:
                new_mol.add_bond(atom_map[idx], atom_map[j], b.order, b.aromatic)
    return new_mol


def copy_edit_mol(mol: Mol) -> Mol:
    """Deep copy keeping only symbol/charge/map and bond orders (reference
    ``copy_edit_mol``, chemutils.py:156-170)."""
    new_mol = Mol()
    for a in mol.atoms:
        new_mol.add_atom(copy_atom(a))
    for b in mol.bonds:
        new_mol.add_bond(b.a1, b.a2, b.order, b.aromatic)
    return new_mol


def get_clique_mol(mol: Mol, atoms: Iterable[int]) -> Optional[Mol]:
    """Extract the induced fragment and resanitize it as a standalone molecule
    (reference ``get_clique_mol``, chemutils.py:173-179).  Bond orders come
    from the kekulized parent, so partial aromatic rings keep valid valences."""
    frag = get_sub_mol(mol, atoms)
    # fragment atoms lose ring context: recompute aromaticity from scratch
    for a in frag.atoms:
        a.aromatic = False
    for b in frag.bonds:
        b.aromatic = False
    ok = sanitize_in_place(frag)
    return frag if ok else None


def atom_equal(a1: Atom, a2: Atom) -> bool:
    """Symbol+charge equality (reference chemutils.py:116-117)."""
    return a1.symbol == a2.symbol and a1.charge == a2.charge


def bond_match(mol1: Mol, a1: int, b1: int, mol2: Mol, a2: int, b2: int) -> bool:
    """Endpoint-typed bond match (reference chemutils.py:120-123)."""
    return atom_equal(mol1.atoms[a1], mol2.atoms[a2]) and \
        atom_equal(mol1.atoms[b1], mol2.atoms[b2])
