"""The chemistry that tensorization needs, in pure Python: SMILES parse
and write, kekulization, aromaticity perception, canonical ranks and
molecule editing (a frozen copy of the port's ``chem/`` without the
fingerprints, BRICS and SA score, which training does not read)."""

from .api import (canon_smiles, copy_atom, get_clique_mol, get_mol,
                  get_smiles, get_smiles_aromatic)
from .canon import canonical_ranks
from .mol import AROMATIC, DOUBLE, SINGLE, TRIPLE, Mol

__all__ = ['AROMATIC', 'DOUBLE', 'SINGLE', 'TRIPLE', 'Mol', 'canon_smiles',
           'canonical_ranks', 'copy_atom', 'get_clique_mol', 'get_mol',
           'get_smiles', 'get_smiles_aromatic']
