"""ggpm_tpu_torch.chem — the pure-Python chemistry kernel of ``ggpm_tpu.chem``.

SMILES parse/write, kekulization, aromaticity perception, SSSR, canonical
ranking and molecular editing: the subset the graph layer needs to tensorize
molecules and the decoder needs to assemble them; and Morgan fingerprints,
BRICS fragments and the SA score, which the evaluation suite reads.  Copied,
not imported, so that the port runs where JAX is not installed.
"""

from .api import (atom_equal, bond_match, canon_smiles, copy_atom,
                  copy_edit_mol, get_clique_mol, get_mol, get_mol_shared,
                  get_smiles, get_smiles_aromatic, get_sub_mol, sanitize,
                  sanitize_in_place, sanitize_smiles_fast, valid_fast)
from .brics import brics_decompose, brics_fragments, find_brics_bonds
from .canon import canonical_ranks
from .fingerprint import morgan_bits, tanimoto, tanimoto_smiles
from .sascore import FragmentScores, calculate_sa, morgan_frag_counts
from .mol import AROMATIC, BOND_TYPES, DOUBLE, SINGLE, TRIPLE, Atom, Bond, Mol
from .parse import mol_from_smiles
from .write import mol_to_smiles

__all__ = [
    'Atom', 'Bond', 'Mol', 'SINGLE', 'DOUBLE', 'TRIPLE', 'AROMATIC',
    'BOND_TYPES', 'mol_from_smiles', 'mol_to_smiles', 'canonical_ranks',
    'get_mol', 'get_smiles', 'get_smiles_aromatic', 'canon_smiles',
    'sanitize_in_place', 'get_sub_mol', 'get_clique_mol', 'copy_atom',
    'get_mol_shared', 'valid_fast', 'sanitize_smiles_fast', 'copy_edit_mol',
    'atom_equal', 'bond_match', 'sanitize',
    'morgan_bits', 'tanimoto', 'tanimoto_smiles',
    'brics_decompose', 'brics_fragments', 'find_brics_bonds',
    'FragmentScores', 'calculate_sa', 'morgan_frag_counts',
]
