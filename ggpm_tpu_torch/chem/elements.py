"""Periodic-table data (copy of ``ggpm_tpu/chem/elements.py``).

This module replaces the slice of RDKit's periodic table that the reference
implementation relies on implicitly (valence models used by
``Chem.MolFromSmiles`` sanitization; cf. the reference ggpm/chemutils.py:17-34).
Only the elements observed in the GGPM datasets (QM9 / HOPV15 / polymer OPV
sets) are covered; unknown elements parse but are treated as zero-implicit-H
species.
"""

from __future__ import annotations

# Atomic numbers for canonical-invariant hashing and fingerprints.
ATOMIC_NUM = {
    '*': 0, 'H': 1, 'B': 5, 'C': 6, 'N': 7, 'O': 8, 'F': 9,
    'Si': 14, 'P': 15, 'S': 16, 'Cl': 17, 'Se': 34, 'Br': 35, 'I': 53,
}

# Allowed valence lists (ordered ascending).  Implicit hydrogen count for an
# organic-subset atom is ``v - bonded`` for the smallest allowed valence
# ``v >= bonded``.
DEFAULT_VALENCES = {
    'B': (3,), 'C': (4,), 'N': (3,), 'O': (2,), 'F': (1,),
    'Si': (4,), 'P': (3, 5), 'S': (2, 4, 6), 'Cl': (1,),
    'Se': (2, 4, 6), 'Br': (1,), 'I': (1, 3, 5), 'H': (1,),
    '*': (),
}

# Maximum total valence accepted during sanitization, by (symbol, charge).
# Charged species get one extra/fewer bond following the usual isoelectronic
# rule; entries cover every bracket atom appearing in the GGPM data files.
_CHARGE_VALENCE_DELTA = {
    ('N', 1): 4, ('N', -1): 2, ('O', 1): 3, ('O', -1): 1,
    ('C', 1): 3, ('C', -1): 3, ('S', 1): 3, ('S', -1): 1,
    ('P', 1): 4, ('P', -1): 2, ('B', -1): 4, ('Se', 1): 3,
    ('I', 1): 2, ('Cl', 1): 2, ('Br', 1): 2,
    ('Si', -1): 5,
}

# Elements readable without brackets in SMILES (the "organic subset").
ORGANIC_SUBSET = {'B', 'C', 'N', 'O', 'P', 'S', 'F', 'Cl', 'Br', 'I', '*'}

# Elements that may carry aromatic (lowercase) flags in SMILES.
AROMATIC_OK = {'B', 'C', 'N', 'O', 'P', 'S', 'Se', 'Si'}


def allowed_valences(symbol: str, charge: int):
    """Valence list for an atom, adjusted for formal charge."""
    if charge != 0:
        v = _CHARGE_VALENCE_DELTA.get((symbol, charge))
        if v is not None:
            return (v,)
        base = DEFAULT_VALENCES.get(symbol)
        if base is None:
            return ()
        # Generic fallback: shift the whole ladder by +|charge| (cations can
        # bind one more neighbour, anions one fewer).
        shift = charge if symbol in ('N', 'O', 'P', 'S', 'Se') else -abs(charge)
        return tuple(max(0, x + shift) for x in base)
    return DEFAULT_VALENCES.get(symbol, ())


def max_valence(symbol: str, charge: int) -> int:
    vals = allowed_valences(symbol, charge)
    return max(vals) if vals else 0


def implicit_h_count(symbol: str, charge: int, bonded: float) -> int:
    """Implicit hydrogens for an organic-subset atom with ``bonded`` valence
    already used by explicit bonds."""
    for v in allowed_valences(symbol, charge):
        if v >= bonded:
            return int(v - bonded)
    return 0


# Average atomic masses (for molecular-weight statistics).
ATOMIC_MASS = {
    '*': 0.0, 'H': 1.008, 'B': 10.811, 'C': 12.011, 'N': 14.007, 'O': 15.999,
    'F': 18.998, 'Si': 28.086, 'P': 30.974, 'S': 32.065, 'Cl': 35.453,
    'Se': 78.971, 'Br': 79.904, 'I': 126.904,
}
