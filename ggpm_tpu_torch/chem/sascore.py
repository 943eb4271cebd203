"""Ertl–Schuffenhauer synthetic-accessibility (SA) score.

Implements the published SA algorithm (Ertl & Schuffenhauer, *Estimation of
synthetic accessibility score of drug-like molecules based on molecular
complexity and fragment contributions*, J. Cheminformatics 1:8, 2009) on the
ggpm_tpu chem kernel.  This replaces the ring/branch proxy previously used by
``eval/metrics.py`` and matches the definition MOSES' SA statistic delegates
to (reference the reference evaluation/metrics.py:230-247 →
``moses.get_all_metrics`` → RDKit-contrib ``sascorer``).

Two halves, exactly as published:

* **fragment score** — mean contribution of the molecule's circular
  (Morgan radius-2) fragments, where a fragment's contribution is its
  relative log10 frequency in a reference corpus.  RDKit ships a table
  precomputed over ~1M PubChem molecules (``fpscores.pkl.gz``), which is not
  redistributable here; instead :class:`FragmentScores` computes the table
  from any corpus with the paper's recipe (log10 frequency relative to the
  corpus mean, clipped to [-4, 4]; unseen fragments score −4 as in
  ``sascorer``).  For distribution *statistics* (the SA Wasserstein metric)
  the corpus is the evaluation reference set, making the statistic
  self-contained and deterministic.
* **complexity penalty** — size^1.005 − size, log10 penalties for
  stereocentre / spiro / bridgehead counts, a flat log10(2) macrocycle
  penalty, and the fingerprint-density correction, combined and rescaled to
  the published 1..10 range (ceiling-compressed above 8).

Deviations (documented):
* fragment identifiers use this kernel's Morgan hashing, so the raw ids
  differ from RDKit's — contributions are learned per-corpus, which is the
  paper's procedure, not a table-compatibility exercise;
* potential stereocentres are detected as sp3 carbons with four distinct
  depth-limited substituent environments (RDKit's ``includeUnassigned=True``
  CIP walk; this kernel does not track parity, which the count ignores
  anyway).
"""

from __future__ import annotations

import json
import math
from collections import Counter
from typing import Dict, Iterable, Optional

from .elements import ATOMIC_NUM
from .mol import Mol

_MASK64 = (1 << 64) - 1


def _mix(*vals: int) -> int:
    h = 0xcbf29ce484222325
    for v in vals:
        h ^= (v & _MASK64)
        h = (h * 0x100000001b3) & _MASK64
    return h


def morgan_frag_counts(mol: Mol, radius: int = 2) -> Counter:
    """Unfolded Morgan fragment identifiers with counts — the analogue of
    ``GetMorganFingerprint(mol, 2).GetNonzeroElements()``: every atom
    contributes one environment id per radius 0..``radius``."""
    n = mol.num_atoms
    inv = []
    for i, a in enumerate(mol.atoms):
        inv.append(_mix(ATOMIC_NUM.get(a.symbol, 99), a.charge & 0xff,
                        mol.degree(i), mol.total_h(i),
                        1 if a.aromatic else 0,
                        1 if mol.atom_in_ring(i) else 0))
    counts: Counter = Counter(inv)
    cur = inv
    for _ in range(radius):
        nxt = [0] * n
        for i in range(n):
            neigh = sorted(
                _mix(b.order if not b.aromatic else 9, cur[b.other(i)])
                for b in mol.bonds_of(i))
            nxt[i] = _mix(cur[i], *neigh)
        counts.update(nxt)
        cur = nxt
    return counts


class FragmentScores:
    """Corpus-derived fragment contribution table (the paper's Fig. 2 step).

    ``fit`` counts radius-2 Morgan fragments over a corpus and assigns each
    fragment ``log10(count / mean_count)`` clipped to [-4, 4]; fragments not
    seen in the corpus contribute the floor value −4 (matching ``sascorer``'s
    default for unknown ids).
    """

    FLOOR = -4.0
    CEIL = 4.0

    def __init__(self, scores: Optional[Dict[int, float]] = None):
        self.scores = scores or {}

    @classmethod
    def fit(cls, mols: Iterable[Optional[Mol]], radius: int = 2
            ) -> 'FragmentScores':
        counts: Counter = Counter()
        for m in mols:
            if m is None:
                continue
            counts.update(morgan_frag_counts(m, radius))
        if not counts:
            return cls({})
        mean = sum(counts.values()) / len(counts)
        scores = {
            fid: max(cls.FLOOR, min(cls.CEIL, math.log10(c / mean)))
            for fid, c in counts.items()
        }
        return cls(scores)

    def get(self, fid: int) -> float:
        return self.scores.get(fid, self.FLOOR)

    def save(self, path: str) -> None:
        with open(path, 'w') as f:
            json.dump({str(k): v for k, v in self.scores.items()}, f)

    @classmethod
    def load(cls, path: str) -> 'FragmentScores':
        with open(path) as f:
            raw = json.load(f)
        return cls({int(k): float(v) for k, v in raw.items()})


def _branch_hash(mol: Mol, start: int, exclude: int, depth: int = 3) -> int:
    """Order-independent hash of the substituent branch rooted at ``start``
    seen from ``exclude`` (depth-limited BFS) — used to decide whether two
    substituents of a candidate stereocentre are distinguishable."""
    frontier = [(start, exclude)]
    h = 0
    for d in range(depth):
        nxt = []
        level = []
        for a, prev in frontier:
            at = mol.atom(a)
            level.append(_mix(d, ATOMIC_NUM.get(at.symbol, 99),
                              at.charge & 0xff, mol.total_h(a),
                              1 if at.aromatic else 0))
            for b in mol.bonds_of(a):
                o = b.other(a)
                if o != prev:
                    nxt.append((o, a))
        for v in sorted(level):
            h = _mix(h, v)
        frontier = nxt
        if not frontier:
            break
    return h


def num_potential_stereocenters(mol: Mol) -> int:
    """Count sp3 carbons whose four substituents (implicit Hs collapsing to
    one class) are pairwise distinct — the ``includeUnassigned=True``
    potential-stereocentre count used by ``sascorer``."""
    count = 0
    for i, a in enumerate(mol.atoms):
        if a.symbol != 'C' or a.aromatic:
            continue
        if any((b.order != 1 or b.aromatic) for b in mol.bonds_of(i)):
            continue
        heavy = mol.neighbors(i)
        n_h = mol.total_h(i)
        if len(heavy) + n_h != 4 or n_h > 1:
            continue
        hashes = [_branch_hash(mol, nb, i) for nb in heavy]
        if n_h == 1:
            hashes.append(_mix(1))  # the hydrogen class
        if len(set(hashes)) == 4:
            count += 1
    return count


def _ring_topology(mol: Mol):
    """(n_spiro_atoms, n_bridgehead_atoms, n_macrocycles) from the SSSR.

    Spiro: atom that is the *only* shared atom of some ring pair.
    Bridgehead: atom shared by a ring pair whose intersection has ≥3 atoms
    (a bridged, not merely fused, system) and that borders the shared path.
    """
    rings = [set(r) for r in mol.sssr()]
    spiro, bridge = set(), set()
    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            shared = rings[i] & rings[j]
            if len(shared) == 1:
                spiro |= shared
            elif len(shared) >= 3:
                for a in shared:
                    in_i = any(nb in rings[i] - shared for nb in mol.neighbors(a))
                    in_j = any(nb in rings[j] - shared for nb in mol.neighbors(a))
                    if in_i and in_j:
                        bridge.add(a)
    n_macro = sum(1 for r in rings if len(r) > 8)
    return len(spiro), len(bridge - spiro), n_macro


def calculate_sa(mol: Mol, fscores: FragmentScores, radius: int = 2) -> float:
    """SA score in [1, 10] (1 = easy to make), per the published formula
    (sascorer ``calculateScore``)."""
    n_atoms = mol.num_atoms
    if n_atoms == 0:
        return 1.0

    frags = morgan_frag_counts(mol, radius)
    nf = sum(frags.values())
    score1 = sum(fscores.get(fid) * c for fid, c in frags.items()) / max(nf, 1)

    n_chiral = num_potential_stereocenters(mol)
    n_spiro, n_bridge, n_macro = _ring_topology(mol)

    size_penalty = n_atoms ** 1.005 - n_atoms
    stereo_penalty = math.log10(n_chiral + 1)
    spiro_penalty = math.log10(n_spiro + 1)
    bridge_penalty = math.log10(n_bridge + 1)
    macro_penalty = math.log10(2) if n_macro > 0 else 0.0
    score2 = -(size_penalty + stereo_penalty + spiro_penalty +
               bridge_penalty + macro_penalty)

    # fingerprint-density correction (symmetry bonus)
    score3 = 0.0
    if n_atoms > len(frags):
        score3 = math.log(float(n_atoms) / len(frags)) * 0.5

    sascore = score1 + score2 + score3

    # rescale to 1..10 with the published smoothing above 8
    lo, hi = -4.0, 2.5
    sascore = 11.0 - (sascore - lo + 1.0) / (hi - lo) * 9.0
    if sascore > 8.0:
        sascore = 8.0 + math.log(sascore + 1.0 - 9.0)
    return min(10.0, max(1.0, sascore))
