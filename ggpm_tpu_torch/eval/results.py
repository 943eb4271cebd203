"""Result post-processing helpers (counterpart of
``ggpm_tpu/eval/results.py``, without pandas).

Reference: the notebook-style scripts under Result/ (rec_result.py,
gen_result.py, vocab_process.py) — parsing result CSVs, checking
reconstruction validity, and summarising the motif vocabulary (thesis
Table 4.2 statistics: motif count, mean motif size).  Molecule PNG
rendering is out of scope (no depiction backend offline).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..chem import canon_smiles, get_mol
from ..cli.common import read_csv_columns, write_csv


def split_result_column(path: str, column: str = 'result',
                        out_path: Optional[str] = None
                        ) -> Dict[str, List[Optional[str]]]:
    """Split a combined "original [reconstruction]" result column into two
    (reference Result/rec_result.py); returns the columns ``original`` and
    ``reconstruction`` as lists (a missing cell reads as ``'nan'``, as
    pandas' ``str(nan)``), and writes them as a CSV to ``out_path``."""
    ori, rec = [], []
    for line in read_csv_columns(path)[column]:
        s = ('nan' if line is None else line).split('[')
        ori.append(s[0].strip(' '))
        rec.append(s[1].strip("]'") if len(s) > 1 else None)
    out = {'original': ori, 'reconstruction': rec}
    if out_path:
        write_csv(out_path, [dict(original=o, reconstruction=r)
                             for o, r in zip(ori, rec)], columns=list(out))
    return out


def validity_report(smiles_list: List[Optional[str]]) -> Dict[str, object]:
    """Which generated SMILES fail to parse (reference Result scripts'
    manual loop)."""
    bad = [i for i, s in enumerate(smiles_list)
           if not s or get_mol(s) is None]
    return {'total': len(smiles_list), 'invalid': len(bad),
            'invalid_indices': bad,
            'validity': 1.0 - len(bad) / max(len(smiles_list), 1)}


def reconstruction_accuracy(originals: List[str],
                            reconstructions: List[Optional[str]]) -> float:
    ok = 0
    for o, r in zip(originals, reconstructions):
        if o and r and canon_smiles(o) == canon_smiles(r):
            ok += 1
    return ok / max(len(originals), 1)


def vocab_stats(vocab_path: str) -> Dict[str, float]:
    """Motif vocabulary statistics (thesis Table 4.2; reference
    Result/vocab_process.py): motif count, mean±std motif size in atoms,
    mean attachments per motif."""
    motifs = {}
    with open(vocab_path) as f:
        for line in f:
            parts = line.strip('\r\n ').split()
            if len(parts) < 2:
                continue
            smiles, ismiles = parts[0], parts[1]
            motifs.setdefault(smiles, set()).add(ismiles)
    sizes = []
    att_counts = []
    for smiles, isset in motifs.items():
        m = get_mol(smiles)
        if m is not None:
            sizes.append(m.num_atoms)
        att_counts.append(len(isset))
    return {
        'num_motifs': len(motifs),
        'mean_motif_size': float(np.mean(sizes)) if sizes else 0.0,
        'std_motif_size': float(np.std(sizes)) if sizes else 0.0,
        'mean_attachments': float(np.mean(att_counts)) if att_counts else 0.0,
        'std_attachments': float(np.std(att_counts)) if att_counts else 0.0,
    }
