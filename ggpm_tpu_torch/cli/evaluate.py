"""Evaluation CLI: MOSES-style metrics over a reconstruction CSV
(counterpart of ``ggpm_tpu/cli/evaluate.py``; reference evaluate.py +
evaluation/metrics.py).

Usage:
    python -m ggpm_tpu_torch.cli.evaluate --reconstructions recon.csv \\
        [--k K] [--fcd-ckpt chemnet.npz] [--device cpu]

The CSV is read without pandas: an empty cell, or one of pandas' NA
strings, is a missing value, as ``pd.isna`` made it.  ChemNet (with
``--fcd-ckpt``) runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json

from ..chem import canon_smiles
from ..eval.metrics import Metrics
from .common import read_csv_columns


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--reconstructions', required=True,
                        help='CSV with original/reconstructed columns')
    parser.add_argument('--k', type=int, default=None)
    parser.add_argument('--fcd-ckpt', default=None,
                        help='ChemNet checkpoint (eval.chemnet format); '
                             'enables real FCD')
    parser.add_argument('--device', default='cuda',
                        help='torch device ChemNet runs on (default: cuda)')
    args = parser.parse_args(argv)

    columns = read_csv_columns(args.reconstructions)
    gen = columns['reconstructed']
    ref = [x for x in columns['original'] if x is not None]

    metrics = Metrics(fcd_ckpt=args.fcd_ckpt,
                      device=args.device).get_recon_n_sample_metrics(
        gen, ref, args.k)
    # exact-reconstruction rate
    matches = sum(1 for o, d in zip(columns['original'], gen)
                  if o is not None and d and canon_smiles(o) == canon_smiles(d))
    metrics['recon_accuracy'] = matches / max(len(gen), 1)
    print(json.dumps(metrics, indent=2, default=float))
    return metrics


if __name__ == '__main__':
    main()
