"""Motif-vocabulary extraction CLI (counterpart of
``ggpm_tpu/cli/get_vocab.py``; reference get_vocab.py).

Usage:
    python -m ggpm_tpu_torch.cli.get_vocab --data data.csv|data.txt \\
        [--output vocab.txt] [--min_frequency 100] [--ncpu 1]

A CSV's ``SMILES`` column is read as the JAX CLI reads it with pandas
(``dropna``, then ``drop_duplicates``, then each cell stripped), without
pandas.
"""

from __future__ import annotations

import argparse

from ..data.vocab_extract import build_vocab, write_vocab
from .common import read_csv_columns


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data', type=str, required=True)
    parser.add_argument('--output', type=str, default='vocab.txt')
    parser.add_argument('--min_frequency', type=int, default=100)
    parser.add_argument('--ncpu', type=int, default=1)
    args = parser.parse_args(argv)

    if args.data.endswith('.csv'):
        column = read_csv_columns(args.data)['SMILES']
        data = [s.strip() for s in dict.fromkeys(column) if s is not None]
    elif args.data.endswith('.txt'):
        with open(args.data) as f:
            data = [line.strip() for line in f if line.strip()]
    else:
        raise TypeError('Data files must be csv or txt')

    rows, fragments = build_vocab(data, args.min_frequency, args.ncpu)
    write_vocab(rows, args.output)
    print(f'wrote {len(rows)} vocab rows ({len(fragments)} frequent fragments) '
          f'to {args.output}')


if __name__ == '__main__':
    main()
