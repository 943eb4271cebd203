"""Preprocessing CLI: tensorize and pickle padded training shards
(counterpart of ``ggpm_tpu/cli/preprocess.py``; reference preprocess.py).

Usage:
    python -m ggpm_tpu_torch.cli.preprocess --train data.csv \\
        --vocab vocab.txt [--out-dir train_processed] [--batch_size 20] \\
        [--batches-per-shard 1000] [--ncpu 8] [--seed 1]

The shards equal the JAX CLI's array for array; ``vae_train`` reads them
from the config's ``data`` folder.
"""

from __future__ import annotations

import argparse

from ..data.vocab_extract import preprocess_to_shards
from ..graph.vocab import common_atom_vocab, load_vocab_file
from .common import read_csv_data


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--train', required=True, help='CSV of SMILES,HOMO,LUMO')
    parser.add_argument('--vocab', required=True)
    parser.add_argument('--out-dir', default='train_processed')
    parser.add_argument('--batch_size', type=int, default=20)
    parser.add_argument('--batches-per-shard', type=int, default=1000)
    parser.add_argument('--ncpu', type=int, default=8)
    parser.add_argument('--seed', type=int, default=1)
    args = parser.parse_args(argv)

    vocab = load_vocab_file(args.vocab)
    data = read_csv_data(args.train)
    n = preprocess_to_shards(data, vocab, common_atom_vocab, args.out_dir,
                             batch_size=args.batch_size,
                             batches_per_shard=args.batches_per_shard,
                             ncpu=args.ncpu, seed=args.seed)
    print(f'wrote {n} batches to {args.out_dir}')


if __name__ == '__main__':
    main()
