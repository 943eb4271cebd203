"""Vocabulary merge CLI (counterpart of ``ggpm_tpu/cli/merge_vocab.py``;
reference merge_vocab.py).

Usage:
    python -m ggpm_tpu_torch.cli.merge_vocab --vocabs a.txt b.txt \\
        [--output merged_vocab.txt]
"""

from __future__ import annotations

import argparse

from ..data.vocab_extract import merge_vocabs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--vocabs', nargs='+', required=True)
    parser.add_argument('--output', default='merged_vocab.txt')
    args = parser.parse_args(argv)
    lines = merge_vocabs(args.vocabs)
    with open(args.output, 'w') as f:
        f.write('\n'.join(lines))
    print(f'wrote {len(lines)} lines to {args.output}')


if __name__ == '__main__':
    main()
