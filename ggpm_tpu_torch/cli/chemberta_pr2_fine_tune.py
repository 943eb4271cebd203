"""ChemBERTa property-regression baseline CLI (counterpart of
``ggpm_tpu/cli/chemberta_pr2_fine_tune.py``; reference
chemberta_pr2_fine_tune.py).

Usage:
    python -m ggpm_tpu_torch.cli.chemberta_pr2_fine_tune \\
        --path-to-config configs.json [--epochs 10] [--batch-size 16] \\
        [--pretrained-dir DIR] [--device cpu]

Reads the config's ``data`` and ``val_data`` (or ``test_data``) CSVs,
``lr``, ``anneal_rate``, ``early_stop_patience``, ``pretrained_dir`` and
``save_dir``, as the JAX CLI does, trains on the card (``cuda``) unless
``--device`` says otherwise, and writes ``save_dir/chemberta.params.pkl``
and ``chemberta.tokenizer.json`` in the JAX package's format.
"""

from __future__ import annotations

import argparse
import os

from ..configs import Configs
from ..models.chemberta import save_chemberta, train_chemberta
from .common import read_csv_data

PROPERTY_MAP = {'homo': 'HOMO', 'lumo': 'LUMO'}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--path-to-config', required=True)
    parser.add_argument('--homo-col', default='homo')
    parser.add_argument('--lumo-col', default='lumo')
    parser.add_argument('--epochs', type=int, default=10)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--pretrained-dir', default=None,
                        help='local checkpoint dir (native save_chemberta '
                             'output or a HF Flax RoBERTa flax_model.msgpack)')
    parser.add_argument('--device', default='cuda',
                        help='torch device to train on (default: cuda)')
    args = parser.parse_args(argv)

    configs = Configs(path=args.path_to_config)
    train_data = read_csv_data(configs.get('data'))
    val_path = configs.get('val_data') or configs.get('test_data')
    val_data = read_csv_data(val_path) if val_path else []

    model, tok = train_chemberta(
        train_data, val_data,
        epochs=args.epochs, batch_size=args.batch_size,
        lr=configs.get('lr', 1e-4),
        anneal_rate=configs.get('anneal_rate', 0.9),
        patience=configs.get('early_stop_patience', 5),
        pretrained_dir=args.pretrained_dir or configs.get('pretrained_dir'),
        device=args.device)
    out_prefix = configs.get('save_dir')
    if out_prefix:
        os.makedirs(out_prefix, exist_ok=True)
        save_chemberta(os.path.join(out_prefix, 'chemberta'), model, tok)
    print('done')
    return model, tok


if __name__ == '__main__':
    main()
