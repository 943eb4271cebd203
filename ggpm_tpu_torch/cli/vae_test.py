"""Train-and-periodically-reconstruct harness (counterpart of
``ggpm_tpu/cli/vae_test.py``; reference vae_test.py:89-136): trains on
the config's ``data`` CSV and, every ``--recon-every`` epochs,
reconstructs the first ``--recon-count`` molecules of ``test_data``
(else ``data``) greedily, printing ``org <SMILES> dec <SMILES>`` pairs.

Usage:
    python -m ggpm_tpu_torch.cli.vae_test --path-to-config configs.json \\
        [--model-type prop] [--recon-every 1] [--recon-count 20] \\
        [--device cpu]

The model starts from ``init_params`` seeded with the config's ``seed``
(default 1); batches of ``batch_size`` (short ones dropped) are padded to
their bucket shapes.  Runs on the card (``cuda``) unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse

from ..configs import Configs
from ..data.batching import pad_batch, to_model_batch
from ..data.dataset import MoleculeDataset, prune_to_vocab
from ..graph.mol_graph import tensorize
from ..graph.vocab import common_atom_vocab
from ..models.api import encode
from ..models.decode import decode_best
from ..train.loop import Trainer
from ..train.optim import make_optimizer
from .common import read_csv_data, setup_model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--path-to-config', required=True)
    parser.add_argument('--model-type', default='prop')
    parser.add_argument('--recon-every', type=int, default=1)
    parser.add_argument('--recon-count', type=int, default=20)
    parser.add_argument('--device', default='cuda',
                        help='torch device to run on (default: cuda)')
    args = parser.parse_args(argv)

    configs = Configs(path=args.path_to_config)
    model, vocab, _ = setup_model(configs, args.model_type,
                                  seed=configs.get('seed', 1))
    batch_size = configs.get('batch_size', 20)

    train_data = prune_to_vocab(read_csv_data(configs.get('data')), vocab)
    test_data = read_csv_data(configs.get('test_data') or configs.get('data'))
    test_ds = MoleculeDataset(test_data[:args.recon_count], vocab,
                              common_atom_vocab, batch_size)

    batches = [pad_batch(tensorize(train_data[i:i + batch_size], vocab,
                                   common_atom_vocab))
               for i in range(0, len(train_data) - batch_size + 1, batch_size)]
    optimizer = make_optimizer(lr=configs.get('lr', 1e-3),
                               clip_norm=configs.get('clip_norm', 20.0),
                               anneal_rate=configs.get('anneal_rate', 0.9),
                               steps_per_epoch=len(batches))
    trainer = Trainer(model, optimizer, vocab.mask,
                      beta=configs.get('beta', 0.1),
                      print_iter=configs.get('print_iter', 50),
                      seed=configs.get('seed', 1), device=args.device)

    for epoch in range(configs.get('epoch', 20)):
        trainer.train_epoch(batches, epoch)
        if (epoch + 1) % args.recon_every == 0:
            trainer.model.eval()
            for i in range(len(test_ds)):
                mb = test_ds[i]
                z, _ = encode(trainer.model,
                              to_model_batch(mb, vocab.mask, pad=False))
                _, smiles = decode_best(trainer.model, vocab,
                                        common_atom_vocab, z, greedy=True,
                                        max_decode_step=150, log_steps=False)
                for org, dec in zip(mb.smiles, smiles):
                    print(f'org {org} dec {dec}')
    return trainer.model


if __name__ == '__main__':
    main()
