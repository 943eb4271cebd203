"""Pretraining driver (counterpart of ``ggpm_tpu/cli/vae_train.py``;
reference vae_train.py) for the ``prop`` and ``hier-prop`` models (and
the others of the registry the port has).

Usage:
    python -m ggpm_tpu_torch.cli.vae_train --path-to-config configs.json \\
        --model-type prop|hier-prop [--data-csv data.csv] [--device cpu]

With ``--data-csv`` it tensorizes the CSV in batches of ``batch_size`` (the
last, short batch is dropped) and pads each to its bucket shape; without
it, it streams the preprocessed pickle shards of the config's ``data``
folder (``DataFolder``: the port's ``preprocess`` writes them, and it reads
the JAX package's too), a shard's batches in a new random order each
epoch, and anneals the learning rate every 1000 steps, as the JAX CLI
does.  It trains on the card (``cuda``) unless ``--device`` says otherwise,
and reads the JAX CLI's config keys.
"""

from __future__ import annotations

import argparse
import os

from ..bridge import load_flax_params, prop_tree, read_checkpoint, to_flax_tree
from ..configs import Configs
from ..data.batching import pad_batch
from ..data.dataset import DataFolder, prune_to_vocab
from ..graph.mol_graph import tensorize
from ..graph.vocab import common_atom_vocab
from ..train import checkpoint as ckpt
from ..train.loop import Trainer
from ..train.optim import make_optimizer
from .common import maybe_load_pretrained, read_csv_data, setup_model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--path-to-config', required=True)
    parser.add_argument('--model-type', required=True)
    parser.add_argument('--data-csv', default=None,
                        help='tensorize this CSV instead of reading the '
                             'config\'s preprocessed shards (data)')
    parser.add_argument('--n-devices', type=int, default=1,
                        help='data-parallel devices: 1 only (ROADMAP A7)')
    parser.add_argument('--tp', type=int, default=1,
                        help='model-axis extent: 1 only (ROADMAP A7)')
    parser.add_argument('--device', default='cuda',
                        help='torch device to train on (default: cuda)')
    args = parser.parse_args(argv)
    if args.n_devices > 1 or args.tp > 1:
        raise NotImplementedError(
            'data- and tensor-parallel training (--n-devices, --tp above 1) '
            'is ROADMAP A7; the port trains on one device')

    configs = Configs(path=args.path_to_config)
    if not args.data_csv and not configs.get('data'):
        raise ValueError('no training data: give --data-csv or the config\'s '
                         'data folder of preprocessed shards')
    model, vocab, mcfg = setup_model(configs, args.model_type,
                                     seed=configs.get('seed', 1))
    configs.to_json(os.path.join(configs.save_dir, 'configs.json'))
    batch_size = configs.get('batch_size', 20)
    if args.data_csv:
        data = prune_to_vocab(read_csv_data(args.data_csv), vocab)
        rows = [data[i:i + batch_size]
                for i in range(0, len(data), batch_size)]
        rows = [b for b in rows if len(b) == batch_size]
        if not rows:
            raise ValueError(f'{args.data_csv}: no full batch of '
                             f'{batch_size} in-vocab molecules')
        steps_per_epoch = len(rows)

        def data_epoch():
            for b in rows:
                yield pad_batch(tensorize(b, vocab, common_atom_vocab))
    else:
        steps_per_epoch = 1000      # the JAX CLI's, for shards

        def data_epoch():
            yield from DataFolder(configs.data, batch_size)

    optimizer = make_optimizer(
        lr=configs.get('lr', 1e-3), clip_norm=configs.get('clip_norm', 20.0),
        anneal_rate=configs.get('anneal_rate', 0.9),
        steps_per_epoch=steps_per_epoch)
    trainer = Trainer(model, optimizer, vocab.mask,
                      beta=configs.get('beta', 0.1),
                      print_iter=configs.get('print_iter', 50),
                      save_dir=configs.save_dir,
                      save_iter=configs.get('save_iter', -1),
                      seed=configs.get('seed', 1), device=args.device)
    maybe_load_pretrained(trainer.model, configs)

    load_epoch = configs.get('load_epoch', -1)
    if load_epoch >= 0:
        load_flax_params(trainer.model, prop_tree(read_checkpoint(
            os.path.join(configs.save_dir, f'model.{load_epoch}'))))

    n_params = sum(p.numel() for p in trainer.model.parameters())
    print('Model #Params: %dK' % (n_params / 1000,))

    for epoch in range(load_epoch + 1, configs.get('epoch', 20)):
        stop = trainer.train_epoch(data_epoch(), epoch)
        if configs.get('save_iter', -1) == -1:
            ckpt.save_params(to_flax_tree(trainer.model),
                             os.path.join(configs.save_dir, f'model.{epoch}'))
        if stop:
            break
    return trainer.model


if __name__ == '__main__':
    main()
