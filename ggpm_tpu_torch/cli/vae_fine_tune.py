"""Property fine-tuning CLI with early stopping and the negative-loss
circuit breaker (counterpart of ``ggpm_tpu/cli/vae_fine_tune.py``;
reference vae_fine_tune.py).

Usage:
    python -m ggpm_tpu_torch.cli.vae_fine_tune --path-to-config configs.json \\
        [--model-type prop-opt] [--indv-opt] [--device cpu]

Reads the JAX CLI's config keys: the training CSV (``data``) and the
validation CSV (``val_data``, else ``test_data``), tensorized in batches of
``batch_size`` (short batches dropped) and padded to their bucket shapes;
``saved_model`` (a ``prop`` or ``prop-opt`` checkpoint) copied in by
``maybe_load_pretrained``.  ``--model-type hier-prop-opt`` fine-tunes the
hier family (its total leaves β·KL out, as the JAX package's does).  ``--indv-opt`` gives the encoder, decoder and
HOMO and LUMO heads their own Adam (``encoder_lr``, ``decoder_lr``,
``homo_lr``, ``lumo_lr``, each defaulting to ``lr``).  It validates every
``eval_iter`` steps (default: once an epoch) with early stopping on the
validation loss (``model.best``), stops when the circuit breaker trips,
and writes ``model.<epoch>`` after each epoch.  It trains on the card
(``cuda``) unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os

from ..bridge import to_flax_tree
from ..configs import Configs
from ..data.batching import pad_batch
from ..data.dataset import prune_to_vocab
from ..graph.mol_graph import tensorize
from ..graph.vocab import common_atom_vocab
from ..train import checkpoint as ckpt
from ..train.loop import Trainer
from ..train.optim import (default_group_fn, make_multi_optimizer,
                           make_optimizer)
from .common import maybe_load_pretrained, read_csv_data, setup_model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--path-to-config', required=True)
    parser.add_argument('--model-type', default=None,
                        help='defaults to configs.model_finetune_type or '
                             'prop-opt')
    parser.add_argument('--indv-opt', action='store_true',
                        help='per-subnetwork optimizers (encoder/decoder/'
                             'homo/lumo)')
    parser.add_argument('--device', default='cuda',
                        help='torch device to train on (default: cuda)')
    args = parser.parse_args(argv)

    configs = Configs(path=args.path_to_config)
    model_type = args.model_type or configs.get('model_finetune_type',
                                                'prop-opt')
    model, vocab, _ = setup_model(configs, model_type,
                                  seed=configs.get('seed', 1))
    configs.to_json(os.path.join(configs.save_dir, 'configs.json'))

    batch_size = configs.get('batch_size', 20)
    train_data = prune_to_vocab(read_csv_data(configs.get('data')), vocab)
    val_path = configs.get('val_data') or configs.get('test_data')
    val_data = prune_to_vocab(read_csv_data(val_path), vocab) \
        if val_path else []

    def to_batches(data):
        batches = [data[i:i + batch_size]
                   for i in range(0, len(data), batch_size)]
        return [pad_batch(tensorize(b, vocab, common_atom_vocab))
                for b in batches if len(b) == batch_size]

    train_batches = to_batches(train_data)
    val_batches = to_batches(val_data)
    steps_per_epoch = max(len(train_batches), 1)
    opt_kw = dict(clip_norm=configs.get('clip_norm', 20.0),
                  anneal_rate=configs.get('anneal_rate', 0.9),
                  steps_per_epoch=steps_per_epoch)
    lr = configs.get('lr', 1e-3)
    if args.indv_opt:
        optimizer = make_multi_optimizer(default_group_fn, {
            g: configs.get(f'{g}_lr', lr)
            for g in ('encoder', 'decoder', 'homo', 'lumo')}, **opt_kw)
    else:
        optimizer = make_optimizer(lr=lr, **opt_kw)

    trainer = Trainer(model, optimizer, vocab.mask,
                      beta=configs.get('beta', 0.1),
                      print_iter=configs.get('print_iter', 50),
                      save_dir=configs.save_dir,
                      save_iter=configs.get('save_iter', -1),
                      clip_break_count=configs.get('clip_break_count', 5),
                      seed=configs.get('seed', 1), device=args.device)
    maybe_load_pretrained(trainer.model, configs)

    early = ckpt.EarlyStopping(
        patience=configs.get('early_stop_patience', 5), verbose=True,
        path=os.path.join(configs.save_dir, 'model.best'))
    # in-epoch validation cadence (reference vae_fine_tune.py:121-148
    # validates every eval_iter steps); default: once an epoch
    eval_iter = configs.get('eval_iter', None) or len(train_batches)
    chunks = [train_batches[i:i + eval_iter]
              for i in range(0, len(train_batches), eval_iter)]

    for epoch in range(configs.get('epoch', 20)):
        for chunk in chunks:
            if trainer.train_epoch(chunk, epoch):
                print('Negative-loss circuit breaker tripped; stopping.')
                return trainer.model
            if val_batches:
                val = trainer.evaluate(val_batches)
                print(f'[epoch {epoch} step {trainer.total_step}] val ' +
                      ', '.join(f'{k}: {v:.3f}'
                                for k, v in sorted(val.items())))
                early(val['Loss'], to_flax_tree(trainer.model))
                if early.early_stop:
                    print('Early stopping.')
                    return trainer.model
        ckpt.save_params(to_flax_tree(trainer.model),
                         os.path.join(configs.save_dir, f'model.{epoch}'))
    return trainer.model


if __name__ == '__main__':
    main()
