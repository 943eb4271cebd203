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

Data-parallel: ``--n-devices N`` spawns N ranks on this host, one a card
(NCCL; ``--device cpu``: N gloo processes), each reading every batch and
stepping on its own one of each group of N (``--tp T``: a N/T × T grid
with the vocab-sized leaves split over T).  ``--dist-coordinator``,
``--dist-nprocs`` and ``--dist-pid`` (or the ``GGPM_*`` variables) make
this process one rank of several, started by the caller, each reading a
disjoint input shard; with TP that is refused, as in the JAX package.
Several ranks on one card need gloo: ``parallel.distributed.
init_distributed(..., backend='gloo')``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.multiprocessing as mp

from ..bridge import load_flax_params, prop_tree, read_checkpoint, to_flax_tree
from ..configs import Configs
from ..data.batching import pad_batch
from ..data.dataset import DataFolder, prune_to_vocab
from ..graph.mol_graph import tensorize
from ..graph.vocab import common_atom_vocab
from ..parallel.distributed import (init_distributed, make_global_mesh,
                                    process_count)
from ..parallel.mesh import make_mesh, make_mesh_2d
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
    parser.add_argument('--n-devices', type=int, default=0,
                        help='data-parallel training over n ranks, one a '
                             'device (0 = every visible card if more than '
                             'one; 1 = one device).  On one host it spawns '
                             'the ranks: one a card (NCCL), or n gloo '
                             'processes with --device cpu.  Each optimizer '
                             'step takes n batches, the gradient '
                             'all-reduced')
    parser.add_argument('--dist-coordinator', default=None,
                        help='several processes: the rendezvous, host:port '
                             'or a URL (or env GGPM_COORDINATOR); one '
                             'process a device, each reading a disjoint '
                             'data shard')
    parser.add_argument('--dist-nprocs', type=int, default=None,
                        help='several processes: their count '
                             '(or env GGPM_NUM_PROCESSES)')
    parser.add_argument('--dist-pid', type=int, default=None,
                        help='several processes: this one\'s index '
                             '(or env GGPM_PROCESS_ID)')
    parser.add_argument('--tp', type=int, default=1,
                        help='model-axis extent: with --tp T > 1 the ranks '
                             'form a (n/T data × T model) grid and the '
                             'vocab-sized parameters (motif/attachment '
                             'embeddings, cls/icls heads) and their Adam '
                             'moments are split over the model axis')
    parser.add_argument('--device', default='cuda',
                        help='torch device to train on (default: cuda)')
    args = parser.parse_args(argv)

    proc_id = init_distributed(args.dist_coordinator, args.dist_nprocs,
                               args.dist_pid, device=args.device)
    n_proc = process_count()
    if n_proc > 1:
        # several processes, each with its own input: one rank a process
        if args.device == 'cuda':
            args.device = f'cuda:{proc_id % torch.cuda.device_count()}'
        return train(args, proc_id, proc_id, n_proc,
                     make_global_mesh(args.tp))
    n_dev = args.n_devices
    if n_dev <= 0:
        n_dev = (torch.cuda.device_count()
                 if torch.device(args.device).type == 'cuda' else 1)
    if n_dev > 1:
        if n_dev % args.tp:
            raise ValueError(f'{n_dev} devices do not split into tp '
                             f'{args.tp}')
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_rank_main, args=(
                args, n_dev, f'file://{tmp}/rendezvous'), nprocs=n_dev,
                start_method='spawn')
        return None
    if args.tp > 1:
        raise ValueError('--tp above 1 needs several devices (--n-devices)')
    return train(args, 0, 0, 1, None)


def _rank_main(rank: int, args, world: int, url: str) -> None:
    """Rank ``rank`` of ``world`` ranks spawned on one host, each on its
    own card (or the CPU), all reading the same batches."""
    device = args.device
    if device == 'cpu':
        torch.set_num_threads(1)
    if torch.device(device).type == 'cuda':
        device = f'cuda:{rank}'
        torch.cuda.set_device(device)
    init_distributed(url, world, rank, device=device)
    try:
        mesh = (make_mesh_2d(world // args.tp, args.tp) if args.tp > 1
                else make_mesh(world))
        if rank == 0:
            print(f'data-parallel over {world} ranks '
                  f'({torch.distributed.get_backend()}, dp={mesh.dp} × '
                  f'tp={mesh.tp})', flush=True)
        args.device = device
        train(args, rank, 0, 1, mesh)
    finally:
        torch.distributed.destroy_process_group()


def train(args, rank: int, proc_id: int, n_proc: int, mesh):
    """The training run of one process: rank ``rank``, reading the input
    shard ``proc_id`` of ``n_proc`` (all of it where ``n_proc`` is 1);
    only rank 0 prints and saves."""
    configs = Configs(path=args.path_to_config)
    if not args.data_csv and not configs.get('data'):
        raise ValueError('no training data: give --data-csv or the config\'s '
                         'data folder of preprocessed shards')
    model, vocab, mcfg = setup_model(configs, args.model_type,
                                     seed=configs.get('seed', 1))
    if rank == 0:
        configs.to_json(os.path.join(configs.save_dir, 'configs.json'))
    batch_size = configs.get('batch_size', 20)
    if args.data_csv:
        data = prune_to_vocab(read_csv_data(args.data_csv), vocab,
                              verbose=rank == 0)
        rows = [data[i:i + batch_size]
                for i in range(0, len(data), batch_size)][proc_id::n_proc]
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
            yield from DataFolder(configs.data, batch_size,
                                  num_shards=n_proc, shard_index=proc_id)

    # weights are loaded before the Trainer: on a dp×tp mesh it splits
    # them over the model group
    maybe_load_pretrained(model, configs)
    load_epoch = configs.get('load_epoch', -1)
    if load_epoch >= 0:
        load_flax_params(model, prop_tree(read_checkpoint(
            os.path.join(configs.save_dir, f'model.{load_epoch}'))))
    n_params = sum(p.numel() for p in model.parameters())
    if rank == 0:
        print('Model #Params: %dK' % (n_params / 1000,))
    optimizer = make_optimizer(
        lr=configs.get('lr', 1e-3), clip_norm=configs.get('clip_norm', 20.0),
        anneal_rate=configs.get('anneal_rate', 0.9),
        steps_per_epoch=steps_per_epoch)
    trainer = Trainer(model, optimizer, vocab.mask,
                      beta=configs.get('beta', 0.1),
                      print_iter=(configs.get('print_iter', 50)
                                  if rank == 0 else 10 ** 9),
                      save_dir=configs.save_dir if rank == 0 else None,
                      save_iter=configs.get('save_iter', -1),
                      seed=configs.get('seed', 1), device=args.device,
                      mesh=mesh, tp_min_dim=configs.get('tp_min_dim', 256))

    for epoch in range(load_epoch + 1, configs.get('epoch', 20)):
        stop = trainer.train_epoch(data_epoch(), epoch)
        if configs.get('save_iter', -1) == -1:
            with trainer.gathered():
                if rank == 0:
                    path = os.path.join(configs.save_dir, f'model.{epoch}')
                    ckpt.save_params(to_flax_tree(trainer.model), path)
                    print(f'saved {path}', flush=True)
        if stop:
            break
    return trainer.model


if __name__ == '__main__':
    main()
