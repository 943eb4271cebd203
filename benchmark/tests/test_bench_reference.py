"""The plain reference against the port's plain path on the CPU, at a small
width, for both families: the same weights, rows and noise give the same
steps.  (The benchmark's runs hold the port on the card to the reference
at full width.)"""

import os

import pytest
import torch

from benchmark import run
from benchmark.reference import steps as ref_steps
from benchmark.yardstick import compare

SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3,
             depthG=3, diterG=2)
STEPS = 2
ROWS = 4


def _port(cfg, vocab_path, family):
    from ggpm_tpu_torch.graph.vocab import load_vocab_file
    from ggpm_tpu_torch.models.vae import (HierPropertyVAE, ModelConfig,
                                           PropertyVAE, init_params)
    vocab = load_vocab_file(vocab_path)
    hv, iv = vocab.size()
    model = {'prop': PropertyVAE, 'hier-prop': HierPropertyVAE}[family](
        ModelConfig(hvocab_size=hv, ivocab_size=iv, **SMALL))
    init_params(model, torch.Generator().manual_seed(3))
    return model, vocab


@pytest.mark.parametrize('config', ['ggpm-motif-prop', 'ggpm-hier-prop'])
def test_reference_steps_are_the_ports(config):
    from ggpm_tpu_torch.data.batching import pad_batch
    from ggpm_tpu_torch.graph.mol_graph import tensorize
    from ggpm_tpu_torch.graph.vocab import common_atom_vocab
    from ggpm_tpu_torch.train.loop import Trainer
    from ggpm_tpu_torch.train.optim import make_optimizer
    cfg = dict(run.load_json(run.HERE, 'configs', config + '.json'), **SMALL)
    model, vocab = _port(cfg, os.path.join(run.ROOT, cfg['vocab']),
                         cfg['model_type'])
    rmodel = ref_steps.FAMILIES[cfg['model_type']](ref_steps.ModelConfig(
        hvocab_size=vocab.size()[0], ivocab_size=vocab.size()[1],
        **{k: cfg[k] for k in ref_steps.SIZES if k in cfg}))
    rmodel.load_state_dict(model.state_dict())
    rvocab = ref_steps.load_vocab_file(os.path.join(run.ROOT, cfg['vocab']))
    rows = ref_steps.read_rows(os.path.join(run.ROOT, 'data/hopv15.csv'),
                               rvocab)
    batches = [rows[i * ROWS:(i + 1) * ROWS] for i in range(STEPS)]

    theta0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer = Trainer(model, make_optimizer(
        lr=cfg['lr'], clip_norm=cfg['clip_norm'],
        anneal_rate=cfg['anneal_rate'], steps_per_epoch=10), vocab.mask,
        beta=cfg['beta'], print_iter=10 ** 9, seed=5, device='cpu')
    losses, grad1 = [], None
    for b in batches:
        db = trainer.device_batch(trainer.host_batch(
            pad_batch(tensorize(b, vocab, common_atom_vocab))))
        metrics, _ = trainer.train_step(db)
        losses.append(float(metrics['Loss']))
        if grad1 is None:
            # the first clipped gradient: Adam's first moment over 1 − b1
            mu = trainer.opt_state.mu / (1 - trainer.optimizer.b1)
            grad1, off = {}, 0
            for k, p in model.named_parameters():
                grad1[k] = mu[off:off + p.numel()].view_as(p).clone()
                off += p.numel()
    program = {'losses': losses, 'grad1': grad1,
               'delta': {k: p.detach() - theta0[k]
                         for k, p in model.named_parameters()}}

    out = ref_steps.run_steps(rmodel, rvocab, cfg, batches,
                              ref_steps.noise_generator(5, 'cpu'), 10)
    reference = {'losses': out['losses'], 'grad1': out['grad1'],
                 'delta': {k: out['params'][k] - theta0[k] for k in theta0}}
    num = compare.training_numbers(program, reference)
    assert num['loss1_gap'] < 1e-5
    assert num['grad_gap'] < 1e-5
    assert num['update_median_gap'] < 1e-4
