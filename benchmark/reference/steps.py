"""The reference's training steps: a model built from a configuration
file and its checkpoint, batches tensorized from the rows anew, and Adam
steps on them with the latent noise drawn from the run's seed.

``load_model`` builds what a configuration names, ``read_rows`` the
rows of a data file; ``run_steps`` takes steps on given rows and returns
each step's loss, the clipped gradient of the first step and the
parameters after the last, by leaf name.  ``precision`` 'tf32' lets
float32 products run in TF32 (the control); ``keep`` < 1 leaves the last
part of each batch out (a fault: the loss is then the mean over the
molecules kept).  ``follow`` takes single steps from another run's state
(its parameters and moments before a step), as the reference of that
run's later steps.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .adam import Adam, clip
from .checkpoint import load_params, read_checkpoint, subtree
from .data.batching import pad_batch, to_model_batch
from .data.rows import prune_to_vocab, read_csv_data
from .graph.mol_graph import tensorize
from .graph.vocab import PairVocab, common_atom_vocab, load_vocab_file
from .models.vae import HierPropertyVAE, ModelConfig, PropertyVAE

FAMILIES = {'prop': PropertyVAE, 'hier-prop': HierPropertyVAE}
SIZES = ('embed_size', 'hidden_size', 'latent_size', 'depthT', 'depthG',
         'diterT', 'diterG', 'atom_vocab_size', 'dropout', 'rnn_type')


def load_model(config: Dict, root: str
               ) -> Tuple[torch.nn.Module, PairVocab]:
    """The configuration's model (on the CPU, its checkpoint loaded) and
    its vocab, paths taken from ``root``."""
    if config.get('tie_embedding', True) is not True or \
            config.get('use_attention', False) or \
            config.get('compute_dtype', 'float32') != 'float32':
        raise ValueError('the reference computes tied, float32 models '
                         'without attention')
    vocab = load_vocab_file(os.path.join(root, config['vocab']))
    hv, iv = vocab.size()
    cfg = ModelConfig(hvocab_size=hv, ivocab_size=iv,
                      **{k: config[k] for k in SIZES if k in config})
    model = FAMILIES[config['model_type']](cfg)
    load_params(model, subtree(read_checkpoint(
        os.path.join(root, config['checkpoint'])),
        config.get('checkpoint_subtree', '')))
    return model, vocab


def read_rows(path: str, vocab: PairVocab) -> List[list]:
    """The in-vocab (SMILES, HOMO, LUMO) rows of a CSV file."""
    return prune_to_vocab(read_csv_data(path), vocab)


def batch_rows(rows: Sequence, batch_size: int, index: int) -> List:
    """The rows of batch ``index`` (batches of ``batch_size`` in file
    order)."""
    return list(rows[index * batch_size:(index + 1) * batch_size])


def device_batch(rows: Sequence, vocab: PairVocab, device,
                 pad: bool = True) -> Dict:
    """``rows`` tensorized (padded to their bucket unless ``pad`` is
    False), as tensors on ``device``."""
    mb = tensorize(rows, vocab, common_atom_vocab)
    host = to_model_batch(pad_batch(mb) if pad else mb, vocab.mask,
                          pad=False)

    def up(d):
        return {k: up(v) if isinstance(v, dict) else
                torch.as_tensor(np.ascontiguousarray(v), device=device)
                for k, v in d.items()}
    return up(host)


def noise_generator(seed: int, device) -> torch.Generator:
    """The generator of the steps' latent noise: seeded with the run's
    noise seed on the run's device, drawn ``[B, latent]`` a step."""
    return torch.Generator(device=device).manual_seed(seed)


@contextlib.contextmanager
def _precision(precision: str):
    """float32 products in float32 ('float32') or in TF32 ('tf32')."""
    if precision not in ('float32', 'tf32'):
        raise ValueError(f'precision {precision!r}')
    tf32 = precision == 'tf32'
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _loss_and_grads(model, params, vocab, config, rows, eps):
    batch = device_batch(rows, vocab, params[0].device)
    total, _ = model(batch, config['beta'],
                     eps if config.get('perturb_z', True) else None)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return total, [torch.zeros_like(p) if g is None else g
                   for g, p in zip(grads, params)]


def _cpu(tensors, names) -> Dict[str, torch.Tensor]:
    return {k: t.detach().to('cpu', copy=True) for k, t in zip(names, tensors)}


def run_steps(model: torch.nn.Module, vocab: PairVocab, config: Dict,
              step_rows: Sequence[Sequence], gen: torch.Generator,
              steps_per_epoch: int, precision: str = 'float32',
              keep: float = 1.0, trail: bool = False) -> Dict:
    """Adam steps from the model's state, one a batch of ``step_rows``
    (each tensorized and padded here, on the model's device); returns
    ``losses`` (a float a step), ``grad1`` (leaf name -> the clipped
    gradient of step 1) and ``params`` (leaf name -> the parameters after
    the last step), and with ``trail`` a record a step of what ``follow``
    and the comparison of later steps read (on the CPU: ``theta``,
    ``mu``, ``nu`` before the step, its clipped ``grad``, ``loss`` and
    ``delta``).  The model is updated in place."""
    names, params = zip(*model.named_parameters())
    device = params[0].device
    opt = Adam([p.data for p in params], config['lr'], config['clip_norm'],
               config['anneal_rate'], steps_per_epoch)
    losses, grad1, steps = [], None, []
    with _precision(precision):
        for rows in step_rows:
            eps = torch.randn((len(rows), config['latent_size']),
                              generator=gen, device=device)
            if keep < 1.0:
                n = max(1, int(len(rows) * keep))
                rows, eps = rows[:n], eps[:n]
            before = trail and {'theta': _cpu(params, names),
                                'mu': _cpu(opt.mu, names),
                                'nu': _cpu(opt.nu, names)}
            total, grads = _loss_and_grads(model, params, vocab, config,
                                           rows, eps)
            out = opt.step(grads)
            losses.append(float(total.detach()))
            if grad1 is None:
                grad1 = dict(zip(names, out['grads']))
            if trail:
                after = _cpu(params, names)
                steps.append(dict(before, loss=losses[-1],
                                  grad=_cpu(out['grads'], names),
                                  delta={k: after[k] - before['theta'][k]
                                         for k in names}))
    out = {'losses': losses, 'grad1': grad1,
           'params': {k: p.detach().clone() for k, p in zip(names, params)}}
    if trail:
        out['trail'] = steps
    return out


def follow(model: torch.nn.Module, vocab: PairVocab, config: Dict,
           checks: Sequence[Dict], gen: torch.Generator,
           steps_per_epoch: int) -> List[Dict]:
    """The reference of another run's later steps, each from that run's
    own state before it.  A check holds ``step`` (its index in the run,
    from 1), ``rows``, and the run's ``theta``, ``mu``, ``nu`` before the
    step and ``grad``, the clipped gradient its moments took (leaf name
    -> tensor, any shape of the leaf's size).  Returns a dict a check:
    ``loss`` and ``grad`` (clipped) of the reference's forward and
    backward at ``theta`` on the step's rows, with the step's noise (the
    run's draws from ``gen``, one ``[batch_size, latent]`` a step), and
    ``delta``, Adam's move from that state with the run's ``grad``, in
    float32 on the CPU.  The model's parameters are overwritten."""
    names, params = zip(*model.named_parameters())
    device = params[0].device
    eps = [torch.randn((config['batch_size'], config['latent_size']),
                       generator=gen, device=device)
           for _ in range(max((c['step'] for c in checks), default=0))]
    out = []
    with _precision('float32'):
        for c in checks:
            with torch.no_grad():
                for k, p in zip(names, params):
                    p.copy_(c['theta'][k].view_as(p))
            total, grads = _loss_and_grads(model, params, vocab, config,
                                           c['rows'], eps[c['step'] - 1])
            _, clipped = clip(grads, config['clip_norm'])
            theta = [c['theta'][k].detach().to('cpu', torch.float32,
                                                copy=True) for k in names]
            opt = Adam(theta, config['lr'], config['clip_norm'],
                       config['anneal_rate'], steps_per_epoch,
                       state={'mu': [c['mu'][k].cpu() for k in names],
                              'nu': [c['nu'][k].cpu() for k in names],
                              'count': c['step'] - 1})
            opt.apply([c['grad'][k].cpu() for k in names])
            out.append({'loss': float(total.detach()),
                        'grad': _cpu(clipped, names),
                        'delta': {k: t - c['theta'][k].cpu()
                                  for k, t in zip(names, theta)}})
    return out
