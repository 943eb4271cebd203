"""The ChemBERTa baseline's training steps against the JAX package's, for
chip_smoke.py phase 16 and tests/test_torch_chemberta.py.

The default width (hidden 384, 6 heads, 6 layers, MLP 1536, max_len 256,
head (256,)) at dropout 0 on ``data/hopv15.csv`` in batches of 16, from
the port's flax-style init seeded with ``SEED`` (bridged into the JAX
model for the golden), with ``train_chemberta``'s optimizer (clip 1.0,
Adam, continuous decay over an epoch of 21 batches at lr 1e-4).
``goldens/chemberta_hopv.json`` (written by tests/test_torch_chemberta.py)
holds JAX's first ``STEPS`` steps: per step the loss and the four metrics
on the params before it, and per leaf the update along the gradient
(``profile_train.update_norms``) and the gradient's norm.
``check_golden`` holds the port's ``golden_steps`` to it: the loss and
metrics within 1e-5 relative at step 1 and 1e-4 after, each leaf's update
within 1e-3 relative at step 1 (every leaf whose gradient is not rounding
noise) and after it for the leaves whose gradient is at least 1e-2 of the
whole gradient's norm.  ``throughput`` times training steps at dropout
0.1 with ``train.profiling.Throughput``.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from . import profile_train
from .bridge import chemberta_to_flax, flatten
from .data.dataset import read_csv_data
from .models.chemberta import (ChemBertaForPR2, SmilesTokenizer, batches,
                               optimizer, to_device)
from .models.vae import init_params
from .train.profiling import Throughput

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, 'ggpm_tpu_torch', 'goldens',
                      'chemberta_hopv.json')
DATA = os.path.join(_ROOT, 'data', 'hopv15.csv')
BATCH = 16
STEPS = 3
SEED = 0
LR = 1e-4
ANNEAL = 0.9
METRICS = ('loss', 'homo_mae', 'homo_mse', 'lumo_mae', 'lumo_mse')
FIRST_RTOL = 1e-5
RTOL = 1e-4
UPDATE_RTOL = 1e-3
STRONG = 1e-2


def setup(device: str, dropout: float = 0.0, **model_kwargs
          ) -> Tuple[ChemBertaForPR2, SmilesTokenizer, list]:
    """The model (seeded init), its tokenizer and the batches of 16 of
    every HOPV row, as ``train_chemberta`` makes them."""
    rows = read_csv_data(DATA)
    tok = SmilesTokenizer.build([r[0] for r in rows])
    model = ChemBertaForPR2(vocab_size=tok.vocab_size, dropout=dropout,
                            **model_kwargs)
    init_params(model, torch.Generator().manual_seed(SEED))
    return model.to(device), tok, batches(rows, tok, BATCH)


def golden_steps(device: str, **model_kwargs) -> List[dict]:
    """The port's first ``STEPS`` steps at dropout 0: per step the loss
    and metrics and per leaf the update along the gradient."""
    model, _, train_b = setup(device, **model_kwargs)
    state = optimizer(LR, ANNEAL, len(train_b)).attach(
        list(model.parameters()))
    model.train()
    steps = []
    for b in train_b[:STEPS]:
        before = flatten(chemberta_to_flax(model))
        for p in state.params:
            p.grad = None
        loss, metrics = model(*to_device(b, device))
        loss.backward()
        state.step()
        grads = flatten(chemberta_to_flax(model, lambda p: p.grad))
        steps.append(dict(
            loss=loss.item(), **{k: v.item() for k, v in metrics.items()},
            update_norms=profile_train.update_norms(
                before, flatten(chemberta_to_flax(model)), grads)))
    return steps


def check_golden(steps: List[dict], golden: dict) -> List[str]:
    """Where ``steps`` break the rule above against ``golden``."""
    bad = []
    if len(steps) != len(golden['steps']):
        return [f'{len(steps)} steps, the golden has {len(golden["steps"])}']
    for i, (got, want) in enumerate(zip(steps, golden['steps'])):
        rtol = FIRST_RTOL if i == 0 else RTOL
        for k in METRICS:
            if not abs(got[k] - want[k]) <= rtol * abs(want[k]):
                bad.append(f'step {i + 1} {k}: {got[k]} vs {want[k]}')
        total = float(np.sqrt(sum(v * v for v in want['grad_norms'].values())))
        for leaf, w in want['update_norms'].items():
            g = got['update_norms'].get(leaf, 'missing')
            if i == 0 and (g is None) != (w is None):
                bad.append(f'step {i + 1} update of {leaf}: {g} vs {w}')
            held = w is not None and (
                i == 0 or want['grad_norms'][leaf] >= STRONG * total)
            if held and not (g is not None and
                             abs(g - w) <= UPDATE_RTOL * abs(w)):
                bad.append(f'step {i + 1} update of {leaf}: {g} vs {w}')
    return bad


def throughput(device: str, steps: int = 20) -> dict:
    """Training steps/s and molecules/s at dropout 0.1 over ``steps``
    steps after one untimed step (``Throughput``, timed to the device's
    end)."""
    model, _, train_b = setup(device, dropout=0.1)
    state = optimizer(LR, ANNEAL, len(train_b)).attach(
        list(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(SEED)
    model.train()
    meter = Throughput(device=device)

    def step(b):
        for p in state.params:
            p.grad = None
        loss, _ = model(*to_device(b, device), generator=gen)
        loss.backward()
        state.step()
    step(train_b[0])
    meter.reset()
    for i in range(steps):
        b = train_b[i % len(train_b)]
        step(b)
        meter.update(len(b[0]))
    return dict(steps=steps, batch=BATCH, **meter.rates())
