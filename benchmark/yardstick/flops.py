"""The model FLOPs of a training step, from the reference's forward on
the batch's own molecules, unpadded: each matrix product it dispatches
counts its own FLOPs (``torch.utils.flop_counter``'s formulas) once for
the forward and once more for each of its two matrices that needs a
gradient, the product the backward makes for that gradient.  Element-wise
work and gathers count nothing.  So the count is the work the inputs
need, whatever implements it: a program that pads does more than this,
and a program that stops padding does not change it.  It is a little
above what ``FlopCounterMode`` counts over the forward and the backward
(a product whose output reaches no loss has no backward; the test holds
the two within 1 %), without running the backward.  The counts of a
cell's batches are kept in the checkout (``batch_flops``): they depend on
nothing a run draws from its seed."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..reference.steps import device_batch

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(os.path.dirname(HERE), 'reference')
# the positions of each product's two matrices among its arguments
MATRICES = {torch.ops.aten.mm: (0, 1), torch.ops.aten.bmm: (0, 1),
            torch.ops.aten.addmm: (1, 2), torch.ops.aten.baddbmm: (1, 2)}


class _Products(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            if packet not in MATRICES:
                raise ValueError(f'no backward count for {packet}')
            grads = sum(bool(args[i].requires_grad) for i in MATRICES[packet])
            self.flops += (1 + grads) * flop_registry[packet](
                *args, **kwargs, out_val=out)
        return out


def step_flops(model: torch.nn.Module, vocab, config: Dict,
               rows: Sequence) -> int:
    """FLOPs of one training step's forward and backward on ``rows``
    (the latent at its mean: the noise adds no product)."""
    batch = device_batch(rows, vocab, next(model.parameters()).device,
                         pad=False)
    with torch.enable_grad(), _Products() as counter:
        model(batch, config['beta'])
    return int(counter.flops)


def _key(config: Dict, batches: Sequence[Sequence]) -> str:
    """What a count depends on: the configuration, the batches' rows, the
    reference's sources and this file's, and PyTorch's version (its FLOP
    formulas)."""
    h = hashlib.sha256(json.dumps([config, [list(map(list, b))
                                            for b in batches],
                                   torch.__version__],
                                  sort_keys=True, default=str).encode())
    sources = [os.path.join(d, f) for d, _, files in os.walk(REFERENCE)
               for f in files if f.endswith('.py')]
    for path in sorted(sources) + [os.path.abspath(__file__)]:
        with open(path, 'rb') as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def batch_flops(model: torch.nn.Module, vocab, config: Dict,
                batches: Sequence[Sequence], cache: str) -> List[int]:
    """``step_flops`` of each batch of rows, kept in ``cache`` (a fixed
    directory in the checkout) under what the counts depend on, so that
    only a checkout's first traced run of a cell counts them."""
    path = os.path.join(cache, f'flops-{_key(config, batches)}.json')
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    counts = [step_flops(model, vocab, config, b) for b in batches]
    os.makedirs(cache, exist_ok=True)
    with open(path + '.tmp', 'w') as f:
        json.dump(counts, f)
    os.replace(path + '.tmp', path)
    return counts
