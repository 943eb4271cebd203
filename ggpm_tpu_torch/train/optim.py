"""Adam with exponential learning-rate decay and global-norm clipping, as
the JAX package's optax chain computes it (counterpart of
``ggpm_tpu/train/optim.py:make_optimizer``; the per-subnetwork optimizer,
``make_multi_optimizer``, is ROADMAP A4).

The chain is ``clip_by_global_norm(clip_norm)``, ``scale_by_adam()`` (b1
0.9, b2 0.999, eps 1e-8, eps_root 0) and ``scale_by_learning_rate(lr ·
anneal_rate ^ (count // steps_per_epoch))``, where ``count`` is the number
of updates made before this one, as optax counts.  optax clips by
``g / ‖g‖ · clip_norm`` when ``‖g‖ >= clip_norm`` (``clip_grad_norm_``
divides by ``‖g‖ + 1e-6`` instead).

``Adam.attach`` moves a model's parameters into one flat buffer, each
parameter a view of it, so that an update is a handful of elementwise
kernels over one vector (optax's ``flatten`` does the same for the JAX
package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch


@dataclass
class Adam:
    """The optimizer's hyperparameters (``make_optimizer``); ``attach``
    gives the state that ``step`` updates."""
    lr: float = 1e-3
    clip_norm: float = 20.0
    anneal_rate: float = 0.9
    steps_per_epoch: int = 1000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates, in
        float32 as optax computes it."""
        epoch = count // max(self.steps_per_epoch, 1)
        rate = torch.tensor(self.anneal_rate, dtype=torch.float32) ** epoch
        return float(self.lr * rate)

    def attach(self, params: Sequence[torch.nn.Parameter]) -> 'AdamState':
        """Put ``params`` (distinct, one device, float32) into one flat
        buffer and return the zero state over it.  The parameters stay
        where the model holds them, each now a view of the buffer."""
        params = list(params)
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        offset = 0
        for p in params:
            n = p.numel()
            p.data = flat[offset:offset + n].view_as(p)
            offset += n
        return AdamState(self, params, flat, torch.zeros_like(flat),
                         torch.zeros_like(flat))


class AdamState:
    """The flat parameters and moments of one optimizer run."""

    def __init__(self, opt: Adam, params: List[torch.nn.Parameter],
                 flat: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor):
        self.opt = opt
        self.params = params
        self.flat = flat
        self.mu = mu
        self.nu = nu
        self.count = 0

    def flat_grad(self) -> torch.Tensor:
        """The parameters' gradients as one vector (zeros where a
        parameter got none)."""
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
            for p in self.params])

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the gradients'
        global norm (before clipping) as a device scalar, without a host
        sync."""
        o = self.opt
        g = self.flat_grad()
        # summed in float64: a float32 sum over ~2M entries on the CPU is
        # off by 2e-4 relative; optax's per-leaf sums are not
        gnorm = torch.linalg.vector_norm(g, dtype=torch.float64).float()
        # optax: select(‖g‖ < max, g, g / ‖g‖ · max), without a host sync
        keep = gnorm < o.clip_norm
        g = g / torch.where(keep, torch.ones_like(gnorm), gnorm) * \
            torch.where(keep, torch.ones_like(gnorm), torch.full_like(
                gnorm, o.clip_norm))
        self.mu.mul_(o.b1).add_(g, alpha=1 - o.b1)
        self.nu.mul_(o.b2).addcmul_(g, g, value=1 - o.b2)
        self.count += 1
        bc1 = float(1 - torch.tensor(o.b1, dtype=torch.float32) ** self.count)
        bc2 = float(1 - torch.tensor(o.b2, dtype=torch.float32) ** self.count)
        upd = (self.mu / bc1) / ((self.nu / bc2).sqrt_() + o.eps)
        self.flat.add_(upd, alpha=-o.schedule(self.count - 1))
        return gnorm


def make_optimizer(lr: float = 1e-3, clip_norm: float = 20.0,
                   anneal_rate: float = 0.9,
                   steps_per_epoch: int = 1000) -> Adam:
    """Adam + exponential decay + global-norm clip (JAX
    ``make_optimizer``)."""
    return Adam(lr=lr, clip_norm=clip_norm, anneal_rate=anneal_rate,
                steps_per_epoch=steps_per_epoch)
