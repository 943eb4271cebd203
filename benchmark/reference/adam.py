"""Adam with global-norm clipping and a per-epoch learning-rate decay, as
optax's chain ``clip_by_global_norm``, ``scale_by_adam``,
``scale_by_learning_rate(exponential_decay(staircase=True))`` computes
it, over a list of plain tensors (the port's ``train/optim.py`` keeps
one flat buffer; the arithmetic is the same)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


def clip(grads: List[torch.Tensor], clip_norm: float):
    """The gradients' global norm and the gradients scaled to at most
    ``clip_norm`` in it."""
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.where(gnorm < clip_norm, torch.ones_like(gnorm),
                        clip_norm / gnorm)
    return gnorm, [g * scale for g in grads]


class Adam:
    """The optimizer's state over ``params`` (tensors updated in place),
    from nought, or from ``state`` (the moments ``mu`` and ``nu``, a
    tensor a parameter, and the ``count`` of updates made)."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 clip_norm: float, anneal_rate: float, steps_per_epoch: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 state: Optional[Dict] = None):
        self.params = params
        self.lr, self.clip_norm = lr, clip_norm
        self.anneal_rate, self.steps_per_epoch = anneal_rate, steps_per_epoch
        self.b1, self.b2, self.eps = b1, b2, eps
        if state is None:
            state = {'mu': [torch.zeros_like(p) for p in params],
                     'nu': [torch.zeros_like(p) for p in params], 'count': 0}
        self.mu = [m.clone() for m in state['mu']]
        self.nu = [v.clone() for v in state['nu']]
        self.count = state['count']

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> Dict[str, object]:
        """One update from ``grads``; returns the gradient's global norm
        before clipping and the clipped gradients the moments took."""
        gnorm, clipped = clip(grads, self.clip_norm)
        self.apply(clipped)
        return {'gnorm': gnorm, 'grads': clipped}

    @torch.no_grad()
    def apply(self, clipped: List[torch.Tensor]) -> None:
        """The moments and the parameters moved by clipped gradients."""
        self.count += 1
        lr = self.lr * self.anneal_rate ** ((self.count - 1)
                                            // self.steps_per_epoch)
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, clipped, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))
