"""Property-regression heads and homoscedastic loss weighing (counterpart
of ``ggpm_tpu/models/heads.py``).

Reference: ggpm/property_optimizer.py:5-67 and ggpm/loss_weigh.py:5-23.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class PropertyRegressor(nn.Module):
    """MLP stack ending in a scalar output, with dropout after each hidden
    layer.  Its layers are named ``Dense_0 .. Dense_k`` after the flax
    layers they are bridged from."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 dropout: float = 0.0):
        super().__init__()
        sizes = [input_size, *hidden_sizes, 1]
        self.n_layers = len(sizes) - 1
        self.dropout = dropout
        for k in range(self.n_layers):
            self.add_module(f'Dense_{k}', nn.Linear(sizes[k], sizes[k + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.n_layers):
            x = getattr(self, f'Dense_{k}')(x)
            if k + 1 < self.n_layers:
                x = F.dropout(F.relu(x), self.dropout, self.training)
        return x[..., 0]


def masked_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the rows whose target is finite (NaN marks
    an unlabelled row); 0 when there is none."""
    ok = torch.isfinite(target)
    err = torch.where(ok, pred - torch.where(ok, target, 0.0), 0.0)
    return (err * err).sum() / ok.sum().clamp(min=1)


class PropertyOptimizer(nn.Module):
    """HOMO and LUMO heads over the two halves of the latent code
    (reference property_optimizer.py:5-52)."""

    def __init__(self, homo_size: int, lumo_size: int, hidden_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.homo_linear = PropertyRegressor(homo_size, (hidden_size,),
                                             dropout)
        self.lumo_linear = PropertyRegressor(lumo_size, (hidden_size,),
                                             dropout)

    def predict(self, homo_vecs, lumo_vecs) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.homo_linear(homo_vecs), self.lumo_linear(lumo_vecs)

    def forward(self, homo_vecs, lumo_vecs, targets):
        """(HOMO loss, LUMO loss, HOMO out, LUMO out): each loss the mean
        squared error over the labelled rows of ``targets`` (homos,
        lumos)."""
        homo_out, lumo_out = self.predict(homo_vecs, lumo_vecs)
        homo_t, lumo_t = targets
        return (masked_mse(homo_out, homo_t), masked_mse(lumo_out, lumo_t),
                homo_out, lumo_out)


class LossWeigh(nn.Module):
    """Learned homoscedastic-uncertainty loss scaling (reference
    loss_weigh.py:5-23): ``loss·exp(−s) + s`` per task, each ``s`` a
    ``(1,)`` parameter starting at zero."""

    def __init__(self):
        super().__init__()
        self.homo_log_var = nn.Parameter(torch.zeros(1))
        self.lumo_log_var = nn.Parameter(torch.zeros(1))
        self.recon_log_var = nn.Parameter(torch.zeros(1))

    @staticmethod
    def _weigh(loss, s):
        return loss * torch.exp(-s)[0] + s[0]

    def forward(self, loss, homo_loss, lumo_loss):
        return (self._weigh(loss, self.recon_log_var),
                self._weigh(homo_loss, self.homo_log_var),
                self._weigh(lumo_loss, self.lumo_log_var))
