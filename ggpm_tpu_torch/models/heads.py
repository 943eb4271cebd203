"""Property-regression heads (counterpart of ``ggpm_tpu/models/heads.py``,
prediction only; the property losses arrive with prop-opt training).

Reference: ggpm/property_optimizer.py:5-67.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class PropertyRegressor(nn.Module):
    """MLP stack ending in a scalar output.  Its layers are named
    ``Dense_0 .. Dense_k`` after the flax layers they are bridged from."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int]):
        super().__init__()
        sizes = [input_size, *hidden_sizes, 1]
        self.n_layers = len(sizes) - 1
        for k in range(self.n_layers):
            self.add_module(f'Dense_{k}', nn.Linear(sizes[k], sizes[k + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.n_layers):
            x = getattr(self, f'Dense_{k}')(x)
            if k + 1 < self.n_layers:
                x = F.relu(x)
        return x[..., 0]


class PropertyOptimizer(nn.Module):
    """HOMO and LUMO heads over the two halves of the latent code
    (reference property_optimizer.py:5-52)."""

    def __init__(self, homo_size: int, lumo_size: int, hidden_size: int):
        super().__init__()
        self.homo_linear = PropertyRegressor(homo_size, (hidden_size,))
        self.lumo_linear = PropertyRegressor(lumo_size, (hidden_size,))

    def predict(self, homo_vecs, lumo_vecs) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.homo_linear(homo_vecs), self.lumo_linear(lumo_vecs)
