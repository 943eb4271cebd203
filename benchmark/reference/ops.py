"""The two graph primitives the reference's models share, in plain
PyTorch (the port's ``ops/graph_ops.py``): every index table pads with 0,
and row 0 of every state is kept at zero, so a padded entry adds
nothing to a neighbour sum."""

from __future__ import annotations

import torch


def nei_sum(h: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """``out[n] = Σ_a h[graph[n, a]]`` for a padded [N, A] table."""
    return h[graph.long()].sum(dim=-2)


def zero_row0(h: torch.Tensor) -> torch.Tensor:
    """``h`` with its padding row zeroed, out of place (JAX
    ``h.at[0].set(0.0)``)."""
    return torch.cat([h.new_zeros((1,) + h.shape[1:]), h[1:]])
