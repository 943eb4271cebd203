"""Model-level convenience API (counterpart of ``ggpm_tpu/models/api.py``;
``reconstruct``, ``sample`` and ``optimize_recs`` arrive with the decode
slice)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_TREE_KEYS = ('fnode', 'fmess', 'agraph', 'bgraph', 'scope')


def _check_tree(tree: Dict[str, np.ndarray]) -> None:
    """Index tables must point inside the tables they index: the gathers
    on the card do not check their indices."""
    n_nodes, n_mess = len(tree['fnode']), len(tree['fmess'])
    bounds = ((tree['agraph'], n_mess), (tree['bgraph'], n_mess),
              (tree['fmess'][:, :2], n_nodes), (tree['scope'][:, 0], n_nodes))
    for table, n in bounds:
        if table.size and (table.min() < 0 or table.max() >= n):
            raise ValueError(f'tree index table out of range [0, {n})')


def tree_to_device(tree: Dict[str, np.ndarray],
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """The tree level of a ``to_model_batch`` dict as tensors on
    ``device``."""
    _check_tree(tree)
    return {k: torch.as_tensor(np.ascontiguousarray(tree[k]), device=device)
            for k in _TREE_KEYS}


@torch.no_grad()
def encode(model, batch: dict, eps: Optional[torch.Tensor] = None):
    """Latent code and KL of a model batch, on the model's device; no noise
    unless ``eps`` is given (reference eval-time convention)."""
    device = next(model.parameters()).device
    return model.encode_latent(tree_to_device(batch['tree'], device), eps)
