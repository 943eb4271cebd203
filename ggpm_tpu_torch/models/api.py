"""Model-level convenience API (counterpart of ``ggpm_tpu/models/api.py``:
``encode``, ``reconstruct`` and ``sample``; ``optimize_recs`` arrives with
latent search)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.batching import to_model_batch
from ..graph.vocab import PairVocab, common_atom_vocab
from .decode import decode_best, sample_prior

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


def reconstruct(model, mb, vocab: PairVocab, avocab=common_atom_vocab,
                greedy: bool = True, max_decode_step: int = 150, **kwargs):
    """Encode without noise, then decode (reference ``reconstruct``).
    Returns (property_outputs_or_None, (results, smiles))."""
    z, _ = encode(model, to_model_batch(mb, vocab.mask, pad=False))
    props = None
    if hasattr(model, 'predict_properties'):
        with torch.no_grad():
            props = tuple(p.cpu().numpy() for p in model.predict_properties(z))
    out = decode_best(model, vocab, avocab, z, greedy=greedy,
                      max_decode_step=max_decode_step, **kwargs)
    return props, out


def sample(model, vocab: PairVocab, batch_size: int,
           avocab=common_atom_vocab, seed: int = 0, **kwargs):
    """Sample from the prior (reference ``sample``)."""
    return sample_prior(model, vocab, avocab, batch_size,
                        rng=np.random.default_rng(seed), **kwargs)
