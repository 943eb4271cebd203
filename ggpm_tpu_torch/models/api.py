"""Model-level convenience API (counterpart of ``ggpm_tpu/models/api.py``:
``encode``, ``reconstruct``, ``sample`` and ``optimize_recs``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.batching import to_model_batch
from ..graph.vocab import PairVocab, common_atom_vocab
from .decode import decode_best, is_hier, sample_prior

_TREE_KEYS = ('fnode', 'fmess', 'agraph', 'bgraph', 'scope')


def _check_tree(tree: Dict[str, np.ndarray], n_atoms: int = 0) -> None:
    """Index tables must point inside the tables they index: the gathers
    on the card do not check their indices.  ``n_atoms``: the atom count
    that a tree's ``cgraph`` indexes."""
    n_nodes, n_mess = len(tree['fnode']), len(tree['fmess'])
    bounds = [(tree['agraph'], n_mess), (tree['bgraph'], n_mess),
              (tree['fmess'][:, :2], n_nodes), (tree['scope'][:, 0], n_nodes)]
    if n_atoms:
        bounds.append((tree['cgraph'], n_atoms))
    for table, n in bounds:
        if table.size and (table.min() < 0 or table.max() >= n):
            raise ValueError(f'tree index table out of range [0, {n})')


def tree_to_device(tree: Dict[str, np.ndarray], device: torch.device,
                   keys=_TREE_KEYS, n_atoms: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """The ``keys`` of a level of a ``to_model_batch`` dict (the tree
    level's by default) as tensors on ``device``."""
    _check_tree(tree, n_atoms)
    return {k: torch.as_tensor(np.ascontiguousarray(tree[k]), device=device)
            for k in keys}


@torch.no_grad()
def encode(model, batch: dict, eps: Optional[torch.Tensor] = None):
    """Latent code and KL of a model batch, on the model's device; no noise
    unless ``eps`` is given (reference eval-time convention).  The hier
    family also reads the atom level, ``batch['graph']``, and the tree's
    cluster table ``cgraph`` (JAX ``api.encode``)."""
    device = next(model.parameters()).device
    if not is_hier(model):
        return model.encode_latent(tree_to_device(batch['tree'], device),
                                   eps)
    graph = tree_to_device(batch['graph'], device)
    tree = tree_to_device(batch['tree'], device, _TREE_KEYS + ('cgraph',),
                          n_atoms=len(batch['graph']['fnode']))
    return model.encode_latent(tree, eps, graph=graph)


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


def optimize_recs(model, mb, vocab: PairVocab, avocab=common_atom_vocab,
                  optimize_type: str = 'hard', **opt_kwargs):
    """Latent property optimisation, then decode (reference
    ``optimize_recs``): encode ``mb`` without noise, search its latents
    against its own HOMO/LUMO labels (``LatentOptimizer``), predict the
    properties at the searched latents and decode them greedily through
    ``decode_best``.  Returns ((homo, lumo) as numpy, (results,
    smiles))."""
    from ..latent.control import LatentOptimizer
    z, _ = encode(model, to_model_batch(mb, vocab.mask, pad=False))
    opt = LatentOptimizer(model, optimize_type=optimize_type, **opt_kwargs)
    z_opt = opt.optimize(z, mb.homos, mb.lumos)
    with torch.no_grad():
        props = tuple(p.cpu().numpy() for p in model.predict_properties(z_opt))
    out = decode_best(model, vocab, avocab, z_opt, greedy=True,
                      max_decode_step=150)
    return props, out
