"""Checkpoint save/load and weight transfer between param trees
(counterpart of ``ggpm_tpu/train/checkpoint.py``).

A param tree is the JAX package's layout as nested dicts of numpy arrays
(``bridge.to_flax_tree`` of a model; ``bridge.load_flax_params`` puts one
back).  ``save_params`` writes it in flax's msgpack format, the bytes that
``flax.serialization.to_bytes`` writes, so each package loads the other's
checkpoints.  The orbax path is not ported.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..bridge import flatten, msgpack_serialize, read_checkpoint


def save_params(params: Mapping, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        f.write(msgpack_serialize(params))


def _restore(template: Mapping, state: Mapping, path: str) -> Dict[str, Any]:
    missing = set(map(str, template)) - set(state)
    if missing:
        raise ValueError(f'checkpoint has no {sorted(missing)} at '
                         f'/{path}')
    return {k: _restore(v, state[str(k)], f'{path}{k}/')
            if isinstance(v, Mapping) else np.asarray(state[str(k)])
            for k, v in template.items()}


def load_params(template: Mapping, path: str) -> Dict[str, Any]:
    """The checkpoint at ``path`` in ``template``'s structure (flax
    ``from_bytes``: every key of the template must be in the file)."""
    return _restore(template, read_checkpoint(path), '')


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *mods, leaf = key.split('/')
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return out


def copy_matching(target: Mapping, source: Mapping,
                  prefix_map: Optional[Dict[str, str]] = None
                  ) -> Tuple[Dict[str, Any], int]:
    """Copy source leaves into the target wherever the (possibly remapped)
    path exists with the same shape (reference nnutils.py:13-62).
    ``prefix_map`` maps target path prefixes to source prefixes
    (``{'params/vae/': 'params/'}``).  Returns the new tree and the count
    copied."""
    sflat = flatten(source)
    out, copied = {}, 0
    for key, tval in flatten(target).items():
        candidates = [key]
        for tp, sp in (prefix_map or {}).items():
            candidates.append(sp + key[len(tp):] if key.startswith(tp)
                              else tp + key)
        sval = next((sflat[c] for c in candidates if c in sflat and
                     np.shape(sflat[c]) == np.shape(tval)), None)
        if sval is not None:
            copied += 1
        out[key] = tval if sval is None else sval
    return _unflatten(out), copied


def copy_encoder(target: Mapping, source: Mapping
                 ) -> Tuple[Dict[str, Any], int]:
    """Encoder-only transfer (reference ``copy_encoder``,
    nnutils.py:45-62): every leaf whose path contains 'encoder' and
    matches in shape, trying the ``vae/`` and ``hier/`` nestings."""
    sflat = flatten(source)
    out, copied = {}, 0
    for key, tval in flatten(target).items():
        v = None
        if 'encoder' in key:
            for cand in (key, key.replace('vae/', '', 1),
                         key.replace('hier/', '', 1),
                         key.replace('params/', 'params/vae/', 1),
                         key.replace('params/', 'params/hier/', 1)):
                v = sflat.get(cand)
                if v is not None:
                    break
        if v is not None and np.shape(v) == np.shape(tval):
            out[key] = v
            copied += 1
        else:
            out[key] = tval
    return _unflatten(out), copied


class EarlyStopping:
    """Patience-based early stopping with best-checkpoint saving (the
    ``torchtools`` interface of the reference fine-tune drivers)."""

    def __init__(self, patience: int = 7, verbose: bool = False,
                 delta: float = 0.0, path: str = 'model.best'):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.path = path
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = float('inf')

    def __call__(self, val_loss: float, params: Mapping) -> None:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            self._save(val_loss, params)
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.verbose:
                print(f'EarlyStopping counter: {self.counter} / '
                      f'{self.patience}')
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self._save(val_loss, params)
            self.counter = 0

    def _save(self, val_loss: float, params: Mapping) -> None:
        if self.verbose:
            print(f'Validation loss decreased ({self.val_loss_min:.6f} -> '
                  f'{val_loss:.6f}). Saving model to {self.path}')
        save_params(params, self.path)
        self.val_loss_min = val_loss
