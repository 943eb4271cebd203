"""Shared CLI plumbing: config → vocab → model (counterpart of
``ggpm_tpu/cli/common.py``).  The port trains, fine-tunes and serves every
model of the JAX registry: ``prop``, ``prop-opt``, ``hier-prop``,
``hier-prop-opt`` and ``prop-opt-sched``."""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..bridge import load_flax_params, prop_tree, read_checkpoint, to_flax_tree
from ..configs import Configs
from ..data.dataset import read_csv_data
from ..graph.vocab import PairVocab, load_vocab_file
from ..models.vae import (HierPropertyVAE, HierPropOptVAE, ModelConfig,
                          PropertyVAE, PropOptSchedulingVAE, PropOptVAE,
                          init_params)
from ..train import checkpoint as ckpt

__all__ = ['load_checkpoint', 'maybe_load_pretrained', 'read_csv_columns',
           'read_csv_data', 'setup_model', 'write_csv']

# the strings ``pandas.read_csv`` reads as missing by default
NA_STRINGS = frozenset([
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'])

# the JAX registry (ggpm_tpu/models/vae.py:OPVNet)
MODELS = {'prop': PropertyVAE, 'prop-opt': PropOptVAE,
          'hier-prop': HierPropertyVAE, 'hier-prop-opt': HierPropOptVAE,
          'prop-opt-sched': PropOptSchedulingVAE}


def setup_model(configs: Configs, model_type: str, seed: int = 1
                ) -> Tuple[Union[PropertyVAE, PropOptVAE, HierPropertyVAE,
                                 HierPropOptVAE, PropOptSchedulingVAE],
                           PairVocab, ModelConfig]:
    """Load the vocab and build the model, initialised as flax initialises
    the JAX package's from a generator seeded with ``seed``; returns
    (model, vocab, config) on the CPU."""
    if model_type not in MODELS:
        raise ValueError(f'Model {model_type} does not exist '
                         f'(have: {sorted(MODELS)})')
    vocab = load_vocab_file(configs.vocab_)
    mcfg = ModelConfig.from_configs(configs, vocab)
    model = MODELS[model_type](mcfg)
    init_params(model, torch.Generator().manual_seed(seed))
    return model, vocab, mcfg


def maybe_load_pretrained(model, configs: Configs) -> bool:
    """The reference's pretrain → fine-tune weight transfer (vae_train.py:
    40-53): load the ``saved_model`` checkpoint (a ``prop`` tree, or the
    ``vae/`` subtree of a prop-opt one) and copy the matching encoder (or
    all) weights into ``model``, a ``prop`` model or the ``vae/`` of a
    ``prop-opt`` one (whose heads keep their weights).  Returns whether a
    checkpoint was found."""
    saved = getattr(configs, 'saved_model', None)
    if not saved or not os.path.exists(saved):
        return False
    source = prop_tree(read_checkpoint(saved))
    target = to_flax_tree(model)
    if getattr(configs, 'load_encoder_only', False):
        tree, n = ckpt.copy_encoder(target, source)
        print(f'Successfully copied encoder weights ({n} tensors).')
    else:
        tree, n = ckpt.copy_matching(target, source,
                                     prefix_map={'params/vae/': 'params/'})
        print(f'Successfully copied encoder-decoder weights ({n} tensors).')
    load_flax_params(model, tree)
    return True


def load_checkpoint(model, configs: Configs) -> str:
    """Load the ``output_model`` (else ``saved_model``) checkpoint of the
    config into ``model``, every parameter of the model from the file (the
    JAX CLIs' ``ckpt.load_params`` into the model's template); returns its
    path."""
    path = configs.get('output_model') or configs.get('saved_model')
    load_flax_params(model, ckpt.load_params(to_flax_tree(model), path))
    return path


def read_csv_columns(path: str) -> Dict[str, List]:
    """The columns of a CSV with a header, as ``pandas.read_csv`` reads a
    column of strings: each cell as written, None where pandas reads a
    missing value (``NA_STRINGS``)."""
    with open(path, newline='') as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return {name: [None if j >= len(r) or r[j] in NA_STRINGS else r[j]
                   for r in rows]
            for j, name in enumerate(header)}


def _cell(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ''
    return repr(v) if isinstance(v, float) else str(v)


def write_csv(path: str, rows: List[Dict],
              columns: Optional[List[str]] = None) -> None:
    """Write ``rows`` (dicts with the same keys, in column order) as
    ``pandas.DataFrame(rows).to_csv(path, index=False)`` writes them: a
    header, floats in their shortest round-trip form, None and NaN as
    empty cells, minimal quoting, ``\\n`` line ends.  ``columns`` names
    the header of an empty table."""
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        if rows or columns:
            w.writerow(list(rows[0]) if rows else columns)
        w.writerows([_cell(v) for v in r.values()] for r in rows)
