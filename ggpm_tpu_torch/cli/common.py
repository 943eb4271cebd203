"""Shared CLI plumbing: config → vocab → model (counterpart of
``ggpm_tpu/cli/common.py`` for the ``prop`` model)."""

from __future__ import annotations

import os
from typing import Tuple

import torch

from ..bridge import load_flax_params, prop_tree, read_checkpoint, to_flax_tree
from ..configs import Configs
from ..data.dataset import read_csv_data
from ..graph.vocab import PairVocab, load_vocab_file
from ..models.vae import ModelConfig, PropertyVAE, init_params
from ..train import checkpoint as ckpt

__all__ = ['maybe_load_pretrained', 'read_csv_data', 'setup_model']

# model types of the JAX registry (ggpm_tpu/models/vae.py:OPVNet) that the
# port does not train yet, and the ROADMAP item that brings each
NOT_PORTED = {'prop-opt': 'A4', 'prop-opt-sched': 'A4', 'hier-prop': 'A5',
              'hier-prop-opt': 'A5'}


def setup_model(configs: Configs, model_type: str, seed: int = 1
                ) -> Tuple[PropertyVAE, PairVocab, ModelConfig]:
    """Load the vocab and build the model, initialised as flax initialises
    the JAX package's from a generator seeded with ``seed``; returns
    (model, vocab, config) on the CPU."""
    if model_type != 'prop':
        item = NOT_PORTED.get(model_type)
        if item is None:
            raise ValueError(f'Model {model_type} does not exist')
        raise NotImplementedError(
            f'model type {model_type!r}: the port trains the prop model '
            f'only so far; {model_type} is ROADMAP {item}')
    vocab = load_vocab_file(configs.vocab_)
    mcfg = ModelConfig.from_configs(configs, vocab)
    model = PropertyVAE(mcfg)
    init_params(model, torch.Generator().manual_seed(seed))
    return model, vocab, mcfg


def maybe_load_pretrained(model: PropertyVAE, configs: Configs) -> bool:
    """The reference's pretrain → fine-tune weight transfer (vae_train.py:
    40-53): load the ``saved_model`` checkpoint (a ``prop`` tree, or the
    ``vae/`` subtree of a prop-opt one) and copy the matching encoder (or
    all) weights into ``model``.  Returns whether a checkpoint was found."""
    saved = getattr(configs, 'saved_model', None)
    if not saved or not os.path.exists(saved):
        return False
    source = prop_tree(read_checkpoint(saved))
    target = to_flax_tree(model)
    if getattr(configs, 'load_encoder_only', False):
        tree, n = ckpt.copy_encoder(target, source)
        print(f'Successfully copied encoder weights ({n} tensors).')
    else:
        tree, n = ckpt.copy_matching(target, source)
        print(f'Successfully copied encoder-decoder weights ({n} tensors).')
    load_flax_params(model, tree)
    return True
