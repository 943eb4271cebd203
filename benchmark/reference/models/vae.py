"""The two VAEs the benchmark trains, in plain PyTorch: ``PropertyVAE``
(registry name ``prop``) and ``HierPropertyVAE`` (``hier-prop``), with
their training losses.  A frozen copy of the port's ``models/vae.py`` cut
to what these configurations use: an LSTM cell, embeddings tied between
encoder and decoder, float32 throughout, no attention heads.

Reference: ggpm/property_vae.py (PropertyVAE, HierPropertyVAE).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .decoder import MotifDecoder
from .encoder import HierMPNEncoder, MotifEncoder
from .hier_decoder import HierDecoder


@dataclass
class ModelConfig:
    """The model's sizes.  Any option the port has beyond these (GRU
    cells, untied embeddings, bf16 depth loops, attention) is refused:
    the reference computes only what the benchmark's configurations
    state."""
    hvocab_size: int
    ivocab_size: int
    atom_vocab_size: int = 38
    embed_size: int = 250
    hidden_size: int = 250
    latent_size: int = 24
    depthT: int = 20
    depthG: int = 20
    diterT: int = 1
    diterG: int = 5
    dropout: float = 0.0
    rnn_type: str = 'LSTM'

    def __post_init__(self):
        if self.rnn_type != 'LSTM' or self.dropout != 0.0:
            raise ValueError('the reference computes LSTM models without '
                             'dropout only')


def _rsample(model: nn.Module, z_vecs: torch.Tensor,
             eps: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterised sample with ``z_log_var = −|W_var z|`` (reference
    property_vae.py:92-99) and its KL divided by the batch size; the mean
    where ``eps`` is None."""
    z_mean = model.R_mean(z_vecs)
    z_log_var = -torch.abs(model.R_var(z_vecs))
    kl = -0.5 * torch.sum(1.0 + z_log_var - z_mean * z_mean -
                          torch.exp(z_log_var)) / z_vecs.shape[0]
    if eps is None:
        return z_mean, kl
    return z_mean + torch.exp(z_log_var / 2) * eps, kl


class PropertyVAE(nn.Module):
    """Motif-level VAE (reference property_vae.py:64-127)."""
    is_hier = False

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.E_c = nn.Embedding(cfg.hvocab_size, cfg.embed_size)
        self.E_i = nn.Embedding(cfg.ivocab_size, cfg.embed_size)
        self.encoder = MotifEncoder(self.E_c, self.E_i, cfg.hidden_size,
                                    cfg.depthT)
        self.R_mean = nn.Linear(cfg.hidden_size, cfg.latent_size)
        self.R_var = nn.Linear(cfg.hidden_size, cfg.latent_size)
        self.decoder = MotifDecoder(self.E_c, self.E_i, cfg.hidden_size,
                                    cfg.latent_size, cfg.diterT)

    def forward(self, batch: Dict[str, Any], beta: float,
                eps: Optional[torch.Tensor] = None):
        """``(total, metrics)`` with ``total = decoder loss + beta · KL``
        (reference vae.py:168-182); the latent is perturbed by ``eps``
        where it is given."""
        tree, plan = batch['tree'], batch['plan']
        root = self.encoder(tree)
        z, kl = _rsample(self, root, eps)
        loss, metrics = self.decoder(tree, plan, z, batch['vocab_mask'])
        total = loss + beta * kl
        return total, dict(metrics, Loss=total, KL=kl)


class HierPropertyVAE(nn.Module):
    """Hierarchical (3-level) VAE (reference property_vae.py:11-62)."""
    is_hier = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.E_c = nn.Embedding(cfg.hvocab_size, cfg.embed_size)
        self.E_i = nn.Embedding(cfg.ivocab_size, cfg.embed_size)
        self.encoder = HierMPNEncoder(self.E_c, self.E_i, cfg.hidden_size,
                                      cfg.depthT, cfg.depthG,
                                      cfg.atom_vocab_size)
        self.decoder = HierDecoder(self.E_c, self.E_i, cfg.hidden_size,
                                   cfg.latent_size, cfg.atom_vocab_size,
                                   cfg.diterT, cfg.diterG)
        self.R_mean = nn.Linear(cfg.hidden_size, cfg.latent_size)
        self.R_var = nn.Linear(cfg.hidden_size, cfg.latent_size)

    def forward(self, batch: Dict[str, Any], beta: float,
                eps: Optional[torch.Tensor] = None):
        """``(total, metrics)`` with ``total = decoder loss + beta · KL``
        (JAX vae.py:314-332)."""
        root = self.encoder(batch['tree'], batch['graph'])
        z, kl = _rsample(self, root, eps)
        loss, metrics = self.decoder(batch['tree'], batch['graph'],
                                     batch['plan'], z, batch['vocab_mask'])
        total = loss + beta * kl
        return total, dict(metrics, Loss=total, KL=kl)
