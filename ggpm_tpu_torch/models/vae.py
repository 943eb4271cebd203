"""The motif VAE with property heads, as far as encoding, property
prediction and decoding need it (counterpart of ``ggpm_tpu/models/vae.py``:
``ModelConfig``, ``PropertyVAE``, ``PropOptVAE``; the training forward comes
with the training slice).

Reference: ggpm/property_vae.py (PropertyVAE, PropOptVAE).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .decoder import MotifDecoder
from .encoder import MotifEncoder
from .heads import PropertyOptimizer


@dataclass
class ModelConfig:
    """The fields of ``ggpm_tpu.models.vae.ModelConfig`` that encoding,
    property prediction and decoding read.  The defaults are the trained HOPV prop-opt
    model's (scripts/quality_run.py); the encoder is the LSTM one, with
    embeddings tied between encoder and decoder, at dropout 0."""
    hvocab_size: int
    ivocab_size: int
    embed_size: int = 250
    hidden_size: int = 250
    latent_size: int = 24
    linear_hidden_size: int = 128
    depthT: int = 20
    diterT: int = 1


class PropertyVAE(nn.Module):
    """Motif-level VAE (reference property_vae.py:64-127; registry name
    ``prop``): encoder, posterior heads and decoder, with the embeddings
    tied between encoder and decoder (reference vae.py:100-109)."""

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

    def _decoder(self) -> MotifDecoder:
        return self.decoder

    def rsample(self, z_vecs: torch.Tensor, eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reparameterised sample with ``z_log_var = −|W_var z|`` (reference
        property_vae.py:92-99) and its KL divided by the batch size.  With
        ``eps`` (standard normal, the shape of the mean) the sample is
        perturbed; without, it is the mean."""
        batch_size = z_vecs.shape[0]
        z_mean = self.R_mean(z_vecs)
        z_log_var = -torch.abs(self.R_var(z_vecs))
        kl = -0.5 * torch.sum(1.0 + z_log_var - z_mean * z_mean -
                              torch.exp(z_log_var)) / batch_size
        if eps is None:
            return z_mean, kl
        return z_mean + torch.exp(z_log_var / 2) * eps, kl

    def encode_latent(self, tree: Dict[str, torch.Tensor],
                      eps: Optional[torch.Tensor] = None):
        root, _ = self.encoder(tree)
        return self.rsample(root, eps)


class PropOptVAE(nn.Module):
    """Motif VAE + HOMO/LUMO property heads on the split latent (reference
    property_vae.py:257-394; registry name ``prop-opt``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.half_latent = cfg.latent_size // 2
        self.vae = PropertyVAE(cfg)
        self.property_optim = PropertyOptimizer(
            self.half_latent, cfg.latent_size - self.half_latent,
            cfg.linear_hidden_size)

    def _decoder(self) -> MotifDecoder:
        return self.vae.decoder

    def encode_latent(self, tree: Dict[str, torch.Tensor],
                      eps: Optional[torch.Tensor] = None):
        return self.vae.encode_latent(tree, eps)

    def predict_properties(self, z: torch.Tensor):
        return self.property_optim.predict(z[:, :self.half_latent],
                                           z[:, self.half_latent:])
