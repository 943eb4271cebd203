"""The motif VAE with property heads (counterpart of
``ggpm_tpu/models/vae.py``: ``ModelConfig``, ``PropertyVAE`` with its
training forward, ``PropOptVAE`` as far as encoding, property prediction
and decoding need it), and ``init_params``, flax's default initialisers.

Reference: ggpm/property_vae.py (PropertyVAE, PropOptVAE).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .decoder import MotifDecoder
from .encoder import MotifEncoder
from .heads import PropertyOptimizer


@dataclass
class ModelConfig:
    """The fields of ``ggpm_tpu.models.vae.ModelConfig`` that the motif
    family reads.  The defaults are the trained HOPV prop-opt model's
    (scripts/quality_run.py); the encoder is the LSTM one, with embeddings
    tied between encoder and decoder.  The GRU cell is ROADMAP A5."""
    hvocab_size: int
    ivocab_size: int
    embed_size: int = 250
    hidden_size: int = 250
    latent_size: int = 24
    linear_hidden_size: int = 128
    depthT: int = 20
    diterT: int = 1
    dropout: float = 0.0
    rnn_type: str = 'LSTM'

    def __post_init__(self):
        if self.rnn_type != 'LSTM':
            raise NotImplementedError(
                f'rnn_type {self.rnn_type!r}: the port has the LSTM cell '
                f'only; the GRU cell is ROADMAP A5')

    @classmethod
    def from_configs(cls, configs, vocab) -> 'ModelConfig':
        """From a config bag (``configs.Configs``) and its vocab, with the
        JAX package's defaults; keys the port does not read are ignored,
        and ``use_attention`` raises."""
        if getattr(configs, 'use_attention', False):
            raise NotImplementedError(
                'use_attention: the port has no attention heads; they wait '
                'until the base path is complete (ROADMAP A4)')
        hv, iv = vocab.size()
        return cls(hvocab_size=hv, ivocab_size=iv, **{
            k: getattr(configs, k) for k in (
                'embed_size', 'hidden_size', 'latent_size',
                'linear_hidden_size', 'depthT', 'diterT', 'dropout',
                'rnn_type') if hasattr(configs, k)})


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2 standard
    deviations, scaled to variance 1 / fan_in (``variance_scaling(1.0,
    'fan_in', 'truncated_normal')``)."""
    # the std of a standard normal truncated at ±2
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(w.shape, generator=gen, dtype=torch.float64)
    x = math.sqrt(2) * torch.erfinv(2 * (lo + (hi - lo) * u) - 1)
    w.copy_((x.clamp(-2, 2) * std).to(w.dtype))


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise ``model`` as flax initialises the JAX package's modules:
    every ``Linear`` (flax ``Dense``) kernel ``lecun_normal`` over its
    inputs with a zero bias, every ``Embedding`` (flax ``Embed``) normal
    with variance 1 / features.  The numbers come from ``gen`` (on the
    CPU), not from JAX's generator, so a model trained from scratch is the
    JAX package's model in distribution, not in value."""
    for _, m in sorted(model.named_modules(), key=lambda x: x[0]):
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen,
                                       dtype=torch.float64)
                           .mul_(math.sqrt(1.0 / m.embedding_dim))
                           .to(m.weight.dtype))
    return model


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
                                    cfg.depthT, cfg.dropout)
        self.R_mean = nn.Linear(cfg.hidden_size, cfg.latent_size)
        self.R_var = nn.Linear(cfg.hidden_size, cfg.latent_size)
        self.decoder = MotifDecoder(self.E_c, self.E_i, cfg.hidden_size,
                                    cfg.latent_size, cfg.diterT, cfg.dropout)

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

    def forward(self, batch: Dict[str, Any], beta: float,
                eps: Optional[torch.Tensor] = None, perturb_z: bool = True,
                generator: Optional[torch.Generator] = None):
        """The training loss of a device batch (``train.loop.to_device`` of
        a ``data.batching.train_tables`` dict): ``(total, metrics, aux)``
        with ``total = decoder loss + beta · KL`` (reference vae.py:168-182).
        With ``perturb_z`` the latent is sampled with noise ``eps`` (drawn
        from ``generator`` when not given); without, it is the mean.
        Dropout follows ``self.training``."""
        tree, plan = batch['tree'], batch['plan']
        root, _ = self.encoder(tree)
        if perturb_z and eps is None:
            eps = torch.randn((root.shape[0], self.cfg.latent_size),
                              generator=generator, device=root.device)
        z, kl = self.rsample(root, eps if perturb_z else None)
        loss, metrics = self.decoder(tree, plan, z, batch['vocab_mask'])
        total = loss + beta * kl
        metrics = dict(metrics, Loss=total, KL=kl)
        return total, metrics, {'clipped': False}


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
