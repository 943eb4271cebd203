"""The VAE models (counterpart of ``ggpm_tpu/models/vae.py``:
``ModelConfig``, ``PropertyVAE``, ``PropOptVAE`` and
``PropOptSchedulingVAE`` with their training forwards, ``HierPropertyVAE``
and ``HierPropOptVAE`` with theirs, and the attention memory ``A_mem``
of a model built with ``use_attention``), and ``init_params``, flax's
default initialisers.

Reference: ggpm/property_vae.py (PropertyVAE, PropOptVAE, HierPropertyVAE,
HierPropOptVAE, PropOptSchedulingVAE).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .decoder import MotifDecoder
from .encoder import HierMPNEncoder, MotifEncoder
from .heads import LossWeigh, PropertyOptimizer
from .hier_decoder import HierDecoder


def compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A config's ``compute_dtype`` as the encoders' compute type, with
    JAX's ``_dtype`` semantics (ggpm_tpu/models/vae.py:25-29): 'bf16' and
    'bfloat16' are ``torch.bfloat16``; any other value (None, 'float32',
    'float16', ...) is f32, returned as None, and is not an error."""
    return torch.bfloat16 if name in ('bfloat16', 'bf16') else None


@dataclass
class ModelConfig:
    """The fields of ``ggpm_tpu.models.vae.ModelConfig``.  The defaults
    are the JAX package's; those of the motif family are the trained HOPV
    prop-opt model's too (scripts/quality_run.py), which trains the hier
    family with ``diterG`` 3.

    ``rnn_type`` ('LSTM' or 'GRU') is the cell of every encoder level and
    decoder; ``tie_embedding`` shares the motif and attachment embeddings
    between encoder and decoder (the VAE's ``E_c``/``E_i``), and without
    it each owns its ``E_c_mod``/``E_i_mod``; ``compute_dtype`` 'bf16' (or
    'bfloat16') runs the encoders' depth loops in bfloat16, any other value
    in f32 (``compute_dtype``; the decoders, heads and losses stay f32).
    ``remat`` and ``loop_remat`` are read and kept but change nothing: in
    JAX they rematerialise the decoder scan's steps and the encoder's depth
    rounds, which trades compute for memory and leaves the numbers as
    they are.  ``use_attention`` adds the attention heads (``A_mem`` and
    the decoder's ``A_topo``, ``A_cls``, ``A_assm``)."""
    hvocab_size: int
    ivocab_size: int
    atom_vocab_size: int = 38
    embed_size: int = 250
    hidden_size: int = 250
    latent_size: int = 24
    linear_hidden_size: int = 128
    depthT: int = 20
    depthG: int = 20
    diterT: int = 1
    diterG: int = 5
    dropout: float = 0.0
    rnn_type: str = 'LSTM'
    tie_embedding: bool = True
    loss_scaling: bool = False
    remat: bool = False
    loop_remat: bool = False
    use_attention: bool = False
    compute_dtype: str = 'float32'

    def __post_init__(self):
        if self.rnn_type not in ('LSTM', 'GRU'):
            raise ValueError(f'unsupported rnn cell type {self.rnn_type}')

    @property
    def dtype(self) -> Optional[torch.dtype]:
        """The encoders' compute type (``compute_dtype``)."""
        return compute_dtype(self.compute_dtype)

    @classmethod
    def from_configs(cls, configs, vocab) -> 'ModelConfig':
        """From a config bag (``configs.Configs``) and its vocab, with the
        JAX package's defaults; keys the port does not read are
        ignored."""
        hv, iv = vocab.size()
        return cls(hvocab_size=hv, ivocab_size=iv, **{
            k: getattr(configs, k) for k in (
                'embed_size', 'hidden_size', 'latent_size',
                'linear_hidden_size', 'depthT', 'depthG', 'diterT',
                'diterG', 'dropout', 'rnn_type', 'tie_embedding',
                'loss_scaling', 'remat', 'loop_remat', 'use_attention',
                'compute_dtype') if hasattr(configs, k)})


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


def embeddings(vae: nn.Module, cfg: ModelConfig):
    """The encoder's and the decoder's ``(E_c, E_i)`` and whether each owns
    them (JAX vae.py:100-117): tied, one pair, the VAE's ``E_c`` and
    ``E_i``; untied, a pair each."""
    def pair():
        return (nn.Embedding(cfg.hvocab_size, cfg.embed_size),
                nn.Embedding(cfg.ivocab_size, cfg.embed_size))
    if cfg.tie_embedding:
        vae.E_c, vae.E_i = pair()
        return (vae.E_c, vae.E_i), (vae.E_c, vae.E_i), False
    return pair(), pair(), True


class PropertyVAE(nn.Module):
    """Motif-level VAE (reference property_vae.py:64-127; registry name
    ``prop``): encoder, posterior heads and decoder, with the embeddings
    tied between encoder and decoder (reference vae.py:100-109) unless
    ``cfg.tie_embedding`` is False.  With ``cfg.use_attention`` the
    decoder's heads attend over the encoder's node hiddens projected by
    ``A_mem`` (JAX vae.py:120-126)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        enc_emb, dec_emb, owned = embeddings(self, cfg)
        self.encoder = MotifEncoder(*enc_emb, cfg.hidden_size, cfg.depthT,
                                    cfg.dropout, cfg.rnn_type, cfg.dtype,
                                    owned)
        self.R_mean = nn.Linear(cfg.hidden_size, cfg.latent_size)
        self.R_var = nn.Linear(cfg.hidden_size, cfg.latent_size)
        self.decoder = MotifDecoder(*dec_emb, cfg.hidden_size,
                                    cfg.latent_size, cfg.diterT, cfg.dropout,
                                    cfg.use_attention, cfg.rnn_type, owned)
        if cfg.use_attention:
            self.A_mem = nn.Linear(cfg.hidden_size, cfg.latent_size)

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

    def encode_attention_memory(self, tree: Dict[str, torch.Tensor]):
        """``(src_mem, scope)`` for attention-aware decoding (JAX
        vae.py:156): the encoder's node hiddens projected by ``A_mem`` and
        the tree's scope windows, for ``decode_motif(src_mem=...,
        src_scope=...)``."""
        _, node = self.encoder(tree)
        return self.A_mem(node), tree['scope']

    def src_mem(self, node: torch.Tensor) -> Optional[torch.Tensor]:
        """The attention memory of the encoder's node hiddens, None
        without the attention heads."""
        return self.A_mem(node) if self.cfg.use_attention else None

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
        root, node = self.encoder(tree)
        if perturb_z and eps is None:
            eps = torch.randn((root.shape[0], self.cfg.latent_size),
                              generator=generator, device=root.device)
        z, kl = self.rsample(root, eps if perturb_z else None)
        loss, metrics = self.decoder(tree, plan, z, batch['vocab_mask'],
                                     src_mem=self.src_mem(node))
        total = loss + beta * kl
        metrics = dict(metrics, Loss=total, KL=kl)
        return total, metrics, {'clipped': False}


def _circuit_breaker(total: torch.Tensor, clip_eps, generator):
    """The negative-loss circuit breaker: a total at or below zero becomes
    ``0.5 + 0.5 · clip_eps``, ``clip_eps`` a standard normal scalar drawn
    from ``generator`` when not given, and 0 when neither is (the JAX
    model's ``rng=None``).  Returns the total and the condition as a device
    bool."""
    if clip_eps is None:
        clip_eps = (torch.zeros((), device=total.device)
                    if generator is None else
                    torch.randn((), generator=generator, device=total.device))
    clipped = total <= 0
    return torch.where(clipped, 0.5 + 0.5 * clip_eps, total), clipped.detach()


class PropOptVAE(nn.Module):
    """Motif VAE + HOMO/LUMO property heads on the split latent (reference
    property_vae.py:257-394; registry name ``prop-opt``), with the learned
    loss weighing when ``cfg.loss_scaling``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.half_latent = cfg.latent_size // 2
        self.vae = PropertyVAE(cfg)
        self.property_optim = PropertyOptimizer(
            self.half_latent, cfg.latent_size - self.half_latent,
            cfg.linear_hidden_size, cfg.dropout)
        if cfg.loss_scaling:
            self.loss_weigh = LossWeigh()

    def _decoder(self) -> MotifDecoder:
        return self.vae.decoder

    def encode_latent(self, tree: Dict[str, torch.Tensor],
                      eps: Optional[torch.Tensor] = None):
        return self.vae.encode_latent(tree, eps)

    def encode_attention_memory(self, tree: Dict[str, torch.Tensor]):
        return self.vae.encode_attention_memory(tree)

    def predict_properties(self, z: torch.Tensor):
        return self.property_optim.predict(z[:, :self.half_latent],
                                           z[:, self.half_latent:])

    def property_loss(self, z: torch.Tensor, homos: torch.Tensor,
                      lumos: torch.Tensor):
        """(HOMO MSE, LUMO MSE, HOMO out, LUMO out) of the heads at ``z``
        against the labels, NaN labels left out."""
        return self.property_optim(z[:, :self.half_latent],
                                   z[:, self.half_latent:], (homos, lumos))

    def forward(self, batch: Dict[str, Any], beta: float,
                eps: Optional[torch.Tensor] = None, perturb_z: bool = True,
                generator: Optional[torch.Generator] = None,
                clip_eps: Optional[torch.Tensor] = None):
        """The fine-tuning loss of a device batch that carries ``homos``
        and ``lumos``: ``(total, metrics, aux)`` with ``total = (decoder
        loss + beta · KL) + HOMO MSE + LUMO MSE``, each term weighed by
        ``LossWeigh`` first when ``cfg.loss_scaling`` (reference
        property_vae.py:330-357).  The latent is sampled as
        ``PropertyVAE.forward`` samples it.  A total at or below zero is
        replaced by ``0.5 + 0.5 · clip_eps`` (the negative-loss circuit
        breaker), ``clip_eps`` a standard normal scalar drawn from
        ``generator`` when not given, and 0 when neither is (the JAX
        model's ``rng=None``); ``aux['clipped']`` is that condition as a
        device bool, read by the ``Trainer`` without a sync per step."""
        tree, plan = batch['tree'], batch['plan']
        root, node = self.vae.encoder(tree)
        if perturb_z and eps is None:
            eps = torch.randn((root.shape[0], self.cfg.latent_size),
                              generator=generator, device=root.device)
        z, kl = self.vae.rsample(root, eps if perturb_z else None)
        homo_loss, lumo_loss, _, _ = self.property_loss(
            z, batch['homos'], batch['lumos'])
        recon_loss, metrics = self.vae.decoder(tree, plan, z,
                                               batch['vocab_mask'],
                                               src_mem=self.vae.src_mem(node))
        recon_loss = recon_loss + beta * kl
        if self.cfg.loss_scaling:
            recon_loss, homo_loss, lumo_loss = self.loss_weigh(
                recon_loss, homo_loss, lumo_loss)
        total = recon_loss + homo_loss + lumo_loss
        total, clipped = _circuit_breaker(total, clip_eps, generator)
        metrics = dict(metrics, Loss=total, KL=kl, Recs_Loss=recon_loss,
                       HOMO_MSE=homo_loss, LUMO_MSE=lumo_loss)
        return total, metrics, {'clipped': clipped}


class HierPropertyVAE(nn.Module):
    """Hierarchical (3-level) VAE (reference property_vae.py:11-62;
    registry name ``hier-prop``): ``HierMPNEncoder``, the posterior heads
    and ``HierDecoder``, with the embeddings tied between encoder and
    decoder unless ``cfg.tie_embedding`` is False.  ``is_hier``: its
    batches keep their plans unpacked and carry
    ``data.batching.hier_train_tables`` (JAX ``is_hier``)."""
    is_hier = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        enc_emb, dec_emb, owned = embeddings(self, cfg)
        self.encoder = HierMPNEncoder(*enc_emb, cfg.hidden_size, cfg.depthT,
                                      cfg.depthG, cfg.atom_vocab_size,
                                      cfg.dropout, cfg.rnn_type, cfg.dtype,
                                      owned)
        self.decoder = HierDecoder(*dec_emb, cfg.hidden_size,
                                   cfg.latent_size, cfg.atom_vocab_size,
                                   cfg.diterT, cfg.diterG, cfg.dropout,
                                   cfg.use_attention, cfg.rnn_type, owned)
        self.R_mean = nn.Linear(cfg.hidden_size, cfg.latent_size)
        self.R_var = nn.Linear(cfg.hidden_size, cfg.latent_size)
        if cfg.use_attention:
            self.A_mem = nn.Linear(cfg.hidden_size, cfg.latent_size)

    def _decoder(self) -> HierDecoder:
        return self.decoder

    rsample = PropertyVAE.rsample

    def encode_latent(self, tree: Dict[str, torch.Tensor],
                      eps: Optional[torch.Tensor] = None,
                      graph: Optional[Dict[str, torch.Tensor]] = None):
        """Latent and KL of a batch's ``tree`` and atom-level ``graph``."""
        root, _, _, _ = self.encoder(tree, graph)
        return self.rsample(root, eps)

    def latent(self, batch: Dict[str, Any], eps, perturb_z, generator):
        """The encoder's root vectors of a batch sampled as
        ``PropertyVAE.forward`` samples them, and the attention memories
        (JAX vae.py:320-325: the motif-level ``A_mem(hnode)`` and the
        atom-level ``A_mem(hatom)``, None without the attention heads):
        ``(z, kl, mems)``."""
        root, hnode, _, hatom = self.encoder(batch['tree'], batch['graph'])
        if perturb_z and eps is None:
            eps = torch.randn((root.shape[0], self.cfg.latent_size),
                              generator=generator, device=root.device)
        mems = ({'src_tree_mem': self.A_mem(hnode),
                 'src_graph_mem': self.A_mem(hatom)}
                if self.cfg.use_attention else {})
        return self.rsample(root, eps if perturb_z else None) + (mems,)

    def forward(self, batch: Dict[str, Any], beta: float,
                eps: Optional[torch.Tensor] = None, perturb_z: bool = True,
                generator: Optional[torch.Generator] = None):
        """The training loss of a device batch (``train.loop.to_device`` of
        a ``data.batching.hier_train_tables`` dict): ``(total, metrics,
        aux)`` with ``total = decoder loss + beta · KL`` (JAX vae.py:
        314-332), the latent sampled as ``PropertyVAE.forward`` samples
        it."""
        z, kl, mems = self.latent(batch, eps, perturb_z, generator)
        loss, metrics = self.decoder(batch['tree'], batch['graph'],
                                     batch['plan'], z, batch['vocab_mask'],
                                     **mems)
        total = loss + beta * kl
        metrics = dict(metrics, Loss=total, KL=kl)
        return total, metrics, {'clipped': False}


class HierPropOptVAE(nn.Module):
    """Hierarchical VAE + HOMO/LUMO heads on the split latent (reference
    property_vae.py:130-254; registry name ``hier-prop-opt``).  The JAX
    package nests the VAE under ``hier/`` beside ``property_optim/``.

    Reference quirk kept (JAX vae.py:339-341, 396): the fine-tuning total
    leaves β·KL out; KL is reported, not added."""
    is_hier = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.half_latent = cfg.latent_size // 2
        self.hier = HierPropertyVAE(cfg)
        self.property_optim = PropertyOptimizer(
            self.half_latent, cfg.latent_size - self.half_latent,
            cfg.linear_hidden_size, cfg.dropout)
        if cfg.loss_scaling:
            self.loss_weigh = LossWeigh()

    def _decoder(self) -> HierDecoder:
        return self.hier.decoder

    def encode_latent(self, tree: Dict[str, torch.Tensor],
                      eps: Optional[torch.Tensor] = None,
                      graph: Optional[Dict[str, torch.Tensor]] = None):
        return self.hier.encode_latent(tree, eps, graph=graph)

    predict_properties = PropOptVAE.predict_properties
    property_loss = PropOptVAE.property_loss

    def forward(self, batch: Dict[str, Any], beta: float,
                eps: Optional[torch.Tensor] = None, perturb_z: bool = True,
                generator: Optional[torch.Generator] = None,
                clip_eps: Optional[torch.Tensor] = None):
        """The fine-tuning loss of a device batch that carries ``homos``
        and ``lumos``, as ``PropOptVAE.forward`` computes it (loss scaling,
        the circuit breaker and its ``clip_eps``) but for the total,
        ``decoder loss + HOMO MSE + LUMO MSE`` without β·KL (JAX vae.py:
        374-405); ``beta`` is not read."""
        z, kl, mems = self.hier.latent(batch, eps, perturb_z, generator)
        homo_loss, lumo_loss, _, _ = self.property_loss(
            z, batch['homos'], batch['lumos'])
        recon_loss, metrics = self.hier.decoder(
            batch['tree'], batch['graph'], batch['plan'], z,
            batch['vocab_mask'], **mems)
        if self.cfg.loss_scaling:
            recon_loss, homo_loss, lumo_loss = self.loss_weigh(
                recon_loss, homo_loss, lumo_loss)
        total = recon_loss + homo_loss + lumo_loss
        total, clipped = _circuit_breaker(total, clip_eps, generator)
        metrics = dict(metrics, Loss=total, KL=kl, Recs_Loss=recon_loss,
                       HOMO_MSE=homo_loss, LUMO_MSE=lumo_loss)
        return total, metrics, {'clipped': clipped}


class PropOptSchedulingVAE(nn.Module):
    """Motif VAE + HOMO/LUMO heads trained with scheduled sampling
    (reference property_vae.py:399-480; JAX vae.py:408-458; registry name
    ``prop-opt-sched``): ``PropOptVAE``'s tree (``vae/`` beside
    ``property_optim/``), the decoder's loss from
    ``MotifDecoder.scheduled_forward``, the property losses weighted 20
    (reference property_vae.py:477), no loss scaling and no circuit
    breaker (``aux['clipped']`` is False)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.half_latent = cfg.latent_size // 2
        self.vae = PropertyVAE(cfg)
        self.property_optim = PropertyOptimizer(
            self.half_latent, cfg.latent_size - self.half_latent,
            cfg.linear_hidden_size, cfg.dropout)

    def _decoder(self) -> MotifDecoder:
        return self.vae.decoder

    encode_latent = PropOptVAE.encode_latent
    encode_attention_memory = PropOptVAE.encode_attention_memory
    predict_properties = PropOptVAE.predict_properties
    property_loss = PropOptVAE.property_loss

    def forward(self, batch: Dict[str, Any], beta: float,
                eps: Optional[torch.Tensor] = None, perturb_z: bool = True,
                generator: Optional[torch.Generator] = None,
                tf_ratio: float = 1.0, coins: Optional[torch.Tensor] = None):
        """The fine-tuning loss of a device batch that carries ``homos``
        and ``lumos``: ``(total, metrics, aux)`` with ``total = (scheduled
        decoder loss + beta · KL) + 20 · (HOMO MSE + LUMO MSE)``, the
        latent sampled as ``PropertyVAE.forward`` samples it.  The
        decoder feeds its own motif predictions back in the lanes whose
        ``coins`` are set (``MotifDecoder.scheduled_forward``: drawn from
        ``generator`` with probability ``1 − tf_ratio`` when not given;
        the ``Trainer`` passes neither, so it trains at ``tf_ratio`` 1, as
        the JAX ``Trainer`` does)."""
        tree, plan = batch['tree'], batch['plan']
        root, _ = self.vae.encoder(tree)
        if perturb_z and eps is None:
            eps = torch.randn((root.shape[0], self.cfg.latent_size),
                              generator=generator, device=root.device)
        z, kl = self.vae.rsample(root, eps if perturb_z else None)
        homo_loss, lumo_loss, _, _ = self.property_loss(
            z, batch['homos'], batch['lumos'])
        recon_loss, metrics = self.vae.decoder.scheduled_forward(
            tree, plan, z, batch['vocab_mask'], tf_ratio, coins, generator)
        recon_loss = recon_loss + beta * kl
        total = recon_loss + 20.0 * homo_loss + 20.0 * lumo_loss
        metrics = dict(metrics, Loss=total, KL=kl, Recs_Loss=recon_loss,
                       HOMO_MSE=homo_loss, LUMO_MSE=lumo_loss)
        return total, metrics, {'clipped': False}
