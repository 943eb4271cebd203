"""Inference-time latent-space property optimisation (counterpart of
``ggpm_tpu/latent/control.py``: ``LatentOptimizer`` and
``control_decode``).

Reference: ggpm/property_control.py:13-216 — gradient search on the latent
code against HOMO/LUMO targets under one of the stopping policies (soft,
patience, hard, and ``fixed``, which is hard), with a sign-flipped step:
``z ← z − sign·lr·∇z``, sign = −1 where the prediction is below its target.

The whole batch runs in lockstep on the model's device.  ``hard`` and
``fixed`` take exactly ``property_optim_step`` steps on the batch's mean
loss (each row's gradient scaled by 1/B, the reference's batched
``MSELoss(reduction='mean')``); ``soft`` and ``patience`` step on the sum
(each row its own loss's gradient) and stop row by row, as the JAX
package's masked ``while_loop`` does: a finished row is frozen.  The host
reads whether every row has finished after each iteration, and stops
there or at the JAX package's cap of ``max(20·property_optim_step, 1000)``
iterations.  The search is bound by the host's launches, so the card has
caught up by the time of each read and the read costs little.

The gradients come from ``torch.autograd.grad`` with respect to the two
latent halves only; the heads' weights enter as detached tensors.  The
heads are [B, 12] → 128 → 1 dense layers, which the JAX package computes
outside any Pallas kernel: they stay torch matmuls.

A NaN target (an unlabelled row) gives that row a NaN gradient for its
half, as in the JAX package, whose ``where(isfinite(t), (x − t)², 0)``
back-propagates ``0 · 2(x − NaN)``: under ``hard`` and ``patience`` the
half becomes NaN; under ``soft`` too, unless the row's loss with its NaN
terms left out (0 for a row with no label) is within ``property_delta``
at once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

POLICIES = ('soft', 'patience', 'fixed', 'hard')


def _head_weights(head) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """A ``PropertyRegressor``'s layers as detached (weight, bias)."""
    return [(lin.weight.detach(), lin.bias.detach()) for lin in (
        getattr(head, f'Dense_{k}') for k in range(head.n_layers))]


def _mlp(x: torch.Tensor, layers) -> torch.Tensor:
    for k, (w, b) in enumerate(layers):
        x = F.linear(x, w, b)
        if k + 1 < len(layers):
            x = F.relu(x)
    return x[..., 0]


class LatentOptimizer:
    """soft/patience/fixed/hard latent search over a prop-opt model's
    property heads (reference ``PropertyVAEOptimizer``).  After
    ``optimize``, ``stats()`` gives the iterations the search ran and the
    rows stopped by ``property_delta`` and by patience."""

    def __init__(self, model, optimize_type: str = 'soft',
                 latent_lr: float = 1.0, property_optim_step: int = 50,
                 property_delta: float = 0.1, patience: int = 5,
                 patience_threshold: float = 0.1):
        if optimize_type not in POLICIES:
            raise ValueError(
                f'Error: property-optimizing choice "{optimize_type}" is '
                f'not valid')
        self.model = model
        self.optimize_type = optimize_type
        self.lr = latent_lr
        self.steps = property_optim_step
        self.delta = property_delta
        self.patience = patience
        self.threshold = patience_threshold
        self._stats: Dict[str, object] = {}

    @property
    def max_iters(self) -> int:
        """The masked loop's safety cap (JAX ``_masked_optimize``)."""
        return max(self.steps * 20, 1000)

    # ------------------------------------------------------------------
    def _losses_and_step(self, heads, h, l, h_tar, l_tar, mean: bool):
        """Per-row losses at (h, l) and the sign-rule step from there
        (reference update_params, property_control.py:65-69)."""
        h = h.detach().requires_grad_(True)
        l = l.detach().requires_grad_(True)
        h_out, l_out = _mlp(h, heads[0]), _mlp(l, heads[1])
        h_loss = torch.where(torch.isfinite(h_tar), (h_out - h_tar) ** 2, 0.0)
        l_loss = torch.where(torch.isfinite(l_tar), (l_out - l_tar) ** 2, 0.0)
        total = (h_loss.mean() + l_loss.mean() if mean
                 else h_loss.sum() + l_loss.sum())
        gh, gl = torch.autograd.grad(total, (h, l))
        h_sign = torch.where(h_out < h_tar, -1.0, 1.0)[:, None].detach()
        l_sign = torch.where(l_out < l_tar, -1.0, 1.0)[:, None].detach()
        return ((h_loss + l_loss).detach(), h.detach() - h_sign * self.lr * gh,
                l.detach() - l_sign * self.lr * gl)

    def _hard(self, heads, h, l, h_tar, l_tar):
        """Exactly ``steps`` batched steps (reference property_control.py:
        159-180)."""
        for _ in range(self.steps):
            _, h, l = self._losses_and_step(heads, h, l, h_tar, l_tar, True)
        b = h.shape[0]
        no = torch.zeros(b, dtype=torch.bool, device=h.device)
        self._stats = dict(iterations=self.steps, by_delta=no,
                           by_patience=no)
        return h, l

    def _masked(self, heads, h, l, h_tar, l_tar, use_delta: bool):
        """Until each row's loss is within ``delta`` (soft only) or its
        patience runs out (reference property_control.py:71-157)."""
        b, dev = h.shape[0], h.device
        prev = torch.zeros(b, device=dev)
        patience = torch.full((b,), self.patience, dtype=torch.int32,
                              device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        by_delta = torch.zeros_like(done)
        by_patience = torch.zeros_like(done)
        full = torch.full_like(patience, self.patience)

        it = 0
        while it < self.max_iters and not bool(done.all()):
            losses, nh, nl = self._losses_and_step(heads, h, l, h_tar, l_tar,
                                                   False)
            hit_delta = (losses <= self.delta) if use_delta else \
                torch.zeros_like(done)
            # patience (reference property_control.py:93-97): spent when the
            # loss grew or improved by at most the threshold, relative
            rel = (losses - prev).abs() / prev.abs().clamp(min=1e-12)
            worse = (losses > prev) | (rel <= self.threshold)
            patience_new = torch.where(worse, patience - 1, full)
            # the reference's order (property_control.py:88-105): the delta
            # test comes before the step; the iteration that exhausts
            # patience still takes its step
            stepping = ~(done | hit_delta)
            h = torch.where(stepping[:, None], nh, h)
            l = torch.where(stepping[:, None], nl, l)
            prev = torch.where(stepping, losses, prev)
            patience = torch.where(stepping, patience_new, patience)
            spent = stepping & (patience_new <= 0)
            by_delta = by_delta | (~done & hit_delta)
            by_patience = by_patience | spent
            done = done | hit_delta | spent
            it += 1
        self._stats = dict(iterations=it, by_delta=by_delta,
                           by_patience=by_patience)
        return h, l

    # ------------------------------------------------------------------
    def optimize(self, root_vecs, homos, lumos) -> torch.Tensor:
        """The searched latents [B, latent] on the model's device, from
        latents ``root_vecs`` and targets ``homos``, ``lumos`` (NaN where a
        row has none).  Runs with gradients on, also when the caller is in
        ``no_grad`` or ``inference_mode``."""
        po = self.model.property_optim
        dev = po.homo_linear.Dense_0.weight.device
        with torch.inference_mode(False), torch.enable_grad():
            # a copy: an inference tensor cannot be saved for backward
            z = (root_vecs.to(dev, torch.float32).clone()
                 if isinstance(root_vecs, torch.Tensor) else
                 torch.tensor(np.asarray(root_vecs, np.float32), device=dev))
            h_tar, l_tar = (torch.tensor(np.asarray(t, np.float32), device=dev)
                            for t in (homos, lumos))
            half = z.shape[-1] // 2
            heads = (_head_weights(po.homo_linear),
                     _head_weights(po.lumo_linear))
            h, l = z[:, :half], z[:, half:]
            if self.optimize_type in ('fixed', 'hard'):
                h, l = self._hard(heads, h, l, h_tar, l_tar)
            else:
                h, l = self._masked(heads, h, l, h_tar, l_tar,
                                    use_delta=self.optimize_type == 'soft')
            return torch.cat([h, l], dim=-1).detach()

    def stats(self) -> Dict[str, object]:
        """The last search's iterations and the rows (indices) it stopped
        by delta and by patience; reads the device."""
        s = self._stats
        return dict(iterations=s['iterations'],
                    by_delta=torch.nonzero(s['by_delta']).flatten().tolist(),
                    by_patience=torch.nonzero(s['by_patience']).flatten()
                    .tolist())


def control_decode(model, vocab, avocab, batch, homos, lumos,
                   optimizer: LatentOptimizer, max_decode_step: int = 150):
    """encode → latent search → property prediction → decode (reference
    PropertyVAEOptimizer.forward, property_control.py:33-63), through the
    exact decode with per-step logs.  Returns ((homo, lumo) predictions
    at the searched latents as numpy, per-step results, SMILES)."""
    from ..models.api import encode
    from ..models.decode import decode_motif

    z, _ = encode(model, batch)
    z_opt = optimizer.optimize(z, homos, lumos)
    with torch.no_grad():
        props = model.predict_properties(z_opt)
    results, smiles = decode_motif(model, vocab, avocab, z_opt, greedy=True,
                                   max_decode_step=max_decode_step)
    return tuple(p.cpu().numpy() for p in props), results, smiles
