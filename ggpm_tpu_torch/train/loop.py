"""Training loop: train step, metric accumulation, checkpoints (counterpart
of ``ggpm_tpu/train/loop.py``: ``Trainer`` with ``train_step``,
``train_epoch``, ``evaluate``, ``MetricAccumulator``; ``scan_steps`` (a TPU
dispatch device), ``dp_step`` and meshes (ROADMAP A7) are not ported).

Reference driver semantics: reference vae_train.py:60-111 (Adam +
exponential decay + grad-clip 20, print every ``print_iter``, checkpoint per
epoch/``save_iter``).  A step runs eagerly on the model's device; metrics
stay there until a print boundary reads them.
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..bridge import to_flax_tree
from ..data.batching import compact_plan_dict, to_model_batch, train_tables
from . import checkpoint as ckpt
from .optim import Adam


def to_device(batch: Mapping, device, vocab_mask: Optional[torch.Tensor]
              = None) -> Dict[str, Any]:
    """A host batch (nested dicts of numpy arrays) as tensors on
    ``device``; ``vocab_mask``, when given, is the device copy of the
    batch's mask (uploaded once and shared)."""
    out = {}
    for k, v in batch.items():
        if k == 'vocab_mask' and vocab_mask is not None:
            out[k] = vocab_mask
        elif isinstance(v, Mapping):
            out[k] = to_device(v, device)
        else:
            out[k] = torch.as_tensor(np.ascontiguousarray(v), device=device)
    return out


def signature(batch: Mapping) -> Tuple:
    """The shapes of a batch's arrays in sorted-key order: the JAX
    ``Trainer``'s bucket key (``jax.tree.leaves`` order)."""
    out = []
    for k in sorted(batch):
        v = batch[k]
        out.extend(signature(v) if isinstance(v, Mapping)
                   else [np.shape(v)])
    return tuple(out)


def flushes(items: Iterable, key: Callable, scan_chunk: int = 8):
    """Groups of ``items`` in the order the JAX ``Trainer`` steps through
    them (loop.py:474-484): items are buffered per ``key`` (the shape
    signature), a buffer is yielded when it holds ``scan_chunk``, and the
    buffers left at the end are yielded in the order they were opened."""
    buckets: Dict[Any, list] = {}
    for item in items:
        k = key(item)
        buckets.setdefault(k, []).append(item)
        if len(buckets[k]) >= scan_chunk:
            yield buckets.pop(k)
    yield from buckets.values()


class MetricAccumulator:
    """Accumulates metric dicts of device scalars; values are read (one
    host sync) only at ``mean()``."""

    def __init__(self):
        self.pending = []

    def add(self, metrics: Dict[str, Any]) -> None:
        self.pending.append(metrics)

    def mean(self) -> Dict[str, float]:
        if not self.pending:
            return {}
        keys = sorted({k for m in self.pending for k in m})
        out = {}
        for k in keys:
            vals = [torch.as_tensor(m[k], dtype=torch.float64).cpu()
                    for m in self.pending if k in m]
            out[k] = float(torch.stack(vals).mean())
        return out

    def reset(self) -> None:
        self.pending = []


class Trainer:
    """Orchestrates epochs over an iterable of ``MolGraphBatch`` objects
    (or ``to_model_batch`` dicts) for the ``prop`` model.

    The optimizer is attached to the model's parameters here (they move
    into its flat buffer, see ``optim.Adam.attach``), after the model is
    moved to ``device``; weights loaded later with
    ``bridge.load_flax_params`` land in the same buffer."""

    def __init__(self, model, optimizer: Adam, vocab_mask: np.ndarray,
                 beta: float = 0.1, print_iter: int = 50,
                 save_dir: Optional[str] = None, save_iter: int = -1,
                 clip_break_count: int = 5, seed: int = 1,
                 beta_warmup_steps: int = 0, perturb_z: bool = True,
                 device: str = 'cuda'):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.opt_state = optimizer.attach(self.model.parameters())
        self.vocab_mask = np.asarray(vocab_mask)
        self._mask_dev = torch.as_tensor(self.vocab_mask, device=self.device)
        self.beta = beta
        self.print_iter = print_iter
        self.save_dir = save_dir
        self.save_iter = save_iter
        self.clip_break_count = clip_break_count
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.beta_warmup_steps = beta_warmup_steps
        self.perturb_z = perturb_z
        self.total_step = 0
        self.n_clipped = 0
        self.mols_seen = 0

    # -- host side ---------------------------------------------------------
    def host_batch(self, mb) -> Dict[str, Any]:
        """A ``MolGraphBatch`` (or model-batch dict) as the model-batch dict
        the JAX ``Trainer`` uploads for the motif family: its plan
        lane-packed (``compact_plan_dict``)."""
        if not isinstance(mb, Mapping):
            mb = to_model_batch(mb, self.vocab_mask, pad=False)
        if 'mol_lane' not in mb['plan']:
            mb = dict(mb, plan=compact_plan_dict(
                {k: np.asarray(v) for k, v in mb['plan'].items()}))
        return mb

    def device_batch(self, host: Mapping) -> Dict[str, Any]:
        """``host_batch``'s dict with the training tables
        (``train_tables``), on the device."""
        return to_device(train_tables(host), self.device, self._mask_dev)

    # -- steps -------------------------------------------------------------
    def _beta(self, step_idx: float) -> float:
        if self.beta_warmup_steps > 0:
            return self.beta * min(step_idx / self.beta_warmup_steps, 1.0)
        return self.beta

    def train_step(self, batch: Dict[str, Any], step_idx=None,
                   eps: Optional[torch.Tensor] = None):
        """One optimizer step on a device batch; returns (metrics, aux)
        with ``GNorm``, the gradients' global norm before clipping.
        Advances ``total_step``."""
        idx = float(self.total_step if step_idx is None else step_idx)
        self.model.train()
        for p in self.opt_state.params:
            p.grad = None
        loss, metrics, aux = self.model(batch, self._beta(idx), eps=eps,
                                        perturb_z=self.perturb_z,
                                        generator=self.gen)
        loss.backward()
        gnorm = self.opt_state.step()
        self.total_step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(metrics, GNorm=gnorm), aux

    def train_epoch(self, data: Iterable, epoch: int = 0,
                    log: Callable = print, scan_chunk: int = 8) -> bool:
        """One epoch.  Batches are buffered per shape signature and run
        ``scan_chunk`` at a time; the buckets left at the end run in the
        order they were opened.  This is the order in which the JAX
        ``Trainer`` takes its steps (loop.py:474-484), so both follow the
        same parameter trajectory.  Returns True when the negative-loss
        circuit breaker stops the run."""
        acc = MetricAccumulator()
        t0 = time.time()
        mols0 = self.mols_seen
        clipped_flags = []
        next_print = (self.total_step // self.print_iter + 1) * self.print_iter
        next_save = None
        if self.save_iter > 0:
            next_save = (self.total_step // self.save_iter + 1) * self.save_iter
        def run(db_list):
            for db in db_list:
                metrics, aux = self.train_step(db)
                self.mols_seen += len(db['plan']['root_clab'])
                acc.add(metrics)
                clipped_flags.append(aux.get('clipped', False))

        def boundary() -> bool:
            nonlocal next_print, next_save
            if self.total_step >= next_print:
                next_print = (self.total_step // self.print_iter + 1) \
                    * self.print_iter
                self.n_clipped += int(sum(bool(x) for x in clipped_flags))
                clipped_flags.clear()
                if self.n_clipped >= self.clip_break_count:
                    log(f'[{self.total_step}] negative-loss clip count '
                        f'reached {self.n_clipped}; aborting run')
                    return True
                m = acc.mean()
                mps = (self.mols_seen - mols0) / max(time.time() - t0, 1e-9)
                log(f'[{self.total_step}] Beta: {self.beta:.3f}, '
                    f'mols/s: {mps:.1f}, '
                    + ', '.join(f'{k}: {v:.3f}' for k, v in sorted(m.items())))
                acc.reset()
            if next_save is not None and self.total_step >= next_save:
                n_iter = self.total_step // self.save_iter - 1
                next_save = (self.total_step // self.save_iter + 1) \
                    * self.save_iter
                if self.save_dir:
                    ckpt.save_params(to_flax_tree(self.model),
                                     f'{self.save_dir}/model.{n_iter}')
            return False

        def arrivals():
            for mb in data:
                host = self.host_batch(mb)
                yield signature(host), self.device_batch(host)

        for group in flushes(arrivals(), lambda x: x[0], scan_chunk):
            run([db for _, db in group])
            if boundary():
                return True
        self.n_clipped += int(sum(bool(x) for x in clipped_flags))
        return self.n_clipped >= self.clip_break_count

    @torch.no_grad()
    def evaluate(self, data: Iterable) -> Dict[str, float]:
        """Mean metrics over ``data`` without noise or dropout (the JAX
        ``make_eval_step``)."""
        acc = MetricAccumulator()
        self.model.eval()
        for mb in data:
            _, metrics, _ = self.model(self.device_batch(self.host_batch(mb)),
                                       self.beta, perturb_z=False)
            acc.add(metrics)
        return acc.mean()
