"""Training loop: train step, scanned steps, metric accumulation,
checkpoints (counterpart of ``ggpm_tpu/train/loop.py``: ``Trainer`` with
``train_step``, ``scan_steps``, ``dp_step``, ``train_epoch``,
``evaluate``, ``MetricAccumulator``).

Reference driver semantics: reference vae_train.py:60-111 (Adam +
exponential decay + grad-clip 20, print every ``print_iter``, checkpoint per
epoch/``save_iter``).  Metrics stay on the device until a print boundary
reads them.  Where the JAX package runs K same-shape steps as one
``lax.scan`` call (``make_scan_train_step``), the port on the card replays
one captured CUDA graph per step (``StepGraph``: forward, backward and the
optimizer's update), captured once per device-batch signature; on the CPU
``scan_steps`` runs K eager steps, the plain version.

On a ``parallel.mesh.Mesh`` the ``Trainer`` is one rank of a
data-parallel (or dp×tp) run: its step is the same, with the gradient,
metrics and breaker flag reduced over the ranks by one all-reduce between
the backward pass and the update (``parallel.mesh.reduce_step``).  Under
NCCL that all-reduce is captured inside the step's CUDA graph and each
replay runs it; under gloo, and on a dp×tp mesh, whose step gathers its
split leaves into storage it releases after the update, the step runs
eagerly.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from collections.abc import Mapping
from typing import (Any, Callable, Dict, Iterable, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..bridge import to_flax_tree
from ..data.batching import (compact_plan_dict, hier_train_tables,
                             to_model_batch, train_tables)
from ..ops import add_replay, capture_record, captured_counts
from ..parallel import mesh as pmesh
from . import checkpoint as ckpt
from .optim import Adam, MultiAdam


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
    """Accumulates metric dicts of device values, scalars of a step or
    [K] rows of ``Trainer.scan_steps``; values are read (one host sync
    each) only at ``mean()``, the mean over every step."""

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
            vals = [torch.as_tensor(m[k], dtype=torch.float64).reshape(-1)
                    .cpu() for m in self.pending if k in m]
            out[k] = float(torch.cat(vals).mean())
        return out

    def reset(self) -> None:
        self.pending = []


def count_clipped(flags: list) -> int:
    """How many of a list of circuit-breaker flags are set: host bools
    (``PropertyVAE``) and device bools, one a step or [K] of a
    ``scan_steps`` (``PropOptVAE``), the latter read in one sync."""
    dev = [f.reshape(-1) for f in flags if isinstance(f, torch.Tensor)]
    n = sum(bool(f) for f in flags if not isinstance(f, torch.Tensor))
    return n + (int(torch.cat(dev).sum()) if dev else 0)


def _leaves(batch: Mapping) -> list:
    """A device batch's tensors in ``signature``'s order."""
    out = []
    for k in sorted(batch):
        v = batch[k]
        out.extend(_leaves(v) if isinstance(v, Mapping) else [v])
    return out


def _static_copy(batch: Mapping, shared: torch.Tensor) -> Dict[str, Any]:
    """A copy of a device batch in tensors of its own, but ``shared`` (the
    vocab mask), which stays the same tensor."""
    return {k: _static_copy(v, shared) if isinstance(v, Mapping)
            else v if v is shared else v.clone() for k, v in batch.items()}


class StepGraph:
    """One training step captured as a ``torch.cuda.CUDAGraph`` for one
    device-batch signature: forward, backward and the optimizer's update,
    with the kernels' launches inside.

    Its static inputs (a copy of the batch, ``eps`` and ``clip_eps``) are
    allocated before the capture, outside the graph's private memory pool
    (one pool per graph: nothing of one graph's pool is live across
    another's replay, but separate pools need no argument that it stays
    so); ``run`` copies a batch into them, draws the noise into them from the
    trainer's generator, replays, and copies the step's row of metrics out
    before the next replay of any graph overwrites it.  Each replay adds
    the launches its capture recorded to the wrappers' counts."""

    def __init__(self, trainer: 'Trainer', batch: Dict[str, Any],
                 stream: torch.cuda.Stream):
        self.inputs = _static_copy(batch, trainer._mask_dev)
        self.eps, self.clip_eps = trainer._noise(batch, static=True)
        before = captured_counts()
        reduces = pmesh.all_reduce.captured
        mem0 = torch.cuda.memory_reserved(stream.device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # the capture registers the device's default generator (dropout's);
        # a capture that fails would leave it in capture mode
        gen = torch.cuda.default_generators[stream.device.index]
        saved = gen.clone_state()
        try:
            with torch.cuda.stream(stream):
                self.graph.capture_begin()
                try:
                    metrics, aux = trainer._body(self.inputs, self.eps,
                                                 self.clip_eps)
                    self.out = trainer._row(metrics, aux)
                finally:
                    self.graph.capture_end()
        except BaseException:
            gen.graphsafe_set_state(saved)
            raise
        torch.cuda.synchronize(stream.device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(stream.device) - mem0
        self.launches, self.launches_bf16 = capture_record(before)
        self.all_reduces = pmesh.all_reduce.captured - reduces

    def run(self, trainer: 'Trainer', batch: Dict[str, Any]
            ) -> torch.Tensor:
        """One step on ``batch``; returns its row (``Trainer._row``)."""
        for dst, src in zip(_leaves(self.inputs), _leaves(batch)):
            if dst is trainer._mask_dev:
                if src is not dst:
                    raise ValueError('a graph step takes the trainer\'s '
                                     'vocab mask (Trainer.device_batch)')
            else:
                dst.copy_(src)
        trainer._noise(batch, out=(self.eps, self.clip_eps))
        self.graph.replay()
        add_replay(self.launches, self.launches_bf16)
        pmesh.all_reduce.calls += self.all_reduces
        return self.out.clone()


class Trainer:
    """Orchestrates epochs over an iterable of ``MolGraphBatch`` objects
    (or ``to_model_batch`` dicts) for the four models of the registry
    (``prop``, ``prop-opt``, ``hier-prop``, ``hier-prop-opt``); a batch of
    a model with property heads carries its HOMO/LUMO labels to the
    device, NaN where a molecule has none.

    The optimizer (``optim.Adam`` or ``optim.MultiAdam``) is attached to
    the model's named parameters here (they move into its flat buffers,
    see ``optim.Adam.attach``), after the model is moved to ``device``;
    weights loaded later with ``bridge.load_flax_params`` land in the same
    buffers.

    A step reads no host value that changes from step to step: β comes
    from a float64 device copy of ``total_step`` (``_step_dev``), the
    learning rate and bias corrections from the optimizer's device counts,
    and the noise (``eps``, and ``clip_eps`` for a model that takes it) is
    drawn from ``gen`` before the model runs.  So the same step can be
    captured once and replayed (``scan_steps``); ``graphs`` keeps the
    captures, one per device-batch signature.

    With ``mesh`` (``parallel.mesh.Mesh``) the trainer is one rank of a
    data-parallel run (JAX's ``Trainer(mesh=...)``): each step takes a
    group of ``n_shards`` same-signature batches (``mesh.dp``, divided by
    ``mesh.n_proc`` where each process reads its own input) and computes
    on its own one of them, ``gen`` is seeded from (seed, data index), the
    parameters start from rank 0's, and on a dp×tp mesh the optimizer
    holds this rank's rows of the split leaves
    (``parallel.mesh.ShardedAdamState``, split at ``tp_min_dim``)."""

    def __init__(self, model, optimizer: Union[Adam, MultiAdam],
                 vocab_mask: np.ndarray,
                 beta: float = 0.1, print_iter: int = 50,
                 save_dir: Optional[str] = None, save_iter: int = -1,
                 clip_break_count: int = 5, seed: int = 1,
                 beta_warmup_steps: int = 0, perturb_z: bool = True,
                 device: str = 'cuda', mesh: Optional[pmesh.Mesh] = None,
                 tp_min_dim: int = 256):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.is_hier = getattr(model, 'is_hier', False)
        self.optimizer = optimizer
        self.mesh = mesh
        self.tp_min_dim = tp_min_dim
        self.n_shards = 1
        if mesh is not None:
            if mesh.n_proc > 1 and mesh.tp > 1:
                raise ValueError('several processes with their own inputs '
                                 'and TP are not supported (a 1-D data '
                                 'mesh only), as in the JAX package')
            if mesh.dp % mesh.n_proc:
                raise ValueError(f'{mesh.dp} data ranks over {mesh.n_proc} '
                                 f'processes')
            if not isinstance(optimizer, Adam):
                raise ValueError('data-parallel training takes one Adam '
                                 '(make_optimizer), as vae_train builds')
            self.n_shards = mesh.dp // mesh.n_proc
            pmesh.broadcast_params(list(self.model.parameters()))
        if mesh is not None and mesh.tp > 1:
            self.opt_state = pmesh.ShardedAdamState(optimizer, self.model,
                                                    mesh, tp_min_dim)
        else:
            self.opt_state = optimizer.attach(
                dict(self.model.named_parameters()))
        self.vocab_mask = np.asarray(vocab_mask)
        self._mask_dev = torch.as_tensor(self.vocab_mask, device=self.device)
        self.beta = beta
        self.print_iter = print_iter
        self.save_dir = save_dir
        self.save_iter = save_iter
        self.clip_break_count = clip_break_count
        self.gen = torch.Generator(device=self.device).manual_seed(
            pmesh.step_seed(seed, None if mesh is None else mesh.data_index))
        self.beta_warmup_steps = beta_warmup_steps
        self.perturb_z = perturb_z
        self.total_step = 0
        self.n_clipped = 0
        self.mols_seen = 0
        self._draws_clip = 'clip_eps' in inspect.signature(
            self.model.forward).parameters
        self._step_dev = torch.zeros((), dtype=torch.float64,
                                     device=self.device)
        self._step_dev_at = 0           # the total_step it holds
        self.graphs: Dict[Tuple, StepGraph] = {}
        self._layout: Optional[Tuple] = None
        self._stream = None

    # -- host side ---------------------------------------------------------
    def host_batch(self, mb) -> Dict[str, Any]:
        """A ``MolGraphBatch`` (or model-batch dict) as the model-batch dict
        the JAX ``Trainer`` uploads: for the motif family its plan
        lane-packed (``compact_plan_dict``); the hier family's stays
        unpacked (its scan is not lane-agnostic)."""
        if not isinstance(mb, Mapping):
            mb = to_model_batch(mb, self.vocab_mask, pad=False)
        if not self.is_hier and 'mol_lane' not in mb['plan']:
            mb = dict(mb, plan=compact_plan_dict(
                {k: np.asarray(v) for k, v in mb['plan'].items()}))
        return mb

    def device_batch(self, host: Mapping) -> Dict[str, Any]:
        """``host_batch``'s dict with the training tables
        (``train_tables``, ``hier_train_tables`` for the hier family), on
        the device."""
        tables = hier_train_tables if self.is_hier else train_tables
        return to_device(tables(host), self.device, self._mask_dev)

    # -- the step on the device ---------------------------------------------
    def _sync_step(self) -> None:
        """Bring the device's step index to the host's (a no-op unless
        ``total_step`` was set from outside)."""
        if self._step_dev_at != self.total_step:
            self._step_dev.fill_(float(self.total_step))
            self._step_dev_at = self.total_step

    def _beta_t(self, idx: Optional[torch.Tensor] = None):
        """β of the step at index ``idx`` (default ``_step_dev``):
        ``beta · min(idx / beta_warmup_steps, 1)`` in float64 on the
        device, as the host computed it, then rounded to float32 as the
        model's ``beta · kl`` rounds it; ``beta`` itself without warmup."""
        if self.beta_warmup_steps <= 0:
            return self.beta
        idx = self._step_dev if idx is None else idx
        # divided by a device scalar: CUDA divides by a host scalar as a
        # product with its reciprocal, which may differ in the last bit
        warmup = torch.full_like(idx, float(self.beta_warmup_steps))
        return (torch.clamp(idx / warmup, max=1.0) * self.beta).float()

    def _noise(self, batch: Mapping, static: bool = False, out=None,
               eps: bool = True):
        """The step's ``(eps, clip_eps)`` drawn from ``gen`` in the order
        the model would draw them (None where it draws none, and for
        ``eps`` without ``eps``): fresh, into ``out``, or, with
        ``static``, empty tensors of their shapes."""
        shapes = ((batch['tree']['scope'].shape[0],
                   self.model.cfg.latent_size)
                  if self.perturb_z and eps else None,
                  () if self._draws_clip else None)
        res = []
        for i, shape in enumerate(shapes):
            if shape is None:
                res.append(None)
            elif static:
                res.append(torch.empty(shape, device=self.device))
            else:
                res.append(torch.randn(shape, generator=self.gen,
                                       device=self.device,
                                       out=None if out is None else out[i]))
        return tuple(res)

    def _body(self, batch: Dict[str, Any], eps, clip_eps, beta=None):
        """One optimizer step from the device's state alone: forward,
        backward, the optimizer's update, and the device step index
        advanced.  Returns (metrics, aux) as device values."""
        self.model.train()
        for p in self.opt_state.params:
            p.grad = None
        if isinstance(self.opt_state, pmesh.ShardedAdamState):
            self.opt_state.gather()
        extra = {} if clip_eps is None else {'clip_eps': clip_eps}
        loss, metrics, aux = self.model(
            batch, self._beta_t() if beta is None else beta, eps=eps,
            perturb_z=self.perturb_z, generator=self.gen, **extra)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.mesh is None:
            gnorm = self.opt_state.update()
        else:
            g, metrics, aux = pmesh.reduce_step(self.mesh, self.opt_state,
                                                metrics, aux)
            gnorm = self.opt_state.update(g)
        self._step_dev += 1
        return dict(metrics, GNorm=gnorm), aux

    def _advance(self) -> None:
        """The host's side of a step, eager or replayed."""
        self.opt_state.advance()
        self.total_step += 1
        self._step_dev_at += 1

    def _row(self, metrics: Dict[str, Any], aux: Dict[str, Any]
             ) -> torch.Tensor:
        """A step's metrics, per-group gradient norms and breaker flag as
        one float32 vector laid out as ``_layout``."""
        groups = getattr(self.opt_state, 'group_norms', {})
        clipped = aux.get('clipped')
        layout = (tuple(sorted(metrics)), tuple(groups),
                  isinstance(clipped, torch.Tensor))
        if self._layout is None:
            self._layout = layout
        if layout != self._layout:
            raise ValueError(f'step outputs {layout}, expected '
                             f'{self._layout}')
        vals = [metrics[k] for k in layout[0]] + [groups[g] for g in layout[1]]
        if layout[2]:
            vals.append(clipped)
        return torch.stack([v.float() for v in vals])

    def _unpack(self, rows: torch.Tensor):
        """``scan_steps``'s (metrics, aux) from its [K, n] rows."""
        keys, groups, has_clip = self._layout
        metrics = {k: rows[:, i] for i, k in enumerate(keys)}
        aux = {'clipped': rows[:, -1].bool() if has_clip else False}
        if groups:
            aux['group_norms'] = {g: rows[:, len(keys) + i]
                                  for i, g in enumerate(groups)}
        return metrics, aux

    # -- steps -------------------------------------------------------------
    def train_step(self, batch: Dict[str, Any], step_idx=None,
                   eps: Optional[torch.Tensor] = None):
        """One optimizer step on a device batch, eagerly; returns (metrics,
        aux) with ``GNorm``, the gradients' global norm before clipping.
        ``eps`` replaces the latent noise drawn from ``gen``; ``step_idx``
        the step index β is warmed up by.  Advances ``total_step``."""
        self._sync_step()
        drawn, clip_eps = self._noise(batch, eps=eps is None)
        beta = None
        if step_idx is not None and self.beta_warmup_steps > 0:
            beta = self._beta_t(torch.tensor(float(step_idx),
                                             dtype=torch.float64,
                                             device=self.device))
        out = self._body(batch, drawn if eps is None else eps, clip_eps,
                         beta)
        self._advance()
        return out

    def scan_steps(self, batches: Sequence[Dict[str, Any]],
                   graph: Optional[bool] = None):
        """K optimizer steps, one per device batch of ``batches``, in
        order (counterpart of the JAX ``Trainer.scan_steps`` over
        ``stack_batches(batches)``).  Returns (metrics, aux) of [K] device
        rows, as the JAX scan stacks them, with ``aux['group_norms']``
        under a per-group optimizer.

        With ``graph`` (the default on CUDA; CUDA only) each step is a
        replay of the ``StepGraph`` of its batch's signature, captured at
        the signature's first step: that step runs eagerly on a side
        stream as its own step (the warm-up a capture needs) and the
        capture follows.  A capture or replay that fails raises; nothing
        falls back to eager steps.  Without it, K ``train_step``s."""
        if graph is None:
            graph = self.graphs_by_default()
        if not graph:
            return self._unpack(torch.stack(
                [self._row(*self.train_step(db)) for db in batches]))
        if self.device.type != 'cuda':
            raise ValueError('a CUDA graph needs a CUDA device')
        if self.mesh is not None and not self.graphs_by_default():
            raise ValueError('a step on this mesh runs eagerly: its '
                             'collectives are gloo\'s, or it gathers split '
                             'leaves (dp×tp)')
        self._sync_step()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        rows = []
        for db in batches:
            key = (signature(db), self.beta, self.beta_warmup_steps,
                   self.perturb_z)
            g = self.graphs.get(key)
            if g is None:
                rows.append(self._warm_up(db))
                self.graphs[key] = StepGraph(self, db, self._stream)
            else:
                rows.append(g.run(self, db))
                self._advance()
        return self._unpack(torch.stack(rows))

    def graphs_by_default(self) -> bool:
        """Whether ``scan_steps`` replays CUDA graphs by default: on the
        card, outside a mesh or on a 1-D mesh whose collectives are
        NCCL's."""
        if self.device.type != 'cuda':
            return False
        return self.mesh is None or (
            self.mesh.tp == 1 and torch.distributed.get_backend() == 'nccl')

    def dp_step(self, db_list: Sequence, graph: Optional[bool] = None):
        """ONE data-parallel optimizer step over a group of up to
        ``n_shards`` same-signature batches (``MolGraphBatch`` objects or
        model-batch dicts; a short group is filled by cycling): this rank
        steps on its own one, with the gradient, metrics and flag reduced
        over the ranks.  Returns (metrics, aux) of [1] rows, as
        ``scan_steps`` (``graph`` as it takes it)."""
        if self.mesh is None:
            raise ValueError('Trainer built without a mesh')
        if len(db_list) > self.n_shards:
            raise ValueError(f'a group of {len(db_list)} batches, a step '
                             f'takes {self.n_shards}')
        mine = pmesh.stack_batches(pmesh.dp_groups(db_list, self.n_shards)[0],
                                   self.mesh, self.n_shards)
        return self.scan_steps([self.device_batch(self.host_batch(mine))],
                               graph=graph)

    def gathered(self):
        """A context in which the model's parameters are whole: on a dp×tp
        mesh its split leaves are gathered (a collective every rank must
        enter) and released after; elsewhere nothing to do."""
        if isinstance(self.opt_state, pmesh.ShardedAdamState):
            return self.opt_state.whole()
        return contextlib.nullcontext()

    def _warm_up(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The eager step of a signature's first batch, on the capture's
        side stream; returns its row."""
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            row = self._row(*self._body(batch, *self._noise(batch)))
        cur.wait_stream(self._stream)
        row.record_stream(cur)
        self._advance()
        return row

    def graph_stats(self) -> Dict[str, Any]:
        """The captured step graphs: how many, the seconds their captures
        took, and the memory their pools reserved."""
        return dict(signatures=len(self.graphs),
                    capture_s=sum(g.capture_s for g in self.graphs.values()),
                    pool_bytes=sum(g.pool_bytes for g in self.graphs.values()))

    def train_epoch(self, data: Iterable, epoch: int = 0,
                    log: Callable = print, scan_chunk: int = 8,
                    graph: Optional[bool] = None) -> bool:
        """One epoch.  Batches are buffered per shape signature and run
        ``scan_chunk`` at a time, a flush of two or more through
        ``scan_steps`` (CUDA graphs on the card), of one through
        ``train_step``; the buckets left at the end run in the order they
        were opened (``graph`` as ``scan_steps`` takes it).  This is the
        order in which the JAX ``Trainer`` takes its steps
        (loop.py:474-484), so both follow the same parameter trajectory.
        On a mesh a flush is split into groups of ``n_shards``, the short
        last one filled by cycling (loop.py:406-425), and each group is one
        step on this rank's batch of it; only those batches go to the
        device.  Returns True when the negative-loss circuit breaker stops
        the run: its flags stay on the device, and are counted at each
        print boundary and at the epoch's end, where ``clip_break_count``
        of them in the run stop it."""
        acc = MetricAccumulator()
        t0 = time.time()
        mols0 = self.mols_seen
        clipped_flags = []
        next_print = (self.total_step // self.print_iter + 1) * self.print_iter
        next_save = None
        if self.save_iter > 0:
            next_save = (self.total_step // self.save_iter + 1) * self.save_iter

        def run(flush):
            if self.mesh is None:
                hosts = [host for host, _ in flush]
                db_list = [db for _, db in flush]
            else:
                # groups of n_shards (the last cycled): this rank's batch
                # of each, on the device
                groups = pmesh.dp_groups([host for host, _ in flush],
                                         self.n_shards)
                hosts = [host for group in groups for host in group]
                db_list = [self.device_batch(pmesh.stack_batches(
                    group, self.mesh, self.n_shards)) for group in groups]
            if len(db_list) == 1:
                metrics, aux = self.train_step(db_list[0])
            else:
                metrics, aux = self.scan_steps(db_list, graph=graph)
            self.mols_seen += sum(len(h['plan']['root_clab']) for h in hosts)
            acc.add(metrics)
            clipped_flags.append(aux.get('clipped', False))
        def boundary() -> bool:
            nonlocal next_print, next_save
            if self.total_step >= next_print:
                next_print = (self.total_step // self.print_iter + 1) \
                    * self.print_iter
                self.n_clipped += count_clipped(clipped_flags)
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
                with self.gathered():
                    if self.save_dir:
                        ckpt.save_params(to_flax_tree(self.model),
                                         f'{self.save_dir}/model.{n_iter}')
            return False

        def arrivals():
            # on a mesh only this rank's batches go to the device (run)
            for mb in data:
                host = self.host_batch(mb)
                yield host, (None if self.mesh is not None
                             else self.device_batch(host))

        for flush in flushes(arrivals(), lambda x: signature(x[0]),
                             scan_chunk):
            run(flush)
            if boundary():
                return True
        self.n_clipped += count_clipped(clipped_flags)
        return self.n_clipped >= self.clip_break_count

    @torch.no_grad()
    def evaluate(self, data: Iterable) -> Dict[str, float]:
        """Mean metrics over ``data`` without noise or dropout (the JAX
        ``make_eval_step``), on this rank's device alone (on a dp×tp mesh
        every rank of the model group must call it: the split leaves are
        gathered)."""
        acc = MetricAccumulator()
        self.model.eval()
        with self.gathered():
            for mb in data:
                _, metrics, _ = self.model(
                    self.device_batch(self.host_batch(mb)), self.beta,
                    perturb_z=False)
                acc.add(metrics)
        return acc.mean()
