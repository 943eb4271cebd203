"""Adam with exponential learning-rate decay and global-norm clipping, as
the JAX package's optax chain computes it, and the per-subnetwork optimizer
(counterpart of ``ggpm_tpu/train/optim.py``: ``make_optimizer``,
``make_multi_optimizer``, ``default_group_fn``).

The chain is ``clip_by_global_norm(clip_norm)``, ``scale_by_adam()`` (b1
0.9, b2 0.999, eps 1e-8, eps_root 0) and ``scale_by_learning_rate(lr ·
anneal_rate ^ (count // steps_per_epoch))``, where ``count`` is the number
of updates made before this one, as optax counts; with ``staircase``
False the exponent is ``count / steps_per_epoch`` (``optax.
exponential_decay``'s continuous decay, which the ChemBERTa baseline
trains with).  optax clips by
``g / ‖g‖ · clip_norm`` when ``‖g‖ >= clip_norm`` (``clip_grad_norm_``
divides by ``‖g‖ + 1e-6`` instead).

``Adam.attach`` moves a model's parameters into one flat buffer, each
parameter a view of it, so that an update is a handful of elementwise
kernels over one vector (optax's ``flatten`` does the same for the JAX
package).  ``MultiAdam`` is ``optax.multi_transform`` over such chains:
each group of parameters has its own flat buffer, clips by the global norm
of its own gradients, and keeps its own moments, learning rate and count.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch


@dataclass
class Adam:
    """The optimizer's hyperparameters (``make_optimizer``); ``attach``
    gives the state that ``step`` updates."""
    lr: float = 1e-3
    clip_norm: float = 20.0
    anneal_rate: float = 0.9
    steps_per_epoch: int = 1000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    staircase: bool = True

    def schedule(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates, in
        float32 as optax computes it."""
        if not self.staircase:
            return float(self._continuous(torch.tensor(count)))
        epoch = count // max(self.steps_per_epoch, 1)
        rate = torch.tensor(self.anneal_rate, dtype=torch.float32) ** epoch
        return float(self.lr * rate)

    def _continuous(self, count: torch.Tensor) -> torch.Tensor:
        """``optax.exponential_decay(lr, steps_per_epoch, anneal_rate)``
        (not staircase) at ``count``: ``lr · anneal_rate ^ (count /
        steps_per_epoch)`` in float32, ``lr`` at count 0."""
        p = count.float() / max(self.steps_per_epoch, 1)
        rate = torch.pow(torch.tensor(self.anneal_rate, dtype=torch.float32,
                                      device=count.device), p)
        return torch.where(count <= 0, torch.full_like(rate, self.lr),
                           rate * self.lr)

    def attach(self, params: Union[Sequence[torch.nn.Parameter],
                                   Mapping]) -> 'AdamState':
        """Put ``params`` (distinct, one device, float32; or a mapping
        from names to them, as ``dict(model.named_parameters())``) into
        one flat buffer and return the zero state over it.  The parameters
        stay where the model holds them, each now a view of the buffer."""
        params = list(params.values() if isinstance(params, Mapping)
                      else params)
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        offset = 0
        for p in params:
            n = p.numel()
            p.data = flat[offset:offset + n].view_as(p)
            offset += n
        return AdamState(self, params, flat, torch.zeros_like(flat),
                         torch.zeros_like(flat))


def _pow_f32(base: torch.Tensor, cube: float, n: torch.Tensor
             ) -> torch.Tensor:
    """``torch.tensor(b, dtype=torch.float32) ** k`` for the integer count
    ``n`` on the device, bit for bit as ATen computes a float32 tensor to an
    integral Python power: in double (``base`` is ``b`` rounded to float32,
    held as a float64 device scalar) rounded to float32, except k = 3, which
    it multiplies out in float32 (``cube``)."""
    return torch.where(n == 3, cube, (base ** n.double()).float())


class AdamState:
    """The flat parameters and moments of one optimizer run.

    The count of updates lives on the device (``count_dev``, optax's
    ``count``): the bias corrections and the learning rate are float32
    device scalars computed from it in the update, so that a captured
    update (``train.loop.Trainer.scan_steps``) computes each replay's own.
    ``count`` is its host mirror, advanced by ``step`` (or ``advance``,
    after a replay of a captured ``update``)."""

    def __init__(self, opt: Adam, params: List[torch.nn.Parameter],
                 flat: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor):
        self.opt = opt
        self.params = params
        self.flat = flat
        self.mu = mu
        self.nu = nu
        self.count = 0
        self.count_dev = torch.zeros((), dtype=torch.int64, device=flat.device)
        self._pows = {}
        for name in ('b1', 'b2', 'anneal_rate'):
            b = torch.tensor(getattr(opt, name), dtype=torch.float32)
            self._pows[name] = (
                torch.tensor(float(b), dtype=torch.float64,
                             device=flat.device), float(b * b * b))

    def _pow(self, name: str, n: torch.Tensor) -> torch.Tensor:
        return _pow_f32(*self._pows[name], n)

    def schedule_t(self, count: torch.Tensor) -> torch.Tensor:
        """``opt.schedule(count)`` for a device count: the same float32
        scalar, on the device."""
        if not self.opt.staircase:
            return self.opt._continuous(count)
        epoch = torch.div(count, max(self.opt.steps_per_epoch, 1),
                          rounding_mode='floor')
        return self._pow('anneal_rate', epoch) * self.opt.lr

    def bias_corrections(self, count: torch.Tensor):
        """``1 - b1 ** count`` and ``1 - b2 ** count`` as float32 device
        scalars."""
        return 1 - self._pow('b1', count), 1 - self._pow('b2', count)

    def flat_grad(self) -> torch.Tensor:
        """The parameters' gradients as one vector (zeros where a
        parameter got none)."""
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
            for p in self.params])

    @torch.no_grad()
    def update(self, g: Optional[torch.Tensor] = None,
               gnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (or the flat
        gradient ``g``, laid out as ``flat``) and the device count, which
        it advances, with no host sync and no host value; returns the
        gradients' global norm (before clipping) as a device scalar, or
        clips by ``gnorm`` where the caller gives the norm of a gradient
        of which ``g`` is a part (``parallel.mesh.ShardedAdamState``).
        The host's ``count`` is left to ``advance``."""
        o = self.opt
        g = self.flat_grad() if g is None else g
        if gnorm is None:
            gnorm = global_norm(g)
        # optax: select(‖g‖ < max, g, g / ‖g‖ · max), without a host sync
        keep = gnorm < o.clip_norm
        g = g / torch.where(keep, torch.ones_like(gnorm), gnorm) * \
            torch.where(keep, torch.ones_like(gnorm), torch.full_like(
                gnorm, o.clip_norm))
        self.mu.mul_(o.b1).add_(g, alpha=1 - o.b1)
        self.nu.mul_(o.b2).addcmul_(g, g, value=1 - o.b2)
        self.count_dev += 1
        bc1, bc2 = self.bias_corrections(self.count_dev)
        upd = (self.mu / bc1) / ((self.nu / bc2).sqrt_() + o.eps)
        # optax's order: the update scaled by the learning rate, then added
        self.flat.sub_(upd.mul_(self.schedule_t(self.count_dev - 1)))
        return gnorm

    def advance(self) -> None:
        self.count += 1

    def step(self) -> torch.Tensor:
        """``update`` and ``advance``: one optimizer step."""
        gnorm = self.update()
        self.advance()
        return gnorm


def global_norm(g: torch.Tensor) -> torch.Tensor:
    """The norm of a flat gradient as a float32 device scalar, summed in
    float64: a float32 sum over ~2M entries on the CPU is off by 2e-4
    relative; optax's per-leaf sums are not."""
    return torch.linalg.vector_norm(g, dtype=torch.float64).float()


def make_optimizer(lr: float = 1e-3, clip_norm: float = 20.0,
                   anneal_rate: float = 0.9,
                   steps_per_epoch: int = 1000,
                   staircase: bool = True) -> Adam:
    """Adam + exponential decay + global-norm clip (JAX
    ``make_optimizer``; with ``staircase`` False the chain of the JAX
    ``train_chemberta``)."""
    return Adam(lr=lr, clip_norm=clip_norm, anneal_rate=anneal_rate,
                steps_per_epoch=steps_per_epoch, staircase=staircase)


def default_group_fn(path: str) -> str:
    """Route a parameter to the encoder, decoder, homo or lumo group by its
    path (JAX ``default_group_fn``).  The port's parameter names mirror the
    flax paths module by module (``vae.encoder.…``, ``property_optim.
    homo_linear.…``), so the tied embeddings, ``vae.E_c`` and ``vae.E_i``
    (flax ``vae/E_c/embedding``), fall in the decoder group in both, and
    untied ones by their owner: ``vae.encoder.E_c_mod`` in the encoder
    group, ``vae.decoder.E_c_mod`` in the decoder group."""
    if 'homo_linear' in path:
        return 'homo'
    if 'lumo_linear' in path:
        return 'lumo'
    if 'encoder' in path:
        return 'encoder'
    return 'decoder'


@dataclass
class MultiAdam:
    """One ``Adam`` per group (``make_multi_optimizer``); ``group_fn`` maps
    a parameter's name to its group."""
    group_fn: Callable[[str], str]
    groups: Dict[str, Adam]

    def attach(self, named: Mapping) -> 'MultiAdamState':
        """Give each group's parameters of ``named`` (name -> parameter,
        as ``dict(model.named_parameters())``) their own flat buffer and
        zero state.  A group no parameter falls in is left out."""
        members: Dict[str, list] = {g: [] for g in self.groups}
        for name, p in named.items():
            g = self.group_fn(name)
            if g not in members:
                raise KeyError(f'parameter {name}: group {g!r} has no '
                               f'learning rate (have {sorted(members)})')
            members[g].append(p)
        return MultiAdamState({g: self.groups[g].attach(ps)
                               for g, ps in members.items() if ps})


class MultiAdamState:
    """The per-group states of one ``MultiAdam`` run."""

    def __init__(self, groups: Dict[str, AdamState]):
        self.groups = groups
        self.params = [p for st in groups.values() for p in st.params]
        self.group_norms: Dict[str, torch.Tensor] = {}

    @property
    def count(self) -> int:
        return next(iter(self.groups.values())).count

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """One update of every group from the parameters' ``.grad``, each
        clipped by its own gradients' global norm and counted by its own
        device count; returns the norm over all groups (before clipping)
        and keeps each group's in ``group_norms``, as device scalars."""
        self.group_norms = {g: st.update() for g, st in self.groups.items()}
        return torch.stack(list(self.group_norms.values())).square().sum() \
            .sqrt()

    def advance(self) -> None:
        for st in self.groups.values():
            st.advance()

    def step(self) -> torch.Tensor:
        """``update`` and ``advance``: one optimizer step."""
        gnorm = self.update()
        self.advance()
        return gnorm


def make_multi_optimizer(group_fn: Callable[[str], str],
                         lrs: Dict[str, float], clip_norm: float = 20.0,
                         anneal_rate: float = 0.9,
                         steps_per_epoch: int = 1000) -> MultiAdam:
    """Per-subnetwork optimizers, each group with its own learning rate
    (JAX ``make_multi_optimizer``; reference vae_fine_tune_indv_opt.py:
    61-70)."""
    return MultiAdam(group_fn, {
        name: make_optimizer(lr, clip_norm, anneal_rate, steps_per_epoch)
        for name, lr in lrs.items()})
