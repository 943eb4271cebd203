"""Meshes of ranks and the data-parallel and dp×tp training steps
(counterpart of ``ggpm_tpu/parallel/mesh.py``).

A ``Mesh`` is a grid of ranks of the process group, ``dp`` rows of data by
``tp`` columns of model: rank ``r`` sits at data index ``r // tp`` and
model index ``r % tp`` (JAX's ``make_mesh_2d`` reshapes its devices so).
Each rank is one process on one device and computes the loss of its own
batch: the batch of its data index in each group of ``dp`` batches of one
shape signature (``dp_groups``, where JAX stacks the group on a device
axis).

The step's one collective is ``all_reduce``: the port's flat gradient
(``train/optim.py``), the step's metrics and its breaker flag in one
buffer, summed over every rank and divided by the world.  So the gradient
is the mean over the data ranks (JAX's psum of the pmean'd loss), the
metrics their ``pmean`` and the flag, set where the sum is positive, their
``pmax``.  Every rank then clips and steps Adam on the same mean (JAX's
replicated ``optimizer.update``), so the parameters stay bit for bit equal
across ranks.

dp×tp splits the leaves that JAX's ``param_partition_spec`` splits over
the model axis (``ShardedAdamState``): the vocab-sized ``E_c``/``E_i``
embeddings by rows and the ``cls``/``icls`` kernels by columns, which are
rows of the port's ``Linear.weight``.  Each rank holds its rows of those
leaves and of their Adam moments; the whole leaf is all-gathered over the
model group before the forward pass and released after the update.  Its
gradient rides in the step's one all-reduce and each rank steps its rows
of it: an all-reduce where a reduce-scatter would move less, so that the
step has one collective of the gradient whatever the grid.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .distributed import process_count, process_index


def _count(fn) -> None:
    """One call of the collective ``fn``: in ``fn.calls`` when it runs, in
    ``fn.captured`` while a CUDA graph records it (a replay of the graph
    adds what its capture recorded, ``train.loop.StepGraph``)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.calls += 1


def all_reduce(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``buf`` in place over the ranks of ``group`` (all of them)."""
    _count(all_reduce)
    dist.all_reduce(buf, group=group)
    return buf


all_reduce.calls = all_reduce.captured = 0


def all_gather(shard: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``shard`` of ``group``, in rank order."""
    _count(all_gather)
    parts = [torch.empty_like(shard)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, shard, group=group)
    return parts


all_gather.calls = all_gather.captured = 0


@dataclass
class Mesh:
    """A ``dp`` × ``tp`` grid over the ranks of the process group.
    ``n_proc`` is how many of them read an input of their own (JAX's
    process count): 1 where every rank reads the same batches and takes
    its data index's of each group, the world where each reads a disjoint
    shard (``distributed.make_global_mesh``)."""
    dp: int
    tp: int = 1
    n_proc: int = 1
    model_group: Any = field(default=None, repr=False)

    @property
    def rank(self) -> int:
        return process_index()

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ('data', 'model') if self.tp > 1 else ('data',)

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D data mesh over the ``n_devices`` ranks of the group (all of
    them by default; the group's world must be that size), every rank
    reading the same batches."""
    world = process_count()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f'a mesh of {n} ranks in a group of {world}')
    return Mesh(dp=n)


def make_mesh_2d(dp: int, tp: int) -> Mesh:
    """A (data × model) grid of ``dp · tp`` ranks with this rank's model
    group: the ``tp`` ranks of its data row.  Every rank of the group must
    call it (each row's group is made on every rank)."""
    world = process_count()
    if dp * tp != world:
        raise ValueError(f'a {dp} × {tp} mesh in a group of {world}')
    mine = None
    for d in range(dp):
        g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
        if d == process_index() // tp:
            mine = g
    return Mesh(dp=dp, tp=tp, model_group=mine)


def dp_groups(batches: Sequence, n: int) -> List[list]:
    """A flush of same-signature batches in the groups of ``n`` that
    the JAX ``Trainer`` steps (loop.py:406-425): consecutive slices, the
    short last one filled by cycling its own batches."""
    out = []
    for i in range(0, len(batches), n):
        group = list(batches[i:i + n])
        while len(group) < n:
            group = group + group[:n - len(group)]
        out.append(group)
    return out


def stack_batches(batches: Sequence, mesh: Mesh, n_shards: Optional[int]
                  = None):
    """This rank's batch of a group of ``n_shards`` (default ``mesh.dp``)
    same-signature batches: the one JAX's stack puts on this rank's
    device."""
    n = mesh.dp if n_shards is None else n_shards
    if len(batches) != n:
        raise ValueError(f'a group of {len(batches)} batches, the mesh '
                         f'takes {n}')
    return batches[mesh.data_index % n]


def step_seed(seed: int, data_index: Optional[int]) -> int:
    """The seed of a rank's generator: ``seed`` itself outside a mesh
    (``data_index`` None), else one drawn from (seed, data index), so that
    each data rank draws its own noise (JAX's ``fold_in(rng,
    axis_index)``) and the ranks of a model group the same."""
    if data_index is None:
        return seed
    return int(np.random.SeedSequence([seed, data_index])
               .generate_state(1, np.uint64)[0] >> 1)


# -- the step's reduction ---------------------------------------------------

def reduce_step(mesh: Mesh, state, metrics: Dict[str, torch.Tensor],
                aux: Dict[str, Any]):
    """After the backward pass of this rank's batch: the mean gradient over
    the data ranks (flat, as ``state.flat_grad()`` lays it out, and as each
    parameter's ``.grad``, a view of it, as DDP leaves them), the ranks'
    mean metrics and their max breaker flag, by one ``all_reduce``."""
    g = state.flat_grad()
    keys = sorted(metrics)
    clipped = aux.get('clipped')
    flag = isinstance(clipped, torch.Tensor)
    vals = [metrics[k].detach().reshape(1).to(g.dtype) for k in keys]
    if flag:
        vals.append(clipped.reshape(1).to(g.dtype))
    buf = torch.cat([g] + vals)
    all_reduce(buf)
    buf.div_(mesh.world)
    n = g.numel()
    g = buf[:n]
    offset = 0
    for p in state.params:
        p.grad = g[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    metrics = {k: buf[n + i] for i, k in enumerate(keys)}
    if flag:
        aux = dict(aux, clipped=buf[-1] > 0)
    return g, metrics, aux


def broadcast_params(params: Sequence[torch.Tensor]) -> None:
    """Rank 0's values of ``params`` on every rank."""
    for p in params:
        dist.broadcast(p.data, 0)


# -- dp×tp ------------------------------------------------------------------

def _spec_for(name: str, shape: Tuple[int, ...], min_dim: int,
              tp_axis: str = 'model') -> tuple:
    """JAX's rule for one leaf at path ``name`` ('/'-joined keys)."""
    if len(shape) != 2:
        return ()
    if ('E_c' in name or 'E_i' in name) and 'embedding' in name and \
            shape[0] >= min_dim:
        return (tp_axis, None)
    if 'cls' in name.lower() and 'kernel' in name and shape[-1] >= min_dim:
        return (None, tp_axis)
    return ()


def param_partition_spec(tree: Mapping, min_dim: int = 256,
                         tp_axis: str = 'model', _path: str = ''):
    """JAX's ``param_partition_spec`` over a flax-layout tree (nested dicts
    of arrays): per leaf ``(tp_axis, None)`` for a 2-D ``E_c``/``E_i``
    embedding of at least ``min_dim`` rows, ``(None, tp_axis)`` for a
    2-D ``cls`` kernel of at least ``min_dim`` columns, else ``()``
    (replicated)."""
    out = {}
    for k, v in tree.items():
        name = f'{_path}/{k}' if _path else str(k)
        out[k] = (param_partition_spec(v, min_dim, tp_axis, name)
                  if isinstance(v, Mapping)
                  else _spec_for(name, np.shape(v), min_dim, tp_axis))
    return out


def split_params(model: torch.nn.Module, min_dim: int = 256) -> List[str]:
    """The names of ``model``'s parameters that ``param_partition_spec``
    splits, each split by rows of the port's tensor (an ``Embedding``'s
    rows are flax's; a ``Linear.weight``'s rows are the flax kernel's
    columns)."""
    from ..bridge import flax_paths
    out = []
    for name, (path, transposed) in flax_paths(model).items():
        shape = tuple(model.get_parameter(name).shape)
        if _spec_for('params/' + path, shape[::-1] if transposed else shape,
                     min_dim):
            out.append(name)
    return out


class ShardedAdamState:
    """An ``optim.Adam`` run over a model whose ``split_params`` are split
    by rows over the mesh's model group: the replicated parameters (views
    of the flat buffer, as ``Adam.attach`` makes them) and this rank's rows
    of each split one (padded to a multiple of ``tp``) share one flat
    buffer and its moments.  Between steps a split parameter holds no
    value (an empty tensor); ``gather`` all-gathers it before the forward
    pass and ``update`` releases it again."""

    def __init__(self, opt, model: torch.nn.Module, mesh: Mesh,
                 min_dim: int = 256):
        self.opt = opt
        self.mesh = mesh
        named = dict(model.named_parameters())
        self.params = list(named.values())
        self.split = split_params(model, min_dim)
        t, T = mesh.model_index, mesh.tp
        masters, self._split = [], []
        for name, p in named.items():
            if name in self.split:
                rows = p.shape[0]
                k = -(-rows // T)
                full = F.pad(p.detach(), (0, 0, 0, k * T - rows))
                shard = full[t * k:(t + 1) * k].clone()
                masters.append(shard)
                self._split.append((name, p, shard, rows, k))
            else:
                masters.append(p)
        self.inner = opt.attach(masters)
        self.gathered = True
        self.release()

    def shards(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
        """Per split parameter, this rank's rows of it and of its two
        moments, as views of the flat buffers."""
        offsets, offset = {}, 0
        for m in self.inner.params:
            offsets[id(m)] = offset
            offset += m.numel()
        return {name: tuple(buf[offsets[id(shard)]:offsets[id(shard)] +
                                shard.numel()].view_as(shard)
                            for buf in (self.inner.flat, self.inner.mu,
                                        self.inner.nu))
                for name, _, shard, _, _ in self._split}

    def release(self) -> None:
        """Free the storage of the split parameters' whole values."""
        if self.gathered:
            for _, p, *_ in self._split:
                p.data = p.data.new_empty(0)
            self.gathered = False

    def gather(self) -> None:
        """The split parameters' whole values from every rank's rows (one
        all-gather each over the model group)."""
        if self.gathered:
            return
        for _, p, shard, rows, k in self._split:
            parts = all_gather(shard, self.mesh.model_group)
            p.data = torch.cat(parts)[:rows]
        self.gathered = True

    def flat_grad(self) -> torch.Tensor:
        """The model's whole gradients, one parameter after the other."""
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1) for p in self.params])

    @torch.no_grad()
    def update(self, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update from the whole gradient ``g`` (``flat_grad``'s
        layout; the parameters' ``.grad`` by default), clipped by its
        global norm; each rank steps its rows of the split leaves.  The
        split parameters are released after it.  Returns the norm."""
        from ..train.optim import global_norm
        g = self.flat_grad() if g is None else g
        gnorm = global_norm(g)
        pieces, offset = [], 0
        split = {id(p): (rows, k) for _, p, _, rows, k in self._split}
        t, T = self.mesh.model_index, self.mesh.tp
        for p in self.params:
            n = p.numel()
            piece = g[offset:offset + n]
            if id(p) in split:
                rows, k = split[id(p)]
                piece = F.pad(piece.view(rows, -1), (0, 0, 0, k * T - rows))[
                    t * k:(t + 1) * k].reshape(-1)
            pieces.append(piece)
            offset += n
        self.inner.update(torch.cat(pieces), gnorm)
        self.release()
        return gnorm

    def advance(self) -> None:
        self.inner.advance()

    @contextlib.contextmanager
    def whole(self):
        """The block with the split parameters whole (a collective: every
        rank of the model group enters it)."""
        self.gather()
        try:
            yield
        finally:
            self.release()


def make_dp_train_step(model, optimizer, vocab_mask, mesh: Mesh,
                       beta: float = 0.1, perturb_z: bool = True,
                       seed: int = 1, device: str = 'cuda',
                       tp_min_dim: int = 256):
    """The data-parallel step (JAX's ``make_dp_train_step``; on a 2-D mesh
    the dp×tp step, JAX's ``make_gspmd_train_step``): the ``dp_step`` of a
    ``Trainer`` on ``mesh``, which takes a group of ``mesh.dp``
    same-signature batches and steps on this rank's."""
    from ..train.loop import Trainer
    trainer = Trainer(model, optimizer, vocab_mask, beta=beta,
                      perturb_z=perturb_z, seed=seed, device=device,
                      mesh=mesh, tp_min_dim=tp_min_dim)
    return trainer.dp_step
