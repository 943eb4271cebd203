"""Joining a cluster of processes, and the global batch (counterpart of
``ggpm_tpu/parallel/distributed.py``).

One process drives one device (a card, or the CPU).  ``init_distributed``
joins the process group from explicit arguments or the ``GGPM_*``
variables, as the JAX package's joins its cluster: NCCL for processes on
cards, gloo on the CPU, or the ``backend`` the caller names (gloo on cards
lets several ranks share one card, which NCCL refuses).  Each process
reads a disjoint input shard (``DataFolder(num_shards=world, shard_index=
rank)``), so each rank's batch is its own: ``global_device_batch`` keeps
it, where JAX assembles one global array of them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = 'cuda',
                     backend: Optional[str] = None) -> int:
    """Join the process group; returns this process's rank.

    Falls back to ``GGPM_COORDINATOR`` / ``GGPM_NUM_PROCESSES`` /
    ``GGPM_PROCESS_ID``; a no-op (returns 0) when neither arguments nor
    variables name a coordinator.  ``coordinator`` is ``host:port`` (a
    TCP rendezvous) or a URL (``tcp://…``, ``file://…``).  The backend is
    ``backend`` where given, else NCCL for a CUDA ``device`` and gloo for
    the CPU."""
    coordinator = coordinator or os.environ.get('GGPM_COORDINATOR')
    if num_processes is None and 'GGPM_NUM_PROCESSES' in os.environ:
        num_processes = int(os.environ['GGPM_NUM_PROCESSES'])
    if process_id is None and 'GGPM_PROCESS_ID' in os.environ:
        process_id = int(os.environ['GGPM_PROCESS_ID'])
    if not coordinator:
        return 0
    if num_processes is None or process_id is None:
        raise ValueError('a coordinator needs the process count and this '
                         'process\'s index (--dist-nprocs, --dist-pid or '
                         'GGPM_NUM_PROCESSES, GGPM_PROCESS_ID)')
    url = coordinator if '://' in coordinator else f'tcp://{coordinator}'
    if backend is None:
        backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def process_count() -> int:
    """The processes of the group (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(tp: int = 1):
    """A mesh over every rank of the group, each rank a process that reads
    its own input (``mesh.Mesh`` with ``n_proc`` the world): 1-D, as the
    ``Trainer`` takes it; with ``tp`` above 1 the grid that the
    ``Trainer`` refuses, as the JAX package refuses TP over several
    processes."""
    from .mesh import Mesh
    world = process_count()
    return Mesh(dp=world // tp, tp=tp, n_proc=world)


def global_device_batch(local_batch, mesh=None):
    """This rank's batch, as it is: each rank computes on its own, and the
    step's all-reduce joins them (JAX builds one global array)."""
    return local_batch


def replicate_global(x, mesh=None, device=None, check: bool = False
                     ) -> torch.Tensor:
    """``x`` (the vocab mask, the same host data on every rank) as a tensor
    on ``device``; with ``check``, broadcast rank 0's copy and raise where
    this rank's differs."""
    t = torch.as_tensor(x, device=device)
    if check and dist.is_initialized():
        ref = t.to(torch.uint8) if t.dtype == torch.bool else t.clone()
        dist.broadcast(ref, 0)
        ref = ref.to(t.dtype)
        if not torch.equal(ref, t):
            raise ValueError(f'rank {dist.get_rank()}: replicated value '
                             f'differs from rank 0\'s')
    return t
