"""The data-parallel and dp×tp training steps of the canonical
configuration against the JAX package's, for chip_smoke.py phase 16 and
tests/test_torch_parallel.py.

``golden_groups`` gives the first ``GOLDEN_STEPS`` groups of ``DP`` HOPV
batches that the JAX ``Trainer`` on a ``DP``-device mesh steps through
over HOPV batches 0-5 (flushes by shape signature, each in groups of
``DP``, a short one cycled): (0, 1), (2, 4), (3, 3).
``goldens/train_dp2_hopv.json`` holds JAX's ``make_dp_train_step`` on them
(written by ``tests/test_torch_parallel.py``), in the layout of
``goldens/train_hopv.json``, so ``profile_train.check_golden`` holds a
rank's ``golden_steps`` to it.  ``run_ranks`` spawns the ranks of one run
on this host (gloo on the CPU, or gloo with every rank on the one card:
NCCL refuses two ranks a card), each running ``rank_main``, and returns
what each rank reports: its steps, a digest of its whole parameters (equal
on every rank, bit for bit), the collectives it called, its kernels'
launches and, on a dp×tp mesh, the rows of each split leaf and of its
moments it holds.  ``emulated_steps`` takes the same steps in one process
without a collective: on one kind of device ``DP`` ranks end on its
parameters bit for bit, which holds the data-parallel path to the
one-device arithmetic exactly, whatever that arithmetic's distance from
JAX's.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.multiprocessing as mp

from . import profile_train
from .bridge import flatten, to_flax_tree
from .data.batching import compact_plan_dict, to_model_batch
from .parallel import mesh as pmesh
from .parallel.distributed import init_distributed
from .train.loop import flushes, signature

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_ROOT, 'ggpm_tpu_torch', 'goldens',
                      'train_dp2_hopv.json')
DP = 2
N_BATCHES = 6
GOLDEN_STEPS = 3


def golden_groups(vocab=None):
    """The HOPV vocab, its first ``N_BATCHES`` batches and the first
    ``GOLDEN_STEPS`` groups (batch indices) that a ``DP``-rank epoch over
    them steps."""
    vocab, mbs = profile_train.hopv_batches(N_BATCHES, vocab)
    sigs = []
    for mb in mbs:
        b = to_model_batch(mb, vocab.mask, pad=False)
        sigs.append(signature(dict(b, plan=compact_plan_dict(
            {k: np.asarray(v) for k, v in b['plan'].items()}))))
    groups = [g for flush in flushes(range(len(mbs)), lambda i: sigs[i])
              for g in pmesh.dp_groups(flush, DP)]
    return vocab, mbs, groups[:GOLDEN_STEPS]


def golden_steps(trainer, mbs, groups) -> List[dict]:
    """A rank's ``dp_step`` on each group of ``groups`` (indices into
    ``mbs``): the step's metrics (the ranks' mean) and per leaf its update
    along the mean gradient (``profile_train.update_norms``)."""
    steps = []
    for group in groups:
        with trainer.gathered():
            before = flatten(to_flax_tree(trainer.model))
        metrics, _ = trainer.dp_step([mbs[i] for i in group])
        grads = flatten(to_flax_tree(trainer.model, lambda p: p.grad))
        with trainer.gathered():
            after = flatten(to_flax_tree(trainer.model))
        steps.append(dict({k: float(v[0]) for k, v in sorted(
            metrics.items())}, update_norms=profile_train.update_norms(
                before, after, grads)))
    return steps


def emulated_steps(device: str) -> Tuple[List[dict], str]:
    """``golden_steps`` of one process without a mesh or a collective: each
    group's batches' gradients computed one after the other, their mean
    (sum, then halved, as the ranks' all-reduce and division give it) fed
    to the update.  Returns the steps and ``params_digest``: ``DP`` ranks
    on one kind of device must end on this digest bit for bit."""
    trainer, vocab = profile_train.canonical_trainer(device)
    vocab, mbs, groups = golden_groups(vocab)
    state = trainer.opt_state
    steps = []
    for group in groups:
        before = flatten(to_flax_tree(trainer.model))
        grads, metrics = [], []
        for i in group:
            db = trainer.device_batch(trainer.host_batch(mbs[i]))
            trainer.model.train()
            for p in state.params:
                p.grad = None
            loss, m, _ = trainer.model(db, trainer.beta, perturb_z=False,
                                       generator=trainer.gen)
            loss.backward()
            grads.append(state.flat_grad())
            metrics.append({k: v.detach() for k, v in m.items()})
        g = torch.stack(grads).sum(0).div_(len(group))
        offset = 0
        for p in state.params:
            p.grad = g[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        gnorm = state.update(g)
        state.advance()
        steps.append(dict(
            {k: float(sum(m[k] for m in metrics) / len(group))
             for k in sorted(metrics[0])}, GNorm=float(gnorm),
            update_norms=profile_train.update_norms(
                before, flatten(to_flax_tree(trainer.model)),
                flatten(to_flax_tree(trainer.model, lambda p: p.grad)))))
    return steps, params_digest(trainer)


def params_digest(trainer) -> str:
    """SHA-256 of the model's whole parameters (a collective on a dp×tp
    mesh)."""
    h = hashlib.sha256()
    with trainer.gathered():
        for k, v in sorted(flatten(to_flax_tree(trainer.model)).items()):
            h.update(k.encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def rank_main(rank: int, world: int, tp: int, url: str, out_dir: str,
              device: str, backend: str) -> None:
    """One rank of ``run_ranks``: the canonical trainer on a ``world/tp``
    × ``tp`` mesh, its ``golden_steps``, written to
    ``out_dir/rank<rank>.json``."""
    if device == 'cpu':
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init_distributed(url, world, rank, device=device, backend=backend)
    try:
        t0 = time.perf_counter()
        mesh = (pmesh.make_mesh_2d(world // tp, tp) if tp > 1
                else pmesh.make_mesh(world))
        trainer, vocab = profile_train.canonical_trainer(device, mesh=mesh)
        vocab, mbs, groups = golden_groups(vocab)
        before = {k: w.launches for k, w in profile_train.KERNELS.items()}
        reduces, gathers = pmesh.all_reduce.calls, pmesh.all_gather.calls
        t1 = time.perf_counter()
        steps = golden_steps(trainer, mbs, groups)
        if device != 'cpu':
            torch.cuda.synchronize()
        out = dict(
            rank=rank, world=world, tp=tp, backend=backend, groups=groups,
            steps=steps, steps_s=time.perf_counter() - t1,
            setup_s=t1 - t0, digest=params_digest(trainer),
            all_reduces=pmesh.all_reduce.calls - reduces,
            all_gathers=pmesh.all_gather.calls - gathers,
            launches={k: w.launches - before[k]
                      for k, w in profile_train.KERNELS.items()},
            shards={name: [int(t.shape[0]) for t in bufs]
                    for name, bufs in getattr(trainer.opt_state, 'shards',
                                              dict)().items()})
        with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(world: int, tp: int = 1, device: str = 'cpu',
              backend: str = 'gloo') -> List[dict]:
    """Spawn ``world`` ranks of ``rank_main`` on this host (all on
    ``device``), wait for them and return their reports in rank order.
    Any rank's failure raises."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(
            world, tp, f'file://{tmp}/rendezvous', tmp, device, backend),
            nprocs=world, start_method='spawn')
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f'rank{r}.json')) as f:
                out.append(json.load(f))
    return out


def check_ranks(reports: List[dict], golden: dict,
                expect_shards: Optional[dict] = None,
                update_steps: Optional[int] = None) -> List[str]:
    """Where the ranks' reports break the golden rule
    (``profile_train.check_golden``, the prop rule; the leaves' updates
    held at the first ``update_steps`` steps only where it is given),
    differ from each other in their parameters, or hold other rows of a
    split leaf than ``expect_shards`` (name -> rows)."""
    bad = [f'rank {r["rank"]}: {b}' for r in reports
           for b in profile_train.check_golden(r['steps'], golden,
                                               update_steps=update_steps)]
    if len({r['digest'] for r in reports}) != 1:
        bad.append(f'parameters differ across ranks: '
                   f'{[r["digest"][:12] for r in reports]}')
    for r in reports:
        if r['all_reduces'] != len(r['steps']):
            bad.append(f'rank {r["rank"]}: {r["all_reduces"]} all-reduces '
                       f'in {len(r["steps"])} steps')
        if expect_shards is not None and {
                k: v for k, v in r['shards'].items()} != expect_shards:
            bad.append(f'rank {r["rank"]}: holds {r["shards"]}, expected '
                       f'{expect_shards}')
    return bad
