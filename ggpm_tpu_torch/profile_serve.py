"""Where the time of one ``/encode``, of a decode and of an ``/optimize``
goes on a GPU.

    python -m ggpm_tpu_torch.profile_serve [--propose-sweep] [--hier]
        [--out PATH]

Encode: host tensorization, the encoder's wall time on the device, the
device's busy and idle share (of the encoder alone and of the whole
request), and the kernels by device time.  Decode (``profile_decode``): the
greedy decode of the first 64 and of the first 120 in-vocab HOPV
molecules' latents through the turbo path (which ``/reconstruct`` takes)
and through the exact path, with wall time, molecules/s, the host's split
between chemistry and the rest, and the device's busy and idle share.
``--propose-sweep`` adds ``propose_sweep`` at both sizes: how the turbo
path's lookahead and ladder were chosen, and what ``chunk`` gives.
``profile_optimize`` (one ``/optimize`` of the 64 molecules under a
policy; chip_smoke.py runs it at ``OPTIMIZE_SETTINGS``) has no flag here.
``--hier`` adds ``hier_profiles``: the trained ``hier-prop`` checkpoint's
encode of the 64 molecules (host tensorize ms, encode wall ms, device busy
ms, ``nei_sum`` and ``gather_rows`` launches an encode by the wrappers and
by the device events) and its decode of their latents, exact and turbo
(``profile_decode``'s ``hier`` and ``hier-turbo`` paths).  Prints one JSON object (and writes it to ``--out`` if given).  Needs a CUDA device;
it has no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import serve
from .bridge import load_model
from .data.batching import to_model_batch
from .data.dataset import prune_to_vocab, read_csv_data
from .graph.mol_graph import tensorize
from .graph.vocab import common_atom_vocab
from .latent.control import LatentOptimizer
from .models import decode, inc_graph
from .models.api import encode
from .ops import (KERNEL_FUNCTIONS, device_launches, gather_rows, nei_sum,
                  transpose_sum)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MOLS = 64      # the request chip_smoke.py sends
N_DECODE = 120   # the decode measurement (ROADMAP A1)
REPS = 10
HIER_CKPT = os.path.join(_ROOT, 'runs', 'QUALITY_hier_hopv.json.ckpt')
HIER_VOCAB = os.path.join(_ROOT, 'runs', 'QUALITY_hier_hopv.json.vocab.txt')
_WRAPPERS = (nei_sum, transpose_sum, gather_rows)
# /optimize's targets in chip_smoke.py: each molecule's own HOMO + 0.01
# and LUMO - 0.01 (Hartree), and each policy's settings, which the golden
# goldens/optimize_hopv64.json records.  Fixed on the CPU before any card
# run.  ``hard`` goes over HTTP, whose body carries the policy only: the
# JAX defaults (lr 1, 50 steps of the batch mean), which move the latents
# by at most 4e-3 and change no decode.  ``soft`` and ``patience`` go
# through GgpmServer.optimize.  The search's step always lowers the
# prediction (the sign rule), so a row's loss mostly grows and its
# patience runs out; with the default patience_threshold 0.1 a row whose
# loss falls by more than a tenth keeps its patience, and at every
# latent_lr that changes decodes (100 and above) this makes the search
# chaotic: latents perturbed by 1e-6 come out 100 and more apart.
# patience_threshold 1.0 spends patience at every step (a loss falls by at
# most all of itself), so each row takes exactly ``patience`` (5) steps
# unless soft's delta stops it first: a continuous map of the latents,
# 1e-6 in, at most 1.2e-5 out in the predictions.  latent_lr 500 then
# changes 35 (soft) and 38 (patience) of the 64 decodes; property_delta
# 2e-4, near the median first loss (5.4e-4 over the 64), stops 22 rows by
# delta under soft.  property_optim_step only sets the loop's cap here.
OPTIMIZE_OFFSETS = {'homo': 0.01, 'lumo': -0.01}
OPTIMIZE_SETTINGS = {
    'hard': {},
    'soft': dict(latent_lr=500.0, property_delta=2e-4,
                 property_optim_step=50, patience_threshold=1.0),
    'patience': dict(latent_lr=500.0, property_delta=2e-4,
                     property_optim_step=50, patience_threshold=1.0),
}


def _device_us(event) -> float:
    # the attribute's name changed across PyTorch releases
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def kernel_of(key: str):
    """Which of the port's kernels a profiler event of a device kernel is,
    by the names of its ``__global__`` functions in its source
    (``ops.KERNEL_FUNCTIONS``); None for any other."""
    for name, functions in KERNEL_FUNCTIONS.items():
        if any(f in key for f in functions):
            return name
    return None


@dataclass
class DeviceEvents:
    """The device events of one name in a profiled run: ``key`` the name,
    ``count`` the launches, ``self_device_time_total`` their µs, and
    ``graph_count`` the launches made by CUDA graph replays (the events
    whose correlation id is a ``cudaGraphLaunch`` call's)."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0
    graph_count: int = 0


def profiled(fn, reps: int = 1, ran: Optional[Dict[str, int]] = None):
    """Device busy µs per run of ``fn`` and its device events by name
    (``DeviceEvents``), from torch.profiler tracing the device alone: a
    CPU op's self device time repeats its kernels' own, and the host's
    events would only add to the processing.  The events are summed from
    the profiler's raw records: ``key_averages`` builds a Python object a
    record, about 60 µs each, a minute for a hier training epoch's
    920,000.  A kernel that a graph replay launched shares its correlation
    id with the replay's ``cudaGraphLaunch`` runtime event.  With ``ran``
    (a dict), fills it with each port kernel's launches that ran in the
    runs by the kernels' own device counts (``ops.device_launches``): the
    profiler loses a record now and then (``profiler_loss``)."""
    before = device_launches() if ran is not None else None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
    if ran is not None:
        ran.update({k: v - before[k] for k, v in device_launches().items()})
    by_name, corrs, graph_launches = {}, {}, set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            agg = by_name.setdefault(e.name(), DeviceEvents(e.name()))
            agg.count += 1
            agg.self_device_time_total += e.duration_ns() / 1e3
            corrs.setdefault(e.name(), []).append(e.correlation_id())
        elif e.name().startswith('cudaGraphLaunch'):
            graph_launches.add(e.correlation_id())
    if graph_launches:
        for name, agg in by_name.items():
            agg.graph_count = sum(c in graph_launches for c in corrs[name])
    events = list(by_name.values())
    return sum(_device_us(e) for e in events) / reps, events


def profiler_loss(device: Dict[str, float], ran: Dict[str, float]
                  ) -> Dict[str, float]:
    """Per port kernel whose profiler records (``device``, launches by
    kernel) differ from the launches that ran (``ran``, from
    ``profiled``): the records the profiler lost, ``ran - device``.  On
    the card (chip_smoke.py) it lost one of a replayed step's 20
    ``gather_rows`` records in every window of a signature, 15 of a
    decode's 1,237 ``nei_sum`` records and 364 of an epoch's 105,600.  A
    negative entry (more records than launches) is no loss but a fault."""
    return {k: ran[k] - device.get(k, 0) for k in ran
            if ran[k] != device.get(k, 0)}


def by_kernel(events, attr: str = 'count') -> Dict[str, float]:
    """The port kernels' device records in ``events`` (``profiled``),
    summed by kernel: their launches, or with ``attr='graph_count'`` those
    made by graph replays."""
    out = {w.__name__: 0 for w in _WRAPPERS}
    for e in events:
        if kernel_of(e.key):
            out[kernel_of(e.key)] += getattr(e, attr)
    return out


def top_kernels(events, reps: int = 1, n: int = 12):
    top = sorted(events, key=_device_us, reverse=True)[:n]
    return [dict(name=e.key[:80], count=e.count / reps,
                 device_us=_device_us(e) / reps) for e in top]


@contextlib.contextmanager
def _timed(owner, name: str, acc: dict, sync: bool = False):
    """Add the seconds spent in ``owner.name`` (a module's function or a
    class's method, which the callers look up by name) to ``acc[name]``
    while the block runs; with ``sync``, each call ends in a synchronize,
    so that its device work counts in it."""
    fn = getattr(owner, name)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            return out
        finally:
            acc[name] += time.perf_counter() - t0
    acc.setdefault(name, 0.0)
    setattr(owner, name, wrapped)
    try:
        yield acc
    finally:
        setattr(owner, name, fn)


def profile_decode(model, vocab, z, path: str = 'turbo', **decode_kwargs
                   ) -> dict:
    """One greedy decode of latents ``z`` on the card through ``path``:
    ``turbo`` (``decode_motif_turbo``, which ``/reconstruct`` and
    ``/sample`` take), ``exact`` (``decode_motif`` without logs) or, for a
    hier model, ``hier-turbo`` (``decode_hier_turbo``, which the family's
    ``/reconstruct`` and ``/sample`` take) and ``hier`` (the exact
    ``decode_hier`` without logs), after one untimed decode of the same
    latents (first use of the shapes on the card, the turbo paths' graph
    captures, the chemistry's caches).

    From the timed run (host clock, ending in a synchronize): wall time,
    molecules/s, and the host split: seconds in the chemistry
    (``_try_assemble``; for ``hier-turbo`` the ``IncGraph`` calls of the
    replays and of the exact path) and the rest, and of the rest in
    writing the SMILES (``IncGraph.get_smiles``); ``nei_sum`` launches; for
    ``exact`` and ``hier`` its steps (and for ``hier`` its ``hdec_assm``
    calls); for the turbo paths the rounds, fallbacks, rungs, pending
    samples, steps active and run per round, the steps run outside the
    rounds, and the seconds waiting for traces and replaying them (for
    ``hier-turbo`` also the exact path's steps, the ``nei_sum`` launches
    the decode must make, ``expected_nei_sum_launches``: four a propose
    step run, eager or replayed, five an exact step, and one profiled
    propose round, ``profile_round``).  From a profiled repeat: device
    busy time, kernel launches, and ``nei_sum_kernel``'s device launches
    (of them, those made by CUDA graph replays) and µs per launch, beside
    the launches the ``nei_sum`` wrapper counted in it, those that ran by
    the kernel's own device count (``nei_sum_ran``) and the records the
    profiler lost (``profiler_lost``, ``profiler_loss``).  The idle share
    is one minus busy over the unprofiled wall time."""
    paths = ('turbo', 'exact', 'hier', 'hier-turbo')
    if path not in paths:
        raise ValueError(f'profile_decode: no decode path {path!r}')
    turbo = path in ('turbo', 'hier-turbo')

    def run():
        if path == 'turbo':
            out = decode.decode_motif_turbo(model, vocab, common_atom_vocab,
                                            z, greedy=True, **decode_kwargs)
        elif path == 'hier-turbo':
            out = decode.decode_best(model, vocab, common_atom_vocab, z,
                                     greedy=True, **decode_kwargs)
        elif path == 'hier':
            out = decode.decode_hier(model, vocab, common_atom_vocab, z,
                                     greedy=True, log_steps=False,
                                     **decode_kwargs)
        else:
            out = decode.decode_motif(model, vocab, common_atom_vocab, z,
                                      greedy=True, log_steps=False,
                                      **decode_kwargs)
        torch.cuda.synchronize()
        return out

    run()
    launches = nei_sum.launches
    chem_calls = ('get_assm_cands', 'try_add_mol', 'add_mol') \
        if path == 'hier-turbo' else ()
    with contextlib.ExitStack() as timers:
        acc = timers.enter_context(_timed(decode, '_try_assemble', {}))
        for name in chem_calls + ('get_smiles',):
            timers.enter_context(_timed(inc_graph.IncGraph, name, acc))
        t0 = time.perf_counter()
        results, smiles = run()
        wall = time.perf_counter() - t0
    launches = nei_sum.launches - launches
    stats = dict(decode.TURBO_STATS if turbo else decode.HIER_STATS)
    counted, ran = nei_sum.launches, {}
    busy_us, events = profiled(run, ran=ran)
    counted = nei_sum.launches - counted
    nei = [e for e in events if 'nei_sum_kernel' in e.key]
    chem = acc['_try_assemble']
    if path == 'hier-turbo':
        chem = sum(acc[name] for name in chem_calls + ('get_smiles',))
    out = dict(path=path, n_mols=len(smiles), wall_s=wall,
               mols_per_s=len(smiles) / wall,
               valid=sum(s is not None for s in smiles),
               chemistry_s=chem, smiles_s=acc['get_smiles'],
               rest_s=wall - chem,
               device_busy_ms=busy_us / 1e3,
               device_idle_share=1.0 - busy_us / 1e6 / wall,
               device_launches=sum(e.count for e in events),
               nei_sum_launches=launches,
               nei_sum_device_launches=sum(e.count for e in nei),
               nei_sum_graph_device_launches=sum(e.graph_count for e in nei),
               profiled_nei_sum_launches=counted,
               nei_sum_ran=ran['nei_sum'],
               profiler_lost=profiler_loss(by_kernel(events), ran),
               nei_sum_device_us_per_launch=(
                   sum(_device_us(e) for e in nei) / sum(e.count for e in nei)
                   if nei else None),
               top_device_kernels=top_kernels(events, n=8))
    if turbo:
        out.update(
            {k: stats[k] for k in ('rounds', 'fallbacks', 'rungs',
                                   'pending_per_round', 'steps',
                                   'steps_run', 'eager_steps', 'wait_s',
                                   'replay_s')},
            other_host_s=wall - sum(stats['wait_s']) - sum(stats['replay_s']))
    if path == 'hier-turbo':
        out.update(exact_steps=stats['exact_steps'],
                   expected_nei_sum_launches=hier_turbo_launches(stats),
                   smiles=smiles,
                   round=profile_round(model, vocab, z, **decode_kwargs))
    elif not turbo:
        steps = decode.decode_steps(results)
        out.update(steps=steps, ms_per_step=1e3 * wall / steps,
                   chemistry_ms_per_step=1e3 * chem / steps)
        if path == 'hier':
            out.update(assm_calls=stats['assm_calls'],
                       nei_sum_per_step=launches / steps, smiles=smiles)
    return out


def hier_turbo_launches(stats: dict) -> int:
    """``nei_sum`` launches of a ``decode_hier_turbo`` call from its
    ``TURBO_STATS``: four a propose step, run eagerly (the step before each
    graph's capture) or replayed from a graph (``steps_run``, the
    lookahead's steps past the last active one included), and five a step
    of the exact path that the samples which fell back take.  A capture itself
    launches nothing."""
    return 4 * (sum(stats['steps_run']) + stats['eager_steps']) + \
        5 * stats['exact_steps']


def profile_round(model, vocab, z, max_decode_step: int = 150,
                  beam: int = 5) -> dict:
    """One propose round of the hier turbo decode over ``z`` (the
    ``HierProposer`` of that width at the full rung, replayed from its
    captured graph as ``decode_hier_turbo`` runs it, after an unprofiled
    round) under the profiler: steps run, host ms a step (the round's wall
    time over its steps), device busy ms a step, device launches a step
    and ``nei_sum_kernel``'s device launches a step."""
    z = torch.as_tensor(z, device='cuda')
    tabs, mask = decode._device_vocab(vocab, common_atom_vocab, z.device)
    with torch.inference_mode():
        prop = decode._proposer(
            decode.HierProposer, model, vocab, mask, tabs, beam,
            max_decode_step, len(z),
            budgets=decode.hier_budgets(vocab, common_atom_vocab))
    queued = []

    def run():
        with torch.inference_mode():
            queued.append(decode.propose_round(prop, z)[1])
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    busy_us, events = profiled(run)
    steps = queued[-1]
    return dict(steps_run=steps, host_ms_per_step=1e3 * wall / steps,
                device_ms_per_step=busy_us / 1e3 / steps,
                device_idle_share=1.0 - busy_us / 1e6 / wall,
                device_launches_per_step=sum(e.count for e in events) / steps,
                nei_sum_device_launches_per_step=sum(
                    e.count for e in events if 'nei_sum_kernel' in e.key) /
                steps)


def optimize_targets(rows):
    """The /optimize targets of ``rows`` (SMILES, HOMO, LUMO)."""
    return ([r[1] + OPTIMIZE_OFFSETS['homo'] for r in rows],
            [r[2] + OPTIMIZE_OFFSETS['lumo'] for r in rows])


def profile_optimize(server, rows, policy: str, **opt_kwargs) -> dict:
    """One ``/optimize`` of ``rows`` through ``server.optimize`` (a
    ``GgpmServer`` on the card) under ``policy``, after one untimed
    request.  From a timed request, its steps each ending in a
    synchronize: wall seconds; host tensorize ms; encode ms; search ms
    (``LatentOptimizer.optimize``), the iterations it ran and the rows it
    stopped by delta and by patience; decode seconds with the host split
    of ``profile_decode``, and the rest.  From a profiled request: the
    device's busy ms, idle share and launches, the kernel wrappers' launch
    counts beside ``nei_sum_kernel``'s device events and the launches
    that ran by the kernels' own device counts (``ran``, with the records
    the profiler lost, ``profiler_lost``), the turbo path's rounds and
    steps, the search's stats and the answer; and from the search alone,
    profiled, its device busy ms, idle share and launches.  Each idle share
    is one minus the busy time over the wall time of the same profiled
    run."""
    smiles = [r[0] for r in rows]
    homo, lumo = optimize_targets(rows)
    answers, walls = [], []

    def run():
        t0 = time.perf_counter()
        answers.append(server.optimize(smiles, homo, lumo, policy,
                                       **opt_kwargs))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    run()
    acc: dict = {}
    with _timed(serve, 'tensorize', acc), \
            _timed(serve, '_encode', acc, sync=True), \
            _timed(LatentOptimizer, 'optimize', acc, sync=True), \
            _timed(serve, 'decode_best', acc, sync=True), \
            _timed(decode, '_try_assemble', acc), \
            _timed(inc_graph.IncGraph, 'get_smiles', acc):
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    before, ran = {k.__name__: k.launches for k in _WRAPPERS}, {}
    busy_us, events = profiled(run, ran=ran)
    profiled_wall = walls[-1]
    launches = {k.__name__: k.launches - before[k.__name__]
                for k in _WRAPPERS}
    turbo, st = dict(decode.TURBO_STATS), dict(server.search_stats)
    z = server._encode_smiles(smiles)
    opt = LatentOptimizer(server.model, optimize_type=policy, **opt_kwargs)

    def search():
        t0 = time.perf_counter()
        opt.optimize(z, homo, lumo)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    search_busy_us, search_events = profiled(search)
    nei = [e for e in events if 'nei_sum_kernel' in e.key]
    search_ms = 1e3 * acc['optimize']
    return dict(
        policy=policy, settings=opt_kwargs, n_mols=len(rows), wall_s=wall,
        tensorize_ms=1e3 * acc['tensorize'], encode_ms=1e3 * acc['_encode'],
        search_ms=search_ms, iterations=st['iterations'],
        stopped_by_delta=len(st['by_delta']),
        stopped_by_patience=len(st['by_patience']),
        search_ms_per_iteration=search_ms / max(st['iterations'], 1),
        decode_s=acc['decode_best'], chemistry_s=acc['_try_assemble'],
        smiles_s=acc['get_smiles'],
        other_s=wall - sum(acc[k] for k in ('tensorize', '_encode',
                                            'optimize', 'decode_best')),
        **{k: turbo[k] for k in ('rounds', 'fallbacks', 'steps_run',
                                 'eager_steps')},
        device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e6 / profiled_wall,
        device_launches=sum(e.count for e in events),
        launches=launches,
        nei_sum_device_launches=sum(e.count for e in nei),
        ran=ran, device=by_kernel(events),
        profiler_lost=profiler_loss(by_kernel(events), ran),
        search_device_busy_ms=search_busy_us / 1e3,
        search_device_idle_share=1.0 - search_busy_us / 1e6 / walls[-1],
        search_device_launches=sum(e.count for e in search_events),
        top_device_kernels=top_kernels(events, n=8),
        search=st, answer=answers[-1])


def propose_sweep(model, vocab, z, T: int = 150, reps: int = 5) -> dict:
    """How the turbo decode's schedule on the card was chosen: one free
    propose round's wall ms over latents ``z`` replayed from a CUDA graph
    with each lookahead (median of ``reps``, host clock ending in a
    synchronize), with the capture's seconds and the steps active and run;
    the same round eagerly; then a whole turbo decode's wall seconds under
    each ladder, and unchunked against chunks of a third of the batch, in
    turns (``reps`` each), with the seconds waiting for traces and
    replaying them."""
    dev = next(model.parameters()).device
    tabs, mask = decode._device_vocab(vocab, common_atom_vocab, dev)
    pins = np.zeros((3, T, z.shape[0]), np.int64)
    rows = []
    with torch.inference_mode():
        for graph, ahead in ((False, 0), (True, 0), (True, 1), (True, 2)):
            t0 = time.perf_counter()
            prop = decode.Proposer(model, mask, tabs, 5, T, z.shape[0],
                                   graph=graph)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            times = []
            for _ in range(reps if graph else 1):
                t0 = time.perf_counter()
                (*_, n_run), queued = decode.propose_round(prop, z, pins,
                                                           ahead)
                times.append(1e3 * (time.perf_counter() - t0))
            rows.append(dict(graph=graph, lookahead=ahead,
                             capture_s=capture_s,
                             round_ms=float(np.median(times)),
                             steps=n_run, steps_run=queued))
            del prop
    ladders = {}
    for ladder in ((), (64,), (32, 64)):
        decode.decode_motif_turbo(model, vocab, common_atom_vocab, z,
                                  ladder=ladder, max_decode_step=T)
        t0 = time.perf_counter()
        decode.decode_motif_turbo(model, vocab, common_atom_vocab, z,
                                  ladder=ladder, max_decode_step=T)
        torch.cuda.synchronize()
        ladders[str(ladder)] = dict(wall_s=time.perf_counter() - t0,
                                    **{k: decode.TURBO_STATS[k] for k in (
                                        'rounds', 'rungs', 'steps',
                                        'steps_run')})
    chunks = []
    for rep in range(reps + 1):          # the first turn captures, untimed
        for chunk in (None, -(-z.shape[0] // 3)):
            t0 = time.perf_counter()
            decode.decode_motif_turbo(model, vocab, common_atom_vocab, z,
                                      max_decode_step=T, chunk=chunk)
            torch.cuda.synchronize()
            st = decode.TURBO_STATS
            if rep:
                chunks.append(dict(chunk=chunk,
                                   wall_s=time.perf_counter() - t0,
                                   wait_s=sum(st['wait_s']),
                                   replay_s=sum(st['replay_s'])))
    return dict(batch=z.shape[0], T=T, rounds=rows, ladders=ladders,
                chunks=chunks)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--ckpt', default=os.path.join(_ROOT, 'runs',
                                                   'QUALITY_hopv.json.ckpt'))
    ap.add_argument('--vocab', default=os.path.join(
        _ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt'))
    ap.add_argument('--data', default=os.path.join(_ROOT, 'data',
                                                   'hopv15.csv'))
    ap.add_argument('--out', default=None)
    ap.add_argument('--propose-sweep', action='store_true')
    ap.add_argument('--hier', action='store_true',
                    help='also profile the hier-prop checkpoint\'s encode '
                         'and decodes (exact and turbo) of the 64 molecules')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_serve needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False

    model, vocab = load_model(args.ckpt, args.vocab, device='cuda')
    all_rows = prune_to_vocab(read_csv_data(args.data), vocab,
                              verbose=False)[:N_DECODE]
    rows = all_rows[:N_MOLS]
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    out = dict(device=smi.strip().splitlines()[0],
               decode=decode_profiles(model, vocab, all_rows,
                                      args.propose_sweep),
               **encode_profile(model, vocab, rows))
    if args.hier:
        hmodel, hvocab = load_model(HIER_CKPT, HIER_VOCAB, device='cuda')
        hrows = prune_to_vocab(read_csv_data(args.data), hvocab,
                               verbose=False)[:N_MOLS]
        out['hier'] = hier_profiles(hmodel, hvocab, hrows)
        out['hier']['decode_turbo'] = profile_decode(
            hmodel, hvocab, hier_latents(hmodel, hvocab, hrows),
            'hier-turbo')
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text + '\n')
    return out


def decode_profiles(model, vocab, rows, sweep: bool) -> dict:
    """``profile_decode`` of both paths (and ``propose_sweep`` if
    ``sweep``) at the first 64 and at all of ``rows``."""
    out = {}
    for n in (N_MOLS, len(rows)):
        batch = to_model_batch(tensorize(rows[:n], vocab, common_atom_vocab),
                               vocab.mask, pad=False)
        z = encode(model, batch)[0]
        out[f'B{n}'] = {path: profile_decode(model, vocab, z, path)
                        for path in ('turbo', 'exact')}
        if sweep:
            out[f'B{n}']['propose_sweep'] = propose_sweep(model, vocab, z)
    return out


def encode_profile(model, vocab, rows) -> dict:
    """The encode of ``rows`` as ``/encode`` and ``/properties`` run it
    (``/encode`` alone for a model without property heads): host
    tensorization, the encode's wall and device busy ms, the device's idle
    share, and each kernel's launches an encode by its wrapper and by the
    profiler's device events."""
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                               vocab.mask, pad=False)
        host_s.append(time.perf_counter() - t0)
    heads = hasattr(model, 'predict_properties')

    def run():
        z, _ = encode(model, batch)
        if heads:
            with torch.no_grad():
                model.predict_properties(z)
        torch.cuda.synchronize()

    for _ in range(3):
        run()
    wall_s = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        wall_s.append(time.perf_counter() - t0)

    # the profiler slows the host: busy time comes from it, wall time and
    # idle share from the unprofiled runs above
    before = {k.__name__: k.launches for k in _WRAPPERS}
    busy_us, events = profiled(run, REPS)
    nei = [e for e in events if 'nei_sum_kernel' in e.key]
    device = {k: n / REPS for k, n in by_kernel(events).items()}
    return dict(
        n_mols=len(rows),
        tree_shape=dict(nodes=int(batch['tree']['fnode'].shape[0]),
                        messages=int(batch['tree']['fmess'].shape[0])),
        graph_shape=dict(atoms=int(batch['graph']['fnode'].shape[0]),
                         messages=int(batch['graph']['fmess'].shape[0])),
        host_tensorize_ms=1e3 * float(np.median(host_s)),
        encode_wall_ms=1e3 * float(np.median(wall_s)),
        device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e6 / float(np.median(wall_s)),
        request_device_idle_share=1.0 - busy_us / 1e6 / (
            float(np.median(host_s)) + float(np.median(wall_s))),
        device_launches_per_encode=sum(e.count for e in events) / REPS,
        launches_per_encode={k.__name__: (k.launches - before[k.__name__])
                             / REPS for k in _WRAPPERS},
        device_launches_per_encode_by_kernel=device,
        nei_sum_device_us_per_launch=(
            sum(_device_us(e) for e in nei) / sum(e.count for e in nei)
            if nei else None),
        top_device_kernels=top_kernels(events, REPS))


def hier_latents(model, vocab, rows) -> torch.Tensor:
    """The latents [len(rows), latent] of ``rows`` by a hier ``model``."""
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    return encode(model, batch)[0]


def hier_profiles(model, vocab, rows) -> dict:
    """The hier family's serve path on the card: ``encode_profile`` of
    ``model`` (the trained ``hier-prop`` checkpoint on the card) over
    ``rows`` (SMILES, HOMO, LUMO), and ``profile_decode``'s ``hier`` path
    over their latents (the exact decode, which beam and logged decodes
    and the turbo path's fallbacks take)."""
    return dict(encode=encode_profile(model, vocab, rows),
                decode=profile_decode(model, vocab,
                                      hier_latents(model, vocab, rows),
                                      'hier'))


if __name__ == '__main__':
    main()
