#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing one line with its seconds; any failure raises and the
script exits non-zero:

1. device  — a CUDA device must be present (else exit 1 with no result);
             prints ``nvidia-smi``'s name and power limit; TF32 off.
2. build   — compiles every kernel of ``ggpm_tpu_torch/csrc`` with nvcc
             into ``build/`` (one nvcc per source, started together).
3. load    — the trained HOPV prop-opt model and vocab through the bridge,
             and the first 120 in-vocab molecules of ``data/hopv15.csv``
             (the first 64 are the request).
4. kernel  — each kernel against its plain PyTorch version on the card, at
             the shapes the serve path gives it (the 64 molecules' tables),
             at that tree tiled 64 times (a 4,096-molecule request), over
             the neighbour widths A = 1..8 at the serve width, at the
             decoder's frontier readout for B = 64 and B = 120 (state
             [500·B, 250], frontier table [B, 12] seeded from the
             molecules' trees, ``kernel_bench.frontier_graph``), and at
             ragged and large cases (``kernel_bench.measure_cases``).
             ``ms``, ``plain_ms`` and ``library_ms`` are device times
             (calls captured in a CUDA graph, replayed between CUDA
             events); ``floor_ms`` is a one-element launch in the same
             harness; ``bound_ms`` counts the distinct rows the case
             reads; ``host_ms`` is the eager back-to-back time, which the
             host's dispatch sets at small shapes.  ``kinds`` forces each
             launch kind of the kernel on the same inputs, each checked
             and timed; ``plan`` is the launch the wrapper chose.  Then
             the depth loop's row gather (``gather_rows``) at the 64
             molecules' ``bgraph`` and width 750, held bit for bit to the
             plain copy and timed alike (``kernel_bench.gather_case``).
5. serve   — ``GgpmServer`` on a free port answers ``/health``, ``/encode``
             and ``/properties`` for the 64 molecules; checks the latents,
             the kernel launch counts (each request: 2 ``nei_sum``, one
             ``gather_rows`` per depth round, no ``transpose_sum``), the
             HOMO/LUMO MAE against the JAX package's, and the latents
             against the port on the CPU.
6. decode  — the same server answers ``/reconstruct`` for the 64 molecules
             and ``/sample`` with ``{"n": 64, "seed": 0}``; the counts are
             reset just before and read just after.  Every answer is held
             to the JAX package's (``decode_best`` on the CPU, the same
             checkpoint, the JAX encoder's latents, max_decode_step 150;
             ``ggpm_tpu_torch/goldens/decode_hopv64.json``, which
             tests/test_torch_decode.py recomputes).  The rule, fixed before
             any card run: every string equals the reference's and the
             count of None is the same, except for fp32 near-ties.  For
             each string that differs, the batch is decoded again with
             per-step logs on the card and on the port's CPU path; the first
             step where ``Generate fragment`` falls on the other side of 0.5,
             or where the order of the top-5 candidates differs, is printed
             with its margin in the CPU log (|p − 0.5| or the score gap).
             The phase passes only if every such margin is below 1e-4 and
             at most 2 of the 128 strings differ.  It also reruns both
             decodes directly to count their steps, and fails unless
             ``nei_sum`` launched once per decode step (plus 2 for the
             encode of ``/reconstruct``) and ``gather_rows`` once per
             depth round of that encode.  Then, outside HTTP, it decodes
             the first 120 molecules' latents at B = 120 and prints
             molecules per second and the device's idle share
             (``profile_serve.profile_decode``).
7. train  — the canonical configuration (``prop``: LSTM, hidden = embed
             = 250, latent 24, depthT 20, batch 20, β 0.1, Adam lr 1e-3,
             clip 20) from the ``vae/`` weights of the same checkpoint,
             trained through the port's ``Trainer`` on the 17 full HOPV
             batches of 20 (``profile_train``); the counts are reset just
             before and read just after.  Its first 3 steps are held to the
             JAX package's (``ggpm_tpu_torch/goldens/train_hopv.json``,
             which tests/test_torch_train.py recomputes) by the rule in
             ``profile_train`` fixed before any card run; then it times an
             epoch (train mols/s, host ms per step, the device's idle
             share, launches per step, from ``profile_train.profile_epoch``)
             and fails unless every kernel of the step launched.  Last, each
             kernel of the step at the first batch's shapes against its
             plain version (max abs error at most 1e-5) and against its
             sum written out in the kernel's order (bit for bit), timed as
             in phase 4 (``kernel_bench.train_cases``).

The line before the last is ``nvidia-smi``'s; the one before it a JSON
object listing every kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import urllib.request

import numpy as np
import torch

from ggpm_tpu_torch import kernel_bench, profile_train
from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.chem import canon_smiles
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.kernel_bench import (device_ms, eager_ms, floor_ms,
                                         nvidia_smi)
from ggpm_tpu_torch.models.api import encode
from ggpm_tpu_torch.models.decode import decode_best, sample_prior
from ggpm_tpu_torch.ops import cuda_build, gather_rows, graph_ops, nei_sum
from ggpm_tpu_torch.ops.nei_sum import KINDS, device_plan, launch
from ggpm_tpu_torch.profile_serve import decode_steps, profile_decode
from ggpm_tpu_torch.serve import GgpmServer

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens', 'decode_hopv64.json')
TRAIN_GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                            'train_hopv.json')
N_MOLS = 64
N_DECODE = 120           # the separate decode measurement (ROADMAP A1)
SAMPLE = {'n': 64, 'seed': 0}
MAX_DECODE_STEP = 150
N_CPU_CHECK = 8
HTTP_TIMEOUT = 120

# HOMO/LUMO MAE of ggpm_tpu (JAX on the CPU, the same checkpoint) on the
# same 64 molecules against the CSV labels; tests/test_torch_serve.py
# recomputes them.
JAX_MAE = {'homo': 0.011003298468887807, 'lumo': 0.012340991850236266}
MAE_TOL = 1e-4
# 20 LSTM rounds at width 250 in another summation order than the CPU's
LATENT_ATOL = 1e-4
# a sum of at most a few values of magnitude <= 1 in another order: a few
# ulps of the sum
KERNEL_ATOL = 1e-5
# the decode rule (docstring, phase 6)
NEAR_TIE = 1e-4
MAX_DIFFERING = 2


def nei_sum_kinds(h, g):
    """Each launch kind of ``nei_sum`` forced on (h, g): its plan, max abs
    error against the plain version, and device ms; and the plan the
    wrapper chooses."""
    ref = graph_ops.nei_sum(h, g)
    out = torch.empty((g.shape[0], h.shape[1]), device=h.device)
    kinds = {}
    for kind in KINDS:
        p = device_plan(h, g, out, kind)
        err = (launch(h, g, out, p) - ref).abs().max().item()
        kinds[kind] = dict(ms=device_ms(lambda p=p: launch(h, g, out, p)),
                           max_abs_err=err, plan=dataclasses.asdict(p))
    return dataclasses.asdict(device_plan(h, g, out)), kinds


# every kernel of the port, keyed as ``profile_train.KERNELS`` (which holds
# the wrappers and their launch counts): what it replaces, where it is
# called, the paths that launch it, and the case of its row in the kernels
# line (``readout`` of phase 4, the others of the train phase)
KERNELS = {
    'nei_sum': dict(
        route='cuda', source='ggpm_tpu_torch/csrc/nei_sum.cu',
        replaces='ggpm_tpu/ops/pallas_gather.py:33', main_case='readout',
        paths=('serve', 'decode', 'train'),
        call_sites=['ggpm_tpu_torch/models/encoder.py:60 (node readout)',
                    'ggpm_tpu_torch/models/encoder.py:103 (root readout)',
                    'ggpm_tpu_torch/models/decoder.py:298 (dec_topo, '
                    'the decode frontier)',
                    'ggpm_tpu_torch/models/decoder.py:174 (_run_scan, the '
                    'teacher-forced frontier)']),
    'transpose_sum': dict(
        route='cuda', source='ggpm_tpu_torch/csrc/transpose_sum.cu',
        replaces='ggpm_tpu/ops/graph_ops.py:111 (_nei_sum_t_bwd) and :134 '
                 '(_gather_nd_t_bwd): XLA gathers, no Pallas kernel; the '
                 'backward of B1, ggpm_tpu/ops/pallas_gather.py:33',
        main_case='depth-gather-bwd', paths=('train',),
        call_sites=['ggpm_tpu_torch/ops/nei_sum.py (nei_sum_t backward)',
                    'ggpm_tpu_torch/ops/gather_rows.py (gather_nd_t '
                    'backward)']),
    'gather_rows': dict(
        route='cuda', source='ggpm_tpu_torch/csrc/gather_rows.cu',
        replaces='ggpm_tpu/ops/graph_ops.py:122 (gather_nd_t forward): an '
                 'XLA gather, no Pallas kernel',
        main_case='depth-gather', paths=('serve', 'decode', 'train'),
        call_sites=['ggpm_tpu_torch/models/rnn.py (MPNLSTMCell.forward, '
                    'the depth loop)']),
}
WRAPPERS = profile_train.KERNELS
assert set(KERNELS) == set(WRAPPERS)


def phase(name, t0):
    print(f'phase {name} ok {time.perf_counter() - t0:.3f}s', flush=True)


def check_kernels(tree, decode_trees):
    """The serve and decode paths' kernels at their shapes: ``nei_sum`` at
    every case of ``kernel_bench.measure_cases`` with each launch kind
    forced, and the depth loop's ``gather_rows`` of the request's tree."""
    floor = floor_ms()
    print(f'floor_ms {floor}', flush=True)
    report = {}
    for case, h, g, row in kernel_bench.measure_cases(tree, floor, nei_sum,
                                                      decode_trees):
        row['plan'], row['kinds'] = nei_sum_kinds(h, g)
        errs = [row['max_abs_err']] + [
            r['max_abs_err'] for r in row['kinds'].values()]
        if not max(errs) <= KERNEL_ATOL:
            raise AssertionError(f'nei_sum/{case}: max abs err {errs}')
        row['host_ms'], row['plain_host_ms'] = (
            eager_ms(lambda f=f: f(h, g))
            for f in (nei_sum, graph_ops.nei_sum))
        print(f'kernel nei_sum {case} ' + json.dumps(row), flush=True)
        report.setdefault('nei_sum', {})[case] = row
    gen = torch.Generator(device='cuda').manual_seed(2)
    for row in checked(kernel_bench.measure(
            [kernel_bench.gather_case('depth-gather-serve', tree, gen)],
            floor)):
        report.setdefault(row['kernel'], {})[row['case']] = row
    return report


def checked(rows):
    """Print and check each row of ``kernel_bench.measure``: max abs error
    at most ``KERNEL_ATOL`` against the plain version, and bit for bit
    against the in-order sum."""
    for row in rows:
        print(f'kernel {row["kernel"]} {row["case"]} ' + json.dumps(row),
              flush=True)
        if not (row['max_abs_err'] <= KERNEL_ATOL and row['bit_exact']):
            raise AssertionError(f'{row["kernel"]}/{row["case"]}: max abs '
                                 f'err {row["max_abs_err"]}, bit exact '
                                 f'{row["bit_exact"]}')
        yield row


def request(port, path, payload=None):
    url = f'http://127.0.0.1:{port}{path}'
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={'Content-Type': 'application/json'})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        out = json.loads(r.read())
    print(f'request {path} {time.perf_counter() - t0:.3f}s', flush=True)
    return out


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in WRAPPERS.items()}


def serve(port, rows):
    """The encoding requests of the main path through GgpmServer.  Returns
    the answers, the kernel launches they made, and each request's."""
    smiles = [r[0] for r in rows]
    reset_counts()
    per_request = []
    health = request(port, '/health')
    for path in ('/encode', '/properties'):
        before = read_counts()
        out = request(port, path, {'smiles': smiles})
        per_request.append({k: v - before[k]
                            for k, v in read_counts().items()})
        if path == '/encode':
            enc = out
    return health, enc, out, read_counts(), per_request


def check_answers(health, enc, props, rows, model_cpu, batch):
    if health.get('status') != 'ok':
        raise AssertionError(f'/health: {health}')
    z = np.asarray(enc['latents'], dtype=np.float64)
    if z.shape != (N_MOLS, 24) or not np.isfinite(z).all():
        raise AssertionError(f'/encode: latents {z.shape}, finite '
                             f'{np.isfinite(z).all()}')
    mae = {}
    for key, col in (('homo', 1), ('lumo', 2)):
        pred = np.asarray(props[key], dtype=np.float64)
        if pred.shape != (N_MOLS,) or not np.isfinite(pred).all():
            raise AssertionError(f'/properties: {key} {pred.shape}')
        mae[key] = float(np.abs(pred - np.array([r[col] for r in rows])).mean())
        if abs(mae[key] - JAX_MAE[key]) > MAE_TOL:
            raise AssertionError(f'{key} MAE {mae[key]} vs JAX {JAX_MAE[key]}')
    z_cpu, _ = encode(model_cpu, batch)
    lat_err = float(np.abs(z[:N_CPU_CHECK] - z_cpu.numpy()).max())
    if not lat_err <= LATENT_ATOL:
        raise AssertionError(f'latents vs the CPU port: max abs err {lat_err}')
    print('answers ' + json.dumps(dict(homo_mae=mae['homo'],
                                       lumo_mae=mae['lumo'],
                                       jax_mae=JAX_MAE,
                                       latent_err_vs_cpu=lat_err)), flush=True)


def decode_requests(port, rows):
    """The decoding requests of the main path.  Returns their answers,
    seconds and ``nei_sum`` and ``gather_rows`` launches, and the kernel
    counts."""
    smiles = [r[0] for r in rows]
    reset_counts()
    out = {}
    for name, path, payload in (('reconstruct', '/reconstruct',
                                 {'smiles': smiles}),
                                ('sample', '/sample', SAMPLE)):
        before = read_counts()
        t0 = time.perf_counter()
        out[name] = dict(smiles=request(port, path, payload)['smiles'],
                         seconds=time.perf_counter() - t0)
        out[name]['launches'] = nei_sum.launches - before['nei_sum']
        out[name]['gather_launches'] = (gather_rows.launches -
                                        before['gather_rows'])
    return out, read_counts()


def _order_gap(card, cpu):
    """Where two logged candidate lists part: the first position whose
    entry differs, and the CPU's score gap between its entry there and the
    card's entry (the CPU list's last score if the card's is not in it)."""
    keys = [c[:-1] for c in cpu]
    for k, (a, c) in enumerate(zip(card, cpu)):
        if a[:-1] != c[:-1]:
            other = cpu[keys.index(a[:-1])][-1] if a[:-1] in keys else cpu[-1][-1]
            return abs(c[-1] - other)
    return None


def first_divergence(card_log, cpu_log):
    """First step where one molecule's card and CPU logs part: (step,
    what, margin in the CPU log); None if they never do."""
    for t, (a, c) in enumerate(zip(card_log, cpu_log)):
        if t == 0 and a['root'] != c['root']:
            return t, 'root', float('inf')   # the log holds no cls scores
        for key in ('top-5-root-attachments', 'top-5-inter-cands'):
            if key in a and key in c:
                gap = _order_gap(a[key], c[key])
                if gap is not None:
                    return t, key, gap
        pa, pc = a.get('Generate fragment'), c.get('Generate fragment')
        if (pa is None) != (pc is None) or (
                pa is not None and (pa > 0.5) != (pc > 0.5)):
            return t, 'Generate fragment', (
                float('inf') if pc is None else abs(pc - 0.5))
    return None


def check_decode(name, got, ref, card_logs, cpu_logs):
    """The decode rule for one request: returns the differing indices and
    prints each one's first divergence."""
    if len(got) != len(ref):
        raise AssertionError(f'/{name}: {len(got)} answers, need {len(ref)}')
    if sum(s is None for s in got) != sum(s is None for s in ref):
        raise AssertionError(f'/{name}: None count differs from the JAX '
                             f'reference')
    differ = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    for i in differ:
        div = first_divergence(card_logs()[i], cpu_logs()[i])
        print(f'decode {name} differs at {i}: {got[i]} vs {ref[i]}; first '
              f'divergence (step, what, CPU margin) {div}', flush=True)
        if div is None or not div[2] < NEAR_TIE:
            raise AssertionError(f'/{name}[{i}] differs from the JAX '
                                 f'reference beyond an fp32 near-tie: {div}')
    return differ


def logs_of(model, vocab, latents):
    """Per-step logs of a greedy decode of ``latents()`` on the model's
    device, computed once on first use."""
    memo = []

    def get():
        if not memo:
            memo.append(decode_best(model, vocab, common_atom_vocab,
                                    latents(), max_decode_step=MAX_DECODE_STEP,
                                    log_steps=True)[0])
        return memo[0]
    return get


def decode_phase(model, model_cpu, vocab, rows, answers, enc, batch,
                 depth):
    """Hold the decoding answers to the JAX reference and count their
    steps and launches (``depth`` rounds of the depth loop an encode);
    returns what the phase prints."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    smiles = [r[0] for r in rows]
    if golden['inputs'] != smiles or golden['sample_request'] != SAMPLE:
        raise AssertionError('the golden file is not for these requests')
    z_card = np.asarray(enc['latents'], dtype=np.float32)
    z_prior = np.random.default_rng(SAMPLE['seed']).standard_normal(
        (SAMPLE['n'], z_card.shape[1])).astype(np.float32)
    differ = {}
    for name, z_c, z_p in (
            ('reconstruct', lambda: z_card,
             lambda: encode(model_cpu, batch)[0]),
            ('sample', lambda: z_prior, lambda: z_prior)):
        differ[name] = check_decode(
            name, answers[name]['smiles'], golden[name],
            logs_of(model, vocab, z_c), logs_of(model_cpu, vocab, z_p))
    n_differ = sum(len(d) for d in differ.values())
    if n_differ > MAX_DIFFERING:
        raise AssertionError(f'{n_differ} decoded strings differ from the '
                             f'JAX reference, at most {MAX_DIFFERING} may')

    # the same decodes again, directly: their steps and launches
    steps = {}
    for name, run in (
            ('reconstruct', lambda: decode_best(
                model, vocab, common_atom_vocab, z_card,
                max_decode_step=MAX_DECODE_STEP)),
            ('sample', lambda: sample_prior(
                model, vocab, common_atom_vocab, SAMPLE['n'],
                rng=np.random.default_rng(SAMPLE['seed']),
                max_decode_step=MAX_DECODE_STEP))):
        before = nei_sum.launches
        results, out = run()
        steps[name] = decode_steps(results)
        direct = nei_sum.launches - before
        encodes = 1 if name == 'reconstruct' else 0
        if not (direct == steps[name] and answers[name]['launches'] ==
                steps[name] + 2 * encodes and out == answers[name]['smiles']
                and answers[name]['gather_launches'] == depth * encodes):
            raise AssertionError(
                f'/{name}: {answers[name]["launches"]} nei_sum and '
                f'{answers[name]["gather_launches"]} gather_rows launches in '
                f'the request, {direct} nei_sum in the direct decode of '
                f'{steps[name]} steps (same answers: '
                f'{out == answers[name]["smiles"]})')
    canon = [canon_smiles(s) for s in smiles]
    rec = answers['reconstruct']['smiles']
    return dict(
        {f'{n}_seconds': answers[n]['seconds'] for n in answers},
        steps=steps, nei_sum_launches={n: answers[n]['launches']
                                       for n in answers},
        gather_rows_launches={n: answers[n]['gather_launches']
                              for n in answers},
        validity={n: sum(s is not None for s in answers[n]['smiles']) /
                  len(answers[n]['smiles']) for n in answers},
        exact_reconstruction=sum(a == b for a, b in zip(rec, canon)) / len(rec),
        differ_from_jax=differ)


def train_phase(vocab):
    """The training path: the golden steps, an epoch profiled, the counts
    of the path, and the step's kernels at its shapes.  Returns what the
    phase prints, the counts and the kernel rows."""
    with open(TRAIN_GOLDEN) as f:
        golden = json.load(f)
    trainer, _ = profile_train.canonical_trainer('cuda', vocab)
    _, batches = profile_train.hopv_batches(vocab=vocab)
    if len(batches) != profile_train.STEPS_PER_EPOCH:
        raise AssertionError(f'{len(batches)} HOPV batches, need '
                             f'{profile_train.STEPS_PER_EPOCH}')
    reset_counts()
    steps = profile_train.golden_steps('cuda', trainer, batches)
    bad = profile_train.check_golden(steps, golden)
    print('train golden ' + json.dumps(dict(
        steps=[{k: v for k, v in s.items() if k != 'update_norms'}
               for s in steps],
        update_deviation=profile_train.update_deviation(steps, golden),
        failures=bad)), flush=True)
    if bad:
        raise AssertionError(f'training steps differ from the JAX '
                             f'package\'s: {bad}')
    prof = profile_train.profile_epoch(trainer, batches)
    counts = read_counts()
    if min(counts.values()) == 0:
        raise AssertionError(f'a kernel never launched on the training '
                             f'path: {counts}')
    print('train ' + json.dumps(prof), flush=True)
    rows = {}
    batch = trainer.device_batch(trainer.host_batch(batches[0]))
    gen = torch.Generator(device='cuda').manual_seed(1)
    for row in checked(kernel_bench.measure(
            kernel_bench.train_cases(batch, gen), floor_ms())):
        rows.setdefault(row['kernel'], {})[row['case']] = row
    return prof, counts, rows


def main() -> int:
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase('device', t0)

    t0 = time.perf_counter()
    for name, info in cuda_build.build().items():
        print(f'build {name} {info["seconds"]:.2f}s\n{info["ptxas"].strip()}',
              flush=True)
    phase('build', t0)

    t0 = time.perf_counter()
    model, vocab = load_model(CKPT, VOCAB, device='cuda')
    all_rows = prune_to_vocab(read_csv_data(DATA), vocab,
                              verbose=False)[:N_DECODE]
    if len(all_rows) != N_DECODE:
        raise AssertionError(f'{len(all_rows)} in-vocab molecules, need '
                             f'{N_DECODE}')
    rows = all_rows[:N_MOLS]
    batches = [to_model_batch(tensorize(r, vocab, common_atom_vocab),
                              vocab.mask, pad=False) for r in (rows, all_rows)]
    tree = batches[0]['tree']
    phase('load', t0)

    t0 = time.perf_counter()
    report = check_kernels(tree, [b['tree'] for b in batches])
    phase('kernel', t0)

    t0 = time.perf_counter()
    server = GgpmServer(model, vocab, max_decode_step=MAX_DECODE_STEP,
                        device='cuda')
    port = server.start(port=0).server_address[1]
    try:
        health, enc, props, counts, per_request = serve(port, rows)
        for name, k in KERNELS.items():
            if (counts[name] > 0) != ('serve' in k['paths']):
                raise AssertionError(f'kernel {name}: {counts[name]} '
                                     f'launches on the encoding path')
        # two readouts and one depth loop of ``depth`` rounds a request
        depth = model.cfg.depthT
        if not all(r['nei_sum'] == 2 and r['gather_rows'] == depth
                   for r in per_request):
            raise AssertionError(f'launches per encoding request '
                                 f'{per_request}, expected nei_sum 2 and '
                                 f'gather_rows {depth}')
        model_cpu, _ = load_model(CKPT, VOCAB, device='cpu')
        small = to_model_batch(tensorize(rows[:N_CPU_CHECK], vocab,
                                         common_atom_vocab), vocab.mask,
                               pad=False)
        check_answers(health, enc, props, rows, model_cpu, small)
        print(f'launches per encoding request {per_request}', flush=True)
        phase('serve', t0)

        t0 = time.perf_counter()
        answers, dcounts = decode_requests(port, rows)
    finally:
        server.stop()
    for name, k in KERNELS.items():
        if (dcounts[name] > 0) != ('decode' in k['paths']):
            raise AssertionError(f'kernel {name}: {dcounts[name]} launches '
                                 f'on the decoding path')
    summary = decode_phase(model, model_cpu, vocab, rows, answers, enc,
                           batches[0], depth)
    print('decode ' + json.dumps(summary), flush=True)
    b120 = profile_decode(model, vocab, encode(model, batches[1])[0],
                          max_decode_step=MAX_DECODE_STEP)
    print('decode B120 ' + json.dumps(b120), flush=True)
    phase('decode', t0)

    t0 = time.perf_counter()
    prof, tcounts, train_rows = train_phase(vocab)
    counts = {name: counts[name] + dcounts[name] + tcounts[name]
              for name in counts}
    phase('train', t0)

    keys = ('max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
            'bound_by', 'floor_ms', 'host_ms')
    kernels = []
    for name, k in KERNELS.items():
        rows_of = {**report.get(name, {}), **train_rows[name]}
        r = rows_of[k['main_case']]
        kernels.append(dict(
            name=name, route=k['route'], source=k['source'],
            replaces=k['replaces'], launches=counts[name],
            launches_per_step=prof['kernel_launches_per_step'][name],
            **{key: r[key] for key in keys},
            max_abs_err_all_cases=max(x['max_abs_err']
                                      for x in rows_of.values()),
            call_sites=k['call_sites'], case=k['main_case'],
            shape=r.get('shape') or dict(h=r['h'], graph=r['graph']),
            cases={case: {key: row[key] for key in keys}
                   for case, row in rows_of.items()
                   if case != k['main_case']}))
    print(f'total {time.perf_counter() - t_all:.1f}s', flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
