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
             and the first 64 in-vocab molecules of ``data/hopv15.csv``.
4. kernel  — each kernel against its plain PyTorch version on the card, at
             the shapes the serve path gives it (the 64 molecules' tables)
             and at ragged and large cases.  ``ms``, ``plain_ms`` and
             ``library_ms`` are device times (calls captured in a CUDA
             graph, replayed between CUDA events); ``host_ms`` is the
             eager back-to-back time, which the host's dispatch sets at
             small shapes.
5. serve   — ``GgpmServer`` on a free port answers ``/health``, ``/encode``
             and ``/properties`` for the 64 molecules; checks the latents,
             the kernel launch counts, the HOMO/LUMO MAE against the JAX
             package's, and the latents against the port on the CPU.

The line before the last is ``nvidia-smi``'s; the one before it a JSON
object listing every kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models.api import encode
from ggpm_tpu_torch.ops import cuda_build, graph_ops, nei_sum
from ggpm_tpu_torch.serve import GgpmServer

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
N_MOLS = 64
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

# H100 SXM data sheet: HBM rate and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# every kernel of the serve path: wrapper, plain version, the one PyTorch
# call that computes the same function (timed as a yardstick only)
KERNELS = {
    'nei_sum': dict(
        route='cuda', source='ggpm_tpu_torch/csrc/nei_sum.cu',
        replaces='ggpm_tpu/ops/pallas_gather.py:33',
        wrapper=nei_sum, plain=graph_ops.nei_sum,
        library=lambda h, g: torch.index_select(h, 0, g.view(-1)).view(
            g.shape[0], g.shape[1], h.shape[1]).sum(1),
        bytes=lambda h, g: 4 * (h.numel() + g.numel() + g.shape[0] * h.shape[1]),
        ops=lambda h, g: g.numel() * h.shape[1]),
}


def phase(name, t0):
    print(f'phase {name} ok {time.perf_counter() - t0:.3f}s', flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def eager_ms(fn, reps: int = 20, inner: int = 50) -> float:
    """Per-call time of ``inner`` back-to-back eager calls, median over
    ``reps``, from CUDA events: at small shapes the host's dispatch sets
    this pace, as it does on the serve path."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_ms(fn, reps: int = 20, inner: int = 20) -> float:
    """Per-call device time: ``inner`` calls captured in a CUDA graph and
    replayed, median over ``reps``, from CUDA events; no host dispatch in
    the timed region."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return float(np.median(times))


def random_table(gen, m, hdim):
    h = torch.rand((m, hdim), generator=gen, device='cuda') * 2 - 1
    h[0] = 0
    return h


def kernel_cases(tree, gen):
    """(name, h, graph) at the serve path's shapes, then edge cases."""
    n_mess = tree['fmess'].shape[0]
    agraph = torch.as_tensor(tree['agraph'], device='cuda')
    roots = torch.as_tensor(tree['scope'][:, 0], device='cuda').long()
    h = random_table(gen, n_mess, 250)
    cases = [('readout', h, agraph),
             ('root', h, agraph[roots].contiguous())]
    for name, m, hdim, n, a in (('ragged-A1-H251', 1001, 251, 37, 1),
                                ('float4-H256', 4097, 256, 1001, 3),
                                ('large', 32768, 256, 65536, 6)):
        cases.append((name, random_table(gen, m, hdim), torch.randint(
            0, m, (n, a), generator=gen, device='cuda', dtype=torch.int32)))
    return cases


def check_kernels(tree):
    gen = torch.Generator(device='cuda').manual_seed(0)
    report = {}
    for kname, k in KERNELS.items():
        for case, h, g in kernel_cases(tree, gen):
            out = k['wrapper'](h, g)
            ref = k['plain'](h, g)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            lib_err = (k['library'](h, g) - ref).abs().max().item()
            if not err <= KERNEL_ATOL:
                raise AssertionError(f'{kname}/{case}: max abs err {err}')
            ms, plain_ms, library_ms = (
                device_ms(lambda f=f: f(h, g))
                for f in (k['wrapper'], k['plain'], k['library']))
            host_ms, plain_host_ms = (
                eager_ms(lambda f=f: f(h, g))
                for f in (k['wrapper'], k['plain']))
            bound_by, bound_ms = max(
                ('bytes', 1e3 * k['bytes'](h, g) / HBM_BYTES_PER_S),
                ('operations', 1e3 * k['ops'](h, g) / FP32_OPS_PER_S),
                key=lambda x: x[1])
            row = dict(h=list(h.shape), graph=list(g.shape), max_abs_err=err,
                       library_max_abs_err=lib_err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, host_ms=host_ms,
                       plain_host_ms=plain_host_ms)
            print(f'kernel {kname} {case} ' + json.dumps(row), flush=True)
            if case == 'readout':
                report[kname] = row
    return report


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


def serve(model, vocab, rows):
    """The main path: three requests through GgpmServer.  Returns the
    answers and the kernel launches it made."""
    smiles = [r[0] for r in rows]
    for k in KERNELS.values():
        k['wrapper'].launches = 0
    server = GgpmServer(model, vocab, device='cuda')
    port = server.start(port=0)
    launches = []
    try:
        health = request(port, '/health')
        enc = request(port, '/encode', {'smiles': smiles})
        launches.append(nei_sum.launches)
        props = request(port, '/properties', {'smiles': smiles})
        launches.append(nei_sum.launches - launches[0])
    finally:
        server.stop()
    counts = {name: k['wrapper'].launches for name, k in KERNELS.items()}
    return health, enc, props, counts, launches


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
        print(f'build {name} {info["seconds"]:.2f}s\n{info["ptxas"].strip()}')
    phase('build', t0)

    t0 = time.perf_counter()
    model, vocab = load_model(CKPT, VOCAB, device='cuda')
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:N_MOLS]
    if len(rows) != N_MOLS:
        raise AssertionError(f'{len(rows)} in-vocab molecules, need {N_MOLS}')
    tree = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                          vocab.mask, pad=False)['tree']
    phase('load', t0)

    t0 = time.perf_counter()
    report = check_kernels(tree)
    phase('kernel', t0)

    t0 = time.perf_counter()
    health, enc, props, counts, per_request = serve(model, vocab, rows)
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f'kernel {name} never launched on the path')
    if min(per_request) < 2:
        raise AssertionError(f'nei_sum launches per encoding request '
                             f'{per_request}, expected >= 2')
    model_cpu, _ = load_model(CKPT, VOCAB, device='cpu')
    small = to_model_batch(tensorize(rows[:N_CPU_CHECK], vocab,
                                     common_atom_vocab), vocab.mask, pad=False)
    check_answers(health, enc, props, rows, model_cpu, small)
    print(f'launches per encoding request {per_request}', flush=True)
    phase('serve', t0)

    kernels = [dict(name=name, route=k['route'], source=k['source'],
                    replaces=k['replaces'], launches=counts[name],
                    max_abs_err=report[name]['max_abs_err'],
                    ms=report[name]['ms'], plain_ms=report[name]['plain_ms'],
                    bound_ms=report[name]['bound_ms'],
                    bound_by=report[name]['bound_by'],
                    library_ms=report[name]['library_ms'],
                    host_ms=report[name]['host_ms'],
                    shape=dict(h=report[name]['h'], graph=report[name]['graph']))
               for name, k in KERNELS.items()]
    print(f'total {time.perf_counter() - t_all:.1f}s', flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
