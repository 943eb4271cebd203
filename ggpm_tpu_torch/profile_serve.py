"""Where the time of one ``/encode`` goes on a GPU: host tensorization, the
encoder's wall time on the device, the device's busy and idle share (of the
encoder alone and of the whole request), and the kernels by device time.

    python -m ggpm_tpu_torch.profile_serve [--out PATH]

Prints one JSON object (and writes it to ``--out`` if given).  Needs a CUDA
device; it has no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .bridge import load_model
from .data.batching import to_model_batch
from .data.dataset import prune_to_vocab, read_csv_data
from .graph.mol_graph import tensorize
from .graph.vocab import common_atom_vocab
from .models.api import encode

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MOLS = 64      # the request chip_smoke.py sends
REPS = 10


def _device_us(event) -> float:
    # the attribute's name changed across PyTorch releases
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--ckpt', default=os.path.join(_ROOT, 'runs',
                                                   'QUALITY_hopv.json.ckpt'))
    ap.add_argument('--vocab', default=os.path.join(
        _ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt'))
    ap.add_argument('--data', default=os.path.join(_ROOT, 'data',
                                                   'hopv15.csv'))
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_serve needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False

    model, vocab = load_model(args.ckpt, args.vocab, device='cuda')
    rows = prune_to_vocab(read_csv_data(args.data), vocab,
                          verbose=False)[:N_MOLS]
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                               vocab.mask, pad=False)
        host_s.append(time.perf_counter() - t0)

    def run():
        z, _ = encode(model, batch)
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            run()
        prof_wall_s = (time.perf_counter() - t0) / REPS
    # device-side events only: a CPU op's self device time repeats its
    # kernels' own
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in events) / REPS
    top = sorted(events, key=_device_us, reverse=True)[:12]
    nei = [e for e in events if 'nei_sum_kernel' in e.key]
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    out = dict(
        device=smi.strip().splitlines()[0], n_mols=len(rows),
        tree_shape=dict(nodes=int(batch['tree']['fnode'].shape[0]),
                        messages=int(batch['tree']['fmess'].shape[0])),
        host_tensorize_ms=1e3 * float(np.median(host_s)),
        encode_wall_ms=1e3 * float(np.median(wall_s)),
        profiled_wall_ms=1e3 * prof_wall_s,
        device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e6 / float(np.median(wall_s)),
        request_device_idle_share=1.0 - busy_us / 1e6 / (
            float(np.median(host_s)) + float(np.median(wall_s))),
        device_launches_per_encode=sum(e.count for e in events) / REPS,
        nei_sum_device_us_per_launch=(
            sum(_device_us(e) for e in nei) / sum(e.count for e in nei)
            if nei else None),
        top_device_kernels=[dict(name=e.key[:80], count=e.count / REPS,
                                 device_us=_device_us(e) / REPS)
                            for e in top])
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text + '\n')
    return out


if __name__ == '__main__':
    main()
