"""The cases of the port's ``nei_sum`` kernel and the device timing that
``chip_smoke.py`` holds it to; run alone, it times the kernel at every case.

    python -m ggpm_tpu_torch.kernel_bench [--out PATH]

Cases: the two readouts of a 64-molecule HOPV request, that tree tiled 64
times into one block-diagonal batch (a 4,096-molecule screening request),
the neighbour width A swept over {1, 2, 3, 4, 6, 8} at the serve width, and
ragged, float4 and large random cases.  Per case it prints one JSON line:
max abs error against the plain version, device ms of the kernel, of its
plain version and of the one PyTorch call that computes the same function,
the bound (distinct rows of ``h`` read once, ``graph`` read once, ``out``
written once, over the card's HBM rate) and the launch floor (a
one-element launch in the same harness).

It calls only ``ops.nei_sum.nei_sum(h, graph)``, the plain
``ops.graph_ops.nei_sum`` and the data modules, so a copy of this file put
into an earlier checkout of the port times that checkout's kernel at the
same cases: run the two in turns in one chip call to compare a redesign
with its parent.  Needs a CUDA device; it has no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch

from .data.batching import to_model_batch
from .data.dataset import prune_to_vocab, read_csv_data
from .graph.mol_graph import tensorize
from .graph.vocab import common_atom_vocab, load_vocab_file
from .ops import graph_ops
from .ops.nei_sum import nei_sum

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(_ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(_ROOT, 'data', 'hopv15.csv')
N_MOLS = 64
REQUEST_COPIES = 64      # 64 copies of the 64-molecule tree: 4,096 molecules
A_SWEEP = (1, 2, 3, 4, 6, 8)

# H100 SXM data sheet: HBM rate and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

Case = Tuple[str, torch.Tensor, torch.Tensor]


def nvidia_smi() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def serve_tree(vocab=None) -> dict:
    """The tree level of the first ``N_MOLS`` in-vocab HOPV molecules, as
    ``to_model_batch`` gives it (numpy arrays)."""
    vocab = vocab or load_vocab_file(VOCAB)
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:N_MOLS]
    return to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                          vocab.mask, pad=False)['tree']


def tile_graph(graph: torch.Tensor, m: int, copies: int) -> torch.Tensor:
    """``copies`` copies of an index table over ``m`` rows as one
    block-diagonal table over ``copies * m`` rows: index ``i > 0`` of copy
    ``k`` becomes ``i + k * m``; the padding index 0 stays 0."""
    shift = m * torch.arange(copies, dtype=graph.dtype,
                             device=graph.device).view(-1, 1, 1)
    tiled = torch.where(graph > 0, graph + shift, graph)
    return tiled.reshape(-1, graph.shape[1])


def random_table(gen: torch.Generator, m: int, hdim: int) -> torch.Tensor:
    h = torch.rand((m, hdim), generator=gen, device=gen.device) * 2 - 1
    h[0] = 0
    return h


def nei_sum_cases(tree: dict, gen: torch.Generator) -> List[Case]:
    """(name, h, graph) on ``gen``'s device: the serve path's two readouts,
    the request-scale tiling, the A sweep at the serve width, then ragged,
    float4 and large random cases.  Values of ``h`` come from ``gen``."""
    dev = gen.device
    n_mess, n_nodes = tree['fmess'].shape[0], tree['fnode'].shape[0]
    agraph = torch.as_tensor(tree['agraph'], device=dev)
    roots = torch.as_tensor(tree['scope'][:, 0], device=dev).long()
    h = random_table(gen, n_mess, 250)
    cases = [('readout', h, agraph),
             ('root', h, agraph[roots].contiguous()),
             ('request', random_table(gen, n_mess * REQUEST_COPIES, 250),
              tile_graph(agraph, n_mess, REQUEST_COPIES))]
    for a in A_SWEEP:
        cases.append((f'A{a}-H250', h, torch.randint(
            0, n_mess, (n_nodes, a), generator=gen, device=dev,
            dtype=torch.int32)))
    for name, m, hdim, n, a in (('ragged-A1-H251', 1001, 251, 37, 1),
                                ('float4-H256', 4097, 256, 1001, 3),
                                ('large', 32768, 256, 65536, 6)):
        cases.append((name, random_table(gen, m, hdim), torch.randint(
            0, m, (n, a), generator=gen, device=dev, dtype=torch.int32)))
    return cases


def library_nei_sum(h: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes ``nei_sum`` (a yardstick only;
    the port never calls it)."""
    return torch.index_select(h, 0, graph.view(-1)).view(
        graph.shape[0], graph.shape[1], h.shape[1]).sum(1)


def nei_sum_bytes(h: torch.Tensor, graph: torch.Tensor) -> int:
    """Bytes the function must move: each distinct row of ``h`` that
    ``graph`` reads, ``graph`` itself, and ``out``, once each."""
    rows = torch.unique(graph).numel()
    return 4 * (rows * h.shape[1] + graph.numel() + graph.shape[0] * h.shape[1])


def nei_sum_ops(h: torch.Tensor, graph: torch.Tensor) -> int:
    return graph.numel() * h.shape[1]


def bound(nbytes: int, ops: int) -> Tuple[str, float]:
    """(what bounds it, least ms) on the card's data-sheet rates."""
    return max(('bytes', 1e3 * nbytes / HBM_BYTES_PER_S),
               ('operations', 1e3 * ops / FP32_OPS_PER_S), key=lambda x: x[1])


def eager_ms(fn: Callable, reps: int = 20, inner: int = 50) -> float:
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


def device_ms(fn: Callable, reps: int = 20, inner: int = 20) -> float:
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


def floor_ms() -> float:
    """Device time of a trivial launch (zeroing one element) in the
    ``device_ms`` harness: what any launch costs there."""
    x = torch.zeros(1, device='cuda')
    return device_ms(x.zero_)


def measure_cases(tree: dict, floor: float, wrapper: Callable = nei_sum
                  ) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor, dict]]:
    """(name, h, graph, row) for every case of ``nei_sum_cases`` on the
    card, ``h`` from a seeded generator; ``row`` has the shapes, bytes and
    bound, ``wrapper``'s max abs error against the plain version, and the
    device ms of ``wrapper``, the plain version and the library call."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    for case, h, g in nei_sum_cases(tree, gen):
        ref = graph_ops.nei_sum(h, g)
        nbytes, ops = nei_sum_bytes(h, g), nei_sum_ops(h, g)
        bound_by, bound_ms = bound(nbytes, ops)
        row = dict(h=list(h.shape), graph=list(g.shape), bytes=nbytes,
                   distinct_rows=torch.unique(g).numel(), bound_ms=bound_ms,
                   bound_by=bound_by, floor_ms=floor)
        row['max_abs_err'] = (wrapper(h, g) - ref).abs().max().item()
        row['library_max_abs_err'] = (
            library_nei_sum(h, g) - ref).abs().max().item()
        row['ms'], row['plain_ms'], row['library_ms'] = (
            device_ms(lambda f=f: f(h, g))
            for f in (wrapper, graph_ops.nei_sum, library_nei_sum))
        yield case, h, g, row


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=None, help='also write the lines here')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('kernel_bench needs a CUDA device')
    smi = nvidia_smi()
    print(smi, flush=True)
    rows = []
    for case, _, _, row in measure_cases(serve_tree(), floor_ms()):
        row = dict(case=case, device=smi, **row)
        print('nei_sum ' + json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.writelines(json.dumps(r) + '\n' for r in rows)
    return rows


if __name__ == '__main__':
    main()
