"""The cases of the port's kernels and the device timing that
``chip_smoke.py`` holds them to; run alone, it times ``nei_sum`` at every
case, or with ``--transpose`` its transpose ``transpose_sum`` at every case
(``train_cases``, the training step's, and ``gather_case``, the depth
loop's, are measured by ``chip_smoke.py``).

    python -m ggpm_tpu_torch.kernel_bench [--out PATH]
    python -m ggpm_tpu_torch.kernel_bench --transpose [--sweep] [--out PATH]

``nei_sum`` cases: the two readouts of a 64-molecule HOPV request, that
tree tiled 64 times into one block-diagonal batch (a 4,096-molecule
screening request), the neighbour width A swept over {1, 2, 3, 4, 6, 8} at
the serve width, the decoder's frontier readout at B = 64 and B = 120
(``frontier_graph``), and ragged, float4 and large random cases.  Per case
it prints one JSON line: max abs error against the plain version, device
ms of the kernel, of its plain version and of the one PyTorch call that
computes the same function (``embedding_bag``), the bound (distinct rows of
``h`` read once, ``graph`` read once, ``out`` written once, over the card's
HBM rate) and the launch floor (a one-element launch in the same harness).

``transpose_sum`` cases (``transpose_cases``): the four of the first HOPV
training batch (the depth loop's gather backward and three readout
backwards, ``train_cases``) and every ``T_SHAPES`` shape of the card tests;
each line as ``measure`` gives it, with whether the output equals the
in-order sum bit for bit.  ``--sweep`` adds the device ms of every forced
launch plan (``sweep_transpose``).

Without ``--sweep`` it calls only ``ops.nei_sum.nei_sum`` /
``transpose_sum``, the plain ``ops.graph_ops`` versions and the data
modules, so a copy of this file put into an earlier checkout of the port
(one that has ``profile_train.hopv_batches`` and ``train.loop.to_device``
for ``--transpose``) times that checkout's kernel at the same cases: run
the two in turns in one chip call to compare a redesign with its parent.
Needs a CUDA device; it has no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .data.batching import compact_plan_dict, to_model_batch, train_tables
from .data.dataset import prune_to_vocab, read_csv_data
from .graph.mol_graph import tensorize
from .graph.vocab import common_atom_vocab, load_vocab_file
from .ops import graph_ops
from .ops.gather_rows import gather_rows
from .ops.nei_sum import nei_sum, transpose_sum

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(_ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(_ROOT, 'data', 'hopv15.csv')
N_MOLS = 64
DECODE_BATCHES = (64, 120)   # a /reconstruct request; the B = 120 decode
MAX_EDGES = 500              # decode state rows per molecule (decode_motif)
MAX_NB = 12                  # frontier readout width (IncBase.max_nb)
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


def serve_tree(vocab=None, n: int = N_MOLS) -> dict:
    """The tree level of the first ``n`` in-vocab HOPV molecules, as
    ``to_model_batch`` gives it (numpy arrays)."""
    vocab = vocab or load_vocab_file(VOCAB)
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:n]
    return to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                          vocab.mask, pad=False)['tree']


def frontier_graph(tree: dict) -> np.ndarray:
    """A decode step's frontier table ``agraph_rows`` [B, MAX_NB] int32,
    seeded from a tree of B molecules: row b lists the incoming messages of
    molecule b's node of highest in-degree (the widest readout its decode
    makes), zero-padded to the decoder's width.  The message ids lie in the
    first rows of the ``MAX_EDGES * B`` state, as a decode's do: it reserves
    rows from 1 upwards, B or fewer a step."""
    agraph, scope = tree['agraph'], tree['scope']
    out = np.zeros((len(scope), MAX_NB), np.int32)
    for b, (start, length) in enumerate(scope):
        nodes = agraph[start:start + length]
        row = nodes[np.argmax((nodes > 0).sum(1))]
        out[b, :agraph.shape[1]] = row
    return out


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


def nei_sum_cases(tree: dict, gen: torch.Generator,
                  decode_trees: Sequence[dict] = ()) -> List[Case]:
    """(name, h, graph) on ``gen``'s device: the serve path's two readouts,
    the request-scale tiling, the A sweep at the serve width, the decode
    frontier over a ``MAX_EDGES * B`` state for each of ``decode_trees``,
    then ragged, float4 and large random cases.  Values of ``h`` come from
    ``gen``."""
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
    for dtree in decode_trees:
        g = torch.as_tensor(frontier_graph(dtree), device=dev)
        cases.append((f'frontier-B{g.shape[0]}',
                      random_table(gen, MAX_EDGES * g.shape[0], 250), g))
    for name, m, hdim, n, a in (('ragged-A1-H251', 1001, 251, 37, 1),
                                ('float4-H256', 4097, 256, 1001, 3),
                                ('large', 32768, 256, 65536, 6)):
        cases.append((name, random_table(gen, m, hdim), torch.randint(
            0, m, (n, a), generator=gen, device=dev, dtype=torch.int32)))
    return cases


def library_nei_sum(h: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes ``nei_sum``: a bag sum of the
    rows of ``h`` that each row of ``graph`` names (a yardstick only; the
    port never calls it)."""
    return F.embedding_bag(graph, h, mode='sum')


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


def measure_cases(tree: dict, floor: float, wrapper: Callable = nei_sum,
                  decode_trees: Sequence[dict] = ()
                  ) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor, dict]]:
    """(name, h, graph, row) for every case of ``nei_sum_cases`` on the
    card, ``h`` from a seeded generator; ``row`` has the shapes, bytes and
    bound, ``wrapper``'s max abs error against the plain version, and the
    device ms of ``wrapper``, the plain version and the library call."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    for case, h, g in nei_sum_cases(tree, gen, decode_trees):
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


def in_order_nei_sum(h: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """``nei_sum`` summed in the kernel's order, a = 0..A-1 (zeros for
    A = 0)."""
    if graph.shape[1] == 0:
        return h.new_zeros((graph.shape[0], h.shape[1]))
    out = h[graph[:, 0].long()].clone()
    for a in range(1, graph.shape[1]):
        out += h[graph[:, a].long()]
    return out


def in_order_transpose(g: torch.Tensor, t_idx: torch.Tensor,
                       t_mask: torch.Tensor, div: int) -> torch.Tensor:
    """The transpose summed in the kernel's order, k = 0..K-1."""
    out = t_mask[:, :1] * g[(t_idx[:, 0] // div).long()]
    for k in range(1, t_idx.shape[1]):
        out += t_mask[:, k:k + 1] * g[(t_idx[:, k] // div).long()]
    return out


def library_gather(src: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes the row gather (a yardstick)."""
    return torch.index_select(src, 0, graph.view(-1)).view(
        *graph.shape, src.shape[1])


def library_transpose(g: torch.Tensor, t_idx: torch.Tensor,
                      t_mask: torch.Tensor, div: int
                      ) -> Callable[[], torch.Tensor]:
    """The one PyTorch call that computes the transpose: a bag sum of the
    rows ``t_idx // div`` of ``g`` weighted by ``t_mask`` (a yardstick
    only).  The division is done here, outside the timed call."""
    rows = (t_idx // div).contiguous()
    return lambda: F.embedding_bag(rows, g, per_sample_weights=t_mask,
                                   mode='sum')


def gather_case(name: str, tree: dict, gen: torch.Generator,
                hidden: int = 250) -> dict:
    """The depth loop's row gather of ``tree`` (a serve tree of numpy
    arrays or a device batch's), ``gather_rows`` of [h | h·Kf | c] at
    width 3 ``hidden`` by ``bgraph``, as a case of ``measure``; the plain
    copy is its in-order reference.  Values come from ``gen``."""
    src = random_table(gen, tree['fmess'].shape[0], 3 * hidden)
    bg = torch.as_tensor(tree['bgraph'], device=gen.device)
    return dict(
        kernel='gather_rows', case=name, shape=dict(
            src=list(src.shape), graph=list(bg.shape)),
        call=lambda: gather_rows(src, bg),
        plain=lambda: graph_ops.gather_nd(src, bg), exact=None,
        library=lambda: library_gather(src, bg),
        bytes=4 * (torch.unique(bg).numel() * src.shape[1] + bg.numel() +
                   bg.numel() * src.shape[1]), ops=0)


def train_cases(batch: dict, gen: torch.Generator, hidden: int = 250
                ) -> List[dict]:
    """The kernels' calls in one training step of a device batch
    (``Trainer.device_batch``): the depth loop's row gather (forward
    ``gather_rows`` at width 3H, backward ``transpose_sum`` with div 1),
    the backward of the three readouts (``transpose_sum`` at width H, div
    A) and the decoder's masked frontier readout (``nei_sum``), at the
    canonical width ``hidden``.  Each case
    holds the kernel's call, its plain version, its in-order reference (the
    plain version itself for the copy), the library call, and the bytes
    the function must move.  Values come from ``gen``."""
    tree, plan = batch['tree'], batch['plan']
    n_mess = tree['fmess'].shape[0]
    H = hidden
    dev = gen.device
    bg = tree['bgraph']
    cases = [gather_case('depth-gather', tree, gen, H)]
    n_roots = tree['scope'].shape[0]
    roots = tree['agraph'][tree['scope'][:, 0].long()]
    sites = (('depth-gather-bwd', bg, tree['bgraph_t'], tree['bgraph_tm'],
              3 * H, 1),
             ('readout-bwd', tree['agraph'], tree['agraph_t'],
              tree['agraph_tm'], H, tree['agraph'].shape[1]),
             ('root-bwd', roots, tree['root_t'], tree['root_tm'], H,
              roots.shape[1]),
             ('frontier-bwd', plan['frontier'], plan['frontier_t'],
              plan['frontier_tm'], H, plan['frontier'].shape[1]))
    for name, graph, t_idx, t_mask, width, div in sites:
        rows = graph.numel() if div == 1 else graph.shape[0]
        g = torch.rand((rows, width), generator=gen, device=dev) * 2 - 1
        cases.append(transpose_case(name, g, t_idx, t_mask, div))
    fr = plan['frontier']
    h = random_table(gen, n_mess + n_roots, H)
    cases.append(dict(
        kernel='nei_sum', case='frontier-train', shape=dict(
            h=list(h.shape), graph=list(fr.shape)),
        call=lambda: nei_sum(h, fr), plain=lambda: graph_ops.nei_sum(h, fr),
        exact=lambda: in_order_nei_sum(h, fr),
        library=lambda: library_nei_sum(h, fr),
        bytes=nei_sum_bytes(h, fr), ops=nei_sum_ops(h, fr)))
    return cases


def transpose_case(name: str, g: torch.Tensor, t_idx: torch.Tensor,
                   t_mask: torch.Tensor, div: int) -> dict:
    """``transpose_sum(g, t_idx, t_mask, div)`` as a case of ``measure``:
    the bytes count the distinct rows of ``g`` that the real entries read,
    both tables and ``out``, once each; the operations one multiply-add
    per real entry and column."""
    nnz = int(t_mask.sum().item())
    read = torch.unique((t_idx // div)[t_mask > 0]).numel()
    width = g.shape[1]
    return dict(
        kernel='transpose_sum', case=name, shape=dict(
            g=list(g.shape), t_idx=list(t_idx.shape), div=div),
        call=lambda: transpose_sum(g, t_idx, t_mask, div),
        plain=lambda: graph_ops.transpose_sum(g, t_idx, t_mask, div),
        exact=lambda: in_order_transpose(g, t_idx, t_mask, div),
        library=library_transpose(g, t_idx, t_mask, div),
        bytes=4 * (read * width + 2 * t_idx.numel() + t_idx.shape[0] * width),
        ops=nnz * width, args=(g, t_idx, t_mask, div))


# (M source rows, W, N rows of the forward table, A, div is A?): the
# training step's B1 backward (W 250, div A) at the node, root and frontier
# tables' widths, and the depth loop's gather backward (W 750, div 1) over
# bgraph's widths; A = 12 takes the generic path.  K comes from the data.
T_SHAPES = [(m, w, n, a, by_a) for a in (1, 4, 6, 8, 12)
            for (m, w, n, by_a) in ((768, 250, 384, True),
                                    (768, 750, 768, False),
                                    (2001, 250, 1501, True),
                                    (2001, 750, 3001, False))]


def transpose_inputs(m: int, w: int, n: int, a: int, by_a: bool, device,
                     seed: int = 1):
    """A random forward table over ``m`` rows (a quarter of its slots
    padding), its transpose, and a cotangent ``g`` of the forward's output:
    [n, w] for nei_sum (div A), [n·a, w] for the row gather (div 1).
    Returns (graph, t_idx, t_mask, g, div)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    graph = torch.randint(0, m, (n, a), generator=gen, device=device,
                          dtype=torch.int32)
    graph[torch.rand((n, a), generator=gen, device=device) < 0.25] = 0
    t_idx, t_mask = graph_ops.build_transpose(graph.cpu().numpy(), m)
    rows = n if by_a else n * a
    g = torch.rand((rows, w), generator=gen, device=device) * 2 - 1
    return (graph, torch.as_tensor(t_idx, device=device),
            torch.as_tensor(t_mask, device=device), g, a if by_a else 1)


def train_batch(device) -> dict:
    """The first HOPV batch of 20 of the canonical training configuration
    as ``Trainer.device_batch`` makes it (padded, lane-packed, with the
    training tables), on ``device``; no model is loaded."""
    from .profile_train import hopv_batches
    from .train.loop import to_device
    vocab, batches = hopv_batches(1, load_vocab_file(VOCAB))
    mb = to_model_batch(batches[0], vocab.mask, pad=False)
    mb = dict(mb, plan=compact_plan_dict(
        {k: np.asarray(v) for k, v in mb['plan'].items()}))
    return to_device(train_tables(mb), device)


def transpose_cases(device) -> List[dict]:
    """The transpose at the training step's shapes (the K2 cases of
    ``train_cases``, from ``train_batch``) and at every ``T_SHAPES``
    shape, values from seeded generators."""
    gen = torch.Generator(device=device).manual_seed(1)
    cases = [c for c in train_cases(train_batch(device), gen)
             if c['kernel'] == 'transpose_sum']
    for shape in T_SHAPES:
        _, t_idx, t_mask, g, div = transpose_inputs(*shape, device=device)
        cases.append(transpose_case('T' + '-'.join(map(str, shape)), g,
                                    t_idx, t_mask, div))
    return cases


def sweep_transpose(case: dict) -> dict:
    """Device ms of the transpose at ``case`` under each forced count of
    column chunks per thread, each plan's output held bit for bit to the
    in-order sum; and two floors in the same harness: the wrapper's plan
    with every weight 0 (``index_and_store_ms``: the round of table loads,
    then the stores, no row of ``g`` read) and one PyTorch fill of ``out``
    (``store_ms``: the stores alone)."""
    from .ops.nei_sum import MAX_CHUNKS, device_plan_t, launch_transpose
    g, t_idx, t_mask, div = case['args']
    out = torch.empty((t_idx.shape[0], g.shape[1]), device=g.device)
    exact = case['exact']()
    row = {}
    for chunks in range(1, MAX_CHUNKS + 1):
        p = device_plan_t(g, t_idx, out, chunks)

        def run(p=p):
            return launch_transpose(g, t_idx, t_mask, div, out, p)
        if not torch.equal(run(), exact):
            raise AssertionError(f'transpose {case["case"]} chunks {chunks}: '
                                 f'not the in-order sum')
        row[f'C{chunks}'] = dict(tpr=p.tpr, rpb=p.rpb, grid=p.grid,
                                 ms=device_ms(run))
    no_entries = torch.zeros_like(t_mask)
    p = device_plan_t(g, t_idx, out)
    row['index_and_store_ms'] = device_ms(
        lambda: launch_transpose(g, t_idx, no_entries, div, out, p))
    row['store_ms'] = device_ms(out.zero_)
    return row


def measure(cases: Sequence[dict], floor: float) -> Iterator[dict]:
    """Each case (``train_cases``, ``gather_case``) on the card: max abs
    error against the plain version, whether it equals the in-order sum
    bit for bit (the gather: the plain copy), device ms of the kernel, the
    plain version and the library call, and the bound."""
    for c in cases:
        out, ref = c['call'](), c['plain']()
        exact = (c['exact'] or c['plain'])()
        bound_by, bound_ms = bound(c['bytes'], c['ops'])
        row = dict(kernel=c['kernel'], case=c['case'], shape=c['shape'],
                   bytes=c['bytes'], bound_ms=bound_ms, bound_by=bound_by,
                   floor_ms=floor,
                   max_abs_err=(out - ref).abs().max().item(),
                   bit_exact=bool(torch.equal(out, exact)))
        row['ms'], row['plain_ms'], row['library_ms'] = (
            device_ms(f) for f in (c['call'], c['plain'], c['library']))
        row['host_ms'] = eager_ms(c['call'])
        yield row


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=None, help='also write the lines here')
    ap.add_argument('--transpose', action='store_true',
                    help='time transpose_sum at its cases instead')
    ap.add_argument('--sweep', action='store_true',
                    help='with --transpose, also time each forced plan')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('kernel_bench needs a CUDA device')
    smi = nvidia_smi()
    print(smi, flush=True)
    rows = []
    if args.transpose:
        floor = floor_ms()
        cases = transpose_cases('cuda')
        for case, row in zip(cases, measure(cases, floor)):
            row['device'] = smi
            if args.sweep:
                row['plans'] = sweep_transpose(case)
            print('transpose_sum ' + json.dumps(row), flush=True)
            rows.append(row)
    else:
        vocab = load_vocab_file(VOCAB)
        decode_trees = [serve_tree(vocab, n) for n in DECODE_BATCHES]
        for case, _, _, row in measure_cases(serve_tree(vocab), floor_ms(),
                                             decode_trees=decode_trees):
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
