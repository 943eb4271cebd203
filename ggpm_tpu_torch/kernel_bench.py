"""The cases of the port's kernels and the device timing that
``chip_smoke.py`` holds them to; run alone, it times ``nei_sum`` at every
case, or with ``--transpose`` its transpose ``transpose_sum`` at every case
(``train_cases``, the training step's, and ``gather_case``, the depth
loop's, are measured by ``chip_smoke.py``).

    python -m ggpm_tpu_torch.kernel_bench [--out PATH]
    python -m ggpm_tpu_torch.kernel_bench --transpose [--sweep] [--out PATH]
    python -m ggpm_tpu_torch.kernel_bench --hier [--out PATH]

``nei_sum`` cases: the two readouts of a 64-molecule HOPV request, that
tree tiled 64 times into one block-diagonal batch (a 4,096-molecule
screening request), the neighbour width A swept over {1, 2, 3, 4, 6, 8} at
the serve width, the decoder's frontier readout at B = 64 and B = 120
in the exact decode's state (``frontier_graph``) and in the turbo
decode's (``turbo_frontier_graph``), and ragged, float4 and large random
cases.  Per case it prints one JSON line: max abs error against the plain
version, device ms of the kernel, of its plain version and of the one
PyTorch call that computes the same function (``embedding_bag``), the
bound (distinct rows of ``h`` read once, ``graph`` read once, ``out``
written once, over the card's HBM rate) and the launch floor (a
one-element launch in the same harness).

``--hier`` times ``nei_sum`` and ``gather_rows`` at the hier family's call
sites (``hier_cases``), on the inputs the trained ``hier-prop``
checkpoint's serve path gives them: the encode of the first 64 in-vocab
HOPV molecules (the five readouts, and the depth loop's gather at the atom
level and at the tree level) and one step of the exact decode of the
first 16 (its five frontier sums), each line as ``measure`` gives it; and
``nei_sum`` at the turbo decode's four propose sums
(``hier_turbo_cases``), at step 20 of a propose round over the 64
molecules' latents and over 120 prior draws.
``hier_train_cases``, the new calls of a hier training step, and
``a5_cases``, the GRU's and the bf16 encoders' calls of a training step,
are measured by ``chip_smoke.py``.

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
import contextlib
import inspect
import json
import os
import subprocess
import sys
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
TURBO_T = 150                # the turbo decode's step budget (its state rows)
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


def turbo_frontier_graph(tree: dict, T: int = 150) -> np.ndarray:
    """``frontier_graph`` in the turbo decode's state layout
    (``MotifDecoder.propose_carry``): sample b owns rows ``1 + b·(T+1)``
    onwards, so message id i > 0 of row b becomes ``1 + b·(T+1) + 1 +
    i mod T``."""
    g = frontier_graph(tree).astype(np.int64)
    base = 1 + np.arange(len(g))[:, None] * (T + 1)
    return np.where(g > 0, base + 1 + g % T, 0).astype(np.int32)


def tile_graph(graph: torch.Tensor, m: int, copies: int) -> torch.Tensor:
    """``copies`` copies of an index table over ``m`` rows as one
    block-diagonal table over ``copies * m`` rows: index ``i > 0`` of copy
    ``k`` becomes ``i + k * m``; the padding index 0 stays 0."""
    shift = m * torch.arange(copies, dtype=graph.dtype,
                             device=graph.device).view(-1, 1, 1)
    tiled = torch.where(graph > 0, graph + shift, graph)
    return tiled.reshape(-1, graph.shape[1])


def random_table(gen: torch.Generator, m: int, hdim: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    h = torch.rand((m, hdim), generator=gen, device=gen.device) * 2 - 1
    h[0] = 0
    return h.to(dtype)


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
    for dtree in decode_trees:
        g = turbo_frontier_graph(dtree)
        cases.append((f'turbo-frontier-B{g.shape[0]}',
                      random_table(gen, 1 + g.shape[0] * (TURBO_T + 1), 250),
                      torch.as_tensor(g, device=dev)))
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
    return (h.element_size() * (rows + graph.shape[0]) * h.shape[1] +
            4 * graph.numel())


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
    A = 0), in f32, rounded once to ``h``'s type."""
    if graph.shape[1] == 0:
        return h.new_zeros((graph.shape[0], h.shape[1]))
    out = h[graph[:, 0].long()].float()
    for a in range(1, graph.shape[1]):
        out += h[graph[:, a].long()].float()
    return out.to(h.dtype)


def in_order_transpose(g: torch.Tensor, t_idx: torch.Tensor,
                       t_mask: torch.Tensor, div: int) -> torch.Tensor:
    """The transpose summed in the kernel's order, k = 0..K-1, in f32,
    rounded once to ``g``'s type."""
    out = t_mask[:, :1] * g[(t_idx[:, 0] // div).long()].float()
    for k in range(1, t_idx.shape[1]):
        out += t_mask[:, k:k + 1] * g[(t_idx[:, k] // div).long()].float()
    return out.to(g.dtype)


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
    w = t_mask.to(g.dtype)
    return lambda: F.embedding_bag(rows, g, per_sample_weights=w,
                                   mode='sum')


def gather_case(name: str, tree: dict, gen: torch.Generator,
                hidden: int = 250) -> dict:
    """The depth loop's row gather of ``tree`` (a serve tree of numpy
    arrays or a device batch's), ``gather_rows`` of [h | h·Kf | c] at
    width 3 ``hidden`` by ``bgraph``, as a case of ``measure``; the plain
    copy is its in-order reference.  Values come from ``gen``."""
    src = random_table(gen, tree['fmess'].shape[0], 3 * hidden)
    return gather_rows_case(name, src, torch.as_tensor(tree['bgraph'],
                                                       device=gen.device))


def nei_sum_case(name: str, h: torch.Tensor, g: torch.Tensor) -> dict:
    """``nei_sum`` of (h, g) as a case of ``measure``: the plain version
    and the in-order sum as references, ``embedding_bag`` as the library
    call."""
    return dict(kernel='nei_sum', case=name,
                shape=dict(h=list(h.shape), graph=list(g.shape)),
                call=lambda: nei_sum(h, g),
                plain=lambda: graph_ops.nei_sum(h, g),
                exact=lambda: in_order_nei_sum(h, g),
                library=lambda: library_nei_sum(h, g),
                bytes=nei_sum_bytes(h, g), ops=nei_sum_ops(h, g))


def gather_rows_case(name: str, src: torch.Tensor, g: torch.Tensor) -> dict:
    """``gather_rows`` of (src, g) as a case of ``measure``."""
    return dict(kernel='gather_rows', case=name,
                shape=dict(src=list(src.shape), graph=list(g.shape)),
                call=lambda: gather_rows(src, g),
                plain=lambda: graph_ops.gather_nd(src, g), exact=None,
                library=lambda: library_gather(src, g),
                bytes=src.element_size() * (torch.unique(g).numel() +
                                            g.numel()) * src.shape[1] +
                4 * g.numel(), ops=0)


# the hier family's call sites, in the order the port calls them (an
# encode: HierMPNEncoder.forward; a decode step: HierDecoder.
# hdec_step_fused), each with the line of the JAX package it ports
HIER_ENCODE_SITES = (
    ('atom-readout', 'ggpm_tpu/models/encoder.py:48 (graph level)'),
    ('cluster', 'ggpm_tpu/models/encoder.py:194'),
    ('inter-readout', 'ggpm_tpu/models/encoder.py:48 (inter level)'),
    ('tree-readout', 'ggpm_tpu/models/encoder.py:48 (tree level)'),
    ('root', 'ggpm_tpu/models/encoder.py:216'))
HIER_STEP_SITES = (
    ('atom-frontier', 'ggpm_tpu/models/hier_decoder.py:446'),
    ('topo-cluster', 'ggpm_tpu/models/hier_decoder.py:457'),
    ('topo-inter', 'ggpm_tpu/models/hier_decoder.py:462'),
    ('topo-tree', 'ggpm_tpu/models/hier_decoder.py:469'),
    ('mess-cluster', 'ggpm_tpu/models/hier_decoder.py:479'))
# the depth loop's gather: depthG rounds at the atom level, then depthT
# at the attachment level and depthT at the motif level (both over the
# tree's bgraph, so one case: the motif level's last round)
HIER_GATHER_SITES = (('atom-gather', 'ggpm_tpu/ops/graph_ops.py:122 '
                      '(graph level)'),
                     ('tree-gather', 'ggpm_tpu/ops/graph_ops.py:122 '
                      '(inter and tree levels)'))
HIER_STEP = 20      # the decode step whose frontier sums are recorded
# where the port makes each hier site's call: the kernel, the function
# (module, qualified name) whose frame is on the call's stack, and text
# found on the calling line of that function and on no other
HIER_SITE_CALLS = {
    'atom-readout': ('nei_sum', 'encoder', 'HierMPNEncoder.forward',
                     ('self.graph_encoder(',)),
    'cluster': ('nei_sum', 'encoder', 'HierMPNEncoder.forward',
                ("tree['cgraph']",)),
    'inter-readout': ('nei_sum', 'encoder', 'HierMPNEncoder.forward',
                      ('self.inter_encoder(',)),
    'tree-readout': ('nei_sum', 'encoder', 'HierMPNEncoder.forward',
                     ('self.tree_encoder(',)),
    'root': ('nei_sum', 'encoder', 'HierMPNEncoder.forward',
             ('nei = readout(hmess',)),
    'atom-frontier': ('nei_sum', 'hier_decoder',
                      'HierDecoder.hdec_graph_update', ('nei = nei_sum(',)),
    'topo-cluster': ('nei_sum', 'hier_decoder', 'HierDecoder.hdec_topo',
                     ('nei_sum(hatom, v_cgraph)',)),
    'topo-inter': ('nei_sum', 'hier_decoder', 'HierDecoder.hdec_topo',
                   ('nei_sum(self.inter_rnn',)),
    'topo-tree': ('nei_sum', 'hier_decoder', 'HierDecoder.hdec_topo',
                  ('nei_sum(self.tree_rnn',)),
    'mess-cluster': ('nei_sum', 'hier_decoder',
                     'HierDecoder.hdec_mess_update',
                     ('nei_sum(hatom, src_cgraph)',)),
    'atom-gather': ('gather_rows', 'encoder', 'HierMPNEncoder.forward',
                    ('self.graph_encoder(',)),
    'tree-gather': ('gather_rows', 'encoder', 'HierMPNEncoder.forward',
                    ('self.inter_encoder(', 'self.tree_encoder(')),
}
# the turbo decode's propose step (HierDecoder.propose_step_): its four
# frontier sums, each a K1 launch, at the JAX line it ports
HIER_PROPOSE_SITES = (
    ('propose-atom', 'ggpm_tpu/models/hier_decoder.py:1063'),
    ('propose-cluster', 'ggpm_tpu/models/hier_decoder.py:1068'),
    ('propose-inter', 'ggpm_tpu/models/hier_decoder.py:1073'),
    ('propose-tree', 'ggpm_tpu/models/hier_decoder.py:1083'))
HIER_SITE_CALLS.update({
    'propose-atom': ('nei_sum', 'hier_decoder', 'HierDecoder.propose_step_',
                     ('atom_nei = nei_sum(',)),
    'propose-cluster': ('nei_sum', 'hier_decoder',
                        'HierDecoder.propose_step_', ('hclu_v = nei_sum(',)),
    'propose-inter': ('nei_sum', 'hier_decoder', 'HierDecoder.propose_step_',
                      ('inter_nei = nei_sum(',)),
    'propose-tree': ('nei_sum', 'hier_decoder', 'HierDecoder.propose_step_',
                     ('tree_nei = nei_sum(',))})
HIER_SITE_NAMES = tuple(site for site, _ in HIER_ENCODE_SITES +
                        HIER_STEP_SITES + HIER_GATHER_SITES)
HIER_PROPOSE_NAMES = tuple(site for site, _ in HIER_PROPOSE_SITES)
assert set(HIER_SITE_NAMES + HIER_PROPOSE_NAMES) == set(HIER_SITE_CALLS)
HIER_TURBO_STEP = 20   # the propose step whose sums hier_turbo_cases take


def hier_site_lines(names: Sequence[str] = HIER_SITE_NAMES) -> dict:
    """``{(kernel, code object, line): site}`` of ``HIER_SITE_CALLS``'s
    ``names``, read from the port's source."""
    from .models import encoder, hier_decoder
    modules = {'encoder': encoder, 'hier_decoder': hier_decoder}
    lines = {}
    for site in names:
        kernel, module, qualname, texts = HIER_SITE_CALLS[site]
        fn = modules[module]
        for part in qualname.split('.'):
            fn = getattr(fn, part)
        src, start = inspect.getsourcelines(fn)
        for text in texts:
            at = [start + i for i, line in enumerate(src) if text in line]
            if len(at) != 1:
                raise AssertionError(f'{site}: {text!r} is on {len(at)} '
                                     f'lines of {qualname}')
            lines[(kernel, fn.__code__, at[0])] = site
    return lines


@contextlib.contextmanager
def hier_sites(keep: bool = False):
    """Count each hier call site's calls and kernel launches while the
    block runs.  ``encoder.nei_sum``, ``hier_decoder.nei_sum`` and
    ``rnn.gather_rows`` (the wrappers as those modules call them) are
    replaced by functions that call the wrapper, take the change of its
    ``launches`` and add it to the site whose line (``HIER_SITE_CALLS``)
    is on the call's stack: the innermost frame of a site's function, at
    the line it is running.  Yields ``{site: {'calls', 'launches'}}``
    with the calls no site made under None; with ``keep``, each site's
    entry also holds copies of the arguments of its last call
    (``'args'``).  The sites are the serve path's (``HIER_SITE_NAMES``)
    and the turbo decode's propose step's four (``HIER_PROPOSE_SITES``);
    ``'replay'`` holds the launches the wrappers gained outside any call,
    by CUDA graph replays of a captured step
    (``models/decode.py:Proposer.run_step``).  A call recorded by a
    capture launches nothing: it counts as a call."""
    from .models import encoder, hier_decoder, rnn
    names = HIER_SITE_NAMES + HIER_PROPOSE_NAMES
    lines = hier_site_lines(names)
    codes = {code for _, code, _ in lines}
    counts = {site: dict(calls=0, launches=0) for site in names + (None,)}
    patched = [(encoder, 'nei_sum'), (hier_decoder, 'nei_sum'),
               (rnn, 'gather_rows')]
    originals = [getattr(m, name) for m, name in patched]
    wrappers = (nei_sum, gather_rows)
    start = sum(w.launches for w in wrappers)

    def counted(fn, kernel):
        def call(*args):
            before = fn.launches
            out = fn(*args)
            frame = sys._getframe(1)
            while frame is not None and frame.f_code not in codes:
                frame = frame.f_back
            site = None if frame is None else \
                lines.get((kernel, frame.f_code, frame.f_lineno))
            entry = counts[site]
            entry['calls'] += 1
            entry['launches'] += fn.launches - before
            if keep and site is not None:
                entry['args'] = tuple(a.clone() for a in args)
            return out
        return call
    for (m, name), fn in zip(patched, originals):
        setattr(m, name, counted(fn, name))
    try:
        yield counts
    finally:
        for (m, name), fn in zip(patched, originals):
            setattr(m, name, fn)
        counts['replay'] = dict(calls=0, launches=sum(
            w.launches for w in wrappers) - start - sum(
            c['launches'] for c in counts.values()))


def hier_cases(model, vocab, rows: Sequence[list], decode_rows: int = 16,
               step: int = HIER_STEP) -> List[dict]:
    """The hier family's kernel cases on the inputs its serve path gives
    them (``measure`` cases, named by ``HIER_*_SITES``): the last call at
    each site (``hier_sites``) in one encode of ``rows`` by ``model`` (a
    hier model on the card), and in the exact decode of the first
    ``decode_rows`` of their latents cut at step ``step``."""
    from .models import decode
    from .models.api import encode
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    with hier_sites(keep=True) as enc:
        z = encode(model, batch)[0]
    with hier_sites(keep=True) as dec:
        decode.decode_hier(model, vocab, common_atom_vocab,
                           z[:decode_rows], max_decode_step=step)
    calls = {site: enc[site]['calls'] + dec[site]['calls']
             for site in HIER_SITE_NAMES + (None,)}
    cfg = model.cfg
    expected = {**{site: 1 for site, _ in HIER_ENCODE_SITES},
                **{site: step for site, _ in HIER_STEP_SITES},
                'atom-gather': cfg.depthG, 'tree-gather': 2 * cfg.depthT,
                None: 0}
    if calls != expected:
        raise AssertionError(f'hier_cases: calls {calls}, expected '
                             f'{expected}')
    cases = [nei_sum_case(f'hier-{site}', *enc[site]['args'])
             for site, _ in HIER_ENCODE_SITES]
    cases += [nei_sum_case(f'hier-{site}', *dec[site]['args'])
              for site, _ in HIER_STEP_SITES]
    cases += [gather_rows_case(f'hier-{site}', *enc[site]['args'])
              for site, _ in HIER_GATHER_SITES]
    return cases


def hier_turbo_cases(model, vocab, latents: Sequence[torch.Tensor],
                     step: int = HIER_TURBO_STEP, T: int = TURBO_T
                     ) -> List[dict]:
    """The hier turbo decode's kernel cases (``measure`` cases named
    ``hier-turbo-<site>-B<width>``): for each batch of ``latents`` (on the
    card), the four ``nei_sum`` calls of the propose step
    (``HIER_PROPOSE_SITES``) at step ``step`` of an eager propose round at
    the turbo decode's budgets and a ``T``-step rung, on the inputs that
    round gives them (``hier_sites``)."""
    from .models import decode
    from .graph.vocab import common_atom_vocab as avocab
    tabs, mask = decode._device_vocab(vocab, avocab, latents[0].device)
    budgets = decode.hier_budgets(vocab, avocab)
    cases = []
    for z in latents:
        with torch.inference_mode(), hier_sites(keep=True) as at:
            prop = decode.HierProposer(model, mask, tabs, 5, T, len(z),
                                       graph=False, budgets=budgets)
            prop.start(z)
            for _ in range(step):
                prop.run_step()
        calls = {site: at[site]['calls'] for site in HIER_PROPOSE_NAMES}
        if calls != {site: step for site in HIER_PROPOSE_NAMES}:
            raise AssertionError(f'hier_turbo_cases: calls {calls}, '
                                 f'expected {step} each')
        cases += [nei_sum_case(f'hier-turbo-{site}-B{len(z)}',
                               *at[site]['args'])
                  for site in HIER_PROPOSE_NAMES]
    return cases


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


def a5_cases(batch: dict, gen: torch.Generator, hidden: int = 250
             ) -> List[dict]:
    """The kernels' new calls in a training step of ROADMAP A5's options,
    on a device batch's tables (``Trainer.device_batch``) at the width
    ``hidden``: the GRU's depth gather of ``[h | h·U_r + b_r]`` (2H
    columns) in f32, forward (``gather_rows``) and backward
    (``transpose_sum``, div 1); and the bf16 encoders' calls: the depth
    gather at the LSTM's 3H and the GRU's 2H, each with its backward, the
    node readout (``nei_sum``) and its backward (div A).  Each case as
    ``train_cases`` gives it; the plain versions and the in-order sums of
    a bf16 case sum in f32 and round once, as the kernels do."""
    tree = batch['tree']
    dev = gen.device
    H = hidden
    bf16 = torch.bfloat16
    bg = tree['bgraph']
    n_mess = tree['fmess'].shape[0]
    ag = tree['agraph']
    cases = []
    for name, width, dtype in (('gru-depth-gather', 2 * H, torch.float32),
                               ('bf16-depth-gather', 3 * H, bf16),
                               ('bf16-gru-depth-gather', 2 * H, bf16)):
        cases.append(gather_rows_case(name, random_table(gen, n_mess, width,
                                                         dtype), bg))
        g = (torch.rand((bg.numel(), width), generator=gen, device=dev)
             * 2 - 1).to(dtype)
        cases.append(transpose_case(f'{name}-bwd', g, tree['bgraph_t'],
                                    tree['bgraph_tm'], 1))
    cases.append(nei_sum_case('bf16-readout', random_table(gen, n_mess, H,
                                                            bf16), ag))
    g = (torch.rand((ag.shape[0], H), generator=gen, device=dev) * 2 - 1
         ).to(bf16)
    cases.append(transpose_case('bf16-readout-bwd', g, tree['agraph_t'],
                                tree['agraph_tm'], ag.shape[1]))
    return cases


# the scheduled-sampling scan's frontier readout (MotifDecoder.
# scheduled_forward), B1's call site in JAX's per-step loop
SCHED_SITE = 'ggpm_tpu/models/decoder.py:470'


@contextlib.contextmanager
def sched_site():
    """Count the scheduled readout's calls and kernel launches while the
    block runs: ``decoder.nei_sum_t`` is replaced by a function that
    calls it and, where ``MotifDecoder.scheduled_forward``'s frame is on
    the call's stack at its ``self._readout(`` line, adds the call and
    the change of ``nei_sum``'s ``launches`` to ``'sched-readout'``, and
    hooks the output's backward node, whose run adds its call and the
    change of ``transpose_sum``'s ``launches`` to ``'sched-readout-bwd'``
    (the autograd engine runs one node of a device at a time).  Yields
    ``{case: {'calls', 'launches'}}``.  A call recorded by a CUDA graph
    capture launches nothing, and a replay calls nothing: the launches
    are those the calls made."""
    from .models import decoder
    fn = decoder.MotifDecoder.scheduled_forward
    src, start = inspect.getsourcelines(fn)
    at = [start + i for i, line in enumerate(src) if 'self._readout(' in line]
    if len(at) != 1:
        raise AssertionError(f'self._readout( is on {len(at)} lines of '
                             f'scheduled_forward')
    code, line = fn.__code__, at[0]
    counts = {case: dict(calls=0, launches=0)
              for case in ('sched-readout', 'sched-readout-bwd')}
    original = decoder.nei_sum_t

    def backward_counted():
        entry, before = counts['sched-readout-bwd'], []

        def pre(grad_outputs):
            before.append(transpose_sum.launches)

        def post(grad_inputs, grad_outputs):
            entry['calls'] += 1
            entry['launches'] += transpose_sum.launches - before.pop()
        return pre, post

    def call(*args):
        before = nei_sum.launches
        out = original(*args)
        frame = sys._getframe(1)
        while frame is not None and frame.f_code is not code:
            frame = frame.f_back
        if frame is not None and frame.f_lineno == line:
            counts['sched-readout']['calls'] += 1
            counts['sched-readout']['launches'] += nei_sum.launches - before
            if out.grad_fn is not None:
                pre, post = backward_counted()
                out.grad_fn.register_prehook(pre)
                out.grad_fn.register_hook(post)
        return out
    decoder.nei_sum_t = call
    try:
        yield counts
    finally:
        decoder.nei_sum_t = original


def sched_cases(batch: dict, gen: torch.Generator, hidden: int = 250
                ) -> List[dict]:
    """``nei_sum`` and its transpose at the scheduled scan's readout of a
    device batch (``Trainer.device_batch`` of a ``prop-opt-sched``
    model): the sum over the masked frontier table of a state of
    ``num_mess + B`` rows at width ``hidden`` (``sched-readout``), and
    ``transpose_sum`` of a gradient over that table's rows
    (``sched-readout-bwd``, div A), as cases of ``measure``.  Values come
    from ``gen``."""
    tree, plan = batch['tree'], batch['plan']
    fr = plan['frontier']
    h = random_table(gen, tree['fmess'].shape[0] + tree['scope'].shape[0],
                     hidden)
    g = torch.rand((fr.shape[0], hidden), generator=gen,
                   device=gen.device) * 2 - 1
    return [nei_sum_case('sched-readout', h, fr),
            transpose_case('sched-readout-bwd', g, plan['frontier_t'],
                           plan['frontier_tm'], fr.shape[1])]


# the sums of a hier training step (HierMPNEncoder.forward's five readouts,
# HierDecoder.forward's five per-step sums), each with the JAX line it
# ports and its table in a ``data.batching.hier_train_tables`` batch:
# (level, table, transpose key, state rows: level and key of its count)
HIER_TRAIN_SITES = (
    ('enc-atom', 'ggpm_tpu/models/encoder.py:48 (graph level)'),
    ('enc-cluster', 'ggpm_tpu/models/encoder.py:194'),
    ('enc-inter', 'ggpm_tpu/models/encoder.py:48 (inter level)'),
    ('enc-tree', 'ggpm_tpu/models/encoder.py:48 (tree level)'),
    ('enc-root', 'ggpm_tpu/models/encoder.py:216'),
    ('dec-atom', 'ggpm_tpu/models/hier_decoder.py:191'),
    ('dec-cluster-src', 'ggpm_tpu/models/hier_decoder.py:197'),
    ('dec-cluster-x', 'ggpm_tpu/models/hier_decoder.py:204'),
    ('dec-inter', 'ggpm_tpu/models/hier_decoder.py:208'),
    ('dec-tree', 'ggpm_tpu/models/hier_decoder.py:222'))
# the decoder's per-step tables of a site, and the step whose are timed
HIER_TRAIN_PLAN = {'dec-atom': 's_atom', 'dec-cluster-src': 's_clu_src',
                   'dec-cluster-x': 's_clu_x', 'dec-inter': 's_inter',
                   'dec-tree': 's_tree'}
HIER_TRAIN_STEP = 20


def hier_train_site(batch: dict, site: str, step: int = HIER_TRAIN_STEP):
    """A hier training site's ``(rows, graph, t_idx, t_mask)`` in a device
    batch of ``hier_train_tables``: the state rows its sum reads, its
    table and the table's transpose (a decoder site's at ``step``)."""
    tree, graph, plan = batch['tree'], batch['graph'], batch['plan']
    n_mess = tree['fmess'].shape[0]
    if site in HIER_TRAIN_PLAN:
        key = HIER_TRAIN_PLAN[site]
        return (plan[key + '_t'].shape[1], plan[key][step],
                plan[key + '_t'][step], plan[key + '_tm'][step])
    level, key, rows = {
        'enc-atom': (graph, 'agraph', graph['fmess'].shape[0]),
        'enc-cluster': (tree, 'cgraph', graph['fnode'].shape[0]),
        'enc-inter': (tree, 'agraph', n_mess),
        'enc-tree': (tree, 'agraph', n_mess),
        'enc-root': (tree, 'root', n_mess)}[site]
    table = tree['agraph'][tree['scope'][:, 0].long()].contiguous() \
        if site == 'enc-root' else level[key]
    return rows, table, level[key + '_t'], level[key + '_tm']


def hier_train_cases(batch: dict, gen: torch.Generator, hidden: int = 250,
                     step: int = HIER_TRAIN_STEP) -> List[dict]:
    """The new kernel calls of a hier training step on a device batch
    (``Trainer.device_batch`` of the hier family): ``nei_sum`` at each of
    ``HIER_TRAIN_SITES`` (the decoder's at scan step ``step``) and
    ``transpose_sum`` at the transpose of each the step launches (every
    site but the motif level's node readout, which the loss does not
    read; it shares the attachment level's table), at width ``hidden``;
    the atom level's depth-loop gather (``gather_rows`` at 3H over the
    atom ``bgraph``) and the scan's atom-level message-update gather (at
    H over ``plan['u_atom']`` at ``step``), each with its backward.
    Cases of ``measure``, named ``hier-train-<site>`` and ``…-bwd``;
    values from ``gen``."""
    H = hidden
    dev = gen.device
    cases, bwd = [], []
    for site, _ in HIER_TRAIN_SITES:
        rows, table, t_idx, t_mask = hier_train_site(batch, site, step)
        cases.append(nei_sum_case(f'hier-train-{site}',
                                  random_table(gen, rows, H), table))
        if site != 'enc-tree':
            g = torch.rand((table.shape[0], H), generator=gen,
                           device=dev) * 2 - 1
            bwd.append(transpose_case(f'hier-train-{site}-bwd', g, t_idx,
                                      t_mask, table.shape[1]))
    graph, plan = batch['graph'], batch['plan']
    update = plan['u_atom'][step]
    for name, table, t_idx, t_mask, width in (
            ('atom-gather', graph['bgraph'], graph['bgraph_t'],
             graph['bgraph_tm'], 3 * H),
            ('atom-update', update, plan['u_atom_t'][step],
             plan['u_atom_tm'][step], H)):
        cases.append(gather_rows_case(
            f'hier-train-{name}', random_table(gen, t_idx.shape[0], width),
            table))
        g = torch.rand((table.numel(), width), generator=gen,
                       device=dev) * 2 - 1
        bwd.append(transpose_case(f'hier-train-{name}-bwd', g, t_idx,
                                  t_mask, 1))
    return cases + bwd


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
        bytes=g.element_size() * (read + t_idx.shape[0]) * width +
        8 * t_idx.numel(), ops=nnz * width, args=(g, t_idx, t_mask, div))


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
                   dtype=str(out.dtype).removeprefix('torch.'),
                   bytes=c['bytes'], bound_ms=bound_ms, bound_by=bound_by,
                   floor_ms=floor,
                   max_abs_err=(out.float() - ref.float()).abs().max().item(),
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
    ap.add_argument('--hier', action='store_true',
                    help='time nei_sum and gather_rows at the hier '
                         'family\'s call sites instead')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('kernel_bench needs a CUDA device')
    smi = nvidia_smi()
    print(smi, flush=True)
    rows = []
    if args.hier:
        from .bridge import load_model
        from .profile_serve import HIER_CKPT, HIER_VOCAB
        model, vocab = load_model(HIER_CKPT, HIER_VOCAB, device='cuda')
        hrows = prune_to_vocab(read_csv_data(DATA), vocab,
                               verbose=False)[:N_MOLS]
        hbatch = to_model_batch(tensorize(hrows, vocab, common_atom_vocab),
                                vocab.mask, pad=False)
        from .models.api import encode
        latents = [encode(model, hbatch)[0], torch.as_tensor(
            np.random.default_rng(0).standard_normal(
                (DECODE_BATCHES[1], model.cfg.latent_size)).astype(
                np.float32), device='cuda')]
        cases = hier_cases(model, vocab, hrows) + \
            hier_turbo_cases(model, vocab, latents)
        for row in measure(cases, floor_ms()):
            row['device'] = smi
            print(f'{row["kernel"]} ' + json.dumps(row), flush=True)
            rows.append(row)
    elif args.transpose:
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
