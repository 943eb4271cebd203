"""Peaks of the card and the least time a kernel launch can take.

The bytes a launch must move count each input byte it reads once and
each output byte it writes once: for the neighbour sum (``nei_sum``) the
distinct rows of ``h`` its table names, the table and the output; for
the row gather (``gather_rows``) the distinct source rows, the table and
the output; for the transpose (``transpose_sum``) the distinct rows of
``g`` its real entries read, both tables and the output (the arithmetic
of the port's ``kernel_bench.py``, copied).

A launch whose working set fits the 50 MB L2 cache can beat HBM's rate:
inside a training step its inputs were written a moment before.  So its
bound uses the larger of HBM's rate and the rate at which a plain copy of
an L2-resident buffer of the launch's working-set size runs on the same
card in the same run (``copy_rate``: a CUDA graph of copies replayed
between CUDA events), measured once for each size class of the
launches' working sets (``size_class``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# NVIDIA H100 SXM data sheet, at its 700 W limit
PEAKS = {
    'hbm_bytes_per_s': 3.35e12,
    'fp32_flops_per_s': 67e12,       # float32 outside the tensor cores
}


def _distinct(idx: torch.Tensor) -> int:
    return int(torch.unique(idx).numel())


def nei_sum_bytes(h: torch.Tensor, graph: torch.Tensor) -> int:
    rows = _distinct(graph)
    return (h.element_size() * (rows + graph.shape[0]) * h.shape[1] +
            4 * graph.numel())


def gather_rows_bytes(src: torch.Tensor, graph: torch.Tensor) -> int:
    return (src.element_size() * (_distinct(graph) + graph.numel()) *
            src.shape[1] + 4 * graph.numel())


def transpose_sum_bytes(g: torch.Tensor, t_idx: torch.Tensor,
                        t_mask: torch.Tensor, div: int) -> int:
    read = _distinct((t_idx // div)[t_mask > 0])
    return (g.element_size() * (read + t_idx.shape[0]) * g.shape[1] +
            8 * t_idx.numel())


def copy_rate(nbytes: int, device, inner: int = 20, reps: int = 5) -> float:
    """Bytes a second of a plain ``copy_`` that reads ``nbytes / 2`` and
    writes as many, its buffers resident in L2 after the first of
    ``inner`` back-to-back copies, replayed from a CUDA graph between
    CUDA events (median of ``reps``)."""
    n = max(1024, -(-nbytes // 8 // 1024) * 1024)   # whole 4 KiB a side
    src = torch.ones(n, device=device)
    dst = torch.empty_like(src)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        dst.copy_(src)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            dst.copy_(src)
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / inner)
    del graph
    times.sort()
    return 8 * n / times[len(times) // 2]


def size_class(nbytes: int) -> int:
    """The working-set size whose copy rate stands for ``nbytes``: the
    next of 16 steps an octave (at most 6.25 % above it)."""
    if nbytes <= 4096:
        return 4096
    e = math.floor(math.log2(nbytes))
    step = 2 ** e / 16
    return int(2 ** e + math.ceil((nbytes - 2 ** e) / step) * step)


def bound_s(nbytes: int, rates: Dict[int, float]) -> Tuple[float, str]:
    """The least seconds a launch moving ``nbytes`` can take, and which
    peak bounds it ('hbm' or 'l2_copy'); ``rates`` maps a size class
    (``size_class``) to its measured ``copy_rate``."""
    hbm = PEAKS['hbm_bytes_per_s']
    l2 = rates.get(size_class(nbytes), 0.0)
    return (nbytes / l2, 'l2_copy') if l2 > hbm else (nbytes / hbm, 'hbm')
