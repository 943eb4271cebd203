"""The depth loop's row gather: ``out[n, a] = src[graph[n, a]]``, with the
transpose of ``nei_sum`` as its backward.

The forward is hand-written CUDA for sm_90a, ``csrc/gather_rows.cu`` (the
source says what bounds it); the backward is ``nei_sum.transpose_sum`` over
the host-built transpose of ``graph`` with ``div`` = 1.  Together they are
``gather_nd_t``, the counterpart of ``ggpm_tpu/ops/graph_ops.py:gather_nd_t``
(ROADMAP B2), which the training path's depth loop calls every round to
gather ``[h | h·Kf | c]`` by ``bgraph``; where no gradient is taken (the
serve and decode encodes) the loop calls ``gather_rows`` itself.

The kernel copies rows as bytes, so it takes f32 and bf16 tables alike
(the bf16 depth loops of a ``compute_dtype`` 'bf16' encoder).
``gather_rows`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes the plain version,
``graph_ops.gather_nd``.  ``gather_rows.launches`` counts launches
(``nei_sum.count_launch``).  ``plan`` chooses the launch (the kernel's
path, chunks a thread, threads a block, grid) from the shapes, the element
size and the base pointers' alignment alone, in plain Python, so the CPU
tests reach it; ``device_plan`` / ``launch`` run a given plan, so a
measurement can compare plans on the same inputs.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import graph_ops
from .cuda_build import library
from .nei_sum import ELEM, MAX_GRID, _sms, count_launch, transpose_sum

# the kernel's constants (csrc/gather_rows.cu: kMaxThreads, kMaxTotal, Kind)
MAX_THREADS = 256          # threads per block
MAX_TOTAL = 2 ** 31 - 1    # words or rows a launch copies
KINDS = ('blocks', 'rows')  # the kernel's paths
CHUNKS = (1, 2)            # chunks a thread on ``blocks``: its templates
CHUNK_BYTES = 16           # a chunk of ``blocks``
ACCESS_BYTES = (16, 8, 4, 2)   # the ``rows`` path's accesses
SM_THREADS = 2048          # threads an H100 SM holds
# the wrapper's plan (PERF.md, section 6): ``rows`` where a row's accesses
# are one pass that fills at least ROW_FILL of the threads it takes; two
# chunks a thread where the stream holds TWO_CHUNK_WAVES waves of one
# chunk a thread (sms * SM_THREADS threads a wave), else one
ROW_FILL = 15 / 16
TWO_CHUNK_WAVES = 8


@dataclass(frozen=True)
class Plan:
    """One launch of ``csrc/gather_rows.cu`` along path ``kind``: ``grid``
    blocks of ``threads`` threads.  On ``blocks`` each thread copies
    ``chunks`` chunks of ``vec`` = 16 bytes of the output stream; on
    ``rows`` each row takes ``tpr`` threads (``row_threads``) that copy
    its accesses of ``vec`` bytes, ``threads // tpr`` rows a block.
    ``elem``: the bytes of an element."""
    kind: str
    chunks: int
    threads: int
    grid: int
    vec: int
    elem: int = 4


def alignment(t: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides ``t``'s address."""
    ptr = t.data_ptr()
    return next(a for a in (16, 8, 4, 2, 1) if ptr % a == 0)


def row_access(width: int, elem: int, src_align: int, out_align: int
               ) -> Tuple[int, int]:
    """The ``rows`` path's (access bytes, accesses a row): the widest
    access that divides the row's bytes and both bases' alignment."""
    row_bytes = width * elem
    vec = next(v for v in ACCESS_BYTES if v >= elem and not (
        row_bytes % v or src_align % v or out_align % v))
    return vec, row_bytes // vec


def row_threads(cols: int, threads: int) -> int:
    """The ``rows`` path's threads a row (the kernel's ``tpr``): a row's
    ``cols`` accesses rounded up to a warp, at most the block's
    ``threads``."""
    return min(-(-cols // 32) * 32, threads)


@functools.lru_cache(maxsize=1024)
def plan(rows: int, width: int, elem: int, src_align: int, out_align: int,
         sms: int, kind: Optional[str] = None, chunks: Optional[int] = None,
         threads: Optional[int] = None) -> Plan:
    """The launch for ``rows`` output rows of ``width`` elements of
    ``elem`` bytes (4: f32, 2: bf16) from a source whose base address is a
    multiple of ``src_align`` into an output whose base is a multiple of
    ``out_align``, on a card of ``sms`` SMs.

    ``rows`` (the per-row mapping) where a row's accesses (``row_access``)
    are one pass of at most ``MAX_THREADS`` threads that they fill to
    ``ROW_FILL``, or where ``blocks`` does not fit; else the stream
    ``blocks`` (16-byte stores; 16-byte loads where a chunk lies in one
    source row), which takes rows of a multiple of 4 bytes, at least 16 of
    them, from a 4-byte aligned source into a 16-byte aligned output.  On
    ``blocks``, chunks a thread: 2 where the stream holds
    ``TWO_CHUNK_WAVES`` waves of threads of one chunk, else 1.  Threads a
    block: ``MAX_THREADS``, on ``rows`` as many whole rows as fit.
    ``kind``, ``chunks`` and ``threads`` may be forced, for measurements
    that compare plans."""
    if rows <= 0 or width <= 0 or elem not in ELEM.values() or \
            src_align % elem or out_align % elem:
        raise ValueError(f'gather_rows plan: rows {rows}, width {width}, '
                         f'{elem}-byte elements, alignment {src_align}, '
                         f'{out_align}')
    row_bytes = width * elem
    wide = (row_bytes % 4 == 0 and row_bytes >= 16 and src_align % 4 == 0
            and out_align % 16 == 0)
    vec, cols = row_access(width, elem, src_align, out_align)
    tpr = row_threads(cols, MAX_THREADS)
    fills = cols <= MAX_THREADS and cols >= ROW_FILL * tpr
    kind = kind or ('blocks' if wide and not fills else 'rows')
    if kind not in KINDS or (kind == 'blocks' and not wide):
        raise ValueError(f'gather_rows plan: no {kind!r} path for rows of '
                         f'{row_bytes} bytes at alignment {src_align}, '
                         f'{out_align}')
    if threads is None:
        threads = tpr * (MAX_THREADS // tpr) if kind == 'rows' \
            else MAX_THREADS
    if not (0 < threads <= MAX_THREADS and threads % 32 == 0) or \
            (kind == 'rows' and threads % row_threads(cols, threads)):
        raise ValueError(f'gather_rows plan: {threads} threads a block')
    if kind == 'rows':
        if chunks not in (None, 1):
            raise ValueError(f'gather_rows plan: {chunks} chunks a thread '
                             f'on rows')
        rpb = threads // row_threads(cols, threads)
        return _checked(Plan(kind, 1, threads, -(-rows // rpb), vec, elem),
                        rows)
    n = -(-rows * row_bytes // CHUNK_BYTES)     # the output's chunks
    if chunks is None:
        chunks = 2 if n >= TWO_CHUNK_WAVES * sms * SM_THREADS else 1
    if chunks not in CHUNKS:
        raise ValueError(f'gather_rows plan: {chunks} chunks a thread')
    return _checked(Plan(kind, chunks, threads, -(-n // (chunks * threads)),
                         CHUNK_BYTES, elem), rows * row_bytes // 4)


def _checked(p: Plan, total: int) -> Plan:
    if total > MAX_TOTAL or p.grid > MAX_GRID:
        raise ValueError(f'gather_rows plan: {total} words or rows, grid '
                         f'{p.grid}: too large')
    return p


@functools.lru_cache(maxsize=64)
def divider(d: int) -> Tuple[int, int]:
    """``(mul, shr)`` with ``x // d == (x * mul >> 32) >> shr`` for every
    ``0 <= x < 2**31`` and ``1 <= d < 2**31`` (``mul`` 0 for d = 1, where
    the kernel takes x itself): the round-up method, ``mul`` =
    ceil(2**p / d) for p = 31 + ceil(log2 d), whose error ``mul·d - 2**p``
    < d keeps ``x·error`` below ``2**p``."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f'gather_rows: no divider for {d}')
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()
    return -(-(1 << p) // d), p - 32


def _lib() -> ctypes.CDLL:
    lib = library('gather_rows')
    fn = lib.ggpm_gather_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
            ctypes.c_int] * 4 + [ctypes.c_int64, ctypes.c_uint32,
                                 ctypes.c_uint32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def device_plan(src: torch.Tensor, graph: torch.Tensor, out: torch.Tensor,
                kind: Optional[str] = None, chunks: Optional[int] = None,
                threads: Optional[int] = None) -> Plan:
    """``plan`` for these CUDA tensors on their card (``kind``,
    ``chunks`` and ``threads`` as there)."""
    return plan(graph.numel(), src.shape[1], src.element_size(),
                alignment(src), alignment(out), _sms(src.device.index), kind,
                chunks, threads)


def launch(src: torch.Tensor, graph: torch.Tensor, out: torch.Tensor,
           p: Plan) -> torch.Tensor:
    """Launch plan ``p`` into ``out`` [N, A, W] on the current stream;
    raises if the launch fails."""
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        if src.element_size() != p.elem:
            raise ValueError(f'gather_rows: a plan for {p.elem}-byte '
                             f'elements launched on {src.dtype}')
        row_bytes = src.shape[1] * p.elem
        err = _lib().ggpm_gather_rows(
            src.data_ptr(), graph.data_ptr(), out.data_ptr(), graph.numel(),
            row_bytes, KINDS.index(p.kind), p.vec, p.chunks, p.threads,
            p.grid, *(divider(row_bytes // 4) if p.kind == 'blocks'
                      else (0, 0)), stream)
        if err:
            raise RuntimeError(f'gather_rows kernel launch failed: CUDA '
                               f'error {err}')
        count_launch(gather_rows, src.dtype)
    return out


def gather_rows(src: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """``src[graph]`` for f32 or bf16 ``src`` [M, W] and int32 ``graph``
    [N, A] whose entries lie in [0, M).  The kernel has no backward of its own:
    where ``src`` needs a gradient on the card, call ``gather_nd_t``."""
    if src.device != graph.device:
        raise ValueError(f'gather_rows: src on {src.device}, graph on '
                         f'{graph.device}')
    if src.dtype not in ELEM or graph.dtype != torch.int32:
        raise TypeError(f'gather_rows takes float32 or bfloat16 src and '
                        f'int32 graph, got {src.dtype} and {graph.dtype}')
    if src.dim() != 2 or graph.dim() != 2:
        raise ValueError(f'gather_rows takes src [M, W] and graph [N, A], '
                         f'got {tuple(src.shape)} and {tuple(graph.shape)}')
    if not (src.is_contiguous() and graph.is_contiguous()):
        raise ValueError('gather_rows takes contiguous src and graph')
    if src.device.type == 'cpu':
        return graph_ops.gather_nd(src, graph)
    if src.device.type != 'cuda':
        raise ValueError(f'gather_rows: no kernel for device {src.device}')
    if src.requires_grad and torch.is_grad_enabled():
        raise ValueError('gather_rows: src needs a gradient; pass the '
                         'transpose of graph to gather_nd_t')
    out = torch.empty((*graph.shape, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    if graph.numel() == 0:
        return out
    return launch(src, graph, out, device_plan(src, graph, out))


gather_rows.launches = gather_rows.captured = 0
gather_rows.launches_bf16 = gather_rows.captured_bf16 = 0


class _GatherNdT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, graph, t_idx, t_mask):
        ctx.save_for_backward(t_idx, t_mask)
        return gather_rows(h, graph)

    @staticmethod
    def backward(ctx, gout):
        t_idx, t_mask = ctx.saved_tensors
        g2 = gout.reshape(-1, gout.shape[-1]).contiguous()
        return transpose_sum(g2, t_idx, t_mask, 1), None, None, None


def gather_nd_t(h: torch.Tensor, graph: torch.Tensor, t_idx: torch.Tensor,
                t_mask: torch.Tensor) -> torch.Tensor:
    """Row gather by a padded [N, A] table whose backward is a gather over
    ``(t_idx, t_mask) = build_transpose(graph, len(h))`` (counterpart of
    ``ggpm_tpu/ops/graph_ops.py:gather_nd_t``).  The table leaves out row
    0, so the gradient of ``h[0]`` is zero: exact where the padding-slot
    cotangent is zero or the row-0 source cotangent is dead, as at the
    depth loop, whose state passes through ``zero_row0`` every round (see
    ``nei_sum.nei_sum_t``)."""
    return _GatherNdT.apply(h, graph, t_idx, t_mask)
