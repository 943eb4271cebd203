"""The depth loop's row gather: ``out[n, a] = src[graph[n, a]]``, with the
transpose of ``nei_sum`` as its backward.

The forward is hand-written CUDA for sm_90a, ``csrc/gather_rows.cu`` (the
source says what bounds it); the backward is ``nei_sum.transpose_sum`` over
the host-built transpose of ``graph`` with ``div`` = 1.  Together they are
``gather_nd_t``, the counterpart of ``ggpm_tpu/ops/graph_ops.py:gather_nd_t``
(ROADMAP B2), which the training path's depth loop calls every round to
gather ``[h | h·Kf | c]`` by ``bgraph``; where no gradient is taken (the
serve and decode encodes) the loop calls ``gather_rows`` itself.

``gather_rows`` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it computes the plain version,
``graph_ops.gather_nd``.  ``gather_rows.launches`` counts launches.
``plan`` chooses the launch from the shapes alone.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import graph_ops
from .cuda_build import library
from .nei_sum import MAX_GRID, transpose_sum, vec_width

MAX_THREADS = 256          # threads per block (csrc/gather_rows.cu: kMaxThreads)


@dataclass(frozen=True)
class Plan:
    """One launch of ``csrc/gather_rows.cu``: ``grid`` blocks of ``tpr`` x
    ``rpb`` threads, ``tpr`` threads per output row, each copying column
    chunks of ``vec`` floats."""
    vec: int
    tpr: int
    rpb: int
    grid: int


def plan(rows: int, width: int, vec: int) -> Plan:
    """The launch for ``rows`` output rows of ``width`` floats read as
    ``vec``-wide chunks: one chunk per thread up to ``MAX_THREADS`` threads
    a row (rounded up to a warp), the rest of the block's threads on
    further rows."""
    if rows <= 0 or width % vec:
        raise ValueError(f'gather_rows plan: rows {rows}, width {width}, '
                         f'vec {vec}')
    tpr = min(MAX_THREADS, -(-(width // vec) // 32) * 32)
    rpb = MAX_THREADS // tpr
    grid = -(-rows // rpb)
    if grid > MAX_GRID:
        raise ValueError(f'gather_rows plan: grid {grid} too large')
    return Plan(vec, tpr, rpb, grid)


def _lib() -> ctypes.CDLL:
    lib = library('gather_rows')
    fn = lib.ggpm_gather_rows_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch(src: torch.Tensor, graph: torch.Tensor, out: torch.Tensor,
           p: Plan) -> torch.Tensor:
    """Launch plan ``p`` into ``out`` [N, A, W] on the current stream;
    raises if the launch fails."""
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _lib().ggpm_gather_rows_f32(
            src.data_ptr(), graph.data_ptr(), out.data_ptr(), graph.numel(),
            src.shape[1] // p.vec, p.vec, p.tpr, p.rpb, p.grid, stream)
    if err:
        raise RuntimeError(f'gather_rows kernel launch failed: CUDA error {err}')
    gather_rows.launches += 1
    return out


def gather_rows(src: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """``src[graph]`` for f32 ``src`` [M, W] and int32 ``graph`` [N, A]
    whose entries lie in [0, M).  The kernel has no backward of its own:
    where ``src`` needs a gradient on the card, call ``gather_nd_t``."""
    if src.device != graph.device:
        raise ValueError(f'gather_rows: src on {src.device}, graph on '
                         f'{graph.device}')
    if src.dtype != torch.float32 or graph.dtype != torch.int32:
        raise TypeError(f'gather_rows takes float32 src and int32 graph, '
                        f'got {src.dtype} and {graph.dtype}')
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
    p = plan(graph.numel(), src.shape[1], vec_width(src, out))
    return launch(src, graph, out, p)


gather_rows.launches = 0


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
