"""The neighbour gather-sum kernel: ``out[n] = Σ_a h[graph[n, a]]``, and
its transpose, which is its backward.

Port of the Pallas TPU kernel ``ggpm_tpu/ops/pallas_gather.py:_kernel``
(ROADMAP B1) as hand-written CUDA for sm_90a, ``csrc/nei_sum.cu``; the
source says how it is laid out and what bounds it.  The encoder calls it at
both of its readouts (the node readout over ``agraph`` and the root readout),
the decoder at its frontier readouts (decode steps and the teacher-forced
scan).  ``transpose_sum`` launches its transpose
(``out[m] = Σ_k mask[m, k] · g[t_idx[m, k] // div]``), a kernel of its own
shaped for the training step's backward, ``csrc/transpose_sum.cu``; and
``nei_sum_t`` is ``nei_sum`` with that as its backward, an autograd
Function.

Both kernels take f32 or bf16 tables (``h``, ``g`` and ``out``; the
transpose's mask stays f32).  A bf16 table is summed in f32 and rounded to
bf16 once, at the store, as the JAX models' ``jnp.sum`` of a bf16 table
is; its plain versions (``graph_ops``) sum in f32 in the kernel's order
and round once too, so the card's kernel equals them bit for bit.

``plan`` and ``plan_t`` choose each kernel's launch (load width, threads
per row, rows per block, grid; the forward's kind, the transpose's column
chunks per thread) from the shapes and the element size alone, in plain
Python, so the CPU tests reach them.  ``nei_sum`` and ``transpose_sum``
launch their kernels for CUDA tensors and raise if they cannot; they never
fall back.  For CPU
tensors they compute the plain versions, ``graph_ops.nei_sum`` and
``graph_ops.transpose_sum``.  ``nei_sum.launches`` and
``transpose_sum.launches`` count the kernel launches that run
(``count_launch``: a launch a CUDA graph capture records is counted in
``.captured`` instead, and whoever replays the graph adds it to
``.launches``).  ``device_plan`` /
``launch`` and ``device_plan_t`` / ``launch_transpose`` run a given plan,
so a measurement can compare plans on the same inputs.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import graph_ops
from .cuda_build import library

# the kernel's constants (csrc/nei_sum.cu: kMaxThreads, Kind, Dtype)
MAX_THREADS = 256          # threads per block
KINDS = ('rows', 'tiled')
# element size (bytes) -> the kernels' dtype code and the elements a chunk
# may hold (at most 16 bytes a load)
DTYPES = {4: (0, (1, 2, 4)), 2: (1, (1, 2, 4, 8))}
ELEM = {torch.float32: 4, torch.bfloat16: 2}
MAX_A_TEMPLATE = 8         # A = 1..8 are templates; other A take the generic path
SM_THREADS = 2048          # threads an H100 SM holds


@dataclass(frozen=True)
class Plan:
    """One launch of ``csrc/nei_sum.cu``: ``grid`` blocks of ``tpr`` x
    ``rpb`` threads (``tpr`` threads per row, one column chunk of ``vec``
    elements of ``elem`` bytes each; ``rpb`` rows per tile).  ``a_tmpl`` is
    A when 1 <= A <= 8, else 0 (generic path)."""
    kind: str
    vec: int
    a_tmpl: int
    tpr: int
    rpb: int
    grid: int
    elem: int = 4


def _check_vec(vec: int, elem: int, name: str) -> None:
    if elem not in DTYPES or vec not in DTYPES[elem][1]:
        raise ValueError(f'{name} plan: no kernel loads {vec} elements of '
                         f'{elem} bytes')


def plan(n: int, a: int, hdim: int, vec: int, sms: int,
         resident: Callable[[str, int], int],
         kind: Optional[str] = None, elem: int = 4) -> Plan:
    """The launch for ``graph`` [n, a] over rows of ``hdim`` elements of
    ``elem`` bytes (4: f32, 2: bf16) read as ``vec``-wide chunks, on a card
    of ``sms`` SMs.  ``resident(kind, threads)`` is how many such blocks
    fit on one SM.

    One chunk per thread (``tpr`` = the row's chunks rounded up to a warp,
    at most ``MAX_THREADS``), so a small ``n`` still spreads over the SMs;
    below two blocks per SM a block holds one row.  A grid that fits in one
    wave takes the ``rows`` kind, one tile per block; a larger one the
    persistent ``tiled`` kind, one block per resident slot.  That switch is
    by shape alone and provisional: ``tiled`` won at a tiled batch of one
    request's molecules and lost at uniformly random indices (PERF.md,
    section 6).  ``kind`` forces a kind, for measurements that compare them."""
    if n <= 0 or hdim % vec:
        raise ValueError(f'nei_sum plan: n {n}, hdim {hdim}, vec {vec}')
    _check_vec(vec, elem, 'nei_sum')
    cols = hdim // vec
    tpr = min(MAX_THREADS, -(-cols // 32) * 32)
    rpb = MAX_THREADS // tpr
    if -(-n // rpb) < 2 * sms:
        rpb = 1
    threads, tiles = tpr * rpb, -(-n // rpb)
    a_tmpl = a if 1 <= a <= MAX_A_TEMPLATE else 0
    if kind is None:
        kind = 'rows' if tiles <= sms * (SM_THREADS // threads) else 'tiled'
    if kind not in KINDS:
        raise ValueError(f'nei_sum plan: no kernel kind {kind!r}')
    grid = tiles
    if kind == 'tiled':
        per_sm = resident(kind, threads)
        if per_sm < 1:
            raise ValueError('nei_sum tiled: no block fits on an SM')
        grid = min(tiles, sms * per_sm)
    return Plan(kind, vec, a_tmpl, tpr, rpb, grid, elem)


def _lib() -> ctypes.CDLL:
    lib = library('nei_sum')
    fn = lib.ggpm_nei_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_int] * 6 + [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.ggpm_nei_sum_blocks_per_sm
        occ.argtypes = [ctypes.c_int] * 5
        occ.restype = ctypes.c_int
    return lib


def _check(h: torch.Tensor, graph: torch.Tensor, name: str = 'nei_sum'
           ) -> None:
    if h.device != graph.device:
        raise ValueError(f'{name}: h on {h.device}, graph on {graph.device}')
    if h.dtype not in ELEM or graph.dtype != torch.int32:
        raise TypeError(f'{name} takes float32 or bfloat16 h and int32 '
                        f'graph, got {h.dtype} and {graph.dtype}')
    if h.dim() != 2 or graph.dim() != 2:
        raise ValueError(f'{name} takes h [M, H] and graph [N, A], got '
                         f'{tuple(h.shape)} and {tuple(graph.shape)}')
    if not (h.is_contiguous() and graph.is_contiguous()):
        raise ValueError(f'{name} takes contiguous h and graph')


def vec_width(h: torch.Tensor, out: torch.Tensor) -> int:
    """Elements of the widest load (16, 8 or 4 bytes, and 2 for bf16) that
    the row width and every row start allow."""
    hdim, elem = h.shape[1], h.element_size()
    for nbytes in (16, 8, 4, 2):
        vec = nbytes // elem
        if vec >= 1 and hdim % vec == 0 and all(
                t.data_ptr() % nbytes == 0 for t in (h, out)):
            return vec
    return 1


@functools.lru_cache(maxsize=1024)
def _device_plan(device: int, n: int, a: int, hdim: int, vec: int,
                 kind: Optional[str], elem: int = 4) -> Plan:
    a_tmpl = a if 1 <= a <= MAX_A_TEMPLATE else 0

    def resident(k, threads):
        with torch.cuda.device(device):
            return _lib().ggpm_nei_sum_blocks_per_sm(
                DTYPES[elem][0], KINDS.index(k), vec, a_tmpl, threads)
    return plan(n, a, hdim, vec, _sms(device), resident, kind, elem)


@functools.lru_cache(maxsize=16)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_plan(h: torch.Tensor, graph: torch.Tensor, out: torch.Tensor,
                kind: Optional[str] = None) -> Plan:
    """``plan`` for these CUDA tensors on their card (``kind`` as there)."""
    n, a = graph.shape
    return _device_plan(h.device.index, n, a, h.shape[1], vec_width(h, out),
                        kind, h.element_size())


def launch(h: torch.Tensor, graph: torch.Tensor, out: torch.Tensor,
           p: Plan) -> torch.Tensor:
    """Launch plan ``p`` (from ``device_plan`` of the same tensors) into
    ``out`` on the current stream; raises if the launch fails."""
    n, a = graph.shape
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if h.element_size() != p.elem:
            raise ValueError(f'nei_sum: a plan for {p.elem}-byte elements '
                             f'launched on {h.dtype}')
        err = _lib().ggpm_nei_sum(
            h.data_ptr(), graph.data_ptr(), out.data_ptr(), n, a,
            h.shape[1] // p.vec, DTYPES[p.elem][0], KINDS.index(p.kind),
            p.vec, p.a_tmpl, p.tpr, p.rpb, p.grid, stream)
        if err:
            raise RuntimeError(f'nei_sum kernel launch failed: CUDA error '
                               f'{err}')
        count_launch(nei_sum, h.dtype)
    return out


def count_launch(wrapper, dtype: torch.dtype = torch.float32) -> None:
    """Count one launch of ``wrapper``'s kernel on the current stream:
    in ``wrapper.launches`` when it runs, in ``wrapper.captured`` when a
    CUDA graph capture only records it (``models/decode.py:Proposer``
    adds a capture's count to ``launches`` at each replay).  A launch on
    bf16 tables is counted in ``launches_bf16`` (``captured_bf16``) too."""
    bf16 = dtype == torch.bfloat16
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
        if bf16:
            wrapper.captured_bf16 += 1
    else:
        wrapper.launches += 1
        if bf16:
            wrapper.launches_bf16 += 1


def nei_sum(h: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """``h[graph].sum(1)`` for f32 or bf16 ``h`` [M, H] and int32 ``graph``
    [N, A] whose entries lie in [0, M); row 0 of ``h`` is the zero padding
    row.  A bf16 sum runs in f32 and is rounded once.
    The kernel has no backward of its own: where ``h`` needs a gradient on
    the card, call ``nei_sum_t`` with the table's transpose."""
    _check(h, graph)
    if h.device.type == 'cpu':
        return graph_ops.nei_sum(h, graph)
    if h.device.type != 'cuda':
        raise ValueError(f'nei_sum: no kernel for device {h.device}')
    if h.requires_grad and torch.is_grad_enabled():
        raise ValueError('nei_sum: h needs a gradient; pass the transpose '
                         'of graph to nei_sum_t')
    out = torch.empty((graph.shape[0], h.shape[1]), dtype=h.dtype,
                      device=h.device)
    if graph.shape[0] == 0:
        return out
    return launch(h, graph, out, device_plan(h, graph, out))


nei_sum.launches = nei_sum.captured = 0
nei_sum.launches_bf16 = nei_sum.captured_bf16 = 0


# the transpose's constants (csrc/transpose_sum.cu: kMaxThreads)
T_MAX_THREADS = 384        # threads per block
MAX_CHUNKS = 2             # column chunks per thread: C = 1, 2 are templates
ROW_THREADS = 192          # threads a row takes, chunks permitting (PERF.md 6)
BLOCK_THREADS = 256        # threads a block takes, rows permitting
MAX_GRID = 2 ** 31 - 1


@dataclass(frozen=True)
class PlanT:
    """One launch of ``csrc/transpose_sum.cu``: ``grid`` blocks of ``tpr``
    x ``rpb`` threads, ``tpr`` threads per row (``rpb`` rows a block),
    each with ``chunks`` column chunks of ``vec`` elements of ``elem``
    bytes.  ``k_tmpl`` is K when 1 <= K <= 8, else 0 (generic path)."""
    vec: int
    k_tmpl: int
    chunks: int
    tpr: int
    rpb: int
    grid: int
    elem: int = 4


def plan_t(n: int, k: int, width: int, vec: int, sms: int,
           chunks: Optional[int] = None, elem: int = 4) -> PlanT:
    """The transpose's launch for ``t_idx`` [n, k] over rows of ``width``
    elements of ``elem`` bytes (4: f32, 2: bf16) read as ``vec``-wide
    chunks, on a card of ``sms`` SMs.

    One pass per row: ``chunks`` chunks per thread (by default as many as
    ``ROW_THREADS`` threads need for the row, at most ``MAX_CHUNKS``) and
    ``tpr`` = the row's chunks over ``chunks``, rounded up to a warp, so
    ``tpr * chunks`` covers the row unless it is wider than
    ``MAX_CHUNKS * T_MAX_THREADS`` chunks (then each thread makes more
    passes).  A block takes ``BLOCK_THREADS // tpr`` rows, one if that
    leaves fewer than two blocks per SM.  ``chunks`` may be forced, for
    measurements that compare plans."""
    if n <= 0 or k < 0 or width % vec:
        raise ValueError(f'transpose_sum plan: n {n}, k {k}, width {width}, '
                         f'vec {vec}')
    _check_vec(vec, elem, 'transpose_sum')
    cols = width // vec
    if chunks is None:
        chunks = min(MAX_CHUNKS, -(-cols // ROW_THREADS))
    if not 1 <= chunks <= MAX_CHUNKS:
        raise ValueError(f'transpose_sum plan: {chunks} chunks per thread')
    per_thread = -(-cols // chunks)
    tpr = min(T_MAX_THREADS, -(-per_thread // 32) * 32)
    rpb = max(1, BLOCK_THREADS // tpr)
    if -(-n // rpb) < 2 * sms:
        rpb = 1
    grid = -(-n // rpb)
    if grid > MAX_GRID:
        raise ValueError(f'transpose_sum plan: grid {grid} too large')
    k_tmpl = k if 1 <= k <= MAX_A_TEMPLATE else 0
    return PlanT(vec, k_tmpl, chunks, tpr, rpb, grid, elem)


def _lib_t() -> ctypes.CDLL:
    lib = library('transpose_sum')
    fn = lib.ggpm_transpose_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
            ctypes.c_int] * 6 + [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def device_plan_t(g: torch.Tensor, t_idx: torch.Tensor, out: torch.Tensor,
                  chunks: Optional[int] = None) -> PlanT:
    """``plan_t`` for these CUDA tensors on their card (``chunks`` as
    there)."""
    n, k = t_idx.shape
    return plan_t(n, k, g.shape[1], vec_width(g, out), _sms(g.device.index),
                  chunks, g.element_size())


def launch_transpose(g: torch.Tensor, t_idx: torch.Tensor,
                     t_mask: torch.Tensor, div: int, out: torch.Tensor,
                     p: PlanT) -> torch.Tensor:
    """Launch the transpose under plan ``p`` (from ``device_plan_t`` of
    the same tensors) into ``out`` on the current stream; raises if the
    launch fails."""
    n, k = t_idx.shape
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if g.element_size() != p.elem:
            raise ValueError(f'transpose_sum: a plan for {p.elem}-byte '
                             f'elements launched on {g.dtype}')
        err = _lib_t().ggpm_transpose_sum(
            g.data_ptr(), t_idx.data_ptr(), t_mask.data_ptr(), out.data_ptr(),
            n, k, div, g.shape[1] // p.vec, DTYPES[p.elem][0], p.vec,
            p.k_tmpl, p.chunks, p.tpr, p.rpb, p.grid, stream)
        if err:
            raise RuntimeError(f'transpose_sum kernel launch failed: CUDA '
                               f'error {err}')
        count_launch(transpose_sum, g.dtype)
    return out


def transpose_sum(g: torch.Tensor, t_idx: torch.Tensor, t_mask: torch.Tensor,
                  div: int) -> torch.Tensor:
    """``out[m] = Σ_k t_mask[m, k] · g[t_idx[m, k] // div]`` for f32 or
    bf16 ``g`` [R, W] (a bf16 sum runs in f32 and is rounded once), int32
    ``t_idx`` and f32 ``t_mask`` [M, K] (0 or 1, from
    ``graph_ops.build_transpose``), with every ``t_idx // div`` in [0, R).
    The backward of ``nei_sum`` (``div`` = A) and of the row gather
    (``div`` = 1, ``g`` the flattened cotangent).  On the card it launches
    ``csrc/transpose_sum.cu`` under ``plan_t``."""
    _check(g, t_idx, 'transpose_sum')
    if t_mask.shape != t_idx.shape or t_mask.dtype != torch.float32 or \
            t_mask.device != g.device or not t_mask.is_contiguous():
        raise ValueError('transpose_sum takes a contiguous f32 t_mask of '
                         't_idx\'s shape on its device')
    if div < 1:
        raise ValueError(f'transpose_sum: div {div}')
    if g.device.type == 'cpu':
        return graph_ops.transpose_sum(g, t_idx, t_mask, div)
    if g.device.type != 'cuda':
        raise ValueError(f'transpose_sum: no kernel for device {g.device}')
    out = torch.empty((t_idx.shape[0], g.shape[1]), dtype=g.dtype,
                      device=g.device)
    if t_idx.shape[0] == 0:
        return out
    return launch_transpose(g, t_idx, t_mask, div, out,
                            device_plan_t(g, t_idx, out))


transpose_sum.launches = transpose_sum.captured = 0
transpose_sum.launches_bf16 = transpose_sum.captured_bf16 = 0


class _NeiSumT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, graph, t_idx, t_mask):
        ctx.save_for_backward(t_idx, t_mask)
        ctx.a = graph.shape[1]
        return nei_sum(h, graph)

    @staticmethod
    def backward(ctx, gout):
        t_idx, t_mask = ctx.saved_tensors
        return (transpose_sum(gout.contiguous(), t_idx, t_mask, ctx.a),
                None, None, None)


def nei_sum_t(h: torch.Tensor, graph: torch.Tensor, t_idx: torch.Tensor,
              t_mask: torch.Tensor) -> torch.Tensor:
    """``nei_sum`` whose backward is ``transpose_sum`` over ``(t_idx,
    t_mask) = build_transpose(graph, len(h))`` with ``div`` = A (counterpart
    of ``ggpm_tpu/ops/graph_ops.py:nei_sum_t``): a gather, not a
    scatter-add.

    The table leaves out every use of row 0, so the gradient of ``h[0]`` is
    zero.  That is exact where the caller keeps ``h[0]`` at zero by
    construction, because then its cotangent is dead: it flows only into
    the ``zero_row0`` that made it (whose backward kills it) or into a
    constant zero buffer.  The node and root readouts of the encoder read
    the depth loop's ``h``, zeroed by ``zero_row0`` every round; the
    decoder's teacher-forced readout reads its message state, and the hier
    scan's five sums a step read its states and node hiddens, each of
    whose row 0 starts as a constant zero and is written only with
    zeros."""
    return _NeiSumT.apply(h, graph, t_idx, t_mask)
