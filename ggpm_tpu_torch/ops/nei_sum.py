"""The neighbour gather-sum kernel: ``out[n] = Σ_a h[graph[n, a]]``.

Port of the Pallas TPU kernel ``ggpm_tpu/ops/pallas_gather.py:_kernel``
(ROADMAP B1) as hand-written CUDA for sm_90a, ``csrc/nei_sum.cu``; the
source says how it is laid out and what bounds it.  The encoder calls it at
both of its readouts (the node readout over ``agraph`` and the root readout).

``plan`` chooses the launch (kernel kind, load width, threads per row, rows
per block, grid) from the shapes alone, in plain Python, so the CPU tests
reach it.  ``nei_sum`` launches the kernel for CUDA tensors and raises if
it cannot; it never falls back.  For CPU tensors it computes the plain
version, ``graph_ops.nei_sum``.  ``nei_sum.launches`` counts kernel
launches.  ``device_plan`` and ``launch`` run a given plan, so a
measurement can compare the kinds on the same inputs.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import graph_ops
from .cuda_build import library

# the kernel's constants (csrc/nei_sum.cu: kMaxThreads, Kind)
MAX_THREADS = 256          # threads per block
KINDS = ('rows', 'tiled')
MAX_A_TEMPLATE = 8         # A = 1..8 are templates; other A take the generic path
SM_THREADS = 2048          # threads an H100 SM holds


@dataclass(frozen=True)
class Plan:
    """One launch of ``csrc/nei_sum.cu``: ``grid`` blocks of ``tpr`` x
    ``rpb`` threads (``tpr`` threads per row, one column chunk of ``vec``
    floats each; ``rpb`` rows per tile).  ``a_tmpl`` is A when
    1 <= A <= 8, else 0 (generic path)."""
    kind: str
    vec: int
    a_tmpl: int
    tpr: int
    rpb: int
    grid: int


def plan(n: int, a: int, hdim: int, vec: int, sms: int,
         resident: Callable[[str, int], int],
         kind: Optional[str] = None) -> Plan:
    """The launch for ``graph`` [n, a] over rows of ``hdim`` floats read as
    ``vec``-wide chunks, on a card of ``sms`` SMs.  ``resident(kind,
    threads)`` is how many such blocks fit on one SM.

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
    return Plan(kind, vec, a_tmpl, tpr, rpb, grid)


def _lib() -> ctypes.CDLL:
    lib = library('nei_sum')
    fn = lib.ggpm_nei_sum_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.ggpm_nei_sum_blocks_per_sm
        occ.argtypes = [ctypes.c_int] * 4
        occ.restype = ctypes.c_int
    return lib


def _check(h: torch.Tensor, graph: torch.Tensor) -> None:
    if h.device != graph.device:
        raise ValueError(f'nei_sum: h on {h.device}, graph on {graph.device}')
    if h.dtype != torch.float32 or graph.dtype != torch.int32:
        raise TypeError(f'nei_sum takes float32 h and int32 graph, '
                        f'got {h.dtype} and {graph.dtype}')
    if h.dim() != 2 or graph.dim() != 2:
        raise ValueError(f'nei_sum takes h [M, H] and graph [N, A], got '
                         f'{tuple(h.shape)} and {tuple(graph.shape)}')
    if not (h.is_contiguous() and graph.is_contiguous()):
        raise ValueError('nei_sum takes contiguous h and graph')


def vec_width(h: torch.Tensor, out: torch.Tensor) -> int:
    """Widest float load that every row start allows."""
    hdim = h.shape[1]
    for vec in (4, 2):
        if hdim % vec == 0 and all(t.data_ptr() % (4 * vec) == 0
                                   for t in (h, out)):
            return vec
    return 1


@functools.lru_cache(maxsize=1024)
def _device_plan(device: int, n: int, a: int, hdim: int, vec: int,
                 kind: Optional[str]) -> Plan:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    a_tmpl = a if 1 <= a <= MAX_A_TEMPLATE else 0

    def resident(k, threads):
        with torch.cuda.device(device):
            return _lib().ggpm_nei_sum_blocks_per_sm(KINDS.index(k), vec,
                                                     a_tmpl, threads)
    return plan(n, a, hdim, vec, sms, resident, kind)


def device_plan(h: torch.Tensor, graph: torch.Tensor, out: torch.Tensor,
                kind: Optional[str] = None) -> Plan:
    """``plan`` for these CUDA tensors on their card (``kind`` as there)."""
    n, a = graph.shape
    return _device_plan(h.device.index, n, a, h.shape[1], vec_width(h, out),
                        kind)


def launch(h: torch.Tensor, graph: torch.Tensor, out: torch.Tensor,
           p: Plan) -> torch.Tensor:
    """Launch plan ``p`` (from ``device_plan`` of the same tensors) into
    ``out`` on the current stream; raises if the launch fails."""
    n, a = graph.shape
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _lib().ggpm_nei_sum_f32(
            h.data_ptr(), graph.data_ptr(), out.data_ptr(), n, a,
            h.shape[1] // p.vec, KINDS.index(p.kind), p.vec, p.a_tmpl, p.tpr,
            p.rpb, p.grid, stream)
    if err:
        raise RuntimeError(f'nei_sum kernel launch failed: CUDA error {err}')
    nei_sum.launches += 1
    return out


def nei_sum(h: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """``h[graph].sum(1)`` for f32 ``h`` [M, H] and int32 ``graph`` [N, A]
    whose entries lie in [0, M); row 0 of ``h`` is the zero padding row."""
    _check(h, graph)
    if h.device.type == 'cpu':
        return graph_ops.nei_sum(h, graph)
    if h.device.type != 'cuda':
        raise ValueError(f'nei_sum: no kernel for device {h.device}')
    out = torch.empty((graph.shape[0], h.shape[1]), dtype=h.dtype,
                      device=h.device)
    if graph.shape[0] == 0:
        return out
    return launch(h, graph, out, device_plan(h, graph, out))


nei_sum.launches = 0
