"""The neighbour gather-sum kernel: ``out[n] = Σ_a h[graph[n, a]]``.

Port of the Pallas TPU kernel ``ggpm_tpu/ops/pallas_gather.py:_kernel``
(ROADMAP B1) as hand-written CUDA for sm_90a, ``csrc/nei_sum.cu``; the
source says how it is laid out and what bounds it.  The encoder calls it at
both of its readouts (the node readout over ``agraph`` and the root readout).

``nei_sum`` launches the kernel for CUDA tensors and raises if it cannot; it
never falls back.  For CPU tensors it computes the plain version,
``graph_ops.nei_sum``.  ``nei_sum.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import graph_ops
from .cuda_build import library

_SMEM_LIMIT = 48 * 1024   # bytes of static-launch shared memory per block


def _lib() -> ctypes.CDLL:
    lib = library('nei_sum')
    fn = lib.ggpm_nei_sum_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ggpm_nei_sum_rows_per_block.argtypes = []
        lib.ggpm_nei_sum_rows_per_block.restype = ctypes.c_int
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


def _vec(h: torch.Tensor, out: torch.Tensor) -> int:
    """Widest float load that every row start allows."""
    hdim = h.shape[1]
    for vec in (4, 2):
        if hdim % vec == 0 and all(t.data_ptr() % (4 * vec) == 0
                                   for t in (h, out)):
            return vec
    return 1


def nei_sum(h: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """``h[graph].sum(1)`` for f32 ``h`` [M, H] and int32 ``graph`` [N, A]
    whose entries lie in [0, M); row 0 of ``h`` is the zero padding row."""
    _check(h, graph)
    if h.device.type == 'cpu':
        return graph_ops.nei_sum(h, graph)
    if h.device.type != 'cuda':
        raise ValueError(f'nei_sum: no kernel for device {h.device}')
    n, a = graph.shape
    out = torch.empty((n, h.shape[1]), dtype=h.dtype, device=h.device)
    if n == 0:
        return out
    lib = _lib()
    if 4 * a * lib.ggpm_nei_sum_rows_per_block() > _SMEM_LIMIT:
        raise ValueError(f'nei_sum: neighbour width {a} exceeds the '
                         f'kernel\'s shared-memory index tile')
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.ggpm_nei_sum_f32(h.data_ptr(), graph.data_ptr(),
                                   out.data_ptr(), n, a, h.shape[1],
                                   _vec(h, out), stream)
    if err:
        raise RuntimeError(f'nei_sum kernel launch failed: CUDA error {err}')
    nei_sum.launches += 1
    return out


nei_sum.launches = 0
