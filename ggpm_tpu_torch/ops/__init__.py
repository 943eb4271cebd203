import ctypes
from typing import Dict

import torch

from .cuda_build import library
from .gather_rows import gather_nd_t, gather_rows
from .graph_ops import (build_transpose, gather_nd, scatter_rows, zero_row0,
                        zero_row0_)
from .nei_sum import nei_sum, nei_sum_t, transpose_sum

# the wrappers that count their kernels' launches (``launches``, and
# ``captured`` while a CUDA graph records them; each with its launches on
# bf16 tables in ``launches_bf16`` and ``captured_bf16``:
# nei_sum.count_launch)
COUNTED = (nei_sum, transpose_sum, gather_rows)


def captured_counts():
    """Each counted wrapper's ``(captured, captured_bf16)``, before a
    capture, for ``capture_record``."""
    return [(w.captured, w.captured_bf16) for w in COUNTED]


def capture_record(before):
    """The launches a capture recorded since ``before``
    (``captured_counts()`` when it began), as two lists of ``(wrapper,
    launches)``: all of them, and those on bf16 tables; ``add_replay``
    adds them at each replay."""
    return ([(w, w.captured - n) for w, (n, _) in zip(COUNTED, before)
             if w.captured > n],
            [(w, w.captured_bf16 - nb) for w, (_, nb) in zip(COUNTED, before)
             if w.captured_bf16 > nb])


def add_replay(launches, launches_bf16=()) -> None:
    """Add a capture's recorded launches (``capture_record``) to the
    wrappers' counts: one replay of its graph launched them."""
    for w, n in launches:
        w.launches += n
    for w, n in launches_bf16:
        w.launches_bf16 += n


def device_launches() -> Dict[str, int]:
    """Each counted wrapper's kernel launches that ran on the current CUDA
    device since its library was loaded, as the kernels count them
    themselves (``ggpm_device_launches`` in ``csrc/<name>.cu``), after the
    device has finished its work.  The difference of two reads is the
    launches that ran between them, eager or replayed from a graph; unlike
    the profiler's device records, of which it can lose some, it misses
    none.  Not to be read while a graph is being captured."""
    torch.cuda.synchronize()
    out = {}
    for w in COUNTED:
        n = ctypes.c_ulonglong()
        err = library(w.__name__).ggpm_device_launches(ctypes.byref(n))
        if err:
            raise RuntimeError(f'{w.__name__}: reading the device launch '
                               f'count failed: CUDA error {err}')
        out[w.__name__] = n.value
    return out
