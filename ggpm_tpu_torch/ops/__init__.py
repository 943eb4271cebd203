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
