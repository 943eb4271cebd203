from .gather_rows import gather_nd_t, gather_rows
from .graph_ops import (build_transpose, gather_nd, scatter_rows, zero_row0,
                        zero_row0_)
from .nei_sum import nei_sum, nei_sum_t, transpose_sum

# the wrappers that count their kernels' launches (``launches``, and
# ``captured`` while a CUDA graph records them: nei_sum.count_launch)
COUNTED = (nei_sum, transpose_sum, gather_rows)

__all__ = ['COUNTED', 'build_transpose', 'gather_nd', 'gather_nd_t',
           'gather_rows', 'nei_sum', 'nei_sum_t', 'scatter_rows',
           'transpose_sum', 'zero_row0', 'zero_row0_']
