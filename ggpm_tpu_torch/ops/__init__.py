from .gather_rows import gather_nd_t, gather_rows
from .graph_ops import (build_transpose, gather_nd, scatter_rows, zero_row0,
                        zero_row0_)
from .nei_sum import nei_sum, nei_sum_t, transpose_sum

__all__ = ['build_transpose', 'gather_nd', 'gather_nd_t', 'gather_rows',
           'nei_sum', 'nei_sum_t', 'scatter_rows', 'transpose_sum',
           'zero_row0', 'zero_row0_']
