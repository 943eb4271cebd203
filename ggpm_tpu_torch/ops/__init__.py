from .graph_ops import build_transpose, gather_nd, zero_row0_
from .nei_sum import nei_sum

__all__ = ['build_transpose', 'gather_nd', 'nei_sum', 'zero_row0_']
