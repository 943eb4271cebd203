"""Gather primitives for message passing on padded graphs (counterpart of
``ggpm_tpu/ops/graph_ops.py``).

All tensors follow the index-0-is-padding convention: row 0 of every
feature/state buffer is kept at zero, so gathering a padded index contributes
nothing to neighbour sums and no masking is needed on the gather path.
"""

from __future__ import annotations

import numpy as np
import torch


def gather_nd(source: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``index_select_ND``: gather rows of ``source`` by an arbitrary-shape
    index tensor → shape ``index.shape + source.shape[1:]``."""
    return source[index]


def nei_sum(h: torch.Tensor, graph: torch.Tensor) -> torch.Tensor:
    """Sum neighbour states: ``h[graph].sum(-2)`` for a padded [N, A] index
    table.  Padding entries hit row 0 of ``h`` which is identically zero.
    The plain version of the ``ops.nei_sum`` kernel."""
    return h[graph].sum(dim=-2)


def transpose_sum(g: torch.Tensor, t_idx: torch.Tensor, t_mask: torch.Tensor,
                  div: int) -> torch.Tensor:
    """``out[m] = Σ_k t_mask[m, k] · g[t_idx[m, k] // div]``: the backward
    of ``nei_sum`` (``div`` = A) and of the row gather (``div`` = 1) over a
    transpose table from ``build_transpose`` (JAX ``_nei_sum_t_bwd`` and
    ``_gather_nd_t_bwd``).  The plain version of the
    ``ops.nei_sum.transpose_sum`` kernel."""
    return (g[t_idx // div] * t_mask[..., None]).sum(dim=-2)


def scatter_rows(buffer: torch.Tensor, index: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``buffer`` with ``rows`` written at ``index`` and the padding row
    zeroed, out of place (``index_scatter`` semantics, JAX
    ``graph_ops.scatter_rows``).  Duplicate indices may only occur at the
    padding slot 0, which is zeroed afterwards."""
    return zero_row0(buffer.index_put((index.long(),), rows))


def zero_row0(h: torch.Tensor) -> torch.Tensor:
    """``h`` with its padding row zeroed, out of place, so that autograd
    may differentiate through it: its backward zeroes row 0 of the
    cotangent, as JAX's ``h.at[0].set(0.0)`` does."""
    return torch.cat([h.new_zeros((1,) + h.shape[1:]), h[1:]])


def zero_row0_(h: torch.Tensor) -> torch.Tensor:
    """Zero the padding row of ``h`` in place and return ``h``.  Callers
    pass a tensor they have just computed, so no other view sees the
    write."""
    h[0] = 0.0
    return h


def build_transpose(graph: np.ndarray, num_src: int, k: int = None):
    """Host-side transpose of a padded [N, A] index table.

    Returns ``(t_idx, t_mask)``: for each source row ``m`` of the gathered
    tensor (``num_src`` rows), ``t_idx[m]`` lists the flat positions
    ``n * A + a`` with ``graph[n, a] == m`` (row 0 excluded), zero-padded to
    width ``k``; ``t_mask`` marks the real entries.  For ``bgraph`` the
    multiplicity of message m is deg(dst(m)) - 1 < A, so ``k=A`` is a
    static bound; pass ``k=None`` to size from the data.  The backward
    kernels of ``nei_sum_t`` and ``gather_nd_t`` gather over this table.
    """
    g = np.asarray(graph)
    flat = g.ravel().astype(np.int64)
    pos = np.flatnonzero(flat)          # drop padding-row occurrences
    vals = flat[pos]
    order = np.argsort(vals, kind='stable')
    vals, pos = vals[order], pos[order]
    counts = np.bincount(vals, minlength=num_src) if vals.size else \
        np.zeros(num_src, np.int64)
    kmax = int(counts.max()) if counts.size else 0
    if k is None:
        k = max(1, kmax)
    if kmax > k:
        raise ValueError(f'transpose width {kmax} exceeds static bound {k}')
    t_idx = np.zeros((num_src, k), np.int32)
    t_mask = np.zeros((num_src, k), np.float32)
    if vals.size:
        first = np.searchsorted(vals, vals, side='left')
        col = np.arange(vals.size) - first
        t_idx[vals, col] = pos
        t_mask[vals, col] = 1.0
    return t_idx, t_mask
