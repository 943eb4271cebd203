"""The port's ``nei_sum`` (its CPU path: the plain version of the CUDA
kernel) against the JAX package's ``graph_ops.nei_sum`` and against the
Pallas kernel itself, run in interpret mode; the launch plans of the CUDA
kernels of ``nei_sum`` and of its transpose ``transpose_sum``; and the
one PyTorch call that computes each function (``embedding_bag``, the
yardstick ``kernel_bench`` times beside the kernels) against its plain
version.

Tolerance 1e-6 absolute: the sums take at most a few terms of magnitude
<= 1, in an order that may differ between the versions.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ggpm_tpu.ops import graph_ops as jax_ops
from ggpm_tpu.ops import pallas_gather
from ggpm_tpu_torch.kernel_bench import (T_SHAPES, library_nei_sum,
                                         library_transpose, tile_graph,
                                         transpose_inputs)
from ggpm_tpu_torch.ops import gather_nd, nei_sum, zero_row0_
from ggpm_tpu_torch.ops import graph_ops
from ggpm_tpu_torch.ops.nei_sum import (KINDS, MAX_CHUNKS, MAX_THREADS,
                                        SM_THREADS, T_MAX_THREADS, plan,
                                        plan_t, vec_width)

torch.set_num_threads(1)

ATOL = 1e-6

# (M, H, N, A): the checked Pallas shape, N not a multiple of the Pallas
# tile (8) or of the rows per block (2) that the CUDA plan gives at H = 250
# or 251, A = 1, the model's H = 250, the widest
# templated A = 8, and an odd H = 251.  M stays a multiple of 8: the Pallas
# kernel DMAs the aligned 8-row block around each row it reads.
SHAPES = [(64, 256, 21, 6), (40, 128, 13, 3), (48, 128, 16, 1),
          (120, 250, 37, 6), (96, 250, 23, 8), (72, 251, 19, 2)]


def _inputs(m, hdim, n, a, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.uniform(-1, 1, (m, hdim)).astype(np.float32)
    h[0] = 0.0
    graph = rng.integers(0, m, (n, a)).astype(np.int32)
    graph[rng.random((n, a)) < 0.25] = 0     # padding slots
    return h, graph


def _port(h, graph):
    return nei_sum(torch.from_numpy(h), torch.from_numpy(graph)).numpy()


@pytest.mark.parametrize('shape', SHAPES)
def test_nei_sum_matches_jax(shape):
    h, graph = _inputs(*shape)
    ref = np.asarray(jax_ops.nei_sum(jnp.asarray(h), jnp.asarray(graph)))
    np.testing.assert_allclose(_port(h, graph), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize('shape', SHAPES)
def test_nei_sum_matches_pallas_kernel(shape, monkeypatch):
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    h, graph = _inputs(*shape, seed=1)
    ref = np.asarray(pallas_gather._nei_sum_pallas_impl(
        jnp.asarray(h), jnp.asarray(graph)))
    np.testing.assert_allclose(_port(h, graph), ref, rtol=0, atol=ATOL)


def test_nei_sum_cpu_path_is_plain_and_launches_nothing():
    h, graph = _inputs(30, 16, 9, 4)
    ht, gt = torch.from_numpy(h), torch.from_numpy(graph)
    before = nei_sum.launches
    torch.testing.assert_close(nei_sum(ht, gt), graph_ops.nei_sum(ht, gt),
                               rtol=0, atol=0)
    assert nei_sum.launches == before


@pytest.mark.parametrize('bad', ['h_dtype', 'graph_dtype', 'rank',
                                 'contiguity', 'device'])
def test_nei_sum_rejects(bad):
    h = torch.zeros(10, 8)
    graph = torch.zeros(4, 3, dtype=torch.int32)
    if bad == 'h_dtype':
        h = h.double()
    elif bad == 'graph_dtype':
        graph = graph.long()
    elif bad == 'rank':
        graph = graph[None]
    elif bad == 'contiguity':
        h = torch.zeros(8, 10).t()
    else:
        h = h.to('meta')
    with pytest.raises((TypeError, ValueError)):
        nei_sum(h, graph)


def test_gather_nd_and_zero_row0_match_jax():
    h, graph = _inputs(20, 6, 7, 3)
    ref = np.asarray(jax_ops.gather_nd(jnp.asarray(h), jnp.asarray(graph)))
    np.testing.assert_array_equal(
        gather_nd(torch.from_numpy(h), torch.from_numpy(graph)).numpy(), ref)
    x = torch.ones(3, 2)
    assert zero_row0_(x) is x
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jax_ops.zero_row0(jnp.ones((3, 2)))))


def test_nei_sum_of_tiled_batch_is_the_copies_stacked():
    """The request-scale case: a tree tiled into one block-diagonal batch
    gives each copy's readout, stacked."""
    copies = 5
    h, graph = _inputs(40, 16, 11, 4, seed=2)
    hs = [np.random.default_rng(k).uniform(-1, 1, h.shape).astype(np.float32)
          for k in range(copies)]
    for hk in hs:
        hk[0] = 0.0
    tiled = tile_graph(torch.from_numpy(graph), h.shape[0], copies)
    assert tiled.shape == (copies * graph.shape[0], graph.shape[1])
    assert tiled.dtype == torch.int32
    assert int(tiled.max()) < copies * h.shape[0]
    got = nei_sum(torch.from_numpy(np.concatenate(hs)), tiled).numpy()
    want = np.concatenate([_port(hk, graph) for hk in hs])
    np.testing.assert_array_equal(got, want)


# (n, a, hdim, vec): every case of kernel_bench.nei_sum_cases (readout,
# root, request scale, the A sweep, ragged, float4, large), then ragged n,
# A = 1, H in {1, 3, 250, 251, 256}, generic A, and the widths that
# misaligned pointers leave (vec 1 or 2 where H allows 4)
PLAN_CASES = ([(853, 6, 250, 2), (64, 6, 250, 2), (54592, 6, 250, 2)] +
              [(853, a, 250, 2) for a in (1, 2, 3, 4, 6, 8)] +
              [(37, 1, 251, 1), (1001, 3, 256, 4), (65536, 6, 256, 4)] +
              [(n, a, hdim, vec) for n in (1, 5, 263, 2113, 40001)
               for a, hdim, vec in ((1, 1, 1), (3, 3, 1), (6, 250, 2),
                                    (2, 251, 1), (8, 256, 4), (12, 256, 2),
                                    (6, 256, 1), (1, 2050, 2))])
SMS = 132


def _resident(kind, threads):
    """Blocks per SM as the card's occupancy query would bound them by
    threads (registers ignored)."""
    return SM_THREADS // threads


def _coverage(p, n, cols):
    """How often the kernel of plan ``p`` writes each (row, column chunk):
    the loops of csrc/nei_sum.cu.  Block b takes tile b (``rows``) or tiles
    b, b + grid, ... (``tiled``); thread (x, y) of a tile takes its row y
    and the columns x, x + tpr, ..."""
    tiles = -(-n // p.rpb)
    if p.kind == 'rows':
        walked = np.arange(p.grid)
    else:
        walked = np.concatenate([np.arange(b, tiles, p.grid)
                                 for b in range(p.grid)])
    rows = (walked[:, None] * p.rpb + np.arange(p.rpb)).ravel()
    rows = rows[rows < n]
    chunks = np.concatenate([np.arange(x, cols, p.tpr) for x in range(p.tpr)])
    row_count = np.bincount(rows, minlength=n)
    col_count = np.bincount(chunks, minlength=cols)
    return row_count, col_count


@pytest.mark.parametrize('kind', [None, *KINDS])
@pytest.mark.parametrize('case', PLAN_CASES, ids=str)
def test_nei_sum_plan_covers_each_row_and_column_once(case, kind):
    n, a, hdim, vec = case
    cols = hdim // vec
    p = plan(n, a, hdim, vec, SMS, _resident, kind)
    assert p.kind == (kind or p.kind) and p.kind in KINDS
    assert p.vec == vec and p.a_tmpl == (a if 1 <= a <= 8 else 0)
    assert p.tpr % 32 == 0 and p.tpr * p.rpb <= MAX_THREADS
    assert 1 <= p.grid < 2 ** 31
    if p.kind == 'tiled':
        assert p.grid <= SMS * _resident(p.kind, p.tpr * p.rpb)
    row_count, col_count = _coverage(p, n, cols)
    assert (row_count == 1).all() and (col_count == 1).all()


@pytest.mark.parametrize('args', [(0, 6, 250, 2, None), (5, 6, 250, 4, None),
                                  (5, 6, 250, 2, 'no-such-kind')], ids=str)
def test_nei_sum_plan_refuses_what_no_kernel_takes(args):
    """No rows, a width the row does not divide into, or a kind the
    kernel does not have."""
    n, a, hdim, vec, kind = args
    with pytest.raises(ValueError):
        plan(n, a, hdim, vec, SMS, _resident, kind)


def test_nei_sum_plan_fills_the_card_at_serve_shapes():
    """The serve readouts spread over the SMs in one wave of the ``rows``
    kind; a request-scale batch takes the persistent ``tiled`` grid."""
    readout = plan(853, 6, 250, 2, SMS, _resident)
    root = plan(64, 6, 250, 2, SMS, _resident)
    request = plan(54592, 6, 250, 2, SMS, _resident)
    assert (readout.kind, readout.tpr, readout.grid) == ('rows', 128, 427)
    assert (root.kind, root.rpb, root.grid) == ('rows', 1, 64)
    assert request.kind == 'tiled'
    assert request.grid == SMS * _resident('tiled', 256)


def test_transpose_plan_at_the_training_step():
    """The depth loop's backward (375 float2 chunks a row) is one pass of
    192 threads with 2 chunks each, one row a block; the readouts' (125
    chunks) one chunk each, 128 threads, two rows a block."""
    depth = plan_t(768, 6, 750, 2, SMS)
    assert (depth.chunks, depth.tpr, depth.rpb, depth.grid, depth.k_tmpl) == \
        (2, 192, 1, 768, 6)
    for n, k in ((768, 1), (788, 5)):
        p = plan_t(n, k, 250, 2, SMS)
        assert (p.chunks, p.tpr, p.rpb, p.grid) == (1, 128, 2, -(-n // 2))


@pytest.mark.parametrize('offset,hdim,vec', [(0, 256, 4), (2, 256, 2),
                                             (1, 256, 1), (0, 250, 2),
                                             (1, 250, 1), (0, 251, 1)])
def test_nei_sum_vec_width_follows_alignment(offset, hdim, vec):
    base = torch.zeros(offset + 4 * hdim + 8)
    h = base[offset:offset + 4 * hdim].view(4, hdim)
    out = torch.zeros(2, hdim)
    assert out.data_ptr() % 16 == 0
    assert vec_width(h, out) == vec


# -- the transpose's launch plan and the one-call yardsticks -------------

# (n, k, width, vec): the training step's transpose calls (the depth loop's
# gather backward, out [768, 750] with K 6; the teacher-forced frontier's,
# out [788, 250] with K 5, and at g's 1,024 rows; the root and node
# readouts', out [768, 250] with K 1, and at the roots' 20 rows), then
# ragged n, K past the templates, and widths of one pass, of a ragged
# last chunk and of more passes than one
T_PLAN_CASES = ([(768, 6, 750, 2), (788, 5, 250, 2), (1024, 5, 250, 2),
                 (768, 1, 250, 2), (20, 1, 250, 2)] +
                [(n, k, width, vec) for n in (1, 5, 263, 2113)
                 for k, width, vec in ((1, 1, 1), (3, 3, 1), (6, 750, 2),
                                       (2, 251, 1), (8, 256, 4), (12, 250, 2),
                                       (0, 750, 2), (5, 2050, 2),
                                       (9, 4100, 2))])


def _coverage_t(p, n, cols):
    """How often the kernel of plan ``p`` writes each (row, column chunk):
    the loops of csrc/transpose_sum.cu.  Block b takes rows b·rpb ..
    b·rpb + rpb - 1; thread x of a row takes the chunks c0 + i·tpr (i <
    chunks) for c0 = x, x + tpr·chunks, ... below cols."""
    rows = (np.arange(p.grid)[:, None] * p.rpb + np.arange(p.rpb)).ravel()
    rows = rows[rows < n]
    chunks = [c0 + i * p.tpr for x in range(p.tpr)
              for c0 in range(x, cols, p.tpr * p.chunks)
              for i in range(p.chunks) if c0 + i * p.tpr < cols]
    return (np.bincount(rows, minlength=n),
            np.bincount(np.array(chunks, dtype=np.int64), minlength=cols))


@pytest.mark.parametrize('chunks', [None, *range(1, MAX_CHUNKS + 1)])
@pytest.mark.parametrize('case', T_PLAN_CASES, ids=str)
def test_transpose_plan_covers_each_row_and_column_once(case, chunks):
    n, k, width, vec = case
    cols = width // vec
    p = plan_t(n, k, width, vec, SMS, chunks)
    assert p.vec == vec and p.k_tmpl == (k if 1 <= k <= 8 else 0)
    assert p.chunks == (chunks or p.chunks) and 1 <= p.chunks <= MAX_CHUNKS
    assert p.tpr % 32 == 0 and p.tpr * p.rpb <= T_MAX_THREADS
    assert 1 <= p.grid < 2 ** 31
    if cols <= p.chunks * T_MAX_THREADS:
        assert p.tpr * p.chunks >= cols          # one pass per row
    row_count, col_count = _coverage_t(p, n, cols)
    assert (row_count == 1).all() and (col_count == 1).all()


@pytest.mark.parametrize('args', [(0, 6, 750, 2, None), (5, 6, 750, 4, None),
                                  (5, -1, 750, 2, None), (5, 6, 750, 2, 0),
                                  (5, 6, 750, 2, MAX_CHUNKS + 1)], ids=str)
def test_transpose_plan_refuses_what_no_kernel_takes(args):
    """No rows, a width the row does not divide into, a negative K, or a
    count of chunks per thread that no kernel has."""
    n, k, width, vec, chunks = args
    with pytest.raises(ValueError):
        plan_t(n, k, width, vec, SMS, chunks)


@pytest.mark.parametrize('shape', SHAPES)
def test_nei_sum_yardstick_is_one_call_of_the_same_function(shape):
    """``embedding_bag`` (``kernel_bench.library_nei_sum``) computes
    ``nei_sum``: the padding row 0 is zero, so its slots add nothing."""
    h, graph = (torch.from_numpy(x) for x in _inputs(*shape))
    torch.testing.assert_close(library_nei_sum(h, graph),
                               graph_ops.nei_sum(h, graph), rtol=0, atol=ATOL)


@pytest.mark.parametrize('shape', [s for s in T_SHAPES if s[3] in (1, 4)],
                         ids=str)
def test_transpose_yardstick_is_one_call_of_the_same_function(shape):
    """``embedding_bag`` weighted by the mask
    (``kernel_bench.library_transpose``) computes ``transpose_sum``, row 0
    included, over a random table's transpose."""
    _, t_idx, t_mask, g, div = transpose_inputs(*shape, device='cpu')
    torch.testing.assert_close(
        library_transpose(g, t_idx, t_mask, div)(),
        graph_ops.transpose_sum(g, t_idx, t_mask, div), rtol=0, atol=ATOL)
