"""K3's launch plan (``ggpm_tpu_torch/ops/gather_rows.py:plan``) on the CPU.

The kernel (``csrc/gather_rows.cu``) runs only on the card; what decides
where its bytes go is the plan and the kernel's index arithmetic.  These
tests hold the plan to its limits at every call site's shape and at the
card tests' edge cases, and walk the kernel's mapping in numpy, written out
here as the source computes it (on ``blocks``, block b, thread t and
chunk j take chunk b·C·T + j·T + t of the output stream, a chunk's words
coming from the row and column its offset falls in, the next row's where
it runs past the row's end; on ``rows``, a row's threads take its
accesses in turn): every output byte is written exactly once, from the source
byte of its row's index and its column, at each base alignment the paths
take, and an aligned 16-byte block is read only where it holds a byte of
the row it is read for.
"""

import numpy as np
import pytest

from ggpm_tpu_torch.kernel_bench import GATHER_EDGES, GATHER_EDGE_WIDTHS
from ggpm_tpu_torch.ops.gather_rows import (CHUNK_BYTES, CHUNKS, KINDS,
                                            MAX_GRID, MAX_THREADS, MAX_TOTAL,
                                            Plan, divider, plan, row_threads)

SMS = 132    # an H100's SMs
ELEM = {'bfloat16': 2, 'float32': 4}
# K3's call sites: (table entries, row width, element bytes): the bf16
# LSTM and GRU depth loops, the hier scan's message update, the prop
# step's, the serve encode's and the GRU's f32 depth loops, the hier
# encoder's atom level and the hier training step's atom depth loop
SITES = [(4608, 750, 2), (4608, 500, 2), (6400, 250, 4), (4608, 750, 4),
         (7885, 750, 4), (4608, 500, 4), (24964, 750, 4), (12288, 750, 4)]


def _align(offset):
    """The alignment of a base ``offset`` bytes past a 16-byte boundary."""
    return next(a for a in (16, 8, 4, 2, 1) if offset % a == 0)


def _wide(width, elem, offset):
    return width * elem % 4 == 0 and width * elem >= 16 and offset % 4 == 0


def _row_access(width, elem, offset):
    """(access bytes, accesses a row) of the ``rows`` path, out 16-byte
    aligned."""
    vec = next(v for v in (16, 8, 4, 2) if v >= elem and
               (width * elem) % v == 0 and offset % v == 0)
    return vec, width * elem // vec


def _takes(kind, width, elem, offset, chunks, threads):
    """Whether the kernel takes a forced plan: ``blocks`` on wide rows;
    ``rows`` on every row, at one chunk a thread and whole rows a block."""
    if kind == 'blocks':
        return _wide(width, elem, offset)
    cols = _row_access(width, elem, offset)[1]
    return chunks == 1 and threads % row_threads(cols, threads) == 0


def realign(blk, s):
    """The kernel's ``realign`` of the blocks at ``blk`` and ``blk + 16``
    (the second loaded only where ``s`` > 0) by ``s`` words, on the
    words' addresses in 4-byte units: the four it stores (-1, a word never
    loaded)."""
    a = [blk // 4 + k for k in range(4)]
    b = [np.where(s > 0, blk // 4 + 4 + k, -1) for k in range(4)]
    two, one = (s & 2) > 0, (s & 1) > 0
    none = np.full_like(blk, -1)
    a, b = ([np.where(two, x, y) for x, y in zip(a[2:] + b[:2], a)],
            [np.where(two, x, y) for x, y in zip(b[2:] + [none, none], b)])
    return [np.where(one, x, y) for x, y in zip(a[1:] + b[:1], a)]


def divide(x, d):
    """The kernel's ``divide``: ``x // d`` by ``divider(d)``'s multiply-
    high and shift, on uint64 arrays of x < 2**31."""
    mul, shr = divider(d)
    x = np.asarray(x, np.uint64)
    if not mul:
        return x.astype(np.int64)
    return (((x * np.uint64(mul)) >> np.uint64(32)) >>
            np.uint64(shr)).astype(np.int64)


def walk(p, idx, width, offset):
    """The kernel's copy under plan ``p`` of the rows ``idx`` of a source
    of rows of ``width`` elements whose base lies ``offset`` bytes past a
    16-byte boundary.  Returns, for each output byte, how many threads
    write it and the source byte (from the base) the last one copies; and
    the 16-byte blocks the ``blocks`` path reads, as (block address from
    the boundary, source row read)."""
    n, elem = len(idx), p.elem
    rb = width * elem
    b, j, t = np.meshgrid(np.arange(p.grid), np.arange(p.chunks),
                          np.arange(p.threads), indexing='ij')
    q = (b * p.chunks * p.threads + j * p.threads + t).ravel()
    count = np.zeros(n * rb, np.int64)
    source = np.full(n * rb, -1, np.int64)
    blocks = []
    if p.kind == 'blocks':
        words, total = rb // 4, n * rb // 4
        o = 4 * q
        live = o < total
        o, q = o[live], q[live]
        have = np.minimum(4, total - o)
        r = divide(o, words)
        c = o - r * words
        here = np.minimum(4, words - c)
        at = idx[r] * words + c
        nxt = np.where(here < have, idx[np.minimum(r + 1, n - 1)] * words
                       - here, 0)
        aligned = (have == 4) & (here == 4)
        addr = offset + 4 * at
        blk = addr & ~15
        s = (addr >> 2) & 3
        window = realign(blk, s)
        for k in range(4):
            on = k < have
            word = np.where(k < here, at, nxt) + k
            word = np.where(aligned, (4 * window[k] - offset) // 4, word)
            for byte in range(4):
                dst = 4 * (o[on] + k) + byte
                np.add.at(count, dst, 1)
                source[dst] = 4 * word[on] + byte
        blocks = [(a, row) for a, row in zip(blk[aligned], idx[r[aligned]])]
        blocks += [(a + 16, row) for a, row, sh in
                   zip(blk[aligned], idx[r[aligned]], s[aligned]) if sh]
    else:
        # rows: block b, thread (x, y) of tpr x rpb copies accesses x,
        # x + tpr, ... of row b * rpb + y
        cols = rb // p.vec
        tpr = row_threads(cols, p.threads)
        b, y, x, k = np.meshgrid(np.arange(p.grid),
                                 np.arange(p.threads // tpr), np.arange(tpr),
                                 np.arange(-(-cols // tpr)), indexing='ij')
        row = (b * (p.threads // tpr) + y).ravel()
        col = (x + k * tpr).ravel()
        on = (row < n) & (col < cols)
        row, col = row[on], col[on]
        for byte in range(p.vec):
            dst = row * rb + col * p.vec + byte
            np.add.at(count, dst, 1)
            source[dst] = idx[row] * rb + col * p.vec + byte
    return count, source, blocks


def _check_walk(p, rows, width, offset, seed=0):
    rng = np.random.default_rng(seed)
    m = 40
    idx = rng.integers(0, m, rows)
    idx[::3] = 0
    idx[-1] = m - 1
    count, source, blocks = walk(p, idx, width, offset)
    rb = width * p.elem
    assert (count == 1).all()
    col = np.arange(rows * rb) % rb
    assert (source == np.repeat(idx, rb) * rb + col).all()
    for a, row in blocks:
        start = offset + row * rb
        assert a % 16 == 0 and a < start + rb and a + 16 > start


def _covers(p, rows, width, offset):
    """The plan's grid covers its rows or stream with less than a block
    to spare."""
    if p.kind == 'rows':
        cols = _row_access(width, p.elem, offset)[1]
        rpb = p.threads // row_threads(cols, p.threads)
        return 0 <= p.grid * rpb - rows < rpb
    n = -(-rows * width * p.elem // CHUNK_BYTES)
    return 0 <= p.grid * p.chunks * p.threads - n < p.chunks * p.threads


@pytest.mark.parametrize('site', SITES, ids=str)
def test_plan_at_call_sites(site):
    """At every call site: the per-row path at the rows of 1,000 and 2,000
    bytes (125 accesses of 8 or 16 bytes, 128 threads a row, two rows a
    block), the 16-byte stream at those of 1,500 and 3,000 bytes; at most
    ``MAX_THREADS`` threads, a grid that covers the rows or the stream
    with less than a block to spare and fills every SM several times."""
    rows, width, elem = site
    p = plan(rows, width, elem, 16, 16, SMS)
    row_bytes = width * elem
    if row_bytes in (1000, 2000):
        assert (p.kind, p.threads, p.vec) == \
            ('rows', MAX_THREADS, row_bytes // 125)
    else:
        assert (p.kind, p.vec) == ('blocks', 16)
    assert p.elem == elem and p.threads <= MAX_THREADS
    assert p.grid <= MAX_GRID and _covers(p, rows, width, 0)
    assert p.grid >= 4 * SMS


@pytest.mark.parametrize('edge', GATHER_EDGES, ids=str)
def test_plan_at_edge_cases(edge):
    """The card tests' edge cases: the path their rows and offset allow
    (``rows`` wherever ``blocks`` does not fit), within the kernel's
    limits, the grid covering the rows or the stream."""
    dtype, width, offset, n, a = edge
    elem = ELEM[dtype]
    p = plan(n * a, width, elem, _align(offset), 16, SMS)
    assert _takes(p.kind, width, elem, offset, p.chunks, p.threads)
    if not _wide(width, elem, offset):
        assert p.kind == 'rows'
    assert p.threads <= MAX_THREADS and p.grid <= MAX_GRID
    assert p.chunks in CHUNKS and _covers(p, n * a, width, offset)


@pytest.mark.parametrize('rows', [1, 37])
@pytest.mark.parametrize('shape', [
    (d, w, off) for d, ws in GATHER_EDGE_WIDTHS.items() for w in ws
    for off in range(0, 16, ELEM[d])], ids=str)
def test_walk_copies_every_byte_once(shape, rows):
    """The plan the wrapper would make copies every output byte exactly
    once, from its row's index and column."""
    dtype, width, offset = shape
    p = plan(rows, width, ELEM[dtype], _align(offset), 16, SMS)
    _check_walk(p, rows, width, offset)


@pytest.mark.parametrize('threads', [32, 96, MAX_THREADS])
@pytest.mark.parametrize('chunks', CHUNKS)
@pytest.mark.parametrize('kind', KINDS)
def test_walk_of_every_forced_plan(kind, chunks, threads):
    """Each path, chunks a thread and threads a block, forced, on rows
    that start at every word offset (f32 250 at offset 4, bf16 750 at
    offset 8), at half-words (bf16 251 at offset 2) or at 16 bytes (f32
    500), ``rows`` in one pass or several: each plan the kernel takes
    copies every byte once, each other one raises."""
    for dtype, width, offset in (('float32', 250, 4), ('bfloat16', 750, 8),
                                 ('bfloat16', 251, 2), ('float32', 500, 0)):
        elem = ELEM[dtype]
        if not _takes(kind, width, elem, offset, chunks, threads):
            with pytest.raises(ValueError):
                plan(13, width, elem, _align(offset), 16, SMS, kind, chunks,
                     threads)
            continue
        for rows in (1, 13):
            p = plan(rows, width, elem, _align(offset), 16, SMS, kind,
                     chunks, threads)
            assert (p.kind, p.chunks, p.threads) == (kind, chunks, threads)
            _check_walk(p, rows, width, offset, seed=rows)


@pytest.mark.parametrize('d', [1, 2, 3, 4, 7, 63, 125, 188, 250, 251, 375,
                               500, 750, 1500, 3000, 2 ** 20 + 1,
                               2 ** 30, 2 ** 31 - 1])
def test_divider_divides_every_dividend_below_2_31(d):
    """The multiply-high division the kernel makes for a row's words or
    elements, at the row widths of the call sites and the edge cases, and
    at the extremes: the first dividends, random ones, those around each
    multiple of d and the largest, each equal to ``x // d``."""
    rng = np.random.default_rng(d)
    top = 2 ** 31
    k = np.unique(np.concatenate([np.arange(1, 2000),
                                  rng.integers(1, top // d + 1, 2000)]))
    x = np.concatenate([np.arange(5000), rng.integers(0, top, 200000),
                        d * k - 1, d * k, d * k + 1, [top - 2, top - 1]])
    x = x[(x >= 0) & (x < top)]
    assert (divide(x, d) == x // d).all()
    with pytest.raises(ValueError):
        divider(0)
    with pytest.raises(ValueError):
        divider(top)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        plan(0, 750, 4, 16, 16, SMS)
    with pytest.raises(ValueError):          # f32 at a 2-byte offset
        plan(10, 750, 4, 2, 16, SMS)
    with pytest.raises(ValueError):          # a wide path on an odd row
        plan(10, 251, 2, 16, 16, SMS, 'blocks')
    with pytest.raises(ValueError):          # a wide path into an unaligned out
        plan(10, 750, 4, 16, 8, SMS, 'blocks')
    with pytest.raises(ValueError):
        plan(10, 750, 4, 16, 16, SMS, chunks=3)
    with pytest.raises(ValueError):
        plan(10, 750, 4, 16, 16, SMS, threads=100)
    with pytest.raises(ValueError):
        plan(10, 750, 4, 16, 16, SMS, threads=2 * MAX_THREADS)
    with pytest.raises(ValueError):          # more words than the kernel counts
        plan(MAX_TOTAL // 750 + 1, 1500, 2, 16, 16, SMS)
    with pytest.raises(ValueError):          # a part of a row a block
        plan(10, 500, 4, 16, 16, SMS, 'rows', threads=192)
    with pytest.raises(ValueError):
        plan(10, 500, 4, 16, 16, SMS, 'rows', chunks=2)
    with pytest.raises(ValueError):
        plan(10, 750, 4, 16, 16, SMS, 'narrow')
    # rows that do not fit ``blocks`` take ``rows``, in several passes
    # where a row has more accesses than a block has threads
    assert plan(10, 750, 4, 16, 8, SMS) == Plan('rows', 1, 256, 10, 8, 4)
    assert plan(10, 251, 2, 2, 16, SMS) == Plan('rows', 1, 256, 10, 2, 2)
    assert plan(10, 750, 2, 2, 16, SMS) == Plan('rows', 1, 256, 10, 2, 2)
    assert plan(10, 750, 4, 16, 16, SMS, 'rows', threads=64) == \
        Plan('rows', 1, 64, 10, 8, 4)
    # a row of 92 accesses takes 96 threads: two rows a block of 192
    p = plan(100, 368, 4, 16, 16, SMS)
    assert (p.kind, p.chunks, p.threads, p.grid) == ('rows', 1, 192, 50)
