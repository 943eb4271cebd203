"""The port's hand-written CUDA kernels on the card, against their plain
versions: ``nei_sum`` (B1), its transpose ``transpose_sum`` and the row
gather ``gather_rows``, and the autograd Functions built from them.  Needs an NVIDIA GPU and ``nvcc``; on the card, from the root of
the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the repo's conftest imports JAX, which the card's machine
does not have.)  Without a card every test skips, decided inside the
``cuda`` fixture, never at import.

``nei_sum`` sums its A neighbours in the order a = 0..A-1 in fp32, so it is
held bit for bit against that sum written out in PyTorch, and within 1e-5
against ``graph_ops.nei_sum`` (``h[graph].sum(1)``, whose reduction order is
PyTorch's).  The transpose likewise, in the order k = 0..K-1 of its table;
the row gather is a copy, held bit for bit.
"""

import dataclasses

import pytest
import torch

from ggpm_tpu_torch.kernel_bench import (T_SHAPES, in_order_nei_sum,
                                         in_order_transpose, train_batch,
                                         train_cases)
from ggpm_tpu_torch.kernel_bench import transpose_inputs as _transpose_inputs
from ggpm_tpu_torch.ops import graph_ops
from ggpm_tpu_torch.ops.gather_rows import gather_nd_t, gather_rows
from ggpm_tpu_torch.ops.nei_sum import (KINDS, MAX_CHUNKS, device_plan,
                                        device_plan_t, launch,
                                        launch_transpose, nei_sum, nei_sum_t,
                                        transpose_sum)

pytestmark = pytest.mark.cuda

ATOL = 1e-5

# (M, H, N, A, offset): the serve readouts, the decode frontier at B = 64
# and B = 120 (generic path, A = 12), the A sweep (templates 1..8 and the
# generic path), H in {1, 3, 250, 251, 256}, ragged N, a grid of many
# tiles per persistent block, and h starting 1 or 2 floats off a 16-byte
# boundary (scalar and float2 loads where H allows float4)
SHAPES = ([(1577, 250, 853, 6, 0), (1577, 250, 64, 6, 0),
           (32000, 250, 64, 12, 0), (60000, 250, 120, 12, 0)] +
          [(1577, 250, 853, a, 0) for a in (1, 2, 3, 4, 5, 7, 8, 9, 13)] +
          [(301, 1, 77, 3, 0), (301, 3, 77, 2, 0), (1001, 251, 37, 1, 0),
           (4097, 256, 1001, 3, 0), (20000, 250, 40001, 6, 0),
           (2000, 256, 3001, 4, 1), (2000, 256, 3001, 4, 2),
           (5, 250, 0, 6, 0), (50, 250, 30, 0, 0)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _inputs(m, hdim, n, a, offset, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.rand(m * hdim + offset, generator=gen, device=device) * 2 - 1
    h = base[offset:].view(m, hdim)
    h[0] = 0
    graph = torch.randint(0, m, (n, a), generator=gen, device=device,
                          dtype=torch.int32)
    graph[torch.rand((n, a), generator=gen, device=device) < 0.25] = 0
    return h, graph


def _run(h, graph, kind):
    """The wrapper's own plan (``kind`` None), or ``kind`` forced."""
    if kind is None:
        return nei_sum(h, graph)
    out = torch.empty((graph.shape[0], h.shape[1]), device=h.device)
    return launch(h, graph, out, device_plan(h, graph, out, kind))


@pytest.mark.parametrize('kind', [None, *KINDS])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_nei_sum_kernel_matches_plain(cuda, shape, kind):
    h, graph = _inputs(*shape, device=cuda)
    before = nei_sum.launches
    if kind is not None and graph.shape[0] == 0:
        # no rows, no plan: the wrapper returns the empty result itself
        with pytest.raises(ValueError):
            _run(h, graph, kind)
        return
    out = _run(h, graph, kind)
    torch.cuda.synchronize()
    assert nei_sum.launches == before + (graph.shape[0] > 0)
    assert out.shape == (graph.shape[0], h.shape[1])
    assert torch.equal(out, in_order_nei_sum(h, graph))
    torch.testing.assert_close(out, graph_ops.nei_sum(h, graph), rtol=0,
                               atol=ATOL)


def test_nei_sum_on_cuda_launches_or_raises(cuda):
    """A CUDA tensor never takes the plain version: a launch is counted,
    and a plan the kernel cannot take raises and counts nothing."""
    h, graph = _inputs(100, 250, 40, 12, 0, device=cuda)
    before = nei_sum.launches
    nei_sum(h, graph)
    assert nei_sum.launches == before + 1
    out = torch.empty((40, 250), device=cuda)
    with pytest.raises(ValueError):
        device_plan(h, graph, out, 'no-such-kind')
    bad = dataclasses.replace(device_plan(h, graph, out), vec=3)
    with pytest.raises(RuntimeError):
        launch(h, graph, out, bad)
    assert nei_sum.launches == before + 1


# -- the transpose (nei_sum's backward) and the row gather ---------------

# the K2 cases of a training step (kernel_bench.train_cases on the first
# HOPV batch), beside the random T_SHAPES
TRAIN_T_CASES = ('depth-gather-bwd', 'readout-bwd', 'root-bwd',
                 'frontier-bwd')


@pytest.fixture(scope='module')
def train_t_cases():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    gen = torch.Generator(device='cuda').manual_seed(1)
    return {c['case']: c['args'] for c in train_cases(train_batch('cuda'), gen)
            if c['kernel'] == 'transpose_sum'}


@pytest.mark.parametrize('chunks', [None, *range(1, MAX_CHUNKS + 1)])
@pytest.mark.parametrize('shape', [*T_SHAPES, *TRAIN_T_CASES], ids=str)
def test_transpose_kernel_matches_plain(cuda, shape, chunks, request):
    """The wrapper's own plan (``chunks`` None), or each count of column
    chunks per thread forced: bit for bit the in-order sum."""
    if shape in TRAIN_T_CASES:
        g, t_idx, t_mask, div = request.getfixturevalue('train_t_cases')[shape]
    else:
        _, t_idx, t_mask, g, div = _transpose_inputs(*shape, device=cuda)
    before = transpose_sum.launches
    if chunks is None:
        out = transpose_sum(g, t_idx, t_mask, div)
    else:
        out = torch.empty((t_idx.shape[0], g.shape[1]), device=cuda)
        launch_transpose(g, t_idx, t_mask, div, out,
                         device_plan_t(g, t_idx, out, chunks))
    torch.cuda.synchronize()
    assert transpose_sum.launches == before + 1
    assert torch.equal(out, in_order_transpose(g, t_idx, t_mask, div))
    torch.testing.assert_close(
        out, graph_ops.transpose_sum(g, t_idx, t_mask, div), rtol=0,
        atol=ATOL)


@pytest.mark.parametrize('shape', [(768, 750, 768, 6, False),
                                   (768, 250, 384, 4, True),
                                   (2001, 250, 1501, 12, True)], ids=str)
def test_transpose_kernel_takes_any_mask(cuda, shape):
    """Each row's entries permuted, so that masked slots lie between real
    ones (the table puts them last): bit for bit the in-order sum still;
    and weights other than 0 and 1, within 1e-5 of the plain version."""
    _, t_idx, t_mask, g, div = _transpose_inputs(*shape, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    perm = torch.argsort(torch.rand(t_idx.shape, generator=gen, device=cuda),
                         dim=1)
    t_idx = t_idx.gather(1, perm).contiguous()
    t_mask = t_mask.gather(1, perm).contiguous()
    out = transpose_sum(g, t_idx, t_mask, div)
    assert torch.equal(out, in_order_transpose(g, t_idx, t_mask, div))
    weights = t_mask * torch.rand(t_mask.shape, generator=gen, device=cuda) * 2
    torch.testing.assert_close(
        transpose_sum(g, t_idx, weights, div),
        graph_ops.transpose_sum(g, t_idx, weights, div), rtol=0, atol=ATOL)


@pytest.mark.parametrize('shape', [(768, 750, 768, 6), (1577, 750, 1577, 5),
                                   (300, 250, 853, 6), (301, 251, 77, 3),
                                   (64, 1, 10, 2), (5, 750, 0, 6)], ids=str)
def test_gather_rows_kernel_is_a_copy(cuda, shape):
    m, w, n, a = shape
    gen = torch.Generator(device=cuda).manual_seed(2)
    src = torch.rand((m, w), generator=gen, device=cuda)
    graph = torch.randint(0, m, (n, a), generator=gen, device=cuda,
                          dtype=torch.int32)
    before = gather_rows.launches
    out = gather_rows(src, graph)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + (n > 0)
    assert out.shape == (n, a, w)
    assert torch.equal(out, src[graph.long()])


@pytest.mark.parametrize('op', ['nei_sum_t', 'gather_nd_t'])
@pytest.mark.parametrize('shape', [(768, 250, 384, 6), (768, 750, 768, 4),
                                   (2001, 250, 900, 12)], ids=str)
def test_autograd_kernels_match_index_add(cuda, op, shape):
    """The autograd Functions on the card: forward equal to the plain
    version, gradient within 1e-5 of the exact one, ``index_add_`` of the
    cotangent in float64 over the forward table with row 0 left out (row
    0 of h is zero at every call site, and its cotangent dead)."""
    m, w, n, a = shape
    graph, t_idx, t_mask, _, _ = _transpose_inputs(m, w, n, a, True, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    h = torch.rand((m, w), generator=gen, device=cuda)
    h[0] = 0
    x = h.clone().requires_grad_()
    fn = nei_sum_t if op == 'nei_sum_t' else gather_nd_t
    counts = (nei_sum.launches, gather_rows.launches, transpose_sum.launches)
    out = fn(x, graph, t_idx, t_mask)
    cot = torch.rand(out.shape, generator=gen, device=cuda) * 2 - 1
    out.backward(cot)
    torch.cuda.synchronize()
    fwd = 0 if op == 'nei_sum_t' else 1
    assert nei_sum.launches - counts[0] == 1 - fwd
    assert gather_rows.launches - counts[1] == fwd
    assert transpose_sum.launches - counts[2] == 1
    plain = h[graph.long()]
    assert torch.equal(out.detach(),
                       plain if fwd else in_order_nei_sum(h, graph))
    src = (cot[:, None, :].expand(n, a, w) if op == 'nei_sum_t' else cot)
    want = torch.zeros((m, w), dtype=torch.float64, device=cuda).index_add_(
        0, graph.reshape(-1).long(), src.reshape(-1, w).double())
    want[0] = 0
    torch.testing.assert_close(x.grad.double(), want, rtol=0, atol=ATOL)


def test_kernels_refuse_a_gradient_without_the_transpose(cuda):
    h = torch.rand((50, 250), device=cuda, requires_grad=True)
    graph = torch.randint(0, 50, (10, 3), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match='nei_sum_t'):
        nei_sum(h, graph)
    with pytest.raises(ValueError, match='gather_nd_t'):
        gather_rows(h, graph)
    with torch.no_grad():
        nei_sum(h, graph)
        gather_rows(h, graph)


def test_device_launches_count_every_launch_that_ran(cuda):
    """``ops.device_launches``: each kernel counts its own launches on the
    card, one a launch, eager and replayed from a CUDA graph alike (the
    count the launch checks of ``chip_smoke.py`` hold, which the
    profiler's records may fall short of)."""
    from ggpm_tpu_torch.ops import device_launches
    graph, t_idx, t_mask, g, div = _transpose_inputs(1577, 250, 853, 6, True,
                                                     cuda)
    h = torch.randn((1577, 250), device=cuda)

    def calls():
        return (nei_sum(h, graph), gather_rows(h, graph), gather_rows(h, graph),
                transpose_sum(g, t_idx, t_mask, div))
    want = {'nei_sum': 1, 'gather_rows': 2, 'transpose_sum': 1}
    before = device_launches()
    eager = calls()
    after = device_launches()
    assert {k: after[k] - before[k] for k in want} == want
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    replay = torch.cuda.CUDAGraph()
    with torch.cuda.graph(replay):
        captured = calls()
    before = device_launches()
    for _ in range(5):
        replay.replay()
    after = device_launches()
    assert {k: after[k] - before[k] for k in want} == \
        {k: 5 * n for k, n in want.items()}
    for e, c in zip(eager, captured):
        assert torch.equal(e, c)
