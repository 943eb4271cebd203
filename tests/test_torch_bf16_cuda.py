"""The bf16 variants of the port's kernels on the card (ROADMAP A5):
``nei_sum`` (K1), its transpose ``transpose_sum`` (K2) and the row gather
``gather_rows`` (K3) on bf16 tables, and K3/K2 at the GRU's width in f32.
Needs an NVIDIA GPU and ``nvcc``; on the card, from the root of the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bf16_cuda.py

A bf16 sum is accumulated in f32 in the kernel's order and rounded once,
so each kernel is held bit for bit to its plain version
(``graph_ops.nei_sum`` / ``transpose_sum``, which sum a bf16 table in that
order) and to ``kernel_bench``'s in-order sums; the gather is a copy.  The
shapes: chip_smoke.py phase 14's (``kernel_bench.a5_cases`` on the first
HOPV training batch), and random tables over every load width (1, 2, 4
and 8 bf16 a load), both launch kinds and the generic path (A > 8).
"""

import pytest
import torch

from ggpm_tpu_torch.kernel_bench import (a5_cases, in_order_nei_sum,
                                         in_order_transpose, measure,
                                         train_batch)
from ggpm_tpu_torch.kernel_bench import transpose_inputs as _transpose_inputs
from ggpm_tpu_torch.ops import graph_ops
from ggpm_tpu_torch.ops.gather_rows import gather_nd_t, gather_rows
from ggpm_tpu_torch.ops.nei_sum import (KINDS, MAX_CHUNKS, device_plan,
                                        device_plan_t, launch,
                                        launch_transpose, nei_sum, nei_sum_t,
                                        transpose_sum, vec_width)

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16

# (M, H, N, A): the serve and training readouts' widths at H 250 (2 bf16 a
# load), H 252 (4), 256 (8), 251 (1), the generic path (A 12) and a grid of
# many tiles
SHAPES = [(1577, 250, 853, 6), (1577, 252, 853, 4), (4097, 256, 1001, 3),
          (1001, 251, 37, 1), (32000, 250, 120, 12), (20000, 256, 40001, 6),
          (50, 250, 30, 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _table(m, hdim, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    h = (torch.rand((m, hdim), generator=gen, device=device) * 2 - 1)
    h[0] = 0
    return h.to(BF16), gen


@pytest.mark.parametrize('kind', [None, *KINDS])
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_bf16_nei_sum_is_the_in_order_sum(cuda, shape, kind):
    m, hdim, n, a = shape
    h, gen = _table(m, hdim, cuda)
    graph = torch.randint(0, m, (n, a), generator=gen, device=cuda,
                          dtype=torch.int32)
    graph[torch.rand((n, a), generator=gen, device=cuda) < 0.25] = 0
    before = (nei_sum.launches, nei_sum.launches_bf16)
    if kind is None:
        out = nei_sum(h, graph)
    else:
        out = torch.empty((n, hdim), dtype=BF16, device=cuda)
        launch(h, graph, out, device_plan(h, graph, out, kind))
    torch.cuda.synchronize()
    assert out.dtype == BF16
    assert (nei_sum.launches, nei_sum.launches_bf16) == (before[0] + 1,
                                                         before[1] + 1)
    assert torch.equal(out, in_order_nei_sum(h, graph))
    assert torch.equal(out, graph_ops.nei_sum(h, graph))


def test_bf16_load_widths(cuda):
    """The widest load the row allows: 8 bf16 at H 256, 4 at 252 and at
    the GRU's 500, 2 at 250 and the LSTM's 750, 1 at 251."""
    for hdim, vec in ((256, 8), (252, 4), (500, 4), (250, 2), (750, 2),
                      (251, 1)):
        h = torch.zeros((4, hdim), dtype=BF16, device=cuda)
        assert vec_width(h, torch.zeros_like(h)) == vec, hdim


@pytest.mark.parametrize('chunks', [None, *range(1, MAX_CHUNKS + 1)])
@pytest.mark.parametrize('shape', [(768, 750, 768, 6, False),
                                   (768, 500, 768, 4, False),
                                   (768, 250, 384, 6, True),
                                   (2001, 256, 1501, 12, True),
                                   (2001, 251, 900, 3, True)], ids=str)
def test_bf16_transpose_is_the_in_order_sum(cuda, shape, chunks):
    _, t_idx, t_mask, g, div = _transpose_inputs(*shape, device=cuda)
    g = g.to(BF16)
    before = transpose_sum.launches_bf16
    if chunks is None:
        out = transpose_sum(g, t_idx, t_mask, div)
    else:
        out = torch.empty((t_idx.shape[0], g.shape[1]), dtype=BF16,
                          device=cuda)
        launch_transpose(g, t_idx, t_mask, div, out,
                         device_plan_t(g, t_idx, out, chunks))
    torch.cuda.synchronize()
    assert out.dtype == BF16 and transpose_sum.launches_bf16 == before + 1
    assert torch.equal(out, in_order_transpose(g, t_idx, t_mask, div))
    assert torch.equal(out, graph_ops.transpose_sum(g, t_idx, t_mask, div))


@pytest.mark.parametrize('dtype', [BF16, torch.float32])
@pytest.mark.parametrize('width', [750, 500, 256, 251, 1])
def test_gather_rows_copies_any_width(cuda, dtype, width):
    """A byte copy at every row width, row 0 included (the GRU's table
    holds ``b_r`` there, not zeros)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    src = (torch.rand((900, width), generator=gen, device=cuda) + 1).to(dtype)
    graph = torch.randint(0, 900, (700, 6), generator=gen, device=cuda,
                          dtype=torch.int32)
    graph[:, 0] = 0
    before = gather_rows.launches_bf16
    out = gather_rows(src, graph)
    torch.cuda.synchronize()
    assert torch.equal(out, src[graph.long()])
    assert out[:, 0].ne(0).all()
    assert gather_rows.launches_bf16 == before + (dtype == BF16)


@pytest.mark.parametrize('op', ['nei_sum_t', 'gather_nd_t'])
def test_bf16_autograd_is_the_plain_transpose(cuda, op):
    """The autograd Functions on bf16 tables: forward and gradient equal
    to the plain versions', bit for bit."""
    graph, t_idx, t_mask, _, _ = _transpose_inputs(768, 500, 384, 6, True,
                                                   cuda)
    h, gen = _table(768, 500, cuda, 3)
    x = h.clone().requires_grad_()
    fn = nei_sum_t if op == 'nei_sum_t' else gather_nd_t
    out = fn(x, graph, t_idx, t_mask)
    cot = (torch.rand(out.shape, generator=gen, device=cuda) * 2 - 1).to(BF16)
    out.backward(cot)
    div = graph.shape[1] if op == 'nei_sum_t' else 1
    flat = cot if op == 'nei_sum_t' else cot.reshape(-1, cot.shape[-1])
    assert x.grad.dtype == BF16
    assert torch.equal(x.grad, graph_ops.transpose_sum(flat, t_idx, t_mask,
                                                       div))
    plain = graph_ops.nei_sum(h, graph) if op == 'nei_sum_t' else \
        h[graph.long()]
    assert torch.equal(out.detach(), plain)


def test_phase_14_cases_are_bit_exact(cuda):
    """chip_smoke.py phase 14's cases (``kernel_bench.a5_cases`` on the
    first HOPV training batch): every kernel equals its plain version and
    its in-order sum bit for bit, and is timed."""
    gen = torch.Generator(device='cuda').manual_seed(4)
    rows = list(measure(a5_cases(train_batch('cuda'), gen), 0.0))
    assert len(rows) == 8
    for row in rows:
        assert row['bit_exact'] and row['max_abs_err'] == 0, row['case']
        assert row['ms'] > 0 and row['library_ms'] > 0
