"""The port's hand-written CUDA kernels on the card, against their plain
versions.  Needs an NVIDIA GPU and ``nvcc``; on the card, from the root of
the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the repo's conftest imports JAX, which the card's machine
does not have.)  Without a card every test skips, decided inside the
``cuda`` fixture, never at import.

``nei_sum`` sums its A neighbours in the order a = 0..A-1 in fp32, so it is
held bit for bit against that sum written out in PyTorch, and within 1e-5
against ``graph_ops.nei_sum`` (``h[graph].sum(1)``, whose reduction order is
PyTorch's).
"""

import dataclasses

import pytest
import torch

from ggpm_tpu_torch.ops import graph_ops
from ggpm_tpu_torch.ops.nei_sum import KINDS, device_plan, launch, nei_sum

pytestmark = pytest.mark.cuda

ATOL = 1e-5

# (M, H, N, A, offset): the serve readouts, the A sweep (templates 1..8 and
# the generic path), H in {1, 3, 250, 251, 256}, ragged N, a grid of many
# tiles per persistent block, and h starting 1 or 2 floats off a 16-byte
# boundary (scalar and float2 loads where H allows float4)
SHAPES = ([(1577, 250, 853, 6, 0), (1577, 250, 64, 6, 0)] +
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


def _in_order(h, graph):
    out = torch.zeros((graph.shape[0], h.shape[1]), device=h.device)
    if graph.shape[1]:
        out = h[graph[:, 0].long()].clone()
    for j in range(1, graph.shape[1]):
        out += h[graph[:, j].long()]
    return out


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
    assert torch.equal(out, _in_order(h, graph))
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
