"""The port's ``nei_sum`` (its CPU path: the plain version of the CUDA
kernel) against the JAX package's ``graph_ops.nei_sum`` and against the
Pallas kernel itself, run in interpret mode.

Tolerance 1e-6 absolute: the sums take at most a few terms of magnitude
<= 1, in an order that may differ between the three.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ggpm_tpu.ops import graph_ops as jax_ops
from ggpm_tpu.ops import pallas_gather
from ggpm_tpu_torch.ops import gather_nd, nei_sum, zero_row0_
from ggpm_tpu_torch.ops import graph_ops

torch.set_num_threads(1)

ATOL = 1e-6

# (M, H, N, A): the checked Pallas shape, N not a multiple of the Pallas
# tile (8) or of the CUDA block (4), A = 1, and the model's H = 250
SHAPES = [(64, 256, 21, 6), (40, 128, 13, 3), (48, 128, 16, 1),
          (120, 250, 37, 6)]


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
