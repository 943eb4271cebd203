"""The hier family's training step on the card: the kernels at the step's
new call sites against their plain versions, and the step replayed from a
captured CUDA graph against the same step run eagerly, bit for bit, with
the launches PERF.md derives.  Needs an NVIDIA GPU and ``nvcc``; on the
card, from the root of the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hier_train_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which the card's
machine does not have.)  Without a card every test skips, decided inside
the ``card`` fixture, never at import.
"""

import pytest
import torch

from ggpm_tpu_torch import kernel_bench, profile_train
from ggpm_tpu_torch.ops import gather_rows, nei_sum, transpose_sum

pytestmark = pytest.mark.cuda

# a sum of at most a few values of magnitude <= 1 in another order
KERNEL_ATOL = 1e-5


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab, batches = profile_train.hopv_batches(
        2, profile_train.load_vocab_file(profile_train.HIER_VOCAB))
    return dict(vocab=vocab, batches=batches)


def _counts():
    return {'nei_sum': nei_sum.launches, 'transpose_sum':
            transpose_sum.launches, 'gather_rows': gather_rows.launches}


def test_kernels_at_the_hier_training_sites(card):
    """``nei_sum`` at the ten sums of a step and ``transpose_sum`` at
    their transposes (``kernel_bench.hier_train_cases`` on the first
    batch) equal their plain versions within 1e-5 and their in-order sums
    bit for bit."""
    trainer, _ = profile_train.hier_trainer('cuda', vocab=card['vocab'])
    batch = trainer.device_batch(trainer.host_batch(card['batches'][0]))
    gen = torch.Generator(device='cuda').manual_seed(1)
    for c in kernel_bench.hier_train_cases(batch, gen):
        out = c['call']()
        torch.cuda.synchronize()
        assert (out - c['plain']()).abs().max().item() <= KERNEL_ATOL, \
            c['case']
        assert torch.equal(out, (c['exact'] or c['plain'])()), c['case']


@pytest.mark.parametrize('finetune', [False, True],
                         ids=['hier-prop', 'hier-prop-opt'])
def test_graph_step_equals_eager_step(card, finetune):
    """The first two batches (one signature) through ``scan_steps``'s
    graph (the first step eager on the capture's stream, the second
    replayed) and through two eager steps, from the same checkpoint: the
    metrics, parameters and Adam moments bit for bit; each step launches
    ``nei_sum`` 5 + 5·T, ``transpose_sum`` 59 + 15·T and ``gather_rows``
    60 + 10·T times (T the scan's padded steps; PERF.md derives them)."""
    rows, states = {}, {}
    for graph in (False, True):
        tr, _ = profile_train.hier_trainer('cuda', finetune, card['vocab'])
        dbs = [tr.device_batch(tr.host_batch(mb))
               for mb in card['batches'][:2]]
        torch.cuda.synchronize()
        before = _counts()
        metrics, _ = tr.scan_steps(dbs, graph=graph)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in _counts().items()}
        T = dbs[0]['plan']['mess'].shape[0]
        assert launches == {'nei_sum': 2 * (5 + 5 * T),
                            'transpose_sum': 2 * (59 + 15 * T),
                            'gather_rows': 2 * (60 + 10 * T)}
        rows[graph] = metrics
        opt = getattr(tr.opt_state, 'groups', {'': tr.opt_state})
        states[graph] = {f'{g}/{k}': getattr(st, k).clone()
                         for g, st in opt.items()
                         for k in ('flat', 'mu', 'nu')}
    bits = lambda t: t.view(torch.int32)
    for k in rows[False]:
        assert torch.equal(bits(rows[False][k]), bits(rows[True][k])), k
    for k in states[False]:
        assert torch.equal(bits(states[False][k]), bits(states[True][k])), k
