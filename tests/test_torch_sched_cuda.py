"""The prop-opt-sched path and the attention heads on the card: ``nei_sum``
and its transpose at the scheduled scan's readout
(``kernel_bench.sched_cases``) against their plain versions and in-order
sums; one ``tf_ratio`` 0.5 step of the trained checkpoint's
``PropOptSchedulingVAE`` with the golden's coins on the card against the
CPU port (``profile_train.check_sched_step``); and the attention model's
step replayed from a captured graph against the eager step, bit for bit.
Needs an NVIDIA GPU and ``nvcc``; on the card, from the root of the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sched_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which the card's machine
does not have.)  Without a card every test skips, decided inside the
``card`` fixture, never at import.
"""

import json
import os

import pytest
import torch

from ggpm_tpu_torch import kernel_bench, profile_train
from ggpm_tpu_torch.data.batching import train_tables
from ggpm_tpu_torch.train.loop import to_device

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'train_propsched_hopv.json')


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab, batches = profile_train.hopv_batches()
    with open(GOLDEN) as f:
        golden = json.load(f)
    return dict(vocab=vocab, batches=batches, golden=golden)


def _host(card):
    tr, _ = profile_train.sched_trainer('cpu', card['vocab'])
    return tr.host_batch(card['batches'][0])


def test_sched_readout_kernels_match_their_plain_versions(card):
    """K1 and K2 at the scheduled readout of the first HOPV batch: within
    1e-5 of the plain versions, bit for bit the in-order sums."""
    dev = to_device(train_tables(_host(card)), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(3)
    for c in kernel_bench.sched_cases(dev, gen):
        out = c['call']()
        torch.testing.assert_close(out, c['plain'](), rtol=0, atol=1e-5)
        assert torch.equal(out, c['exact']()), c['case']


def test_sched_step_on_the_card_matches_the_cpu_port(card):
    """One tf_ratio 0.5 forward and backward with the golden's coins:
    the fed-back predictions the CPU port's (or a named near-tie), the
    metrics the golden's and every gradient the CPU port's."""
    host = _host(card)
    got = profile_train.sched_step(
        profile_train.sched_model(card['vocab'])[0].to('cuda'),
        to_device(train_tables(host), 'cuda'),
        profile_train.sched_coins(card['golden'], 'cuda'))
    cpu = profile_train.sched_step(
        profile_train.sched_model(card['vocab'])[0],
        to_device(train_tables(host), 'cpu'),
        profile_train.sched_coins(card['golden'], 'cpu'))
    bad, ties = profile_train.check_sched_step(got, cpu, card['golden'])
    assert bad == [], (bad, ties)
    assert int(cpu['use'].sum()) > 0


@pytest.mark.parametrize('hier', [False, True], ids=['prop-opt', 'hier-prop'])
def test_attention_step_replays_bit_for_bit(card, hier):
    """Two steps of one signature with the attention heads, eagerly and
    through ``Trainer.scan_steps``' graph (the attention over the memories
    inside the captured step): the metrics and the parameters after equal
    bit for bit."""
    vocab = (profile_train.load_vocab_file(profile_train.HIER_VOCAB) if hier
             else card['vocab'])
    batches = (profile_train.hopv_batches(vocab=vocab)[1] if hier
               else card['batches'])
    out = {}
    for graph in (False, True):
        tr, _ = profile_train.attention_trainer('cuda', hier, vocab)
        pair = next(g[:2] for g in profile_train.flush_groups(tr, batches)
                    if len(g) > 1)
        metrics, _ = tr.scan_steps(pair, graph=graph)
        out[graph] = (metrics, tr.opt_state.flat.clone() if hier else
                      torch.cat([st.flat for st in
                                 tr.opt_state.groups.values()]))
    bits = lambda t: t.view(torch.int32)
    for k in out[False][0]:
        assert torch.equal(bits(out[False][0][k]), bits(out[True][0][k])), k
    assert torch.equal(bits(out[False][1]), bits(out[True][1]))
