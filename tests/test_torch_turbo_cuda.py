"""The turbo decode on the card: the propose loop replayed from captured
CUDA graphs against the same loop run eagerly, bit for bit (same kernels in
the same order), ``decode_motif_turbo`` against the exact path on the
trained HOPV model, and B1's launches in a turbo decode (the profiler's
against the wrapper's count and the steps run).  Needs an NVIDIA GPU and ``nvcc``; on the card, from
the root of the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_turbo_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which the card's machine
does not have.)  Without a card every test skips, decided inside the
``card`` fixture, never at import.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models import decode
from ggpm_tpu_torch.models.api import encode

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
T = 150
BEAM = 5


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    model, vocab = load_model(CKPT, VOCAB, device='cuda')
    rows = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:120]
    batch = to_model_batch(tensorize(rows, vocab, common_atom_vocab),
                           vocab.mask, pad=False)
    return dict(model=model, vocab=vocab, z=encode(model, batch)[0])


def _round(model, mask, tabs, z, pins, graph):
    """One propose round over latents ``z``: replayed from a CUDA graph
    with the turbo decode's lookahead, or eagerly one step at a time."""
    prop = decode.Proposer(model, mask, tabs, BEAM, T, len(z), graph=graph)
    return decode.propose_round(prop, z, pins,
                                decode.CUDA_LOOKAHEAD if graph else 0)[0]


@pytest.mark.parametrize('batch', [64, 120])
def test_graph_replay_equals_eager(card, batch):
    """A free round, then a round pinned as the host's replay of the first
    left each sample: traces, root motifs and active steps equal."""
    model, vocab = card['model'], card['vocab']
    tabs, mask = decode._device_vocab(vocab, common_atom_vocab,
                                      torch.device('cuda'))
    z = card['z'][:batch]
    pins = np.zeros((3, T, batch), np.int64)
    with torch.inference_mode():
        for rnd in range(2):
            eager = _round(model, mask, tabs, z, pins, graph=False)
            graph = _round(model, mask, tabs, z, pins, graph=True)
            for a, b in zip(eager[:3], graph[:3]):
                np.testing.assert_array_equal(a, b)
            assert eager[3] == graph[3]
            packed, root_cls, root_icls, _ = eager
            for j in range(batch):
                rs = decode._ReplayState(vocab, common_atom_vocab, 400, 500,
                                         12)
                decode._replay_pinned(packed[:, j], root_cls[j],
                                      root_icls[j], rs, vocab, BEAM)
                for t, pin in enumerate(rs.pins):
                    pins[:, t, j] = pin
            assert rnd or pins[0].any()


def test_turbo_equals_exact_on_the_card(card):
    model, vocab = card['model'], card['vocab']
    z = card['z'][:64]
    _, exact = decode.decode_motif(model, vocab, common_atom_vocab, z,
                                   greedy=True, max_decode_step=T,
                                   log_steps=False)
    _, turbo = decode.decode_motif_turbo(model, vocab, common_atom_vocab, z,
                                         max_decode_step=T)
    assert turbo == exact
    assert decode.TURBO_STATS['fallbacks'] == 0


@pytest.mark.parametrize('case', ['one-round', 'fallback'])
def test_turbo_counts_every_b1_launch(card, case):
    """A turbo decode that captures its graph (and, under a round cap of
    one-step rungs, sends samples to the exact path): B1's launches that
    ran on the card (the kernel's own device count) equal the wrapper's
    count, which equals the steps the rounds ran plus the steps run
    outside them; the profiler's records of them are at most as many."""
    from ggpm_tpu_torch.ops import nei_sum
    from ggpm_tpu_torch.profile_serve import profiled
    kw = dict(ladder=(1, 2), max_rounds=2) if case == 'fallback' else {}
    decode._PROPOSERS.clear()
    before, ran = nei_sum.launches, {}
    _, events = profiled(lambda: decode.decode_motif_turbo(
        card['model'], card['vocab'], common_atom_vocab, card['z'][:16],
        max_decode_step=T, **kw), ran=ran)
    st = decode.TURBO_STATS
    device = sum(e.count for e in events if 'nei_sum_kernel' in e.key)
    assert ran['nei_sum'] == nei_sum.launches - before == \
        sum(st['steps_run']) + st['eager_steps'] >= device, st
    if case == 'fallback':    # a capture a rung, and the exact path's steps
        assert st['fallbacks'] > 0 and st['eager_steps'] > len(st['rungs'])
    else:                     # the one capture
        assert (st['fallbacks'], st['eager_steps']) == (0, 1)


FAILING_CAPTURE = '''
import sys, torch
from ggpm_tpu_torch.bridge import load_model
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models import decode, decoder
step = decoder.MotifDecoder.propose_step_

def syncing_step(self, carry, *args, **kwargs):
    step(self, carry, *args, **kwargs)
    carry['sp'].sum().item()      # a host sync, which a capture refuses

decoder.MotifDecoder.propose_step_ = syncing_step
model, vocab = load_model(sys.argv[1], sys.argv[2], device='cuda')
z = torch.zeros((4, model.cfg.latent_size), device='cuda')
try:
    decode.decode_motif_turbo(model, vocab, common_atom_vocab, z,
                              max_decode_step=20)
except RuntimeError as e:
    print('raised:', str(e).splitlines()[0])
    sys.exit(0)
print('no error: the capture did not fail, or it was hidden')
sys.exit(3)
'''


def test_a_failing_capture_raises(card):
    """A step that syncs with the host cannot be captured: the decode
    raises instead of taking the eager loop or the exact path (in a child
    process, which the failed capture cannot leave in a bad state for the
    other tests)."""
    out = subprocess.run([sys.executable, '-c', FAILING_CAPTURE, CKPT, VOCAB],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith('raised:')
