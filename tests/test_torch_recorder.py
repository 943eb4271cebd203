"""The training loop's recorder (``train/profiling.py``: ``recording``,
``named_scope``, ``at_step``, ``tag``, ``count``) and its spans and
counters in ``train/loop.py``, on the CPU, for both families at small
width: off, an epoch reads no clock through the recorder and records
nothing; on, its spans nest under the right parents with their batches'
(epoch, index), ``tables`` and ``upload`` inside the harness's own span
around ``Trainer.device_batch`` (``benchmark/yardstick/spans.py``), and
its counters equal a count made directly from the batches; the trainer's
step counts in ``graph_stats``.  Also the port kernels' names
(``ops.KERNEL_FUNCTIONS``) against their sources.

The epoch takes three batches A, B, A (A and B of two shape signatures),
so it runs one flush of two through ``scan_steps`` (on the CPU, two eager
steps) and one flush of one through ``train_step``.  The card's steps
(warm-ups, captures, replays) are held in tests/test_torch_scan_cuda.py.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

from benchmark.yardstick.spans import Spans
from ggpm_tpu_torch.data.batching import pad_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file
from ggpm_tpu_torch.models.vae import (HierPropertyVAE, ModelConfig,
                                       PropertyVAE, init_params)
from ggpm_tpu_torch.ops import KERNEL_FUNCTIONS
from ggpm_tpu_torch.profile_serve import kernel_of
from ggpm_tpu_torch.train import profiling
from ggpm_tpu_torch.train.loop import Trainer, flushes, signature
from ggpm_tpu_torch.train.optim import make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
FAMILIES = {'prop': (PropertyVAE, 'QUALITY_hopv.json.vocab.txt'),
            'hier-prop': (HierPropertyVAE, 'QUALITY_hier_hopv.json.vocab.txt')}
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3,
             depthG=3, diterG=1)
BATCH = 4
EPOCH = 5
SPANS = {'epoch', 'host_batch', 'tables', 'upload', 'flush.graphs',
         'flush.eager', 'boundary'}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module', params=sorted(FAMILIES))
def family(request):
    """A small model of the family, its vocab and the epoch's batches A,
    B, A (the first two batches of ``BATCH`` HOPV molecules whose host
    signatures differ)."""
    cls, vocab_file = FAMILIES[request.param]
    vocab = load_vocab_file(os.path.join(ROOT, 'runs', vocab_file))
    rows = prune_to_vocab(read_csv_data(DATA)[:40], vocab, verbose=False)
    hv, iv = vocab.size()
    cfg = ModelConfig(hvocab_size=hv, ivocab_size=iv, **SMALL)
    probe = _trainer(cls, cfg, vocab)
    batches, sigs = [], []
    for i in range(0, len(rows) - BATCH + 1, BATCH):
        mb = pad_batch(tensorize(rows[i:i + BATCH], vocab, common_atom_vocab))
        sig = signature(probe.host_batch(mb))
        if sig not in sigs:
            batches.append(mb)
            sigs.append(sig)
        if len(batches) == 2:
            break
    a, b = batches
    return dict(cls=cls, cfg=cfg, vocab=vocab, data=[a, b, a])


def _trainer(cls, cfg, vocab):
    torch.manual_seed(0)
    model = init_params(cls(cfg), torch.Generator().manual_seed(0))
    return Trainer(model, make_optimizer(lr=1e-3, clip_norm=20.0,
                                         anneal_rate=0.9, steps_per_epoch=3),
                   vocab.mask, beta=0.1, print_iter=10 ** 9, device='cpu')


def _epoch(family):
    tr = _trainer(family['cls'], family['cfg'], family['vocab'])
    return tr, lambda: tr.train_epoch(family['data'], epoch=EPOCH,
                                      log=lambda *_: None)


def test_off_reads_no_clock_and_records_nothing(family, monkeypatch):
    reads = []
    monkeypatch.setattr(profiling, '_clock',
                        lambda: reads.append(1) or 0)
    tr, run = _epoch(family)
    assert profiling.named_scope('a') is profiling.named_scope('b')
    assert not run()
    assert reads == [] and profiling.current() is None
    assert tr.total_step == 3


def test_spans_nest_with_parents_and_steps(family):
    tr, run = _epoch(family)
    harness = Spans()
    harness.intervals = []
    harness.wrap(tr, 'device_batch', 'device_batch')
    try:
        with profiling.recording() as rec:
            run()
    finally:
        harness.unwrap()
    spans = rec.spans
    assert {s.name for s in spans} == SPANS
    assert rec.calls() == {'epoch': 1, 'host_batch': 3, 'tables': 3,
                           'upload': 3, 'flush.graphs': 1, 'flush.eager': 1,
                           'boundary': 1}
    top = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in top] == ['epoch']
    assert spans[top[0]].step == (EPOCH, None)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert p.name == 'epoch'
    for name in ('host_batch', 'tables', 'upload'):
        assert [s.step for s in spans if s.name == name] == \
            [(EPOCH, i) for i in range(3)]
    # the flush of A's two batches (arrivals 0 and 2) runs first, at the
    # epoch's end, then B's flush of one (arrival 1)
    flush = [(s.name, s.step) for s in spans if s.name.startswith('flush')]
    assert flush == [('flush.graphs', (EPOCH, 0)),
                     ('flush.eager', (EPOCH, 1))]
    assert [s.step for s in spans if s.name == 'boundary'] == [(EPOCH, None)]
    # tables and upload inside the harness's span around device_batch
    wrapped = [(s, e) for s, e, name in harness.intervals]
    assert len(wrapped) == 3
    for i, (s, e) in enumerate(wrapped):
        inside = [x for x in spans if x.name in ('tables', 'upload')
                  and x.step == (EPOCH, i)]
        assert len(inside) == 2
        assert all(s <= x.start_ns <= x.end_ns <= e for x in inside)
    assert sorted(rec.intervals()) == sorted(
        (s.start_ns, s.end_ns, s.name) for s in spans)


def test_counters_equal_a_direct_count(family):
    tr, run = _epoch(family)
    with profiling.recording() as rec:
        run()
    hosts = [tr.host_batch(mb) for mb in family['data']]
    sizes = [len(f) for f in flushes(hosts, signature)]
    active = [np.asarray(h['plan']['active']) for h in hosts]
    assert sizes == [2, 1]
    # on the CPU every step is eager: no warm-up, capture or replay
    assert dict(rec.counters) == {
        'eager': sum(sizes), 'mols': 3 * BATCH,
        'scan.cells': sum(a.size for a in active),
        'scan.active': sum(int(a.sum()) for a in active)}
    assert rec.calls()['flush.eager'] == sizes.count(1)
    assert rec.calls()['flush.graphs'] == sum(n > 1 for n in sizes)
    assert tr.step_counts == dict(eager=3, warm_up=0, replay=0, captures=0)


def test_graph_stats_carries_the_step_counts(family):
    tr, run = _epoch(family)
    run()
    run()
    assert tr.graph_stats() == dict(
        signatures=0, capture_s=0, pool_bytes=0, captures=0,
        step_kinds=dict(eager=6, warm_up=0, replay=0))


def test_recording_reads_spans_on_its_clock(monkeypatch):
    ticks = iter(range(0, 100 * 10 ** 9, 10 ** 9))
    monkeypatch.setattr(profiling, '_clock', lambda: next(ticks))
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError, match='already on'):
            with profiling.recording():
                pass
        profiling.at_step(1, 2)
        batch = object()
        profiling.tag(batch)
        profiling.at_step(1, 3)
        with profiling.named_scope('a'):          # 0 .. 5
            with profiling.named_scope('b', batch):   # 1 .. 2
                profiling.count('n', 4)
            with profiling.named_scope('c'):      # 3 .. 4
                profiling.count('n')
    assert profiling.current() is None
    assert [(s.name, s.start_ns // 10 ** 9, s.end_ns // 10 ** 9, s.parent,
             s.step) for s in rec.spans] == [
        ('a', 0, 5, -1, (1, 3)), ('b', 1, 2, 0, (1, 2)),
        ('c', 3, 4, 0, (1, 3))]
    assert rec.summary() == dict(
        seconds={'a': 5.0, 'b': 1.0, 'c': 1.0},
        self_seconds={'a': 3.0, 'b': 1.0, 'c': 1.0},
        calls={'a': 1, 'b': 1, 'c': 1}, counters={'n': 5})


def test_every_global_function_maps_to_its_kernel():
    found = {}
    for path in glob.glob(os.path.join(ROOT, 'ggpm_tpu_torch', 'csrc',
                                       '*.cu')):
        with open(path) as f:
            src = f.read()
        names = re.findall(r'__global__\s+void\s+(?:__launch_bounds__\s*'
                           r'\([^)]*\)\s+)?(\w+)\s*\(', src)
        found[os.path.basename(path)[:-3]] = names
    assert sorted(found) == sorted(KERNEL_FUNCTIONS)
    for kernel, names in found.items():
        assert names
        for name in names:
            # a device record's name: the function with its template
            # arguments and parameter types
            assert kernel_of(f'void {name}<4, 2>(float const*, int)') == \
                kernel
    assert kernel_of('void at::native::index_elementwise_kernel<128>') is None
