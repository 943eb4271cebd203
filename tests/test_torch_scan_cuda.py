"""``Trainer.scan_steps`` on the card: the training step replayed from
captured CUDA graphs (forward, backward and the optimizer's update, with
the ``nei_sum``, ``transpose_sum`` and ``gather_rows`` kernels inside)
against the same steps run eagerly, bit for bit, over the 17 HOPV batches
in the JAX package's order, for ``prop`` and the prop-opt fine-tuning
step, through ``scan_steps`` and through ``Trainer.train_epoch``, whose
flush of one batch is replayed too; the kernels' launches in a replayed
step, by the wrappers' counts and by the profiler's device events; the
recorder's step counts and spans over two epochs; dropout's masks under
replay; a capture that fails; and the training CLI on the card.  Needs an NVIDIA
GPU and ``nvcc``; on the card, from the root of the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_scan_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which the card's machine
does not have.)  Without a card every test skips, decided inside the
``card`` fixture, never at import.
"""

import json

import pytest
import torch

from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import load_flax_params, prop_tree, read_checkpoint
from ggpm_tpu_torch.cli import vae_train
from ggpm_tpu_torch.models.vae import ModelConfig, PropertyVAE
from ggpm_tpu_torch.train import loop, profiling
from ggpm_tpu_torch.train.loop import Trainer
from ggpm_tpu_torch.train.optim import make_optimizer

pytestmark = pytest.mark.cuda

# a step's launches of each kernel: the node, root and frontier readouts;
# their transposes and the depth loop's 20 rounds' (2 + 20); the 20 rounds
LAUNCHES = {'nei_sum': 3, 'transpose_sum': 22, 'gather_rows': 20}


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab, batches = profile_train.hopv_batches()
    return dict(vocab=vocab, batches=batches)


def _trainer(card, kind, noise=False):
    make = (profile_train.canonical_trainer if kind == 'prop'
            else profile_train.finetune_trainer)
    tr = make('cuda', card['vocab'])[0] if kind == 'prop' else make('cuda')[0]
    tr.perturb_z = noise
    return tr


def _bits(t):
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _state(tr):
    groups = getattr(tr.opt_state, 'groups', {'': tr.opt_state})
    out = {'gen': tr.gen.get_state(), 'step': tr._step_dev}
    for g, st in groups.items():
        out.update({f'{g}/flat': st.flat, f'{g}/mu': st.mu, f'{g}/nu': st.nu,
                    f'{g}/count': st.count_dev})
    return out


@pytest.mark.parametrize('kind,noise', [('prop', False), ('prop-opt', False),
                                        ('prop-opt', True)],
                         ids=['prop', 'prop-opt', 'prop-opt-noise'])
def test_graph_epochs_equal_eager_epochs(card, kind, noise):
    """Two epochs over the 17 HOPV batches from the same checkpoint, in
    the JAX order, once eager and once through graphs (the first epoch
    captures, the second only replays): every step's metrics, breaker
    flag and group norms, and the parameters, moments, counts and noise
    generator after, bit for bit.  With ``noise`` the latent noise and
    the breaker's are drawn from the trainer's generator."""
    rows, states = {}, {}
    for graph in (False, True):
        tr = _trainer(card, kind, noise)
        groups = profile_train.flush_groups(tr, card['batches'])
        rows[graph] = []
        for _ in range(2):
            profile_train.run_epoch(tr, groups, graph, rows[graph])
        states[graph] = _state(tr)
        if graph:
            # a graph per signature, that of a flush of one too
            assert len(tr.graphs) == len({loop.signature(g[0])
                                          for g in groups})
    assert len(rows[True]) == len(rows[False]) == 34
    for i, (e, g) in enumerate(zip(rows[False], rows[True])):
        assert set(e) == set(g)
        for k in e:
            if isinstance(e[k], torch.Tensor):
                assert torch.equal(_bits(e[k]), _bits(g[k])), (i, k)
            else:
                assert e[k] == g[k], (i, k)
    for k in states[False]:
        assert torch.equal(_bits(states[False][k]),
                           _bits(states[True][k])), k


def _step_rows(tr, graph):
    """Wrap ``tr``'s steps to record each step's metrics, breaker flag and
    group norms (device values) in the order the steps run: eagerly each
    ``train_step`` (which ``scan_steps`` without graphs calls too), through
    graphs each step of a ``scan_steps`` call.  Returns the list."""
    rows = []
    if graph:
        scan = tr.scan_steps

        def scanned(dbs, **kw):
            metrics, aux = scan(dbs, **kw)
            rows.extend(profile_train.step_rows(metrics, aux))
            return metrics, aux
        tr.scan_steps = scanned
    else:
        step = tr.train_step

        def stepped(db, **kw):
            metrics, aux = step(db, **kw)
            norms = getattr(tr.opt_state, 'group_norms', {})
            rows.append(dict(
                metrics,
                **({'clipped': aux['clipped']}
                   if isinstance(aux['clipped'], torch.Tensor) else {}),
                **{f'group {g}': v for g, v in norms.items()}))
            return metrics, aux
        tr.train_step = stepped
    return rows


@pytest.mark.parametrize('kind,noise', [('prop', False), ('prop-opt', False),
                                        ('prop-opt', True)],
                         ids=['prop', 'prop-opt', 'prop-opt-noise'])
def test_train_epoch_graphs_equal_eager(card, kind, noise):
    """Three epochs through ``Trainer.train_epoch`` from the same
    checkpoint, once with ``graph=False`` and once through graphs (the
    default on the card), each epoch's batch order its own: every step's
    metrics, breaker flag and group norms, and the parameters, moments,
    counts and noise generator after, bit for bit.  Through graphs no
    step is a ``train_step``: the flush of one batch is warmed up and
    captured in the first epoch and replayed in the others, as every
    other signature's."""
    batches = card['batches']
    n = len(batches)
    orders = [list(range(n)), list(reversed(range(n))),
              [(7 * i + 3) % n for i in range(n)]]
    rows, states, trainers = {}, {}, {}
    for graph in (False, True):
        tr = _trainer(card, kind, noise)
        rows[graph] = _step_rows(tr, graph)
        for e, order in enumerate(orders):
            assert not tr.train_epoch([batches[i] for i in order], epoch=e,
                                      log=lambda *_: None,
                                      graph=None if graph else False)
        torch.cuda.synchronize()
        states[graph], trainers[graph] = _state(tr), tr
    stats = trainers[True].graph_stats()
    assert stats['signatures'] == stats['captures'] == 5
    assert stats['step_kinds'] == dict(eager=0, warm_up=5,
                                       replay=3 * n - 5)
    assert trainers[False].graph_stats()['step_kinds'] == dict(
        eager=3 * n, warm_up=0, replay=0)
    assert len(rows[True]) == len(rows[False]) == 3 * n
    for i, (e, g) in enumerate(zip(rows[False], rows[True])):
        assert set(e) == set(g), i
        for k in e:
            assert torch.equal(_bits(e[k]), _bits(g[k])), (i, k)
    for k in states[False]:
        assert torch.equal(_bits(states[False][k]),
                           _bits(states[True][k])), k


def test_replayed_steps_launch_each_kernel(card):
    """A replayed step adds 3 / 22 / 20 launches of ``nei_sum`` /
    ``transpose_sum`` / ``gather_rows`` to the wrappers' counts, and as
    many of each run on the card by the kernels' own device counts, one
    profiler window a step, the flush of one's too; the profiler's records
    are at most as many (``profile_train.check_replay_windows``)."""
    tr = _trainer(card, 'prop')
    groups = profile_train.flush_groups(tr, card['batches'])
    for g in groups:
        tr.scan_steps(g)                  # captures
    windows = profile_train.replay_windows(tr, groups)
    bad, lost = profile_train.check_replay_windows(
        windows, {k: float(v) for k, v in LAUNCHES.items()})
    assert len(windows) == 17 and not bad, (bad, lost)


def test_recorded_epochs_count_steps_by_kind(card):
    """Two epochs through graphs, each with the recorder on: the first
    warms up and captures each signature, that of the flush of one batch
    too, and replays the other steps; the second replays every step and
    captures none; neither runs a step eagerly.  The recording's counters
    and spans, and ``graph_stats``, equal that count made from the
    batches' flushes, and each step's span carries its batch's (epoch,
    index)."""
    tr = _trainer(card, 'prop')
    batches = card['batches']
    hosts = [tr.host_batch(mb) for mb in batches]
    groups = list(loop.flushes(hosts, loop.signature))
    graphs = len({loop.signature(g[0]) for g in groups})
    assert graphs == 5 and [len(g) for g in groups].count(1) == 1
    want = [dict(eager=0, warm_up=graphs, replay=len(batches) - graphs,
                 captures=graphs),
            dict(eager=0, warm_up=0, replay=len(batches), captures=0)]
    orders = [list(range(len(batches))),
              list(reversed(range(len(batches))))]
    for e, (order, w) in enumerate(zip(orders, want)):
        with profiling.recording() as rec:
            tr.train_epoch([batches[i] for i in order], epoch=e,
                           log=lambda *_: None)
        torch.cuda.synchronize()
        assert {k: rec.counters.get(k, 0) for k in w} == w, e
        assert rec.counters['mols'] == profile_train.BATCH_SIZE * len(order)
        calls = rec.calls()
        assert (calls.get('warm_up', 0), calls.get('capture', 0),
                calls.get('replay', 0), calls.get('flush.eager', 0)) == \
            (w['warm_up'], w['captures'], w['replay'], w['eager']), e
        stepped = sorted(s.step for s in rec.spans
                         if s.name in ('warm_up', 'replay', 'flush.eager'))
        assert stepped == [(e, i) for i in range(len(batches))], e
        for s in rec.spans:
            if s.name in ('warm_up', 'capture', 'replay'):
                assert rec.spans[s.parent].name == 'flush.graphs'
    stats = tr.graph_stats()
    assert stats['captures'] == stats['signatures'] == graphs
    assert stats['step_kinds'] == {k: want[0][k] + want[1][k]
                                   for k in ('eager', 'warm_up', 'replay')}


def test_dropout_masks_change_between_replays(card):
    """At dropout 0.1 a replayed step draws new masks from the device's
    generator (the loss of the same batch at the same parameters differs
    between replays) and the same masks as the eager steps from the same
    seed."""
    cfg = ModelConfig(*card['vocab'].size(), dropout=0.1)
    params = prop_tree(read_checkpoint(profile_train.CKPT))
    losses = {}
    for graph in (False, True):
        model = PropertyVAE(cfg)
        load_flax_params(model, params)
        tr = Trainer(model, make_optimizer(lr=0.0), card['vocab'].mask,
                     perturb_z=False, device='cuda')
        db = tr.device_batch(tr.host_batch(card['batches'][0]))
        torch.cuda.manual_seed(7)
        metrics, _ = tr.scan_steps([db] * 4, graph=graph)
        losses[graph] = metrics['Loss']
    assert torch.equal(_bits(losses[False]), _bits(losses[True]))
    assert len(set(losses[True].tolist())) == 4


def test_training_cli_trains_through_graphs(card, tmp_path, monkeypatch):
    """``cli.vae_train`` on the card runs its flushes as graph replays,
    with no flag: one epoch of the canonical configuration from scratch
    over the HOPV CSV, whose flushes of 1, 3, 3, 5 and 5 batches have five
    signatures, each captured."""
    captured = []
    init = loop.StepGraph.__init__

    def counting(self, *a, **kw):
        init(self, *a, **kw)
        captured.append(self)
    monkeypatch.setattr(loop.StepGraph, '__init__', counting)
    cfg = dict(vocab_=profile_train.VOCAB, save_dir=str(tmp_path / 'out'),
               batch_size=20, epoch=1, print_iter=5, seed=2)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    model = vae_train.main(['--path-to-config', str(tmp_path / 'cfg.json'),
                            '--model-type', 'prop', '--data-csv',
                            profile_train.DATA])
    assert len(captured) == 5
    assert (tmp_path / 'out' / 'model.0').exists()
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_a_failed_capture_raises(card, monkeypatch):
    """A host sync inside the step makes its capture fail: ``scan_steps``
    raises after the signature's eager first step and runs none of the
    others eagerly, and leaves the device's generator and the current
    stream as they were (random draws and eager steps work after it)."""
    tr = _trainer(card, 'prop')
    forward = tr.model.forward

    def syncing(*a, **kw):
        out = forward(*a, **kw)
        out[0].item()
        return out
    monkeypatch.setattr(tr.model, 'forward', syncing)
    group = next(g for g in profile_train.flush_groups(tr, card['batches'])
                 if len(g) > 1)
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError):
        tr.scan_steps(group)
    assert tr.total_step == 1 and not tr.graphs
    assert torch.cuda.current_stream() == stream
    torch.rand(8, device='cuda')
    monkeypatch.setattr(tr.model, 'forward', forward)
    tr.scan_steps(group, graph=False)
    torch.cuda.synchronize()
