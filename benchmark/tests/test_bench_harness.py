"""The harness end to end on the CPU at a small size (the cells' own
configurations and traffic, cut to batches of 4 and a data file of 12
rows, 3 batches an epoch), past its look for a card: a sound run comes
out correct, and a run whose timed path is broken underneath comes out
not correct, once for each fault a training cell can have (a step that
returns its state unchanged, from the first step or from a later one;
half of the batch left out, the mean taken over the rest).
The cells run on one card, so no exchange between cards can be left
out, and a training step produces no token or answer to alter."""

import json
import os
import shutil
import time

import pytest

from benchmark import run

CELLS = ['prop-train-hopv', 'hier-train-hopv']


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    """A copy of the benchmark's data files with each cell's batches cut
    to 4 molecules and its traffic's data file to its first 12 rows (3
    batches an epoch), and the manifest."""
    here = tmp_path_factory.mktemp('bench') / 'benchmark'
    shutil.copytree(run.HERE, here,
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = run.load_json(run.ROOT, 'BENCHMARK.json')
    for c in bench['configs']:
        p = here / 'configs' / (c['name'] + '.json')
        p.write_text(json.dumps(dict(json.loads(p.read_text()),
                                     batch_size=4)))
    for w in bench['workloads']:
        p = here / 'traffic' / (w['traffic'] + '.json')
        tr = json.loads(p.read_text())
        data = here / (w['traffic'] + '.csv')
        with open(os.path.join(run.ROOT, tr['data'])) as f:
            data.write_text(''.join(f.readlines()[:13]))
        p.write_text(json.dumps(dict(tr, data=str(data))))
    return bench, str(here)


def _run(small, cell, seed=2 ** 31 + 7):
    bench, here = small
    out = run.run_cell(bench, cell, seed, 0.0, False, 'cpu',
                       time.perf_counter(), here=here)
    return out


@pytest.mark.parametrize('cell', CELLS)
def test_a_sound_run_is_correct(small, cell):
    out = _run(small, cell)
    assert out['correct'], out['checks']
    assert list(out)[-1] == 'checks'
    assert out['attempted'] == 3 and out['failed'] == 0
    assert set(out['metrics']) == {'setup_s', 'train_mols_per_s'}
    rec = out['record']
    assert len(rec['checked_steps']) == 3
    assert len(set(rec['checked_steps'])) == 3       # rows that all differ
    # on the CPU every step is eager: the later step checked is step 2
    assert [d['step'] for d in rec['later_detail']] == [2]
    assert rec['step_kinds'][:3] == ['train_step'] * 3
    assert set(rec['span_epoch']['spans']) >= {'host_batch', 'device_batch'}


@pytest.mark.parametrize('cell', CELLS)
def test_a_step_that_leaves_its_state_unchanged_is_caught(small, cell,
                                                          monkeypatch):
    from ggpm_tpu_torch.train import optim

    def frozen(self, g=None, gnorm=None):
        return optim.global_norm(self.flat_grad() if g is None else g)
    monkeypatch.setattr(optim.AdamState, 'update', frozen)
    out = _run(small, cell)
    assert not out['correct']
    # nothing moved: the first gradient reads 0 (Adam's moment stayed 0)
    assert out['record']['numbers']['grad_gap'] == pytest.approx(1.0)
    # the median leaf's change reads 1, or its norm over the median's
    assert out['record']['numbers']['update_median_gap'] > 0.5


@pytest.mark.parametrize('cell', CELLS)
def test_a_later_step_that_leaves_its_state_unchanged_is_caught(
        small, cell, monkeypatch):
    from ggpm_tpu_torch.train import optim
    update = optim.AdamState.update

    def frozen_after_one(self, g=None, gnorm=None):
        if self.count == 0:
            return update(self, g, gnorm)
        return optim.global_norm(self.flat_grad() if g is None else g)
    monkeypatch.setattr(optim.AdamState, 'update', frozen_after_one)
    out = _run(small, cell)
    assert not out['correct']
    num = out['record']['numbers']
    # the first step is sound; step 2's moments and parameters stay put
    assert num['loss1_gap'] < 1e-5 and num['grad_gap'] < 1e-4
    assert num['later_grad_gap'] > 0.5
    assert num['later_update_gap'] == pytest.approx(1.0)


@pytest.mark.parametrize('cell', CELLS)
def test_a_step_on_half_its_batch_is_caught(small, cell, monkeypatch):
    import os
    from ggpm_tpu_torch.data.batching import pad_batch
    from ggpm_tpu_torch.graph.mol_graph import tensorize
    from ggpm_tpu_torch.graph.vocab import common_atom_vocab, load_vocab_file
    from ggpm_tpu_torch.train.loop import Trainer
    bench, here = small
    cfg = run.cell_files(bench, cell, here)['config']
    vocab = load_vocab_file(os.path.join(run.ROOT, cfg['vocab']))
    host_batch = Trainer.host_batch

    def half(self, mb):
        rows = list(zip(mb.smiles, mb.homos, mb.lumos))[:len(mb.smiles) // 2]
        return host_batch(self, pad_batch(tensorize(
            [list(r) for r in rows], vocab, common_atom_vocab)))
    monkeypatch.setattr(Trainer, 'host_batch', half)
    out = _run(small, cell)
    assert not out['correct']
    assert out['record']['numbers']['loss1_gap'] > 1e-3
