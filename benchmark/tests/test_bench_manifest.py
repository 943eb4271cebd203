"""``BENCHMARK.json`` keeps to the benchmark's contract: keys, names,
units and lengths, bounds and the run length; every cell,
configuration, traffic, job and metric it names resolves to a file of
its own by name; and a cell and a metric added as new files are taken
with no edit to a file that is there."""

import json
import os
import re
import shutil

import pytest

from benchmark import run

ROOT = run.ROOT
BENCH = run.load_json(ROOT, 'BENCHMARK.json')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_.\-/]{1,200}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
CHECK_S = 43200


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        '\n' not in text and '\t' not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    with open(os.path.join(ROOT, 'BENCHMARK.json'), 'rb') as f:
        assert len(f.read()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH['paths']) <= 16
    for p in BENCH['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH['command']
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        if '/' in word:
            assert not word.startswith('/') and '..' not in word
            assert any(word.startswith(p + '/') for p in BENCH['paths'])


def test_run_seconds_fit_the_check_at_24_cells():
    s = BENCH['run_seconds']
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= CHECK_S


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end',
                                     'per_layer'])
def test_names_are_unique_and_well_formed(section):
    names = [e['name'] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH['configs']) <= 24
    files = set()
    used = {w['config'] for w in BENCH['workloads']}
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert _line(c['source']) and _line(c['why'])
        assert c['file'].startswith('benchmark/') and c['file'] not in files
        files.add(c['file'])
        assert len(c['reduced']) <= 16 and all(NAME.match(k)
                                               for k in c['reduced'])
        assert c['name'] in used
        own = run.load_json(ROOT, c['file'])
        assert own['name'] == c['name'] and own['reduced'] == c['reduced']
        assert own['source'] == c['source']


def test_workloads():
    assert 1 <= len(BENCH['workloads']) <= 24
    pairs = set()
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and _line(w['why'])
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, len(BENCH['workloads']) // 4)


def test_metrics():
    e2e = {m['name'] for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(BENCH['per_layer']) <= 128
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    layers = {}
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert m['source'] in SOURCES and m['moves'] in e2e
        assert _line(m['layer'])
        layers.setdefault(m['layer'], []).append(m['name'])
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        for w in m.get('workloads', []):
            assert w in {c['name'] for c in BENCH['workloads']}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH['workloads']:
        files = run.cell_files(BENCH, w['name'])
        names = {m['name'] for m in files['end_to_end']}
        assert 'setup_s' in names and len(names) >= 2
        assert files['per_layer']
        for m in files['per_layer']:
            assert m['moves'] in names


def test_everything_resolves_by_name():
    for w in BENCH['workloads']:
        files = run.cell_files(BENCH, w['name'])
        assert files['workload']['name'] == w['name']
        assert files['config']['name'] == w['config']
        assert files['traffic']['name'] == w['traffic']
        assert callable(run.job(files['workload']['job']))
        assert set(files['workload']['limits']) == {
            'loss1_gap', 'grad_gap', 'update_median_gap', 'later_loss_gap',
            'later_grad_gap', 'later_update_gap'}
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert callable(run.reader(m['name']))
    assert os.path.isfile(os.path.join(ROOT, BENCH['command'][1]))


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A cell and a metric come as files and entries of the manifest:
    the harness finds them by name, and no existing file changes."""
    here = tmp_path / 'benchmark'
    shutil.copytree(run.HERE, here,
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in here.rglob('*') if p.is_file()}
    (here / 'workloads' / 'new-cell.json').write_text(json.dumps(
        {'name': 'new-cell', 'job': 'train', 'limits': {'loss1_gap': 1e-3}}))
    (here / 'metrics' / 'epochs_run.n.py').write_text(
        'def read(rec):\n    return rec.get("epochs")\n')
    bench = json.loads(json.dumps(BENCH))
    bench['workloads'].append({'name': 'new-cell',
                               'config': 'ggpm-motif-prop',
                               'traffic': 'hopv-epochs', 'chips': 1,
                               'why': 'a new cell'})
    bench['per_layer'].append({'name': 'epochs_run.n', 'unit': 'epochs',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'Training driver',
                               'moves': 'setup_s',
                               'workloads': ['new-cell']})
    files = run.cell_files(bench, 'new-cell', str(here))
    assert files['workload']['limits'] == {'loss1_gap': 1e-3}
    assert [m['name'] for m in files['per_layer']] == ['epochs_run.n']
    assert run.reader('epochs_run.n', str(here))({'epochs': 4}) == 4
    assert all(p.read_bytes() == b for p, b in before.items())
