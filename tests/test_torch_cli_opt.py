"""The port's ``optimize`` and ``reconstruct`` CLIs (``--device cpu``)
against the JAX package's encoder, ``LatentOptimizer``, heads and
``decode_best`` on six molecules of the trained HOPV model, and their
CSVs against what pandas writes (the JAX CLIs write with pandas; the
port, without it, with the standard library's ``csv``).  The JAX CLIs
are not called: their tests read reference data absent from the test
machines.  Predictions within 1e-5, strings equal.
"""

import csv
import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ggpm_tpu.data import batching as jax_batching
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.latent.control import LatentOptimizer as JaxLatentOptimizer
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu.models.api import encode as jax_encode
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropOptVAE as JaxPropOptVAE
from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import load_model, read_checkpoint
from ggpm_tpu_torch.cli import optimize as cli_optimize
from ggpm_tpu_torch.cli import reconstruct as cli_reconstruct
from ggpm_tpu_torch.cli.common import write_csv
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOPV = os.path.join(ROOT, 'data', 'hopv15.csv')


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def jax_fragments():
    saved = jax_mg.MolGraph.FRAGMENTS
    yield
    jax_mg.MolGraph.FRAGMENTS = saved


CKPT = profile_train.CKPT
VOCAB = profile_train.VOCAB


@pytest.fixture(scope='module')
def trained(jax_fragments):
    jvocab, _ = jax_load_vocab(VOCAB)
    hv, iv = jvocab.size()
    jmodel = JaxPropOptVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, rnn_type='LSTM', dropout=0.0))
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    rows = prune_to_vocab(read_csv_data(HOPV), vocab, verbose=False)[:6]
    return dict(jmodel=jmodel, params=read_checkpoint(CKPT), jvocab=jvocab,
                vocab=vocab, rows=rows)


def _jax_latents(t, rows):
    batch = jax.tree.map(jnp.asarray, jax_batching.to_model_batch(
        jax_mg.tensorize(rows, t['jvocab'], jax_avocab), t['jvocab'].mask,
        pad=False))
    return np.asarray(jax_encode(t['jmodel'], t['params'], batch)[0])


def _jax_predict(t, z):
    h, l = t['jmodel'].apply(t['params'], jnp.asarray(z),
                             method=lambda m, zz: m.predict_properties(zz))
    return np.asarray(h), np.asarray(l)


def _cli_config(tmp_path, rows, **kw):
    path = tmp_path / 'test.csv'
    with open(path, 'w') as f:
        f.write('SMILES,HOMO,LUMO\n')
        f.writelines(f'{s},{"" if h is None else h},{"" if l is None else l}\n'
                     for s, h, l in rows)
    cfg = dict(vocab_=VOCAB, output_model=CKPT, test_data=str(path), **kw)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    return ['--path-to-config', str(tmp_path / 'cfg.json'), '--device', 'cpu',
            '--batch-size', '3']


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _pandas_text(rows):
    """What ``pandas.DataFrame(rows).to_csv(index=False)`` writes: the
    JAX CLIs' output."""
    buf = io.StringIO()
    pd.DataFrame(rows).to_csv(buf, index=False)
    return buf.getvalue()


@pytest.mark.parametrize('policy', ['hard', 'soft'])
def test_optimize_cli_matches_jax(trained, tmp_path, monkeypatch, policy):
    """``cli/optimize --device cpu`` on six molecules in batches of 3: its
    two CSVs and its logs against the JAX package's encoder,
    ``LatentOptimizer`` and ``decode_best``, the CSVs' text what pandas
    writes.  ``hard`` at lr 20 through the exact decode; ``soft`` (the
    defaults, which stop every row at once) through the turbo decode,
    with a molecule whose HOMO label is missing (an empty cell, as
    pandas writes NaN)."""
    t = trained
    rows = [list(r) for r in t['rows']]
    if policy == 'soft':
        rows[2][1] = None
    monkeypatch.chdir(tmp_path)
    kw = dict(latent_lr=20.0) if policy == 'hard' else {}
    argv = _cli_config(tmp_path, rows, output='opt.csv') + [
        '--optimize-type', policy] + (
        ['--latent-lr', '20'] if policy == 'hard' else ['--fast-decode'])
    recon_rows, prop_rows = cli_optimize.main(argv)
    recon = _read(tmp_path / 'reconstructed_molecules_after_opt.csv')
    props = _read(tmp_path / 'property_prediction_after_opt.csv')
    want_smiles, want_rows = [], []
    for i in (0, 3):
        batch = rows[i:i + 3]
        z = _jax_latents(t, batch)
        h0, l0 = _jax_predict(t, z)
        homos = np.array([np.nan if r[1] is None else r[1] for r in batch],
                         np.float32)
        lumos = np.array([r[2] for r in batch], np.float32)
        z_opt = np.asarray(JaxLatentOptimizer(
            t['jmodel'], t['params'], optimize_type=policy, **kw).optimize(
            jnp.asarray(z), homos, lumos))
        h1, l1 = _jax_predict(t, z_opt)
        _, smiles = jax_decode.decode_best(
            t['jmodel'], t['params'], t['jvocab'], jax_avocab, z_opt,
            greedy=True, max_decode_step=150)
        want_smiles += smiles
        want_rows += [dict(org_homo=a, org_lumo=b, new_homo=c, new_lumo=d,
                           target_homo=e, target_lumo=f)
                      for a, b, c, d, e, f in zip(h0, l0, h1, l1, homos, lumos)]
    assert [r['original'] for r in recon] == [r[0] for r in rows]
    assert [r['reconstructed'] for r in recon] == want_smiles
    assert list(props[0]) == list(want_rows[0])
    for got, want in zip(props, want_rows):
        for k, v in want.items():
            if np.isnan(v):
                assert got[k] == ''
            else:
                assert float(got[k]) == pytest.approx(float(v), abs=1e-5), k
    moved = [abs(float(r['new_homo']) - float(r['org_homo'])) for r in props]
    assert (max(moved) > 1e-4) == (policy == 'hard')
    if policy == 'soft':
        assert props[2]['target_homo'] == ''
    for name, rows_out in (
            ('reconstructed_molecules_after_opt.csv', recon_rows),
            ('property_prediction_after_opt.csv', prop_rows)):
        with open(tmp_path / name) as f:
            assert f.read() == _pandas_text(rows_out)
    with open(tmp_path / 'opt_logs.pkl', 'rb') as f:
        logs = pickle.load(f)
    assert len(logs) == len(rows)
    if policy == 'hard':
        assert all(logs)        # the exact decode's per-step logs


def test_reconstruct_cli_matches_jax(trained, tmp_path):
    """``cli/reconstruct --device cpu --model-type prop-opt``: the CSV
    against the JAX encoder, heads and decode, its text what pandas
    writes."""
    t = trained
    out = str(tmp_path / 'rec.csv')
    rows = cli_reconstruct.main(_cli_config(tmp_path, t['rows'], output=out) + [
        '--model-type', 'prop-opt', '--fast-decode'])
    z = _jax_latents(t, t['rows'])
    h, l = _jax_predict(t, z)
    _, smiles = jax_decode.decode_best(t['jmodel'], t['params'], t['jvocab'],
                                       jax_avocab, z, greedy=True,
                                       max_decode_step=150)
    got = _read(out)
    assert [r['original'] for r in got] == [r[0] for r in t['rows']]
    assert [r['reconstructed'] for r in got] == smiles
    np.testing.assert_allclose([float(r['HOMO']) for r in got], h, atol=1e-5)
    np.testing.assert_allclose([float(r['LUMO']) for r in got], l, atol=1e-5)
    assert len(rows) == len(t['rows'])
    with open(out) as f:
        assert f.read() == _pandas_text(rows)
    assert os.path.exists(str(tmp_path / 'rec_logs.pkl'))


def test_write_csv_is_what_pandas_writes(tmp_path):
    rows = [{'a': 'C,C', 'b': 0.1, 'c': None, 'd': float('nan'), 'e': 1e-05},
            {'a': 'x"y', 'b': -2.0, 'c': None, 'd': 3.25, 'e': 123456789.5}]
    write_csv(str(tmp_path / 'x.csv'), rows)
    buf = io.StringIO()
    pd.DataFrame(rows).to_csv(buf, index=False)
    with open(tmp_path / 'x.csv') as f:
        assert f.read() == buf.getvalue()
