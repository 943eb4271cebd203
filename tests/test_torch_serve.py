"""The port's GgpmServer on the CPU against the JAX package's encode and
property heads, called directly (the JAX GgpmServer's own tests depend on a
fixture whose data are not in the repo, so it is no oracle), its HTTP
surface against the JAX server's, and the JAX reference numbers that
chip_smoke.py holds the card's answers to.  The decoding endpoints are held
to the JAX package in tests/test_torch_decode.py, the search behind
``/optimize`` in tests/test_torch_latent.py."""

import importlib.util
import json
import os
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.cli.common import read_csv_data as jax_read_csv
from ggpm_tpu.data.batching import to_model_batch as jax_to_model_batch
from ggpm_tpu.data.dataset import prune_to_vocab as jax_prune
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab
from ggpm_tpu.graph import mol_graph as jax_mg
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.latent.control import LatentOptimizer as JaxLatentOptimizer
from ggpm_tpu.models.api import encode as jax_encode
from ggpm_tpu.models.decode import decode_best as jax_decode_best
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig
from ggpm_tpu.models.vae import PropOptVAE as JaxPropOptVAE
from ggpm_tpu_torch.bridge import load_model, read_checkpoint
from ggpm_tpu_torch.data.batching import to_model_batch
from ggpm_tpu_torch.data.dataset import prune_to_vocab, read_csv_data
from ggpm_tpu_torch.graph.mol_graph import tensorize
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models.api import encode
from ggpm_tpu_torch.serve import GgpmServer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.ckpt')
VOCAB = os.path.join(ROOT, 'runs', 'QUALITY_hopv.json.vocab.txt')
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
ATOL = 1e-4   # full width, 20 LSTM rounds in another summation order


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jax_side():
    """The JAX model, params and vocab (its vocab loader sets the class-level
    fragment set, restored after the module)."""
    saved = jax_mg.MolGraph.FRAGMENTS
    vocab, _ = jax_load_vocab(VOCAB)
    hv, iv = vocab.size()
    model = JaxPropOptVAE(cfg=JaxModelConfig(
        hvocab_size=hv, ivocab_size=iv, rnn_type='LSTM', hidden_size=250,
        embed_size=250, latent_size=24, linear_hidden_size=128, depthT=20,
        dropout=0.0))
    yield dict(model=model, params=read_checkpoint(CKPT), vocab=vocab)
    jax_mg.MolGraph.FRAGMENTS = saved


def _jax_predict(side, rows):
    mb = jax_mg.tensorize(rows, side['vocab'], jax_avocab)
    batch = jax.tree.map(jnp.asarray, jax_to_model_batch(
        mb, side['vocab'].mask, pad=False))
    z, _ = jax_encode(side['model'], side['params'], batch)
    h, l = side['model'].apply(side['params'], z,
                               method=lambda m, zz: m.predict_properties(zz))
    return np.asarray(z), np.asarray(h), np.asarray(l)


@pytest.fixture(scope='module')
def server():
    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    srv = GgpmServer(model, vocab, device='cpu')
    httpd = srv.start(port=0)
    yield dict(port=httpd.server_address[1], vocab=vocab, httpd=httpd)
    srv.stop()
    assert srv._thread is None


def _call(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}', data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(server):
    code, out = _call(server['port'], '/health')
    assert code == 200
    assert out == {'status': 'ok', 'model': 'PropOptVAE', 'vocab': [91, 380]}


def test_encode_and_properties_match_jax(server, jax_side):
    rows = read_csv_data(DATA)[:4]
    smiles = [r[0] for r in rows]
    z, homo, lumo = _jax_predict(jax_side, [[s, None, None] for s in smiles])
    code, enc = _call(server['port'], '/encode', {'smiles': smiles})
    assert code == 200
    np.testing.assert_allclose(enc['latents'], z, rtol=0, atol=ATOL)
    code, props = _call(server['port'], '/properties', {'smiles': smiles})
    assert code == 200
    np.testing.assert_allclose(props['homo'], homo, rtol=0, atol=ATOL)
    np.testing.assert_allclose(props['lumo'], lumo, rtol=0, atol=ATOL)


def test_optimize_endpoint_matches_jax(server, jax_side):
    """``/optimize`` with the policy left to its default (hard, the JAX
    server's): the JAX encoder's latents searched by the JAX
    ``LatentOptimizer``, the predictions there and ``decode_best``'s
    strings (the JAX server's steps, called directly)."""
    rows = read_csv_data(DATA)[:3]
    smiles = [r[0] for r in rows]
    homo = [r[1] + 0.01 for r in rows]
    lumo = [r[2] - 0.01 for r in rows]
    z, _, _ = _jax_predict(jax_side, [[s, None, None] for s in smiles])
    opt = JaxLatentOptimizer(jax_side['model'], jax_side['params'],
                             optimize_type='hard')
    z_opt = opt.optimize(jnp.asarray(z), np.asarray(homo, np.float32),
                         np.asarray(lumo, np.float32))
    h, l = jax_side['model'].apply(
        jax_side['params'], z_opt,
        method=lambda m, zz: m.predict_properties(zz))
    _, want = jax_decode_best(jax_side['model'], jax_side['params'],
                              jax_side['vocab'], jax_avocab,
                              np.asarray(z_opt), greedy=True,
                              max_decode_step=150, log_steps=False)
    code, out = _call(server['port'], '/optimize',
                      {'smiles': smiles, 'homo': homo, 'lumo': lumo})
    assert code == 200 and set(out) == {'smiles', 'homo', 'lumo'}
    assert out['smiles'] == want
    np.testing.assert_allclose(out['homo'], np.asarray(h), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out['lumo'], np.asarray(l), rtol=0, atol=1e-5)
    assert not np.allclose(np.asarray(z_opt), z, rtol=0, atol=1e-4)


@pytest.mark.parametrize('payload,error', [
    ({'smiles': ['CCO'], 'lumo': [0.0]}, "'homo'"),
    ({'smiles': ['CCO'], 'homo': [0.0], 'lumo': [0.0], 'policy': 'bogus'},
     'Error: property-optimizing choice "bogus" is not valid')])
def test_optimize_errors_answer_500(server, payload, error):
    """A body without ``homo`` and an unknown policy: 500 with the
    exception's text, as the JAX server replies; it keeps serving."""
    code, out = _call(server['port'], '/optimize', payload)
    assert code == 500 and out == {'error': error}
    assert _call(server['port'], '/health')[0] == 200


def test_start_returns_the_server_on_all_interfaces(server):
    """The reference's surface: ``start`` binds 0.0.0.0 and returns the
    ThreadingHTTPServer."""
    httpd = server['httpd']
    assert isinstance(httpd, ThreadingHTTPServer)
    assert httpd.server_address[0] == '0.0.0.0'
    assert httpd.server_address[1] == server['port'] > 0


@pytest.mark.parametrize('path', ['/encode', '/properties', '/reconstruct'])
def test_error_body_is_the_reference_text(server, path):
    """A body with no ``smiles`` key: the reference replies
    ``{'error': str(e)}`` for the KeyError, and so does the port."""
    code, out = _call(server['port'], path, {})
    assert code == 500 and out == {'error': "'smiles'"}


@pytest.mark.parametrize('path,payload,expect', [
    ('/nowhere', {}, 404), ('/encode', {}, 500),
    ('/encode', {'smiles': ['not a smiles']}, 500)])
def test_bad_requests(server, path, payload, expect):
    code, out = _call(server['port'], path, payload)
    assert code == expect and 'error' in out
    assert _call(server['port'], '/health')[0] == 200   # still serving


def test_chip_smoke_reference_mae(jax_side):
    """chip_smoke.py's JAX_MAE: the JAX package's HOMO/LUMO MAE on the first
    64 in-vocab HOPV molecules; the port on the CPU gives the same."""
    cs = _chip_smoke()
    rows = jax_prune(jax_read_csv(DATA), jax_side['vocab'],
                     verbose=False)[:cs.N_MOLS]
    _, homo, lumo = _jax_predict(jax_side, rows)
    labels = np.array([[r[1], r[2]] for r in rows])
    jax_mae = {'homo': np.abs(homo - labels[:, 0]).mean(),
               'lumo': np.abs(lumo - labels[:, 1]).mean()}
    for key in ('homo', 'lumo'):
        assert abs(jax_mae[key] - cs.JAX_MAE[key]) < 1e-6

    model, vocab = load_model(CKPT, VOCAB, device='cpu')
    ours = prune_to_vocab(read_csv_data(DATA), vocab, verbose=False)[:cs.N_MOLS]
    assert ours == rows
    z, _ = encode(model, to_model_batch(
        tensorize(ours, vocab, common_atom_vocab), vocab.mask, pad=False))
    with torch.no_grad():
        h, l = model.predict_properties(z)
    assert abs(np.abs(h.numpy() - labels[:, 0]).mean() - jax_mae['homo']) \
        < cs.MAE_TOL
    assert abs(np.abs(l.numpy() - labels[:, 1]).mean() - jax_mae['lumo']) \
        < cs.MAE_TOL
