"""The hier family with the GRU cell against the JAX package's, on the CPU
(ROADMAP A5): ``hier-prop`` and ``hier-prop-opt`` trained with
``rnn_type`` GRU, a ``hier-prop`` with GRU and the attention heads, and
the exact and turbo hier decodes of a GRU model with untied embeddings.

Small width (hidden = embed = 32, latent 8, depthT = depthG = 3, diterT 1,
diterG 2, dropout 0) over the trained hier vocab, on padded, unpacked
batches of 6 HOPV molecules, the latent sampled with JAX's noise,
injected.  The f32 rule of ``tests/torch_a5.py``: losses within 1e-5
relative, each gradient leaf within 1e-4 of its largest entry (floor 1e-3
of any leaf's); ``decoder/W_assm/bias``, whose exact gradient is zero,
below 1e-6 of the largest gradient entry in both packages.  The decodes:
8 prior latents, greedy, 20 steps, strings equal and per-step logs within
1e-5 (``tests/test_torch_hier.py:close_logs``).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab
from ggpm_tpu.models import decode as jax_decode
from ggpm_tpu_torch.graph.vocab import common_atom_vocab
from ggpm_tpu_torch.models import decode
from ggpm_tpu_torch.ops import graph_ops
from test_torch_hier import close_logs
from torch_a5 import (CLASSES, ROOT, check_f32, configs, device_batch,
                      hier_data, port_model, small_params)

GRU_UNTIED = dict(rnn_type='GRU', tie_embedding=False)
MAX_STEP = 20


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize('name', ['hier-prop', 'hier-prop-opt'])
def test_gru_hier_model_matches_jax(name):
    """The three encoder levels and the decoder's three levels with one
    state each: the total, every metric and every gradient leaf."""
    check_f32(name, hier_data(), rnn_type='GRU')


def test_gru_hier_with_attention_matches_jax():
    """``hier-prop`` with the GRU cell and the attention heads: the
    motif- and atom-level memories feed the decoder's heads."""
    check_f32('hier-prop', hier_data(), i=1, seed=2, rnn_type='GRU',
              use_attention=True)


@pytest.fixture(scope='module')
def gru_hier():
    data = hier_data()
    cfg, jcfg = configs(data, **GRU_UNTIED)
    params = small_params(CLASSES['hier-prop'][0], cfg, 3)
    return dict(data=data, params=params,
                jmodel=CLASSES['hier-prop'][1](cfg=jcfg),
                model=port_model(CLASSES['hier-prop'][0], cfg,
                                 params).eval(),
                z=np.random.default_rng(5).normal(
                    size=(8, cfg.latent_size)).astype(np.float32))


def test_gru_untied_decode_hier_matches_jax(gru_hier):
    """The exact ``decode_hier`` of a GRU model with untied embeddings:
    strings and per-step logs (every step reads the decoder's own
    tables)."""
    s = gru_hier
    kw = dict(greedy=True, max_decode_step=MAX_STEP, log_steps=True)
    jres, jsmiles = jax_decode.decode_hier(
        s['jmodel'], s['params'], s['data']['jvocab'], jax_avocab, s['z'],
        **kw)
    res, smiles = decode.decode_hier(s['model'], s['data']['vocab'],
                                     common_atom_vocab, s['z'], **kw)
    assert smiles == jsmiles
    close_logs(res, jres)


def test_gru_untied_decode_hier_turbo_matches_jax(gru_hier):
    """The turbo ``decode_hier_turbo``, its propose carry holding one state
    a level: JAX's strings, which are the exact path's."""
    s = gru_hier
    kw = dict(greedy=True, max_decode_step=MAX_STEP)
    _, jsmiles = jax_decode.decode_hier_turbo(
        s['jmodel'], s['params'], s['data']['jvocab'], jax_avocab, s['z'],
        **kw)
    _, smiles = decode.decode_hier_turbo(s['model'], s['data']['vocab'],
                                         common_atom_vocab, s['z'], **kw)
    _, exact = decode.decode_hier(s['model'], s['data']['vocab'],
                                  common_atom_vocab, s['z'], **kw)
    assert smiles == jsmiles == exact
    carry = s['model'].decoder.propose_carry(2, 4, 3, 8, 8, 4, 4, 12, 'cpu')
    assert {'tree_h', 'inter_h', 'graph_h'} <= set(carry)
    assert not {'tree_c', 'inter_c', 'graph_c'} & set(carry)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('kw', [{}, dict(rnn_type='GRU'),
                                dict(rnn_type='GRU', tie_embedding=False,
                                     compute_dtype='bf16')],
                         ids=['LSTM', 'GRU', 'GRU-untied-bf16'])
def test_step_launches_are_chip_smokes_count(kw, monkeypatch):
    """One training step calls the kernels' wrappers as
    ``chip_smoke.hier_step_launches`` counts them for the cell (the plain
    versions' calls on the CPU), and a bf16 model's encoders call them on
    bf16 tables: the three node readouts, their backward where the loss
    reads them (the atom and attachment levels'), and the depth loops'
    gathers and their backward."""
    data = hier_data()
    cfg, _ = configs(data, **kw)
    calls = {k: [] for k in ('nei_sum', 'transpose_sum', 'gather_nd')}
    for name in calls:
        orig = getattr(graph_ops, name)

        def counted(*a, orig=orig, name=name):
            calls[name].append(a[0].dtype)
            return orig(*a)
        monkeypatch.setattr(graph_ops, name, counted)
    model = port_model(CLASSES['hier-prop'][0], cfg,
                       small_params(CLASSES['hier-prop'][0], cfg, 0))
    db = device_batch(data, 0)
    total, _, _ = model(db, 0.1, perturb_z=False)
    total.backward()
    want = _chip_smoke().hier_step_launches(cfg)(db['plan']['mess'].shape[0])
    got = {'nei_sum': len(calls['nei_sum']),
           'transpose_sum': len(calls['transpose_sum']),
           'gather_rows': len(calls['gather_nd'])}
    assert got == {k: int(v) for k, v in want.items()}
    bf16 = {k: sum(d == torch.bfloat16 for d in v) for k, v in calls.items()}
    depth = cfg.depthG + 2 * cfg.depthT
    assert bf16 == ({'nei_sum': 3, 'transpose_sum': depth + 2,
                     'gather_nd': depth} if cfg.dtype else
                    {'nei_sum': 0, 'transpose_sum': 0, 'gather_nd': 0})
