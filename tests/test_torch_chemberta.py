"""The port's ChemBERTa baseline against the JAX package's, on the CPU.

Small width (2 layers, hidden 32, 4 heads, MLP 64, max_len 128, head (16,),
dropout 0) on ``data/hopv15.csv`` with the same params in both packages
(flax's init, bridged).  Tolerances: the eval forward within 1e-5; the
loss and metrics within 1e-5 relative; each gradient leaf within 1e-4 of
its largest entry, or of 1e-3 of the largest entry of any leaf for the
attention keys' biases, whose exact gradient is zero; each leaf's update
of a 3-step trajectory (clipped at 1.0, continuous decay) within 1e-3
relative over its entries whose gradient is not rounding noise.  The
default width's three golden steps (``profile_chemberta``) are held to
``goldens/chemberta_hopv.json`` by its rule.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_chemberta.py

rewrites ``ggpm_tpu_torch/goldens/chemberta_hopv.json`` from the JAX
package (the default width, three steps at dropout 0 from the port's
seeded init; about a minute).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ggpm_tpu.models import chemberta as J
from ggpm_tpu_torch import profile_chemberta, profile_train
from ggpm_tpu_torch.bridge import (chemberta_from_flax, chemberta_to_flax,
                                   flatten, msgpack_serialize)
from ggpm_tpu_torch.cli import chemberta_pr2_fine_tune as cli
from ggpm_tpu_torch.data.dataset import read_csv_data
from ggpm_tpu_torch.models import chemberta as P
from ggpm_tpu_torch.train.profiling import Throughput

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'data', 'hopv15.csv')
SMALL = dict(hidden=32, heads=4, layers=2, mlp_dim=64, max_len=128,
             head_hidden=(16,), dropout=0.0)
BATCH = 8
FWD_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-3


@pytest.fixture(scope='module')
def setup():
    """Both tokenizers over the HOPV SMILES, the small JAX model and its
    params (flax's init), and four batches of 8."""
    rows = read_csv_data(DATA)
    jtok = J.SmilesTokenizer.build([r[0] for r in rows])
    tok = P.SmilesTokenizer.build([r[0] for r in rows])
    jmodel = J.ChemBertaForPR2(vocab_size=jtok.vocab_size, **SMALL)
    bs = P.batches(rows[:4 * BATCH], tok, BATCH, SMALL['max_len'])
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda t, h, l: jmodel.init({'params': key, 'dropout': key}, t, h,
                                    l, True))(*map(jnp.asarray, bs[0])))
    return dict(rows=rows, jtok=jtok, tok=tok, jmodel=jmodel, params=params,
                batches=bs)


def _port(setup, params=None):
    model = P.ChemBertaForPR2(vocab_size=setup['tok'].vocab_size, **SMALL)
    chemberta_from_flax(model, setup['params'] if params is None else params)
    return model


def test_tokenizer_ids_match_jax(setup):
    assert setup['tok'].vocab == setup['jtok'].vocab
    assert setup['tok'].vocab_size == setup['jtok'].vocab_size
    smiles = [r[0] for r in setup['rows']]
    for max_len in (256, 32):
        ours = setup['tok'].encode_batch(smiles, max_len)
        theirs = setup['jtok'].encode_batch(smiles, max_len)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert setup['tok'].encode('[Xe]Q', 8).tolist() == \
        setup['jtok'].encode('[Xe]Q', 8).tolist()


def test_bridge_round_trip(setup):
    """flax tree -> port -> flax tree is the identity, leaf for leaf."""
    back = flatten(chemberta_to_flax(_port(setup)))
    want = flatten(setup['params'])
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


def test_eval_forward_matches_flax(setup):
    model = _port(setup).eval()
    for b in setup['batches']:
        ours = model(torch.as_tensor(b[0])).detach().numpy()
        theirs = np.asarray(setup['jmodel'].apply(setup['params'],
                                                  jnp.asarray(b[0])))
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=FWD_ATOL)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jmodel):
    def f(p, toks, homos, lumos):
        return jmodel.apply(p, toks, homos, lumos, False,
                            rngs={'dropout': jax.random.PRNGKey(0)})
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _jax_loss_and_grads(jmodel, params, b):
    (loss, metrics), grads = _jax_value_and_grad(jmodel)(
        params, *map(jnp.asarray, b))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        flatten(jax.tree.map(np.asarray, grads))


def test_loss_metrics_and_grads_match_flax(setup):
    model = _port(setup).train()
    b = setup['batches'][1]
    loss, metrics = model(*map(torch.as_tensor, b))
    loss.backward()
    loss = loss.detach()
    jloss, jmet, jgrads = _jax_loss_and_grads(setup['jmodel'],
                                              setup['params'], b)
    assert float(loss) == pytest.approx(jloss, rel=LOSS_RTOL)
    assert set(metrics) == set(jmet)
    for k, v in jmet.items():
        assert metrics[k].item() == pytest.approx(v, rel=LOSS_RTOL), k
    grads = flatten(chemberta_to_flax(model, lambda p: p.grad))
    assert set(grads) == set(jgrads)
    # the key's bias has no gradient (the softmax cancels it): its entries
    # are rounding noise, held to 1e-3 of the largest entry of any leaf
    top = max(np.abs(v).max() for v in jgrads.values())
    for k, v in jgrads.items():
        np.testing.assert_allclose(
            grads[k], v, rtol=0, err_msg=k,
            atol=GRAD_RTOL * max(np.abs(v).max(), 1e-3 * top))


@pytest.mark.parametrize('count', [0, 1, 2, 3, 7])
def test_continuous_decay_matches_optax(count):
    sched = optax.exponential_decay(1e-3, 3, 0.5)
    opt = P.optimizer(1e-3, 0.5, 3)
    assert opt.schedule(count) == pytest.approx(float(sched(count)),
                                                rel=1e-7)
    st = opt.attach([torch.nn.Parameter(torch.zeros(2))])
    assert float(st.schedule_t(torch.tensor(count))) == pytest.approx(
        float(sched(count)), rel=1e-7)


def test_three_step_trajectory_matches_optax(setup):
    """Three steps of ``train_chemberta``'s optimizer (clip 1.0, Adam on
    the continuous decay over 2 steps an epoch, lr 1e-3) against the JAX
    package's optax chain."""
    jmodel, bs = setup['jmodel'], setup['batches'][:3]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
        optax.exponential_decay(1e-3, 2, 0.9)))
    p = jax.tree.map(jnp.asarray, setup['params'])
    st = tx.init(p)
    model = _port(setup).train()
    state = P.optimizer(1e-3, 0.9, 2).attach(list(model.parameters()))
    noise = None
    for b in bs:
        jbefore = flatten(jax.tree.map(np.array, p))
        _, _, jgrads = _jax_loss_and_grads(jmodel, p, b)
        upd, st = tx.update(jax.tree.map(jnp.asarray, _unflat(jgrads)), st, p)
        p = optax.apply_updates(p, upd)
        jafter = flatten(jax.tree.map(np.array, p))
        before = flatten(chemberta_to_flax(model))
        for q in state.params:
            q.grad = None
        loss, _ = model(*map(torch.as_tensor, b))
        loss.backward()
        gnorm = float(state.step())
        assert gnorm > 1.0         # every step clips
        grads = flatten(chemberta_to_flax(model, lambda q: q.grad))
        total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                            for v in grads.values()))
        noise = {k: (np.abs(v) < 1e-6 * total) | (
            noise[k] if noise else False) for k, v in grads.items()}
        after = flatten(chemberta_to_flax(model))
        for k in jbefore:
            d = jafter[k].astype(np.float64) - jbefore[k]
            ours = after[k].astype(np.float64) - before[k]
            keep = ~noise[k]
            assert np.linalg.norm(ours[keep] - d[keep]) <= \
                UPDATE_RTOL * np.linalg.norm(d[keep]), k


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *mods, leaf = path.split('/')
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_checkpoints_cross_read(setup, tmp_path, writer):
    """Each package loads the other's ``save_chemberta`` through
    ``load_pretrained_backbone``: every leaf, equal."""
    rng = np.random.default_rng(1)
    trained = jax.tree.map(lambda x: (x + rng.normal(0, 0.1, x.shape))
                           .astype(np.float32), setup['params'])
    if writer == 'port':
        P.save_chemberta(str(tmp_path / 'chemberta'), _port(setup, trained),
                         setup['tok'])
    else:
        J.save_chemberta(str(tmp_path / 'chemberta'), trained, setup['jtok'])
    with open(tmp_path / 'chemberta.tokenizer.json') as f:
        assert json.load(f) == setup['tok'].vocab
    n_leaves = len(flatten(trained))
    jloaded, jn = J.load_pretrained_backbone(setup['params'], str(tmp_path),
                                             log=lambda *_: None)
    model, n = P.load_pretrained_backbone(_port(setup), str(tmp_path),
                                          log=lambda *_: None)
    assert jn == n == n_leaves
    ours = flatten(chemberta_to_flax(model))
    for k, v in flatten(trained).items():
        assert np.array_equal(ours[k], v), k
        assert np.array_equal(np.asarray(flatten(jloaded)[k]), v), k


def _hf_tree(params, heads):
    """An HF FlaxRoberta checkpoint's layout of ``params`` (attention
    kernels [H, H], word embeddings of another tokenizer)."""
    p = params['params']
    layers = {}
    for i in range(SMALL['layers']):
        lay = p[f'TransformerEncoderLayer_{i}']
        att = lay['MultiHeadDotProductAttention_0']
        h = lay['LayerNorm_0']['scale'].shape[0]
        sub = {name: {'kernel': att[name]['kernel'].reshape(h, h) + 1,
                      'bias': att[name]['bias'].reshape(h) + 1}
               for name in ('query', 'key', 'value')}
        layers[str(i)] = {
            'attention': {'self': sub, 'output': {
                'dense': {'kernel': att['out']['kernel'].reshape(h, h) + 1,
                          'bias': att['out']['bias'] + 1},
                'LayerNorm': {'scale': lay['LayerNorm_0']['scale'] + 1,
                              'bias': lay['LayerNorm_0']['bias'] + 1}}},
            'intermediate': {'dense': {k: v + 1 for k, v in
                                       lay['Dense_0'].items()}},
            'output': {'dense': {k: v + 1 for k, v in lay['Dense_1'].items()},
                       'LayerNorm': {'scale': lay['LayerNorm_1']['scale'] + 1,
                                     'bias': lay['LayerNorm_1']['bias'] + 1}}}
    emb = {'position_embeddings': {'embedding': p['Embed_1']['embedding'] + 1},
           'word_embeddings': {'embedding': np.ones((7, h), np.float32)}}
    return {'roberta': {'embeddings': emb, 'encoder': {'layer': layers}}}


@pytest.mark.parametrize('writer', ['port', 'flax'])
def test_hf_msgpack_loads_as_in_jax(setup, tmp_path, writer):
    """A synthesized HF-layout ``flax_model.msgpack`` (written by flax or
    by the port's writer) loads into both packages alike: the encoder
    layers and position embeddings, not the word embeddings."""
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        _hf_tree(setup['params'], SMALL['heads']))
    data = (msgpack_serialize(tree) if writer == 'port'
            else serialization.msgpack_serialize(tree))
    (tmp_path / 'flax_model.msgpack').write_bytes(data)
    jloaded, jn = J.load_pretrained_backbone(setup['params'], str(tmp_path),
                                             log=lambda *_: None)
    model, n = P.load_pretrained_backbone(_port(setup), str(tmp_path),
                                          log=lambda *_: None)
    assert n == jn == 16 * SMALL['layers'] + 1
    ours = flatten(chemberta_to_flax(model))
    for k, v in flatten(jax.tree.map(np.asarray, jloaded)).items():
        assert np.array_equal(ours[k], v), k
    assert np.array_equal(ours['params/Embed_0/embedding'],
                          setup['params']['params']['Embed_0']['embedding'])


def test_unpickler_refuses_other_globals(tmp_path):
    import pickle
    path = tmp_path / 'chemberta.params.pkl'
    path.write_bytes(pickle.dumps({'params': {'x': Throughput}}))
    with pytest.raises(pickle.UnpicklingError, match='may not name'):
        P.read_params_pickle(str(path))


def test_dropout_draws_from_the_generator(setup):
    """At dropout 0.1 in training mode the same generator seed gives the
    same loss, another seed another; eval mode has no dropout."""
    kw = dict(SMALL, dropout=0.1)
    model = P.ChemBertaForPR2(vocab_size=setup['tok'].vocab_size, **kw)
    chemberta_from_flax(model, setup['params'])
    b = [torch.as_tensor(x) for x in setup['batches'][0]]
    model.train()
    losses = [float(model(*b, generator=torch.Generator().manual_seed(s))[0])
              for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]
    model.eval()
    assert float(model(*b)[0]) == pytest.approx(
        float(_port(setup).eval()(*b)[0]), abs=0)


def test_cli_runs_end_to_end(setup, tmp_path, monkeypatch):
    """``chemberta_pr2_fine_tune`` on a tiny config (the small width):
    two epochs with validation and early stopping, the best weights
    restored and saved in the JAX package's format, which loads back into
    a fresh model with the same predictions."""
    rows = setup['rows']
    for name, part in (('train.csv', rows[:32]), ('val.csv', rows[32:48])):
        with open(tmp_path / name, 'w') as f:
            f.write('SMILES,HOMO,LUMO\n')
            f.writelines(f'{s},{h},{l}\n' for s, h, l in part)
    cfg = dict(data=str(tmp_path / 'train.csv'),
               val_data=str(tmp_path / 'val.csv'), lr=1e-3,
               early_stop_patience=5, save_dir=str(tmp_path / 'out'))
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    widths = {k: v for k, v in SMALL.items() if k != 'max_len'}
    monkeypatch.setattr(cli, 'train_chemberta', functools.partial(
        P.train_chemberta, model_kwargs=dict(widths, dropout=0.1),
        max_len=SMALL['max_len']))
    model, tok = cli.main(['--path-to-config', str(tmp_path / 'cfg.json'),
                           '--epochs', '2', '--batch-size', '8',
                           '--device', 'cpu'])
    assert (tmp_path / 'runs' / 'chemberta.best').exists()
    assert (tmp_path / 'out' / 'chemberta.tokenizer.json').exists()
    fresh = P.ChemBertaForPR2(vocab_size=tok.vocab_size, **SMALL)
    _, n = P.load_pretrained_backbone(fresh, str(tmp_path / 'out'),
                                      log=lambda *_: None)
    assert n == len(flatten(chemberta_to_flax(fresh)))
    b = torch.as_tensor(tok.encode_batch([r[0] for r in rows[:4]],
                                         SMALL['max_len']))
    assert torch.equal(model.eval()(b), fresh.eval()(b))


def test_throughput_counts_steps_and_molecules():
    meter = Throughput()
    for _ in range(3):
        meter.update(16)
    r = meter.rates()
    assert meter.steps == 3 and meter.mols == 48
    assert r['mols_per_sec'] == pytest.approx(16 * r['steps_per_sec'])


# -- the full-width golden that chip_smoke.py phase 16 holds the card to -----

def chemberta_reference():
    """The JAX package's first ``profile_chemberta.STEPS`` steps of its
    ``train_chemberta`` step at the default width, dropout 0, on HOPV
    batches of 16, from the port's seeded init: per step the loss and
    metrics, and per leaf the update along the (clipped) gradient, read
    from Adam's first moment, and that gradient's norm."""
    model, tok, train_b = profile_chemberta.setup('cpu')
    params = chemberta_to_flax(model)
    jmodel = J.ChemBertaForPR2(vocab_size=tok.vocab_size, dropout=0.0)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
        optax.exponential_decay(profile_chemberta.LR, len(train_b),
                                profile_chemberta.ANNEAL)))
    p = jax.tree.map(jnp.asarray, params)
    st = tx.init(p)

    @jax.jit
    def step(p, st, toks, homos, lumos):
        def loss_fn(q):
            return jmodel.apply(q, toks, homos, lumos, False,
                                rngs={'dropout': jax.random.PRNGKey(0)})
        (loss, metrics), grads = jax.value_and_grad(loss_fn,
                                                    has_aux=True)(p)
        updates, st = tx.update(grads, st, p)
        return optax.apply_updates(p, updates), st, loss, metrics

    mu_prev = {k: 0.0 for k in flatten(params)}
    steps = []
    for b in train_b[:profile_chemberta.STEPS]:
        before = flatten(jax.tree.map(np.array, p))
        p, st, loss, metrics = step(p, st, *map(jnp.asarray, b))
        after = flatten(jax.tree.map(np.array, p))
        mu = flatten(jax.tree.map(np.array, st[1][0].mu))
        grad = {k: (mu[k] - 0.9 * mu_prev[k]) / 0.1 for k in mu}
        mu_prev = mu
        steps.append(dict(
            loss=float(loss), **{k: float(v) for k, v in metrics.items()},
            update_norms=profile_train.update_norms(before, after, grad),
            grad_norms={k: float(np.linalg.norm(v)) for k, v in
                        grad.items()}))
    return dict(data='data/hopv15.csv', batch_size=profile_chemberta.BATCH,
                seed=profile_chemberta.SEED, lr=profile_chemberta.LR,
                anneal_rate=profile_chemberta.ANNEAL,
                steps_per_epoch=len(train_b), dropout=0.0, steps=steps)


@pytest.fixture(scope='module')
def golden():
    with open(profile_chemberta.GOLDEN) as f:
        return json.load(f)


def test_golden_is_the_jax_reference(golden):
    want = chemberta_reference()
    assert {k: v for k, v in golden.items() if k != 'steps'} == \
        {k: v for k, v in want.items() if k != 'steps'}
    assert profile_chemberta.check_golden(want['steps'], golden) == []


def test_port_on_the_cpu_meets_the_golden(golden):
    assert profile_chemberta.check_golden(
        profile_chemberta.golden_steps('cpu'), golden) == []


def test_golden_rule_holds_updates(golden):
    """``check_golden`` passes the golden itself and fails an update off
    by 2e-3 at step 1."""
    steps = [dict(s) for s in golden['steps']]
    assert profile_chemberta.check_golden(steps, golden) == []
    k, w = next((k, w) for k, w in sorted(
        steps[0]['update_norms'].items()) if w)
    steps[0] = dict(steps[0], update_norms=dict(steps[0]['update_norms'],
                                                **{k: w * 1.002}))
    assert profile_chemberta.check_golden(steps, golden) == [
        f'step 1 update of {k}: {w * 1.002} vs {w}']


if __name__ == '__main__':
    with open(profile_chemberta.GOLDEN, 'w') as f:
        json.dump(chemberta_reference(), f, indent=1)
        f.write('\n')
