"""The port's GRU cell and the motif family with it against the JAX
package's, on the CPU (ROADMAP A5).

``MPNGRUCell`` (``ggpm_tpu_torch/models/rnn.py``) is held to JAX's
(``ggpm_tpu/models/rnn.py:MPNGRUCell``) on the same flax params, as
``tests/test_rnn_equivalence.py`` holds JAX's own: the dense depth loop
(with the plain gather and with the transpose tables), the one-step
``cell`` and the split-step ``x_proj``/``k_h``/``step``, within 1e-5, and
the dense loop's parameter gradients by the f32 rule.  Then ``prop``,
``prop-opt`` and ``prop-opt-sched`` with ``rnn_type`` GRU (at
``tf_ratio`` 1.0 and 0.5 with JAX's coins) by the f32 rule of
``tests/torch_a5.py``: losses within 1e-5 relative, each gradient leaf
within 1e-4 of its largest entry (floor 1e-3 of any leaf's).  The small
width of ``tests/test_torch_propopt.py``: hidden = embed = 32, latent 8,
depthT 3, dropout 0, on lane-packed batches of 8 molecules of
``data/chem_data/train.csv``.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_gru.py

rewrites ``ggpm_tpu_torch/goldens/train_gru_hopv.json`` (chip_smoke.py
phase 14's GRU steps) from the JAX package on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.models.rnn import MPNGRUCell as JaxGRU
from ggpm_tpu.ops import build_transpose as jax_build_transpose
from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import flatten, load_flax_params, to_flax_tree
from ggpm_tpu_torch.models.rnn import MPNGRUCell, make_cell
from torch_a5 import (ROOT, assert_grads, check_f32, jax_train_steps,
                      motif_data, write_golden)

E, A, IN, H, DEPTH = 40, 4, 6, 8, 3
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def cell():
    """A JAX ``MPNGRUCell`` and its flax params (perturbed), the port's
    cell bridged from them, and inputs: messages [E, IN] and a padded
    ``bgraph`` [E, A] whose row 0 and some slots are padding, with its
    transpose."""
    rng = np.random.default_rng(0)
    bg = rng.integers(1, E, (E, A)).astype(np.int32)
    bg[rng.random(bg.shape) < 0.3] = 0
    bg[0] = 0
    fm = rng.normal(size=(E, IN)).astype(np.float32)
    fm[0] = 0
    jcell = JaxGRU(hidden_size=H, depth=DEPTH)
    params = jcell.init(jax.random.PRNGKey(0), jnp.asarray(fm),
                        jnp.asarray(bg))
    params = jax.tree.map(lambda x: np.asarray(x) + rng.normal(
        0, 0.1, x.shape).astype(np.float32), params)
    port = MPNGRUCell(IN, H, DEPTH)
    load_flax_params(port, params)
    t_idx, t_mask = jax_build_transpose(bg, E)
    return dict(jcell=jcell, params=params, port=port, fm=fm, bg=bg,
                bt=(t_idx, t_mask), rng=rng)


def test_make_cell_builds_each_type():
    assert isinstance(make_cell('GRU', IN, H, 2), MPNGRUCell)
    assert make_cell('LSTM', IN, H, 2).n_state == 2
    with pytest.raises(ValueError, match='unsupported rnn cell type'):
        make_cell('RNN', IN, H, 2)


def test_gru_tree_is_flax_tree(cell):
    """The port's parameters are the flax cell's leaves by name: ``W_z``,
    ``U_r`` and ``W_h`` with a bias, ``W_r`` without."""
    mine = flatten(to_flax_tree(cell['port']))
    theirs = flatten(cell['params'])
    assert set(mine) == set(theirs)
    assert 'params/W_r/bias' not in mine
    for k, v in theirs.items():
        assert np.array_equal(mine[k], v), k


@pytest.mark.parametrize('tables', [False, True], ids=['gather', 'gather_t'])
def test_dense_forward_and_grads_match_jax(cell, tables):
    """The depth loop's ``h`` within 1e-5, row 0 zero, and the gradient of
    ``Σ h · w`` for a fixed random ``w`` by the f32 rule, with the plain
    gather and with the transpose tables (``gather_nd_t``)."""
    w = cell['rng'].normal(size=(E, H)).astype(np.float32)
    bt = cell['bt'] if tables else None
    jbt = None if bt is None else tuple(jnp.asarray(x) for x in bt)

    def jloss(p):
        h, = cell['jcell'].apply(p, jnp.asarray(cell['fm']),
                                 jnp.asarray(cell['bg']), jbt)
        return (h * w).sum(), h
    (_, jh), jg = jax.value_and_grad(jloss, has_aux=True)(cell['params'])
    port = cell['port']
    port.zero_grad()
    tbt = None if bt is None else tuple(torch.from_numpy(x) for x in bt)
    h, = port(torch.from_numpy(cell['fm']), torch.from_numpy(cell['bg']),
              tbt)
    (h * torch.from_numpy(w)).sum().backward()
    assert not h[0].any()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=ATOL)
    assert_grads(flatten(to_flax_tree(port, lambda p: p.grad)),
                 flatten(jax.tree.map(np.asarray, jg)))


def test_cell_and_split_step_match_jax(cell):
    """The one-step ``cell`` on gathered neighbour states, and ``step``
    from ``x_proj`` and ``k_h`` (U_r's bias folded into the reset gate's x
    term), each within 1e-5 of JAX's; ``init_state`` is one buffer with
    the init rows appended."""
    rng = cell['rng']
    x = rng.normal(size=(7, IN)).astype(np.float32)
    h_nei = rng.normal(size=(7, A, H)).astype(np.float32)
    h_nei[:, -1] = 0

    def jfn(m, xx, nn):
        return (m.cell(xx, (nn,))[0],
                m.step(m.x_proj(xx), (nn,), m.k_h())[0], m.x_proj(xx))
    jc, js, jxp = cell['jcell'].apply(cell['params'], jnp.asarray(x),
                                      jnp.asarray(h_nei), method=jfn)
    port = cell['port']
    with torch.no_grad():
        tx, tn = torch.from_numpy(x), torch.from_numpy(h_nei)
        c, = port.cell(tx, (tn,))
        xp = port.x_proj(tx)
        s, = port.step(xp, (tn,), port.k_h())
    for ours, theirs in ((c, jc), (s, js), (xp, jxp)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                                   atol=ATOL)
    init = torch.randn(3, H)
    state = port.init_state(5, init_rows=init)
    assert len(state) == 1 and state[0].shape == (8, H)
    assert not state[0][:5].any() and torch.equal(state[0][5:], init)


@pytest.mark.parametrize('name', ['prop', 'prop-opt'])
def test_gru_model_matches_jax(name):
    """``prop`` and ``prop-opt`` with the GRU cell: the total, every metric
    and every gradient leaf by the f32 rule, the latent sampled with JAX's
    noise (and the breaker's, for ``prop-opt``)."""
    check_f32(name, motif_data(), rnn_type='GRU')


@pytest.mark.parametrize('tf_ratio', [1.0, 0.5])
def test_gru_scheduled_model_matches_jax(tf_ratio):
    """``prop-opt-sched`` with the GRU cell, at ``tf_ratio`` 1.0 and at 0.5
    with JAX's coins injected (the scheduled scan carries one state)."""
    check_f32('prop-opt-sched', motif_data(), i=1, tf_ratio=tf_ratio,
              rnn_type='GRU')


# -- the phase-14 golden ------------------------------------------------------

GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens', 'train_gru_hopv.json')


def jax_reference():
    """The JAX package's first 3 steps of the canonical ``prop``
    configuration with the GRU cell from ``profile_train.gru_model``'s
    params (``init_params`` seeded with ``A5_SEED``), as
    ``tests/test_torch_train.py`` computes the LSTM's."""
    model, _ = profile_train.gru_model()
    steps = jax_train_steps('prop', dict(profile_train.GRU_CONFIG),
                            to_flax_tree(model), profile_train.VOCAB,
                            hier=False, finetune=False)
    return dict(model='prop', config=profile_train.GRU_CONFIG,
                init='ggpm_tpu_torch.models.vae.init_params',
                seed=profile_train.A5_SEED,
                vocab='runs/QUALITY_hopv.json.vocab.txt',
                data='data/hopv15.csv', batch_size=20,
                optimizer=profile_train.OPTIMIZER, beta=profile_train.BETA,
                steps=steps)


@pytest.mark.slow
def test_port_on_the_cpu_meets_the_gru_golden():
    """chip_smoke.py phase 14's GRU steps on the CPU: the port's 3 steps
    at full width held to the golden by the prop rule (about 3 minutes on
    one thread: hence ``slow``)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    trainer, vocab = profile_train.gru_trainer('cpu')
    _, batches = profile_train.hopv_batches(profile_train.GOLDEN_STEPS,
                                            vocab)
    got = profile_train.golden_steps('cpu', trainer, batches)
    assert profile_train.check_golden(got, golden) == []


if __name__ == '__main__':
    write_golden(GOLDEN, jax_reference())
