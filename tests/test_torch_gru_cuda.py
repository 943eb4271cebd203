"""One GRU step and one bf16 step of the port on the card against the
port on the CPU (ROADMAP A5).  Needs an NVIDIA GPU and ``nvcc``; on the
card, from the root of the repo:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gru_cuda.py

A ``prop`` model with the GRU cell and untied embeddings, and a
``prop-opt`` and a ``hier-prop`` with bf16 encoders (LSTM and GRU), at a
small width (hidden = embed = 32, latent 8, depths 3) from seeded flax
initialisers, forward and backward on the first HOPV batch of 20 (the
motif family's lane-packed) at the latent's mean.  f32: the total within
1e-5 relative of the CPU's and each gradient leaf within 1e-4 of its
largest entry (floor 1e-3 of any leaf's), as the CPU tests hold the CPU
port to JAX.  bf16: the card is no farther from the CPU port's bf16, in
the total and in each leaf's relative gradient norm (floor 1e-3 of the
largest leaf norm), than the CPU port's bf16 is from its f32, but for
the leaves whose gradient is rounding noise (``decoder/W_assm/bias``,
cancellation noise in both precisions) and the biases of the bf16 layers,
which are held to the worst leaf's distance, as ``tests/torch_a5.py``
holds the CPU port to JAX; the bf16 kernels launch (``launches_bf16``).
"""

import numpy as np
import pytest
import torch

from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import flatten, to_flax_tree
from ggpm_tpu_torch.data.batching import (compact_plan_dict,
                                          hier_train_tables, to_model_batch,
                                          train_tables)
from ggpm_tpu_torch.graph.vocab import load_vocab_file
from ggpm_tpu_torch.models.vae import (HierPropertyVAE, ModelConfig,
                                       PropertyVAE, PropOptVAE, init_params)
from ggpm_tpu_torch.ops import gather_rows, nei_sum, transpose_sum
from ggpm_tpu_torch.profile_serve import HIER_VOCAB
from ggpm_tpu_torch.train.loop import to_device

pytestmark = pytest.mark.cuda
SMALL = dict(embed_size=32, hidden_size=32, latent_size=8, depthT=3,
             depthG=3, diterG=2, linear_hidden_size=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run on the card (see the module '
                    'docstring)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _batch(hier):
    vocab = load_vocab_file(HIER_VOCAB if hier else profile_train.VOCAB)
    _, mbs = profile_train.hopv_batches(1, vocab)
    b = to_model_batch(mbs[0], vocab.mask, pad=False)
    if hier:
        return vocab, hier_train_tables(b)
    b = dict(b, plan=compact_plan_dict({k: np.asarray(v)
                                        for k, v in b['plan'].items()}))
    return vocab, train_tables(b)


def _step(cls, vocab, batch, device, **kw):
    hv, iv = vocab.size()
    model = init_params(cls(ModelConfig(hvocab_size=hv, ivocab_size=iv,
                                        **SMALL, **kw)),
                        torch.Generator().manual_seed(0)).to(device)
    total, _, _ = model(to_device(batch, device), 0.1, perturb_z=False)
    total.backward()
    return total.item(), {k: v for k, v in flatten(to_flax_tree(
        model, lambda p: p.grad)).items()}


def _rel(a, b, ref):
    top = max(np.linalg.norm(v) for v in ref.values())
    return {k: np.linalg.norm(a[k] - b[k]) / max(np.linalg.norm(ref[k]),
                                                 1e-3 * top) for k in ref}


def test_gru_step_matches_the_cpu(cuda):
    vocab, batch = _batch(False)
    kw = dict(rnn_type='GRU', tie_embedding=False)
    launches = gather_rows.launches
    loss, grads = _step(PropertyVAE, vocab, batch, cuda, **kw)
    assert gather_rows.launches - launches == SMALL['depthT']
    cpu_loss, cpu_grads = _step(PropertyVAE, vocab, batch, 'cpu', **kw)
    np.testing.assert_allclose(loss, cpu_loss, rtol=1e-5)
    top = max(np.abs(v).max() for v in cpu_grads.values())
    for k, v in cpu_grads.items():
        np.testing.assert_allclose(grads[k], v, rtol=0, atol=1e-4 * max(
            np.abs(v).max(), 1e-3 * top), err_msg=k)


@pytest.mark.parametrize('case', [('prop-opt', {}), ('prop-opt', dict(
    rnn_type='GRU')), ('hier-prop', dict(rnn_type='GRU',
                                         tie_embedding=False))],
    ids=['prop-opt-LSTM', 'prop-opt-GRU', 'hier-prop-GRU-untied'])
def test_bf16_step_matches_the_cpu(cuda, case):
    name, kw = case
    hier = name == 'hier-prop'
    cls = HierPropertyVAE if hier else PropOptVAE
    vocab, batch = _batch(hier)
    before = [w.launches_bf16 for w in (nei_sum, transpose_sum, gather_rows)]
    loss, grads = _step(cls, vocab, batch, cuda, compute_dtype='bf16', **kw)
    after = [w.launches_bf16 for w in (nei_sum, transpose_sum, gather_rows)]
    depth = (SMALL['depthG'] + 2 * SMALL['depthT'] if hier
             else SMALL['depthT'])
    # the node readouts (three levels, or one) and their backward where the
    # loss reads them (the atom and attachment levels' in the hier model)
    assert [a - b for a, b in zip(after, before)] == \
        [3 if hier else 1, depth + (2 if hier else 0), depth]
    cpu_loss, cpu_grads = _step(cls, vocab, batch, 'cpu',
                                compute_dtype='bf16', **kw)
    f32_loss, f32_grads = _step(cls, vocab, batch, 'cpu', **kw)
    assert abs(loss - cpu_loss) <= abs(cpu_loss - f32_loss)
    ours, bound = _rel(grads, cpu_grads, cpu_grads), _rel(cpu_grads,
                                                          f32_grads,
                                                          f32_grads)
    worst = max(bound.values())
    own = {k: not (k.endswith('decoder/W_assm/bias') or (
        '_encoder/' in k and k.endswith('/bias'))) for k in ours}
    over = {k: (ours[k], bound[k]) for k in ours
            if ours[k] > (bound[k] if own[k] else worst)}
    assert not over, over
