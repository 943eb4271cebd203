"""The hier family's bf16 encoders against the JAX package's, on the CPU
(ROADMAP A5), and the training CLI with all three of A5's options.

``hier-prop`` with ``compute_dtype`` 'bf16', LSTM (tied) and GRU (untied),
is held by the bf16 rule of ``tests/torch_a5.py``: the port's bf16 total
and gradients are no farther from JAX's bf16 than JAX's bf16 is from its
f32 on the same batch (JAX's references from a process with XLA's excess
precision off, ``torch_a5.jax_references``).  The three levels' depth
loops, their node readouts (K1 in bf16) and ``W_o`` run in bf16; the
cluster sum and the root readout stay f32.  Measured (the port against
JAX's bf16, then JAX's bf16 against its f32; total, then the worst leaf):
LSTM on batch 0 0 and 1.2e-5, 0.83 % and 3.7 %; GRU + untied on batch 1
1.2e-7 and 4.6e-5, 0.93 % and 7.0 %, the latent sampled with JAX's
noise.  Small width: hidden = embed = 32, latent 8, depthT = depthG = 3,
diterT 1, diterG 2, batches of 6 HOPV molecules.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16_hier.py

rewrites ``ggpm_tpu_torch/goldens/train_hier_gru_bf16_hopv.json``
(chip_smoke.py phase 14's hier steps) from the JAX package on the CPU, in a
process with XLA's excess precision off.
"""

import json
import os

import pytest
import torch

from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import to_flax_tree
from ggpm_tpu_torch.profile_serve import HIER_VOCAB
from torch_a5 import (ROOT, STRICT_BF16, bf16_references, case_ids,
                      check_bf16, hier_data, jax_train_steps,
                      strict_bf16_process, write_golden)

CASES = [('hier-prop', {}, 0, True),
         ('hier-prop', dict(rnn_type='GRU', tie_embedding=False), 1, True)]


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def references(tmp_path_factory):
    return bf16_references(hier_data(), CASES,
                           str(tmp_path_factory.mktemp('bf16h')))


@pytest.mark.parametrize('case', range(len(CASES)), ids=case_ids(CASES))
def test_bf16_hier_model_meets_the_rule(references, case):
    check_bf16(hier_data(), CASES[case], references[case])


# -- the phase-14 golden ------------------------------------------------------

GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'train_hier_gru_bf16_hopv.json')


def jax_reference():
    """The JAX package's first 3 steps of ``profile_train.hier_a5_model``
    (``hier-prop`` with GRU, untied embeddings and bf16 at the trained hier
    model's configuration, ``init_params`` seeded with ``A5_SEED``), and
    the same steps in f32: the bf16 rule's bound.  In a process with XLA's
    excess precision off."""
    model, _ = profile_train.hier_a5_model()
    params = to_flax_tree(model)
    cfg = dict(profile_train.HIER_A5_CONFIG)
    out = dict(model='hier-prop', config=cfg,
               init='ggpm_tpu_torch.models.vae.init_params',
               seed=profile_train.A5_SEED,
               vocab='runs/QUALITY_hier_hopv.json.vocab.txt',
               data='data/hopv15.csv', batch_size=20,
               optimizer=profile_train.OPTIMIZER, beta=profile_train.BETA,
               xla_flags=STRICT_BF16)
    for key, dt in (('steps', 'bf16'), ('f32_steps', 'float32')):
        out[key] = jax_train_steps('hier-prop', dict(cfg, compute_dtype=dt),
                                   params, HIER_VOCAB, hier=True,
                                   finetune=False)
    return out


@pytest.mark.slow
def test_port_on_the_cpu_meets_the_hier_bf16_golden():
    """chip_smoke.py phase 14's hier steps on the CPU: the port's 3 steps
    at full width held to the golden by ``profile_train.HIER_A5_RULE``
    (``hier_rule()`` widened by the bf16 rule, the leaves' updates held at
    step 1; about 5 minutes on one thread: hence ``slow``)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    trainer, vocab = profile_train.hier_a5_trainer('cpu')
    _, batches = profile_train.hopv_batches(profile_train.GOLDEN_STEPS,
                                            vocab)
    got = profile_train.golden_steps('cpu', trainer, batches)
    assert profile_train.check_golden(got, golden, f32=golden['f32_steps'],
                                      **profile_train.HIER_A5_RULE) == []


if __name__ == '__main__':
    strict_bf16_process()
    write_golden(GOLDEN, jax_reference())
