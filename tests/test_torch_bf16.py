"""``compute_dtype`` (ROADMAP C3, closed) and the motif family's bf16
encoders against the JAX package's, on the CPU (ROADMAP A5).

``ModelConfig.from_configs`` reads ``compute_dtype``, ``remat`` and
``loop_remat``; 'bf16' and 'bfloat16' run every encoder depth loop, its
node readout and ``W_o`` in bfloat16 (JAX ``_dtype``), any other value in
f32.  ``prop`` and ``prop-opt``, LSTM and GRU, in bf16 are held by the
bf16 rule (``tests/torch_a5.py``): the port's bf16 is no farther from
JAX's bf16, in the total and in each gradient leaf's relative norm (floor
1e-3 of the largest leaf norm), than JAX's bf16 is from JAX's f32 on the
same batch, both measured here.  JAX's references come from a process
with XLA's excess precision off (``torch_a5.jax_references``).  Measured
(the port against JAX's bf16, then JAX's bf16 against its f32; total, then
the worst leaf): ``prop`` LSTM on batch 0 at the latent's mean 0 and
8.9e-6, 0.52 % and 0.88 %; ``prop`` GRU on batch 1, sampled, 0 and
8.2e-5, 0.60 % and 2.9 %; ``prop-opt`` LSTM on batch 2, sampled, 0 and
1.3e-5, 0.60 % and 2.9 %; ``prop-opt`` GRU + untied on batch 0 1.7e-7 and
2.8e-5, 0.56 % and 0.93 %.  The small width of
``tests/test_torch_propopt.py`` (hidden = embed = 32, latent 8, depthT 3).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16.py

rewrites ``ggpm_tpu_torch/goldens/train_propopt_bf16_hopv.json``
(chip_smoke.py phase 14's bf16 fine-tuning steps) from the JAX package on
the CPU, in a process with XLA's excess precision off.
"""

import json
import os

import pytest
import torch

from ggpm_tpu.models import vae as jax_vae
from ggpm_tpu_torch import profile_train
from ggpm_tpu_torch.bridge import read_checkpoint
from ggpm_tpu_torch.configs import Configs
from ggpm_tpu_torch.models.vae import (ModelConfig, PropertyVAE, PropOptVAE,
                                       compute_dtype)
from ggpm_tpu_torch.ops import graph_ops
from torch_a5 import (ROOT, STRICT_BF16, bf16_references, case_ids,
                      check_bf16, configs, device_batch, jax_train_steps,
                      motif_data, strict_bf16_process, write_golden)

# (registry name, options, batch, latent sampled) of the bf16 cases
CASES = [('prop', {}, 0, False), ('prop', dict(rnn_type='GRU'), 1, True),
         ('prop-opt', {}, 2, True),
         ('prop-opt', dict(rnn_type='GRU', tie_embedding=False), 0, False)]


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# -- C3: the config's compute_dtype ------------------------------------------

def test_from_configs_reads_compute_dtype_and_remat():
    """``from_configs`` reads the three keys JAX's ``from_configs`` reads; the
    encoders' compute type follows JAX's ``_dtype``: 'bf16' and
    'bfloat16' are bfloat16, anything else f32 (not an error)."""
    data = motif_data()
    bag = Configs(args=dict(vocab_='unused', compute_dtype='bf16',
                            remat=True, loop_remat=True, rnn_type='GRU',
                            tie_embedding=False))
    cfg = ModelConfig.from_configs(bag, data['vocab'])
    assert (cfg.compute_dtype, cfg.remat, cfg.loop_remat) == \
        ('bf16', True, True)
    assert cfg.dtype is torch.bfloat16
    assert (cfg.rnn_type, cfg.tie_embedding) == ('GRU', False)
    for name in ('bf16', 'bfloat16', 'float32', 'float16', None):
        want = jax_vae._dtype(type('C', (), {'compute_dtype': name})())
        assert (compute_dtype(name) is torch.bfloat16) == \
            (want is not None), name
    default = ModelConfig.from_configs(Configs(args={}), data['vocab'])
    assert default.dtype is None and not default.remat


def _gathered_dtypes(monkeypatch):
    seen = []
    orig = graph_ops.gather_nd

    def record(src, index):
        seen.append(src.dtype)
        return orig(src, index)
    monkeypatch.setattr(graph_ops, 'gather_nd', record)
    return seen


@pytest.mark.parametrize('name,dtype', [('bf16', torch.bfloat16),
                                        ('bfloat16', torch.bfloat16),
                                        ('float16', torch.float32)])
def test_config_dtype_reaches_the_depth_loop(name, dtype, monkeypatch):
    """A config's ``compute_dtype`` makes the encoder's depth loop gather
    tables of that type (``float16`` trains in f32, as JAX does, to the
    bit of the f32 model), and the encoder returns f32."""
    data = motif_data()
    cfg = ModelConfig.from_configs(Configs(args=dict(compute_dtype=name)),
                                   data['vocab'])
    # a fixed init: the two losses differ by a few f32 ulps, and about one
    # random init in 40 rounds them to the same float
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = PropertyVAE(cfg)
    f32 = PropertyVAE(ModelConfig.from_configs(Configs(args={}),
                                               data['vocab']))
    f32.load_state_dict(model.state_dict())
    seen = _gathered_dtypes(monkeypatch)
    db = device_batch(data, 0)
    with torch.no_grad():
        root, node = model.encoder(db['tree'])
    assert seen and set(seen) == {dtype}
    assert root.dtype == node.dtype == torch.float32
    with torch.no_grad():
        total = model(db, 0.1, perturb_z=False)[0]
        want = f32(db, 0.1, perturb_z=False)[0]
    assert (total.item() == want.item()) == (dtype is torch.float32)


@pytest.mark.parametrize('rnn_type', ['LSTM', 'GRU'])
def test_bf16_step_calls_each_kernel_per_dtype(rnn_type, monkeypatch):
    """A ``prop-opt`` training step with bf16 encoders calls the kernels'
    wrappers as chip_smoke.py phase 14 counts them (the plain versions'
    calls on the CPU, by the type of their table): ``nei_sum`` 3 (the node
    readout's in bf16, the root and frontier readouts' in f32),
    ``transpose_sum`` depthT + 2 (the depth loop's in bf16; the node
    readout's is not run, as the loss does not read the node hiddens),
    ``gather_rows`` depthT, all bf16."""
    data = motif_data()
    cfg = configs(data, rnn_type=rnn_type, compute_dtype='bf16')[0]
    calls = {k: [] for k in ('nei_sum', 'transpose_sum', 'gather_nd')}
    for name in calls:
        orig = getattr(graph_ops, name)

        def counted(*a, orig=orig, name=name):
            calls[name].append(a[0].dtype == torch.bfloat16)
            return orig(*a)
        monkeypatch.setattr(graph_ops, name, counted)
    model = PropOptVAE(cfg)
    total, _, _ = model(device_batch(data, 0), 0.1, perturb_z=False)
    total.backward()
    d = cfg.depthT
    assert {k: (len(v), sum(v)) for k, v in calls.items()} == {
        'nei_sum': (3, 1), 'transpose_sum': (d + 2, d), 'gather_nd': (d, d)}


# -- the bf16 rule ------------------------------------------------------------

@pytest.fixture(scope='module')
def references(tmp_path_factory):
    """JAX's bf16 and f32 totals and gradients of every case on batch 0
    (the latent's mean), with the params the port loads."""
    return bf16_references(motif_data(), CASES,
                           str(tmp_path_factory.mktemp('bf16')))


@pytest.mark.parametrize('case', range(len(CASES)), ids=case_ids(CASES))
def test_bf16_model_meets_the_rule(references, case):
    """The port's bf16 total and gradients against JAX's bf16 by the bf16
    rule, JAX's bf16 against its f32 giving the bound; the f32 totals
    differ, so the rule is not met by running f32."""
    check_bf16(motif_data(), CASES[case], references[case])


# -- the phase-14 golden ------------------------------------------------------

GOLDEN = os.path.join(ROOT, 'ggpm_tpu_torch', 'goldens',
                      'train_propopt_bf16_hopv.json')


def jax_reference():
    """The JAX package's first 3 fine-tuning steps of the trained prop-opt
    checkpoint with ``compute_dtype`` bf16 (``profile_train.
    finetune_trainer``'s settings), and the same steps in f32: the bf16
    rule's bound.  In a process with XLA's excess precision off."""
    params = read_checkpoint(profile_train.CKPT)
    out = dict(checkpoint='runs/QUALITY_hopv.json.ckpt',
               vocab='runs/QUALITY_hopv.json.vocab.txt',
               data='data/hopv15.csv', batch_size=20, model='prop-opt',
               config=dict(compute_dtype='bf16'), beta=profile_train.BETA,
               lrs=profile_train.FINETUNE_LRS,
               optimizer={k: v for k, v in profile_train.OPTIMIZER.items()
                          if k != 'lr'}, xla_flags=STRICT_BF16)
    for key, dt in (('steps', 'bf16'), ('f32_steps', 'float32')):
        out[key] = jax_train_steps('prop-opt', dict(compute_dtype=dt), params,
                                   profile_train.VOCAB, hier=False,
                                   finetune=True)
    return out


@pytest.mark.slow
def test_port_on_the_cpu_meets_the_bf16_golden():
    """chip_smoke.py phase 14's bf16 fine-tuning steps on the CPU: the
    port's 3 steps at full width held to the golden by the prop-opt rule
    widened by the bf16 rule (about 3 minutes on one thread: hence
    ``slow``)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    trainer, vocab = profile_train.finetune_trainer('cpu', 'bf16')
    _, batches = profile_train.hopv_batches(profile_train.GOLDEN_STEPS,
                                            vocab)
    got = profile_train.golden_steps('cpu', trainer, batches)
    assert profile_train.check_golden(
        got, golden, f32=golden['f32_steps'],
        later_update_rtol=profile_train.FINETUNE_LATER_UPDATE_RTOL) == []


if __name__ == '__main__':
    strict_bf16_process()
    write_golden(GOLDEN, jax_reference())
