"""``vae_train`` with all three of A5's options against the JAX package,
on the CPU: one epoch of a ``hier-prop`` config with ``rnn_type`` GRU,
``tie_embedding`` false and ``compute_dtype`` bf16 trains a GRU model with
untied embeddings whose encoders run in bf16, and its first loss is JAX's
bf16 loss by the bf16 rule of ``tests/torch_a5.py`` (no farther from it
than JAX's bf16 is from JAX's f32), not the f32 one.  JAX's references come
from a process with XLA's excess precision off
(``torch_a5.jax_references``).  Small width: hidden = embed = 32, latent
8, depthT = depthG = 3, diterT 1, diterG 2, batches of 6 HOPV molecules.
"""

import json

import numpy as np
import pytest
import torch

from ggpm_tpu_torch.bridge import flatten, to_flax_tree
from ggpm_tpu_torch.cli import vae_train
from ggpm_tpu_torch.cli.common import setup_model
from ggpm_tpu_torch.configs import Configs
from ggpm_tpu_torch.models.vae import HierPropertyVAE
from ggpm_tpu_torch.profile_serve import HIER_VOCAB
from ggpm_tpu_torch.train import loop
from torch_a5 import HSMALL, configs, hier_data, jax_references

ALL_THREE = dict(rnn_type='GRU', tie_embedding=False, compute_dtype='bf16')


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cli_files(data, tmp_path):
    """A config with A5's three options over the trained hier vocab and a
    CSV of the first two batches' molecules."""
    csv_file = tmp_path / 'data.csv'
    with open(csv_file, 'w') as f:
        f.write('SMILES,HOMO,LUMO\n')
        f.writelines(f'{s},{h},{l}\n' for r in data['batch_rows'][:2]
                     for s, h, l in r)
    cfg = dict(vocab_=HIER_VOCAB, save_dir=str(tmp_path / 'out'),
               batch_size=len(data['batch_rows'][0]), epoch=1, print_iter=1,
               seed=2, dropout=0.0, **HSMALL, **ALL_THREE)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    return str(tmp_path / 'cfg.json'), str(csv_file)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """JAX's bf16 and f32 references of the CLI's first step: its initial
    params on the first batch, the latent's mean."""
    data = hier_data()
    tmp = tmp_path_factory.mktemp('cli')
    cfg_path, _ = _cli_files(data, tmp)
    model, _, _ = setup_model(Configs(path=cfg_path), 'hier-prop', seed=2)
    _, jcfg = configs(data, **ALL_THREE)
    spec = dict(name='hier-prop', params=flatten(to_flax_tree(model)),
                cfg={k: v for k, v in vars(jcfg).items()
                     if k != 'compute_dtype'},
                batch=data['jbs'][0], rng=0, perturb=False)
    ref, = jax_references([spec], str(tmp))
    return ref


def test_vae_train_cli_trains_gru_untied_bf16(reference, tmp_path,
                                              monkeypatch):
    """One epoch of ``vae_train --model-type hier-prop`` with the three
    options (the latent's mean, so that JAX's loss is comparable): the
    model is a GRU with untied embeddings whose encoders run in bf16, and
    the first step's loss is JAX's bf16 loss by the rule."""
    data = hier_data()
    cfg, csv_file = _cli_files(data, tmp_path)
    losses = []

    class Recording(loop.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, perturb_z=False, **k)

        def train_step(self, batch, *a, **k):
            metrics, aux = super().train_step(batch, *a, **k)
            losses.append(float(metrics['Loss']))
            return metrics, aux
    monkeypatch.setattr(vae_train, 'Trainer', Recording)
    model = vae_train.main(['--path-to-config', cfg, '--model-type',
                            'hier-prop', '--data-csv', csv_file, '--device',
                            'cpu'])
    assert isinstance(model, HierPropertyVAE)
    assert model.cfg.rnn_type == 'GRU' and not model.cfg.tie_embedding
    assert model.encoder.tree_encoder.rnn.dtype is torch.bfloat16
    assert hasattr(model.encoder, 'E_c_mod')
    assert len(losses) == 2 and np.isfinite(losses).all()
    jl, fl = reference['bf16'][0], reference['f32'][0]
    assert abs(losses[0] - jl) <= abs(jl - fl)
    assert abs(losses[0] - jl) < abs(losses[0] - fl)
    assert (tmp_path / 'out' / 'model.0').exists()
