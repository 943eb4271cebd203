"""The port's data-parallel and dp×tp training against the JAX package's,
on the CPU: ranks are spawned gloo processes (``tests/torch_dp_worker.py``),
JAX's devices the 8 virtual CPU devices of ``tests/conftest.py``.

Small width (hidden = embed = 32, latent 8, depthT 3, dropout 0,
``perturb_z`` False) with the same params in both packages (a flax init
with noise on every leaf, through the bridge), on lane-packed batches of 8
molecules of ``data/chem_data/train.csv``; the hier family on unpacked
batches of 6 HOPV molecules.  The JAX functions are called directly
(``make_dp_train_step``, ``make_gspmd_train_step``, ``Trainer(mesh=...)``):
the JAX fixtures read reference data absent from the test machines.

Tolerances, as tests/test_torch_train.py: losses within 1e-5 relative and
accuracies within 1e-7; each leaf of the mean gradient within 1e-4 of its
largest entry (or of 1e-3 of the largest entry of any leaf, for a leaf
whose exact gradient is zero); each leaf's update within 1e-3 relative
over its entries whose gradient is not rounding noise.  Every rank's
parameters are equal bit for bit after every step.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_parallel.py

rewrites ``ggpm_tpu_torch/goldens/train_dp2_hopv.json`` from the JAX
package (``make_dp_train_step`` at full width on 2 virtual devices; about
2 minutes).
"""

import json
import os
import subprocess
import sys

if __name__ == '__main__':
    # the virtual devices tests/conftest.py gives the test run
    os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                               ' --xla_force_host_platform_device_count=8')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ggpm_tpu.data import batching as jax_batching  # noqa: E402
from ggpm_tpu.data.vocab_extract import load_vocab_file as jax_load_vocab  # noqa: E402
from ggpm_tpu.graph import mol_graph as jax_mg  # noqa: E402
from ggpm_tpu.graph.vocab import common_atom_vocab as jax_avocab  # noqa: E402
from ggpm_tpu.models.vae import ModelConfig as JaxModelConfig  # noqa: E402
from ggpm_tpu.models.vae import PropertyVAE as JaxPropertyVAE  # noqa: E402
from ggpm_tpu.parallel.mesh import make_dp_train_step as jax_dp_step  # noqa: E402
from ggpm_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from ggpm_tpu.parallel.mesh import param_partition_spec as jax_spec  # noqa: E402
from ggpm_tpu.parallel.mesh import shard_model_batches  # noqa: E402
from ggpm_tpu.train import checkpoint as jax_ckpt  # noqa: E402
from ggpm_tpu.train.loop import Trainer as JaxTrainer  # noqa: E402
from ggpm_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from ggpm_tpu_torch import profile_dp, profile_train  # noqa: E402
from ggpm_tpu_torch.bridge import (flatten, flax_paths, read_checkpoint,  # noqa: E402
                                   to_flax_tree)
from ggpm_tpu_torch.cli import vae_train  # noqa: E402
from ggpm_tpu_torch.models.vae import ModelConfig, PropertyVAE  # noqa: E402
from ggpm_tpu_torch.parallel import distributed, mesh as pmesh  # noqa: E402
from ggpm_tpu_torch.train.loop import signature  # noqa: E402
from torch_dp_common import (BATCH, BETA, OPT, ROOT, SMALL, TP_MIN_DIM,  # noqa: E402
                             _assert_updates, _hold, _jax_dp, _packed,
                             _prop_spec, _spawn, jax_fragments, prop)


def test_dp_step_matches_jax_prop(prop, tmp_path):
    """D = 2 ranks, two steps over groups (0, 1) and (2, 4) of one
    signature each, against ``make_dp_train_step`` on 2 of the 8 virtual
    devices."""
    groups = [[0, 1], [2, 4]]
    wait = _spawn(tmp_path, 2, _prop_spec(prop, groups, mode='steps'))
    step = _jax_dp(prop['jmodel'], 2)
    reports = wait()
    for r in reports:
        assert r['all_reduces'] == len(groups)
    _hold(reports, step, prop['params'], prop['jbs'], groups)


def test_flush_of_five_at_d2_takes_the_jax_groups(prop, tmp_path):
    """``train_epoch`` over five batches of one signature at D = 2 steps
    the JAX ``Trainer(mesh=...)``'s groups, (0, 1), (2, 3), (4, 4), and
    ends on its parameters."""
    sigs = [signature(b) for b in prop['jbs']]
    five = [i for i, s in enumerate(sigs) if s == sigs[2]][:5]
    assert len(five) == 5
    wait = _spawn(tmp_path, 2, _prop_spec(prop, five, mode='epoch'))
    tx = jax_make_optimizer(**OPT)
    tr = JaxTrainer(prop['jmodel'], tx, prop['jvocab'].mask,
                    print_iter=10 ** 6, mesh=jax_make_mesh(2))
    tr._dp_fn = jax_dp_step(prop['jmodel'], tx, tr.mesh, BETA,
                            perturb_z=False)
    tr._mask_rep = jnp.asarray(prop['jvocab'].mask)
    tr._placed = False
    seen = []
    dp_step = tr.dp_step

    def recording(params, opt_state, db_list):
        # the JAX Trainer's batch dicts are new, their trees the same
        seen.append([next(i for i in five
                          if db['tree'] is prop['jbs'][i]['tree'])
                     for db in db_list])
        return dp_step(params, opt_state, db_list)
    tr.dp_step = recording
    p = jax.tree.map(jnp.asarray, prop['params'])
    p, _, stop = tr.train_epoch(p, tx.init(p), [prop['jbs'][i] for i in five])
    assert not stop and tr.total_step == 3
    assert seen == [[five[0], five[1]], [five[2], five[3]],
                    [five[4], five[4]]]
    reports = wait()
    jafter = flatten(jax.tree.map(np.array, p))
    for rank, r in enumerate(reports):
        assert r['stepped'] == [g[rank] for g in seen]
        jbefore = flatten(jax.tree.map(np.asarray, prop['params']))
        noise = {k: np.zeros(np.shape(v), bool) for k, v in jbefore.items()}
        for k in r['noise']:
            noise[k] = r['noise'][k]
        _assert_updates(jbefore, r['final'], jbefore, jafter, noise)
    assert len({r['digest'] for r in reports}) == 1


def test_vae_train_cli_two_ranks_rank0_saves(prop, tmp_path, capfd):
    """``vae_train --device cpu --n-devices 2`` runs an epoch in two gloo
    processes: only rank 0 prints and saves, and the JAX package loads its
    checkpoint."""
    vocab_file = tmp_path / 'vocab.txt'
    vocab_file.write_text(''.join(f'{a} {b}\n' for a, b in prop['pairs']))
    csv_file = tmp_path / 'data.csv'
    with open(csv_file, 'w') as f:
        f.write('SMILES,HOMO,LUMO\n')
        f.writelines(f'{s},{h},{l}\n' for s, h, l in prop['rows'][:4 * BATCH])
    cfg = dict(vocab_=str(vocab_file), save_dir=str(tmp_path / 'out'),
               batch_size=BATCH, epoch=1, print_iter=1, seed=2, **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    args = ['--path-to-config', str(tmp_path / 'cfg.json'), '--model-type',
            'prop', '--data-csv', str(csv_file), '--device', 'cpu']
    assert vae_train.main(args + ['--n-devices', '2']) is None
    out = capfd.readouterr().out
    assert out.count('saved ') == 1 and out.count('Model #Params') == 1
    assert 'data-parallel over 2 ranks (gloo, dp=2 × tp=1)' in out
    path = tmp_path / 'out' / 'model.0'
    model = PropertyVAE(ModelConfig(**prop['cfg']))
    jparams = jax_ckpt.load_params(jax.tree.map(np.asarray, to_flax_tree(
        model)), str(path))
    for k, v in flatten(jax.tree.map(np.asarray, jparams)).items():
        assert np.isfinite(v).all(), k
    # several processes with their own inputs and TP are refused, as JAX
    # refuses them; TP on one device too
    with pytest.raises(ValueError, match='TP are not supported'):
        vae_train.train(vae_train.argparse.Namespace(
            path_to_config=str(tmp_path / 'cfg.json'), model_type='prop',
            data_csv=str(csv_file), device='cpu'), 0, 0, 2,
            pmesh.Mesh(dp=1, tp=2, n_proc=2))
    with pytest.raises(ValueError, match='several devices'):
        vae_train.main(args + ['--tp', '2'])


def test_vae_train_cli_two_processes_read_disjoint_shards(prop, tmp_path):
    """``--dist-coordinator``, ``--dist-nprocs`` and ``--dist-pid``: two
    processes started by the caller, each reading its own batches of the
    CSV (``batches[pid::2]``), one rank each; rank 0 alone saves."""
    vocab_file = tmp_path / 'vocab.txt'
    vocab_file.write_text(''.join(f'{a} {b}\n' for a, b in prop['pairs']))
    csv_file = tmp_path / 'data.csv'
    with open(csv_file, 'w') as f:
        f.write('SMILES,HOMO,LUMO\n')
        # pid 0 reads batches 0 and 2 of the 96 molecules, pid 1 batches
        # 1 and 4: two steps each
        f.writelines(f'{s},{h},{l}\n' for i in (0, 1, 2, 4)
                     for s, h, l in prop['rows'][i * BATCH:(i + 1) * BATCH])
    cfg = dict(vocab_=str(vocab_file), save_dir=str(tmp_path / 'out'),
               batch_size=BATCH, epoch=1, print_iter=1, seed=2, **SMALL)
    (tmp_path / 'cfg.json').write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    env.pop('JAX_PLATFORMS', None)
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'ggpm_tpu_torch.cli.vae_train',
         '--path-to-config', str(tmp_path / 'cfg.json'), '--model-type',
         'prop', '--data-csv', str(csv_file), '--device', 'cpu',
         '--dist-coordinator', f'file://{tmp_path}/rendezvous',
         '--dist-nprocs', '2', '--dist-pid', str(pid)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0].count('saved ') == 1 and 'saved ' not in outs[1]
    assert (tmp_path / 'out' / 'model.0').exists()


def test_init_distributed_is_a_noop_without_arguments(monkeypatch):
    for k in ('GGPM_COORDINATOR', 'GGPM_NUM_PROCESSES', 'GGPM_PROCESS_ID'):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() == 0
    assert not torch.distributed.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    monkeypatch.setenv('GGPM_COORDINATOR', 'localhost:1')
    with pytest.raises(ValueError, match='process count'):
        distributed.init_distributed()


@pytest.mark.parametrize('n,want', [
    (5, [[0, 1], [2, 3], [4, 4]]), (1, [[0, 0]]), (4, [[0, 1], [2, 3]])])
def test_dp_groups_cycle_the_short_last_group(n, want):
    assert pmesh.dp_groups(list(range(n)), 2) == want
    mesh = pmesh.Mesh(dp=2)
    assert pmesh.stack_batches(want[0], mesh) == want[0][0]


def test_param_partition_spec_matches_jax(prop):
    """The port's rule on the bridged tree and on the model's own
    parameters equals JAX's at every leaf."""
    for min_dim in (TP_MIN_DIM, 256, 8):
        want = jax.tree.map(lambda s: tuple(s), jax_spec(
            prop['params'], min_dim=min_dim),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = pmesh.param_partition_spec(prop['params'], min_dim)
        assert flatten(got) == flatten(want)
        model = PropertyVAE(ModelConfig(**prop['cfg']))
        names = pmesh.split_params(model, min_dim)
        paths = {f'params/{path}' for n, (path, _) in
                 flax_paths(model).items() if n in names}
        assert paths == {k for k, v in flatten(want).items() if v}


def test_step_seed_depends_on_the_data_index():
    """Each data rank draws its own noise, the ranks of a model group the
    same; outside a mesh the seed is the trainer's."""
    seeds = [pmesh.step_seed(1, d) for d in (0, 1, 0)]
    assert seeds[0] == seeds[2] != seeds[1]
    assert pmesh.step_seed(1, None) == 1 != pmesh.step_seed(2, 0)
    m = pmesh.Mesh(dp=2, tp=2)
    assert (m.world, m.data_index, m.model_index) == (4, 0, 0)
    assert m.axis_names == ('data', 'model')


# -- the full-width golden that chip_smoke.py phase 16 holds the card to -----

def dp_reference():
    """JAX's ``make_dp_train_step`` on 2 virtual devices, from the ``vae/``
    weights of the trained HOPV checkpoint, over ``profile_dp.
    golden_groups``: per step the metrics, ``GNorm`` and per leaf the
    update along the mean gradient (read from Adam's first moment) and
    the gradient's norm, as ``goldens/train_hopv.json`` records them."""
    saved = jax_mg.MolGraph.FRAGMENTS
    try:
        jvocab, _ = jax_load_vocab(profile_train.VOCAB)
        vocab, _, groups = profile_dp.golden_groups()
        rows = profile_train.hopv_rows(vocab)
        jbs = [_packed(jax_batching.to_model_batch(jax_batching.pad_batch(
            jax_mg.tensorize(rows[20 * i:20 * i + 20], jvocab, jax_avocab)),
            jvocab.mask, pad=False)) for i in range(profile_dp.N_BATCHES)]
    finally:
        jax_mg.MolGraph.FRAGMENTS = saved
    hv, iv = jvocab.size()
    jmodel = JaxPropertyVAE(cfg=JaxModelConfig(hvocab_size=hv, ivocab_size=iv))
    params = {'params': read_checkpoint(profile_train.CKPT)['params']['vae']}
    tx = jax_make_optimizer(**profile_train.OPTIMIZER)
    mesh = jax_make_mesh(profile_dp.DP)
    step = jax_dp_step(jmodel, tx, mesh, beta=profile_train.BETA,
                       perturb_z=False)
    p = jax.tree.map(jnp.asarray, params)
    st = tx.init(p)
    mu_prev = {k: 0.0 for k in flatten(params)}
    steps = []
    for i, group in enumerate(groups):
        before = flatten(jax.tree.map(np.array, p))
        p, st, metrics, _ = step(p, st, shard_model_batches(
            [jbs[j] for j in group], mesh), jax.random.PRNGKey(i))
        after = flatten(jax.tree.map(np.array, p))
        mu = flatten(jax.tree.map(np.array, st[1].mu))
        grad = {k: (mu[k] - 0.9 * mu_prev[k]) / 0.1 for k in mu}
        mu_prev = mu
        gnorm = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                                  for v in grad.values())))
        # the recovered gradient is the clipped one: no step may clip
        assert gnorm < profile_train.OPTIMIZER['clip_norm'], gnorm
        steps.append(dict(
            {k: float(v) for k, v in sorted(metrics.items())}, GNorm=gnorm,
            update_norms=profile_train.update_norms(before, after, grad),
            grad_norms={k: float(np.linalg.norm(v)) for k, v in
                        grad.items()}))
    return dict(checkpoint='runs/QUALITY_hopv.json.ckpt (vae/ subtree)',
                vocab='runs/QUALITY_hopv.json.vocab.txt',
                data='data/hopv15.csv', batch_size=20, devices=profile_dp.DP,
                groups=groups, optimizer=profile_train.OPTIMIZER,
                beta=profile_train.BETA, steps=steps)


@pytest.fixture(scope='module')
def golden():
    with open(profile_dp.GOLDEN) as f:
        return json.load(f)


def test_golden_groups_are_the_trainer_order(golden):
    _, _, groups = profile_dp.golden_groups()
    assert groups == golden['groups'] == [[0, 1], [2, 4], [3, 3]]


@pytest.mark.slow
def test_golden_is_the_jax_reference(golden):
    want = dp_reference()
    assert {k: v for k, v in golden.items() if k != 'steps'} == \
        {k: v for k, v in want.items() if k != 'steps'}
    for g, w in zip(golden['steps'], want['steps']):
        for k, v in w.items():
            if isinstance(v, dict):
                for leaf, x in v.items():
                    assert g[k][leaf] == pytest.approx(x, rel=1e-5, abs=1e-9)
            else:
                assert g[k] == pytest.approx(v, rel=1e-5), k


if __name__ == '__main__':
    with open(profile_dp.GOLDEN, 'w') as f:
        json.dump(dp_reference(), f, indent=1)
        f.write('\n')
