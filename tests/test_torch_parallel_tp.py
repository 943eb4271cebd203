"""The port's data-parallel step of the hier family and its dp×tp step
against the JAX package's ``make_dp_train_step`` and
``make_gspmd_train_step`` on the CPU (the setup and tolerances of
tests/test_torch_parallel.py, whose helpers live in
tests/torch_dp_common.py)."""

import jax

from ggpm_tpu.parallel.mesh import make_gspmd_train_step as jax_gspmd_step
from ggpm_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from ggpm_tpu.parallel.mesh import param_partition_spec as jax_spec
from ggpm_tpu.train.optim import make_optimizer as jax_make_optimizer
from ggpm_tpu_torch.bridge import flatten
from ggpm_tpu_torch.profile_serve import HIER_VOCAB
from torch_dp_common import (BETA, OPT, TP_MIN_DIM, _hold, _jax_dp,
                             _prop_spec, _spawn, hier, jax_fragments, prop)


def test_dp_step_matches_jax_hier(hier, tmp_path):
    """One D = 2 step of the small ``hier-prop`` model (unpacked plans)
    against ``make_dp_train_step``."""
    spec = dict(model='hier-prop', cfg=hier['cfg'], vocab=HIER_VOCAB,
                rows=[r for s in hier['starts'] for r in hier['rows'][s:s + 6]],
                batch=6, groups=[[0, 1]], params=hier['params'], opt=OPT,
                beta=BETA, mode='steps')
    wait = _spawn(tmp_path, 2, spec)
    step = _jax_dp(hier['jmodel'], 2)
    _hold(wait(), step, hier['params'], hier['jbs'], [[0, 1]])


def test_dp_tp_step_matches_jax_gspmd(prop, tmp_path):
    """dp 2 × tp 2: four ranks against ``make_gspmd_train_step`` on a 2 × 2
    virtual mesh, the split leaves those of JAX's ``param_partition_spec``
    on the bridged tree, each rank holding 63 of their 126 rows and of
    their moments."""
    groups = [[0, 1], [2, 4]]
    wait = _spawn(tmp_path, 4, _prop_spec(prop, groups, mode='steps', tp=2,
                                          tp_min_dim=TP_MIN_DIM))
    jmesh = jax_make_mesh_2d(2, 2)
    step, place = jax_gspmd_step(prop['jmodel'], jax_make_optimizer(**OPT),
                                 jmesh, beta=BETA, perturb_z=False,
                                 tp_min_dim=TP_MIN_DIM)
    step.mesh = jmesh
    placed = []

    def place_once(p, st, stacked):
        if placed:
            return p, st, stacked
        placed.append(True)
        return place(p, st, stacked)
    split = {k for k, v in flatten(jax_spec(prop['params'],
                                            min_dim=TP_MIN_DIM)).items()
             if v != jax.sharding.PartitionSpec()}
    assert split == {'params/E_i/embedding',
                     'params/decoder/iclsNN/Dense_1/kernel'}
    reports = wait()
    for r in reports:
        assert set(r['split']) == split
        assert r['shards'] == {k: [63, 63, 63] for k in r['shards']}
        assert len(r['shards']) == 2
    _hold(reports, step, prop['params'], prop['jbs'], groups,
          place=place_once)
