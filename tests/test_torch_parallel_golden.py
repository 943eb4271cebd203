"""chip_smoke.py phase 16 (b) and (c) on the CPU: the port's canonical
configuration at full width, 2 gloo ranks (and 2 × 2 with the vocab-sized
leaves split), three data-parallel steps from the trained HOPV checkpoint
held to ``goldens/train_dp2_hopv.json`` (JAX's ``make_dp_train_step``;
tests/test_torch_parallel.py writes it) by ``profile_train.check_golden``'s
prop rule, every rank's parameters equal bit for bit, and equal bit for
bit to one process taking the same steps without a collective."""

import json

import pytest
import torch

from ggpm_tpu_torch import profile_dp, profile_train

SHARDS = {'E_i.weight': [190] * 3, 'decoder.iclsNN.Dense_1.weight': [190] * 3}


@pytest.fixture(scope='module')
def golden():
    with open(profile_dp.GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def dp2():
    return profile_dp.run_ranks(2, device='cpu')


@pytest.mark.parametrize('tp', [1, 2])
def test_port_on_the_cpu_meets_the_golden(golden, dp2, tp):
    """2 (or 2 × 2) gloo ranks at full width held to the golden; on the
    2 × 2 grid each rank holds 190 of the 380 attachment rows and icls
    columns and of their moments."""
    reports = dp2 if tp == 1 else profile_dp.run_ranks(4, tp=2, device='cpu')
    assert profile_dp.check_ranks(reports, golden,
                                  None if tp == 1 else SHARDS) == []


def test_ranks_take_the_one_process_steps_bit_for_bit(golden, dp2):
    """``profile_dp.emulated_steps`` (no mesh, no collective) meets the
    golden and ends on the 2 gloo ranks' parameters, bit for bit."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)        # as each rank runs (rank_main)
    try:
        steps, digest = profile_dp.emulated_steps('cpu')
    finally:
        torch.set_num_threads(saved)
    assert profile_train.check_golden(steps, golden) == []
    assert [r['digest'] for r in dp2] == [digest, digest]
