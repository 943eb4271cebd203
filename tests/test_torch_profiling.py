"""The port's profiling module (``train/profiling.py``) against the JAX
package's ``train/profiling.py`` on the CPU: the norms within 1e-6
relative, the meter's rates, and a trace that parses."""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggpm_tpu.train import profiling as jax_profiling
from ggpm_tpu_torch.train import profiling


@pytest.fixture
def tensors():
    rng = np.random.default_rng(0)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((5, 3), (7,), (2, 2, 2), (300, 40))]


def test_param_and_grad_norm_match_jax(tensors):
    want = jax_profiling.param_norm({f'p{i}': jnp.asarray(t)
                                     for i, t in enumerate(tensors)})
    model = torch.nn.Module()
    for i, t in enumerate(tensors):
        setattr(model, f'p{i}', torch.nn.Parameter(torch.from_numpy(t)))
    assert profiling.param_norm(model) == pytest.approx(want, rel=1e-6)
    assert profiling.param_norm([torch.from_numpy(t) for t in tensors]) == \
        pytest.approx(want, rel=1e-6)
    for p in model.parameters():
        p.grad = 2 * p.detach()
    model.p1.grad = None            # no gradient counts as zero
    jgrads = {f'p{i}': 2 * jnp.asarray(t) for i, t in enumerate(tensors)
              if i != 1}
    assert profiling.grad_norm(model) == pytest.approx(
        jax_profiling.grad_norm(jgrads), rel=1e-6)


def test_throughput_rates():
    meter = profiling.Throughput(device='cpu')
    for n in (20, 20, 10):
        meter.update(n)
    time.sleep(0.01)
    r = meter.rates()
    assert meter.steps == 3 and meter.mols == 50
    assert 0 < r['steps_per_sec'] < 300
    assert r['mols_per_sec'] == pytest.approx(50 / 3 * r['steps_per_sec'])
    meter.reset()
    assert meter.rates()['steps_per_sec'] == 0


def test_trace_writes_a_trace_with_named_scopes(tmp_path):
    with profiling.trace(str(tmp_path / 'trace')) as prof:
        with profiling.named_scope('ggpm_step'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / 'trace')
    with open(prof.trace_path) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'ggpm_step' for e in events)


def test_nan_checks_and_trace_server():
    profiling.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match='nan'):
            (x / x).sum().backward()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
