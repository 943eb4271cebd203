"""The port stands alone: it imports neither JAX, flax, msgpack, networkx
nor anything of ``ggpm_tpu``, and chip_smoke.py fails without a GPU or
without the rest of the repo."""

import importlib.util
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'ggpm_tpu_torch')
FORBIDDEN = ('jax', 'flax', 'optax', 'msgpack', 'networkx')

_IMPORT_ALL = f"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import ggpm_tpu_torch
for m in pkgutil.walk_packages(ggpm_tpu_torch.__path__, 'ggpm_tpu_torch.'):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location('chip_smoke', {ROOT!r} + '/chip_smoke.py')
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in {FORBIDDEN!r}
             or (n.split('.')[0] == 'ggpm_tpu'))
print(' '.join(bad))
"""


def _run(args, cwd, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_the_port_loads_no_jax_or_ggpm_tpu(tmp_path):
    out = _run(['-c', _IMPORT_ALL], cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ''


def _sources():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith('.py')]
    return files


_IMPORT_RE = re.compile(
    r'^\s*(?:import|from)\s+(?:' + '|'.join(FORBIDDEN) +
    r'|ggpm_tpu(?!_torch))\b', re.M)


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_has_no_forbidden_import(path):
    with open(path) as f:
        assert not _IMPORT_RE.findall(f.read())


def test_source_scan_pattern():
    assert _IMPORT_RE.search('import jax.numpy as jnp')
    assert _IMPORT_RE.search('from ggpm_tpu.ops import nei_sum')
    assert _IMPORT_RE.search('    import msgpack')
    assert not _IMPORT_RE.search('from ggpm_tpu_torch.ops import nei_sum')
    assert not _IMPORT_RE.search('import jaxlib_like_name')


def test_port_modules_are_all_scanned():
    names = {m.name for m in pkgutil.walk_packages([PORT])}
    assert {'bridge', 'serve', 'ops', 'models', 'graph', 'chem', 'train',
            'cli', 'configs', 'profile_train', 'profile_serve',
            'kernel_bench'} <= names


def test_chip_smoke_fails_without_cuda(capsys):
    """Without a GPU the script exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: chip_smoke.py would run in full')
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
    out = _run([os.path.join(ROOT, 'chip_smoke.py')], cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    out = _run(['chip_smoke.py'], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
