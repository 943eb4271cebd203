"""Nothing the benchmark runs is JAX or the JAX package, compared by whole
top-level module names (``ggpm_tpu_torch`` begins with ``ggpm_tpu``),
and the plain reference imports nothing of the port; the command fails,
printing no result, without a card or without the port beside it."""

import ast
import os
import shutil
import subprocess
import sys

from benchmark import run

HERE = run.HERE
REFERENCE = os.path.join(HERE, 'reference')


def _imports(path):
    """Top-level names of the absolute imports of a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.')[0])
    return out


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_names_are_compared_whole():
    assert run.forbidden_modules({'ggpm_tpu_torch': 0,
                                  'ggpm_tpu_torch.ops': 0, 'jaxtyping': 0,
                                  'flaxen': 0}) == []
    assert run.forbidden_modules({'jax.numpy': 0, 'ggpm_tpu': 0,
                                  'ggpm_tpu.models.vae': 0, 'flax': 0,
                                  'jaxlib': 0}) == [
        'flax', 'ggpm_tpu', 'ggpm_tpu.models.vae', 'jax.numpy', 'jaxlib']


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources(HERE):
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(REFERENCE):
        names = _imports(path)
        assert 'ggpm_tpu_torch' not in names and \
            not names & set(run.FORBIDDEN), path


def test_the_reference_loads_no_port_module():
    code = ('import sys; import benchmark.reference.steps, '
            'benchmark.yardstick.flops, benchmark.yardstick.compare; '
            'print(sorted({m.split(".")[0] for m in sys.modules}))')
    out = subprocess.run([sys.executable, '-c', code], cwd=run.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = eval(out)
    assert 'ggpm_tpu_torch' not in loaded
    assert not set(loaded) & set(run.FORBIDDEN)


def _command(cwd, seed=1):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'prop-train-hopv',
         '--seed', str(seed), '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))


def test_fails_without_a_card_and_prints_no_result():
    res = _command(run.ROOT)
    assert res.returncode != 0 and res.stdout == ''


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(os.path.join(run.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    res = _command(tmp_path)
    assert res.returncode != 0 and res.stdout == ''
