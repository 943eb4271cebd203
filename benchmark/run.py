"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``ggpm_tpu_torch``.  The cell is
an entry of ``BENCHMARK.json``'s ``workloads``; its file
``benchmark/workloads/<cell>.json`` names the job (``benchmark/jobs/
<job>.py``) and the limits of its correctness numbers, and the cell's
configuration and traffic are ``benchmark/configs/<config>.json`` and
``benchmark/traffic/<traffic>.json``.  Each metric is read from the job's
record by ``benchmark/metrics/<metric>.py``: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error are those numbers too.  Exits
with another code than 0, printing no result, without a CUDA card (or
with fewer than the cell asks for), and when JAX or the JAX package has
been loaded into the process by the end of the run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'benchmark')
# the JAX stack and the JAX package: none of it may run here
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ggpm_tpu')


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN`` (``ggpm_tpu_torch`` is not ``ggpm_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split('.')[0] in FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(bench: dict, name: str, here: str = HERE) -> dict:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` as loaded) with
    its workload, configuration and traffic files and its metrics'
    entries, found by name."""
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no cell {name!r} in BENCHMARK.json')
    cell = cells[name]

    def mine(metric):
        return name in metric.get('workloads', [name])
    return {'cell': cell,
            'workload': load_json(here, 'workloads', name + '.json'),
            'config': load_json(here, 'configs', cell['config'] + '.json'),
            'traffic': load_json(here, 'traffic', cell['traffic'] + '.json'),
            'end_to_end': [m for m in bench['end_to_end'] if mine(m)],
            'per_layer': [m for m in bench['per_layer'] if mine(m)]}


def reader(name: str, here: str = HERE):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(here, 'metrics', name + '.py')
    mod_name = 'benchmark.metrics.' + re.sub(r'\W', '_', name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod.read


def job(name: str):
    """The ``run`` function of ``benchmark/jobs/<name>.py``."""
    return importlib.import_module(f'benchmark.jobs.{name}').run


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, here: str = HERE,
             root: str = ROOT) -> dict:
    """One run of cell ``name``: the job's record, the metrics read from it
    and the correctness checks, as the result line lays them out (without
    ``device``)."""
    from benchmark.yardstick.compare import judge
    files = cell_files(bench, name, here)
    ctx = dict(files, seed=seed, seconds=seconds, trace=trace, device=device,
               root=root, t_start=t_start)
    rec = job(files['workload']['job'])(ctx)
    metrics = {}
    for m in files['per_layer' if trace else 'end_to_end']:
        value = reader(m['name'], here)(rec)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    checks = judge(rec['numbers'], files['workload']['limits'])
    out = {'correct': all(c['ok'] for c in checks),
           'attempted': rec['steps'], 'failed': 0, 'metrics': metrics,
           'record': rec, 'checks': checks}
    if trace and 'trace' in rec:
        out['breakdown'] = {'device_ops': rec['trace']['top_ops'],
                            'idle_gaps': rec['trace']['idle_gaps']}
    return out


def _details(rec: dict) -> dict:
    """What the run measured beyond its metrics, for standard error."""
    keys = ('setup_s', 'window_s', 'epochs', 'steps', 'spans', 'calls',
            'checked_steps', 'launches_ran', 'launches_counted', 'bound_s',
            'bound_by', 'kernel_shares', 'copy_rate_max', 'flops_per_epoch',
            'memory_peak_bytes', 'after_window_s', 'span_epoch',
            'numbers_detail', 'later_detail', 'step_kinds', 'epoch_ends_s',
            'copy_rates_s')
    out = {k: rec[k] for k in keys if k in rec}
    if 'trace' in rec:
        out['trace'] = {k: rec['trace'][k] for k in ('busy_s', 'window_s',
                                                      'outside_s', 'kernels')}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, 'ggpm_tpu_torch')):
        print('no ggpm_tpu_torch beside the benchmark', file=sys.stderr)
        return 2
    sys.path[0] = ROOT
    # build caches at fixed paths in the checkout (the port's kernels
    # build into <checkout>/build/ by themselves)
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build',
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')
    bench = load_json(ROOT, 'BENCHMARK.json')
    chips = {w['name']: w for w in bench['workloads']}[args.workload]['chips']
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'the cell needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), 'cuda', T_START)
    rec = out.pop('record')
    bad = forbidden_modules()
    if bad:
        print(f'loaded in this process: {", ".join(bad)}', file=sys.stderr)
        return 3
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': chips, 'memory_peak_bytes': rec['memory_peak_bytes']}
    if args.trace:
        device.update(busy_s=rec['trace']['busy_s'],
                      window_s=rec['trace']['window_s'])
    checks = {c['name']: {'value': c['value'], 'limit': c['limit']}
              for c in out.pop('checks')}
    line = dict(out, device=device)
    line['checks'] = checks
    print(json.dumps(_details(rec)), file=sys.stderr)
    for k, c in checks.items():
        print(f'check {k}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())
