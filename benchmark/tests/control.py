"""The readings a cell's correctness limits are set between, from the
reference alone: its control (the reference in the program's place,
computed one precision below the configuration's: TF32 for float32 with
TF32 off) and the fault of a step that leaves half its batch out (the
mean over the rest), each held to the float32 reference by the cell's
numbers (``yardstick.compare``), on the cell's own rows and steps: the
first step's and the change's from the checkpoint, and the later steps'
with the float32 reference following each from the state before it.

    python3 benchmark/tests/control.py --workload <cell> --seeds 1 2 3 [--out FILE]

Prints one JSON line a seed.  The benchmark's own runs do not run it;
``test_bench_control.py`` runs it on the card at one seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import steps as ref_steps  # noqa: E402
from benchmark.run import cell_files, load_json  # noqa: E402
from benchmark.yardstick import compare, traffic  # noqa: E402

STEPS = 3


def readings(name: str, seed: int, device: str = 'cuda',
             kinds=('control', 'half_batch')) -> dict:
    """The cell's numbers of each of ``kinds`` against the float32
    reference, at seed ``seed``: three steps from the checkpoint on the
    first three batches of the seed's first epoch."""
    files = cell_files(load_json(ROOT, 'BENCHMARK.json'), name)
    cfg, tr = files['config'], files['traffic']
    model, vocab = ref_steps.load_model(cfg, ROOT)
    rows = ref_steps.read_rows(os.path.join(ROOT, tr['data']), vocab)
    n = traffic.n_batches(len(rows), cfg['batch_size'])
    order = traffic.epoch_order(seed, 0, n)[:STEPS]
    step_rows = [ref_steps.batch_rows(rows, cfg['batch_size'], i)
                 for i in order]
    theta0 = {k: p.detach().clone().to(device)
              for k, p in model.named_parameters()}
    model.to(device)

    def noise():
        return ref_steps.noise_generator(traffic.noise_seed(seed), device)

    def side(**kw):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(theta0[k])
        out = ref_steps.run_steps(model, vocab, cfg, step_rows, noise(), n,
                                  trail=True, **kw)
        return {'losses': out['losses'],
                'grad1': {k: v.cpu() for k, v in out['grad1'].items()},
                'delta': {k: (out['params'][k] - theta0[k]).cpu()
                          for k in theta0},
                'later': [dict(t, step=i + 1, rows=step_rows[i])
                          for i, t in enumerate(out['trail']) if i]}
    ref = side()
    out = {'workload': name, 'seed': seed, 'steps': order}
    for kind, kw in (('control', {'precision': 'tf32'}),
                     ('half_batch', {'keep': 0.5})):
        if kind in kinds:
            rec = side(**kw)
            followed = ref_steps.follow(model, vocab, cfg, rec['later'],
                                        noise(), n)
            out[kind] = dict(compare.training_numbers(rec, ref),
                             **compare.later_numbers(rec['later'], followed))
            out[kind + '_detail'] = dict(
                compare.details(rec, ref),
                later=compare.later_details(rec['later'], followed))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--out')
    args = p.parse_args(argv)
    for seed in args.seeds:
        line = json.dumps(readings(args.workload, seed))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
