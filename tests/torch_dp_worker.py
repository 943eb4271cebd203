"""One rank of a data-parallel run of the port on the CPU, for
tests/test_torch_parallel.py (it imports nothing of JAX):

    python tests/torch_dp_worker.py SPEC RANK WORLD

``SPEC`` is a pickled dict: the model (``prop`` or ``hier-prop``), its
config and flax params, the vocab (``pairs`` or a ``vocab`` file), the
rows and batch size, the optimizer and β, ``tp`` (and ``tp_min_dim``),
the rendezvous ``init`` and the report's path prefix ``out``.  In mode
``steps`` the rank takes one ``Trainer.dp_step`` per group of ``groups``
(batch indices) and reports each step's metrics, mean gradient, whole
parameters before and after, and their digest; in mode ``epoch`` it runs
``Trainer.train_epoch`` over the batches ``groups`` and reports the batch
it stepped on each step and the final parameters.
"""

import hashlib
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ggpm_tpu_torch.bridge import flatten, load_flax_params, to_flax_tree  # noqa: E402
from ggpm_tpu_torch.data import batching  # noqa: E402
from ggpm_tpu_torch.graph.mol_graph import tensorize  # noqa: E402
from ggpm_tpu_torch.graph.vocab import (PairVocab, common_atom_vocab,  # noqa: E402
                                        load_vocab_file)
from ggpm_tpu_torch.models.vae import (HierPropertyVAE, ModelConfig,  # noqa: E402
                                       PropertyVAE)
from ggpm_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from ggpm_tpu_torch.parallel.distributed import (init_distributed,  # noqa: E402
                                                 replicate_global)
from ggpm_tpu_torch.train.loop import Trainer  # noqa: E402
from ggpm_tpu_torch.train.optim import make_optimizer  # noqa: E402


def whole(trainer):
    with trainer.gathered():
        return flatten(to_flax_tree(trainer.model))


def digest(tree):
    h = hashlib.sha256()
    for k, v in sorted(tree.items()):
        h.update(k.encode() + np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def noise(grads):
    total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                        for v in grads.values()))
    return {k: np.abs(v) < 1e-6 * total for k, v in grads.items()}


def main(spec_path, rank, world):
    torch.set_num_threads(1)
    with open(spec_path, 'rb') as f:
        spec = pickle.load(f)
    init_distributed(spec['init'], world, rank, device='cpu')
    tp = spec.get('tp', 1)
    mesh = pmesh.make_mesh_2d(world // tp, tp) if tp > 1 else \
        pmesh.make_mesh(world)
    vocab = (PairVocab(spec['pairs']) if 'pairs' in spec
             else load_vocab_file(spec['vocab']))
    rows, b = spec['rows'], spec['batch']
    mbs = [batching.pad_batch(tensorize(rows[i:i + b], vocab,
                                        common_atom_vocab))
           for i in range(0, len(rows) - b + 1, b)]
    cls = HierPropertyVAE if spec['model'] == 'hier-prop' else PropertyVAE
    model = cls(ModelConfig(**spec['cfg']))
    load_flax_params(model, spec['params'])
    replicate_global(vocab.mask, check=True)
    trainer = Trainer(model, make_optimizer(**spec['opt']), vocab.mask,
                      beta=spec['beta'], print_iter=10 ** 9,
                      perturb_z=False, device='cpu', mesh=mesh,
                      tp_min_dim=spec.get('tp_min_dim', 256))
    reduces = pmesh.all_reduce.calls
    out = dict(rank=rank)
    if spec['mode'] == 'steps':
        steps = []
        for group in spec['groups']:
            before = whole(trainer)
            metrics, _ = trainer.dp_step([mbs[i] for i in group])
            grads = flatten(to_flax_tree(trainer.model, lambda p: p.grad))
            after = whole(trainer)
            steps.append(dict(
                metrics={k: float(v[0]) for k, v in metrics.items()},
                grads=grads, before=before, after=after,
                digest=digest(after)))
        out['steps'] = steps
    else:
        tags, stepped, masks = {}, [], []
        host_batch, stack = trainer.host_batch, pmesh.stack_batches

        def tagged(mb):
            host = host_batch(mb)
            tags[id(host)] = spec['groups'][len(tags)]
            return host

        def recording(group, m, n=None):
            mine = stack(group, m, n)
            stepped.append(tags[id(mine)])
            return mine
        trainer.host_batch, pmesh.stack_batches = tagged, recording
        body = trainer._body

        def noted(*a, **k):
            res = body(*a, **k)
            masks.append(noise(flatten(to_flax_tree(
                trainer.model, lambda p: p.grad))))
            return res
        trainer._body = noted
        assert not trainer.train_epoch([mbs[i] for i in spec['groups']])
        pmesh.stack_batches = stack
        out.update(stepped=stepped, final=whole(trainer),
                   noise={k: np.logical_or.reduce([m[k] for m in masks])
                          for k in masks[0]})
        out['digest'] = digest(out['final'])
    out['all_reduces'] = pmesh.all_reduce.calls - reduces
    if tp > 1:
        out['split'] = {f'params/{p}' for n, (p, _) in __import__(
            'ggpm_tpu_torch.bridge', fromlist=['flax_paths']).flax_paths(
                trainer.model).items() if n in trainer.opt_state.split}
        out['shards'] = {k: [int(t.shape[0]) for t in v]
                         for k, v in trainer.opt_state.shards().items()}
    with open(f'{spec["out"]}{rank}.pkl', 'wb') as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
