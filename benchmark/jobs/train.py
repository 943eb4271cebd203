"""The training job: one configuration trained by the port's ``Trainer``
on a training traffic, epoch after epoch.

Set-up, all of it in ``setup_s``: the port loads the checkpoint
(``bridge.read_checkpoint``, ``load_flax_params``) into its model, prunes
the traffic's rows to its vocab, tensorizes and pads them in batches of
the configuration's size (``graph.mol_graph.tensorize``,
``data.batching.pad_batch``), builds the optimizer
(``train.optim.make_optimizer``) and one ``train.loop.Trainer``, and runs
one epoch through ``Trainer.train_epoch``, which captures a CUDA graph
for each of the cell's batch signatures.  That epoch's steps are the ones
the reference checks: the harness records, around the trainer's own
calls, which batch each step took and how (eager, or a graph's replay),
each step's loss, and the optimizer's state (the parameters and Adam's
moments) before and after the steps it checks.  The first steps are
followed by the reference from the checkpoint; each signature's first
replay and the first eager flush of one, from the program's state
before it (``reference.steps.follow``).

The window: epochs back to back through the same trainer until
``seconds`` have passed, ending at an epoch boundary, every epoch's batch
order drawn from the seed.  After it one more epoch runs with spans
around the trainer's calls, each call that waits on the device timed
from a synchronisation; with ``trace`` another follows under
``torch.profiler`` tracing the device alone.  The kernels' launches and
their bytes come from each batch signature's eager step in set-up, where
the harness wraps the port's launch functions.

After the window the peak memory is read and the traced run measures the
L2 copy rates its roofline needs; then the program's state is freed, the
reference takes the same steps, and the traced run counts each batch's
FLOPs with the reference.
"""

from __future__ import annotations

import gc
import importlib
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import steps as ref_steps
from ..yardstick import compare, flops, roofline, trace, traffic
from ..yardstick.spans import Spans

CHECKED_STEPS = 3


def _signature(batch) -> tuple:
    """The shapes of a host batch's arrays in sorted-key order."""
    out = []
    for k in sorted(batch):
        v = batch[k]
        out.extend(_signature(v) if isinstance(v, dict) else [np.shape(v)])
    return tuple(out)


def _model(cfg: Dict, root: str, device: str):
    """The port's model of the configuration, its checkpoint loaded, and
    its vocab."""
    from ggpm_tpu_torch.bridge import load_flax_params, read_checkpoint
    from ggpm_tpu_torch.graph.vocab import load_vocab_file
    from ggpm_tpu_torch.models.vae import (HierPropertyVAE, ModelConfig,
                                           PropertyVAE)
    vocab = load_vocab_file(os.path.join(root, cfg['vocab']))
    hv, iv = vocab.size()
    keys = ('embed_size', 'hidden_size', 'latent_size', 'depthT', 'depthG',
            'diterT', 'diterG', 'atom_vocab_size', 'dropout', 'rnn_type',
            'tie_embedding', 'use_attention', 'compute_dtype')
    mc = ModelConfig(hvocab_size=hv, ivocab_size=iv,
                     **{k: cfg[k] for k in keys if k in cfg})
    model = {'prop': PropertyVAE, 'hier-prop': HierPropertyVAE}[
        cfg['model_type']](mc)
    params = read_checkpoint(os.path.join(root, cfg['checkpoint']))
    params = params.get('params', params)
    if cfg.get('checkpoint_subtree'):
        params = params[cfg['checkpoint_subtree']]
    load_flax_params(model, {'params': params})
    return model.to(device), vocab


class _FirstSteps:
    """What the harness records of the trainer's steps in set-up: the
    batch and the kind of each step (``warm_up``, the eager step before a
    capture; ``train_step``, an eager flush of one; ``replay``, a captured
    graph's), each step's loss and each batch's signature (the shapes of
    its host arrays); the parameters before step 1 and after step ``n``
    and Adam's first moment after step 1; and the state (parameters and
    moments, on the CPU) before and after each checked later step: each
    signature's first replay, and the first ``train_step`` after step 1."""

    def __init__(self, trainer, batches, n: int):
        from ggpm_tpu_torch.train.loop import StepGraph
        self.trainer, self.n = trainer, n
        self.index = {id(b): i for i, b in enumerate(batches)}
        self.sig_of: Dict[int, tuple] = {}
        self.steps: List[int] = []
        self.kinds: List[str] = []
        self.losses: List[torch.Tensor] = []
        self.state = self._state()
        self.theta0 = self.state['flat']
        self.mu1 = self.theta_n = self.current = None
        self.later: List[Dict] = []
        self.replayed = set()
        self.spans = Spans()
        self.spans.wrap(trainer, 'host_batch', 'host_batch',
                        after=self._tag_host)
        self.spans.wrap(trainer, 'device_batch', 'device_batch',
                        after=self._tag)
        for attr in ('train_step', 'scan_steps'):
            self.spans.wrap(trainer, attr, attr, group='step',
                            after=lambda out, args: self._took(out))
        self._kind(trainer, '_warm_up', 'warm_up', 0)
        self._kind(trainer, 'train_step', 'train_step', 0)
        self._kind(StepGraph, 'run', 'replay', 2)
        self.spans.wrap(trainer, '_advance', '_advance', after=self._advanced)

    def _state(self) -> Dict[str, torch.Tensor]:
        st = self.trainer.opt_state
        return {k: getattr(st, k).detach().to('cpu', copy=True)
                for k in ('flat', 'mu', 'nu')}

    def _kind(self, obj, attr, kind, arg):
        """Tag each call of ``obj.attr`` as a step of ``kind`` on the
        batch at ``args[arg]``."""
        orig = getattr(obj, attr)

        def call(*args, **kwargs):
            self.current = (kind, self.index[id(args[arg])])
            return orig(*args, **kwargs)
        self.spans.replace(obj, attr, call)

    def _tag(self, out, args):
        self.index[id(out)] = self.index[id(args[0])]

    def _tag_host(self, out, args):
        self._tag(out, args)
        self.sig_of[self.index[id(out)]] = _signature(out)

    def _took(self, out):
        self.losses.append(out[0]['Loss'].detach().reshape(-1).clone())

    def _advanced(self, out, args):
        (kind, i), self.current = self.current, None
        k, sig, state = self.trainer.total_step, self.sig_of[i], self._state()
        self.steps.append(i)
        self.kinds.append(kind)
        if k == 1:
            self.mu1 = state['mu']
        if k == self.n:
            self.theta_n = state['flat']
        first_eager = kind == 'train_step' and 'train_step' not in \
            [c['kind'] for c in self.later]
        if k >= 2 and (first_eager or
                       kind == 'replay' and sig not in self.replayed):
            self.later.append({'step': k, 'kind': kind, 'batch': i,
                               'before': self.state, 'after': state})
        if kind == 'replay':
            self.replayed.add(sig)
        self.state = state

    def record(self, names_numels) -> Dict:
        """The program's side of the comparison: the first ``n`` steps'
        losses and batches, the first clipped gradient and the change of
        the parameters, by leaf; and each checked later step's batch,
        loss, state before it, clipped gradient (from the moments before
        and after it) and change of the parameters, by leaf."""
        self.spans.unwrap()
        b1 = self.trainer.optimizer.b1

        def leaves(flat):
            out, off = {}, 0
            for name, k in names_numels:
                out[name] = flat[off:off + k]
                off += k
            return out
        losses = torch.cat(self.losses).cpu().tolist()
        later = []
        for c in self.later:
            before, after = c['before'], c['after']
            grad = (after['mu'].double() - b1 * before['mu'].double()) / \
                (1 - b1)
            later.append({'step': c['step'], 'kind': c['kind'],
                          'batch': c['batch'], 'loss': losses[c['step'] - 1],
                          'theta': leaves(before['flat']),
                          'mu': leaves(before['mu']),
                          'nu': leaves(before['nu']),
                          'grad': leaves(grad.float()),
                          'delta': leaves(after['flat'] - before['flat'])})
        return {'steps': self.steps[:self.n], 'losses': losses[:self.n],
                'grad1': leaves(self.mu1 / (1 - b1)),
                'delta': leaves(self.theta_n - self.theta0),
                'kinds': self.kinds, 'later': later}


class _Launches:
    """Each eager step's kernel launches, by the batch it took: the port's
    launch functions wrapped in set-up, each launch's bytes (the
    yardstick's arithmetic) kept under the batch's signature, from the
    first eager step of that signature."""

    def __init__(self, trainer, first: _FirstSteps):
        # the modules, which ``ggpm_tpu_torch.ops`` shadows by the
        # functions of their names
        ns_mod = importlib.import_module('ggpm_tpu_torch.ops.nei_sum')
        gr_mod = importlib.import_module('ggpm_tpu_torch.ops.gather_rows')
        self.trainer, self.first = trainer, first
        self.by_sig: Dict[tuple, List] = {}
        self.current = None
        self.spans = Spans()
        for mod, attr, kernel, size in (
                (ns_mod, 'launch', 'nei_sum',
                 lambda a: roofline.nei_sum_bytes(a[0], a[1])),
                (ns_mod, 'launch_transpose', 'transpose_sum',
                 lambda a: roofline.transpose_sum_bytes(*a[:4])),
                (gr_mod, 'launch', 'gather_rows',
                 lambda a: roofline.gather_rows_bytes(a[0], a[1]))):
            self._wrap_launch(mod, attr, kernel, size)
        for attr in ('_warm_up', 'train_step'):
            self._wrap_step(attr)

    def _wrap_launch(self, mod, attr, kernel, size):
        orig = getattr(mod, attr)

        def call(*args):
            if self.current is not None and \
                    not torch.cuda.is_current_stream_capturing():
                self.current.append((kernel, size(args)))
            return orig(*args)
        self.spans.replace(mod, attr, call)

    def _wrap_step(self, attr):
        orig = getattr(self.trainer, attr)

        def call(db, *args, **kwargs):
            sig = self.first.sig_of[self.first.index[id(db)]]
            self.current = [] if sig not in self.by_sig else None
            try:
                return orig(db, *args, **kwargs)
            finally:
                if self.current is not None:
                    self.by_sig[sig] = self.current
                self.current = None
        self.spans.replace(self.trainer, attr, call)


def run(ctx) -> Dict:
    """One run of a training cell; returns the record the metric readers
    read (``ctx``: the cell, configuration and traffic as loaded, the
    run's seed, seconds, trace flag, device and checkout root)."""
    from ggpm_tpu_torch import ops
    from ggpm_tpu_torch.data.batching import pad_batch
    from ggpm_tpu_torch.data.dataset import prune_to_vocab
    from ggpm_tpu_torch.graph.mol_graph import tensorize
    from ggpm_tpu_torch.graph.vocab import common_atom_vocab
    from ggpm_tpu_torch.train.loop import Trainer
    from ggpm_tpu_torch.train.optim import make_optimizer

    cfg, tr, seed, root, device = (ctx['config'], ctx['traffic'], ctx['seed'],
                                   ctx['root'], ctx['device'])
    cuda = device.startswith('cuda')
    if cuda:
        # the configuration's precision: float32 products in float32
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get('tf32', False))
        torch.backends.cudnn.allow_tf32 = bool(cfg.get('tf32', False))
    B = cfg['batch_size']
    model, vocab = _model(cfg, root, device)
    rows = prune_to_vocab(traffic.rows(tr, root), vocab, verbose=False)
    n = traffic.n_batches(len(rows), B)
    batches = [pad_batch(tensorize(rows[i * B:(i + 1) * B], vocab,
                                   common_atom_vocab)) for i in range(n)]
    trainer = Trainer(model, make_optimizer(
        lr=cfg['lr'], clip_norm=cfg['clip_norm'],
        anneal_rate=cfg['anneal_rate'], steps_per_epoch=n), vocab.mask,
        beta=cfg['beta'], print_iter=10 ** 9, seed=traffic.noise_seed(seed),
        perturb_z=cfg.get('perturb_z', True), device=device)
    def epoch(e: int) -> None:
        order = traffic.epoch_order(seed, e, n)
        if trainer.train_epoch([batches[i] for i in order], epoch=e,
                               log=lambda *_: None,
                               scan_chunk=tr['scan_chunk']):
            raise RuntimeError('the negative-loss circuit breaker stopped '
                               'the run')

    first = _FirstSteps(trainer, batches, CHECKED_STEPS)
    launches = _Launches(trainer, first) if ctx['trace'] and cuda else None
    for e in range(tr['warmup_epochs']):
        epoch(e)
    if cuda:
        torch.cuda.synchronize()
    if launches is not None:
        launches.spans.unwrap()
    names_numels = [(k, p.numel()) for k, p in model.named_parameters()]
    program = first.record(names_numels)
    e = tr['warmup_epochs']

    # the window
    t0 = time.perf_counter()
    rec = {'setup_s': t0 - ctx['t_start']}
    epochs, ends = 0, []
    while True:
        epoch(e + epochs)
        epochs += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx['seconds']:
            break
    if cuda:
        torch.cuda.synchronize()
    rec.update(window_s=time.perf_counter() - t0, epochs=epochs,
               steps=epochs * n, mols=epochs * n * B, epoch_ends_s=ends)
    e += epochs
    t1 = time.perf_counter()
    rec['span_epoch'] = _span_epoch(lambda: epoch(e), trainer, n, cuda)
    e += 1
    if ctx['trace'] and cuda:
        rec.update(_profiled_epoch(lambda: epoch(e), trainer, ops, n))
    rec['memory_peak_bytes'] = torch.cuda.max_memory_allocated() if cuda \
        else 0
    if ctx['trace'] and cuda:
        t2 = time.perf_counter()
        rec['copy_rates'] = {c: roofline.copy_rate(c, device) for c in
                             sorted({roofline.size_class(b)
                                     for lst in launches.by_sig.values()
                                     for _, b in lst})}
        rec['copy_rates_s'] = time.perf_counter() - t2
        rec.update(_roofline(rec, launches.by_sig, first.sig_of, n))
    # the program's state goes before the reference runs
    del first, launches
    trainer = model = batches = None
    gc.collect()
    torch.cuda.empty_cache()

    rec['after_window_s'] = {'trace': time.perf_counter() - t1}
    t1 = time.perf_counter()

    # the reference, after the window
    rmodel, rvocab = ref_steps.load_model(cfg, root)
    rmodel.to(device)
    theta0 = {k: p.detach().clone() for k, p in rmodel.named_parameters()}
    rrows = ref_steps.read_rows(os.path.join(root, tr['data']), rvocab)
    out = ref_steps.run_steps(
        rmodel, rvocab, cfg,
        [ref_steps.batch_rows(rrows, B, i) for i in program['steps']],
        ref_steps.noise_generator(traffic.noise_seed(seed), device), n)
    reference = {'losses': out['losses'],
                 'grad1': {k: v.cpu() for k, v in out['grad1'].items()},
                 'delta': {k: (out['params'][k] - theta0[k]).cpu()
                           for k in theta0}}
    rec['numbers'] = compare.training_numbers(program, reference)
    rec['numbers_detail'] = compare.details(program, reference)
    rec['checked_steps'] = program['steps']
    followed = ref_steps.follow(
        rmodel, rvocab, cfg,
        [dict(c, rows=ref_steps.batch_rows(rrows, B, c['batch']))
         for c in program['later']],
        ref_steps.noise_generator(traffic.noise_seed(seed), device), n)
    rec['numbers'].update(compare.later_numbers(program['later'], followed))
    rec['later_detail'] = compare.later_details(program['later'], followed)
    rec['step_kinds'] = program['kinds']
    rec['after_window_s']['reference'] = time.perf_counter() - t1
    t1 = time.perf_counter()
    if ctx['trace']:
        rec['flops_per_epoch'] = sum(flops.batch_flops(
            rmodel, rvocab, cfg, [ref_steps.batch_rows(rrows, B, i)
                                  for i in range(n)],
            os.path.join(root, 'build', 'benchmark')))
        rec['after_window_s']['flops'] = time.perf_counter() - t1
    return rec


def _wrap_calls(trainer, spans: Spans, sync=None) -> None:
    spans.wrap(trainer, 'host_batch', 'host_batch')
    spans.wrap(trainer, 'device_batch', 'device_batch', before=sync)
    spans.wrap(trainer, 'train_step', 'train_step', group='step', before=sync)
    spans.wrap(trainer, 'scan_steps', 'scan_steps', group='step', before=sync)


def _span_epoch(run_epoch, trainer, n: int, cuda: bool) -> Dict:
    """One epoch with spans around the trainer's calls (``host_batch``,
    ``device_batch``, ``train_step``, ``scan_steps``), the device
    synchronised before each call that waits on it (an upload, an eager
    step), so that a span holds the call's own time: its wall time, its
    steps and the spans' seconds and calls."""
    spans = Spans()
    _wrap_calls(trainer, spans, torch.cuda.synchronize if cuda else None)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_epoch()
    if cuda:
        torch.cuda.synchronize()
    spans.unwrap()
    return {'wall_s': time.perf_counter() - t0, 'steps': n,
            'spans': dict(spans.seconds), 'calls': dict(spans.calls)}


def _profiled_epoch(run_epoch, trainer, ops, n: int) -> Dict:
    """One epoch under ``torch.profiler`` tracing the device alone (its
    host cost is the launches' records, not every operator's), the
    trainer's calls timed as host spans on the profiler's clock (nothing
    synchronised); the reduced trace and the launches that ran, by the
    kernels' own device counts."""
    from torch.profiler import ProfilerActivity, profile
    spans = Spans()
    spans.intervals = []
    _wrap_calls(trainer, spans)
    before = ops.device_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.time_ns()
        run_epoch()
        torch.cuda.synchronize()
        w1 = time.time_ns()
    spans.unwrap()
    after = ops.device_launches()
    red = trace.reduce(prof, (w0, w1), spans.intervals)
    del prof
    return {'trace': red, 'trace_steps': n,
            'launches_ran': {k: after[k] - before[k] for k in after}}


def _roofline(rec: Dict, by_sig: Dict, sig_of: Dict, n: int) -> Dict:
    """Per port kernel, the least seconds its launches of the profiled
    epoch could take (each batch's launches those of its signature's
    eager step) and which peak bounds them, and the launches counted so."""
    bound, counted, by = {}, {}, {}
    for i in range(n):
        for kernel, nbytes in by_sig.get(sig_of[i], []):
            s, peak = roofline.bound_s(nbytes, rec['copy_rates'])
            bound[kernel] = bound.get(kernel, 0.0) + s
            counted[kernel] = counted.get(kernel, 0) + 1
            by.setdefault(kernel, {}).setdefault(peak, 0)
            by[kernel][peak] += 1
    shares = {}
    for k, s in bound.items():
        kt, ran = rec['trace']['kernels'].get(k), rec['launches_ran'][k]
        if kt and kt['records'] and ran:
            shares[k] = 100.0 * (s / counted[k]) / (kt['seconds'] /
                                                   kt['records'])
    return {'bound_s': bound, 'launches_counted': counted, 'bound_by': by,
            'kernel_shares': shares,
            'copy_rate_max': max(rec['copy_rates'].items(),
                                 key=lambda x: x[1], default=None)}
