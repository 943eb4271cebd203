"""Tracing, profiling and diagnostics (counterpart of
``ggpm_tpu/train/profiling.py``).

* ``recording`` — spans and counters of the training loop, kept in
  memory (``Recording``) and read at the end, on the UNIX clock in
  nanoseconds that ``torch.profiler``'s records carry, so that a gap of
  the device's timeline can be named by the span open at its middle;
* ``trace`` — a ``torch.profiler`` trace of the block, written as a Chrome
  trace that Perfetto and TensorBoard open;
* ``named_scope`` — a span of the recording and, inside ``trace``, a named
  range of the trace and, on the card, an NVTX range; with neither on it
  costs one check of a module variable, and reads no clock;
* ``at_step``, ``tag`` and ``count`` — the step a span belongs to, and the
  recording's counters;
* ``Throughput`` — steps/s and molecules/s, timed to the device's end;
* ``enable_nan_checks`` — autograd's anomaly detection behind a flag;
* ``param_norm`` / ``grad_norm`` — the reference's printed diagnostics.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Tuple,
                    Union)

import torch

Tensors = Union[torch.nn.Module, Iterable[torch.Tensor]]
# a span's step: (epoch, the batch's index in it), the index None for the
# epoch's own spans
Step = Tuple[int, Optional[int]]

# the recorder's clock: the profiler's time base
_clock = time.time_ns


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` on ``_clock``, the
    index of its ``parent`` in ``Recording.spans`` (-1 at the top) and its
    ``step`` (``Step``), which it shares with its step's other spans."""
    __slots__ = ('name', 'start_ns', 'end_ns', 'parent', 'step')

    def __init__(self, name: str, start_ns: int, parent: int,
                 step: Optional[Step]):
        self.name, self.start_ns, self.end_ns = name, start_ns, start_ns
        self.parent, self.step = parent, step

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recording:
    """What ``recording`` recorded: ``spans`` in the order they opened,
    and ``counters``, integer counts by name.  Nothing is written while
    it records; read it at the end."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._open: List[int] = []
        self._step: Optional[Step] = None
        self._tags: Dict[int, Step] = {}

    def _begin(self, name: str, batch: Any) -> int:
        step = self._step if batch is None else \
            self._tags.get(id(batch), self._step)
        self.spans.append(Span(name, _clock(),
                               self._open[-1] if self._open else -1, step))
        self._open.append(len(self.spans) - 1)
        return self._open[-1]

    def _end(self, i: int) -> None:
        self.spans[i].end_ns = _clock()
        if self._open[-1] == i:
            self._open.pop()
        else:
            self._open.remove(i)

    def seconds(self) -> Dict[str, float]:
        """Each span name's seconds, summed over its spans."""
        out = defaultdict(float)
        for s in self.spans:
            out[s.name] += s.seconds
        return dict(out)

    def self_seconds(self) -> Dict[str, float]:
        """Each span name's self seconds: its spans' seconds less those of
        their children."""
        out = defaultdict(float)
        for s in self.spans:
            out[s.name] += s.seconds
            if s.parent >= 0:
                out[self.spans[s.parent].name] -= s.seconds
        return dict(out)

    def calls(self) -> Dict[str, int]:
        """How many spans of each name."""
        out = defaultdict(int)
        for s in self.spans:
            out[s.name] += 1
        return dict(out)

    def intervals(self) -> List[Tuple[int, int, str]]:
        """Each span as ``(start_ns, end_ns, name)``: the host intervals by
        which a trace of the device names its idle gaps."""
        return [(s.start_ns, s.end_ns, s.name) for s in self.spans]

    def summary(self) -> Dict[str, Dict]:
        """``seconds``, ``self_seconds`` and ``calls`` by span name, and
        the ``counters``."""
        return dict(seconds=self.seconds(), self_seconds=self.self_seconds(),
                    calls=self.calls(), counters=dict(self.counters))


# the recording on, or None
_recording: Optional[Recording] = None
# how many ``trace`` blocks are open
_tracing = 0
# what a scope does: None when neither a recording nor a trace is on (the
# one check a scope then costs), else (the recording or None, whether to
# annotate the trace)
_on: Optional[Tuple[Optional[Recording], bool]] = None


def _update() -> None:
    global _on
    _on = None if _recording is None and not _tracing else \
        (_recording, _tracing > 0)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the spans and counters of the block (one recording at a
    time) into the ``Recording`` it yields."""
    global _recording
    if _recording is not None:
        raise RuntimeError('a recording is already on')
    _recording = Recording()
    _update()
    try:
        yield _recording
    finally:
        _recording = None
        _update()


def current() -> Optional[Recording]:
    """The recording on, or None."""
    return _recording


def at_step(epoch: int, index: Optional[int] = None) -> None:
    """While recording: the spans opened from here on belong to batch
    ``index`` of ``epoch`` (to the epoch itself where None)."""
    if _recording is not None:
        _recording._step = (epoch, index)


def tag(batch: Any) -> None:
    """While recording: ``batch`` (any object, by identity) belongs to the
    current step (``at_step``), for the spans that name it later."""
    if _recording is not None and batch is not None:
        _recording._tags[id(batch)] = _recording._step


def count(name: str, n: int = 1) -> None:
    """While recording: add ``n`` to the counter ``name``."""
    if _recording is not None:
        _recording.counters[name] += n


class _Scope:
    __slots__ = ('name', 'batch', 'rec', 'index', 'fn')

    def __init__(self, name: str, batch: Any):
        self.name, self.batch = name, batch

    def __enter__(self):
        self.rec, annotate = _on
        self.fn = None
        if annotate:
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(self.name)
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        if self.rec is not None:
            self.index = self.rec._begin(self.name, self.batch)
        return self

    def __exit__(self, *exc) -> bool:
        if self.rec is not None:
            self.rec._end(self.index)
        if self.fn is not None:
            self.fn.__exit__(*exc)
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_pop()
        return False


_OFF = contextlib.nullcontext()


def named_scope(name: str, batch: Any = None):
    """A context around a block: a span ``name`` of the recording on
    (its step ``batch``'s, where ``tag`` gave it one, else the current
    one), and, inside ``trace``, a named range of the trace
    (``record_function``) and, where the card is present, an NVTX range.
    With neither on it does nothing."""
    if _on is None:
        return _OFF
    return _Scope(name, batch)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the CPU, and the card where one is present) and
    write its Chrome trace to ``log_dir/trace.<pid>.json`` on exit; the
    file's path is ``prof.trace_path`` afterwards.  Each ``named_scope``
    inside is a named range of it."""
    global _tracing
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _tracing += 1
        _update()
        try:
            yield prof
        finally:
            _tracing -= 1
            _update()
    prof.trace_path = os.path.join(log_dir, f'trace.{os.getpid()}.json')
    prof.export_chrome_trace(prof.trace_path)


def enable_nan_checks(enable: bool = True) -> None:
    """Raise in the backward pass at the operation that made a NaN
    (``torch.autograd.set_detect_anomaly``; the JAX package's
    ``jax_debug_nans``)."""
    torch.autograd.set_detect_anomaly(enable)


def _tensors(x: Tensors):
    return x.parameters() if isinstance(x, torch.nn.Module) else x


def param_norm(params: Tensors) -> float:
    """The global norm of a model's parameters (or of tensors), summed in
    float64."""
    total = torch.zeros((), dtype=torch.float64)
    for t in _tensors(params):
        total += t.detach().double().square().sum().cpu()
    return float(total.sqrt())


def grad_norm(grads: Tensors) -> float:
    """The global norm of a model's gradients (its parameters' ``.grad``,
    a parameter without one counting as zero), or of gradient tensors."""
    if isinstance(grads, torch.nn.Module):
        grads = [p.grad for p in grads.parameters() if p.grad is not None]
    return param_norm(grads)


class Throughput:
    """Steps/s and molecules/s since ``reset``.  On the card the clock is
    read after ``torch.cuda.synchronize(device)``, so the rate counts the
    device's work, not only its dispatch."""

    def __init__(self, window: int = 50,
                 device: Optional[Union[str, torch.device]] = None):
        self.window = window
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def _now(self) -> float:
        if self.device is not None and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def reset(self) -> None:
        self.t0 = self._now()
        self.steps = 0
        self.mols = 0

    def update(self, n_mols: int) -> None:
        self.steps += 1
        self.mols += n_mols

    def rates(self) -> Dict[str, float]:
        dt = max(self._now() - self.t0, 1e-9)
        return {'steps_per_sec': self.steps / dt,
                'mols_per_sec': self.mols / dt}
