"""Tracing, profiling and diagnostics (counterpart of
``ggpm_tpu/train/profiling.py``).

* ``trace`` — a ``torch.profiler`` trace of the block, written as a Chrome
  trace that Perfetto and TensorBoard open;
* ``named_scope`` — a named range in that trace and, on the card, an NVTX
  range;
* ``Throughput`` — steps/s and molecules/s, timed to the device's end;
* ``enable_nan_checks`` — autograd's anomaly detection behind a flag;
* ``param_norm`` / ``grad_norm`` — the reference's printed diagnostics.

``trace_server`` (the JAX package's ``jax.profiler.start_server``) has no
PyTorch counterpart: it raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, Iterator, Optional, Union

import torch

Tensors = Union[torch.nn.Module, Iterable[torch.Tensor]]


def trace_server(port: int = 9999) -> None:
    """The JAX package starts a profiler server that TensorBoard attaches
    to; PyTorch has no such server.  Use ``trace`` instead."""
    raise NotImplementedError(
        f'trace_server(port={port}): torch.profiler has no server that '
        'TensorBoard attaches to; capture a trace with trace(log_dir)')


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the CPU, and the card where one is present) and
    write its Chrome trace to ``log_dir/trace.<pid>.json`` on exit; the
    file's path is ``prof.trace_path`` afterwards."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f'trace.{os.getpid()}.json')
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def named_scope(name: str) -> Iterator[None]:
    """A named range of the trace (``record_function``) and, where the
    card is present, an NVTX range around the block."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
