"""Spans the harness records around the program's calls: the host
seconds inside each named call and how many calls, kept in memory.

``Spans.wrap(obj, attr, name)`` replaces a bound method or a module's
function by one that times each call; calls of one ``group`` do not
nest (an inner call, as a ``train_step`` under ``scan_steps`` on the
CPU, is left to the outer one).  ``before``, where given, runs ahead of
the clock (a device synchronisation, so that a span times the call and
not the device work queued before it).  ``after`` is called with each outer call's result and
arguments.  With ``intervals`` a list, each outer call's ``(start, end,
name)`` is appended to it on the UNIX clock in nanoseconds, the time
base of ``torch.profiler``'s records, so that a trace of the device
alone can say what the host was doing in a gap of its timeline.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Optional

class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.intervals = None
        self._depth = defaultdict(int)
        self._undo = []

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()

    def wrap(self, obj, attr: str, name: str, group: Optional[str] = None,
             after: Optional[Callable] = None,
             before: Optional[Callable] = None) -> None:
        orig = getattr(obj, attr)
        group = group or name

        def call(*args, **kwargs):
            if self._depth[group]:
                return orig(*args, **kwargs)
            self._depth[group] += 1
            if before is not None:
                before()
            t0, ns0 = time.perf_counter(), time.time_ns()
            try:
                out = orig(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                if self.intervals is not None:
                    self.intervals.append((ns0, time.time_ns(), name))
                self.calls[name] += 1
                self._depth[group] -= 1
            if after is not None:
                after(out, args)
            return out

        self.replace(obj, attr, call)

    def replace(self, obj, attr: str, fn) -> None:
        """Put ``fn`` in place of ``obj.attr`` until ``unwrap``."""
        self._undo.append((obj, attr, vars(obj).get(attr)))
        setattr(obj, attr, fn)

    def unwrap(self) -> None:
        """Put back what ``wrap`` and ``replace`` replaced, newest first
        (an instance's method by deleting the instance's own)."""
        for obj, attr, old in reversed(self._undo):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
        self._undo.clear()
