"""The reduction of a ``torch.profiler`` trace of the device to what the
per-layer metrics read, from the profiler's raw records (``key_averages``
builds a Python object a record, far too slow for an epoch's hundreds of
thousands).

The traced window is a stretch of the host's UNIX clock in nanoseconds
(the profiler's time base), begun after the device has finished earlier
work and ended after it has finished the window's.  Device busy time is
the union of the device's records (kernels, copies, fills) inside it; an
idle gap is a stretch of the window where the device runs nothing, named
by the innermost host span of the harness (``spans.Spans.intervals``)
open at its middle (``host outside the harness spans`` where none is).  The port's kernels are told apart by the names of their ``__global__``
functions in their sources (``csrc/<name>.cu``); a kernel renamed there
goes silent here (no record), and its metric with it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

# each port kernel's ``__global__`` functions (csrc/<kernel>.cu)
PORT_KERNELS = {'nei_sum': ('nei_sum_kernel',),
                'transpose_sum': ('transpose_sum_kernel',),
                'gather_rows': ('gather_wide', 'gather_by_row')}
OUTSIDE = 'host outside the harness spans'


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, 'start_ns') else int(e.start_us() * 1e3)


def port_kernel(name: str):
    """Which port kernel a device record's name is, or None."""
    for k, functions in PORT_KERNELS.items():
        if any(f in name for f in functions):
            return k
    return None


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(prof, window: Tuple[int, int],
           host: List[Tuple[int, int, str]], top: int = 10) -> Dict:
    """``busy_s``, ``window_s``, ``top_ops`` and ``idle_gaps`` (each a list
    of ``[name, seconds]``, largest first, at most ``top``), ``kernels``
    (per port kernel: ``records`` and ``seconds``) and ``outside_s`` (the
    device's record time that falls outside the window) of a profile of
    the device over ``window`` (UNIX ns), with the host spans ``host``."""
    from torch.autograd import DeviceType
    device = []
    for e in prof.profiler.kineto_results.events():
        d = e.duration_ns()
        if e.device_type() == DeviceType.CUDA and d > 0 and \
                not e.is_user_annotation():
            s = _start_ns(e)
            device.append((s, s + d, e.name()))
    w0, w1 = window
    ops, kernels = defaultdict(int), defaultdict(lambda: [0, 0])
    inside, outside = [], 0
    for s, e, name in device:
        s0, e0 = s, e
        s, e = max(s, w0), min(e, w1)
        outside += (e0 - s0) - max(0, e - s)
        if e <= s:
            continue
        inside.append((s, e))
        ops[name] += e - s
        k = port_kernel(name)
        if k:
            kernels[k][0] += 1
            kernels[k][1] += e - s
    busy = _merge(inside)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted(host)
    idle = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        best = None
        for s, e, name in host:
            if s > mid:
                break
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        idle[best[2] if best else OUTSIDE] += b - a

    def ranked(d):
        return [[k[:120], v / 1e9] for k, v in
                sorted(d.items(), key=lambda x: -x[1])[:top]]
    return {'busy_s': sum(e - s for s, e in busy) / 1e9,
            'window_s': (w1 - w0) / 1e9,
            'outside_s': outside / 1e9,
            'top_ops': ranked(ops), 'idle_gaps': ranked(idle),
            'kernels': {k: {'records': v[0], 'seconds': v[1] / 1e9}
                        for k, v in kernels.items()}}
