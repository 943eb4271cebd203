"""Milliseconds a step in which the device runs anything: the union of
the profiler's device records over the traced epoch, over its steps."""


def read(rec):
    tr = rec.get('trace')
    if not tr or not rec.get('trace_steps') or tr['busy_s'] <= 0:
        return None
    return 1e3 * tr['busy_s'] / rec['trace_steps']
