"""Percent of the traced epoch's wall time in which the device runs
nothing: the gaps of its timeline in the profiler's trace."""


def read(rec):
    tr = rec.get('trace')
    if not tr or tr['window_s'] <= 0 or tr['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
