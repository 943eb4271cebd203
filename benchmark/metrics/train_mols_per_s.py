"""Molecules stepped in the window over the window's wall time (the host's
clock, from a device synchronisation before the first epoch to one after
the last)."""


def read(rec):
    if not rec.get('window_s') or 'mols' not in rec:
        return None
    return rec['mols'] / rec['window_s']
