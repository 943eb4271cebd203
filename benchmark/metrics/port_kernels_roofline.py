"""The port's hand-written kernels' (K1 ``nei_sum``, K2 ``transpose_sum``,
K3 ``gather_rows``) share of their roofline in the traced epoch, in
percent: the least seconds their launches could take over the seconds
they took.

Each launch's least time is its bytes over the larger of HBM's rate and
the L2-resident copy rate at its working-set size (``yardstick.roofline``).
The seconds they took are each kernel's launches that ran (the kernels'
own device counts) times its mean record in the profiler's trace, which
loses a record now and then; the least seconds are scaled alike, from
the launches the harness recorded to those that ran.  Nothing where the
epoch launched none of them."""


def read(rec):
    bound = rec.get('bound_s')
    tr = rec.get('trace')
    if not bound or not tr:
        return None
    least = spent = 0.0
    for k, s in bound.items():
        kt = tr['kernels'].get(k)
        ran = rec['launches_ran'][k]
        if not kt or not kt['records'] or not ran:
            return None
        least += s * ran / rec['launches_counted'][k]
        spent += ran * kt['seconds'] / kt['records']
    return 100.0 * least / spent
