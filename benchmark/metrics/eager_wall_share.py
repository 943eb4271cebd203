"""Percent of the traced run's span epoch spent inside ``Trainer.train_step``
calls, the steps that run eagerly (an epoch's flush of one batch),
each timed from a device synchronisation, where every other step replays
a captured CUDA graph."""


def read(rec):
    ep = rec.get('span_epoch')
    if not ep or 'scan_steps' not in ep['spans']:
        return None
    return 100.0 * ep['spans'].get('train_step', 0.0) / ep['wall_s']
