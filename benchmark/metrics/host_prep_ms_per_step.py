"""Host milliseconds a step spends preparing its batch: the spans around
``Trainer.host_batch`` (the model-batch dict, its plan lane-packed) and
``Trainer.device_batch`` (the training tables, uploaded), each upload
timed from a device synchronisation, over the steps of the traced run's
span epoch."""


def read(rec):
    ep = rec.get('span_epoch')
    if not ep or 'host_batch' not in ep['spans']:
        return None
    s = ep['spans']
    return 1e3 * (s['host_batch'] + s.get('device_batch', 0.0)) / ep['steps']
