"""The whole step's share of the card's float32 peak while the device
works, in percent: the model FLOPs of the traced epoch (each batch's
forward and backward counted by the reference at its own unpadded sizes;
the epoch takes every batch once) over the device's busy time in that
epoch (the union of the profiler's device records), against 67 TFLOP/s,
the H100's float32 rate outside the tensor cores (the configurations
compute in float32 with TF32 off).  Host time and idle gaps do not
enter it: ``device_idle_share`` reads those."""

from ..yardstick.roofline import PEAKS


def read(rec):
    tr = rec.get('trace')
    if not rec.get('flops_per_epoch') or not tr or tr['busy_s'] <= 0:
        return None
    return 100.0 * rec['flops_per_epoch'] / tr['busy_s'] / \
        PEAKS['fp32_flops_per_s']
