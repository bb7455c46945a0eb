"""Merge, optimizer and codec stage: device time of the codec kernels,
the DGC update and BSC's top-k and sorts in the traced rounds, in ms a
round."""

from geobench.kernel_groups import group

GROUPS = ("dgc_update", "codec_kernels", "bsc_topk")


def read(run):
    tr = run.trace
    if tr is None or not tr.rounds:
        return None
    us = tr.device_us(lambda name: group(name) in GROUPS)
    if us <= 0:
        return None
    return us / 1e3 / tr.rounds
