"""Device: the share of the traced rounds' wall time in which no
kernel, copy or memset ran (one minus the union of their intervals over
the span)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_us <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
