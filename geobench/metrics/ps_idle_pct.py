"""PS runtime: the share of the traced span in which the device is idle
(no kernel, copy or memset) while a span of a server (``local.*``,
``global.*``, ``codec.*``) is open on some thread: the device waiting on
the PS runtime's host path.  At most ``device_idle_pct`` of the same
run (program span)."""

from geobench import program_spans as ps


def read(run):
    tr, sp = run.trace, ps.spans(run)
    if not sp or tr.window_us <= 0:
        return None
    server = ps.union((s.t0, s.t1) for s in sp
                      if s.name.startswith(ps.SERVER_PREFIXES))
    if not server:
        return None
    idle = ps.overlap_us(ps.idle_intervals(tr), server)
    return 100.0 * idle / tr.window_us
