"""Worker loop: the port's ``worker.d2h`` and ``worker.h2d`` spans (the
gradients or weights to the host, the pulled weights back) in the
traced rounds, in ms a worker-step (program span)."""

from geobench import program_spans as ps


def read(run):
    copies = ps.named(ps.spans(run) or [], "worker.d2h", "worker.h2d")
    if not copies:
        return None
    return sum(s.dur for s in copies) / ps.worker_steps(run) / 1e3
