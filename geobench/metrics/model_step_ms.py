"""Model step: the mean of the port's ``worker.grad`` span in the traced
rounds, one a worker-step: the forward, the backward and, under HFA,
the local optimizer's update, closed on the device (program span)."""

from geobench import program_spans as ps


def read(run):
    sp = ps.spans(run)
    grads = ps.named(sp or [], "worker.grad")
    if not grads:
        return None
    return sum(s.dur for s in grads) / len(grads) / 1e3
