"""Worker loop: the ``bytes`` the port's ``worker.d2h`` and
``worker.h2d`` spans carry in the traced rounds, in MB a worker-step
(program counter)."""

from geobench import program_spans as ps


def read(run):
    copies = ps.named(ps.spans(run) or [], "worker.d2h", "worker.h2d")
    if not copies:
        return None
    total = sum(int(s.args.get("bytes", 0)) for s in copies)
    return total / ps.worker_steps(run) / 1e6
