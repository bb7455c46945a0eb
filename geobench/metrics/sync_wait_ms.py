"""PS runtime: ``Measure``'s ``push`` and ``pull_wait`` phases, summed
over the window and divided by its worker-steps (both close on the
worker's ``kv.wait_all()``)."""


def read(run):
    ph = run.result["phases"]
    total = sum(ph.get("push", [])) + sum(ph.get("pull_wait", []))
    steps = run.result["worker_steps"]
    if not steps or not (ph.get("push") or ph.get("pull_wait")):
        return None
    return 1e3 * total / steps
