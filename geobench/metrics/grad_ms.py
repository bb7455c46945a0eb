"""Worker loop: the mean of ``Measure``'s ``grad`` phase a worker-step in
the window.  Under FSA the phase closes on the per-leaf D2H that waits
for the backward pass, so it holds the whole model step."""

from geobench.harness import mean


def read(run):
    xs = run.result["phases"].get("grad")
    if not xs or run.cell.cell["loop"] != "fsa":
        return None
    return 1e3 * mean(xs)
