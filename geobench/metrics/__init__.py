"""Per-layer metric readers, one module a metric, named as in
``BENCHMARK.json``.  Each has ``read(run) -> float or None``; ``run`` is
a :class:`geobench.run.RunData`.  A reader that finds nothing to read
returns None and the metric is left out of the result line."""
