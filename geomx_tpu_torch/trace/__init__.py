"""Cross-tier distributed tracing over the HiPS tree.

Causal spans (trace_id / span_id / parent_span_id carried on every
``Message``) connect one synchronization round's
push → local-merge → WAN → global-merge → pull chain across every node
role; a collector on the global scheduler merges all parties' spans into
one Chrome-trace/perfetto timeline (clock-corrected from heartbeat RTTs)
and distills a per-round critical-path report.

Off by default (``Config.trace_sample_every = 0``): every hot-path hook
gates on one module flag and the span factory returns a shared no-op, so
the disabled path adds no per-message work.  Sampling every N-th round
bounds the overhead when it is on.  While ``torch.profiler`` records,
spans record too, traceless outside a sampled round, stamped on the
profiler's host clock: :func:`recorded_spans` returns them, to be laid
beside the device's events of the profiler's trace.

See docs/tracing.md for usage.
"""

from geomx_tpu_torch.trace import context
from geomx_tpu_torch.trace.context import (TraceContext, activate, new_span_id,
                                     trace_id_for_round)
from geomx_tpu_torch.trace.recorder import Tracer, get_tracer, recorded_spans


def get_collector(postoffice):
    """Construct the scheduler-side collector (lazy import: the
    collector pulls in the ps layer, which instruments back into us)."""
    from geomx_tpu_torch.trace.collector import TraceCollector

    return TraceCollector(postoffice)


class PhaseTracer:
    """Test/soak helper: bracket coarse phases of a long-running test as
    root spans so a flake's dumped timeline shows which phase stalled.

    Activates tracing (phases are always sampled), records each phase as
    its own root trace on a synthetic node, and ``dump()`` writes a
    self-contained Chrome-trace JSON artifact.
    """

    def __init__(self, name: str):
        activate()
        self.name = name
        self.tracer = get_tracer(f"test:{name}")
        self._n = 0
        self._open = None

    def phase(self, label: str):
        self._n += 1
        span = self.tracer.round(self._n - 1, 1)
        span.name = f"phase.{label}"
        return span

    def begin(self, label: str) -> None:
        """Linear alternative to ``with phase(...)`` for long soak
        bodies: closes the previous phase and opens the next — no
        re-indentation of existing test code."""
        self.end()
        self._open = self.phase(label)
        self._open.__enter__()

    def end(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None

    def mark(self, label: str, **extra):
        self.tracer.instant(f"mark.{label}", **extra)

    def dump(self, path: str = "") -> str:
        """Write the phase timeline artifact; defaults under
        $GEOMX_TEST_TRACE_DIR (or /tmp/geomx_trace_tests)."""
        self.end()
        if not path:
            import os

            d = os.environ.get("GEOMX_TEST_TRACE_DIR",
                               "/tmp/geomx_trace_tests")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{self.name}.json")
        self.tracer.profiler.dump(path)
        return path


__all__ = ["TraceContext", "Tracer", "PhaseTracer", "activate",
           "context", "get_collector", "get_tracer", "new_span_id",
           "recorded_spans", "trace_id_for_round"]
