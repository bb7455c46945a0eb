"""Cluster-wide telemetry plane (the operational complement to HiPS).

Three coupled pieces, all beyond the reference (whose monitoring story
is per-process profiler dumps):

- **time-series shipping** — a per-node :class:`MetricsPump` samples
  the system-metrics registry + role stats on an interval and
  fire-and-forget ships ``Ctrl.METRICS_REPORT`` frames (the PR 3
  TRACE_REPORT path) to a :class:`MetricsCollector` on the global
  scheduler, which keeps ring-buffered per-node series, feeds perfetto
  counter tracks into the merged trace JSON, and dumps a
  Prometheus-style text exposition;
- **SLO health engine** — :class:`HealthEngine` evaluates stall/lag/
  imbalance/goodput/RTT/fence rules over the collected series and
  emits structured alert + recovery records (JSON log, registry
  counters, ``health.alert`` trace instants, stdout);
- **cluster-state console** — :class:`ClusterStateService` answers
  ``Ctrl.CLUSTER_STATE`` with the merged live state (shard
  holders/terms, party folds, heartbeat freshness, policy epoch,
  active alerts, pressure column), rendered by ``python -m
  geomx_tpu_torch.status`` and ``Simulation.cluster_state()``;
- **black-box flight recorder** — :class:`FlightRecorder`
  (obs/flight.py, DEFAULT ON) keeps a fixed-size per-node event ring
  (message heads, fences, barriers, membership/failover transitions,
  round open/complete, sampled pressure) dumped to ``GEOMX_OBS_DIR``
  on exit/signal, health-alert incidents (``Control.FLIGHT_DUMP``
  broadcast) and operator request; ``python -m
  geomx_tpu_torch.obs.postmortem`` assembles the dumps into one
  clock-rebased causal timeline + stall report.

The pump/collector/health plane is off by default
(``Config.enable_obs = False``): no pump, no collector, no threads, no
frames — the disabled path is one flag check at construction time.
See docs/observability.md.
"""

from geomx_tpu_torch.obs.collector import MetricsCollector
from geomx_tpu_torch.obs.endpoint import TelemetryEndpoint, get_endpoint
from geomx_tpu_torch.obs.flight import (FlightEv, FlightRecorder,
                                  broadcast_flight_dump,
                                  install_process_hooks)
from geomx_tpu_torch.obs.health import HealthEngine
from geomx_tpu_torch.obs.pump import MetricsPump
from geomx_tpu_torch.obs.state import ClusterStateService, render_text

__all__ = ["ClusterStateService", "FlightEv", "FlightRecorder",
           "HealthEngine", "MetricsCollector", "MetricsPump",
           "TelemetryEndpoint", "broadcast_flight_dump", "get_endpoint",
           "install_process_hooks", "render_text"]
