"""Shared scheduler-side telemetry endpoint.

The global scheduler serves no data traffic, so its PS app id is free
for telemetry: ``Ctrl.TRACE_REPORT`` (PR 3), ``Ctrl.METRICS_REPORT``
and ``Ctrl.CLUSTER_STATE`` frames all arrive as requests on
``(APP_PS, customer 0)``.  A Customer can only register once per
postoffice, so every collector shares ONE endpoint that routes inbound
frames by their ``Ctrl`` head: :func:`get_endpoint` is get-or-create on
the postoffice, and ``acquire``/``release`` refcount the customer's
lifetime — the trace collector, metrics collector and cluster-state
service stop independently, in any order.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict


class TelemetryEndpoint:
    """Owner of the PS app on a scheduler postoffice; routes request
    frames to the handler registered for their ``cmd`` head."""

    def __init__(self, postoffice):
        from geomx_tpu_torch.kvstore.common import APP_PS
        from geomx_tpu_torch.ps.customer import Customer

        self.po = postoffice
        self._mu = threading.Lock()
        self._routes: Dict[int, Callable] = {}
        self._refs = 0
        self._stopped = False
        self._customer = Customer(APP_PS, 0, self._on_msg, postoffice,
                                  owns_app=True)

    def route(self, cmd, handler: Callable) -> None:
        """Register ``handler(msg)`` for request frames with this head."""
        with self._mu:
            self._routes[int(cmd)] = handler

    def _on_msg(self, msg):
        if not msg.request:
            return
        with self._mu:
            fn = self._routes.get(int(msg.cmd))
        if fn is not None:
            fn(msg)
        # anything else addressed at the scheduler's PS app is dropped —
        # the scheduler serves no data traffic

    def acquire(self) -> "TelemetryEndpoint":
        with self._mu:
            self._refs += 1
        return self

    def release(self) -> None:
        """Drop one reference; the customer stops when the last
        collector has released (idempotent past that point)."""
        with self._mu:
            self._refs -= 1
            if self._refs > 0 or self._stopped:
                return
            self._stopped = True
        self._customer.stop()


def get_endpoint(postoffice) -> TelemetryEndpoint:
    """Get-or-create the postoffice's shared telemetry endpoint (one
    per postoffice for its whole lifetime — Customer registrations are
    permanent).  Callers ``acquire()`` it and ``release()`` on stop."""
    ep = getattr(postoffice, "_telemetry_endpoint", None)
    if ep is None:
        ep = TelemetryEndpoint(postoffice)
        postoffice._telemetry_endpoint = ep
    return ep
