"""Read-serving replica tier: staleness-bounded model subscribers
serving high-QPS pull/predict traffic under concurrent training, plus
the self-healing serving plane around them — liveness-aware client
load balancing, explicit admission-control load shedding, and replica
autoscaling.

See docs/serving.md for the operator guide.
"""

from geomx_tpu_torch.serve.autoscaler import ReplicaAutoscaler
from geomx_tpu_torch.serve.balancer import ServeBalancer
from geomx_tpu_torch.serve.client import ReplicaClient, ReplicaError
from geomx_tpu_torch.serve.monitor import ReplicaMonitor
from geomx_tpu_torch.serve.replica import ModelReplica

__all__ = ["ModelReplica", "ReplicaAutoscaler", "ReplicaClient",
           "ReplicaError", "ReplicaMonitor", "ServeBalancer"]
