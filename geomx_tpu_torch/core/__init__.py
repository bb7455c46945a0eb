from geomx_tpu_torch.core.config import Config, Role, Topology, NodeId  # noqa: F401
