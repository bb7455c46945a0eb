from geomx_tpu_torch.transport.message import Message, Control, Domain  # noqa: F401
from geomx_tpu_torch.transport.van import Van, InProcFabric, FaultPolicy  # noqa: F401
