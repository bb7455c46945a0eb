from geomx_tpu_torch.kvstore.common import Cmd, Ctrl, APP_PS  # noqa: F401
from geomx_tpu_torch.kvstore.client import WorkerKVStore  # noqa: F401
from geomx_tpu_torch.kvstore.server import LocalServer, GlobalServer  # noqa: F401
from geomx_tpu_torch.kvstore.sim import Simulation  # noqa: F401
