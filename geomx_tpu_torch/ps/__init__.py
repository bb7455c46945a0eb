from geomx_tpu_torch.ps.postoffice import Postoffice, KeyRange  # noqa: F401
from geomx_tpu_torch.ps.customer import Customer  # noqa: F401
from geomx_tpu_torch.ps.kv_app import KVWorker, KVServer, KVPairs  # noqa: F401
