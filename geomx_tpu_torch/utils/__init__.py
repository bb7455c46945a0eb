from geomx_tpu_torch.utils.profiler import Profiler, get_profiler  # noqa: F401
from geomx_tpu_torch.utils.measure import Measure, aggregate_reports  # noqa: F401
from geomx_tpu_torch.utils import metrics  # noqa: F401
