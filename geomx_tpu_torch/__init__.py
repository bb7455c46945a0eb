"""geomx_tpu_torch — the GeoMX hierarchical parameter server on PyTorch
and CUDA.

The host runtime (transport, PS core, both server tiers, codecs, control
and telemetry planes) is the same code as the JAX package's, kept as a
copy; the device side — the merge backend, the device optimizer, the WAN
codec stage, the worker's model — is PyTorch, and the three WAN codec
kernels are hand-written Triton kernels for Hopper
(:mod:`geomx_tpu_torch.ops.kernels.quantize_triton`).  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

from geomx_tpu_torch.core.config import Config, Role, Topology  # noqa: F401
from geomx_tpu_torch.core.platform import resolve_device  # noqa: F401
