"""geomx_tpu_torch — the GeoMX hierarchical parameter server on PyTorch
and CUDA.

The host runtime (transport, PS core, both server tiers, codecs, control
and telemetry planes) is the same code as the JAX package's, kept as a
copy; the device side — the merge backend, the device optimizer, the WAN
codec stage, the worker's model — is PyTorch, and every kernel the JAX
package wrote in Pallas is a hand CUDA C++ kernel for Hopper, built
with ``nvcc``: the WAN codec's 2-bit quantize and dequantize and its
DGC update (``csrc/quantize.cu``, via
:mod:`geomx_tpu_torch.ops.kernels.quantize_cuda`), flash attention and
the ring hop's block attention (``csrc/flash_attention.cu`` and
``csrc/block_attention.cu``).  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from geomx_tpu_torch.core.config import Config, Role, Topology  # noqa: F401


def __getattr__(name):
    # resolve_device imports torch: the host-only command-line tools
    # (serve.load, status, obs.postmortem) import this package and must
    # start as fast as the JAX package's (2.5 s of torch import delayed
    # scripts/run_serve_demo.sh's reads past its replica kill)
    if name == "resolve_device":
        from geomx_tpu_torch.core.platform import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
