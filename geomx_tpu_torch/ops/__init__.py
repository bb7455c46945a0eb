"""Codec kernels of the WAN path: plain PyTorch versions and their
hand-written Hopper kernels."""

from geomx_tpu_torch.ops.quantize import (  # noqa: F401
    dequantize_2bit, dgc_update, quantize_2bit)
