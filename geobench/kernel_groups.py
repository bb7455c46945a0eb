"""Device kernels by what they do: the grouping of the port's
``examples/profile_georound.py`` (``_group`` and its name lists),
copied."""

from __future__ import annotations

CODEC_KERNELS = ("quant_consecutive", "quant_strided")   # also dequant_*
DGC_KERNELS = ("dgc_update<",)
FLASH_KERNELS = ("fwd_f32_tc_kernel<", "delta_kernel<",
                 "dkdv_f32_tc_kernel<", "dq_f32_tc_kernel<", "fwd_tc_kernel<",
                 "bwd_tc_kernel<", "dq_convert_kernel")


def group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in DGC_KERNELS):
        return "dgc_update"
    if any(k in name for k in CODEC_KERNELS):
        return "codec_kernels"
    if any(k in name for k in FLASH_KERNELS):
        return "flash_attention"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(s in low for s in ("conv", "gemm", "cutlass", "sm80", "sm90",
                              "nvjet", "gemv", "splitk",
                              "wgrad", "dgrad", "cudnn", "xmma", "nhwc",
                              "max_pool", "softmax", "nll", "relu",
                              "gelu", "embedding", "index")):
        return "worker_compute"
    if "topk" in low or "sort" in low or "radix" in low:
        return "bsc_topk"
    return "elementwise_other"
