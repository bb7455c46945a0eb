"""Kernels: the flash forward and backward kernels' share of their
roofline in the traced rounds: the least time the card needs for the
calls the rounds make (each call's larger of operations over the bf16
peak and bytes over the HBM bandwidth) over the device time of the
flash kernels.  Read only where the trace holds exactly one forward
kernel a call."""

from geobench.flops.flash_attention import costs
from geobench.kernel_groups import group


def read(run):
    tr, peaks = run.trace, run.peaks
    m = run.cell.config["model"]
    if tr is None or not peaks or run.cell.config["family"] != "transformer":
        return None
    if m.get("attn_impl") != "flash" or m.get("compute_dtype") != "bfloat16":
        return None
    calls = tr.rounds * run.result["n_workers"] * m["n_layers"]
    if tr.count(lambda n: "fwd_tc_kernel<" in n) != calls:
        return None
    c = costs(run.cell.batch, m["max_seq"], m["n_heads"],
              m["d_model"] // m["n_heads"])
    least = sum(max(ops / peaks["bf16_flops"], b / peaks["hbm_bytes_per_s"])
                for ops, b in c.values()) * calls
    us = tr.device_us(lambda n: group(n) == "flash_attention")
    if us <= 0:
        return None
    return 100.0 * least / (us / 1e6)
