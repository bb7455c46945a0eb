"""Device: the model FLOPs of the window's samples (forward and
backward, counted from the model's shapes) over the window's seconds
and the card's bf16 peak."""

import importlib


def read(run):
    peak = (run.peaks or {}).get("bf16_flops")
    if not peak or not run.result["seconds"]:
        return None
    fam = importlib.import_module(f"geobench.flops.{run.cell.config['family']}")
    flops = fam.sample_flops(run.cell.config["model"]) * run.result["samples"]
    return 100.0 * flops / (run.result["seconds"] * peak)
