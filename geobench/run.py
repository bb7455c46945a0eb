"""One run of one benchmark cell of the port (``geomx_tpu_torch``).

    python3 geobench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (``python -m geobench.run`` works too).
Loads the cell by its name in ``BENCHMARK.json``, drives the port's
in-process geo-round on the card (:mod:`geobench.harness`), then checks
the run's first steps against the plain reference
(:mod:`geobench.reference.georound`, :mod:`geobench.check`) after the
program's state is freed.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown`` of the
traced rounds, and last ``check``, each compared number beside its
limit, which also end standard error.

Exits non-zero with no result when CUDA is missing or has fewer cards
than the cell asks for, when the program is missing, or when JAX, flax
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "geomx_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that must not be in this
    process: compared whole (``geomx_tpu_torch`` is not ``geomx_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _cache_env(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so
    that a cell's first run there builds and the later ones hit; the
    program's own kernel cache is ``geomx_tpu_torch/.kernel_cache``."""
    cache = os.path.join(root, ".geobench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["GEOMX_OBS_DIR"] = os.path.join(cache, "obs")
    os.environ["GEOMX_TEST_TRACE_DIR"] = os.path.join(cache, "trace")
    os.environ["USE_FLAX"] = "0"


class RunData:
    """What the per-layer readers see of a run."""

    def __init__(self, cell, result, trace, peaks):
        self.cell, self.result, self.trace, self.peaks = (cell, result,
                                                          trace, peaks)


def _peaks(kind: str):
    with open(os.path.join(ROOT, "geobench", "peaks.json")) as f:
        return json.load(f).get(kind)


def end_to_end(cell, res: dict, setup_s: float) -> dict:
    from geobench.harness import quantile

    vals = {
        "samples_per_s": res["samples"] / res["seconds"],
        "step_p90_ms": 1e3 * quantile(res["step_times"], 90),
        "wan_bytes_per_sample": res["wan_bytes"] / res["samples"],
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, data: RunData) -> dict:
    from geobench.spec import reader

    out = {}
    for m in cell.per_layer:
        v = reader(m["name"]).read(data)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(args, device, root: str) -> int:
    import torch

    from geobench import check
    from geobench.harness import run_cell
    from geobench.reference import georound
    from geobench.spec import load
    from geobench.trace import Trace

    cell = load(args.workload, root)
    tmpdir = tempfile.mkdtemp(prefix="geobench_")
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device, tmpdir=tmpdir)
        setup_s = res["setup_end_wall"] - _T_START
        kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        peaks = _peaks(kind)
        dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": kind, "count": cell.chips,
               "memory_peak_bytes": res["memory_peak_bytes"]}
        out = {"attempted": res["worker_steps"], "failed": 0}
        if args.trace:
            tr = Trace.load(res["trace_path"], res["traced_rounds"])
            out["metrics"] = per_layer(cell, RunData(cell, res, tr, peaks))
            dev["busy_s"] = tr.busy_us() / 1e6
            dev["window_s"] = tr.window_us / 1e6
            out["breakdown"] = {"device_ops": tr.top_ops(10),
                                "idle_gaps": tr.idle_gaps(10)}
        else:
            out["metrics"] = end_to_end(cell, res, setup_s)
        prog = {"losses": res["readings"].losses,
                "grad_norms": res["readings"].grad_norms,
                "change": res["readings"].change,
                "first_grad": res["readings"].first_grad}
        del res
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = georound.run(cell.config, cell.cell, args.seed, device,
                           int(cell.cell["check_steps"]))
        numbers = check.compare(prog, ref)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    limits = cell.cell.get("limits", {})
    found = forbidden_modules()
    if found:
        print(f"geobench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    keys = [k for k in check.NUMBERS if k in numbers or k in limits]
    checked = {k: {"value": numbers.get(k), "limit": limits.get(k)}
               for k in keys}
    line = {"correct": check.judge(numbers, limits), **out, "device": dev,
            "check": checked}
    for k in keys:
        print(f"{k} {numbers.get(k)!r} limit {limits.get(k)!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    _cache_env(root)
    import torch

    from geobench.spec import load

    chips = load(args.workload, root).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"geobench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run(args, torch.device("cuda", 0), root)


if __name__ == "__main__":
    sys.exit(main())
