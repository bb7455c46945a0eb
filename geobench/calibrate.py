"""The readings a cell's correctness limits are set from, at the cell's
own size, in one process.

    python3 geobench/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 [--first-seed N] [--repeat 1] \\
        [--out chiprun_out/calibrate_<cell>.json]

For each of ``--seeds`` seeds: the program's run of the checked steps
(the harness's own path, stopped at the window) against the float32
reference: the lower readings.  Beside it, the reference with its pull
generator seeded otherwise (``pull_reseeded``) against the reference:
what the pull's sampled top-k alone moves.  On the first ``--repeat``
seeds the program runs a second time and is compared with its first run
(``program_again``).  For each of ``--control-seeds`` other seeds: the
control (the reference with fp8 products put in the program's place)
and each planted fault (:data:`geobench.reference.georound.FAULTS`),
against the float32 reference: the upper readings.  A step that leaves
its state unchanged reads 1 on the change's numbers by their
definition and is not run.  Writes every number, the three worst leaves
of each norm gap, every leaf's norms of the program's seeds, and the
time each part took.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PULL_RESEED = 4321


def _as_prog(ref: dict) -> dict:
    n = len(ref["change_norms"])
    return {"losses": {w: [row[w] for row in ref["losses"]]
                       for w in range(n)},
            "grad_norms": ref["grad_norms"],
            "change": dict(enumerate(ref["change_norms"])),
            "first_grad": ref["first_grad"]}


def _as_ref(prog: dict, sampled) -> dict:
    """A program run in the reference's layout, to compare another run
    with it."""
    n = len(prog["losses"])
    steps = len(prog["losses"][0])
    return {"losses": [[prog["losses"][w][s] for w in range(n)]
                       for s in range(steps)],
            "grad_norms": prog["grad_norms"],
            "change_norms": [prog["change"][w] for w in range(n)],
            "first_grad": prog["first_grad"], "sampled": sampled}


def _worst(prog: dict, ref: dict) -> dict:
    """The three leaves with the largest gaps, per norm number."""
    out = {}
    pg, rg = prog["grad_norms"], ref["grad_norms"]
    if isinstance(rg, dict):
        pg, rg = [pg], [rg]
    rows = []
    for w, (p, r) in enumerate(zip(pg, rg)):
        rows += [(abs(p[k] - r[k]), w, k, p[k], r[k]) for k in r]
    out["grad"] = sorted(rows, reverse=True)[:3]
    rows = []
    for w, r in enumerate(ref["change_norms"]):
        p = prog["change"][w]
        rows += [(abs(p[k] - r[k]), w, k, p[k], r[k]) for k in r]
    out["change"] = sorted(rows, reverse=True)[:3]
    return out


def _plain(d):
    """The readings without the gradients' tensors, for the report."""
    return {k: v for k, v in d.items() if k != "first_grad"}


def _program(cell, seed, dev):
    from geobench.harness import run_cell

    res = run_cell(cell, seed, 0.0, False, dev)
    r = res["readings"]
    prog = {"losses": r.losses, "grad_norms": r.grad_norms,
            "change": r.change, "first_grad": r.first_grad}
    return prog, res["memory_peak_bytes"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_147_483_000)
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from geobench import check
    from geobench.reference import georound
    from geobench.spec import load

    root = os.getcwd()
    cell = load(args.workload, root)
    dev = torch.device(args.device)
    S = int(cell.cell["check_steps"])
    report = {"workload": args.workload, "program": [], "control": []}
    if dev.type == "cuda":
        report["device"] = torch.cuda.get_device_name(dev)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.time()
        prog, mem = _program(cell, seed, dev)
        t1 = time.time()
        ref = georound.run(cell.config, cell.cell, seed, dev, S)
        t2 = time.time()
        other = georound.run(cell.config, cell.cell, seed, dev, S,
                             pull_seed=PULL_RESEED)
        row = {"seed": seed, "numbers": check.compare(prog, ref),
               "pull_reseeded": check.compare(_as_prog(other), ref),
               "worst": _worst(prog, ref), "program_s": t1 - t0,
               "reference_s": t2 - t1, "memory_peak_bytes": mem}
        if i < args.repeat:
            again, _ = _program(cell, seed, dev)
            row["program_again"] = check.compare(
                again, _as_ref(prog, ref["sampled"]))
            del again
        row["leaves"] = {"program": _plain(prog), "reference": _plain(ref),
                         "pull_reseeded": _plain(other)}
        report["program"].append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "leaves"}),
              flush=True)
    for i in range(args.control_seeds):
        seed = args.first_seed + 104729 * (i + 1)
        t0 = time.time()
        ref = georound.run(cell.config, cell.cell, seed, dev, S)
        row = {"seed": seed, "reference_s": time.time() - t0}
        for precision, fault in [("fp8", None)] + [
                ("f32", f) for f in georound.FAULTS]:
            got = georound.run(cell.config, cell.cell, seed, dev, S,
                               precision=precision, fault=fault)
            row[fault or precision] = check.compare(_as_prog(got), ref)
        report["control"].append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
