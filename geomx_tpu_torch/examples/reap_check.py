"""Run ``chip_smoke.py`` and list what outlived it.

Each run starts ``python3 chip_smoke.py`` from the repository's root
(a copy of it for the failing run), keeps its output in ``chiprun_out/``, and lists
``ps -eo pid,ppid,pgid,sid,etimes,args`` 0 s and 15 s after it ended,
the processes whose arguments name the tree, ``geomx_tpu_torch``, a
``run_*.sh`` script or ``pytest`` (this script and its parents aside).
Besides whole runs it can stop one by SIGTERM a while after a phase's
end, and run a copy of the tree whose phase 4 fails at its start.  On a
card::

    python -m geomx_tpu_torch.examples.reap_check --runs 2 --fail-phase4 \\
        --sigterm-after 3b --sigterm-delay 45

Writes ``chiprun_out/reap_check.json``; prints one line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PHASE4 = "    full, refs = check_full_width_step(dev)\n"


def _ancestors() -> set:
    pids, pid = set(), os.getpid()
    while pid > 1:
        pids.add(pid)
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            break
        pid = int(stat[stat.rfind(")") + 2:].split()[1])
    return pids


def listing(tree: str) -> list:
    """The processes that name the run, as ``ps`` prints them."""
    out = subprocess.run(["ps", "-eo", "pid,ppid,pgid,sid,etimes,args"],
                         capture_output=True, text=True).stdout
    mine = _ancestors()
    pat = re.compile(r"geomx_tpu_torch|run_[a-z_0-9]*\.sh|pytest|"
                     + re.escape(tree))
    rows = []
    for line in out.splitlines()[1:]:
        pid = int(line.split()[0])
        if pid in mine or " ps -eo " in line:
            continue
        if pat.search(line):
            rows.append(line)
    return rows


def run(tree: str, log: str, sigterm_after=None, delay=0.0) -> dict:
    """One ``chip_smoke.py`` run in ``tree``; SIGTERM ``delay`` seconds
    after phase ``sigterm_after`` ended, if given."""
    t0 = time.monotonic()
    with open(log, "w") as f:
        p = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree,
                             stdout=f, stderr=subprocess.STDOUT)
    rec = {"tree": tree, "log": log}
    if sigterm_after is not None:
        mark = f"phase {sigterm_after} done"
        while p.poll() is None:
            with open(log) as f:
                if mark in f.read():
                    break
            time.sleep(1)
        time.sleep(delay)
        if p.poll() is None:
            rec["alive_before_sigterm"] = len(listing(tree))
            rec["sigterm_at_s"] = time.monotonic() - t0
            p.send_signal(signal.SIGTERM)
    rec["rc"] = p.wait()
    rec["wall_s"] = time.monotonic() - t0
    rec["after_0s"] = listing(tree)
    time.sleep(15)
    rec["after_15s"] = listing(tree)
    with open(log) as f:
        text = f.read()
    rec["phases_s"] = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^phase (\S+) done in ([0-9.]+) s", text, re.M)}
    rec["lines"] = [ln for ln in text.splitlines() if re.match(
        r"(lane on the card|lane codec kernel launches|phase 1[01]: |"
        r"chip_smoke: |staged LM P3|total )", ln)]
    rec["last_line"] = text.rstrip("\n").rsplit("\n", 1)[-1]
    return rec


def failing_copy(tree: str) -> str:
    """A copy of ``tree`` (its committed kinds of files) whose phase 4
    fails at its start."""
    dest = os.path.join(tree, ".scratch", "reap_check_fail")
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(tree, dest, ignore=shutil.ignore_patterns(
        ".git", ".scratch", ".proof", "chiprun_out", ".kernel_cache",
        "__pycache__", "*.so"))
    path = os.path.join(dest, "chip_smoke.py")
    with open(path) as f:
        text = f.read()
    assert text.count(_PHASE4) == 1, "phase 4's first line moved"
    with open(path, "w") as f:
        f.write(text.replace(_PHASE4, '    assert False, "phase 4 made to '
                             'fail at its start"\n' + _PHASE4))
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--fail-phase4", action="store_true")
    ap.add_argument("--sigterm-after", default=None)
    ap.add_argument("--sigterm-delay", type=float, default=45.0)
    args = ap.parse_args(argv)
    tree = ROOT
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
           if shutil.which("nvidia-smi") else "no nvidia-smi")
    print(f"nvidia-smi: {smi}", flush=True)
    recs = {}
    for i in range(args.runs):
        recs[f"whole_{i}"] = run(tree, os.path.join(
            out_dir, f"reap_check_whole_{i}.log"))
    if args.fail_phase4:
        copy = failing_copy(tree)
        recs["fail_phase4"] = run(copy, os.path.join(
            out_dir, "reap_check_fail_phase4.log"))
        shutil.rmtree(copy, ignore_errors=True)
    if args.sigterm_after is not None:
        recs["sigterm"] = run(tree, os.path.join(
            out_dir, "reap_check_sigterm.log"), args.sigterm_after,
            args.sigterm_delay)
    for name, r in recs.items():
        print(f"{name}: rc {r['rc']} wall {r['wall_s']:.1f} s; alive after "
              f"0 s: {len(r['after_0s'])}, after 15 s: {len(r['after_15s'])}"
              + (f"; SIGTERM at {r['sigterm_at_s']:.1f} s with "
                 f"{r['alive_before_sigterm']} alive"
                 if "sigterm_at_s" in r else ""), flush=True)
        for ln in r["lines"] + r["after_0s"] + r["after_15s"]:
            print(f"  {ln[:300]}", flush=True)
    with open(os.path.join(out_dir, "reap_check.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "runs": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
