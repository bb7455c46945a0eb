"""CLI front end: ``python -m geomx_tpu_torch.analysis``.

Exit codes: 0 = clean (modulo baseline), 1 = unsuppressed findings,
2 = usage / baseline-file error.  ``--baseline`` prints TOML skeleton
entries for the current unsuppressed findings (with a placeholder
reason that the loader REJECTS — paste, then justify or fix).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from geomx_tpu_torch.analysis import (CHECKERS, Baseline, BaselineError, Project,
                                repo_root, run_checkers, skeleton)
from geomx_tpu_torch.analysis.baseline import DEFAULT_BASELINE


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m geomx_tpu_torch.analysis",
        description="concurrency & protocol lint suite "
                    "(docs/static-analysis.md)")
    ap.add_argument("--check", action="append", metavar="NAME",
                    help="run only this checker (repeatable); "
                         "default: all")
    ap.add_argument("--baseline", action="store_true",
                    help="print baseline skeleton entries for the "
                         "current unsuppressed findings and exit 1 if "
                         "there are any")
    ap.add_argument("--baseline-file", default=None, metavar="PATH",
                    help=f"suppression file (default: <root>/"
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="project root (default: the repo this package "
                         "lives in)")
    ap.add_argument("--list", action="store_true",
                    help="list checkers and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name, cls in CHECKERS.items():
            print(f"{name:18s} {cls.description}")
        return 0

    root = pathlib.Path(args.root) if args.root else repo_root()
    try:
        project = Project(root)
        bl_path = (pathlib.Path(args.baseline_file) if args.baseline_file
                   else root / DEFAULT_BASELINE)
        bl = Baseline.load(bl_path)
        fresh, eaten, bl = run_checkers(project, args.check, bl)
    except BaselineError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    if args.baseline:
        if fresh:
            print(skeleton(fresh))
        print(f"# {len(fresh)} unsuppressed finding(s); "
              f"{len(eaten)} already baselined", file=sys.stderr)
        return 1 if fresh else 0

    for f in fresh:
        print(f.render())
    stale = [] if args.check else bl.unused()
    for s in stale:
        print(f"warning: stale baseline entry (matched nothing): "
              f"{s.checker} :: {s.key}", file=sys.stderr)
    checked = ", ".join(args.check) if args.check else "all checkers"
    print(f"{len(fresh)} finding(s) [{checked}], {len(eaten)} "
          f"baselined, {len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'}")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
