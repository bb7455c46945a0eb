"""AST-based static-analysis suite (concurrency & protocol lint).

``python -m geomx_tpu_torch.analysis`` runs every checker over the live tree
and exits non-zero on any finding not suppressed by
``analysis-baseline.toml``; ``tests/test_analysis.py`` pins the same
run green in tier 1.  See docs/static-analysis.md for the checker
catalog and the baseline policy.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Iterable, List, Optional, Tuple, Type

from geomx_tpu_torch.analysis.baseline import (DEFAULT_BASELINE, Baseline,
                                         BaselineError, skeleton)
from geomx_tpu_torch.analysis.config_drift import ConfigDrift
from geomx_tpu_torch.analysis.core import Checker, Finding, Project
from geomx_tpu_torch.analysis.decode_bounds import DecodeBounds
from geomx_tpu_torch.analysis.doc_drift import MetricsDoc
from geomx_tpu_torch.analysis.lock_discipline import LockDiscipline
from geomx_tpu_torch.analysis.reactor_blocking import ReactorBlocking
from geomx_tpu_torch.analysis.wire_protocol import WireProtocol

#: name -> checker class, in catalog order
CHECKERS: Dict[str, Type[Checker]] = {
    c.name: c for c in (LockDiscipline, ReactorBlocking, WireProtocol,
                        ConfigDrift, MetricsDoc, DecodeBounds)
}


def repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def run_checkers(project: Optional[Project] = None,
                 names: Optional[Iterable[str]] = None,
                 baseline: Optional[Baseline] = None,
                 ) -> Tuple[List[Finding], List[Finding], Baseline]:
    """Run the named checkers (default: all) and split the findings by
    the baseline.  Returns ``(unsuppressed, suppressed, baseline)``."""
    if project is None:
        project = Project(repo_root())
    if baseline is None:
        baseline = Baseline.load(
            pathlib.Path(project.root) / DEFAULT_BASELINE)
    wanted = list(names) if names is not None else list(CHECKERS)
    findings: List[Finding] = []
    for name in wanted:
        if name not in CHECKERS:
            raise KeyError(
                f"unknown checker {name!r} (have: {sorted(CHECKERS)})")
        findings.extend(CHECKERS[name]().run(project))
    findings.sort(key=lambda f: (f.checker, f.path, f.line, f.key))
    fresh, eaten = baseline.filter(findings)
    return fresh, eaten, baseline


__all__ = [
    "Baseline", "BaselineError", "CHECKERS", "Checker", "Finding",
    "Project", "repo_root", "run_checkers", "skeleton",
]
