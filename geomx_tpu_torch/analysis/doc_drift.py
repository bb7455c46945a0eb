"""Shared doc-drift engine + the metrics-doc checker.

One engine for "a source-extracted name set must match a markdown
catalog": extract name *templates* from call sites, expand the dynamic
ones through an explicit expansion table, and diff both directions
against the doc's backticked tokens.  ``docs/metrics.md`` (the PR 7
grep-audit that used to live inline in tests/test_metrics_doc.py) is
the first instance; ``docs/env-vars.md`` uses the same idea through the
config-drift checker.

The expansion table is the audit's teeth for dynamic names: a call site
whose name suffix is computed at runtime (``f"{self.node}.{action}s"``)
must list its concrete expansions here, so adding a new dynamic metric
without documenting what it can produce fails the audit by design.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

from geomx_tpu_torch.analysis.core import Checker, Finding, Project

_CALL = re.compile(r'system_(?:counter|gauge)\(\s*f?"([^"]+)"', re.S)


def _health_rules() -> Sequence[str]:
    from geomx_tpu_torch.obs.health import RULES

    return list(RULES)


def metric_expansions() -> Dict[str, List[str]]:
    """Templates whose SUFFIX is computed at runtime -> the concrete
    names they can produce (each must be documented).  Imported by
    tests/test_metrics_doc.py, so the table has exactly one home."""
    return {
        "{self.po.node}.{action}s": ["party_folds", "party_unfolds"],
        "{postoffice.node}.wan_policy_{a}s": [
            "wan_policy_downshifts", "wan_policy_upshifts",
            "wan_policy_manuals"],
        "{self.node}.wan_bytes_{tag or 'vanilla'}": [
            "wan_bytes_vanilla", "wan_bytes_fp16", "wan_bytes_2bit",
            "wan_bytes_bsc", "wan_bytes_mpq"],
        "{self.node}.health_{r}_alerts": [
            f"health_{r}_alerts" for r in _health_rules()],
        # the flight recorder's pressure gauges (obs/flight.py
        # add_pressure): the van's send-queue / process-thread / reactor
        # probes are registered by the Postoffice, the merge-side trio
        # by attach_server_pressure
        "{self.node}.{name}": ["lock_wait_s", "lane_depth",
                               "van_sendq_depth", "codec_pool_busy",
                               "process_threads", "reactor_loop_lag_ms",
                               "reactor_fds"],
    }


def metric_templates(project: Project) -> List[Tuple[str, str]]:
    """(source rel, name template) for every system_counter/gauge call
    site in the package."""
    out: List[Tuple[str, str]] = []
    for f in project.files:
        for m in _CALL.finditer(f.text):
            out.append((f.rel, m.group(1)))
    return out


class MetricsDoc(Checker):
    name = "metrics-doc"
    description = ("every registered system metric is documented in "
                   "docs/metrics.md and every doc row has a live call "
                   "site")

    DOC = "metrics.md"

    def run(self, project: Project) -> List[Finding]:
        doc_path = project.docs_dir / self.DOC
        if not doc_path.exists():
            return []
        doc = doc_path.read_text()
        doc_rel = doc_path.relative_to(project.root).as_posix()
        templates = metric_templates(project)
        expansions = metric_expansions()
        findings: List[Finding] = []
        if not templates:
            findings.append(Finding(
                self.name, doc_rel, 1, f"{doc_rel}::audit::empty",
                "audit regex found no system_counter/system_gauge call "
                "sites — broken audit"))
            return findings
        for src, tpl in templates:
            # collapse {placeholders} to a marker FIRST — the node
            # expression itself contains dots ({self.po.node}.x)
            norm = re.sub(r"\{[^}]*\}", "\x00", tpl)
            if "." not in norm:
                findings.append(Finding(
                    self.name, src, 1, f"{src}::metric::noprefix:{tpl}",
                    f"metric {tpl!r} has no node prefix"))
                continue
            prefix, suffix = norm.split(".", 1)
            if "\x00" in suffix:
                if tpl not in expansions:
                    findings.append(Finding(
                        self.name, src, 1, f"{src}::metric::dynamic:{tpl}",
                        f"dynamic metric name {tpl!r} — add its "
                        "expansions to geomx_tpu_torch/analysis/doc_drift.py "
                        "AND document them in docs/metrics.md"))
                    continue
                for name in expansions[tpl]:
                    if f"`{name}`" not in doc:
                        findings.append(Finding(
                            self.name, src, 1,
                            f"{src}::metric::missing:{name}",
                            f"{name} (expansion of {tpl!r}) not in "
                            "docs/metrics.md"))
                continue
            if prefix == "\x00":
                token = f"`{suffix}`"       # per-node: bare suffix
            else:
                # literal family prefix (global_shard<k>.*)
                token = ("`" + prefix.replace("\x00", "<k>") + "."
                         + suffix + "`")
            if token not in doc:
                findings.append(Finding(
                    self.name, src, 1, f"{src}::metric::missing:{token}",
                    f"{token} not in docs/metrics.md"))
        findings.extend(self._stale_rows(doc, doc_rel, templates,
                                         expansions))
        return findings

    def _stale_rows(self, doc: str, doc_rel: str,
                    templates: List[Tuple[str, str]],
                    expansions: Dict[str, List[str]]) -> List[Finding]:
        """The reverse direction, loosely: every per-node table row's
        name still has a matching call site (catches renames that
        orphan doc rows)."""
        tpls = [t for _, t in templates]
        expanded = [n for names in expansions.values() for n in names]
        rows = re.findall(r"^\| `([^`]+)` \|", doc, re.M)
        findings: List[Finding] = []
        if not rows:
            findings.append(Finding(
                self.name, doc_rel, 1, f"{doc_rel}::audit::norows",
                "no table rows parsed from docs/metrics.md"))
            return findings
        for name in rows:
            bare = name.replace("global_shard<k>.", "")
            if name in expanded or bare in expanded:
                continue
            if not any(t.endswith(f".{bare}") for t in tpls):
                findings.append(Finding(
                    self.name, doc_rel, 1, f"{doc_rel}::row::{name}",
                    f"doc row `{name}` has no call site — stale entry"))
        return findings
