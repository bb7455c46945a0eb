"""Checker: the Config ↔ ``GEOMX_*`` env ↔ docs/env-vars.md contract.

The configuration surface is a three-way contract: every ``Config`` (or
``Topology``) field is settable in code, has a ``GEOMX_*`` env fallback
wired in ``Config.from_env`` / ``__post_init__``, and has a row in
``docs/env-vars.md``.  Fields that deliberately have *no* env knob
document that with ``—`` in the row's env column — the row is still
required, so the exception is visible and reviewed.

Rules:

``field-no-env``        a Config/Topology field with no GEOMX_* read
                        anywhere in config.py and no ``—`` env cell in
                        its doc row
``field-undocumented``  a field with no docs/env-vars.md row at all
``env-undocumented``    a ``GEOMX_*`` name read anywhere in the package
                        but absent from the doc's env column (orphaned
                        env reads land here too: an env var consulted
                        by code that nobody can discover)
``doc-env-unread``      a ``GEOMX_*`` name documented in the env column
                        but never read by any source file (a row that
                        outlived a rename)

This generalizes the ``test_metrics_doc`` grep-audit idea (docs as a
machine-checked contract) onto the shared framework; the metrics-doc
checker itself lives in :mod:`geomx_tpu_torch.analysis.doc_drift`.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from geomx_tpu_torch.analysis.core import Checker, Finding, Project, SourceFile

CONFIG_REL = "geomx_tpu_torch/core/config.py"
DOC_NAME = "env-vars.md"

_ENV_READER = re.compile(r"^(?:get|getenv|_e|env|_env(?:_\w+)?)$")
_ENV_NAME = re.compile(r"^GEOMX_[A-Z0-9_]+$")
_DOC_ENV = re.compile(r"`(GEOMX_[A-Z0-9_]+)`")
_ENV_TOKEN = re.compile(r"[\"'](GEOMX_[A-Z0-9_]+)[\"']")
#: repo files outside the package whose env knobs the doc also catalogs
_EXTRA_GLOBS = ("bench.py", "scripts/*.py", "scripts/*.sh",
                "examples/*.py")
#: fields that are pure code-level plumbing, not operator knobs
_INTERNAL_FIELDS = frozenset({"topology"})


class ConfigDrift(Checker):
    name = "config-drift"
    description = ("every Config field has its GEOMX_* env fallback and "
                   "docs/env-vars.md row; no orphaned or stale env names")

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        sf = project.by_rel.get(CONFIG_REL)
        doc_path = project.docs_dir / DOC_NAME
        if sf is None or not doc_path.exists():
            return findings
        doc_text = doc_path.read_text()
        doc_rel = doc_path.relative_to(project.root).as_posix()

        fields = self._dataclass_fields(sf, "Config")
        fields.update({f"topology.{n}": ln for n, ln
                       in self._dataclass_fields(sf, "Topology").items()})
        field_envs = self._field_env_map(sf)
        doc_rows = self._doc_rows(doc_text)
        documented_fields: Set[str] = set()
        documented_envs: Set[str] = set()
        noenv_fields: Set[str] = set()
        for env_cell, field_cell in doc_rows:
            for m in _DOC_ENV.finditer(env_cell):
                documented_envs.add(m.group(1))
            for tok in re.findall(r"`([A-Za-z0-9_.]+)`", field_cell):
                documented_fields.add(tok)
                if not _DOC_ENV.search(env_cell):
                    noenv_fields.add(tok)

        # every GEOMX_* literal anywhere in config.py: __post_init__
        # fallbacks that stage through a local variable (the
        # GEOMX_GLOBAL_SHARDS pattern) still count as the field's env
        # wiring when the doc row names that env
        config_literals = self._env_literals(sf.tree)
        doc_env_by_field: Dict[str, Set[str]] = {}
        for env_cell, field_cell in doc_rows:
            row_envs = {m.group(1) for m in _DOC_ENV.finditer(env_cell)}
            for tok in re.findall(r"`([A-Za-z0-9_.]+)`", field_cell):
                doc_env_by_field.setdefault(tok, set()).update(row_envs)

        for fname, line in sorted(fields.items()):
            if fname in _INTERNAL_FIELDS:
                continue
            envs = field_envs.get(fname, set())
            if not envs:
                envs = doc_env_by_field.get(fname, set()) & config_literals
            if not envs and fname not in noenv_fields:
                findings.append(self.finding(
                    CONFIG_REL, line, "Config", f"noenv:{fname}",
                    f"Config field {fname!r} has no GEOMX_* env fallback "
                    "in from_env/__post_init__ and its doc row does not "
                    "declare '—' (no-env) — directly-constructed configs "
                    "and launch scripts cannot set it from the "
                    "environment"))
            if fname not in documented_fields:
                findings.append(self.finding(
                    CONFIG_REL, line, "Config", f"undoc:{fname}",
                    f"Config field {fname!r} has no row in "
                    f"docs/{DOC_NAME}"))

        env_reads = self._env_reads(project)
        for env, sites in sorted(env_reads.items()):
            if env not in documented_envs:
                rel, line = sites[0]
                findings.append(self.finding(
                    rel, line, "env", f"envundoc:{env}",
                    f"env var {env} is read here but has no row in "
                    f"docs/{DOC_NAME} (env column)"))
        # stale-row check is read against ANY mention in the repo's
        # tooling files too (bench.py / scripts / examples carry knobs
        # the doc legitimately catalogs)
        mentioned = set(env_reads)
        for pat in _EXTRA_GLOBS:
            for p in project.root.glob(pat):
                mentioned.update(_ENV_TOKEN.findall(p.read_text()))
                mentioned.update(
                    re.findall(r"\b(GEOMX_[A-Z0-9_]+)=", p.read_text()))
        for env in sorted(documented_envs):
            if env not in mentioned:
                findings.append(Finding(
                    self.name, doc_rel, 1,
                    f"{doc_rel}::doc::stale:{env}",
                    f"docs/{DOC_NAME} documents {env} but no source "
                    "file reads it — a row that outlived a rename"))
        return findings

    # -- source side -------------------------------------------------------
    def _dataclass_fields(self, sf: SourceFile, cls: str
                          ) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef) and node.name == cls:
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and isinstance(stmt.target, ast.Name) \
                            and not stmt.target.id.startswith("_"):
                        out[stmt.target.id] = stmt.lineno
        return out

    def _env_literals(self, node: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and _ENV_NAME.match(n.value):
                out.add(n.value)
        return out

    def _field_env_map(self, sf: SourceFile) -> Dict[str, Set[str]]:
        """field (or ``topology.field``) -> GEOMX_* names consulted for
        it, from the ``from_env`` constructor kwargs and the
        ``__post_init__`` self-assignments."""
        out: Dict[str, Set[str]] = {}
        for fn in sf.functions:
            if fn.qualname == "Config.from_env":
                for n in ast.walk(fn.node):
                    if not isinstance(n, ast.Call):
                        continue
                    ctor = (n.func.id if isinstance(n.func, ast.Name)
                            else "")
                    if ctor not in ("Config", "Topology"):
                        continue
                    prefix = "topology." if ctor == "Topology" else ""
                    for kw in n.keywords:
                        if kw.arg is None:
                            continue
                        envs = self._env_literals(kw.value)
                        if envs:
                            out.setdefault(prefix + kw.arg,
                                           set()).update(envs)
            if fn.qualname == "Config.__post_init__":
                for n in ast.walk(fn.node):
                    if isinstance(n, ast.Assign) and len(n.targets) == 1:
                        tgt = n.targets[0]
                        if isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self":
                            envs = self._env_literals(n.value)
                            if envs:
                                out.setdefault(tgt.attr,
                                               set()).update(envs)
                    # dataclasses.replace(self.topology, field=_env_int(..))
                    if isinstance(n, ast.Call):
                        fname = (n.func.attr
                                 if isinstance(n.func, ast.Attribute)
                                 else "")
                        if fname == "replace":
                            for kw in n.keywords:
                                if kw.arg is None:
                                    continue
                                envs = self._env_literals(kw.value)
                                if envs:
                                    out.setdefault(
                                        f"topology.{kw.arg}",
                                        set()).update(envs)
        return out

    def _env_reads(self, project: Project
                   ) -> Dict[str, List[Tuple[str, int]]]:
        out: Dict[str, List[Tuple[str, int]]] = {}
        for f in project.files:
            for fn_or_tree in (f.tree,):
                for n in ast.walk(fn_or_tree):
                    name: Optional[str] = None
                    if isinstance(n, ast.Call):
                        fname = (n.func.attr
                                 if isinstance(n.func, ast.Attribute)
                                 else n.func.id
                                 if isinstance(n.func, ast.Name) else "")
                        if _ENV_READER.match(fname) and n.args:
                            a0 = n.args[0]
                            if isinstance(a0, ast.Constant) \
                                    and isinstance(a0.value, str) \
                                    and _ENV_NAME.match(a0.value):
                                name = a0.value
                    elif isinstance(n, ast.Subscript):
                        sl = n.slice
                        if isinstance(sl, ast.Constant) \
                                and isinstance(sl.value, str) \
                                and _ENV_NAME.match(sl.value):
                            name = sl.value
                    if name is not None:
                        out.setdefault(name, []).append((f.rel, n.lineno))
        return out

    # -- doc side ----------------------------------------------------------
    def _doc_rows(self, text: str) -> List[Tuple[str, str]]:
        """(env_cell, field_cell) per table row.  The doc mixes
        5-column (``Env | Legacy | Field | ...``) and 4-column
        (``Env | Field | ...``) tables, so each table's header decides
        which cell is the field column."""
        rows: List[Tuple[str, str]] = []
        field_idx = 2
        for line in text.splitlines():
            line = line.strip()
            if not line.startswith("|") or line.startswith("|---"):
                continue
            cells = [c.strip() for c in line.strip("|").split("|")]
            low = [c.lower() for c in cells]
            if low and low[0].startswith("env"):
                field_idx = next(
                    (i for i, c in enumerate(low) if "field" in c), 2)
                continue
            if len(cells) <= field_idx:
                continue
            rows.append((cells[0], cells[field_idx]))
        return rows
