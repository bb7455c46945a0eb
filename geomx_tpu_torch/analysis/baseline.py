"""Per-finding suppression baseline (``analysis-baseline.toml``).

A baseline entry acknowledges ONE finding (or a small ``fnmatch``
family) as defensible and says WHY — the ``reason`` field is mandatory
and must be a real justification (placeholder reasons like ``TODO`` are
rejected at load time, so a skeleton emitted by ``--baseline`` cannot
be committed unfilled).  Format::

    [[suppress]]
    checker = "reactor-blocking"
    key = "geomx_tpu_torch/kvstore/server.py::GlobalServerLogic._x::send_cmd"
    reason = "runs on a dedicated drain thread spawned by the handler"

The container image pins Python 3.10 (no ``tomllib``), so this module
carries a tiny parser for exactly the subset the file uses: comments,
``[[suppress]]`` array-of-tables headers, and ``key = "string"`` pairs
with standard backslash escapes.  Anything else is a hard error — the
baseline is a reviewed artifact, not a config language.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import pathlib
from typing import Iterable, List, Optional

from geomx_tpu_torch.analysis.core import Finding

DEFAULT_BASELINE = "analysis-baseline-torch.toml"

_PLACEHOLDER_REASONS = ("", "todo", "tbd", "fixme", "xxx")


class BaselineError(ValueError):
    pass


@dataclasses.dataclass
class Suppression:
    checker: str
    key: str          # exact finding key, or an fnmatch pattern
    reason: str
    line: int = 0
    used: int = 0     # findings matched this run

    def matches(self, f: Finding) -> bool:
        if self.checker != f.checker:
            return False
        if self.key == f.key:
            return True
        return ("*" in self.key or "?" in self.key) \
            and fnmatch.fnmatchcase(f.key, self.key)


def _unquote(raw: str, line_no: int) -> str:
    raw = raw.strip()
    if not raw.startswith('"'):
        raise BaselineError(
            f"baseline line {line_no}: value must be a double-quoted "
            f"string, got {raw!r}")
    out: List[str] = []
    i = 1
    closed = False
    while i < len(raw):
        c = raw[i]
        if c == '"':
            closed = True
            i += 1
            break
        if c == "\\":
            i += 1
            if i >= len(raw):
                raise BaselineError(
                    f"baseline line {line_no}: dangling escape")
            esc = raw[i]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc)
                       or _bad_escape(esc, line_no))
        else:
            out.append(c)
        i += 1
    rest = raw[i:].strip()
    if not closed or (rest and not rest.startswith("#")):
        raise BaselineError(
            f"baseline line {line_no}: malformed string value {raw!r}")
    return "".join(out)


def _bad_escape(esc: str, line_no: int) -> str:
    raise BaselineError(
        f"baseline line {line_no}: unsupported escape \\{esc}")


def parse(text: str) -> List[Suppression]:
    entries: List[Suppression] = []
    current: Optional[dict] = None
    current_line = 0

    def flush():
        nonlocal current
        if current is None:
            return
        missing = [k for k in ("checker", "key", "reason")
                   if k not in current]
        if missing:
            raise BaselineError(
                f"baseline entry at line {current_line} is missing "
                f"{missing}")
        reason = current["reason"].strip()
        if reason.lower().rstrip(":. ") in _PLACEHOLDER_REASONS \
                or len(reason) < 10:
            raise BaselineError(
                f"baseline entry at line {current_line} "
                f"({current['key']}): 'reason' must be a real "
                f"justification, got {reason!r}")
        entries.append(Suppression(current["checker"], current["key"],
                                   reason, current_line))
        current = None

    for no, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[suppress]]":
            flush()
            current = {}
            current_line = no
            continue
        if "=" in line and current is not None:
            k, _, v = line.partition("=")
            k = k.strip()
            if k not in ("checker", "key", "reason"):
                raise BaselineError(
                    f"baseline line {no}: unknown field {k!r}")
            if k in current:
                raise BaselineError(
                    f"baseline line {no}: duplicate field {k!r}")
            current[k] = _unquote(v, no)
            continue
        raise BaselineError(f"baseline line {no}: cannot parse {raw!r}")
    flush()
    return entries


class Baseline:
    def __init__(self, entries: Iterable[Suppression] = ()):
        self.entries = list(entries)

    @classmethod
    def load(cls, path: pathlib.Path) -> "Baseline":
        path = pathlib.Path(path)
        if not path.exists():
            return cls()
        return cls(parse(path.read_text()))

    def filter(self, findings: List[Finding]
               ) -> tuple[List[Finding], List[Finding]]:
        """Split into (unsuppressed, suppressed)."""
        fresh: List[Finding] = []
        eaten: List[Finding] = []
        for f in findings:
            hit = next((s for s in self.entries if s.matches(f)), None)
            if hit is None:
                fresh.append(f)
            else:
                hit.used += 1
                eaten.append(f)
        return fresh, eaten

    def unused(self) -> List[Suppression]:
        """Entries that matched nothing this run — stale suppressions
        that should be deleted (reported as a warning, not a failure:
        a checker run restricted by --check legitimately skips some)."""
        return [s for s in self.entries if s.used == 0]


def skeleton(findings: List[Finding]) -> str:
    """Render unsuppressed findings as baseline entries for a human to
    justify.  The emitted reason fails validation on purpose."""
    blocks = []
    for f in findings:
        blocks.append(
            "[[suppress]]\n"
            f'checker = "{f.checker}"\n'
            f'key = "{f.key}"\n'
            f'reason = "TODO"  # justify or fix — TODO is rejected\n')
    return "\n".join(blocks)
