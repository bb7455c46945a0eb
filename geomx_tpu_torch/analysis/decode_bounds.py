"""Checker: every raw-buffer decode in the transport / codec / durable-
state paths sits behind explicit length validation.

``unchecked-decode``
    ``np.frombuffer(...)``, ``struct.unpack(...)`` / ``unpack_from`` and
    compiled ``Struct.unpack*`` calls reinterpret attacker-reachable (or
    disk-rotted) bytes.  Without a preceding length/bounds check they
    either raise a bare ``ValueError``/``struct.error`` deep inside the
    framing (taking the reactor thread with it) or — worse — silently
    produce a short array that the merge path scatters into the wrong
    coordinates.  The rule: inside the enclosing function, BEFORE the
    decode call (in line order), there must be at least one of

    - a branch / loop condition / assert that inspects a size
      (``len(...)``, ``.nbytes``, ``.size``, ``.itemsize``), or
    - a call to a validation helper (name contains ``check``, ``verify``
      or ``valid``), or
    - the decode sits inside a ``try`` whose handler catches the decode
      error classes (``struct.error`` / ``ValueError`` / a typed
      corruption error) — the catch-and-fence idiom.

    Findings that are individually audited and defensible (e.g. a
    buffer whose length the caller already pinned) belong in
    ``analysis-baseline.toml`` with a one-sentence justification, like
    every other checker's.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from geomx_tpu_torch.analysis.core import (Checker, Finding, FunctionInfo,
                                     Project, _attr_chain)

#: modules whose decode sites face the wire or durable state — the
#: data/ file readers parse trusted local training files and are out of
#: scope (a corrupt dataset fails loudly at startup, not mid-round)
DECODE_SCOPES = (
    "geomx_tpu_torch/transport/",
    "geomx_tpu_torch/compression/",
    "geomx_tpu_torch/kvstore/checkpoint.py",
)

#: call names that reinterpret raw bytes
_DECODE_NAMES = frozenset({"frombuffer", "unpack", "unpack_from"})

#: attribute names whose mere mention in a condition counts as a size
#: inspection
_SIZE_ATTRS = frozenset({"nbytes", "size", "itemsize"})

#: exception names that make an enclosing try/except a legitimate
#: catch-and-fence guard for a decode
_FENCE_EXCS = frozenset({
    "error", "ValueError", "Exception", "struct", "CodecError",
    "WireCorruption", "CheckpointCorruption", "OSError", "KeyError",
    "IndexError", "TypeError",
})


def _mentions_size(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            fname = n.func.id if isinstance(n.func, ast.Name) else (
                n.func.attr if isinstance(n.func, ast.Attribute) else "")
            if fname == "len":
                return True
            low = fname.lower()
            if "check" in low or "verify" in low or "valid" in low:
                return True
        if isinstance(n, ast.Attribute) and n.attr in _SIZE_ATTRS:
            return True
    return False


def _handler_names(handler: ast.ExceptHandler) -> Set[str]:
    if handler.type is None:
        return {"Exception"}  # bare except catches everything
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    out: Set[str] = set()
    for t in types:
        ch = _attr_chain(t)
        if ch:
            out.update(ch.split("."))
    return out


class DecodeBounds(Checker):
    name = "decode-bounds"
    description = ("np.frombuffer / struct.unpack in transport+codec "
                   "paths must follow an explicit length check (or sit "
                   "in a typed catch-and-fence try block)")

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for sf in project.files:
            if not any(sf.rel.startswith(s) if s.endswith("/")
                       else sf.rel == s for s in DECODE_SCOPES):
                continue
            for fn in sf.functions:
                if isinstance(fn.node, ast.Lambda):
                    continue
                findings.extend(self._check_function(sf.rel, fn))
        return findings

    # ------------------------------------------------------------------
    def _check_function(self, rel: str, fn: FunctionInfo) -> List[Finding]:
        node = fn.node
        decode_sites: List[Tuple[str, int]] = []
        for call in fn.calls:
            if call.name not in _DECODE_NAMES:
                continue
            # unpack()/unpack_from() with no receiver is some local
            # helper, not a struct decode; frombuffer always counts
            if call.name != "frombuffer" and call.recv is None:
                continue
            decode_sites.append((call.name, call.line))
        if not decode_sites:
            return []
        guard_lines = self._guard_lines(node)
        helper_lines = self._helper_call_lines(fn)
        fenced = self._fenced_ranges(node)
        out: List[Finding] = []
        seen_per_name: dict = {}
        for name, line in sorted(decode_sites, key=lambda s: s[1]):
            if any(g < line for g in guard_lines):
                continue
            if any(h < line for h in helper_lines):
                continue
            if any(lo <= line <= hi for lo, hi in fenced):
                continue
            ordinal = seen_per_name.get(name, 0)
            seen_per_name[name] = ordinal + 1
            out.append(self.finding(
                rel, line, fn.qualname, f"{name}:{ordinal}",
                f"{name}() decodes raw bytes with no preceding length/"
                "bounds check in this function and no typed catch-and-"
                "fence around it — a truncated or bit-rotted buffer "
                "either raises inside the framing or returns a silently "
                "short array"))
        return out

    def _guard_lines(self, node: ast.AST) -> List[int]:
        """Lines of size-inspecting branch conditions / asserts,
        excluding nested function bodies (their guards protect their own
        decodes, not ours)."""
        out: List[int] = []
        for n in self._walk_same_function(node):
            if isinstance(n, (ast.If, ast.While)) and _mentions_size(n.test):
                out.append(n.lineno)
            elif isinstance(n, ast.Assert) and _mentions_size(n.test):
                out.append(n.lineno)
            elif isinstance(n, ast.IfExp) and _mentions_size(n.test):
                out.append(n.lineno)
        return out

    def _helper_call_lines(self, fn: FunctionInfo) -> List[int]:
        out: List[int] = []
        for call in fn.calls:
            low = call.name.lower()
            if "check" in low or "verify" in low or "valid" in low:
                out.append(call.line)
        return out

    def _fenced_ranges(self, node: ast.AST) -> List[Tuple[int, int]]:
        """(first, last) line ranges of try-bodies whose handlers catch
        a decode error class."""
        out: List[Tuple[int, int]] = []
        for n in self._walk_same_function(node):
            if not isinstance(n, ast.Try):
                continue
            if not any(_handler_names(h) & _FENCE_EXCS
                       for h in n.handlers):
                continue
            last = max((getattr(s, "end_lineno", s.lineno) or s.lineno)
                       for s in n.body)
            out.append((n.body[0].lineno, last))
        return out

    def _walk_same_function(self, node: ast.AST):
        """ast.walk, but do not descend into nested def/lambda."""
        stack = list(ast.iter_child_nodes(node))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))
