"""Shared infrastructure for the AST-based static-analysis suite.

The checkers in this package (lock discipline, reactor blocking, wire
protocol, config drift — see docs/static-analysis.md) all consume the
same project model built here:

- :class:`Project` parses every ``*.py`` under a package root once and
  indexes modules, classes, functions and string-literal occurrences.
- :class:`FunctionInfo` is one function/method/lambda with its outgoing
  :class:`CallSite` list (calls inside *nested* defs belong to the
  nested function, so the call graph matches runtime reachability:
  defining a closure is not calling it).
- :class:`CallGraph` resolves call sites to project functions with a
  deliberately conservative name-based strategy (see
  :meth:`CallGraph.resolve`): ``self.x()`` follows the class hierarchy
  both up (bases) and down (subclasses — dynamic dispatch through a
  base-class template method is exactly how the Customer/_App handler
  chain works), bare names resolve within the module, and foreign
  attribute calls resolve by unique-ish method name so cross-object
  chains (server → replication → executor) stay connected without a
  type system.

Checkers report :class:`Finding`\\ s keyed by a *stable* suppression key
(``relpath::qualname::symbol`` — no line numbers, so a baseline entry
survives unrelated edits to the file).  ``python -m geomx_tpu_torch.analysis``
and the tier-1 audit in ``tests/test_analysis.py`` are the two front
ends.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker hit.

    ``key`` is the stable suppression handle: ``relpath::qualname::
    symbol``.  Line numbers appear only in the human-facing location —
    a baseline entry must not rot when an unrelated edit reflows the
    file.
    """

    checker: str
    path: str          # project-relative, forward slashes
    line: int
    key: str
    message: str

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.checker}] "
                f"{self.message}\n    key = {self.key}")


def finding_key(path: str, qualname: str, symbol: str) -> str:
    return f"{path}::{qualname}::{symbol}"


# ---------------------------------------------------------------------------
# source model


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of an expression if it is a plain Name/Attribute
    chain (``self.up.customer`` → ``"self.up.customer"``), else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class CallSite:
    """One Call node inside a function body."""

    node: ast.Call
    name: str                  # called attr/function name ("" for f()())
    recv: Optional[str]        # dotted receiver ("self", "time", ...) or
    #                            None for bare-name calls
    line: int

    def keyword(self, name: str) -> Optional[ast.expr]:
        for kw in self.node.keywords:
            if kw.arg == name:
                return kw.value
        return None

    def has_keyword(self, name: str) -> bool:
        return self.keyword(name) is not None

    def keyword_is_const(self, name: str, value) -> bool:
        kw = self.keyword(name)
        return isinstance(kw, ast.Constant) and kw.value is value

    @property
    def num_pos_args(self) -> int:
        return len(self.node.args)


@dataclasses.dataclass
class FunctionInfo:
    """One function / method / lambda and its outgoing calls."""

    module: "SourceFile"
    node: ast.AST                    # FunctionDef / AsyncFunctionDef / Lambda
    name: str
    qualname: str                    # Class.method / outer.inner / ...<lambda>
    cls: Optional[str]               # enclosing class name, if any
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    is_method: bool = False          # a DIRECT method (not nested in one)

    @property
    def line(self) -> int:
        return self.node.lineno

    @property
    def is_init(self) -> bool:
        return self.name == "__init__"

    def source_id(self) -> str:
        return f"{self.module.rel}::{self.qualname}"


@dataclasses.dataclass
class ClassInfo:
    module: "SourceFile"
    node: ast.ClassDef
    name: str
    bases: List[str]                                  # base-class names
    methods: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    # self.<attr> = threading.Lock()/RLock()/Condition()/StripedRLock()
    lock_attrs: Dict[str, str] = dataclasses.field(default_factory=dict)


class SourceFile:
    """One parsed module."""

    def __init__(self, root: pathlib.Path, path: pathlib.Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text()
        self.tree = ast.parse(self.text, filename=str(path))
        self.functions: List[FunctionInfo] = []
        self.classes: Dict[str, ClassInfo] = {}
        self._index()

    # -- indexing ----------------------------------------------------------
    _LOCK_CTORS = ("Lock", "RLock", "Condition", "StripedRLock",
                   "Semaphore", "BoundedSemaphore")

    def _index(self) -> None:
        self._walk_body(self.tree.body, qual=[], cls=None)

    def _walk_body(self, body: Sequence[ast.stmt], qual: List[str],
                   cls: Optional[ClassInfo]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                info = ClassInfo(self, stmt, stmt.name,
                                 [b for b in
                                  (_attr_chain(x) for x in stmt.bases)
                                  if b])
                self.classes[stmt.name] = info
                self._walk_body(stmt.body, qual + [stmt.name], info)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(stmt, qual, cls)
            # module-level statements may still contain lambdas/defs in
            # expressions; those are rare and not reachability roots —
            # skipped on purpose.

    def _add_function(self, node, qual: List[str],
                      cls: Optional[ClassInfo]) -> FunctionInfo:
        qn = ".".join(qual + [node.name]) if qual else node.name
        info = FunctionInfo(self, node, node.name, qn,
                            cls.name if cls is not None else None)
        self.functions.append(info)
        if cls is not None and len(qual) >= 1 and qual[-1] == cls.name:
            cls.methods[node.name] = info
            info.is_method = True
        # collect calls + nested defs (nested bodies are separate funcs)
        self._collect(node, info, qual, cls)
        return info

    def _collect(self, fn_node, info: FunctionInfo, qual: List[str],
                 cls: Optional[ClassInfo]) -> None:
        body = fn_node.body if not isinstance(fn_node, ast.Lambda) \
            else [ast.Expr(fn_node.body)]
        stack: List[ast.AST] = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(n, info.qualname.split("."), cls)
                continue
            if isinstance(n, ast.Lambda):
                lam = FunctionInfo(self, n, "<lambda>",
                                   f"{info.qualname}.<lambda>",
                                   cls.name if cls is not None else None)
                self.functions.append(lam)
                self._collect(n, lam, qual, cls)
                continue
            if isinstance(n, ast.Call):
                name, recv = "", None
                if isinstance(n.func, ast.Name):
                    name = n.func.id
                elif isinstance(n.func, ast.Attribute):
                    name = n.func.attr
                    recv = _attr_chain(n.func.value)
                info.calls.append(CallSite(n, name, recv, n.lineno))
            # lock-attribute declarations (only meaningful in methods)
            if (cls is not None and isinstance(n, ast.Assign)
                    and isinstance(n.value, ast.Call)):
                ctor = (n.value.func.attr
                        if isinstance(n.value.func, ast.Attribute)
                        else n.value.func.id
                        if isinstance(n.value.func, ast.Name) else "")
                if ctor in self._LOCK_CTORS:
                    for tgt in n.targets:
                        ch = _attr_chain(tgt)
                        if ch and ch.startswith("self.") \
                                and ch.count(".") == 1:
                            cls.lock_attrs[ch.split(".", 1)[1]] = ctor
            for child in ast.iter_child_nodes(n):
                stack.append(child)

    # -- helpers -----------------------------------------------------------
    def get_class(self, name: str) -> Optional[ClassInfo]:
        return self.classes.get(name)


class Project:
    """Every parsed module under ``root/pkg`` plus the docs directory.

    ``pkg`` may be a package directory name (the default production use:
    ``geomx_tpu_torch``) — fixture tests point it at a temp dir with a couple
    of small modules instead.
    """

    def __init__(self, root: pathlib.Path, pkg: str = "geomx_tpu_torch",
                 docs: str = "docs"):
        self.root = pathlib.Path(root)
        self.pkg = pkg
        self.pkg_dir = self.root / pkg
        self.docs_dir = self.root / docs
        self.files: List[SourceFile] = []
        for p in sorted(self.pkg_dir.rglob("*.py")):
            if "__pycache__" in p.parts:
                continue
            self.files.append(SourceFile(self.root, p))
        # global indexes
        self.by_rel: Dict[str, SourceFile] = {f.rel: f for f in self.files}
        self.classes: Dict[str, List[ClassInfo]] = {}
        self.methods: Dict[str, List[FunctionInfo]] = {}
        self.module_functions: Dict[Tuple[str, str], FunctionInfo] = {}
        self.functions: List[FunctionInfo] = []
        for f in self.files:
            for ci in f.classes.values():
                self.classes.setdefault(ci.name, []).append(ci)
            for fn in f.functions:
                self.functions.append(fn)
                if fn.is_method:
                    self.methods.setdefault(fn.name, []).append(fn)
                elif "." not in fn.qualname:
                    self.module_functions[(f.rel, fn.name)] = fn
        self._subclasses: Optional[Dict[str, List[ClassInfo]]] = None

    # -- class hierarchy ---------------------------------------------------
    def subclasses_of(self, name: str) -> List[ClassInfo]:
        if self._subclasses is None:
            self._subclasses = {}
            for cis in self.classes.values():
                for ci in cis:
                    for b in ci.bases:
                        base = b.split(".")[-1]
                        self._subclasses.setdefault(base, []).append(ci)
        out: List[ClassInfo] = []
        seen = set()
        frontier = [name]
        while frontier:
            nxt = frontier.pop()
            for ci in self._subclasses.get(nxt, []):
                if id(ci) not in seen:
                    seen.add(id(ci))
                    out.append(ci)
                    frontier.append(ci.name)
        return out

    def mro_methods(self, cls_name: str, meth: str,
                    include_derived: bool = True) -> List[FunctionInfo]:
        """Resolve ``self.meth()`` from a method of ``cls_name``: the
        class itself, its project-visible bases (upward), and — when
        ``include_derived`` — its subclasses (template-method dynamic
        dispatch downward)."""
        out: List[FunctionInfo] = []
        seen_ids = set()

        def add(fi: Optional[FunctionInfo]):
            if fi is not None and id(fi) not in seen_ids:
                seen_ids.add(id(fi))
                out.append(fi)

        # upward: class + bases transitively
        frontier = [cls_name]
        visited = set()
        while frontier:
            cname = frontier.pop()
            if cname in visited:
                continue
            visited.add(cname)
            for ci in self.classes.get(cname, []):
                add(ci.methods.get(meth))
                for b in ci.bases:
                    frontier.append(b.split(".")[-1])
        if include_derived:
            for ci in self.subclasses_of(cls_name):
                add(ci.methods.get(meth))
        return out

    # -- text scans --------------------------------------------------------
    def grep_count(self, needle: str, exclude_rel: Iterable[str] = ()
                   ) -> Dict[str, int]:
        """Occurrences of a literal substring per module (cheap text
        scan for reference audits; the AST checkers use real nodes)."""
        skip = set(exclude_rel)
        out: Dict[str, int] = {}
        for f in self.files:
            if f.rel in skip:
                continue
            n = f.text.count(needle)
            if n:
                out[f.rel] = n
        return out


# ---------------------------------------------------------------------------
# call graph


#: attribute-call names too generic to resolve across objects — an edge
#: through one of these would connect unrelated subsystems and drown the
#: reachability checkers in noise.  ``self.x()`` calls are NOT affected
#: (they resolve through the class hierarchy).
GENERIC_NAMES = frozenset({
    "get", "put", "set", "add", "pop", "send", "recv", "read", "write",
    "close", "stop", "start", "run", "join", "wait", "acquire", "release",
    "append", "appendleft", "extend", "clear", "copy", "update", "items",
    "keys", "values", "submit", "record", "inc", "dec", "encode", "decode",
    "save", "load", "reset", "flush", "count", "index", "sort", "split",
    "strip", "format", "register", "cancel", "result", "done", "discard",
    "remove", "insert", "lower", "upper", "setdefault", "mean", "sum",
})

#: how many distinct classes may declare a method before a foreign
#: attribute call to it is considered unresolvable (too ambiguous)
MAX_FOREIGN_CANDIDATES = 4


class CallGraph:
    """Name-based call resolution over a :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project

    def resolve(self, caller: FunctionInfo, call: CallSite
                ) -> List[FunctionInfo]:
        p = self.project
        if call.recv is None:
            # bare name: nested function of the caller, else module-level
            # function in the same module, else a class constructor
            for fn in caller.module.functions:
                if (fn.name == call.name
                        and fn.qualname == f"{caller.qualname}.{call.name}"):
                    return [fn]
            fn = p.module_functions.get((caller.module.rel, call.name))
            if fn is not None:
                return [fn]
            return []
        if call.recv in ("self", "cls"):
            if caller.cls is None:
                return []
            return p.mro_methods(caller.cls, call.name)
        # module-style receivers (time.sleep, np.x, threading.Event):
        # never project edges — the blocking detectors special-case them
        if call.recv.split(".")[0] in _STDLIB_RECEIVERS:
            return []
        if call.name in GENERIC_NAMES:
            return []
        cands = p.methods.get(call.name, [])
        owners = {fi.cls for fi in cands}
        if 0 < len(owners) <= MAX_FOREIGN_CANDIDATES:
            return list(cands)
        return []

    def reachable(self, roots: Sequence[FunctionInfo], max_depth: int = 10
                  ) -> Dict[int, Tuple[FunctionInfo, List[str]]]:
        """BFS over resolved call edges.  Returns ``{id(fn): (fn,
        chain)}`` where ``chain`` is the qualname path from the root
        (for the human-facing finding message)."""
        out: Dict[int, Tuple[FunctionInfo, List[str]]] = {}
        frontier: List[Tuple[FunctionInfo, List[str]]] = [
            (r, [r.source_id()]) for r in roots]
        depth = 0
        while frontier and depth <= max_depth:
            nxt: List[Tuple[FunctionInfo, List[str]]] = []
            for fn, chain in frontier:
                if id(fn) in out:
                    continue
                out[id(fn)] = (fn, chain)
                for call in fn.calls:
                    for callee in self.resolve(fn, call):
                        if id(callee) not in out:
                            nxt.append((callee,
                                        chain + [callee.qualname]))
            frontier = nxt
            depth += 1
        return out


_STDLIB_RECEIVERS = frozenset({
    "time", "os", "np", "numpy", "threading", "math", "json", "struct",
    "pickle", "io", "re", "sys", "logging", "socket", "selectors",
    "random", "collections", "heapq", "itertools", "traceback", "uuid",
    "jax", "jnp", "dataclasses", "enum", "pathlib", "shutil", "signal",
    "queue", "ast", "subprocess",
})


# ---------------------------------------------------------------------------
# checker base + registry


class Checker:
    """Base class: subclasses set ``name``/``description`` and implement
    :meth:`run`."""

    name = "base"
    description = ""

    def run(self, project: Project) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    # convenience
    def finding(self, path: str, line: int, qualname: str, symbol: str,
                message: str) -> Finding:
        return Finding(self.name, path, line,
                       finding_key(path, qualname, symbol), message)


def parent_map(tree: ast.AST) -> Dict[int, ast.AST]:
    """id(child) -> parent for ancestor walks inside one function."""
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out
