"""Checker: lock discipline for the ``*_locked`` naming convention and
the cross-module lock-acquisition-order graph.

Three rules (docs/static-analysis.md has the full catalog):

``unguarded-locked-call``
    Every call to a ``*_locked`` method must be *dominated* by holding a
    lock: the call sits lexically inside a ``with <lock>`` block (or an
    explicit ``.acquire()``/``.release()`` bracket) in the same
    function, OR the enclosing function is itself ``*_locked`` (the
    caller-chain contract), OR the enclosing function documents the
    chain (an ``assert`` mentioning the lock / a docstring saying the
    caller holds it), OR the call is in ``__init__`` (construction is
    pre-concurrent: the object has not been published to another thread
    yet).

``lock-order-cycle``
    Nested lock acquisitions define edges ``outer → inner`` (direct
    nesting, plus bounded-depth interprocedural edges: a call made
    under lock L into a function that acquires M yields L → M).  A
    cycle in that graph is a deadlock waiting for the right
    interleaving.  Reentrant self-edges (RLock re-entry) are ignored.

``drain-under-lock``
    ``ShardExecutor.drain()`` quiesces the merge lanes, and lane work
    takes key stripes — draining while holding the stripe lock (or the
    all-stripes barrier) is a lock-order inversion against every lane
    thread, so any ``.drain(`` call lexically under a ``with <lock>``
    is flagged.

Lock identity is name-based: a ``with`` item acquires a lock when its
expression is ``self.<attr>`` / ``<obj>.<attr>`` whose final attribute
looks like a lock (``*_mu``/``mu``/``*_lock``/``lock``/``*_cv``) or a
``.stripe(...)`` call on one.  Canonical lock names qualify the attr by
the class that declares it (``TcpFabric._registry_mu``), so one lock
used from several modules is one graph node.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from geomx_tpu_torch.analysis.core import (CallGraph, Checker, Finding,
                                     FunctionInfo, Project, _attr_chain)

_LOCK_ATTR = re.compile(r"^_?(?:[a-z0-9_]*_)?(?:mu|lock|cv|mutex)$")

#: docstring phrases that document a caller-holds contract
_DOC_PHRASES = ("caller holds", "callers hold", "under the lock",
                "with the lock held", "holding the lock", "caller must hold")


def _is_lock_attr(name: str) -> bool:
    return bool(_LOCK_ATTR.match(name))


def _lock_expr_name(expr: ast.expr) -> Optional[Tuple[str, bool]]:
    """``(attr_name, is_stripe)`` when ``expr`` acquires a lock:
    ``self._mu`` → ("_mu", False); ``self._mu.stripe(k)`` → ("_mu",
    True); bare module-level ``_registry_mu`` also counts."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "stripe":
        inner = _attr_chain(expr.func.value)
        if inner:
            attr = inner.split(".")[-1]
            if _is_lock_attr(attr):
                return attr, True
        return None
    chain = _attr_chain(expr)
    if chain is None:
        return None
    attr = chain.split(".")[-1]
    if _is_lock_attr(attr):
        return attr, False
    return None


class LockDiscipline(Checker):
    name = "lock-discipline"
    description = ("*_locked calls must hold a lock; the lock-acquisition"
                   " order graph must be acyclic; no lane drain() under a"
                   " lock")

    #: interprocedural depth for the acquires* closure
    ORDER_DEPTH = 3

    def run(self, project: Project) -> List[Finding]:
        graph = CallGraph(project)
        findings: List[Finding] = []
        # canonical lock naming: attr -> declaring classes
        declared: Dict[str, List[str]] = {}
        for f in project.files:
            for ci in f.classes.values():
                for attr in ci.lock_attrs:
                    declared.setdefault(attr, []).append(ci.name)

        def canon(fn: FunctionInfo, attr: str, stripe: bool) -> str:
            owners = declared.get(attr, [])
            if fn.cls is not None and fn.cls in owners:
                owner = fn.cls
            elif len(set(owners)) == 1:
                owner = owners[0]
            else:
                owner = fn.cls or fn.module.rel
            return f"{owner}.{attr}" + (".stripe" if stripe else "")

        # per-function: direct acquisitions + per-call held-lock context
        acquires: Dict[int, Set[str]] = {}
        order_edges: Dict[Tuple[str, str], Finding] = {}
        calls_under: List[Tuple[FunctionInfo, "ast.Call", Set[str]]] = []

        for fn in project.functions:
            held_at, acq = self._scan(fn, canon)
            acquires[id(fn)] = acq
            body = fn.node
            doc = (ast.get_docstring(body) or "").lower() \
                if not isinstance(body, ast.Lambda) else ""
            documented = any(p in doc for p in _DOC_PHRASES) \
                or self._has_lock_assert(fn)
            for call in fn.calls:
                held = held_at.get(id(call.node), frozenset())
                calls_under.append((fn, call.node, set(held)))
                # rule: *_locked call must be guarded
                if call.name.endswith("_locked"):
                    guarded = (bool(held) or fn.name.endswith("_locked")
                               or fn.is_init or documented)
                    if not guarded:
                        findings.append(self.finding(
                            fn.module.rel, call.line, fn.qualname,
                            call.name,
                            f"call to {call.name}() holds no lock: not "
                            "inside a with/acquire block, the caller is "
                            "not itself *_locked, and the function "
                            "documents no caller-holds contract"))
                # rule: drain under a held lock
                if call.name == "drain" and held:
                    findings.append(self.finding(
                        fn.module.rel, call.line, fn.qualname,
                        "drain-under-lock",
                        f"lane drain() called while holding "
                        f"{sorted(held)} — lane work takes key stripes, "
                        "so draining under a lock inverts the lane "
                        "ordering and can deadlock"))
            # direct nesting edges
            for outer, inner, line in self._nesting(fn, canon):
                if outer != inner:
                    order_edges.setdefault((outer, inner), self.finding(
                        fn.module.rel, line, fn.qualname,
                        f"order:{outer}->{inner}",
                        f"acquires {inner} while holding {outer}"))

        # interprocedural order edges: call under L into g ⇒ L → each
        # lock in acquires*(g) (bounded closure)
        closure = self._acquire_closure(project, graph, acquires)
        for fn, call_node, held in calls_under:
            if not held:
                continue
            site = None
            for c in fn.calls:
                if c.node is call_node:
                    site = c
                    break
            if site is None:
                continue
            for callee in graph.resolve(fn, site):
                for inner in closure.get(id(callee), ()):
                    for outer in held:
                        if outer != inner:
                            order_edges.setdefault(
                                (outer, inner), self.finding(
                                    fn.module.rel, site.line, fn.qualname,
                                    f"order:{outer}->{inner}",
                                    f"calls {callee.qualname}() (which "
                                    f"acquires {inner}) while holding "
                                    f"{outer}"))

        findings.extend(self._cycles(order_edges))
        return findings

    # -- function-local lock tracking -------------------------------------
    def _scan(self, fn: FunctionInfo, canon):
        """Map id(call-node) -> frozenset of canonical locks lexically
        held at that call, plus the set of locks this function acquires
        anywhere."""
        held_at: Dict[int, frozenset] = {}
        acquired: Set[str] = set()

        def visit(node: ast.AST, held: frozenset):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn.node:
                return  # nested defs are separate functions
            new_held = held
            if isinstance(node, ast.With):
                got = []
                for item in node.items:
                    ln = _lock_expr_name(item.context_expr)
                    if ln is not None:
                        got.append(canon(fn, *ln))
                if got:
                    acquired.update(got)
                    new_held = held | frozenset(got)
                for item in node.items:
                    visit(item.context_expr, held)
                for child in node.body:
                    visit(child, new_held)
                return
            if isinstance(node, ast.Call):
                held_at[id(node)] = held
                # explicit lock.acquire() also counts as acquisition
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "acquire":
                    ln = _lock_expr_name(node.func.value)
                    if ln is not None:
                        acquired.add(canon(fn, *ln))
            for child in ast.iter_child_nodes(node):
                visit(child, new_held)

        body = fn.node.body if not isinstance(fn.node, ast.Lambda) \
            else [ast.Expr(fn.node.body)]
        for stmt in body:
            visit(stmt, frozenset())
        return held_at, acquired

    def _nesting(self, fn: FunctionInfo, canon):
        """Direct (outer, inner, line) nesting pairs inside one
        function."""
        out: List[Tuple[str, str, int]] = []

        def visit(node: ast.AST, held: List[str]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn.node:
                return
            if isinstance(node, ast.With):
                got = []
                for item in node.items:
                    ln = _lock_expr_name(item.context_expr)
                    if ln is not None:
                        got.append(canon(fn, *ln))
                for g in got:
                    for h in held:
                        out.append((h, g, node.lineno))
                for child in node.body:
                    visit(child, held + got)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        if not isinstance(fn.node, ast.Lambda):
            for stmt in fn.node.body:
                visit(stmt, [])
        return out

    def _has_lock_assert(self, fn: FunctionInfo) -> bool:
        if isinstance(fn.node, ast.Lambda):
            return False
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assert):
                src = ast.dump(node)
                if "_mu" in src or "lock" in src.lower():
                    return True
        return False

    # -- order graph -------------------------------------------------------
    def _acquire_closure(self, project: Project, graph: CallGraph,
                         direct: Dict[int, Set[str]]) -> Dict[int, Set[str]]:
        closure = {k: set(v) for k, v in direct.items()}
        for _ in range(self.ORDER_DEPTH):
            changed = False
            for fn in project.functions:
                acc = closure.setdefault(id(fn), set())
                before = len(acc)
                for call in fn.calls:
                    for callee in graph.resolve(fn, call):
                        acc |= closure.get(id(callee), set())
                if len(acc) != before:
                    changed = True
            if not changed:
                break
        return closure

    def _cycles(self, edges: Dict[Tuple[str, str], Finding]
                ) -> List[Finding]:
        adj: Dict[str, Set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
        findings: List[Finding] = []
        seen_cycles: Set[frozenset] = set()
        # DFS cycle detection, reporting each distinct node set once
        for start in sorted(adj):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == path[0] and len(path) > 1:
                        key = frozenset(path)
                        if key not in seen_cycles:
                            seen_cycles.add(key)
                            witness = edges[(path[0], path[1])]
                            findings.append(Finding(
                                self.name, witness.path, witness.line,
                                "lock-order-cycle::" + "->".join(
                                    sorted(path)),
                                "lock acquisition order cycle: "
                                + " -> ".join(path + [path[0]])))
                    elif nxt not in path and len(path) < 6:
                        stack.append((nxt, path + [nxt]))
        return findings
