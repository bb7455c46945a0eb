"""Checker: no blocking primitives reachable from reactor contexts.

Under ``GEOMX_TRANSPORT=reactor`` (transport/reactor.py) every node's
inbound dispatch, timers and socket callbacks run on a small shared
pool — a handler that parks its thread stalls *other nodes'* traffic,
and at O(100) parties that is a cluster-wide wedge, not a local bug
(the PR 13 warm-boot wedge was exactly a blocking ``send_cmd`` inside a
handler).  This checker finds the reactor entry points statically and
walks the call graph a bounded depth looking for blocking primitives.

Roots (all discovered from the AST, no runtime needed):

- *strict* contexts — must never block at all:
  ``reactor.channel(cb)`` callbacks (``SerialChannel`` dispatch — in
  lightweight mode this is every Customer handler), ``call_later`` fns
  (they run ON the selector loop thread), ``register(read_cb=/
  write_cb=)`` socket callbacks (also loop-thread), ``Customer(...)``
  handler arguments, and any function assigned to a ``*_handler`` /
  ``*_cb`` / ``*_hook`` attribute (the codebase's callback idiom).
- *periodic* contexts — may block briefly on a bounded timeout, never
  unboundedly: ``call_every`` / ``Periodic`` tick functions (they run
  on the worker pool; the reactor skips overlapped ticks).

Blocking primitives::

    sleep            time.sleep(...)
    wait-unbounded   .wait() / .wait(timeout=None)
    wait-default     .wait(x) with no timeout= (Customer.wait's default
                     is 120 s — two minutes of a shared pool worker)
    queue-get        .get() with no args (queue.get blocks; dict.get
                     always takes a key, so zero-arg get IS a queue)
    thread-join      .join() with no timeout
    send-cmd         send_cmd(...) without wait=False (the default
                     wait=True parks in Customer.wait; pass wait=False
                     and poll, or hand the work to a thread)
    wait-true        any call with an explicit wait=True kwarg
    drain            ShardExecutor.drain() (waits on the merge lanes)
    future-result    .result() with no timeout

Strict contexts flag all of them; periodic contexts flag only the
unbounded ones (sleep, wait-unbounded, queue-get, thread-join,
send-cmd, wait-true).  Handing work to ``threading.Thread(target=...)``
is the sanctioned escape hatch and is naturally invisible here — the
graph only follows *calls*, and a Thread target is not called by its
spawner.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from geomx_tpu_torch.analysis.core import (CallGraph, CallSite, Checker, Finding,
                                     FunctionInfo, Project, _attr_chain)

_HANDLER_ATTR_SUFFIXES = ("_handler", "_cb", "_hook", "handler")

#: codes flagged even in periodic (bounded-tick) contexts
_UNBOUNDED = frozenset({"sleep", "wait-unbounded", "queue-get",
                        "thread-join", "send-cmd", "wait-true"})

MAX_DEPTH = 8


def _timeout_kw(call: CallSite) -> Optional[ast.expr]:
    return call.keyword("timeout")


def classify_blocking(call: CallSite) -> Optional[str]:
    """The blocking-primitive code for one call site, or None."""
    name, recv = call.name, call.recv
    if name == "sleep" and recv == "time":
        return "sleep"
    if name in ("wait", "wait_for"):
        to = _timeout_kw(call)
        if to is not None:
            if isinstance(to, ast.Constant) and to.value is None:
                return "wait-unbounded"
            return None  # explicitly bounded
        if call.num_pos_args == 0:
            return "wait-unbounded"
        if call.num_pos_args >= 2:
            return None  # wait(x, timeout) / wait_for(pred, t) positional
        # one positional arg: Event.wait(t) is bounded by it, but
        # Customer.wait(ts) falls back to the 120 s default — the exact
        # send_cmd wedge class, so the customer shape is flagged
        if call.recv is not None and "customer" in call.recv:
            return "wait-default"
        return None
    if name == "get" and call.num_pos_args == 0 and not call.node.keywords:
        return "queue-get"
    if name == "join" and call.num_pos_args == 0 \
            and not call.has_keyword("timeout"):
        # str.join always takes the iterable positionally, so a
        # zero-arg join can only be a thread/process join
        return "thread-join"
    if name == "send_cmd":
        if call.keyword_is_const("wait", False):
            return None
        return "send-cmd"
    if call.keyword_is_const("wait", True):
        return "wait-true"
    if name == "drain":
        return "drain"
    if name == "result" and call.num_pos_args == 0 \
            and not call.has_keyword("timeout"):
        return "future-result"
    return None


class ReactorBlocking(Checker):
    name = "reactor-blocking"
    description = ("no blocking primitives reachable from SerialChannel "
                   "handlers, selector callbacks, or timer ticks")

    def run(self, project: Project) -> List[Finding]:
        graph = CallGraph(project)
        strict_roots, periodic_roots = self._roots(project, graph)
        findings: List[Finding] = []
        seen: Set[str] = set()
        strict_reach = graph.reachable(
            sorted(strict_roots.values(), key=lambda r: r.source_id()),
            max_depth=MAX_DEPTH)
        periodic_reach = graph.reachable(
            sorted(periodic_roots.values(), key=lambda r: r.source_id()),
            max_depth=MAX_DEPTH)
        for reach, mode in ((strict_reach, "strict"),
                            (periodic_reach, "periodic")):
            for fn, chain in reach.values():
                # a function reached by BOTH modes reports under strict
                # only (the superset rule set)
                if mode == "periodic" and id(fn) in strict_reach:
                    continue
                for call in fn.calls:
                    code = classify_blocking(call)
                    if code is None:
                        continue
                    if mode == "periodic" and code not in _UNBOUNDED:
                        continue
                    f = self.finding(
                        fn.module.rel, call.line, fn.qualname,
                        f"{code}:{call.name}",
                        f"{code}: {call.name}() can block a "
                        f"{'reactor dispatch/loop' if mode == 'strict' else 'timer-wheel tick'}"
                        f" context (via {' -> '.join(chain)})")
                    if f.key not in seen:
                        seen.add(f.key)
                        findings.append(f)
        return findings

    # -- root discovery ----------------------------------------------------
    def _roots(self, project: Project, graph: CallGraph
               ) -> Tuple[Dict[str, FunctionInfo], Dict[str, FunctionInfo]]:
        strict: Dict[str, FunctionInfo] = {}
        periodic: Dict[str, FunctionInfo] = {}

        def add(table: Dict[str, FunctionInfo],
                fns: List[FunctionInfo]) -> None:
            for fn in fns:
                table.setdefault(fn.source_id(), fn)

        for fn in project.functions:
            for call in fn.calls:
                args = call.node.args
                if call.name == "channel" and args:
                    add(strict, self._funcref(project, fn, args[0]))
                elif call.name == "call_later" and len(args) >= 2:
                    add(strict, self._funcref(project, fn, args[1]))
                elif call.name == "call_every" and len(args) >= 2:
                    add(periodic, self._funcref(project, fn, args[1]))
                elif call.name == "Periodic" and len(args) >= 2:
                    add(periodic, self._funcref(project, fn, args[1]))
                elif call.name == "Customer" and len(args) >= 3:
                    add(strict, self._funcref(project, fn, args[2]))
                elif call.name == "register":
                    for kw in call.node.keywords:
                        if kw.arg in ("read_cb", "write_cb"):
                            add(strict,
                                self._funcref(project, fn, kw.value))
            # attribute-assigned handlers: self.x_handler = self._f
            self._handler_assigns(project, fn, strict)
        return strict, periodic

    def _handler_assigns(self, project: Project, fn: FunctionInfo,
                         strict: Dict[str, FunctionInfo]) -> None:
        node = fn.node
        if isinstance(node, ast.Lambda):
            return
        for n in ast.walk(node):
            if not isinstance(n, ast.Assign):
                continue
            for tgt in n.targets:
                if not isinstance(tgt, ast.Attribute):
                    continue
                if not any(tgt.attr.endswith(s)
                           for s in _HANDLER_ATTR_SUFFIXES):
                    continue
                for ref in self._funcref(project, fn, n.value):
                    strict.setdefault(ref.source_id(), ref)

    def _funcref(self, project: Project, ctx: FunctionInfo,
                 expr: ast.expr) -> List[FunctionInfo]:
        """Resolve a callback-reference expression to project
        functions."""
        # functools.partial(f, ...) / lambda wrappers
        if isinstance(expr, ast.Call):
            fname = (expr.func.attr if isinstance(expr.func, ast.Attribute)
                     else expr.func.id if isinstance(expr.func, ast.Name)
                     else "")
            if fname == "partial" and expr.args:
                return self._funcref(project, ctx, expr.args[0])
            return []
        if isinstance(expr, ast.Lambda):
            for fn in ctx.module.functions:
                if fn.node is expr:
                    return [fn]
            return []
        chain = _attr_chain(expr)
        if chain is None:
            return []
        parts = chain.split(".")
        if parts[0] in ("self", "cls") and len(parts) == 2:
            if ctx.cls is None:
                return []
            return project.mro_methods(ctx.cls, parts[1])
        if len(parts) == 1:
            fn = project.module_functions.get((ctx.module.rel, parts[0]))
            if fn is not None:
                return [fn]
            # nested function of the current one
            for fn in ctx.module.functions:
                if fn.qualname == f"{ctx.qualname}.{parts[0]}":
                    return [fn]
            return []
        # foreign attr ref (obj.method): unique-name resolution
        cands = project.methods.get(parts[-1], [])
        owners = {c.cls for c in cands}
        if 0 < len(owners) <= 3:
            return list(cands)
        return []
