"""Customer: request/response timestamp tracking + handler threads.

Mirrors the reference Customer (ref: ps-lite/include/ps/internal/customer.h:28-123):
each outbound request gets a timestamp; responses are counted against it;
``wait`` blocks until all expected responses arrive.  Inbound messages are
processed on dedicated handler threads.  Like the reference (ref:
customer.h:91-101 pull-queue split in Accept), pull *requests* can be routed
to a separate queue/thread on the server so that slow push aggregation
cannot starve pull serving.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

from geomx_tpu_torch.ps.postoffice import Postoffice
from geomx_tpu_torch.trace import context as _tctx
from geomx_tpu_torch.transport.message import Message


class Customer:
    def __init__(
        self,
        app_id: int,
        customer_id: int,
        handler: Callable[[Message], None],
        postoffice: Postoffice,
        split_pull_queue: bool = False,
        owns_app: bool = False,
    ):
        self.app_id = app_id
        self.customer_id = customer_id
        self._handler = handler
        self.postoffice = postoffice
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._expected: Dict[int, int] = {}
        self._responded: Dict[int, int] = {}
        self._listeners: Dict[int, list] = {}
        # completion record: all ts < _watermark are complete; stragglers
        # (completed out of order) sit in _completed until the gap closes
        self._completed: set = set()
        self._watermark = 0
        self._next_ts = 0
        # deterministic mode (NaiveEngine analog): no handler threads —
        # accept() processes inline on the fabric's single dispatcher,
        # keeping one global total order of all handler executions
        self._inline = bool(postoffice.config.deterministic)
        self._q: "queue.Queue[Optional[Message]]" = queue.Queue()
        # split pull lane (ref: customer.h:91-101): pure pull REQUESTS
        # bypass the push/command queue onto their own thread, so pull
        # serving is never head-of-line blocked behind a long merge
        # dispatch.  ON by default for server roles (KVServer passes
        # split_pull_queue=True); the inline/deterministic path stays
        # single-ordered — a second lane would break the NaiveEngine
        # analog's global total order, so it is deliberately untouched.
        self._pull_q: Optional["queue.Queue[Optional[Message]]"] = (
            queue.Queue() if (split_pull_queue and not self._inline)
            else None
        )
        self._threads = []
        # lightweight-party mode (transport/reactor.py): handler threads
        # become serial channels on the shared reactor pool — identical
        # per-customer FIFO order (and the same split pull lane as a
        # SECOND channel), O(1) threads in node count
        fabric = postoffice.van.fabric
        self._light = bool((not self._inline)
                           and getattr(fabric, "lightweight", False))
        self._chan = None
        self._pull_chan = None
        postoffice.register_customer(self, owns_app=owns_app)
        if self._light:
            reactor = fabric.reactor
            self._chan = reactor.channel(
                self._process,
                name=f"customer-{postoffice.node}-{app_id}.{customer_id}")
            if split_pull_queue:
                self._pull_chan = reactor.channel(
                    self._process,
                    name=f"customer-pull-{postoffice.node}"
                         f"-{app_id}.{customer_id}")
        elif not self._inline:
            t = threading.Thread(
                target=self._loop, args=(self._q,),
                name=f"customer-{postoffice.node}-{app_id}.{customer_id}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
            if self._pull_q is not None:
                t2 = threading.Thread(
                    target=self._loop, args=(self._pull_q,),
                    name=f"customer-pull-{postoffice.node}-{app_id}.{customer_id}",
                    daemon=True,
                )
                t2.start()
                self._threads.append(t2)

    # ---- request tracking ---------------------------------------------------
    def new_request(
        self, num_responses: int, on_complete: Optional[Callable[[], None]] = None
    ) -> int:
        """Allocate a timestamp expecting `num_responses` responses
        (ref: customer.h:66 NewRequest(recver) counts group members).

        ``on_complete`` fires once, on the thread delivering the final
        response — used for event-driven chaining (push-up → ack → pull-down)
        without blocking a thread in wait().
        """
        with self._lock:
            ts = self._next_ts
            self._next_ts += 1
            if num_responses <= 0:
                # degenerate request: complete immediately
                self._completed.add(ts)
                while self._watermark in self._completed:
                    self._completed.discard(self._watermark)
                    self._watermark += 1
            else:
                self._expected[ts] = num_responses
                self._responded[ts] = 0
            if on_complete is not None:
                if self._is_complete_locked(ts):
                    pass  # fired below, outside the lock
                else:
                    self._listeners.setdefault(ts, []).append(on_complete)
                    on_complete = None
        if on_complete is not None:
            on_complete()
        return ts

    def add_response(self, ts: int, count: int = 1):
        fire = []
        with self._cv:
            self._responded[ts] = self._responded.get(ts, 0) + count
            if self._responded[ts] >= self._expected.get(ts, 0):
                self._expected.pop(ts, None)
                self._responded.pop(ts, None)
                self._completed.add(ts)
                while self._watermark in self._completed:
                    self._completed.discard(self._watermark)
                    self._watermark += 1
                fire = self._listeners.pop(ts, [])
            self._cv.notify_all()
        for cb in fire:
            cb()

    def add_completion_listener(self, ts: int, fn: Callable[[], None]):
        """Run fn when ts completes (immediately if it already has).

        The ordering primitive the reference gets from the MXNet dependency
        engine (pull-op depends on push-op of the same key)."""
        with self._lock:
            if not self._is_complete_locked(ts):
                self._listeners.setdefault(ts, []).append(fn)
                return
        fn()

    def _is_complete_locked(self, ts: int) -> bool:
        return ts < self._watermark or ts in self._completed

    def num_response(self, ts: int) -> int:
        with self._lock:
            return self._responded.get(ts, 0)

    def wait(self, ts: int, timeout: Optional[float] = 120.0):
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._is_complete_locked(ts), timeout=timeout
            )
        if not ok:
            raise TimeoutError(
                f"{self.postoffice.node}: wait(ts={ts}) timed out "
                f"({self.num_response(ts)}/{self._expected.get(ts)})"
            )

    # ---- inbound ------------------------------------------------------------
    def _invoke_traced(self, msg: Message):
        """Run the handler with the message's trace context installed:
        handler-side spans (and any messages the handler sends — the
        merge→push-up→pull-down chain) become children of the inbound
        message, which is what connects one round's spans across nodes.
        Callers gate on ``ACTIVE and msg.trace_id`` FIRST so untraced
        messages pay one attribute read, not an extra frame."""
        prev = _tctx.swap(_tctx.TraceContext(msg.trace_id, msg.span_id))
        try:
            self._handler(msg)
        finally:
            _tctx.restore(prev)

    def accept(self, msg: Message):
        if self._inline:
            try:
                if _tctx.ACTIVE and msg.trace_id > 0:
                    self._invoke_traced(msg)
                else:
                    self._handler(msg)
            except Exception:  # pragma: no cover
                import traceback

                traceback.print_exc()
            return
        if self._light:
            is_pull = (self._pull_chan is not None and msg.request
                       and msg.pull and not msg.push)
            (self._pull_chan if is_pull else self._chan).put(msg)
            return
        if self._pull_q is not None and msg.request and msg.pull and not msg.push:
            self._pull_q.put(msg)
        else:
            self._q.put(msg)

    def _process(self, msg: Message):
        """One handler invocation (the loop body, also the lightweight
        channels' callback)."""
        try:
            if _tctx.ACTIVE and msg.trace_id > 0:
                self._invoke_traced(msg)
            else:
                self._handler(msg)
        except Exception:  # pragma: no cover
            import traceback

            traceback.print_exc()

    def _loop(self, q: "queue.Queue[Optional[Message]]"):
        while True:
            msg = q.get()
            if msg is None:
                return
            self._process(msg)

    def stop(self):
        if self._chan is not None:
            self._chan.close()
        if self._pull_chan is not None:
            self._pull_chan.close()
        self._q.put(None)
        if self._pull_q is not None:
            self._pull_q.put(None)
