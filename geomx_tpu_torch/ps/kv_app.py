"""KV application layer: KVWorker push/pull + KVServer request handling.

Mirrors the reference kv_app (ref: ps-lite/include/ps/kv_app.h:171-336
KVWorker::{ZPush,ZPull,Wait}; :480-534 KVServer::{Process,Response}) plus
the SimpleApp command channel (ref: ps-lite/include/ps/simple_app.h) used
for control commands (sync mode, optimizer distribution, profiler control).

Message discrimination: data messages always have ``push`` or ``pull`` set;
command messages have neither (the reference uses a separate SimpleApp
customer instead).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from geomx_tpu_torch.core.config import NodeId
from geomx_tpu_torch.ps.customer import Customer
from geomx_tpu_torch.ps.postoffice import KeyRange, Postoffice
from geomx_tpu_torch.transport.message import Control, Domain, Message


@dataclasses.dataclass
class KVPairs:
    """A batch of key→value-slab pairs (ref: kv_app.h:57 KVPairs).

    ``tags`` optionally carries a per-key codec tag (for compressed pull
    responses, where different keys of one message may use different
    codecs — the MPQ case)."""

    keys: np.ndarray                      # int64 [n]
    vals: np.ndarray                      # flat payload
    lens: Optional[np.ndarray] = None     # int64 [n]; elements of vals per key
    tags: Optional[dict] = None           # int key -> compr tag
    pv: Optional[dict] = None             # int key -> pull-view version
    #                                       (BSC pull handshake; see
    #                                       BroadcastCompressor.compress)
    wv: Optional[dict] = None             # int key -> weight version
    #                                       (global pull-down ordering
    #                                       stamp; see GlobalServer.
    #                                       _weight_wv)

    def __post_init__(self):
        self.keys = np.asarray(self.keys, dtype=np.int64)
        if self.lens is None:
            assert len(self.keys) == 1, "lens required for multi-key KVPairs"
            self.lens = np.array([len(self.vals)], dtype=np.int64)
        self.lens = np.asarray(self.lens, dtype=np.int64)

    def slices(self):
        """Iterate (key, val_slice) pairs."""
        off = 0
        for k, ln in zip(self.keys, self.lens):
            yield int(k), self.vals[off:off + ln]
            off += ln


class _App:
    """Shared base: owns a Customer, provides the command channel."""

    def __init__(
        self,
        app_id: int,
        customer_id: int,
        postoffice: Postoffice,
        split_pull_queue: bool = False,
        owns_app: bool = False,
    ):
        self.postoffice = postoffice
        self.cmd_handler: Optional[Callable[[Message], None]] = None
        self._cmd_responses: Dict[int, object] = {}
        from geomx_tpu_torch.transport.dgt import DgtReassembler

        self._dgt_reasm = DgtReassembler()
        self.customer = Customer(
            app_id, customer_id, self._process_outer, postoffice,
            split_pull_queue=split_pull_queue, owns_app=owns_app,
        )

    def _process_outer(self, msg: Message):
        """DGT chunk reassembly in front of normal processing
        (ref: Van::ProcessDataMsg reassembly before Customer::Accept)."""
        if msg.seq >= 0:
            whole = self._dgt_reasm.accept(msg)
            if whole is None:
                return
            msg = whole
        self._process(msg)

    def send_cmd(
        self,
        recipient: NodeId,
        head: int,
        body=None,
        domain: Domain = Domain.LOCAL,
        wait: bool = True,
    ):
        """Send a control command. With ``wait`` returns the response body;
        otherwise the timestamp (read the body later via cmd_response)."""
        ts = self.customer.new_request(1)
        self.postoffice.van.send(Message(
            recipient=recipient, domain=domain, app_id=self.customer.app_id,
            customer_id=self.customer.customer_id, timestamp=ts, request=True,
            cmd=head, body=body,
        ))
        if wait:
            self.customer.wait(ts)
            return self._cmd_responses.pop(ts, None)
        return ts

    def cmd_response(self, ts: int):
        return self._cmd_responses.pop(ts, None)

    def reply_cmd(self, req: Message, body=None):
        self.postoffice.van.send(req.reply_to(body=body))

    def wait(self, ts: int):
        self.customer.wait(ts)

    def _process(self, msg: Message):
        raise NotImplementedError

    def _handle_command(self, msg: Message):
        if msg.request:
            if self.cmd_handler is not None:
                self.cmd_handler(msg)
            else:
                self.reply_cmd(msg)  # default: bare ACK
        else:
            if msg.body is not None:
                self._cmd_responses[msg.timestamp] = msg.body
            self.customer.add_response(msg.timestamp)

    def stop(self):
        self.customer.stop()


class KVWorker(_App):
    """Client endpoint pushing/pulling key ranges to a server group.

    ``targets`` is the ordered server list (tier-1: the party's local
    server; tier-2: all global servers) and ``key_ranges`` their owned
    ranges — requests are sliced per server like the reference slicer
    (ref: kv_app.h:788-839 DefaultSlicer).
    """

    def __init__(
        self,
        app_id: int,
        customer_id: int,
        postoffice: Postoffice,
        targets: Sequence[NodeId],
        key_ranges: Sequence[KeyRange],
        domain: Domain = Domain.LOCAL,
        owns_app: bool = False,
    ):
        super().__init__(app_id, customer_id, postoffice, owns_app=owns_app)
        assert len(targets) == len(key_ranges)
        self.targets = list(targets)
        self.key_ranges = list(key_ranges)
        self.domain = domain
        # inbound-request hook (TSEngine overlay relays arrive at workers
        # as data requests, ref: TS_Process kv_app.h:1111-1179)
        self.ts_handler: Optional[Callable[[Message], None]] = None
        # error-response hook: sees every response whose body carries an
        # "error" BEFORE it lands in self.errors; return True to claim it
        # (the response still counts toward completion — claiming only
        # suppresses the errors-list entry).  The adaptive-WAN local
        # server uses this to turn policy-fence replies into a re-encode
        # + retry instead of a surfaced failure.
        self.error_handler: Optional[Callable[[Message], bool]] = None
        # DGT chunking applies on the WAN domain when enabled
        # (ref: KVServer::Send DGT branch kv_app.h:917-995)
        self.dgt_sender = None
        if postoffice.config.enable_dgt and domain is Domain.GLOBAL:
            from geomx_tpu_torch.transport.dgt import DgtSender

            self.dgt_sender = DgtSender(postoffice.config)
        self._pull_bufs: Dict[int, List[KVPairs]] = {}
        self._pull_cbs: Dict[int, Callable[[KVPairs], None]] = {}
        self._pull_expected: Dict[int, int] = {}
        self._mu = threading.Lock()
        # server-reported errors (e.g. rejected pushes); surfaced by the
        # kvstore client on wait_all — a bare ACK would hide them
        self.errors: List[str] = []
        # application-level request replay (elastic recovery): a request
        # whose response hasn't arrived within request_retry_s is re-sent
        # to the targets that haven't answered; servers dedup replays by
        # (sender, app, customer, ts).  This is what survives a server
        # crash+restart — transport resend only covers lost *delivery*,
        # not state lost with a dead process.
        self._retry_s = float(postoffice.config.request_retry_s or 0.0)
        # backoff shape from Config (chaos soaks tighten these via env —
        # GEOMX_RETRY_BACKOFF_CAP / GEOMX_RETRY_JITTER — instead of
        # editing source); deterministic mode forces jitter off so the
        # replay schedule reproduces run-to-run
        cfg = postoffice.config
        self._retry_cap = max(1, int(getattr(cfg, "retry_backoff_cap", 8)))
        self._retry_jitter = (0.0 if getattr(cfg, "deterministic", False)
                              else float(getattr(cfg, "retry_jitter", 0.0)))
        self._inflight: Dict[int, dict] = {}  # ts -> {deadline, attempts,
        #                                       msgs: {target_str: Message}}
        self._retry_stop = threading.Event()
        if self._retry_s > 0:
            threading.Thread(
                target=self._retry_loop, daemon=True,
                name=f"kv-retry-{postoffice.node}-{app_id}.{customer_id}",
            ).start()

    # ---- request replay (elastic recovery) ----------------------------------
    def _track(self, ts: int, msgs: List[Message]):
        if self._retry_s <= 0 or not msgs:
            return
        import time

        with self._mu:
            self._inflight[ts] = {
                "deadline": time.monotonic() + self._retry_s,
                "attempts": 0,
                "msgs": {str(m.recipient): m for m in msgs},
            }

    def _on_response_tracked(self, msg: Message) -> bool:
        """Drop-duplicate filter; returns False for a response from a
        target that already answered this request (a replayed request can
        produce two responses — counting both would complete the request
        before the *other* targets answered)."""
        if self._retry_s <= 0:
            return True
        with self._mu:
            ent = self._inflight.get(msg.timestamp)
            if ent is None:
                return False  # request already complete → duplicate
            if ent["msgs"].pop(str(msg.sender), None) is None:
                return False  # this target already answered
            if not ent["msgs"]:
                del self._inflight[msg.timestamp]
        return True

    def retarget(self, old: NodeId, new: NodeId) -> int:
        """Global-tier failover: replace server ``old`` with ``new`` and
        REPLAY every un-ACKed request that was addressed to it.

        Future sends route to ``new`` (the targets slot swaps in place —
        key ranges are positional, and the standby owns exactly its
        primary's shard).  In-flight requests are re-addressed and
        re-sent NOW rather than waiting out the retry backoff; mutating
        the tracked Message in place also re-points the van resender's
        pending-ACK entry, so transport-level retransmits follow the new
        primary too.  Exactly-once across the replay is the standby's
        job: it was seeded with the primary's replay-dedup window, so a
        request the dead primary applied *and* replicated is re-acked
        without re-applying.  Returns the number of replayed requests.
        """
        old_s, new_s = str(old), str(new)
        resend: List[Message] = []
        with self._mu:
            for i, t in enumerate(self.targets):
                if str(t) == old_s:
                    self.targets[i] = new
            for ent in self._inflight.values():
                m = ent["msgs"].pop(old_s, None)
                if m is not None:
                    m.recipient = new
                    ent["msgs"][new_s] = m
                    resend.append(m)
        for m in resend:
            try:
                self.postoffice.van.send(m)
            except (KeyError, OSError):
                pass  # the retry loop re-sends once the standby is up
        return len(resend)

    def _retry_loop(self):
        import random
        import time

        while not self._retry_stop.wait(min(self._retry_s / 4, 1.0)):
            now = time.monotonic()
            resend: List[Message] = []
            with self._mu:
                for ent in self._inflight.values():
                    if now >= ent["deadline"]:
                        ent["attempts"] += 1
                        backoff = min(2 ** ent["attempts"], self._retry_cap)
                        if self._retry_jitter > 0.0:
                            # desynchronize: a whole party's replays must
                            # not stampede a freshly promoted shard in
                            # lockstep
                            backoff *= 1.0 + random.uniform(
                                0.0, self._retry_jitter)
                        ent["deadline"] = now + self._retry_s * backoff
                        resend.extend(ent["msgs"].values())
            for m in resend:
                try:
                    self.postoffice.van.send(m)
                except (KeyError, OSError):
                    pass  # peer still down — the next sweep retries

    # ---- slicing ------------------------------------------------------------
    def _slice(self, kvs: KVPairs) -> List[tuple]:
        """Partition KVPairs by the server CURRENTLY holding each key
        range; returns ``[(target NodeId, KVPairs), ...]``.  Keys must
        be sorted.

        Grouped by target NODE, not by range slot: after a key-range
        reassignment (shard drain) or chained failovers, two ranges may
        be held by one server — one message (and one response) per
        server keeps the response tracker's per-target accounting
        correct (two same-recipient messages under one timestamp would
        make the dedup filter eat the second real response)."""
        groups: Dict[str, list] = {}  # target-str -> [node, ks, vs, ls]
        targets = list(self.targets)  # retarget() swaps slots in place
        off = 0
        for k, ln in zip(kvs.keys, kvs.lens):
            k = int(k)
            sid = None
            for i, r in enumerate(self.key_ranges):
                if r.contains(k):
                    sid = i
                    break
            if sid is None:
                raise KeyError(f"key {k} outside all server ranges")
            node = targets[sid]
            ent = groups.setdefault(str(node), [node, [], [], []])
            ent[1].append(k)
            ent[2].append(kvs.vals[off:off + ln])
            ent[3].append(int(ln))
            off += ln
        return [
            (e[0], KVPairs(
                keys=np.array(e[1], dtype=np.int64),
                # single-slice parts stay views of the caller's payload —
                # concatenate([one]) would be a full copy, which at the
                # big-tensor scale regime is ~0.2 s per hop
                vals=(e[2][0] if len(e[2]) == 1
                      else np.concatenate(e[2]) if e[2]
                      else np.empty(0, kvs.vals.dtype)),
                lens=np.array(e[3], dtype=np.int64),
            ))
            for e in groups.values()
        ]

    # ---- public API ---------------------------------------------------------
    def zpush(
        self,
        kvs: KVPairs,
        cmd: int = 0,
        priority: int = 0,
        wait: bool = False,
        on_complete=None,
        **msg_fields,
    ) -> int:
        """Push values to their owning servers (ref: kv_app.h:171 ZPush)."""
        parts = self._slice(kvs)
        ts = self.customer.new_request(len(parts), on_complete=on_complete)
        sends: List[tuple] = []
        for target, part in parts:
            m = Message(
                recipient=target, domain=self.domain,
                app_id=self.customer.app_id, customer_id=self.customer.customer_id,
                timestamp=ts, request=True, push=True, cmd=cmd, priority=priority,
                keys=part.keys, vals=part.vals, lens=part.lens, **msg_fields,
            )
            # DGT applies only to recurring gradient pushes: INIT and HFA
            # milestone deltas are one-shot — a dropped chunk would be
            # permanent corruption, not a delayed update
            use_dgt = (self.dgt_sender is not None and cmd == 0
                       and m.compr in ("", "fp16") and m.vals is not None
                       and len(m.vals) > self.dgt_sender.block_size)
            sends.append((m, use_dgt))
        # track BEFORE sending — a loopback-fast response must not race
        # the bookkeeping and be dropped as a duplicate.  DGT pushes are
        # tracked as their unsplit original: a replay re-sends the whole
        # message reliably (seq=-1 bypasses chunk reassembly).
        self._track(ts, [m for m, _ in sends])
        for m, use_dgt in sends:
            if use_dgt:
                m.sender = self.postoffice.node  # split() copies sender
                for chunk in self.dgt_sender.split(m):
                    self.postoffice.van.send(chunk)
            else:
                self.postoffice.van.send(m)
        if wait:
            self.customer.wait(ts)
        return ts

    def zpull(
        self,
        keys: Sequence[int],
        cb: Optional[Callable[[KVPairs], None]] = None,
        cmd: int = 0,
        priority: int = 0,
        wait: bool = False,
        on_complete=None,
        after_ts: Optional[int] = None,
        **msg_fields,
    ) -> int:
        """Pull values for keys; cb runs with the merged result before
        wait() unblocks (ref: kv_app.h:277 ZPull).

        ``after_ts`` defers the request send until that earlier request of
        this customer completes — the pull-after-push-per-key ordering the
        reference gets from the MXNet dependency engine (push/pull ops share
        the key's var, ref: kvstore_dist.h:602-624 PushAsync read/write deps).
        """
        keys = np.asarray(sorted(int(k) for k in keys), dtype=np.int64)
        dummy = KVPairs(keys=keys, vals=np.empty(len(keys), np.float32),
                        lens=np.ones(len(keys), np.int64))
        parts = self._slice(dummy)
        ts = self.customer.new_request(len(parts), on_complete=on_complete)
        with self._mu:
            self._pull_bufs[ts] = []
            self._pull_expected[ts] = len(parts)
            if cb is not None:
                self._pull_cbs[ts] = cb

        def _send():
            msgs = [Message(
                recipient=target, domain=self.domain,
                app_id=self.customer.app_id,
                customer_id=self.customer.customer_id,
                timestamp=ts, request=True, pull=True, cmd=cmd,
                priority=priority, keys=part.keys, **msg_fields,
            ) for target, part in parts]
            self._track(ts, msgs)  # before sending (response could race)
            for m in msgs:
                self.postoffice.van.send(m)

        if after_ts is None:
            _send()
        else:
            self.customer.add_completion_listener(after_ts, _send)
        if wait:
            self.customer.wait(ts)
        return ts

    def push_pull(self, kvs: KVPairs, cb=None, cmd: int = 0, priority: int = 0,
                  wait: bool = False, on_complete=None, **msg_fields) -> int:
        """Combined push+pull in one round trip (response carries values)."""
        parts = self._slice(kvs)
        ts = self.customer.new_request(len(parts), on_complete=on_complete)
        with self._mu:
            self._pull_bufs[ts] = []
            self._pull_expected[ts] = len(parts)
            if cb is not None:
                self._pull_cbs[ts] = cb
        msgs = [Message(
            recipient=target, domain=self.domain,
            app_id=self.customer.app_id, customer_id=self.customer.customer_id,
            timestamp=ts, request=True, push=True, pull=True, cmd=cmd,
            priority=priority, keys=part.keys, vals=part.vals, lens=part.lens,
            **msg_fields,
        ) for target, part in parts]
        self._track(ts, msgs)  # before sending (response could race)
        for m in msgs:
            self.postoffice.van.send(m)
        if wait:
            self.customer.wait(ts)
        return ts

    # ---- response processing ------------------------------------------------
    def _process(self, msg: Message):
        if not msg.push and not msg.pull:
            self._handle_command(msg)
            return
        if msg.request:
            if self.ts_handler is not None:
                self.ts_handler(msg)
                return
            raise AssertionError(f"KVWorker got a request: {msg}")
        if not self._on_response_tracked(msg):
            return  # duplicate response caused by a replayed request
        if isinstance(msg.body, dict) and "error" in msg.body:
            h = self.error_handler
            if h is None or not h(msg):
                with self._mu:
                    self.errors.append(str(msg.body["error"]))
        ts = msg.timestamp
        if msg.keys is not None and msg.vals is not None:
            # pull (or push_pull) response carrying data
            tags = pv = wv = None
            if isinstance(msg.body, dict) and "compr" in msg.body:
                tags = {int(k): t for k, t in msg.body["compr"].items()}
            if isinstance(msg.body, dict) and "pv" in msg.body:
                pv = {int(k): int(v) for k, v in msg.body["pv"].items()}
            if isinstance(msg.body, dict) and "wv" in msg.body:
                wv = {int(k): int(v) for k, v in msg.body["wv"].items()}
            with self._mu:
                buf = self._pull_bufs.get(ts)
                if buf is not None:
                    buf.append(KVPairs(msg.keys, msg.vals, msg.lens,
                                       tags=tags, pv=pv, wv=wv))
                    done = len(buf) == self._pull_expected.get(ts, -1)
                else:
                    done = False
            if done:
                merged = self._merge(self._pull_bufs.pop(ts))
                self._pull_expected.pop(ts, None)
                cb = self._pull_cbs.pop(ts, None)
                if cb is not None:
                    cb(merged)
        self.customer.add_response(ts)

    def stop(self):
        self._retry_stop.set()
        super().stop()

    @staticmethod
    def _merge(parts: List[KVPairs]) -> KVPairs:
        """Sort-merge per-server responses by key (ref: kv_app.h pull
        aggregation sorts by key before the user callback)."""
        if len(parts) == 1:
            # single-server response: pass through as-is (already
            # key-sorted by the server; concatenate would be a full
            # payload copy — ~0.27 s at the 200 MB-tensor regime)
            return parts[0]
        ks, vs, ls = [], [], []
        tags: dict = {}
        pv: dict = {}
        wv: dict = {}
        for p in parts:
            if p.tags:
                tags.update(p.tags)
            if p.pv:
                pv.update(p.pv)
            if p.wv:
                wv.update(p.wv)
            for k, v in p.slices():
                ks.append(k); vs.append(v); ls.append(len(v))
        order = np.argsort(np.asarray(ks, dtype=np.int64), kind="stable")
        keys = np.asarray(ks, dtype=np.int64)[order]
        vals = (np.concatenate([vs[i] for i in order])
                if vs else np.empty(0, np.float32))
        lens = np.asarray(ls, dtype=np.int64)[order]
        return KVPairs(keys, vals, lens, tags=tags or None, pv=pv or None,
                       wv=wv or None)


class KVServer(_App):
    """Server endpoint: user handle processes requests, ``response`` replies.

    The handle runs on the customer thread (push queue) or the dedicated
    pull thread (ref: customer.h:91-101) — handlers must therefore be
    thread-safe across those two.  ``split_pull_queue`` defaults ON for
    every server role: a pull must be servable while a long merge
    dispatch occupies the push lane (the sharded servers additionally
    stripe their key state, so the two lanes only contend per key).
    """

    def __init__(
        self,
        app_id: int,
        customer_id: int,
        postoffice: Postoffice,
        handle: Callable[[Message, Optional[KVPairs], "KVServer"], None],
        split_pull_queue: bool = True,
    ):
        super().__init__(app_id, customer_id, postoffice,
                         split_pull_queue=split_pull_queue, owns_app=True)
        self.handle = handle

    def _process(self, msg: Message):
        if not msg.push and not msg.pull:
            self._handle_command(msg)
            return
        if not msg.request:
            # response to a push/pull this node issued as a *server*
            # (e.g. ACKs for pushed-down model updates)
            self.customer.add_response(msg.timestamp)
            return
        kvs = None
        if msg.keys is not None:
            vals = msg.vals if msg.vals is not None else np.empty(0, np.float32)
            lens = msg.lens if msg.lens is not None else np.zeros(len(msg.keys), np.int64)
            kvs = KVPairs(msg.keys, vals, lens)
        self.handle(msg, kvs, self)

    def response(self, req: Message, kvs: Optional[KVPairs] = None, **overrides):
        rep = req.reply_to(**overrides)
        if kvs is not None:
            rep.keys, rep.vals, rep.lens = kvs.keys, kvs.vals, kvs.lens
        self.postoffice.van.send(rep)
