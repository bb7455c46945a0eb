"""Wire message format.

Mirrors the information content of the reference's ``Meta`` / ``Message``
(ref: ps-lite/include/ps/internal/message.h:160-290 and the protobuf wire
form meta.proto:34-80) including the DGT chunk fields (message.h:237-251),
but as a plain dataclass carrying numpy arrays.  The in-proc fabric passes
it by reference (zero-copy); the TCP van serializes it with a small binary
header + raw array bytes (no pickle on the data path).
"""

from __future__ import annotations

import dataclasses
import enum
import io
import os
import pickle
import struct
from typing import Any, Optional

import numpy as np

from geomx_tpu_torch.core.config import NodeId

# Wire-format selector: v2 (raw self-describing array framing, the
# default) vs the legacy v1 np.save frames.  ``GEOMX_WIRE_FORMAT=v1``
# pins the ENCODER to v1 for mixed-version rollouts and for the serde
# microbench's same-run comparison; the decoder always auto-detects, so
# either side may upgrade first.
WIRE_V2 = os.environ.get("GEOMX_WIRE_FORMAT", "v2").strip().lower() != "v1"

# Wire-integrity stamping (``GEOMX_INTEGRITY_WIRE=1`` /
# Config.enable_integrity_wire; off by default).  When on, every v2
# frame carries two 32-bit checksums between the meta blob and the
# array descriptors — one over the fixed header + meta pickle, one over
# the descriptors + payload bytes — and a marker in the header's first
# spare byte says they are present.  The DECODER keys on the marker,
# not on this flag, so a stamped frame verifies wherever it lands and
# an unstamped (legacy) frame is accepted unchanged; with the flag off
# the encoder output is bit-for-bit the legacy frame.
WIRE_INTEGRITY = (os.environ.get("GEOMX_INTEGRITY_WIRE", "")
                  .strip().lower() in ("1", "true", "yes", "on"))

# crc32c (Castagnoli) when a native wheel is available; zlib's crc32 is
# the always-present fallback — same 32-bit space, same chaining API,
# and C speed either way.  Both sides of one deployment share a build,
# so the polynomial choice never splits a cluster.
try:  # pragma: no cover - depends on the host image
    from crc32c import crc32c as _crc32
except ImportError:
    from zlib import crc32 as _crc32


def wire_checksum(data, value: int = 0) -> int:
    """Checksum one buffer (chainable: pass the previous value)."""
    return _crc32(data, value) & 0xFFFFFFFF


class WireCorruption(ValueError):
    """A v2 frame failed its integrity check (or could not be parsed
    past a verified checksum block).  Carries whatever header identity
    survived verification so the receiving fabric can count the reject
    and NACK the sender's resender (``sender`` is ``""`` when the
    header/meta region itself failed — nothing in the frame can be
    trusted, and recovery is the sender's resend timer)."""

    def __init__(self, what: str, *, sender: str = "", msg_sig: int = -1,
                 boot: int = 0, channel: int = 0, domain=None):
        super().__init__(f"wire integrity: {what}")
        self.what = what
        self.sender = sender
        self.msg_sig = msg_sig
        self.boot = boot
        self.channel = channel
        self.domain = domain


class Control(enum.Enum):
    """Control message types (ref: message.h:125-137)."""

    EMPTY = 0          # data message
    TERMINATE = 1
    ADD_NODE = 2
    BARRIER = 3
    ACK = 4
    HEARTBEAT = 5
    # TSEngine control plane (ref: message.h:135-136)
    ASK_PULL = 6       # node asks scheduler who to relay pull-model to
    ASK_PUSH = 7       # node asks scheduler for a push-merge pairing
    REPLY = 8          # scheduler's answer
    AUTOPULL_REPLY = 9 # receiver confirms overlay delivery
    DEAD_NODES = 10    # query the scheduler's heartbeat table
    ADDR_UPDATE = 11   # a replacement node announces its new address
    #                    (ref: ADD_NODE re-registration van.cc:176-193;
    #                    here plan-based — the node broadcasts directly)
    # global-tier failover (beyond the reference — its global recovery is
    # a TODO, van.cc:224): the global scheduler's failure detector drives
    # a hot-standby promotion
    PROMOTE = 12       # scheduler -> standby: become primary (body: term)
    NEW_PRIMARY = 13   # scheduler -> everyone: the shard's new primary
    #                    identity + fencing term; clients retarget and
    #                    replay, a zombie ex-primary demotes itself
    # crash-tolerant membership (the tiers below the global root): the
    # heartbeat failure detector ACTUATES instead of just observing
    EVICT = 14         # scheduler -> server: synthesized forced leave of a
    #                    heartbeat-expired member (worker eviction at the
    #                    party tier; reversible party fold/unfold at the
    #                    global tier — body: {node, boot} or
    #                    {action: "party_fold"|"party_unfold", node})
    REJOIN = 15        # request (global scheduler -> local server): warm-
    #                    boot by pulling model state from the global tier;
    #                    broadcast (scheduler -> party workers, body:
    #                    {event: "server_back"}): the party server
    #                    recovered — replay un-ACKed requests at it now
    HANDOFF = 16       # global scheduler -> a live global shard holder:
    #                    drain your key range onto {target} under a
    #                    bumped term (live key-range reassignment).  The
    #                    holder quiesces, ships a final state snapshot
    #                    (Cmd.REPLICATE {handoff: true}) to the target,
    #                    fences itself, and the scheduler broadcasts
    #                    NEW_PRIMARY so every client retargets + replays
    #                    — the same epoch-fence machinery as failover,
    #                    exercised with the old holder still alive
    FLIGHT_DUMP = 17   # broadcast -> every node: snapshot your flight-
    #                    recorder ring to disk NOW, under one shared
    #                    incident id (body: {incident, dir, rule?,
    #                    subject?}).  Sent by the health engine on an
    #                    alert transition (every node dumps the same
    #                    incident window) and by the scheduler relaying
    #                    an operator's Ctrl.FLIGHT_DUMP request
    #                    (geomx_tpu_torch/obs/flight.py)
    PREEMPT_NOTICE = 18  # spot-preemption notice (graceful drain path,
    #                    requires Config.enable_preempt).  As a REQUEST
    #                    to a worker: finish the in-flight step, flush
    #                    un-ACKed pushes, leave the party gracefully,
    #                    reply {ok, drain_s} — the party server folds
    #                    the member out IMMEDIATELY instead of stalling
    #                    rounds until heartbeat expiry.  As a request to
    #                    a local server: drain the WAN round and hand
    #                    the party fold to the global tier proactively.
    #                    As a non-request: {event: "draining", node} to
    #                    the party scheduler holds eviction during the
    #                    drain window; {event: "server_drained", party,
    #                    node, boot} tells the recovery monitor the fold
    #                    already happened so the rejoin path arms
    PROBE_INDIRECT = 19  # SWIM-style indirect probe (partition-vs-crash
    #                    disambiguation, requires Config.
    #                    enable_partition_mode).  As a REQUEST with
    #                    body {suspect, timeout} to a peer: relay a ping
    #                    to the suspect on my behalf and reply
    #                    {alive, suspect, token}.  As a request with
    #                    body {ping: true}: answer {pong: true} inline
    #                    (liveness only — no state touched).  A monitor
    #                    whose direct heartbeat view expired but whose
    #                    indirect probes still hear the suspect
    #                    QUARANTINES instead of evicting (kvstore/
    #                    eviction.py; docs/deployment.md)
    NACK = 20          # wire-integrity negative ack (data-integrity
    #                    plane, GEOMX_INTEGRITY_WIRE): a receiver whose
    #                    frame failed its checksum tells the sender's
    #                    resender to retransmit NOW instead of waiting
    #                    out the resend backoff.  msg_sig names the
    #                    corrupted message; the van treats it as "reset
    #                    the retry clock and resend" — the replay-dedup
    #                    window absorbs the case where an uncorrupted
    #                    copy also arrived.  Best-effort: a lost NACK
    #                    just falls back to the resend timer.


class Domain(enum.Enum):
    """Which communication domain a message travels in.

    The reference keeps two sockets/threads per dual-role node — local and
    global (ref: van.h:98, van.cc:557-671).  We tag messages instead; the
    fabric routes on (recipient, domain) so a local server's two identities
    share one mailbox but can be distinguished by handlers.
    """

    LOCAL = 0
    GLOBAL = 1


@dataclasses.dataclass
class Message:
    sender: NodeId = None  # type: ignore[assignment]
    recipient: NodeId = None  # type: ignore[assignment]
    control: Control = Control.EMPTY
    domain: Domain = Domain.LOCAL

    # request/response tracking (ref: message.h Meta
    # {head, app_id, customer_id, timestamp, request, push, pull})
    app_id: int = 0
    customer_id: int = 0
    timestamp: int = -1          # request id issued by Customer
    request: bool = False
    push: bool = False
    pull: bool = False
    cmd: int = 0                 # server dispatch word
    priority: int = 0            # P3 / engine priority; higher = sooner
    body: Any = None             # control payload (python object)

    # data plane
    keys: Optional[np.ndarray] = None   # int64 key ids
    vals: Optional[np.ndarray] = None   # flat payload
    lens: Optional[np.ndarray] = None   # per-key value lengths

    # DGT chunk fields (ref: message.h:237-251, meta.proto:60-79)
    first_key: int = -1
    seq: int = -1
    seq_begin: int = -1
    seq_end: int = -1
    channel: int = 0             # 0 = reliable; >=1 = lossy priority channels
    total_bytes: int = 0
    val_bytes: int = 0
    compr: str = ""              # codec tag applied to vals ("", "fp16", "2bit", "bsc")

    # resender bookkeeping (ref: resender.h)
    msg_sig: int = -1

    # payload ownership: True = the receiver may ADOPT ``vals`` (and its
    # slices) — mutate it, keep it as its accumulator — without a
    # defensive copy.  Set by senders that transfer ownership (a local
    # server pushing up its aggregation buffer) and by the TCP van on
    # decode (deserialized buffers are always fresh).  In-proc delivery
    # is by reference, so a non-donated payload may alias the sender's
    # live data and must be copied before first mutation.  On this
    # single-core host each avoided 200 MB copy is ~0.27 s of the server
    # round (VERDICT r3 item 2).
    donated: bool = False

    # sender incarnation nonce, stamped by the Van at send time.  Replay
    # dedup keys on it so a replaced node (ADDR_UPDATE recovery) whose
    # Customer timestamps restart at 0 can't have fresh requests
    # misclassified as replays of its predecessor's (advisor r1)
    boot: int = 0

    # adaptive-WAN policy epoch (geomx_tpu_torch/control): 0 = no policy /
    # adaptive off.  WAN gradient pushes carry the sender's current
    # epoch; a receiver on a different epoch fences the payload with a
    # retryable error instead of decoding it under the wrong codec
    # parameters (see docs/adaptive-wan.md).
    policy_epoch: int = 0

    # distributed-tracing context (geomx_tpu_torch/trace): 0/False = untraced.
    # ``span_id`` identifies THIS message on the timeline; receivers use
    # it as the parent of their handler spans, so the cross-node chain
    # stays connected.  Stamped by Van.send from the sender thread's
    # context; responses inherit the request's trace via reply_to (the
    # same timestamp/Customer correlation that pairs them).  A replayed
    # or retransmitted request keeps its original ids — the replay shows
    # up as extra children of the original round, not a new trace.
    trace_id: int = 0
    span_id: int = 0
    parent_span_id: int = 0
    sampled: bool = False

    _nbytes_cache: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def nbytes(self) -> int:
        """Approximate wire size, for WAN-byte accounting (ref: van.h:180-181).

        Cached: accounting calls this on every send/recv/retransmit and the
        body pickle would otherwise be recomputed each time.
        """
        if self._nbytes_cache is None:
            n = 64  # meta overhead
            for a in (self.keys, self.vals, self.lens):
                if a is not None:
                    n += a.nbytes
            if self.body is not None:
                n += len(pickle.dumps(self.body, protocol=4))
            self._nbytes_cache = n
        return self._nbytes_cache

    def reply_to(self, **overrides) -> "Message":
        """Build a response message addressed back to the sender."""
        kw = dict(
            sender=self.recipient,
            recipient=self.sender,
            control=self.control,
            domain=self.domain,
            app_id=self.app_id,
            customer_id=self.customer_id,
            timestamp=self.timestamp,
            request=False,
            push=self.push,
            pull=self.pull,
            cmd=self.cmd,
            # responses inherit the request's priority so P3 ordering
            # holds on the return path (pull-downs / piggybacked values
            # contend on the server's uplink too)
            priority=self.priority,
            # ...and the request's policy epoch, so a fence reply is
            # attributable to the exact epoch that was refused
            policy_epoch=self.policy_epoch,
            # request→response trace correlation: the response joins the
            # request's trace as a child of the request MESSAGE (span_id
            # itself is assigned fresh at send time)
            trace_id=self.trace_id,
            parent_span_id=self.span_id,
            sampled=self.sampled,
        )
        kw.update(overrides)
        return Message(**kw)

    # ---- binary serialization (for the TCP van) -----------------------------
    #
    # Wire format v2 (default): self-describing raw array framing —
    #
    #   int32  _V2_MAGIC (negative, so a v1 frame's positive header
    #          length can never collide; from_bytes auto-detects)
    #   _HDR   fixed meta fields (same struct as v1)
    #   int32  meta_len; pickle of {sender, recipient, body, compr}
    #          (pickle survives ONLY for this small control dict)
    #   3 ×    array descriptor: u8 dtype-descr length (0 = None),
    #          dtype descr ascii (np.dtype.str, e.g. "<f4"), u8 ndim,
    #          int64 × ndim shape
    #   raw    each present array's bytes, in (keys, vals, lens) order,
    #          each block starting at the next 8-byte-aligned offset
    #          (alignment keeps np.frombuffer views fast), no trailing
    #          pad after the last block
    #
    # The payload crosses the encoder with ZERO copies: ``to_frames``
    # returns [prelude, pad?, arr.view, ...] and the TCP fabric
    # scatter-gathers them onto the socket.  ``from_bytes`` over a
    # writeable receive buffer returns np.frombuffer VIEWS — the
    # decoded arrays alias the buffer, stay writeable, and flow into
    # the server's ``donated`` adopt-or-copy contract without a copy.
    # v1 frames (np.save blobs, pre-PR-5 peers) still decode.
    _HDR = struct.Struct("<B B i i q B B B i i q q q q q B q q q q q q q")
    _V2_MAGIC = -20206
    _DTYPE_WHITELIST = frozenset("?bhilqBHILQefdg")  # bool/int/uint/float
    # byte offset (within the packed header) of the first spare pad
    # byte, reused as the integrity marker: 0 = plain legacy frame,
    # 1 = an 8-byte checksum block follows the meta blob.  The second
    # spare byte stays reserved.
    _INTEGRITY_BYTE = 19

    def _meta_blob(self) -> bytes:
        return pickle.dumps({
            "sender": str(self.sender) if self.sender else "",
            "recipient": str(self.recipient) if self.recipient else "",
            "body": self.body,
            "compr": self.compr,
        }, protocol=4)

    def _pack_hdr(self, integrity: bool = False) -> bytes:
        flags = ((self.request << 0) | (self.push << 1) | (self.pull << 2)
                 | (self.sampled << 3))
        return self._HDR.pack(
            self.control.value, self.domain.value, self.app_id, self.customer_id,
            self.timestamp, flags, 1 if integrity else 0, 0, self.cmd,
            self.priority,
            self.first_key, self.seq, self.seq_begin, self.seq_end,
            self.total_bytes, self.channel, self.val_bytes, self.msg_sig,
            self.boot, self.trace_id, self.span_id, self.parent_span_id,
            self.policy_epoch,
        )

    def to_frames(self) -> list:
        """Serialize to a scatter-gather buffer list (v2): one small
        prelude + each payload array's own memory, uncopied.  The
        caller must finish transmitting before mutating the arrays
        (the fabric sends synchronously, so this holds).

        With ``WIRE_INTEGRITY`` on, an 8-byte checksum block
        (``<II``: header+meta crc, descriptor+payload crc) sits between
        the meta blob and the descriptors, announced by the header's
        integrity marker byte; off (the default) the output is
        bit-for-bit the legacy frame."""
        integrity = WIRE_INTEGRITY
        hdr = self._pack_hdr(integrity=integrity)
        meta_b = self._meta_blob()
        descr = io.BytesIO()
        arrs = []
        for a in (self.keys, self.vals, self.lens):
            if a is None:
                descr.write(b"\x00")
                arrs.append(None)
                continue
            a = np.asarray(a)
            if not a.flags.c_contiguous:
                # the only copy on the encode path; 0-d arrays are
                # always contiguous (ascontiguousarray would 1-d them)
                a = np.ascontiguousarray(a)
            if a.dtype.char not in self._DTYPE_WHITELIST:
                raise TypeError(
                    f"non-plain dtype {a.dtype} cannot ride the wire")
            d = a.dtype.str.encode("ascii")
            descr.write(struct.pack("<B", len(d)))
            descr.write(d)
            descr.write(struct.pack("<B", a.ndim))
            for dim in a.shape:
                descr.write(struct.pack("<q", dim))
            arrs.append(a)
        descr_b = descr.getvalue()
        meta_len_b = struct.pack("<i", len(meta_b))
        head = 4 + len(hdr) + 4 + len(meta_b) \
            + (8 if integrity else 0) + len(descr_b)
        payload_frames = []
        off = head
        for a in arrs:
            if a is None or a.nbytes == 0:
                continue
            pad = -off % 8
            if pad:
                payload_frames.append(b"\x00" * pad)
                off += pad
            payload_frames.append(memoryview(a.reshape(-1).view(np.uint8)))
            off += a.nbytes
        if integrity:
            crc_meta = wire_checksum(hdr + meta_len_b + meta_b)
            crc_payload = wire_checksum(descr_b)
            for f in payload_frames:
                crc_payload = wire_checksum(f, crc_payload)
            crc_block = struct.pack("<II", crc_meta, crc_payload)
            prelude = b"".join((struct.pack("<i", self._V2_MAGIC), hdr,
                                meta_len_b, meta_b, crc_block, descr_b))
        else:
            prelude = b"".join((struct.pack("<i", self._V2_MAGIC), hdr,
                                meta_len_b, meta_b, descr_b))
        return [prelude] + payload_frames

    def to_bytes(self) -> bytes:
        if not WIRE_V2:
            return self.to_bytes_v1()
        return b"".join(bytes(f) if not isinstance(f, bytes) else f
                        for f in self.to_frames())

    def to_bytes_v1(self) -> bytes:
        """Legacy (pre-PR-5) frame: np.save blobs per array.  Kept so
        old frames can be GENERATED for compat tests and so the serde
        microbench can measure both formats in one run
        (``GEOMX_WIRE_FORMAT=v1`` flips to_bytes to this path)."""
        buf = io.BytesIO()
        meta_b = self._meta_blob()
        arrs = []
        for a in (self.keys, self.vals, self.lens):
            if a is None:
                arrs.append(b"")
            else:
                with io.BytesIO() as ab:
                    np.save(ab, a, allow_pickle=False)
                    arrs.append(ab.getvalue())
        hdr = self._pack_hdr()
        buf.write(struct.pack("<i", len(hdr)))
        buf.write(hdr)
        for blob in (meta_b, *arrs):
            buf.write(struct.pack("<q", len(blob)))
            buf.write(blob)
        return buf.getvalue()

    @classmethod
    def _unpack_hdr(cls, data, off: int) -> dict:
        if off + cls._HDR.size > len(data):
            # explicit bound: the v2 caller pre-checks, but the v1 path
            # trusts a length prefix the frame itself carried — a
            # truncated buffer must fail typed, not with a raw
            # struct.error inside the framing
            raise ValueError("truncated frame (header)")
        (control, domain, app_id, customer_id, timestamp, flags, _, _, cmd,
         priority, first_key, seq, seq_begin, seq_end, total_bytes, channel,
         val_bytes, msg_sig, boot, trace_id, span_id, parent_span_id,
         policy_epoch) = cls._HDR.unpack_from(data, off)
        return dict(
            control=Control(control), domain=Domain(domain), app_id=app_id,
            customer_id=customer_id, timestamp=timestamp,
            request=bool(flags & 1), push=bool(flags & 2),
            pull=bool(flags & 4), sampled=bool(flags & 8),
            cmd=cmd, priority=priority,
            first_key=first_key, seq=seq, seq_begin=seq_begin,
            seq_end=seq_end, channel=channel, total_bytes=total_bytes,
            val_bytes=val_bytes, msg_sig=msg_sig, boot=boot,
            trace_id=trace_id, span_id=span_id,
            parent_span_id=parent_span_id, policy_epoch=policy_epoch,
        )

    @classmethod
    def from_bytes(cls, data) -> "Message":
        """Decode a frame (v2 or legacy v1, auto-detected).

        ``data`` may be bytes, bytearray or memoryview.  v2 payload
        arrays are ZERO-COPY views of ``data``: pass the receive
        buffer itself (a writeable bytearray on the TCP path) and the
        decoded arrays alias it, writeable, satisfying the ``donated``
        adopt contract with no memcpy.  Read-only input (a UDP
        datagram's bytes) yields read-only views; the adopt gate then
        takes its defensive copy."""
        if len(data) < 4:
            raise ValueError("truncated frame (length prefix)")
        (first,) = struct.unpack_from("<i", data, 0)
        if first != cls._V2_MAGIC:
            return cls._from_bytes_v1(data, first)
        off = 4
        if off + cls._HDR.size + 4 > len(data):
            raise ValueError("truncated v2 frame (header)")
        marker = data[off + cls._INTEGRITY_BYTE]
        hdr_start = off
        off += cls._HDR.size
        (meta_len,) = struct.unpack_from("<i", data, off)
        off += 4
        if meta_len < 0 or off + meta_len > len(data):
            raise ValueError("truncated v2 frame (meta)")
        if marker:
            # verify the header+meta span BEFORE header enum decoding
            # and unpickling: a frame that fails here is untrustworthy
            # end to end (the header identity included), so the error
            # carries no NACK target
            if off + meta_len + 8 > len(data):
                raise WireCorruption("truncated checksum block")
            crc_meta, crc_payload = struct.unpack_from(
                "<II", data, off + meta_len)
            got = wire_checksum(
                memoryview(data)[hdr_start:off + meta_len])
            if got != crc_meta:
                raise WireCorruption("header/meta checksum mismatch")
        fields = cls._unpack_hdr(data, hdr_start)
        meta = pickle.loads(bytes(data[off:off + meta_len]))
        off += meta_len
        if marker:
            off += 8
        payload_start = off
        try:
            descrs = []
            for _ in range(3):
                (dlen,) = struct.unpack_from("<B", data, off)
                off += 1
                if dlen == 0:
                    descrs.append(None)
                    continue
                if off + dlen + 1 > len(data):
                    raise ValueError("truncated v2 frame (descriptor)")
                dt = np.dtype(bytes(data[off:off + dlen]).decode("ascii"))
                off += dlen
                (ndim,) = struct.unpack_from("<B", data, off)
                off += 1
                shape = struct.unpack_from(f"<{ndim}q", data, off)
                off += 8 * ndim
                descrs.append((dt, tuple(shape)))
            arrs = []
            for d in descrs:
                if d is None:
                    arrs.append(None)
                    continue
                dt, shape = d
                count = 1
                for s in shape:
                    count *= s
                if count:
                    off += -off % 8
                    if off + count * dt.itemsize > len(data):
                        raise ValueError("truncated v2 frame (payload)")
                a = np.frombuffer(data, dtype=dt, count=count, offset=off)
                off += count * dt.itemsize
                if len(shape) != 1:
                    a = a.reshape(shape)
                arrs.append(a)
        except WireCorruption:
            raise
        except (ValueError, TypeError, UnicodeDecodeError,
                struct.error) as e:
            if marker:
                # the verified meta names the sender — NACKable
                raise WireCorruption(
                    f"payload parse failed ({e})",
                    sender=meta.get("sender", ""),
                    msg_sig=fields["msg_sig"], boot=fields["boot"],
                    channel=fields["channel"], domain=fields["domain"])
            raise
        if marker:
            got = wire_checksum(memoryview(data)[payload_start:off])
            if got != crc_payload:
                raise WireCorruption(
                    "payload checksum mismatch",
                    sender=meta.get("sender", ""),
                    msg_sig=fields["msg_sig"], boot=fields["boot"],
                    channel=fields["channel"], domain=fields["domain"])
        return cls(
            sender=NodeId.parse(meta["sender"]) if meta["sender"] else None,
            recipient=(NodeId.parse(meta["recipient"])
                       if meta["recipient"] else None),
            body=meta["body"], compr=meta["compr"],
            keys=arrs[0], vals=arrs[1], lens=arrs[2],
            donated=True,  # deserialized buffers are exclusively ours
            **fields,
        )

    @classmethod
    def _from_bytes_v1(cls, data, hlen: int) -> "Message":
        if not 0 < hlen <= 4096:
            raise ValueError(f"bad frame header length {hlen}")
        off = 4
        fields = cls._unpack_hdr(data, off)
        off += hlen
        blobs = []
        for _ in range(4):
            if off + 8 > len(data):
                raise ValueError("truncated v1 frame")
            (blen,) = struct.unpack_from("<q", data, off); off += 8
            if blen < 0 or off + blen > len(data):
                raise ValueError("truncated v1 frame")
            blobs.append(bytes(data[off:off + blen])); off += blen
        meta = pickle.loads(blobs[0])
        arrs = []
        for blob in blobs[1:]:
            if not blob:
                arrs.append(None)
            else:
                arrs.append(np.load(io.BytesIO(blob), allow_pickle=False))
        return cls(
            sender=NodeId.parse(meta["sender"]) if meta["sender"] else None,
            recipient=(NodeId.parse(meta["recipient"])
                       if meta["recipient"] else None),
            body=meta["body"], compr=meta["compr"],
            keys=arrs[0], vals=arrs[1], lens=arrs[2],
            donated=True,
            **fields,
        )
