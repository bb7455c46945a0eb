"""DGT: Differential Gradient Transmission.

Reimplements the reference's DGT data plane (ref: kv_app.h:841-995,
van.cc:707-824, message.h:237-251): a large dense push is chunked into
``block_size``-element blocks; each chunk's *contribution* (EWMA of its
mean |gradient|, α = DGT_CONTRIBUTION_ALPHA) ranks it; the top ``k``
fraction rides the reliable channel 0, the rest spread over N lossy
priority channels.  The receiver reassembles on the reliable final chunk
(which always travels channel 0, ref: kv_app.h:989-991) and fills chunks
lost on the lossy channels with zeros — loss-tolerant best-effort for the
unimportant mass.

Transport mapping: the reference uses raw UDP sockets with DSCP marks;
in-proc the lossy channels are fabric channels with a configurable drop
rate, and on real DCN they map to secondary QUIC/UDP streams.  Modes
(ref: ENABLE_DGT∈{1,2,3}, van.cc:750-824): 1 = lossy channels; 2 = all
chunks reliable (chunking + prioritization only); 3 = all reliable but
unimportant chunks re-quantized to 4-bit (per-chunk min/max scale, two
nibbles per byte — the reference's encode/decode 4-bit path,
van.cc:750-824), trading precision of the low-contribution mass for
8x less wire on it.

Sparse payloads (bsc) are never chunked — dropping a chunk of a
[values ‖ indices] payload would corrupt it; DGT applies to dense and
fp16 pushes like the reference (MergeMsg/MergeMsg_HALF, van.cc:290-328).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from geomx_tpu_torch.core.config import Config
from geomx_tpu_torch.transport.message import Message


def quant4(vals: np.ndarray):
    """4-bit linear quantization: returns (packed uint8 [(n+1)//2],
    lo, hi).  Two nibbles per byte, low nibble first."""
    v = vals.astype(np.float32)
    lo = float(v.min())
    hi = float(v.max())
    scale = (hi - lo) or 1.0
    q = np.clip(np.round((v - lo) / scale * 15.0), 0, 15).astype(np.uint8)
    if len(q) % 2:
        q = np.append(q, np.uint8(0))
    return (q[0::2] | (q[1::2] << 4)).astype(np.uint8), lo, hi


def dequant4(packed: np.ndarray, n: int, lo: float, hi: float) -> np.ndarray:
    q = np.empty(len(packed) * 2, dtype=np.uint8)
    q[0::2] = packed & 15
    q[1::2] = packed >> 4
    return (q[:n].astype(np.float32) / 15.0 * ((hi - lo) or 1.0)
            + lo).astype(np.float32)


class DgtSender:
    """Chunk + rank + assign channels.  One instance per sending endpoint
    (holds the per-chunk contribution EWMA state)."""

    def __init__(self, config: Config):
        self.block_size = config.dgt_block_size
        self.k = config.dgt_k
        self.k_min = config.dgt_k_min
        self.adaptive = config.dgt_adaptive_k
        self.k_anneal_steps = config.dgt_k_anneal_steps
        self.channels = max(1, config.dgt_udp_channels)
        self.alpha = config.dgt_contrib_alpha
        self.mode = config.enable_dgt
        self._contrib: Dict[Tuple[int, int], float] = {}
        self._steps = 0
        self.dgt4_chunks = 0  # mode-3 observable: 4-bit requant count

    def current_k(self) -> float:
        """Adaptive k decays from k to k_min over training
        (ref: ADAPTIVE_K_FLAG; the reference anneals with iteration).
        The horizon is ``dgt_k_anneal_steps`` (GEOMX_DGT_K_ANNEAL_STEPS)."""
        if not self.adaptive:
            return self.k
        t = min(1.0, self._steps / max(1, self.k_anneal_steps))
        return self.k + (self.k_min - self.k) * t

    def split(self, msg: Message) -> List[Message]:
        """Split one data message into chunk messages. The final chunk
        (seq == seq_end) carries the full meta (keys/lens/body) and always
        rides channel 0 so completion always triggers."""
        vals = msg.vals
        assert vals is not None and vals.dtype in (np.float32, np.float16)
        self._steps += 1
        n = len(vals)
        bs = self.block_size
        nchunks = (n + bs - 1) // bs
        first_key = int(msg.keys[0]) if msg.keys is not None and len(msg.keys) else -1

        # contribution EWMA per (first_key, chunk index)
        contribs = []
        for c in range(nchunks):
            blk = vals[c * bs:(c + 1) * bs]
            mean_mag = float(np.mean(np.abs(blk.astype(np.float32))))
            key = (first_key, c)
            old = self._contrib.get(key)
            ewma = mean_mag if old is None else (
                self.alpha * mean_mag + (1 - self.alpha) * old)
            self._contrib[key] = ewma
            contribs.append(ewma)

        order = np.argsort(-np.asarray(contribs), kind="stable")
        k_cnt = max(1, int(np.ceil(self.current_k() * nchunks)))
        channel_of = {}
        for rank, c in enumerate(order):
            if self.mode != 1 or rank < k_cnt:
                channel_of[int(c)] = 0
            else:
                channel_of[int(c)] = 1 + (rank - k_cnt) % self.channels

        rank_of = {int(c): r for r, c in enumerate(order)}
        out = []
        for c in range(nchunks):
            blk = vals[c * bs:(c + 1) * bs]
            # mode 3: requantize unimportant (non-final) chunks to 4-bit
            chunk_body = None
            # (dtype already constrained to f32/f16 by the entry assert)
            if (self.mode == 3 and rank_of[c] >= k_cnt
                    and c != nchunks - 1):
                packed, lo, hi = quant4(blk)
                chunk_body = {"_dgt4": {"n": len(blk), "lo": lo, "hi": hi}}
                blk = packed
                self.dgt4_chunks += 1
            chunk = Message(
                sender=msg.sender, recipient=msg.recipient, domain=msg.domain,
                app_id=msg.app_id, customer_id=msg.customer_id,
                timestamp=msg.timestamp, request=msg.request, push=msg.push,
                pull=msg.pull, cmd=msg.cmd, priority=msg.priority,
                compr=msg.compr, vals=blk,
                first_key=first_key, seq=c, seq_begin=0, seq_end=nchunks - 1,
                channel=channel_of[c],
                total_bytes=n,            # total elements of the payload
                val_bytes=c * bs,         # element offset of this chunk
                # every chunk carries the logical message's trace context
                # — reassembly must restore it whichever chunks survive
                # the lossy channels, and a lost lossy chunk must not
                # orphan the round's causal chain
                trace_id=msg.trace_id, span_id=msg.span_id,
                parent_span_id=msg.parent_span_id, sampled=msg.sampled,
                # every chunk carries the WAN-policy epoch too: the
                # reassembled push must fence like an unsplit one
                policy_epoch=msg.policy_epoch,
                # ...and the sender incarnation nonce (the van re-stamps
                # it at send time, but the field table must be complete:
                # reassembly restores boot from the completion chunk and
                # replay dedup keys on it)
                boot=msg.boot,
            )
            if chunk_body is not None:
                chunk.body = chunk_body
            if c == nchunks - 1:
                # meta rides the completion chunk, always reliable; it also
                # lists the reliable seqs so the receiver can wait for any
                # channel-0 chunk lost to generic drop injection (they are
                # retransmitted by the resender; lossy chunks are not)
                chunk.keys = msg.keys
                chunk.lens = msg.lens
                chunk.channel = 0
                channel_of[c] = 0
                chunk.body = {
                    "_dgt_reliable": [int(s) for s, ch in channel_of.items()
                                      if ch == 0],
                    "orig": msg.body,
                }
            out.append(chunk)
        # send lossy/low-rank chunks first, completion chunk last
        out.sort(key=lambda m: (m.seq == m.seq_end, -m.channel))
        return out


class DgtReassembler:
    """Receiver side: merge chunks; finalize on the completion chunk,
    zero-filling chunks lost on the lossy channels
    (ref: ProcessDataMsg msg_map merge, van.cc:330-370)."""

    def __init__(self):
        import collections

        self._buf: Dict[tuple, dict] = {}
        self._mu = threading.Lock()
        self.dgt4_decoded = 0  # mode-3 observable: 4-bit chunks decoded
        # finalized-round tombstones: stragglers (late retransmits of
        # reliable chunks) must not recreate buffer entries
        self._done = set()
        self._done_order = collections.deque()
        self._done_cap = 10_000

    @staticmethod
    def _key(msg: Message) -> tuple:
        return (str(msg.sender), msg.app_id, msg.customer_id,
                msg.timestamp, msg.first_key)

    def accept(self, msg: Message) -> Optional[Message]:
        """Returns the reassembled logical message when complete."""
        key = self._key(msg)
        with self._mu:
            if key in self._done:
                return None  # straggler retransmit of a finalized round
            ent = self._buf.setdefault(key, {"chunks": {}, "final": None})
            ent["chunks"][msg.seq] = msg
            if msg.seq == msg.seq_end:
                ent["final"] = msg
            final = ent["final"]
            if final is None:
                return None
            have = ent["chunks"]
            # wait for every RELIABLE chunk (channel 0): those are either
            # in-order before the final chunk or retransmitted by the
            # resender; chunks lost on lossy channels are gone forever and
            # get zero-filled
            reliable = (final.body or {}).get("_dgt_reliable", [])
            if any(s not in have for s in reliable):
                return None
            del self._buf[key]
            self._done.add(key)
            self._done_order.append(key)
            if len(self._done_order) > self._done_cap:
                self._done.discard(self._done_order.popleft())
        total = max(0, int(final.total_bytes))
        vals = np.zeros(total, dtype=final.vals.dtype)
        for s, chunk in have.items():
            # defensive bounds: a chunk that decoded despite in-flight
            # damage (legacy unstamped frames) may carry a nonsense
            # offset/length — scatter it nowhere (≡ a lost lossy chunk,
            # zero-filled) instead of raising out of the receive path
            try:
                off = int(chunk.val_bytes)
                meta4 = (chunk.body or {}).get("_dgt4") if isinstance(
                    chunk.body, dict) else None
                if meta4 is not None:
                    dec = dequant4(chunk.vals, int(meta4["n"]),
                                   meta4["lo"], meta4["hi"])
                else:
                    dec = chunk.vals
                n = len(dec)
                if off < 0 or off + n > total:
                    continue
                vals[off:off + n] = dec
                if meta4 is not None:
                    self.dgt4_decoded += 1
            except (ValueError, TypeError, KeyError, OverflowError):
                continue
        out = Message(
            sender=final.sender, recipient=final.recipient,
            domain=final.domain, app_id=final.app_id,
            customer_id=final.customer_id, timestamp=final.timestamp,
            request=final.request, push=final.push, pull=final.pull,
            cmd=final.cmd, priority=final.priority, compr=final.compr,
            keys=final.keys, vals=vals, lens=final.lens,
            body=(final.body or {}).get("orig"),
            # the reassembled logical message IS the original on the
            # timeline: same trace/span ids (any surviving chunk carries
            # them; the completion chunk always does)
            trace_id=final.trace_id, span_id=final.span_id,
            parent_span_id=final.parent_span_id, sampled=final.sampled,
            policy_epoch=final.policy_epoch,
            # restore the sender incarnation nonce: RecentRequests keys
            # replay dedup on (sender, boot, ts) — a reassembled push
            # with boot=0 would collide with a replaced predecessor's
            # requests after an ADDR_UPDATE recovery
            boot=final.boot,
            # the reassembly buffer is freshly allocated and exclusively
            # ours — the receiving server may adopt it as its accumulator
            donated=True,
        )
        return out
