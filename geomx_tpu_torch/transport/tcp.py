"""TCP fabric: real sockets for multi-process / multi-host deployment.

The reference's transport is ZeroMQ ROUTER/DEALER TCP plus raw UDP
(ref: 3rdparty/ps-lite/src/zmq_van.h:41-193); this fabric provides the
same role with plain sockets and the framework's binary message format
(Message.to_bytes / from_bytes — length-prefixed frames).  It implements
the InProcFabric interface (register → mailbox, deliver), so the Van and
everything above it is transport-agnostic.

Addressing is static: every node gets ``base_port + index`` within the
deterministic ``Topology.all_nodes()`` order on its host (127.0.0.1 for
pseudo-distributed runs, per-node hosts via GEOMX_NODE_HOSTS JSON for
multi-host).  The reference's dynamic ADD_NODE registration is replaced
by this static plan; elastic join/recovery rides the heartbeat layer.
"""

from __future__ import annotations

import errno
import json
import os
import queue
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from geomx_tpu_torch.core.config import Config, NodeId, Topology
from geomx_tpu_torch.transport import message as _message
from geomx_tpu_torch.transport.message import (Control, Domain, Message,
                                         WireCorruption)
from geomx_tpu_torch.transport.reactor import Reactor, resolve_transport
from geomx_tpu_torch.transport.van import FaultPolicy, _Mailbox, corrupt_bytes


class _RecvConn:
    """Reactor-mode inbound connection: a readiness-driven scatter-gather
    ``recv_into`` state machine (8-byte length header, then the frame
    body into ONE writeable bytearray) replacing the per-connection recv
    thread.  The completed buffer goes straight to
    ``Message.from_bytes`` — zero-copy views over the receive buffer,
    exactly the wire-v2 contract the thread path honors."""

    __slots__ = ("fabric", "sock", "box", "node_s", "_hdr", "_hdr_view",
                 "_hdr_got", "_buf", "_view", "_got", "_need", "_reg")

    def __init__(self, fabric: "TcpFabric", sock: socket.socket,
                 box: _Mailbox, node_s: str = ""):
        self.fabric = fabric
        self.sock = sock
        self.box = box
        self.node_s = node_s
        self._hdr = bytearray(8)
        self._hdr_view = memoryview(self._hdr)
        self._hdr_got = 0
        self._buf: Optional[bytearray] = None
        self._view: Optional[memoryview] = None
        self._got = 0
        self._need = 0
        sock.setblocking(False)
        self._reg = fabric.reactor.register(sock, read_cb=self._on_readable)

    def _on_readable(self):
        try:
            while True:
                if self._buf is None:
                    n = self.sock.recv_into(self._hdr_view[self._hdr_got:],
                                            8 - self._hdr_got)
                    if n == 0:
                        self.close()
                        return
                    self._hdr_got += n
                    if self._hdr_got < 8:
                        continue
                    (need,) = struct.unpack("<q", self._hdr)
                    self._hdr_got = 0
                    if need <= 0:
                        continue  # defensive: empty frame
                    self._buf = bytearray(need)
                    self._view = memoryview(self._buf)
                    self._got = 0
                    self._need = need
                else:
                    n = self.sock.recv_into(self._view[self._got:],
                                            self._need - self._got)
                    if n == 0:
                        self.close()
                        return
                    self._got += n
                    if self._got < self._need:
                        continue
                    buf = self._buf
                    self._buf = self._view = None
                    # the frame buffer is a WRITEABLE bytearray this
                    # state machine never touches again: from_bytes
                    # returns zero-copy np.frombuffer views over it and
                    # the ``donated`` contract lets servers adopt them
                    try:
                        self.box.put(Message.from_bytes(buf))
                    except WireCorruption as e:
                        # checksum verdict on a complete frame: the
                        # length-prefix framing is INTACT, so the stream
                        # stays up — reject the frame, NACK the sender
                        self.fabric._on_corrupt_frame(self.node_s, e)
                    except Exception:
                        # a malformed frame poisons the stream framing —
                        # drop the connection like the thread path does
                        # when the decode raises out of its loop
                        import logging

                        logging.getLogger(__name__).exception(
                            "reactor recv: frame decode failed")
                        self.close()
                        return
        except (BlockingIOError, InterruptedError):
            return  # drained: wait for the next readiness event
        except OSError:
            self.close()

    def close(self):
        self._reg.close()
        with self.fabric._registry_mu:
            try:
                self.fabric._accepted.remove(self)
            except ValueError:
                pass


class _SendConn:
    """Reactor-mode outbound connection: non-blocking sends with a
    per-connection write queue drained on write readiness.  The caller
    tries an optimistic ``sendmsg`` first (the common, uncongested
    case costs no loop round-trip); leftovers queue and arm write
    interest.  Backpressure: a sender whose queue passes the high
    watermark BLOCKS until the loop drains it below — the same
    flow-control a blocking socket applied, without a thread per
    connection."""

    HIGH_WATER = int(os.environ.get("GEOMX_REACTOR_SENDQ_MAX",
                                    str(64 << 20)))
    _IOV = 64  # buffers per sendmsg call (stays far under IOV_MAX)

    __slots__ = ("sock", "broken", "_mu", "_cv", "_bufs", "_queued",
                 "_reg")

    def __init__(self, sock: socket.socket, reactor: Reactor):
        self.sock = sock
        self.broken = False
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._bufs: list = []
        self._queued = 0
        sock.setblocking(False)
        self._reg = reactor.register(sock, read_cb=self._on_readable,
                                     write_cb=self._on_writable)

    # outgoing conns receive nothing: readable means peer EOF/reset
    def _on_readable(self):
        try:
            data = self.sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            self._break_locked_notify()

    def _break_locked_notify(self):
        with self._cv:
            self.broken = True
            self._bufs.clear()
            self._queued = 0
            self._cv.notify_all()
        self._reg.close()

    @staticmethod
    def _advance(bufs: list, sent: int) -> None:
        while sent > 0 and bufs:
            n = bufs[0].nbytes
            if sent >= n:
                sent -= n
                bufs.pop(0)
            else:
                bufs[0] = bufs[0][sent:]
                sent = 0

    def send(self, frames) -> None:
        """Queue one message's frames atomically (whole-frame-list
        append under the lock keeps concurrent senders' messages from
        interleaving).  Raises OSError when the connection is broken —
        the fabric's redial-once path takes over."""
        bufs = [memoryview(f).cast("B") for f in frames]
        with self._cv:
            if self.broken:
                raise OSError(errno.EPIPE, "reactor send conn broken")
            if not self._bufs:
                # optimistic fast path: push what the kernel will take
                try:
                    while bufs:
                        sent = self.sock.sendmsg(bufs[:self._IOV])
                        self._advance(bufs, sent)
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError:
                    self.broken = True
                    self._reg.close()
                    raise
            if bufs:
                self._queued += sum(b.nbytes for b in bufs)
                self._bufs.extend(bufs)
                self._reg.want_write(True)
                while self._queued > self.HIGH_WATER and not self.broken:
                    self._cv.wait(timeout=1.0)  # backpressure
                if self.broken:
                    raise OSError(errno.EPIPE, "reactor send conn broke "
                                               "under backpressure")

    def _on_writable(self):
        with self._cv:
            try:
                while self._bufs:
                    sent = self.sock.sendmsg(self._bufs[:self._IOV])
                    self._queued -= sent
                    self._advance(self._bufs, sent)
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                # broken mid-drain: the queued tail dies with the
                # stream (the resend layer recovers reliable traffic)
                self.broken = True
                self._bufs.clear()
                self._queued = 0
                self._cv.notify_all()
                self._reg.close()
                return
            if not self._bufs:
                self._reg.want_write(False)
            self._cv.notify_all()

    def close(self):
        with self._cv:
            self.broken = True
            self._bufs.clear()
            self._queued = 0
            self._cv.notify_all()
        self._reg.close()


def default_address_plan(topology: Topology, base_port: int = 9200,
                         hosts: Optional[Dict[str, str]] = None
                         ) -> Dict[str, Tuple[str, int]]:
    """node-str → (host, port).  Hosts default to loopback (the reference's
    pseudo-distributed mode, ref: docs/source/pseudo-distributed-deployment.rst);
    ``hosts`` overrides per node for multi-host."""
    hosts = hosts or {}
    plan = {}
    for i, n in enumerate(topology.all_nodes()):
        s = str(n)
        plan[s] = (hosts.get(s, "127.0.0.1"), base_port + i)
    return plan


def plan_from_env(topology: Topology) -> Dict[str, Tuple[str, int]]:
    base = int(os.environ.get("GEOMX_BASE_PORT", "9200"))
    hosts = json.loads(os.environ.get("GEOMX_NODE_HOSTS", "{}"))
    return default_address_plan(topology, base, hosts)


class TcpFabric:
    """One per process. Only the local node(s) register; deliver() dials
    the static plan.

    DGT's lossy channels (``msg.channel >= 1``) travel as real **UDP
    datagrams** to the peer's port (the reference's raw UDP sockets with
    DSCP/TOS marks, ref: zmq_van.h:95-193): no connection, no
    retransmission, genuinely lossy — a dropped datagram is simply a
    zero-filled chunk at the reassembler.  Each lossy channel sends from
    its own TOS-marked socket (descending priority, ref: the tos ladder
    in zmq_van.h); oversized payloads fall back to the reliable TCP conn
    (the reference sizes DGT blocks for UDP, kv_app.h:841-850 — the
    fallback keeps misconfigured block sizes correct, just not lossy).
    """

    UDP_MAX = 60_000  # payloads above this ride TCP (IP fragmentation
    #                   would turn one lost fragment into a lost chunk
    #                   anyway; 60k stays under the 64k datagram limit)

    # descending DSCP ladder for channels 1..n (ref: zmq_van.h TOS marks)
    _TOS = (0x88, 0x68, 0x48, 0x28)

    def __init__(self, plan: Dict[str, Tuple[str, int]],
                 fault: Optional[FaultPolicy] = None,
                 config: Optional[Config] = None):
        if fault is None:
            fault = FaultPolicy.from_config(config) if config else FaultPolicy()
        self.fault = fault
        self.plan = plan
        # event-driven mode (GEOMX_TRANSPORT=reactor / Config.transport):
        # every endpoint in the process is serviced by the shared
        # per-process Reactor — non-blocking accept, readiness-driven
        # recv state machines, write queues — instead of accept/recv
        # threads per listener/connection.  "threads" (default) keeps
        # the pre-reactor path bit-for-bit.
        self.mode = resolve_transport(config)
        self.reactor = Reactor.shared() if self.mode == "reactor" else None
        self._reactor_regs: list = []  # listener/udp registrations
        self._boxes: Dict[str, _Mailbox] = {}
        self._listeners = []
        self._conns: Dict[str, socket.socket] = {}
        # per-destination locks: one slow/unreachable peer must not stall
        # sends to every other peer (heartbeats would time out and trigger
        # false dead-node detection)
        self._conn_mus: Dict[str, threading.Lock] = {}
        self._registry_mu = threading.Lock()
        self._accepted: list = []
        self._established: set = set()
        self._dial_window: Dict[str, float] = {}
        # peers being dialed off the sender's thread (_dial_or_defer):
        # the frames sent to each meanwhile, in order
        self._dialing: Dict[str, list] = {}
        self._udp_send: Dict[int, socket.socket] = {}  # channel -> socket
        self._udp_recv: list = []
        self._stop = False
        self.dropped = 0
        self.udp_datagrams_sent = 0
        self.udp_datagrams_recv = 0
        self.udp_dropped = 0  # lossy-channel losses only (injected or
        #                       sendto failures), distinct from `dropped`
        #                       which also counts reliable-channel
        #                       drop injection
        # system-metrics mirrors of the two loss ledgers, named by the
        # first registered node (one process = one fabric): transport
        # loss shows up in utils.metrics.system_snapshot next to the
        # failover / replication / eviction counters
        self._sys_dropped = None
        self._sys_udp_dropped = None
        # data-integrity ledger: frames a receiver's checksum rejected
        # (per-node counters live in the metrics registry)
        self.corrupt_rejected = 0
        self._integrity_counters: Dict[str, object] = {}

    def _count_integrity_reject(self, node_s: str):
        with self._registry_mu:
            self.corrupt_rejected += 1
        if not node_s:
            return
        c = self._integrity_counters.get(node_s)
        if c is None:
            from geomx_tpu_torch.utils.metrics import system_counter

            c = self._integrity_counters.setdefault(
                node_s, system_counter(f"{node_s}.integrity_wire_rejects"))
            # first reject for this receiver only — the counter carries
            # the volume, the log line is the operator breadcrumb
            print(f"{node_s}: wire checksum rejected a corrupt frame "
                  "(counted in integrity_wire_rejects)", flush=True)
        c.inc()

    def _on_corrupt_frame(self, node_s: str, err: WireCorruption):
        """A complete TCP frame failed its checksum.  Count the reject,
        then NACK the sender (when the verified meta named one) so its
        resender retransmits NOW instead of waiting out the backoff.
        The NACK is sent from a short-lived thread: deliver() may dial
        a cold connection, and neither the reactor loop nor a recv
        thread may block on that."""
        self._count_integrity_reject(node_s)
        if not err.sender or err.msg_sig < 0 or err.channel != 0:
            return  # no trustworthy sender identity, or a lossy channel
        nack = Message(sender=node_s, recipient=err.sender,
                       control=Control.NACK,
                       domain=err.domain or Domain.LOCAL,
                       msg_sig=err.msg_sig, boot=err.boot)

        def _send():
            try:
                self.deliver(nack)
            except (KeyError, OSError):
                pass  # sender unreachable: its resend timer recovers

        threading.Thread(target=_send, daemon=True,
                         name=f"tcp-nack-{node_s}").start()

    def _count_drop(self, udp: bool = False):
        """Ledger a lost message (caller holds ``_registry_mu``)."""
        self.dropped += 1
        if self._sys_dropped is not None:
            self._sys_dropped.inc()
        if udp:
            self.udp_dropped += 1
            if self._sys_udp_dropped is not None:
                self._sys_udp_dropped.inc()

    # ---- local side ---------------------------------------------------------
    def register(self, node: NodeId) -> _Mailbox:
        s = str(node)
        if s in self._boxes:
            return self._boxes[s]
        box = _Mailbox()
        host, port = self.plan[s]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # a restarted role re-binds its fixed port; sockets lingering from
        # the previous incarnation can hold it for a moment — retry, but
        # only on EADDRINUSE (anything else is a real config error).
        # NOTE: deliberately no SO_REUSEPORT — it would let two live
        # incarnations share the port and silently split inbound traffic.
        deadline = time.monotonic() + 5.0
        try:
            while True:
                try:
                    srv.bind(("0.0.0.0", port))
                    break
                except OSError as e:
                    if (e.errno != errno.EADDRINUSE
                            or time.monotonic() >= deadline):
                        raise
                    time.sleep(0.1)
            srv.listen(64)
        except OSError:
            srv.close()  # a retried register() must not find a dead box
            raise
        # UDP receiver on the same port number for DGT's lossy channels.
        # Bound BEFORE the box/threads are installed so a bind failure
        # leaves no half-registered node (a retried register() finding a
        # mailbox with no UDP receiver would silently zero-fill every
        # lossy chunk forever).  Deliberately no SO_REUSEADDR: UDP has no
        # TIME_WAIT to work around, and on Linux it would let two live
        # incarnations share the port and split inbound datagrams.
        udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            deadline = time.monotonic() + 5.0
            while True:
                try:
                    udp.bind(("0.0.0.0", port))
                    break
                except OSError as e:
                    if (e.errno != errno.EADDRINUSE
                            or time.monotonic() >= deadline):
                        raise
                    time.sleep(0.1)
        except OSError:
            udp.close()
            srv.close()
            raise
        self._boxes[s] = box
        if self._sys_dropped is None:
            from geomx_tpu_torch.utils.metrics import system_counter

            self._sys_dropped = system_counter(f"{s}.tcp_dropped")
            self._sys_udp_dropped = system_counter(f"{s}.tcp_udp_dropped")
        self._listeners.append(srv)
        self._udp_recv.append(udp)
        if self.reactor is not None:
            # reactor mode: no accept thread, no UDP thread, no thread
            # per accepted connection — the shared loops service all of
            # them via readiness callbacks
            srv.setblocking(False)
            udp.setblocking(False)
            self._reactor_regs.append(self.reactor.register(
                srv, read_cb=lambda: self._accept_ready(srv, box, s)))
            self._reactor_regs.append(self.reactor.register(
                udp, read_cb=lambda: self._udp_ready(udp, box, s)))
        else:
            threading.Thread(target=self._accept_loop, args=(srv, box, s),
                             name=f"tcp-accept-{s}", daemon=True).start()
            threading.Thread(target=self._udp_recv_loop,
                             args=(udp, box, s),
                             name=f"udp-recv-{s}", daemon=True).start()
        return box

    # ---- reactor-mode readiness callbacks -----------------------------------
    def _accept_ready(self, srv: socket.socket, box: _Mailbox,
                      node_s: str):
        while not self._stop:
            try:
                conn, _ = srv.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            rc = _RecvConn(self, conn, box, node_s)
            with self._registry_mu:
                self._accepted.append(rc)

    def _udp_ready(self, sock: socket.socket, box: _Mailbox,
                   node_s: str):
        while not self._stop:
            try:
                data, _ = sock.recvfrom(65535)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if not data:
                continue  # shutdown poke
            try:
                msg = Message.from_bytes(data)
            except WireCorruption:
                # checksum verdict on a lossy datagram: counted but
                # never NACKed — DGT chunks are never retransmitted, and
                # the reassembler zero-fills the hole by design
                self._count_integrity_reject(node_s)
                continue
            except Exception:
                continue  # truncated/corrupt datagram: lossy by design
            with self._registry_mu:
                self.udp_datagrams_recv += 1
            box.put(msg)

    def _udp_recv_loop(self, sock: socket.socket, box: _Mailbox,
                       node_s: str):
        while not self._stop:
            try:
                data, _ = sock.recvfrom(65535)
            except OSError:
                return
            try:
                msg = Message.from_bytes(data)
            except WireCorruption:
                self._count_integrity_reject(node_s)  # see _udp_ready
                continue
            except Exception:
                continue  # truncated/corrupt datagram: lossy by design
            with self._registry_mu:
                self.udp_datagrams_recv += 1
            box.put(msg)

    def _udp_sock(self, channel: int) -> socket.socket:
        with self._registry_mu:
            if self._stop:  # lost the race against shutdown()
                raise OSError(errno.ESHUTDOWN, "fabric shut down")
            s = self._udp_send.get(channel)
            if s is None:
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                tos = self._TOS[min(channel - 1, len(self._TOS) - 1)]
                try:
                    s.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, tos)
                except OSError:
                    pass  # TOS is advisory; some sandboxes deny it
                self._udp_send[channel] = s
            return s

    def _accept_loop(self, srv: socket.socket, box: _Mailbox,
                     node_s: str):
        while not self._stop:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=self._recv_loop,
                             args=(conn, box, node_s),
                             daemon=True).start()

    def _recv_loop(self, conn: socket.socket, box: _Mailbox,
                   node_s: str = ""):
        with self._registry_mu:
            self._accepted.append(conn)
        try:
            while not self._stop:
                hdr = self._recv_exact(conn, 8)
                if hdr is None:
                    return
                (n,) = struct.unpack("<q", bytes(hdr))
                data = self._recv_exact(conn, n)
                if data is None:
                    return
                # the frame buffer is a WRITEABLE bytearray this loop
                # never touches again: from_bytes returns zero-copy
                # np.frombuffer views over it, and the message's
                # ``donated`` contract lets the server adopt them as
                # its accumulators without a defensive copy
                try:
                    box.put(Message.from_bytes(data))
                except WireCorruption as e:
                    # complete frame, bad checksum: framing is intact,
                    # the stream survives — reject + NACK the sender
                    self._on_corrupt_frame(node_s, e)
        except OSError:
            return  # connection torn down (peer reset or fabric shutdown)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._registry_mu:
                try:
                    self._accepted.remove(conn)
                except ValueError:
                    pass

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> Optional[bytearray]:
        """Read exactly ``n`` bytes into a fresh writeable buffer via
        recv_into — no per-chunk bytes objects, no quadratic b"" +=
        reassembly, and the result can back zero-copy array views."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            r = conn.recv_into(view[got:], n - got)
            if not r:
                return None
            got += r
        return buf

    # ---- send side ----------------------------------------------------------
    def deliver(self, msg: Message, _dup_ok: bool = True) -> bool:
        if self.fault.should_drop(msg):
            with self._registry_mu:
                # separate ledger: DGT acceptance metrics must not
                # conflate lossy-channel loss with reliable-channel drop
                # injection — and only count it as UDP loss if the
                # message would actually have ridden the UDP path
                # (remote destination, datagram-sized)
                # nbytes underestimates the serialized frame (headers /
                # keys / lens); leave margin so a message the real path
                # would have sent over TCP isn't ledgered as UDP loss
                self._count_drop(udp=(
                    msg.channel >= 1
                    and str(msg.recipient) not in self._boxes
                    and msg.nbytes <= self.UDP_MAX - 4096))
            return False
        if _dup_ok and self.fault.should_duplicate(msg):
            # at-least-once injection (mirrors InProcFabric): a copy of
            # the frame goes out ahead of the original
            import copy

            self.deliver(copy.copy(msg), _dup_ok=False)
        dest = str(msg.recipient)
        box = self._boxes.get(dest)
        if box is not None:  # local shortcut (several roles per process)
            box.put(msg)
            return True
        if dest not in self.plan:
            raise KeyError(f"no mailbox for {msg.recipient}")
        # scatter-gather: the payload arrays go onto the socket as their
        # own iovecs — no getvalue()/concat copy of a multi-hundred-MB
        # frame anywhere on the send path (the length prefix and prelude
        # share the first small buffer)
        if _message.WIRE_V2:
            frames = msg.to_frames()
            total = sum(memoryview(f).nbytes for f in frames)
        else:  # v1-pinned encoder (GEOMX_WIRE_FORMAT=v1)
            frames = [msg.to_bytes()]
            total = len(frames[0])
        roll = self.fault.corruption_roll(msg)
        if roll is not None:
            # seeded in-flight damage: flatten the scatter-gather list
            # and corrupt the serialized frame — what a flipped bit on
            # the physical WAN does; the receiver's checksum (or lack of
            # one) decides what happens next
            mode, rng = roll
            data = corrupt_bytes(b"".join(bytes(f) for f in frames),
                                 rng, mode)
            frames = [data]
            total = len(data)
        if msg.channel >= 1 and total <= self.UDP_MAX:
            # lossy DGT channel: one best-effort datagram, no dial, no
            # retransmit; send failures are losses by design
            data = b"".join(bytes(f) for f in frames)
            host, port = self.plan[dest]
            try:
                self._udp_sock(msg.channel).sendto(data, (host, port))
            except OSError:
                with self._registry_mu:
                    self._count_drop(udp=True)
                return False
            with self._registry_mu:
                self.udp_datagrams_sent += 1
            return True
        frames.insert(0, struct.pack("<q", total))
        with self._registry_mu:
            mu = self._conn_mus.setdefault(dest, threading.Lock())
        with mu:
            queued = self._dialing.get(dest)
            if queued is not None:  # behind the first dial to this peer
                queued.append(frames)
                return True
            conn = self._conns.get(dest)
            if conn is None or getattr(conn, "broken", False):
                if conn is not None:  # async write failure marked it
                    conn.close()
                    self._conns.pop(dest, None)
                conn = self._dial_or_defer(dest, frames)
                if conn is None:
                    return True
            try:
                self._send_on(conn, frames)
            except OSError:
                # peer restarted: redial once; drop the dead socket from
                # the registry first so a failed redial doesn't leave it
                # there for every later send to trip over.  Resending
                # from frame 0 on the FRESH stream is safe — the broken
                # connection dies with whatever partial frame it carried
                conn.close()
                self._conns.pop(dest, None)
                conn = self._dial(dest)
                self._send_on(conn, frames)
        return True

    def _dial_or_defer(self, dest: str, frames) -> Optional[socket.socket]:
        """One connect attempt to ``dest``; if it is refused while the
        peer's bring-up window is open (never reached yet), the rest of
        the window is waited out on a thread of its own
        (:meth:`_dial_behind`), which sends ``frames`` and whatever
        follows them once the peer answers: returns None then.  So no
        send holds its thread for the window: not a relaunched server's
        notices to a dead worker, nor a client's first read at a killed
        replica (C12, C14).  Caller holds the destination's lock."""
        try:
            return self._dial(dest, retry_for=0.0)
        except OSError as e:
            transient = (isinstance(e, TimeoutError)
                         or e.errno in self._TRANSIENT_ERRNOS)
            with self._registry_mu:
                opened = self._dial_window.get(dest, 0.0)
                patient = (transient and not self._stop
                           and dest not in self._established
                           and time.monotonic() < opened + self.DIAL_WINDOW_S)
            if not patient:
                raise
        self._dialing[dest] = [frames]
        threading.Thread(target=self._dial_behind, args=(dest,),
                         daemon=True, name=f"dial-{dest}").start()
        return None

    def _dial_behind(self, dest: str) -> None:
        """Dial ``dest`` through its bring-up window, then send what
        queued for it in order; a peer that never answers loses those
        messages, ledgered as drops (the resend layer owns recovery, as
        for a dial that fails in the sender's thread)."""
        try:
            conn = self._dial(dest)
        except OSError:
            conn = None
        with self._registry_mu:
            mu = self._conn_mus[dest]
        with mu:
            queued = self._dialing.pop(dest)
            while conn is not None and queued:
                try:
                    self._send_on(conn, queued[0])
                except OSError:
                    conn.close()
                    self._conns.pop(dest, None)
                    break
                queued.pop(0)
            with self._registry_mu:
                for _ in queued:
                    self._count_drop()

    def _send_on(self, conn, frames) -> None:
        """One message onto ``conn`` — blocking ``sendmsg`` loop on the
        thread path, write-queue submit (with backpressure) on a
        reactor ``_SendConn``."""
        if isinstance(conn, _SendConn):
            conn.send(frames)
        else:
            self._sendmsg_all(conn, frames)

    @staticmethod
    def _sendmsg_all(conn: socket.socket, frames) -> None:
        """sendall for a buffer list: one sendmsg gathers every iovec;
        short writes advance into the list without copying."""
        bufs = [memoryview(f).cast("B") for f in frames]
        while bufs:
            sent = conn.sendmsg(bufs)
            while sent > 0 and bufs:
                n = bufs[0].nbytes
                if sent >= n:
                    sent -= n
                    bufs.pop(0)
                else:
                    bufs[0] = bufs[0][sent:]
                    sent = 0

    # connect errors worth waiting out during bring-up; anything else
    # (DNS failure, ENETUNREACH, …) is a config error and raises at once
    _TRANSIENT_ERRNOS = frozenset({errno.ECONNREFUSED, errno.ECONNRESET,
                                   errno.ECONNABORTED, errno.ETIMEDOUT})

    # how long a first dial to a peer retries while its listener comes up
    DIAL_WINDOW_S = 30.0

    def _dial(self, dest: str, retry_for: float = DIAL_WINDOW_S
              ) -> socket.socket:
        """Connect to a peer, retrying while its listener comes up.

        Roles start as independent processes in arbitrary order (the
        reference's ZMQ sockets reconnect transparently); a connection
        refused during the bring-up window must retry, not drop — a lost
        control command (e.g. set_optimizer) would hang the caller.

        The retry window opens at the FIRST dial attempt to a peer and is
        never re-armed: once the peer has been reached — or the window
        has expired without contact — later dial failures fail fast, so
        the (serial) heartbeat and resend loops are not head-of-line
        blocked behind a dead destination.  Redelivery to a restarted
        peer is the resend layer's job."""
        host, port = self.plan[dest]
        with self._registry_mu:
            if dest in self._established:
                deadline = 0.0
            else:
                opened = self._dial_window.setdefault(dest, time.monotonic())
                deadline = opened + retry_for
        while True:
            try:
                conn = socket.create_connection((host, port), timeout=5)
                break
            except OSError as e:
                # connect timeouts surface as TimeoutError with errno None
                transient = (isinstance(e, TimeoutError)
                             or e.errno in self._TRANSIENT_ERRNOS)
                if (self._stop or not transient
                        or time.monotonic() >= deadline):
                    raise
                time.sleep(0.1)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.reactor is not None:
            # wrap in the write-queue state machine; the reactor's loop
            # drains it on write readiness — no send thread, no redials
            # hidden inside the loop
            conn = _SendConn(conn, self.reactor)
        with self._registry_mu:
            if self._stop:  # lost the race against shutdown()
                conn.close()
                raise OSError(errno.ESHUTDOWN, "fabric shut down")
            self._conns[dest] = conn
            self._established.add(dest)
        return conn

    def add_address(self, node: str, addr: Tuple[str, int]) -> None:
        """Explicitly register an OUT-OF-PLAN peer (a dynamically joined
        worker, ref: ADD_NODE van.cc:41-112).  Distinct from
        ``update_address``, which deliberately ignores unknown nodes as
        stale broadcasts."""
        with self._registry_mu:
            if node not in self.plan:
                self.plan[node] = addr
        self.update_address(node, addr)

    def update_address(self, node: str, addr: Tuple[str, int]) -> None:
        """Re-point a peer's address (replacement node at a new
        host:port).  Drops any live connection to the old address and
        re-arms the bring-up dial window so the next send retries while
        the replacement finishes starting."""
        if node not in self.plan:
            return  # unknown node: a stale broadcast from another epoch
        with self._registry_mu:
            if self.plan[node] == addr:
                return
            self.plan[node] = addr
            conn = self._conns.pop(node, None)
            self._established.discard(node)
            self._dial_window.pop(node, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def shutdown(self):
        self._stop = True
        for srv in self._listeners:
            # close() alone does not release a listener whose accept() is
            # blocked in another thread — the kernel keeps the socket (and
            # the port) alive until accept returns; shutdown() wakes it
            try:
                srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                srv.close()
            except OSError:
                pass
        # wake UDP recv loops blocked in recvfrom: close() alone does not
        # release the port while the syscall holds the open file
        # description (the UDP analog of the listener-shutdown note
        # above; shutdown() on an unconnected UDP socket is ENOTCONN on
        # Linux, so poke it with a self-datagram instead)
        for sock in list(self._udp_recv):
            try:
                port = sock.getsockname()[1]
                sock.sendto(b"", ("127.0.0.1", port))
            except OSError:
                pass
        # reactor mode: unregister the listener/udp fds from the shared
        # loops (closing their sockets as a side effect — the reactor
        # itself is process-lifetime and keeps running for other users)
        for reg in self._reactor_regs:
            reg.close()
        self._reactor_regs.clear()
        # snapshot under the lock, close OUTSIDE it: a reactor
        # _RecvConn.close re-enters _registry_mu to delist itself
        with self._registry_mu:
            targets = (list(self._conns.values()) + list(self._accepted)
                       + list(self._udp_recv)
                       + list(self._udp_send.values()))
            self._conns.clear()
            self._accepted.clear()
            self._udp_recv.clear()
            self._udp_send.clear()
        for c in targets:
            try:
                c.close()
            except OSError:
                pass
