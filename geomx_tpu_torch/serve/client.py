"""Read-path client for the replica tier.

Unlike :class:`~geomx_tpu_torch.kvstore.client.WorkerKVStore` (which slices
requests across the training tiers), a :class:`ReplicaClient` talks to
ONE replica that holds the whole key space, and it needs the response
*body* (the ``{staleness_s, version, rounds_at_refresh}`` contract
metadata), so it processes raw messages instead of riding KVWorker's
merge path.  An inference frontend holds one client per replica and
load-balances/fails over by retargeting.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from geomx_tpu_torch.core.config import Config, NodeId, Role
from geomx_tpu_torch.kvstore.common import APP_PS, Cmd, Ctrl
from geomx_tpu_torch.kvstore.keys import KeyPlan
from geomx_tpu_torch.ps import KVPairs, Postoffice
from geomx_tpu_torch.ps.kv_app import _App
from geomx_tpu_torch.transport.message import Domain, Message


class ReplicaError(RuntimeError):
    """A replica answered with an error body.  ``body`` keeps the
    STRUCTURED response — the admission-control shed fields
    (``shed``/``retry_after_s``/``inflight``/``retired``) the balancer
    needs to deprioritize the replica and retry elsewhere, which the
    flattened message string cannot carry."""

    def __init__(self, message: str, body: Optional[dict] = None):
        super().__init__(message)
        self.body = dict(body or {})

    @property
    def shed(self) -> bool:
        """True for an explicit admission-control refusal (the replica
        is overloaded or retiring, not broken)."""
        return bool(self.body.get("shed"))

    @property
    def retry_after_s(self) -> float:
        return float(self.body.get("retry_after_s", 0.0) or 0.0)


class ReplicaClient(_App):
    """One query endpoint toward one serve replica."""

    def __init__(self, postoffice: Postoffice,
                 config: Optional[Config] = None,
                 replica: Union[NodeId, int] = 0,
                 customer_id: int = 3,
                 advertise: Optional[tuple] = None):
        # state BEFORE super(): the Customer registers with the
        # postoffice inside _App.__init__, and from that moment
        # _process may run on a delivery thread
        self._mu = threading.Lock()
        self._replies: Dict[int, Message] = {}
        super().__init__(APP_PS, customer_id, postoffice)
        self.po = postoffice
        self.config = config or postoffice.config
        if not isinstance(replica, NodeId):
            replica = NodeId(Role.REPLICA, int(replica))
        self.target = replica
        # OUT-OF-PLAN TCP querier (the serve.load driver, an inference
        # frontend outside the static plan): ship the reply address in
        # every request body, status-console style, so the replica can
        # dial back
        self._advertise = advertise
        # the same deterministic tensor→key encoding every node computes
        self.plan = KeyPlan(
            num_shards=postoffice.topology.num_global_servers,
            bigarray_bound=self.config.bigarray_bound)
        self.reads = 0

    def retarget(self, replica: Union[NodeId, int]):
        """Point at another replica (load balancing / replica death)."""
        if not isinstance(replica, NodeId):
            replica = NodeId(Role.REPLICA, int(replica))
        self.target = replica

    # ---- message plumbing ----------------------------------------------------
    def _process(self, msg: Message):
        if not msg.push and not msg.pull:
            self._handle_command(msg)
            return
        if msg.request:
            return  # stray
        with self._mu:
            self._replies[msg.timestamp] = msg
            while len(self._replies) > 1024:  # timed-out orphans
                self._replies.pop(next(iter(self._replies)))
        self.customer.add_response(msg.timestamp)

    def _body(self, body: Optional[dict] = None) -> Optional[dict]:
        if self._advertise is None:
            return body
        out = dict(body or {})
        out["addr"] = [self._advertise[0], int(self._advertise[1])]
        return out

    def _roundtrip(self, msg_fields: dict, timeout: float) -> Message:
        if self._advertise is not None:
            msg_fields = dict(msg_fields,
                              body=self._body(msg_fields.get("body")))
        ts = self.customer.new_request(1)
        self.po.van.send(Message(
            recipient=self.target, domain=Domain.GLOBAL,
            app_id=self.customer.app_id,
            customer_id=self.customer.customer_id,
            timestamp=ts, request=True, **msg_fields))
        self.customer.wait(ts, timeout=timeout)
        with self._mu:
            msg = self._replies.pop(ts)
        body = msg.body if isinstance(msg.body, dict) else {}
        if "error" in body:
            raise ReplicaError(str(body["error"]), body=body)
        return msg

    # ---- public API ----------------------------------------------------------
    def list_keys(self, timeout: float = 5.0) -> List[int]:
        """The key set the replica currently holds."""
        ts = self.send_cmd(self.target, Ctrl.LIST_KEYS,
                           body=self._body(), domain=Domain.GLOBAL,
                           wait=False)
        self.customer.wait(ts, timeout=timeout)
        reply = self.cmd_response(ts) or {}
        return [int(k) for k in reply.get("keys", ())]

    def stats(self, timeout: float = 5.0) -> dict:
        ts = self.send_cmd(self.target, Ctrl.QUERY_STATS,
                           body=self._body(), domain=Domain.GLOBAL,
                           wait=False)
        self.customer.wait(ts, timeout=timeout)
        return self.cmd_response(ts) or {}

    def pull(self, keys, timeout: float = 10.0) -> Tuple[KVPairs, dict]:
        """Read raw ps keys; returns ``(KVPairs, meta)`` where meta is
        the replica's staleness contract body."""
        ks = np.asarray(sorted(int(k) for k in keys), dtype=np.int64)
        msg = self._roundtrip({"pull": True, "cmd": int(Cmd.SERVE_PULL),
                               "keys": ks}, timeout)
        self.reads += 1
        return (KVPairs(msg.keys, msg.vals, msg.lens),
                dict(msg.body or {}))

    def pull_tensor(self, tid: int, size: int,
                    timeout: float = 10.0) -> Tuple[np.ndarray, dict]:
        """Read one flat tensor by id (reassembled across its keys)."""
        parts = self.plan.parts(tid, size)
        kvs, meta = self.pull([p.ps_key for p in parts], timeout)
        got = {k: v for k, v in kvs.slices()}
        out = np.empty(size, dtype=np.float32)
        for p in parts:
            out[p.start:p.start + p.length] = got[p.ps_key]
        return out, meta

    def predict(self, x: np.ndarray, layers: List[tuple],
                relu: bool = True,
                timeout: float = 10.0) -> Tuple[np.ndarray, dict]:
        """Forward pass on the replica: ``layers`` is a list of
        ``(tensor_id, (rows, cols))`` (optionally ``(tensor_id,
        (rows, cols), bias_tensor_id)``) naming an MLP's weight chain.
        Each layer tensor must live whole under one ps key (like the
        row-sparse contract — partitioned layers are rejected here, not
        corrupted there)."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        spec = []
        for ly in layers:
            tid, (rows, cols) = ly[0], ly[1]
            parts = self.plan.parts(tid, rows * cols)
            if len(parts) != 1:
                raise ValueError(
                    f"predict layer tensor {tid} ({rows}x{cols}) spans "
                    f"{len(parts)} ps keys; predict layers must fit one "
                    "key (raise bigarray_bound or shrink the layer)")
            ent = {"key": parts[0].ps_key, "rows": rows, "cols": cols}
            if len(ly) > 2 and ly[2] is not None:
                bparts = self.plan.parts(int(ly[2]), cols)
                if len(bparts) != 1:
                    raise ValueError(f"bias tensor {ly[2]} spans keys")
                ent["bias"] = bparts[0].ps_key
            spec.append(ent)
        msg = self._roundtrip({
            "push": True, "pull": True, "cmd": int(Cmd.PREDICT),
            "keys": np.array([0], dtype=np.int64),
            "vals": x.ravel(),
            "lens": np.array([x.size], dtype=np.int64),
            "body": {"layers": spec, "batch": int(x.shape[0]),
                     "relu": bool(relu)},
        }, timeout)
        body = dict(msg.body or {})
        shape = body.get("shape") or [int(x.shape[0]), -1]
        self.reads += 1
        return np.asarray(msg.vals, np.float32).reshape(shape), body
