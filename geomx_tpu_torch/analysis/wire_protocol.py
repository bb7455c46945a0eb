"""Checker: wire-protocol exhaustiveness for the four protocol enums
and the ``Message`` header field tables.

Rules:

``duplicate-enum-value``
    ``Control`` / ``Ctrl`` / ``Cmd`` / ``FlightEv`` values must be
    unique.  ``IntEnum`` silently aliases duplicate values — a
    copy-pasted value would make two protocol heads indistinguishable
    on the wire without any runtime error.

``undispatched-enum-member``
    Every member must be *referenced* outside its defining module, and
    (for the three command enums) referenced in at least one of the
    enum's receiver modules — adding a protocol head without a handler
    is dead wire surface at best and a silent drop at worst.  For
    ``FlightEv`` the requirement is a ``record(FlightEv.X`` call site
    anywhere (the postmortem renders codes generically by name, so the
    receiving role is the recorder itself).

``wire-field-table``
    The scalar fields packed by ``Message._pack_hdr`` define the wire
    header.  Every header field that is not per-chunk mechanics
    (seq/channel/offset bookkeeping) must be carried through the two
    places that *reconstruct* logical messages — the DGT chunk
    constructor (``DgtSender.split``) and the reassembly constructor
    (``DgtReassembler.accept``) — and must be unpacked by
    ``_unpack_hdr``.  This is the drift guard: add a new header field
    (the way ``policy_epoch`` and ``boot`` were added) and the checker
    fails until the chunk/reassembly tables carry it too.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from geomx_tpu_torch.analysis.core import Checker, Finding, Project, SourceFile

#: enum -> (defining module rel, receiver modules that must dispatch it)
ENUMS = {
    "Control": ("geomx_tpu_torch/transport/message.py", (
        "geomx_tpu_torch/transport/van.py", "geomx_tpu_torch/kvstore/server.py",
        "geomx_tpu_torch/kvstore/client.py", "geomx_tpu_torch/kvstore/sim.py",
        "geomx_tpu_torch/kvstore/eviction.py", "geomx_tpu_torch/ps/postoffice.py",
        "geomx_tpu_torch/serve/replica.py", "geomx_tpu_torch/obs/flight.py",
        "geomx_tpu_torch/sched/tsengine.py", "geomx_tpu_torch/sched/ts_push.py",
    )),
    "Ctrl": ("geomx_tpu_torch/kvstore/common.py", (
        "geomx_tpu_torch/kvstore/server.py", "geomx_tpu_torch/serve/replica.py",
        "geomx_tpu_torch/obs/collector.py", "geomx_tpu_torch/obs/state.py",
        "geomx_tpu_torch/trace/collector.py",
    )),
    "Cmd": ("geomx_tpu_torch/kvstore/common.py", (
        "geomx_tpu_torch/kvstore/server.py", "geomx_tpu_torch/serve/replica.py",
        "geomx_tpu_torch/kvstore/replication.py",
    )),
    "FlightEv": ("geomx_tpu_torch/obs/flight.py", ()),  # record-site rule
}

#: _pack_hdr fields that are per-chunk / transport mechanics — the DGT
#: constructors set them per chunk (or the van stamps them at send), so
#: they are exempt from the logical-message field tables
MECHANICAL = frozenset({
    "control", "domain", "first_key", "seq", "seq_begin", "seq_end",
    "total_bytes", "channel", "val_bytes", "msg_sig",
})

#: the constructors that must carry every logical header field
FIELD_TABLES = (
    ("geomx_tpu_torch/transport/dgt.py", "DgtSender.split",
     "DGT chunk constructor"),
    ("geomx_tpu_torch/transport/dgt.py", "DgtReassembler.accept",
     "DGT reassembly constructor"),
)


class WireProtocol(Checker):
    name = "wire-protocol"
    description = ("protocol enum values unique + dispatched; Message "
                   "header fields carried by the DGT chunk/reassembly "
                   "field tables")

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for enum_name, (def_rel, receivers) in ENUMS.items():
            findings.extend(self._check_enum(project, enum_name, def_rel,
                                             receivers))
        findings.extend(self._check_field_tables(project))
        return findings

    # -- enums -------------------------------------------------------------
    def _enum_members(self, sf: SourceFile, enum_name: str
                      ) -> List[Tuple[str, Optional[int], int]]:
        out: List[Tuple[str, Optional[int], int]] = []
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.ClassDef)
                    and node.name == enum_name):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    val = None
                    if isinstance(stmt.value, ast.Constant) \
                            and isinstance(stmt.value.value, int):
                        val = stmt.value.value
                    out.append((stmt.targets[0].id, val, stmt.lineno))
        return out

    def _check_enum(self, project: Project, enum_name: str, def_rel: str,
                    receivers: Tuple[str, ...]) -> List[Finding]:
        findings: List[Finding] = []
        sf = project.by_rel.get(def_rel)
        if sf is None:
            return findings  # fixture projects carry only what they test
        members = self._enum_members(sf, enum_name)
        if not members:
            return findings
        by_val: Dict[int, List[str]] = {}
        for name, val, line in members:
            if val is not None:
                by_val.setdefault(val, []).append(name)
        for val, names in sorted(by_val.items()):
            if len(names) > 1:
                findings.append(self.finding(
                    def_rel, members[0][2], enum_name,
                    f"dup:{val}",
                    f"{enum_name} value {val} assigned to multiple "
                    f"members {names} — IntEnum silently aliases them "
                    "and the wire cannot distinguish the heads"))
        for name, _, line in members:
            pat = re.compile(rf"\b{enum_name}\.{name}\b")
            if enum_name == "FlightEv":
                # recorded somewhere (possibly via a helper inside
                # flight.py itself), or referenced outside the defining
                # module (e.g. picked by a ternary at the record site)
                rec = re.compile(rf"record\(\s*FlightEv\.{name}\b")
                recorded = any(rec.search(f.text) for f in project.files)
                outside_ref = any(f.rel != def_rel and pat.search(f.text)
                                  for f in project.files)
                if not recorded and not outside_ref:
                    findings.append(self.finding(
                        def_rel, line, enum_name, f"norecord:{name}",
                        f"FlightEv.{name} is never recorded anywhere — "
                        "a dead event code the postmortem can never "
                        "see"))
                continue
            outside = [f.rel for f in project.files
                       if f.rel != def_rel and pat.search(f.text)]
            if not outside:
                findings.append(self.finding(
                    def_rel, line, enum_name, f"unused:{name}",
                    f"{enum_name}.{name} is never referenced outside "
                    f"{def_rel} — a protocol head nobody sends or "
                    "handles"))
                continue
            wanted = [r for r in receivers if r in project.by_rel]
            if wanted and not any(r in outside for r in wanted):
                findings.append(self.finding(
                    def_rel, line, enum_name, f"undispatched:{name}",
                    f"{enum_name}.{name} has no reference in any "
                    f"receiver module ({', '.join(wanted)}) — senders "
                    "exist but nothing dispatches it"))
        return findings

    # -- Message header field tables ---------------------------------------
    def _header_fields(self, sf: SourceFile) -> Tuple[Set[str], Set[str]]:
        """(packed self.<field> names from _pack_hdr, dict keys produced
        by _unpack_hdr)."""
        packed: Set[str] = set()
        unpacked: Set[str] = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "_pack_hdr":
                for n in ast.walk(node):
                    if isinstance(n, ast.Attribute) \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id == "self":
                        if n.attr not in ("_HDR",):
                            packed.add(n.attr)
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "_unpack_hdr":
                for n in ast.walk(node):
                    if isinstance(n, ast.Call):
                        fname = (n.func.id
                                 if isinstance(n.func, ast.Name) else "")
                        if fname == "dict":
                            unpacked.update(kw.arg for kw in n.keywords
                                            if kw.arg)
        return packed, unpacked

    def _check_field_tables(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        msg_sf = project.by_rel.get("geomx_tpu_torch/transport/message.py")
        if msg_sf is None:
            return findings
        packed, unpacked = self._header_fields(msg_sf)
        if not packed:
            return findings
        # flags are packed as one word and unpacked as four bools
        flag_fields = {"request", "push", "pull", "sampled"}
        logical = (packed | flag_fields) - MECHANICAL
        missing_unpack = logical - unpacked - {"flags"}
        for f in sorted(missing_unpack):
            findings.append(self.finding(
                "geomx_tpu_torch/transport/message.py", 1, "Message._unpack_hdr",
                f"unpack:{f}",
                f"header field {f!r} is packed by _pack_hdr but never "
                "restored by _unpack_hdr — it dies at the first TCP "
                "hop"))
        # the two DGT constructors must carry every logical field
        #  (minus flags-word internals that ride as separate kwargs)
        required = logical - {"flags"}
        dgt_sf = project.by_rel.get("geomx_tpu_torch/transport/dgt.py")
        if dgt_sf is None:
            return findings
        for rel, qual, label in FIELD_TABLES:
            sf = project.by_rel.get(rel)
            if sf is None:
                continue
            kwargs = self._message_ctor_kwargs(sf, qual)
            if kwargs is None:
                findings.append(self.finding(
                    rel, 1, qual, "ctor-missing",
                    f"{label}: no Message(...) constructor found in "
                    f"{qual} — the field-table audit has nothing to "
                    "check"))
                continue
            got, line = kwargs
            for f in sorted(required - got):
                findings.append(self.finding(
                    rel, line, qual, f"field:{f}",
                    f"{label} does not carry Message.{f} — a chunked/"
                    "reassembled message silently loses it (the class "
                    "of bug that breaks replay dedup and trace "
                    "correlation across DGT)"))
        return findings

    def _message_ctor_kwargs(self, sf: SourceFile, qual: str
                             ) -> Optional[Tuple[Set[str], int]]:
        """Union of kwarg names over Message(...) calls plus attribute
        assignments (``chunk.keys = ...``) inside one function."""
        target = None
        for fn in sf.functions:
            if fn.qualname == qual:
                target = fn
                break
        if target is None or isinstance(target.node, ast.Lambda):
            return None
        got: Set[str] = set()
        line = target.node.lineno
        found = False
        assigned_names: Set[str] = set()
        for n in ast.walk(target.node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id == "Message":
                found = True
                line = n.lineno
                got.update(kw.arg for kw in n.keywords if kw.arg)
            if isinstance(n, ast.Assign):
                for tgt in n.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name):
                        assigned_names.add(tgt.attr)
        if not found:
            return None
        return got | assigned_names, line
