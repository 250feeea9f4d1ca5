"""Cross-process frame provenance: the telemetry sidecar.

The span tracer (obs/trace.py) stops at a process boundary — a peer's
``net_send`` and the relay's ``relay_pump`` are separate files with no
edge between them. This module adds the missing link WITHOUT touching a
single wire byte:

- :class:`SidecarSocket` is a purely **passive tap** around any
  ``NonBlockingSocket``: it forwards ``send_to`` bytes verbatim, returns
  ``receive_all`` results verbatim, and transmits nothing of its own. It
  only *records* — direction, timestamp, datagram length, a content
  digest, the decoded wire type, and (for inputs / stream deltas) the
  frame the datagram is about — into a bounded :class:`ProvenanceLog`.

- The **flow key** is an FNV-1a 64-bit digest of the datagram bytes.
  This works cross-process because the relay forwards envelopes
  *verbatim* (relay/server.py): the same bytes — hence the same digest —
  appear at peer-tx, relay-rx, relay-tx, and destination-rx, so the merge
  tool (obs/merge.py) can chain those four records into one Perfetto flow
  without any process ever exchanging telemetry.

Determinism contract (the "sidecar is provably inert" requirement of
docs/observability.md): the tap sends no datagrams, consumes no RNG (so
ChaosSocket fault schedules are byte-identical with the tap on or off),
and never mutates or reorders traffic. The provenance context (match id,
epoch) is host-side metadata attached to *records*, never to payloads —
hashed wire contents are untouched, so attestation and checksum compare
see identical streams. tests/test_telemetry_determinism.py holds this
bitwise.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Dict, List, Optional, Tuple

from ..session import protocol

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3

#: Wire-type byte -> short record tag (unknown types record as "t<N>").
_TYPE_TAGS = {
    protocol.T_SYNC_REQUEST: "sync_request",
    protocol.T_SYNC_REPLY: "sync_reply",
    protocol.T_INPUT: "input",
    protocol.T_INPUT_ACK: "input_ack",
    protocol.T_QUALITY_REPORT: "quality_report",
    protocol.T_QUALITY_REPLY: "quality_reply",
    protocol.T_KEEP_ALIVE: "keep_alive",
    protocol.T_CHECKSUM_REPORT: "checksum_report",
    protocol.T_STATE_REQUEST: "state_request",
    protocol.T_STATE_CHUNK: "state_chunk",
    protocol.T_RELAY_HELLO: "relay_hello",
    protocol.T_RELAY_WELCOME: "relay_welcome",
    protocol.T_RELAY_FORWARD: "relay_forward",
    protocol.T_SUBSCRIBE: "subscribe",
    protocol.T_STREAM_DELTA: "stream_delta",
    protocol.T_STREAM_KEYFRAME: "stream_keyframe",
    protocol.T_STREAM_ACK: "stream_ack",
    protocol.T_MIGRATE_OFFER: "migrate_offer",
    protocol.T_MIGRATE_ACCEPT: "migrate_accept",
    protocol.T_MIGRATE_CHUNK: "migrate_chunk",
    protocol.T_MIGRATE_DONE: "migrate_done",
    protocol.T_FLEET_HEARTBEAT: "fleet_heartbeat",
    protocol.T_CTRL_FRAME: "ctrl_frame",
    protocol.T_CTRL_ACK: "ctrl_ack",
}


def flow_key(data: bytes) -> int:
    """FNV-1a 64 digest of one datagram — the cross-process flow id."""
    h = _FNV64_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def _classify(data: bytes) -> Tuple[str, Optional[int], Optional[str]]:
    """(type tag, provenance frame | None, inner type tag | None) for one
    datagram, read-only. The frame is the wire field that names WHICH
    frame this datagram is about: ``start_frame`` for inputs, ``frame``
    for checksum reports / state chunks / stream deltas+keyframes. For a
    relay-forward envelope the inner datagram is classified too (the
    relay never parses it, but the tap may)."""
    hdr = protocol._HDR
    if len(data) < hdr.size:
        return "garbage", None, None
    magic, _version, mtype = hdr.unpack_from(data)
    if magic != protocol.MAGIC:
        return "garbage", None, None
    tag = _TYPE_TAGS.get(mtype, f"t{mtype}")
    body = data[hdr.size:]
    frame: Optional[int] = None
    inner: Optional[str] = None
    try:
        if mtype == protocol.T_INPUT:
            frame = protocol.InputMsg._FMT.unpack_from(body)[1]
        elif mtype == protocol.T_CHECKSUM_REPORT:
            frame = protocol._I32U64.unpack_from(body)[0]
        elif mtype == protocol.T_STATE_CHUNK:
            frame = protocol._STATE_CHUNK.unpack_from(body)[2]
        elif mtype == protocol.T_STREAM_DELTA:
            frame = protocol._STREAM_DELTA.unpack_from(body)[0]
        elif mtype == protocol.T_STREAM_KEYFRAME:
            frame = protocol._STREAM_KF.unpack_from(body)[0]
        elif mtype == protocol.T_MIGRATE_OFFER:
            frame = protocol._MIG_OFFER.unpack_from(body)[2]
        elif mtype == protocol.T_MIGRATE_CHUNK:
            frame = protocol._MIG_CHUNK.unpack_from(body)[1]
        elif mtype == protocol.T_MIGRATE_DONE:
            frame = protocol._MIG_DONE.unpack_from(body)[1]
        elif mtype == protocol.T_RELAY_FORWARD:
            inner, frame, _ = _classify(body[protocol._RELAY_FWD.size:])
        elif mtype == protocol.T_CTRL_FRAME:
            # Reliable-sublayer envelope: classify THROUGH it — the
            # envelope is transport plumbing, and a tap below the
            # ReliableSocket should attribute the inner control frame
            # exactly as if the sublayer weren't there.
            return _classify(body[protocol._CTRL_FRAME.size:])
    except Exception:
        pass
    return tag, frame, inner


class ProvenanceLog:
    """Bounded record ring for one component (one process track).

    ``component`` names the track in the merged trace ("peer0", "relay",
    "server", ...); ``pid`` must match the component's SpanTracer pid so
    merge can land flow arrows on the right process. ``set_context`` pins
    host-side provenance (match id, epoch) that subsequent records carry;
    it is metadata only and never reaches the wire.
    """

    def __init__(
        self,
        component: str,
        pid: int = 0,
        capacity: int = 200_000,
        clock=time.perf_counter,
        wall_t0: Optional[float] = None,
    ):
        self.component = component
        self.pid = int(pid)
        self._clock = clock
        self._origin = clock()
        self.wall_t0 = time.time() if wall_t0 is None else float(wall_t0)
        self._records = collections.deque(maxlen=int(capacity))
        self._context: Dict[str, object] = {}

    def set_context(self, **ctx) -> None:
        """Pin host-side provenance (``match=..., epoch=...``) onto
        subsequent records. ``None`` values clear keys."""
        for k, v in ctx.items():
            if v is None:
                self._context.pop(k, None)
            else:
                self._context[k] = v

    def _now_us(self) -> int:
        return int((self._clock() - self._origin) * 1e6)

    def record(self, direction: str, data: bytes, addr) -> None:
        tag, frame, inner = _classify(data)
        rec = {
            "ts_us": self._now_us(),
            "dir": direction,  # "tx" | "rx"
            "key": flow_key(data),
            "len": len(data),
            "type": tag,
            "addr": list(addr) if isinstance(addr, tuple) else addr,
        }
        if frame is not None:
            rec["frame"] = frame
        if inner is not None:
            rec["inner"] = inner
        if self._context:
            rec.update(self._context)
        self._records.append(rec)

    def records(self) -> List[dict]:
        return list(self._records)

    def export_jsonl(self, path: str) -> int:
        """First line is a ``{"meta": ...}`` header (component, pid,
        wall_t0); each further line is one record. Returns record count."""
        meta = {
            "meta": {
                "component": self.component,
                "pid": self.pid,
                "wall_t0": self.wall_t0,
            }
        }
        n = 0
        with open(path, "w") as f:
            f.write(json.dumps(meta) + "\n")
            for rec in self._records:
                f.write(json.dumps(rec) + "\n")
                n += 1
        return n


class SidecarSocket:
    """Passive provenance tap implementing the ``NonBlockingSocket``
    surface. Wrap the *raw* socket (below any RelaySocket, below the
    session) so relay envelopes are digested in their forwarded form —
    the form the relay re-sends verbatim, which is what makes the flow
    key identical at every hop. Safe below a ChaosSocket too: the tap
    transmits nothing, so chaos RNG draws are unchanged.
    """

    def __init__(self, inner, log: ProvenanceLog):
        self.inner = inner
        self.log = log

    def send_to(self, data: bytes, addr) -> None:
        self.log.record("tx", data, addr)
        self.inner.send_to(data, addr)

    def receive_all(self):
        out = self.inner.receive_all()
        for addr, data in out:
            self.log.record("rx", data, addr)
        return out

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def __getattr__(self, name):
        # Transparent for anything beyond the protocol surface
        # (local_addr, chaos controls, ...).
        return getattr(self.inner, name)
