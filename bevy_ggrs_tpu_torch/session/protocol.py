"""Wire protocol: the peer-to-peer message vocabulary.

Counterpart of ``bevy_ggrs_tpu/session/protocol.py``.

Reimplements the *semantics* of the ggrs UDP protocol the reference rides
(survey §2.2): sync handshake with nonce echo, input spans with redundancy
(every packet resends all unacked frames, so loss tolerance needs no
retransmit timer), acks, quality (ping/frame-advantage) exchange, keepalives,
and periodic confirmed-frame checksum reports for desync detection.

Encoding is a hand-rolled little-endian struct format (one magic/version
header byte pair + type byte), small enough to stay well under one MTU for
any plausible input size × redundancy span.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Optional, Tuple, Union

import numpy as np

MAGIC = 0x47  # 'G'
# v2: ChecksumReport widened to 64 bits (the reference's saved-state cell is
# u128-capable — ggrs_stage.rs:283; 32 bits collides too easily at one
# compare per 16 confirmed frames). Version mismatch = datagram dropped, but
# counted (see version_mismatch) so a skewed peer surfaces as an event
# instead of an indefinite sync stall.
# v3: resource-checksum semantics changed (position-keyed parallel hash,
# state.py:_resources_checksum) — checksum VALUES differ across builds for
# bit-identical worlds, so mixed-version peers must fail the handshake with
# VERSION_MISMATCH instead of firing a false DESYNC_DETECTED on the first
# compared resource-bearing frame. Checksum semantics are part of the wire
# contract this version gates.
# v4: SyncRequest/SyncReply carry a 64-bit config digest (the learned
# input-predictor's weight content hash, 0 = predictor off). Prediction
# only shapes each peer's LOCAL speculation tree — committed states come
# from confirmed inputs either way — but the digest makes the deployed
# prediction config attestable at handshake time: a peer running different
# weights is refused with a typed CONFIG_MISMATCH event instead of playing
# on with silently different recovery economics.
# v5: the data plane (types 1-8) gains a crc32 trailer over the whole frame,
# header included. Every OTHER family already carried integrity somewhere
# (StateChunk.crc, StreamDelta.crc, MigrateChunk.crc, CtrlFrame.crc) but a
# bit flip inside an InputMsg used to decode cleanly and inject a genuinely
# wrong input — REAL transport divergence that surfaced as a desync ballot.
# From v5 a corrupt data-plane datagram fails the trailer check and is
# dropped+counted (see crc_mismatch / PeerEndpoint.data_crc_drops),
# indistinguishable from loss, which the input-span redundancy already
# absorbs. Frame layout changed (4 trailing bytes), so this is a version
# bump: a v4 peer gets a typed VERSION_MISMATCH refusal, never a desync.
VERSION = 5

# Heartbeat staleness is a bounded reorder window on beat_seq, not a bare
# monotonic compare. Heartbeats travel unenveloped (the next beat is their
# retry), so a corrupted datagram that slips the 3-byte header check can
# carry a beat_seq with a high bit flipped; with a bare `seq <= last`
# guard that single beat would poison the receiver's floor and every
# later genuine beat would read as stale — a permanently "silent" live
# server. Inside the window a lower seq is a genuinely reordered stale
# beat (dropped); beyond it the receiver resets its floor (corruption or
# sender restart, either way self-healing within one beat).
BEAT_REORDER_WINDOW = 64

T_SYNC_REQUEST = 1
T_SYNC_REPLY = 2
T_INPUT = 3
T_INPUT_ACK = 4
T_QUALITY_REPORT = 5
T_QUALITY_REPLY = 6
T_KEEP_ALIVE = 7
T_CHECKSUM_REPORT = 8
# State-transfer pair (supervisor recovery path). New types need NO version
# bump: an old peer's decode() returns None for unknown type bytes and drops
# the datagram, so mixed deployments degrade to "no recovery", not desync.
T_STATE_REQUEST = 9
T_STATE_CHUNK = 10
# Relay tier (bevy_ggrs_tpu/relay/): peer registration + forwarding envelope
# so NAT'd peers exchange the types above THROUGH a RelayServer (the
# forwarded payload is a complete inner datagram, types 1-10 included — the
# relay never parses it), plus the broadcast spectator stream: subscribe /
# delta / keyframe / ack. Same no-version-bump rule: a relay-less peer drops
# these unknown type bytes and keeps playing direct.
T_RELAY_HELLO = 11
T_RELAY_WELCOME = 12
T_RELAY_FORWARD = 13
T_SUBSCRIBE = 14
T_STREAM_DELTA = 15
T_STREAM_KEYFRAME = 16
T_STREAM_ACK = 17
# Fleet tier (bevy_ggrs_tpu/fleet/): live cross-server match migration —
# offer/accept handshake, chunked digest-guarded snapshot transfer in the
# ServerCheckpointer blob format, and a commit ack — plus the balancer
# heartbeat every MatchServer emits. Same no-version-bump rule as the relay
# family: a fleet-less peer drops these unknown type bytes unharmed.
T_MIGRATE_OFFER = 18
T_MIGRATE_ACCEPT = 19
T_MIGRATE_CHUNK = 20
T_MIGRATE_DONE = 21
T_FLEET_HEARTBEAT = 22
# Reliable control-plane sublayer (transport/reliable.py): CtrlFrame wraps
# one control datagram in a per-peer sequence number + CRC envelope; CtrlAck
# acknowledges it. Retransmit-until-acked with receive-side dedup turns the
# lossy UDP control wire into at-least-once + idempotent delivery for the
# migration family under chaos. Same no-version-bump rule: a peer without
# the sublayer drops the unknown type bytes unharmed.
T_CTRL_FRAME = 23
T_CTRL_ACK = 24

# StateRequest.kind values.
STATE_KIND_RING = 0  # world snapshot at one settled frame (desync resync)
STATE_KIND_FULL = 1  # full runner+session checkpoint (crash-restart rejoin)

_HDR = struct.Struct("<BBB")  # magic, version, type

# v5 data-plane integrity: these frame types carry a crc32 trailer computed
# over the whole encoded frame (header included, trailer excluded). The set
# is exactly the types that previously had NO integrity guard of their own;
# types 9+ each carry a per-chunk crc or digest already, and heartbeats
# (type 22) are deliberately unenveloped (BEAT_REORDER_WINDOW absorbs them).
DATA_PLANE_TYPES = frozenset((
    T_SYNC_REQUEST, T_SYNC_REPLY, T_INPUT, T_INPUT_ACK,
    T_QUALITY_REPORT, T_QUALITY_REPLY, T_KEEP_ALIVE, T_CHECKSUM_REPORT,
))
_CRC = struct.Struct("<I")


@dataclasses.dataclass(frozen=True)
class SyncRequest:
    nonce: int
    # 64-bit session-config digest (v4): the input-predictor weight
    # content hash, or 0 when prediction is off. Checked on BOTH legs of
    # the handshake (see PeerEndpoint) — a mismatched peer never reaches
    # RUNNING.
    config_digest: int = 0


@dataclasses.dataclass(frozen=True)
class SyncReply:
    nonce: int
    config_digest: int = 0


@dataclasses.dataclass(frozen=True)
class InputMsg:
    """A span of inputs for one player: frames ``start_frame ..
    start_frame+num-1`` (redundant resend of everything unacked).
    ``ack_frame`` acks the receiver's inputs; ``sender_frame`` and
    ``advantage`` feed time sync."""

    handle: int
    start_frame: int
    payload: bytes  # num × input_size raw bytes
    num: int
    ack_frame: int
    sender_frame: int
    advantage: int  # sender's local frame advantage estimate (frames)

    _FMT = struct.Struct("<BiHHiih")

    def encode(self) -> bytes:
        return (
            self._FMT.pack(
                self.handle,
                self.start_frame,
                self.num,
                len(self.payload) // max(self.num, 1),
                self.ack_frame,
                self.sender_frame,
                self.advantage,
            )
            + self.payload
        )

    @classmethod
    def decode(cls, body: bytes) -> "InputMsg":
        handle, start, num, size, ack, sender, adv = cls._FMT.unpack_from(body)
        payload = body[cls._FMT.size : cls._FMT.size + num * size]
        return cls(handle, start, payload, num, ack, sender, adv)


@dataclasses.dataclass(frozen=True)
class InputAck:
    handle: int
    ack_frame: int


@dataclasses.dataclass(frozen=True)
class QualityReport:
    send_time_ms: int  # sender clock, ms, wraps at 2^32
    frame_advantage: int


@dataclasses.dataclass(frozen=True)
class QualityReply:
    pong_time_ms: int


@dataclasses.dataclass(frozen=True)
class KeepAlive:
    pass


@dataclasses.dataclass(frozen=True)
class ChecksumReport:
    frame: int
    checksum: int


@dataclasses.dataclass(frozen=True)
class StateRequest:
    """Ask a healthy peer for a state checkpoint (supervisor recovery).
    ``nonce`` identifies the transfer (the requester's retry key);
    ``resend_from`` lets a retry skip chunks already received."""

    nonce: int
    kind: int  # STATE_KIND_RING | STATE_KIND_FULL
    resend_from: int = 0


@dataclasses.dataclass(frozen=True)
class StateChunk:
    """One fragment of a serialized checkpoint. ``checksum`` is the 64-bit
    semantic digest of the DECODED world state (the transfer's signature:
    the receiver recomputes it after restore and rejects a tampered or
    corrupted payload); ``crc`` guards the individual fragment's bytes."""

    nonce: int
    kind: int
    frame: int
    checksum: int  # u64 semantic digest of the whole decoded state
    seq: int
    total: int
    crc: int  # crc32 of this chunk's payload bytes
    payload: bytes


@dataclasses.dataclass(frozen=True)
class RelayHello:
    """Register (and keep alive) the sender's address at a relay as
    ``(session_id, peer_id)``. Sent periodically — it doubles as the NAT
    keepalive and the relay-liveness probe: every hello is answered by a
    :class:`RelayWelcome`, and a client that stops seeing welcomes fails
    over to its standby relay (relay/client.py)."""

    session_id: int
    peer_id: int


@dataclasses.dataclass(frozen=True)
class RelayWelcome:
    """Hello ack. ``epoch`` identifies the relay *instance*: a restarted
    (or standby) relay carries a different epoch, which tells publishers
    their delta chain's base is gone relay-side and a fresh keyframe must
    re-seed the stream buffer."""

    session_id: int
    peer_id: int
    epoch: int


@dataclasses.dataclass(frozen=True)
class RelayForward:
    """The forwarding envelope. Client→relay: ``dst`` names the target
    peer_id, ``src`` must match the sender's registration (spoofed srcs are
    dropped). Relay→client: ``src`` preserved, and the receiver surfaces
    ``payload`` as one inner datagram from the *logical* address
    ``("relay-peer", src)`` — sessions never learn real peer addresses, so
    relay failover changes no endpoint key."""

    src: int
    dst: int
    payload: bytes


@dataclasses.dataclass(frozen=True)
class Subscribe:
    """Spectator→relay: join (or resume) the confirmed-state stream.
    ``cursor`` is the last frame the spectator holds reconstructed
    (NULL_FRAME/-1 for a cold join → the relay starts from its newest
    keyframe); ``window`` is the spectator's receive budget in frames — the
    relay never sends deltas more than ``window`` frames past the last
    ack (explicit backpressure)."""

    session_id: int
    cursor: int
    window: int


@dataclasses.dataclass(frozen=True)
class StreamDelta:
    """One confirmed frame as an XOR+RLE delta against the previously
    published frame ``base_frame`` (exact — confirmed frames are
    bitwise-stable). ``crc`` is crc32 of the RECONSTRUCTED full state
    bytes, so a corrupted delta is rejected after apply, not trusted."""

    frame: int
    base_frame: int
    crc: int
    payload: bytes


@dataclasses.dataclass(frozen=True)
class StreamKeyframe:
    """One fragment of a full confirmed-state snapshot (chunked like
    :class:`StateChunk`). ``crc`` guards this fragment's bytes; ``digest``
    is the 64-bit digest of the whole reassembled state payload."""

    frame: int
    seq: int
    total: int
    crc: int
    digest: int
    payload: bytes


@dataclasses.dataclass(frozen=True)
class StreamAck:
    """Spectator→relay flow control: ``frame`` is the highest frame the
    spectator has RECONSTRUCTED (contiguously applied), not merely
    received — the relay's send window advances only on real progress."""

    frame: int


@dataclasses.dataclass(frozen=True)
class MigrateOffer:
    """Source server -> target server: propose moving one live match.
    ``nonce`` keys the transfer; ``match_id`` is the fleet-level match
    identity; ``frame`` the frame the snapshot was drained at; ``total``
    the chunk count about to follow; ``digest`` the 64-bit payload digest
    of the whole reassembled ServerCheckpointer-format blob (the target
    verifies it BEFORE unpacking — a corrupt migration must abort, not
    readmit a plausible impostor). ``epoch`` is the match's fencing token:
    the migration authority (balancer / ProcFleet parent) bumps it on every
    transfer attempt, so a duplicated or delayed offer from a superseded
    attempt is refused structurally instead of creating a second live copy
    of the match (split-brain)."""

    nonce: int
    match_id: int
    frame: int
    total: int
    digest: int
    epoch: int = 0


# MigrateAccept.reason values when accept == 0.
MIG_REFUSE_CAPACITY = 0  # no free slot / draining
MIG_REFUSE_EPOCH = 1  # stale fencing token (superseded transfer attempt)
MIG_REFUSE_DUP = 2  # match already hosted here (duplicate offer)


@dataclasses.dataclass(frozen=True)
class MigrateAccept:
    """Target -> source: ``accept`` 1 reserves capacity for the transfer
    (0 = refusing; the source readmits locally and nothing is lost).
    ``epoch`` echoes the offer's fencing token; ``reason`` types the
    refusal (``MIG_REFUSE_*``) so the source can tell a capacity bounce
    from an epoch-fence rejection."""

    nonce: int
    accept: int
    epoch: int = 0
    reason: int = 0


@dataclasses.dataclass(frozen=True)
class MigrateChunk:
    """One fragment of the snapshot blob (chunked like
    :class:`StateChunk`). ``frame`` repeats the offer's drain frame so a
    passive provenance tap can attribute the fragment to the match's
    timeline; ``crc`` guards this fragment's bytes; ``epoch`` carries the
    offer's fencing token so a straggler chunk from a superseded attempt
    can be fenced without consulting the nonce table."""

    nonce: int
    frame: int
    seq: int
    total: int
    crc: int
    payload: bytes
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class MigrateDone:
    """Target -> source: the match readmitted at ``frame`` (``ok`` 1) or
    the transfer failed digest/unpack (``ok`` 0 — the source readmits its
    retained ticket; zero matches lost either way). ``epoch`` echoes the
    offer's fencing token: the authority refuses a landing whose epoch is
    older than the match's current one (the structural split-brain kill)."""

    nonce: int
    frame: int
    ok: int
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class FleetHeartbeat:
    """Server -> balancer liveness + load beacon, sent every
    ``heartbeat_interval`` served frames. ``pages`` counts slots whose SLO
    burn level is "page" (the balancer's primary placement repellent);
    missed beats past the balancer's timeout mark the server dead and
    trigger checkpoint failover. ``beat_seq`` is a monotonic per-server
    send counter: the receiver derives ``missed_beats`` from gaps in it
    and refuses to let a REORDERED stale beat refresh liveness (a beat
    with ``beat_seq`` <= the highest seen carries no new liveness
    information)."""

    server_id: int
    frames_served: int
    slots_active: int
    slots_free: int
    quarantined: int
    pages: int
    # Speculation-ledger rollup (permille, 0 when the ledger is off):
    # lifetime full-hit rate and waste ratio across the server's slots.
    spec_hit_permille: int = 0
    spec_waste_permille: int = 0
    beat_seq: int = 0


@dataclasses.dataclass(frozen=True)
class CtrlFrame:
    """Reliable-sublayer envelope: one control datagram (``payload`` is a
    fully-encoded inner frame, header included) under a per-peer ``seq``
    and a CRC32 over the payload. The receiver acks every valid CtrlFrame
    (including duplicates — the ack may have been the thing that was
    lost), delivers each seq at most once, and drops CRC failures
    silently (the sender retransmits)."""

    seq: int
    crc: int
    payload: bytes


@dataclasses.dataclass(frozen=True)
class CtrlAck:
    """Reliable-sublayer ack: ``seq`` received intact. Cumulative-free
    (one ack per frame) — simplicity over bandwidth on a low-rate
    control wire."""

    seq: int


Message = Union[
    SyncRequest, SyncReply, InputMsg, InputAck, QualityReport, QualityReply,
    KeepAlive, ChecksumReport, StateRequest, StateChunk,
    RelayHello, RelayWelcome, RelayForward, Subscribe,
    StreamDelta, StreamKeyframe, StreamAck,
    MigrateOffer, MigrateAccept, MigrateChunk, MigrateDone, FleetHeartbeat,
    CtrlFrame, CtrlAck,
]

_U32 = struct.Struct("<I")
_SYNC = struct.Struct("<IQ")  # nonce, config_digest
_I32U64 = struct.Struct("<iQ")
_BI = struct.Struct("<Bi")
_IH = struct.Struct("<Ih")
_STATE_REQ = struct.Struct("<IBi")  # nonce, kind, resend_from
_STATE_CHUNK = struct.Struct("<IBiQHHI")  # nonce kind frame checksum seq total crc
_RELAY_HELLO = struct.Struct("<IH")  # session_id, peer_id
_RELAY_WELCOME = struct.Struct("<IHI")  # session_id, peer_id, epoch
_RELAY_FWD = struct.Struct("<HH")  # src, dst
_SUBSCRIBE = struct.Struct("<IiH")  # session_id, cursor, window
_STREAM_DELTA = struct.Struct("<iiI")  # frame, base_frame, crc
_STREAM_KF = struct.Struct("<iHHIQ")  # frame, seq, total, crc, digest
_I32 = struct.Struct("<i")
# Migration structs: the fencing ``epoch`` is APPENDED so every prefix
# offset (and obs/provenance.py's prefix unpack_from reads) stays put.
_MIG_OFFER = struct.Struct(
    "<IIiHQI"
)  # nonce, match_id, frame, total, digest, epoch
_MIG_ACCEPT = struct.Struct("<IBIB")  # nonce, accept, epoch, reason
_MIG_CHUNK = struct.Struct("<IiHHII")  # nonce, frame, seq, total, crc, epoch
_MIG_DONE = struct.Struct("<IiBI")  # nonce, frame, ok, epoch
_FLEET_HB = struct.Struct(
    "<HIHHHHHHI"
)  # id, frames, active, free, quar, pages, spec_hit_pm, spec_waste_pm, beat_seq
_CTRL_FRAME = struct.Struct("<II")  # seq, crc (payload follows)
_CTRL_ACK = struct.Struct("<I")  # seq


def encode(msg: Message) -> bytes:
    data = _encode(msg)
    if data[2] in DATA_PLANE_TYPES:
        data += _CRC.pack(zlib.crc32(data) & 0xFFFFFFFF)
    return data


def _encode(msg: Message) -> bytes:
    if isinstance(msg, SyncRequest):
        return _HDR.pack(MAGIC, VERSION, T_SYNC_REQUEST) + _SYNC.pack(
            msg.nonce, msg.config_digest & 0xFFFFFFFFFFFFFFFF
        )
    if isinstance(msg, SyncReply):
        return _HDR.pack(MAGIC, VERSION, T_SYNC_REPLY) + _SYNC.pack(
            msg.nonce, msg.config_digest & 0xFFFFFFFFFFFFFFFF
        )
    if isinstance(msg, InputMsg):
        return _HDR.pack(MAGIC, VERSION, T_INPUT) + msg.encode()
    if isinstance(msg, InputAck):
        return _HDR.pack(MAGIC, VERSION, T_INPUT_ACK) + _BI.pack(
            msg.handle, msg.ack_frame
        )
    if isinstance(msg, QualityReport):
        return _HDR.pack(MAGIC, VERSION, T_QUALITY_REPORT) + _IH.pack(
            msg.send_time_ms & 0xFFFFFFFF, msg.frame_advantage
        )
    if isinstance(msg, QualityReply):
        return _HDR.pack(MAGIC, VERSION, T_QUALITY_REPLY) + _U32.pack(
            msg.pong_time_ms & 0xFFFFFFFF
        )
    if isinstance(msg, KeepAlive):
        return _HDR.pack(MAGIC, VERSION, T_KEEP_ALIVE)
    if isinstance(msg, ChecksumReport):
        return _HDR.pack(MAGIC, VERSION, T_CHECKSUM_REPORT) + _I32U64.pack(
            msg.frame, msg.checksum & 0xFFFFFFFFFFFFFFFF
        )
    if isinstance(msg, StateRequest):
        return _HDR.pack(MAGIC, VERSION, T_STATE_REQUEST) + _STATE_REQ.pack(
            msg.nonce & 0xFFFFFFFF, msg.kind, msg.resend_from
        )
    if isinstance(msg, StateChunk):
        return (
            _HDR.pack(MAGIC, VERSION, T_STATE_CHUNK)
            + _STATE_CHUNK.pack(
                msg.nonce & 0xFFFFFFFF,
                msg.kind,
                msg.frame,
                msg.checksum & 0xFFFFFFFFFFFFFFFF,
                msg.seq,
                msg.total,
                msg.crc & 0xFFFFFFFF,
            )
            + msg.payload
        )
    if isinstance(msg, RelayHello):
        return _HDR.pack(MAGIC, VERSION, T_RELAY_HELLO) + _RELAY_HELLO.pack(
            msg.session_id & 0xFFFFFFFF, msg.peer_id & 0xFFFF
        )
    if isinstance(msg, RelayWelcome):
        return _HDR.pack(MAGIC, VERSION, T_RELAY_WELCOME) + _RELAY_WELCOME.pack(
            msg.session_id & 0xFFFFFFFF, msg.peer_id & 0xFFFF,
            msg.epoch & 0xFFFFFFFF,
        )
    if isinstance(msg, RelayForward):
        return (
            _HDR.pack(MAGIC, VERSION, T_RELAY_FORWARD)
            + _RELAY_FWD.pack(msg.src & 0xFFFF, msg.dst & 0xFFFF)
            + msg.payload
        )
    if isinstance(msg, Subscribe):
        return _HDR.pack(MAGIC, VERSION, T_SUBSCRIBE) + _SUBSCRIBE.pack(
            msg.session_id & 0xFFFFFFFF, msg.cursor, msg.window & 0xFFFF
        )
    if isinstance(msg, StreamDelta):
        return (
            _HDR.pack(MAGIC, VERSION, T_STREAM_DELTA)
            + _STREAM_DELTA.pack(msg.frame, msg.base_frame, msg.crc & 0xFFFFFFFF)
            + msg.payload
        )
    if isinstance(msg, StreamKeyframe):
        return (
            _HDR.pack(MAGIC, VERSION, T_STREAM_KEYFRAME)
            + _STREAM_KF.pack(
                msg.frame, msg.seq, msg.total,
                msg.crc & 0xFFFFFFFF, msg.digest & 0xFFFFFFFFFFFFFFFF,
            )
            + msg.payload
        )
    if isinstance(msg, StreamAck):
        return _HDR.pack(MAGIC, VERSION, T_STREAM_ACK) + _I32.pack(msg.frame)
    if isinstance(msg, MigrateOffer):
        return _HDR.pack(MAGIC, VERSION, T_MIGRATE_OFFER) + _MIG_OFFER.pack(
            msg.nonce & 0xFFFFFFFF, msg.match_id & 0xFFFFFFFF, msg.frame,
            msg.total & 0xFFFF, msg.digest & 0xFFFFFFFFFFFFFFFF,
            msg.epoch & 0xFFFFFFFF,
        )
    if isinstance(msg, MigrateAccept):
        return _HDR.pack(MAGIC, VERSION, T_MIGRATE_ACCEPT) + _MIG_ACCEPT.pack(
            msg.nonce & 0xFFFFFFFF, msg.accept & 0xFF,
            msg.epoch & 0xFFFFFFFF, msg.reason & 0xFF,
        )
    if isinstance(msg, MigrateChunk):
        return (
            _HDR.pack(MAGIC, VERSION, T_MIGRATE_CHUNK)
            + _MIG_CHUNK.pack(
                msg.nonce & 0xFFFFFFFF, msg.frame, msg.seq & 0xFFFF,
                msg.total & 0xFFFF, msg.crc & 0xFFFFFFFF,
                msg.epoch & 0xFFFFFFFF,
            )
            + msg.payload
        )
    if isinstance(msg, MigrateDone):
        return _HDR.pack(MAGIC, VERSION, T_MIGRATE_DONE) + _MIG_DONE.pack(
            msg.nonce & 0xFFFFFFFF, msg.frame, msg.ok & 0xFF,
            msg.epoch & 0xFFFFFFFF,
        )
    if isinstance(msg, FleetHeartbeat):
        return _HDR.pack(MAGIC, VERSION, T_FLEET_HEARTBEAT) + _FLEET_HB.pack(
            msg.server_id & 0xFFFF, msg.frames_served & 0xFFFFFFFF,
            msg.slots_active & 0xFFFF, msg.slots_free & 0xFFFF,
            msg.quarantined & 0xFFFF, msg.pages & 0xFFFF,
            msg.spec_hit_permille & 0xFFFF, msg.spec_waste_permille & 0xFFFF,
            msg.beat_seq & 0xFFFFFFFF,
        )
    if isinstance(msg, CtrlFrame):
        return (
            _HDR.pack(MAGIC, VERSION, T_CTRL_FRAME)
            + _CTRL_FRAME.pack(msg.seq & 0xFFFFFFFF, msg.crc & 0xFFFFFFFF)
            + msg.payload
        )
    if isinstance(msg, CtrlAck):
        return _HDR.pack(MAGIC, VERSION, T_CTRL_ACK) + _CTRL_ACK.pack(
            msg.seq & 0xFFFFFFFF
        )
    raise TypeError(f"unknown message {msg!r}")


def version_mismatch(data: bytes) -> Optional[int]:
    """The sender's protocol version when this datagram carries our MAGIC but
    a different VERSION; None otherwise. :func:`decode` drops such datagrams
    (a v1 peer must not be half-parsed), but silently dropping them forever
    leaves mixed-version peers stuck in SYNCHRONIZING — callers count these
    and surface a VERSION_MISMATCH event so operators see the skew."""
    if len(data) >= _HDR.size:
        magic, version, _ = _HDR.unpack_from(data)
        if magic == MAGIC and version != VERSION:
            return version
    return None


def crc_mismatch(data: bytes) -> bool:
    """True when this datagram is a well-headed v5 data-plane frame whose
    crc32 trailer does not verify — i.e. a corruption *detected* by the v5
    guard (as opposed to garbage that never parsed a header, or a version
    skew, which version_mismatch covers). :func:`decode` drops these;
    callers count them (``data_crc_drops``) so wire corruption is visible
    as a rate instead of masquerading as plain loss."""
    if len(data) < _HDR.size + _CRC.size:
        return False
    magic, version, mtype = _HDR.unpack_from(data)
    if magic != MAGIC or version != VERSION or mtype not in DATA_PLANE_TYPES:
        return False
    (trailer,) = _CRC.unpack_from(data, len(data) - _CRC.size)
    return (zlib.crc32(data[: -_CRC.size]) & 0xFFFFFFFF) != trailer


def decode(data: bytes) -> Optional[Message]:
    """Parse one datagram; returns None for garbage / version mismatch
    (untrusted network input — never raise)."""
    try:
        if len(data) < _HDR.size:
            return None
        magic, version, mtype = _HDR.unpack_from(data)
        if magic != MAGIC or version != VERSION:
            return None
        body = data[_HDR.size :]
        if mtype in DATA_PLANE_TYPES:
            # v5: verify the crc32 trailer over header+body before ANY
            # field parse. Truncation, bit flips and trailing garbage all
            # land here and read as loss, which rollback already absorbs.
            if len(data) < _HDR.size + _CRC.size:
                return None
            (trailer,) = _CRC.unpack_from(data, len(data) - _CRC.size)
            if (zlib.crc32(data[: -_CRC.size]) & 0xFFFFFFFF) != trailer:
                return None
            body = data[_HDR.size : -_CRC.size]
        if mtype == T_SYNC_REQUEST:
            nonce, digest = _SYNC.unpack_from(body)
            return SyncRequest(nonce, digest)
        if mtype == T_SYNC_REPLY:
            nonce, digest = _SYNC.unpack_from(body)
            return SyncReply(nonce, digest)
        if mtype == T_INPUT:
            return InputMsg.decode(body)
        if mtype == T_INPUT_ACK:
            h, f = _BI.unpack_from(body)
            return InputAck(h, f)
        if mtype == T_QUALITY_REPORT:
            t, adv = _IH.unpack_from(body)
            return QualityReport(t, adv)
        if mtype == T_QUALITY_REPLY:
            return QualityReply(_U32.unpack_from(body)[0])
        if mtype == T_KEEP_ALIVE:
            return KeepAlive()
        if mtype == T_CHECKSUM_REPORT:
            f, cs = _I32U64.unpack_from(body)
            return ChecksumReport(f, cs)
        if mtype == T_STATE_REQUEST:
            nonce, kind, resend = _STATE_REQ.unpack_from(body)
            return StateRequest(nonce, kind, resend)
        if mtype == T_STATE_CHUNK:
            nonce, kind, frame, cs, seq, total, crc = _STATE_CHUNK.unpack_from(
                body
            )
            return StateChunk(
                nonce, kind, frame, cs, seq, total, crc, body[_STATE_CHUNK.size :]
            )
        if mtype == T_RELAY_HELLO:
            sid, pid = _RELAY_HELLO.unpack_from(body)
            return RelayHello(sid, pid)
        if mtype == T_RELAY_WELCOME:
            sid, pid, epoch = _RELAY_WELCOME.unpack_from(body)
            return RelayWelcome(sid, pid, epoch)
        if mtype == T_RELAY_FORWARD:
            src, dst = _RELAY_FWD.unpack_from(body)
            return RelayForward(src, dst, body[_RELAY_FWD.size :])
        if mtype == T_SUBSCRIBE:
            sid, cursor, window = _SUBSCRIBE.unpack_from(body)
            return Subscribe(sid, cursor, window)
        if mtype == T_STREAM_DELTA:
            frame, base, crc = _STREAM_DELTA.unpack_from(body)
            return StreamDelta(frame, base, crc, body[_STREAM_DELTA.size :])
        if mtype == T_STREAM_KEYFRAME:
            frame, seq, total, crc, digest = _STREAM_KF.unpack_from(body)
            return StreamKeyframe(
                frame, seq, total, crc, digest, body[_STREAM_KF.size :]
            )
        if mtype == T_STREAM_ACK:
            return StreamAck(_I32.unpack_from(body)[0])
        if mtype == T_MIGRATE_OFFER:
            nonce, mid, frame, total, digest, epoch = _MIG_OFFER.unpack_from(
                body
            )
            return MigrateOffer(nonce, mid, frame, total, digest, epoch)
        if mtype == T_MIGRATE_ACCEPT:
            nonce, accept, epoch, reason = _MIG_ACCEPT.unpack_from(body)
            return MigrateAccept(nonce, accept, epoch, reason)
        if mtype == T_MIGRATE_CHUNK:
            nonce, frame, seq, total, crc, epoch = _MIG_CHUNK.unpack_from(body)
            return MigrateChunk(
                nonce, frame, seq, total, crc, body[_MIG_CHUNK.size :], epoch
            )
        if mtype == T_MIGRATE_DONE:
            nonce, frame, ok, epoch = _MIG_DONE.unpack_from(body)
            return MigrateDone(nonce, frame, ok, epoch)
        if mtype == T_FLEET_HEARTBEAT:
            (
                sid, frames, active, free, quar, pages, hit_pm, waste_pm,
                beat_seq,
            ) = _FLEET_HB.unpack_from(body)
            return FleetHeartbeat(
                sid, frames, active, free, quar, pages, hit_pm, waste_pm,
                beat_seq,
            )
        if mtype == T_CTRL_FRAME:
            seq, crc = _CTRL_FRAME.unpack_from(body)
            return CtrlFrame(seq, crc, body[_CTRL_FRAME.size :])
        if mtype == T_CTRL_ACK:
            return CtrlAck(_CTRL_ACK.unpack_from(body)[0])
        return None
    except struct.error:
        return None


def pack_input_span(
    frames_bits: List[Tuple[int, np.ndarray]],
) -> Tuple[int, int, bytes]:
    """Pack a contiguous ascending span of (frame, bits) into
    (start_frame, num, payload)."""
    if not frames_bits:
        return 0, 0, b""
    start = frames_bits[0][0]
    payload = b"".join(np.ascontiguousarray(b).tobytes() for _, b in frames_bits)
    return start, len(frames_bits), payload


def unpack_input_span(
    msg: InputMsg, dtype: np.dtype, shape: Tuple[int, ...]
) -> List[Tuple[int, np.ndarray]]:
    """Inverse of :func:`pack_input_span` for a known input spec."""
    if msg.num == 0:
        return []
    itemsize = int(np.dtype(dtype).itemsize * int(np.prod(shape, dtype=int) or 1))
    out = []
    for i in range(msg.num):
        chunk = msg.payload[i * itemsize : (i + 1) * itemsize]
        if len(chunk) < itemsize:
            break
        arr = np.frombuffer(chunk, dtype=dtype).reshape(shape)
        out.append((msg.start_frame + i, arr))
    return out
