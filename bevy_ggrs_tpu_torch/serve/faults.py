"""Serve-tier fault domains: per-slot blast-radius containment.

Counterpart of ``bevy_ggrs_tpu/serve/faults.py``. The batched core makes
S matches share one tick — and one fault domain: a single slot whose
session stalls, raises, or needs a supervisor state transfer could poison
the dispatch serving the other S−1. This module is the containment layer:
at fleet scale preemption and peer failure are the steady state, so the
design target is isolation + fast recovery, not absence of faults.

The port's rings are written in place, so a :class:`SlotTicket` always
holds copies of a slot's rows (``BatchedSessionCore.extract``), never
views a later tick could rewrite. Checkpoint and migration blobs are the
JAX package's bytes: each package unpacks the other's.

The pieces, in blast-radius order:

- :class:`SlotFault` — the typed escape hatch replacing the batched core's
  blanket rejections. Raised BEFORE any sibling-slot state is mutated
  (``BatchedSessionCore`` pre-validates every segment of every slot ahead
  of the apply loop), so catching it and retrying the round without the
  faulted slot is always safe.
- :class:`SlotHealthFSM` — per-slot ``HEALTHY → DEGRADED → QUARANTINED →
  RECOVERING → (HEALTHY | EVICTED)`` with a legal-transition table, watchdog
  strike counting, and a traced edge per transition (mirroring the
  supervisor's ``_set_health`` idiom).
- :class:`SlotTicket` — the portable form of one match's device state
  (frame, world, full snapshot ring, as-used input-log tail, speculation
  flag). Extraction (``BatchedSessionCore.extract``) and readmission
  (``admit(ticket=...)``) both move the WHOLE ring, because synctest
  sessions issue ``LoadGameState(frame - check_distance)`` every frame —
  a readmitted slot with an empty ring would fault again immediately.
- :class:`RecoveryLane` — a singleton :class:`~bevy_ggrs_tpu_torch.runner.
  RollbackRunner` driving one drained match off the hot batch path,
  optionally under the existing :class:`~bevy_ggrs_tpu_torch.session.supervisor.
  SessionSupervisor` (desync ballots, type-9/10 state transfer, crash
  rejoin). All lanes of a server share ONE warmed
  :class:`~bevy_ggrs_tpu_torch.rollout.RolloutExecutor`, so draining and
  readmitting matches keeps the build counters
  (``utils.build_cache.compile_counters``) unchanged — the same churn
  contract the batched admit honors.
- :class:`ServerCheckpointer` — periodic per-slot checkpoints through the
  relay tier's :class:`~bevy_ggrs_tpu_torch.relay.delta.StateCodec` flat-byte
  layout (plus input-log tails), so a killed MatchServer process restarts
  and re-seeds every occupied slot: synctest matches resume bitwise from
  the checkpoint, P2P matches rejoin through the supervisor's
  crash-restart path (docs/serving.md "Failure domains").
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import re
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from bevy_ggrs_tpu_torch.session.common import PredictionThreshold, SessionState
from bevy_ggrs_tpu_torch.session.supervisor import Health

__all__ = [
    "SlotHealth",
    "SlotFault",
    "SlotHealthFSM",
    "SlotTicket",
    "RecoveryLane",
    "ServerCheckpointer",
    "pack_match_record",
    "unpack_match_record",
    "load_checkpoint_matches",
]


class SlotHealth(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"  # watchdog strikes accumulating; still batched
    QUARANTINED = "quarantined"  # fenced off the batch; lane being built
    RECOVERING = "recovering"  # advancing on a singleton recovery lane
    EVICTED = "evicted"  # recovery deadline blown; match removed


# Legal edges. HEALTHY -> QUARANTINED is direct (a raise needs no strike
# warm-up); HEALTHY -> RECOVERING covers crash-restart adoption, where a
# restarted server readmits a P2P match straight into a rejoin lane.
_LEGAL: Dict[SlotHealth, frozenset] = {
    SlotHealth.HEALTHY: frozenset(
        {SlotHealth.DEGRADED, SlotHealth.QUARANTINED, SlotHealth.RECOVERING}
    ),
    SlotHealth.DEGRADED: frozenset(
        {SlotHealth.HEALTHY, SlotHealth.QUARANTINED}
    ),
    SlotHealth.QUARANTINED: frozenset(
        {SlotHealth.RECOVERING, SlotHealth.EVICTED}
    ),
    SlotHealth.RECOVERING: frozenset(
        {SlotHealth.HEALTHY, SlotHealth.EVICTED}
    ),
    SlotHealth.EVICTED: frozenset(),
}


class SlotFault(RuntimeError):
    """One slot's tick cannot proceed. Carries enough to fence exactly that
    slot: which slot, why, and at what frame. The batched core guarantees
    that when this escapes, NO slot's host or device state was mutated by
    the aborted round — the server drops the faulted slot from the work
    dict and re-ticks the rest, handing the dropped ``(requests, session)``
    to the recovery lane so the session's frame counter and the runner
    never disagree (the ggrs save-frame invariant)."""

    def __init__(
        self,
        slot: int,
        reason: str,
        frame: int,
        cause: Optional[BaseException] = None,
    ):
        super().__init__(
            f"slot {slot} faulted at frame {frame}: {reason}"
            + (f" ({cause!r})" if cause is not None else "")
        )
        self.slot = int(slot)
        self.reason = str(reason)
        self.frame = int(frame)
        self.cause = cause


class SlotHealthFSM:
    """Health state for one served match, with validated transitions.

    Watchdog integration: :meth:`strike` records one over-budget host tick
    (``HEALTHY -> DEGRADED`` on the first, ``-> QUARANTINED`` — returning
    True — at ``strike_limit``); :meth:`clear` forgives the streak once a
    tick lands back inside its budget. Every edge emits a tracer instant
    and a labeled metric so the flight recorder can reconstruct the full
    quarantine timeline per ``match_slot``.
    """

    def __init__(
        self,
        slot: int,
        metrics=None,
        tracer=None,
        strike_limit: int = 3,
        initial: SlotHealth = SlotHealth.HEALTHY,
    ):
        from bevy_ggrs_tpu_torch.obs.trace import null_tracer
        from bevy_ggrs_tpu_torch.utils.metrics import null_metrics

        self.slot = int(slot)
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        self.strike_limit = int(strike_limit)
        self.state = initial
        self.strikes = 0
        self.last_reason: Optional[str] = None
        self.last_fault_frame: Optional[int] = None

    def to(self, state: SlotHealth, reason: str = "", frame: int = -1) -> None:
        if state is self.state:
            return
        if state not in _LEGAL[self.state]:
            raise ValueError(
                f"illegal slot-health transition {self.state.value} -> "
                f"{state.value} (slot {self.slot})"
            )
        self.tracer.instant(
            "slot_health",
            slot=self.slot,
            prev=self.state.value,
            to=state.value,
            reason=reason,
        )
        self.metrics.count(
            "slot_health_transitions",
            labels={"match_slot": self.slot, "to": state.value},
        )
        self.state = state
        if state is SlotHealth.QUARANTINED:
            self.last_reason = reason or self.last_reason
            self.last_fault_frame = frame if frame >= 0 else None
            self.strikes = 0

    def strike(self, frame: int, reason: str = "watchdog_timeout") -> bool:
        """Record one watchdog deadline miss; True when the streak crosses
        ``strike_limit`` (the caller must then quarantine the slot)."""
        self.strikes += 1
        self.metrics.count(
            "watchdog_strikes", labels={"match_slot": self.slot}
        )
        if self.state is SlotHealth.HEALTHY:
            self.to(SlotHealth.DEGRADED, reason=reason, frame=frame)
        return self.strikes >= self.strike_limit

    def clear(self) -> None:
        self.strikes = 0
        if self.state is SlotHealth.DEGRADED:
            self.to(SlotHealth.HEALTHY)

    def slo_signal(self, level: str, frame: int = -1) -> None:
        """Consume one SLO alert level (obs/slo.py) as a health input.

        A ``"page"`` burn drives a HEALTHY slot to DEGRADED even though
        no single tick tripped the watchdog — a slot missing 2% of
        deadlines forever never strikes, but it IS spending error budget
        the fleet balancer must see. An ``"ok"`` budget clears a
        DEGRADED slot only when no watchdog strikes are live (strikes
        own the DEGRADED state they created; the SLO must not mask an
        in-progress streak). WARN is observability-only.
        """
        if level == "page" and self.state is SlotHealth.HEALTHY:
            self.to(SlotHealth.DEGRADED, reason="slo_burn", frame=frame)
        elif (
            level == "ok"
            and self.state is SlotHealth.DEGRADED
            and self.strikes == 0
        ):
            self.to(SlotHealth.HEALTHY, reason="slo_recovered", frame=frame)


@dataclasses.dataclass
class SlotTicket:
    """One match's portable state: everything a slot row or a singleton
    runner needs to continue the trajectory bitwise. ``state``/``ring`` are
    device trees of their own (copies of the slot's rows: the port's rings
    are written in place, so a view would change under later ticks);
    ``input_log`` is the as-used
    host log tail the speculation builders seed from."""

    frame: int
    state: Any  # WorldState, device
    ring: Any  # SnapshotRing, device, depth = max_prediction + 1
    input_log: Dict[int, np.ndarray]
    spec_on: bool = True


def adopt_ticket(runner, ticket: SlotTicket) -> None:
    """Seed a singleton runner from a ticket by DIRECT assignment — not
    ``restore_state``, which re-seeds the ring empty: a synctest session
    issues ``LoadGameState(frame - check_distance)`` on its very next
    advance, so the pre-fault ring entries must survive the move."""
    runner.state = ticket.state
    runner.ring = ticket.ring
    runner.frame = int(ticket.frame)
    runner._input_log = dict(ticket.input_log)


class _SlotRunnerFacade:
    """The runner-shaped view a :class:`SessionSupervisor` holds while its
    match lives in a batch slot. Donor-side serving (``_build_payload``
    reads ``state``/``ring``/``frame``/``max_prediction``; ``dumps_runner``
    additionally reads the rollback counters) works against the live slot
    rows; the mutating entry points raise :class:`SlotFault` — recovery
    must never write through the facade, it must drain the slot to a lane
    first (the server does this the moment ``should_advance()`` goes
    False)."""

    def __init__(self, core, slot: int):
        self._core = core
        self._slot = int(slot)

    @property
    def state(self):
        return self._core.slot_state(self._slot)

    @property
    def ring(self):
        return self._core.slot_ring(self._slot)

    @property
    def frame(self) -> int:
        return self._core.slots[self._slot].frame

    @property
    def max_prediction(self) -> int:
        return self._core.max_prediction

    # dumps_runner metadata: per-slot rollback counts are aggregated on the
    # core; a rejoiner only needs plausible counters, not exact ones.
    rollbacks_total = 0
    rollback_frames_total = 0

    def restore_state(self, frame, state) -> None:
        raise SlotFault(self._slot, "restore_request", self.frame)

    def handle_requests(self, requests, session=None) -> None:
        raise SlotFault(self._slot, "unsupported_request", self.frame)


class RecoveryLane:
    """A drained match advancing on a singleton runner until readmission.

    Drive contract mirrors the supervisor drive loop
    (tests/test_supervisor.py): each :meth:`step` polls, ticks the
    supervisor (when present), and — if the session is RUNNING and the
    supervisor allows — advances with up to ``1 + min(frames_behind, 4)``
    catch-up iterations, treating :class:`PredictionThreshold` as
    backpressure. The first step applies the ``pending`` request list the
    faulting tick dropped, so the session and runner frame counters
    re-converge before any new frame is produced.

    ``ready`` gates readmission on: no pending requests, a clean streak of
    ``clean_target`` fault-free steps, supervisor HEALTHY with no active
    rejoin-freeze window, and zero frames behind the remote frontier — the
    conditions under which the batched core's canonical-burst contract
    holds again.
    """

    def __init__(
        self,
        handle,
        session,
        runner,
        supervisor=None,
        local_inputs: Optional[Callable[[int, int], object]] = None,
        pending: Optional[Tuple[List[object], object]] = None,
        fault_frame: Optional[int] = 0,
        clean_target: int = 2,
        catchup_cap: int = 4,
    ):
        self.handle = handle
        self.session = session
        self.runner = runner
        self.supervisor = supervisor
        self.local_inputs = local_inputs
        self.pending = pending
        # None = crash-restart rejoin (no in-process fault frame to
        # measure recovery depth against).
        self.fault_frame = None if fault_frame is None else int(fault_frame)
        self.clean_target = int(clean_target)
        self.catchup_cap = int(catchup_cap)
        self.frames_stepped = 0
        self.errors = 0
        self.last_error: Optional[BaseException] = None
        self._clean = 0

    @property
    def advancing(self) -> bool:
        return self._clean > 0

    @property
    def ready(self) -> bool:
        if self.pending is not None or self._clean < self.clean_target:
            return False
        sup = self.supervisor
        if sup is not None:
            if sup.health is not Health.HEALTHY:
                return False
            if sup._freeze_until is not None:
                # Post-rejoin frozen-input window: the lane keeps routing
                # local inputs through sup.input_for until it expires; the
                # batched fast path does too, but holding the match here
                # until the window closes keeps readmission unconditional.
                return False
            if sup.frames_behind() > 0:
                return False
        return True

    def step(self, now: Optional[float] = None) -> None:
        """One recovery-lane drive iteration; never raises (errors are
        counted for the server's eviction policy)."""
        self.frames_stepped += 1
        try:
            self._step(now)
        except PredictionThreshold:
            self._clean = 0  # backpressure, not a fault — but not clean
        except Exception as e:  # the lane IS the containment boundary
            self._clean = 0
            self.errors += 1
            self.last_error = e

    def _step(self, now: Optional[float]) -> None:
        if self.pending is not None:
            requests, psession = self.pending
            self.pending = None
            # The singleton runner handles arbitrary request shapes —
            # RestoreGameState, non-canonical bursts — which is exactly
            # why the faulted list is replayed here and not in the batch.
            self.runner.handle_requests(requests, psession)
        session = self.session
        poll = getattr(session, "poll_remote_clients", None)
        if poll is not None:
            poll()
        sup = self.supervisor
        behind = 0
        if sup is not None:
            sup.tick(now)
            if (
                session.current_state() != SessionState.RUNNING
                or not sup.should_advance()
            ):
                self._clean = 0
                return
            behind = sup.frames_behind()
        for _ in range(1 + min(behind, self.catchup_cap)):
            frame = getattr(session, "current_frame", self.runner.frame)
            if self.local_inputs is not None:
                for h in session.local_player_handles():
                    bits = self.local_inputs(frame, h)
                    if sup is not None:
                        bits = sup.input_for(h, bits)
                    session.add_local_input(h, bits)
            requests = session.advance_frame()
            self.runner.handle_requests(requests, session)
        self._clean += 1

    def ticket(self, spec_on: bool = True) -> SlotTicket:
        r = self.runner
        return SlotTicket(
            frame=int(r.frame),
            state=r.state,
            ring=r.ring,
            input_log=dict(r._input_log or {}),
            spec_on=bool(spec_on),
        )


# ---------------------------------------------------------------------------
# Server crash-restart checkpoints
# ---------------------------------------------------------------------------

_HEADER_KEY = "__ggrs_server_header__"
_CKPT_VERSION = 1


def _encode_match(codec, j: int, snap: Dict) -> Tuple[Dict, Dict]:
    """One snapshot_matches() record -> (npz arrays keyed ``m{j}_*``,
    header entry). The single shared serializer behind whole-server
    checkpoints AND per-match migration blobs — one format, one digest
    discipline."""
    from bevy_ggrs_tpu_torch.relay.delta import payload_digest
    from bevy_ggrs_tpu_torch.state import to_host, to_numpy

    arrays: Dict[str, np.ndarray] = {}
    state_bytes = codec.encode(to_host(snap["state"]))
    ring = snap["ring"]
    depth = int(ring.frames.shape[0])
    ring_rows = np.stack(
        [
            np.frombuffer(
                codec.encode(to_host(_ring_row(ring.states, d))),
                dtype=np.uint8,
            )
            for d in range(depth)
        ]
    )
    log = snap["input_log"]
    # Tail only: frames the speculation builders / forced-rollback
    # window can still reach (the rest is GC fodder anyway).
    tail_from = snap["frame"] - depth - 8
    frames = sorted(f for f in log if f >= tail_from)
    log_frames = np.asarray(frames, dtype=np.int64)
    log_bits = (
        np.stack([np.asarray(log[f]) for f in frames])
        if frames
        else np.zeros((0,), dtype=np.uint8)
    )
    arrays[f"m{j}_state"] = np.frombuffer(state_bytes, dtype=np.uint8)
    arrays[f"m{j}_ring"] = ring_rows
    arrays[f"m{j}_ring_frames"] = to_numpy(ring.frames).astype(np.int32)
    # The port carries the lanes as int64 values in [0, 2**32): on disk
    # they are JAX's uint32.
    arrays[f"m{j}_ring_cs"] = to_numpy(ring.checksums).astype(np.uint32)
    arrays[f"m{j}_log_frames"] = log_frames
    arrays[f"m{j}_log_bits"] = log_bits
    handle = snap["handle"]
    entry = {
        "j": j,
        "group": 0 if handle is None else handle.group,
        "slot": 0 if handle is None else handle.slot,
        "frame": int(snap["frame"]),
        "spec_on": bool(snap["spec_on"]),
        "kind": snap["kind"],
        "digest": payload_digest(state_bytes),
        "session_state": snap["session_state"],
    }
    return arrays, entry


def _decode_ticket(codec, npz, entry: Dict, template) -> SlotTicket:
    """Rebuild one match's :class:`SlotTicket` from its checkpoint arrays,
    on ``template``'s device and in its dtypes (``template`` is a world
    of the server's structure). The caller has already digest-verified
    the state payload. The inverse of :func:`_encode_match`, bitwise."""
    import torch

    from bevy_ggrs_tpu_torch.state import SnapshotRing, WorldState, from_numpy, tree_map

    device = template.device

    def world(host: Dict) -> WorldState:
        return tree_map(lambda t, a: from_numpy(a, t.dtype, device), template,
                        WorldState(**host))

    j = entry["j"]
    state = world(codec.decode(npz[f"m{j}_state"].tobytes()))
    ring_rows = npz[f"m{j}_ring"]
    depth = ring_rows.shape[0]
    row_states = [
        world(codec.decode(ring_rows[d].tobytes())) for d in range(depth)
    ]
    ring = SnapshotRing(
        states=tree_map(lambda *xs: torch.stack(xs), *row_states),
        frames=torch.as_tensor(
            npz[f"m{j}_ring_frames"].astype(np.int32), device=device),
        checksums=torch.as_tensor(
            npz[f"m{j}_ring_cs"].astype(np.int64), device=device),
    )
    log_frames = npz[f"m{j}_log_frames"]
    log_bits = npz[f"m{j}_log_bits"]
    input_log = {
        int(f): np.asarray(log_bits[k]) for k, f in enumerate(log_frames)
    }
    return SlotTicket(
        frame=int(entry["frame"]),
        state=state,
        ring=ring,
        input_log=input_log,
        spec_on=bool(entry["spec_on"]),
    )


def _verify_header(header: Dict, codec, origin: str) -> None:
    if header.get("version") != _CKPT_VERSION:
        raise ValueError(
            f"{origin}: version {header.get('version')} != {_CKPT_VERSION}"
        )
    if header["codec_size"] != codec.size:
        raise ValueError(
            f"{origin}: state layout is {header['codec_size']} bytes, "
            f"server template needs {codec.size} — mismatched world "
            "registry/capacity"
        )


def pack_match_record(codec, snap: Dict) -> bytes:
    """One match as a self-contained ServerCheckpointer-format blob (the
    live-migration wire payload): a single-entry checkpoint archive whose
    header carries the per-match integrity digest. Portable across server
    instances — nothing in it references the source's slot index, stagger
    group, or executor beyond the provenance fields in the header."""
    import io

    arrays, entry = _encode_match(codec, 0, snap)
    header = json.dumps(
        {
            "version": _CKPT_VERSION,
            "codec_size": int(codec.size),
            "matches": [entry],
        }
    )
    arrays[_HEADER_KEY] = np.frombuffer(header.encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _corruption_as_value_error(origin: str):
    """Context manager normalizing every way a bit-flipped blob's header
    can fail to parse (mangled JSON header, missing key; the zip and npy
    readers' failures are already ``ValueError`` through
    ``utils.persistence._members``, whatever type they raised) into the
    one typed ``ValueError`` the
    callers' corruption contract promises — a flipped bit must surface as
    "corrupt checkpoint", never as an incidental decoder exception that an
    outer handler misclassifies as a bug."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        import zipfile
        import zlib as _zlib

        try:
            yield
        except ValueError:
            raise  # already the typed contract (digest/template mismatch)
        except (
            zipfile.BadZipFile,
            _zlib.error,
            OSError,
            EOFError,
            KeyError,
            json.JSONDecodeError,
            UnicodeDecodeError,
        ) as e:
            raise ValueError(f"corrupt {origin}: {e!r}") from e

    return cm()


def unpack_match_record(codec, blob: bytes, template) -> Dict:
    """Inverse of :func:`pack_match_record`: verify version, codec layout
    and payload digest, then rebuild the ticket on ``template``'s device
    and dtypes (a world of the server's structure; the JAX package reads
    them from its arrays). Raises ``ValueError`` on any mismatch — a
    corrupt migration blob must abort the move, never readmit a plausible
    impostor."""
    import io

    from bevy_ggrs_tpu_torch.relay.delta import payload_digest

    from bevy_ggrs_tpu_torch.utils.persistence import _members

    npz = _members(blob, "migration blob")
    with _corruption_as_value_error("migration blob"):
        header = json.loads(bytes(npz[_HEADER_KEY]).decode())
        _verify_header(header, codec, "migration blob")
        (entry,) = header["matches"]
        state_bytes = npz[f"m{entry['j']}_state"].tobytes()
        if payload_digest(state_bytes) != entry["digest"]:
            raise ValueError(
                "migration blob: state fails its integrity digest"
            )
        return {
            "kind": entry["kind"],
            "frame": int(entry["frame"]),
            "spec_on": bool(entry["spec_on"]),
            "session_state": entry["session_state"],
            "source": (int(entry["group"]), int(entry["slot"])),
            "ticket": _decode_ticket(codec, npz, entry, template),
        }


def load_checkpoint_matches(path: str, codec, template) -> List[Dict]:
    """Read a whole-server checkpoint into per-match records — every entry
    digest-verified; ``ticket`` decoded for synctest matches (P2P sessions
    were never serialized, so their recovery is the donor-rejoin path and
    needs no ticket), on ``template``'s device. The shared loader behind
    :meth:`ServerCheckpointer.restore` and fleet server-loss failover,
    which re-seeds a dead server's matches onto SURVIVING servers at
    whatever slots they have free."""
    from bevy_ggrs_tpu_torch.relay.delta import payload_digest

    from bevy_ggrs_tpu_torch.utils.persistence import _members

    out: List[Dict] = []
    with _corruption_as_value_error(f"server checkpoint {path!r}"):
        with open(path, "rb") as f:
            data = f.read()
    npz = _members(data, f"server checkpoint {path!r}")
    with _corruption_as_value_error(f"server checkpoint {path!r}"):
        header = json.loads(bytes(npz[_HEADER_KEY]).decode())
        _verify_header(header, codec, f"server checkpoint {path!r}")
        for entry in header["matches"]:
            key = (int(entry["group"]), int(entry["slot"]))
            state_bytes = npz[f"m{entry['j']}_state"].tobytes()
            if payload_digest(state_bytes) != entry["digest"]:
                raise ValueError(
                    f"server checkpoint {path!r}: slot {key} state "
                    "fails its integrity digest"
                )
            out.append(
                {
                    "key": key,
                    "kind": entry["kind"],
                    "frame": int(entry["frame"]),
                    "spec_on": bool(entry["spec_on"]),
                    "session_state": entry["session_state"],
                    "ticket": (
                        _decode_ticket(codec, npz, entry, template)
                        if entry["kind"] == "synctest"
                        else None
                    ),
                }
            )
    return out


class ServerCheckpointer:
    """Rolling on-disk checkpoints of a whole MatchServer.

    One ``.npz`` per save, written atomically, holding for every live match
    (batched slots AND recovery lanes): the world state and each snapshot
    ring row as :class:`~bevy_ggrs_tpu_torch.relay.delta.StateCodec` flat bytes
    (the relay tier's deterministic layout — byte-identical encode/decode,
    guarded by a :func:`~bevy_ggrs_tpu_torch.relay.delta.payload_digest` per
    slot), the ring frame/checksum arrays, the as-used input-log tail, and
    (synctest) the session's ``state_dict``.

    Restore contract (:meth:`restore`): the caller rebuilds a MatchServer
    with identical construction parameters plus one attachment per saved
    match — ``{(group, slot): {"session": ..., "local_inputs": ...,
    "donor": ...}}``. Synctest matches are re-seeded bitwise at their exact
    (group, slot) via the admit path; P2P matches (no
    serializable session) re-enter as RECOVERING lanes that adopt a full
    checkpoint from ``donor`` through the supervisor's crash-restart
    rejoin, then readmit. Cadence tradeoff: a shorter ``interval`` bounds
    synctest recovery staleness (a restart replays nothing — it resumes AT
    the checkpoint, so staleness = frames since the last save) at the cost
    of one full host sync of every slot per save (docs/serving.md).
    """

    _NAME = re.compile(r"^server_ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, interval: int = 120, keep: int = 3):
        if interval <= 0 or keep <= 0:
            raise ValueError("interval and keep must be positive")
        self.directory = directory
        self.interval = int(interval)
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)
        self.saves_total = 0
        self.last_save_path: Optional[str] = None
        # Corrupt-checkpoint skips during restore (newest-first fallback).
        self.load_fallbacks = 0

    # -- saving ----------------------------------------------------------

    def _checkpoints(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if m:
                out.append(
                    (int(m.group(1)), os.path.join(self.directory, name))
                )
        return sorted(out)

    def latest(self) -> Optional[str]:
        ckpts = self._checkpoints()
        return ckpts[-1][1] if ckpts else None

    def maybe_save(self, server) -> Optional[str]:
        """Checkpoint iff ``frames_served`` is an ``interval`` boundary."""
        n = server.frames_served
        if n == 0 or n % self.interval:
            return None
        return self.save(server)

    def save(self, server) -> str:
        codec = server.state_codec()
        arrays: Dict[str, np.ndarray] = {}
        matches: List[Dict] = []
        for j, snap in enumerate(server.snapshot_matches()):
            a, entry = _encode_match(codec, j, snap)
            arrays.update(a)
            matches.append(entry)
        header = json.dumps(
            {
                "version": _CKPT_VERSION,
                "frames_served": int(server.frames_served),
                "codec_size": int(codec.size),
                "matches": matches,
            }
        )
        arrays[_HEADER_KEY] = np.frombuffer(header.encode(), dtype=np.uint8)
        import io

        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        path = os.path.join(
            self.directory, f"server_ckpt_{server.frames_served}.npz"
        )
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(buf.getvalue())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        for _, stale in self._checkpoints()[: -self.keep]:
            os.unlink(stale)
        self.saves_total += 1
        self.last_save_path = path
        return path

    # -- restoring -------------------------------------------------------

    def restore(
        self,
        server,
        attachments: Dict[Tuple[int, int], Dict],
        path: Optional[str] = None,
    ) -> List:
        """Re-seed a freshly built server from the newest (or named)
        checkpoint. Returns the re-established MatchHandles. Raises
        ``ValueError`` on digest/template mismatch — a corrupted checkpoint
        must never silently produce a plausible fleet.

        Corruption fallback (the bottom rung of docs/serving.md's
        self-healing ladder): when no explicit ``path`` is named and the
        newest checkpoint fails its integrity checks, older retained
        checkpoints are tried newest-first — the rolling ``keep`` window
        exists precisely so one corrupt file costs ``interval`` frames of
        staleness, not the fleet. Every skip is counted in
        ``load_fallbacks``. An explicitly named ``path`` never falls back
        (the caller asked for THAT file)."""
        codec = server.state_codec()
        template = server._template
        if path is not None:
            records = load_checkpoint_matches(path, codec, template)
        else:
            candidates = [p for _, p in reversed(self._checkpoints())]
            if not candidates:
                raise ValueError(
                    f"no server checkpoint in {self.directory!r}"
                )
            records = None
            errors: List[str] = []
            for cand in candidates:
                try:
                    records = load_checkpoint_matches(cand, codec, template)
                    path = cand
                    break
                except ValueError as e:
                    self.load_fallbacks += 1
                    errors.append(f"{cand!r}: {e}")
            if records is None:
                raise ValueError(
                    "every retained server checkpoint failed integrity "
                    "verification: " + "; ".join(errors)
                )
        handles = []
        for rec in records:
            key = rec["key"]
            att = attachments.get(key)
            if att is None:
                raise ValueError(
                    f"server checkpoint {path!r}: no attachment for "
                    f"match at group={key[0]} slot={key[1]}"
                )
            if rec["kind"] != "synctest":
                # P2P: the session is live network state we never
                # serialized — rejoin from a surviving donor instead.
                handles.append(
                    server.adopt_rejoin(
                        key,
                        att["session"],
                        att.get("local_inputs"),
                        att["donor"],
                    )
                )
                continue
            session = att["session"]
            if rec["session_state"] is not None:
                session.load_state_dict(rec["session_state"])
            handles.append(
                server.resume_match(
                    session,
                    att.get("local_inputs"),
                    rec["ticket"],
                    handle=key,
                )
            )
        return handles


def _ring_row(states, d: int):
    from bevy_ggrs_tpu_torch.state import tree_map

    return tree_map(lambda x: x[d], states)
