"""Supervised subprocess MatchServers over real UDP sockets.

Counterpart of ``bevy_ggrs_tpu/fleet/proc.py``: the same child protocol,
events and parent, with the children running the port's serving tier on
the card.

The balancer/autopilot tests so far run every MatchServer inside one
Python process on a loopback network — deterministic, but it can't
prove the fleet contracts against real process boundaries: separate
GILs, separate CUDA contexts, real datagrams, real crashes. This module
makes the fleet real:

- **Child** (``python -m bevy_ggrs_tpu_torch.fleet.proc '<json-config>'``):
  one warmed box_game MatchServer per process, on ``cuda`` unless the
  config's ``"device"`` names another (a child asked for ``cuda`` on a
  machine without a GPU raises before its ``ready`` event). Control
  plane is line-delimited JSON over stdin/stdout (reliable, ordered, and
  lifecycle-tied — a dead child is a closed pipe); data plane is a real
  ephemeral-port :class:`~bevy_ggrs_tpu_torch.transport.udp.UdpSocket`
  that carries type-22 heartbeats to the parent and the type 18–21
  migration wire between siblings. Matches are synctest sessions keyed
  by ``match_id`` alone — the per-frame input script is a pure function
  of ``(frame, handle, match_id)``, so a migration destination can
  rebuild the session from the MigrateOffer's ``match_id`` plus the
  blob's ``session_state`` and continue bitwise.
- **Parent** (:class:`ProcFleet`): spawn/drain/kill lifecycle
  supervision implementing the same fleet-adapter protocol the
  autopilot drives in-process (``samples / placements /
  pump_migrations / migrate / spawn / set_draining / retire``), plus
  heartbeat-timeout death detection and checkpoint failover — the
  parent re-packs the dead child's on-disk fleet checkpoint and ships
  it over the SAME migration wire from its own socket, so a surviving
  child cannot tell recovery from an ordinary migration.

Each child runs a provenance sidecar on its fleet socket and exports
its telemetry set on shutdown; :meth:`ProcFleet.merge_observability`
folds every child's Perfetto trace + provenance log into one
cross-process fleet timeline. Kernel and native libraries are built
once into the package's on-disk build directory (``ops/_build.py``,
``native/build.py``; atomic renames, so children may build at once),
so every child after the first finds them built. ``compiles`` in the
status events counts this child's builds and checksum-layout
preparations after warmup (``utils/build_cache.py``), the fleet-wide
churn gate; the ``bye`` event carries the kernels' launch counts since the
last ``rebase_compiles`` command (from process start without one).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

CHUNK_PAYLOAD = 1024

# Child defaults: the box_game serving shape every fleet test uses.
DEFAULT_CONFIG: Dict = {
    "server_id": 0,
    "parent": None,  # [host, port] for heartbeats; None = no beacon
    "capacity": 4,
    "stagger_groups": 2,
    "num_players": 2,
    "max_prediction": 8,
    "num_branches": 8,
    "spec_frames": 3,
    "check_distance": 2,
    "fps": 60.0,  # 0 = free-run
    "frame_ms": 1000.0 / 60.0,
    "heartbeat_interval": 8,
    "status_interval": 30,
    "checkpoint_dir": None,
    "checkpoint_interval": 60,
    "obs_dir": None,
    "spec_on": True,
    # Chaos on the child's real UDP socket: a ChaosPlan as JSON (see
    # chaos/plan.py) applied to every outgoing datagram — heartbeats and
    # migration frames alike. `chaos_t0` is the shared wall-clock origin
    # (time.time()) so directive windows line up across processes.
    "chaos_plan": None,
    "chaos_t0": None,
    # Wall-clock (NOT frames: a free-running child serves thousands of
    # frames per second, and a frame-counted deadline would abort-and-
    # resume an outgoing transfer the destination has already admitted —
    # duplicating the match). Must stay well under the parent's
    # failover_timeout so a child-side abort always precedes the
    # parent's bookkeeping expiry.
    "migrate_timeout_s": 30.0,
    # {"start": f0, "end": f1, "every": n, "ms": t} — sleep t ms once per
    # frame while start <= frames_served < end and frames_served % every
    # == 0. A 1-in-`every` deadline miss pages the SLO (miss rate >>
    # 1 - objective) without ever fencing the watchdog (strikes must be
    # consecutive), which is exactly the burn-preemption test shape.
    "hiccup": None,
    # The card the child serves on: None = cuda (raising without a GPU);
    # tests pass "cpu".
    "device": None,
}


def _inputs_for(match_id: int, child: "_Child") -> Callable:
    import numpy as np

    def f(frame, handle):
        hc = child.hiccup
        if hc and handle == 0:
            fs = child.server.frames_served
            if hc["start"] <= fs < hc["end"] and fs % hc["every"] == 0:
                time.sleep(hc["ms"] / 1000.0)
        return np.uint8((frame * 3 + handle * 5 + match_id) % 16)

    return f


def _make_session(cfg: dict):
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.session.builder import SessionBuilder

    return (
        SessionBuilder(box_game.INPUT_SPEC)
        .with_num_players(cfg["num_players"])
        .with_max_prediction_window(cfg["max_prediction"])
        .with_check_distance(cfg["check_distance"])
        .start_synctest_session()
    )


# ---------------------------------------------------------------------------
# Child process
# ---------------------------------------------------------------------------


class _Child:
    """One subprocess MatchServer: frame loop, stdin commands, stdout
    events, and both sides of the UDP migration wire."""

    def __init__(self, cfg: dict):
        from bevy_ggrs_tpu_torch.models import box_game
        from bevy_ggrs_tpu_torch.obs.ledger import SpeculationLedger
        from bevy_ggrs_tpu_torch.obs.provenance import ProvenanceLog, SidecarSocket
        from bevy_ggrs_tpu_torch.obs.trace import SpanTracer
        from bevy_ggrs_tpu_torch.serve.server import MatchServer
        from bevy_ggrs_tpu_torch.transport.reliable import ReliableSocket
        from bevy_ggrs_tpu_torch.transport.udp import UdpSocket
        from bevy_ggrs_tpu_torch.utils.metrics import Metrics
        from bevy_ggrs_tpu_torch.state import resolve_device
        from bevy_ggrs_tpu_torch.utils.build_cache import compile_counters

        self.cfg = cfg
        self.device = resolve_device(cfg.get("device"))
        self.sid = int(cfg["server_id"])
        self.draining = False
        self.running = True
        self.hiccup = cfg.get("hiccup")
        self.matches: Dict[int, dict] = {}  # mid -> {handle, session}
        self.outgoing: Dict[int, dict] = {}  # nonce -> src-side transfer
        self.incoming: Dict[int, dict] = {}  # nonce -> dst-side transfer
        # Highest migration epoch engaged per match — the child half of
        # the split-brain fence (the parent is the epoch authority).
        self.match_epochs: Dict[int, int] = {}
        self.fence_refusals = 0
        self._stdin_buf = b""
        os.set_blocking(sys.stdin.fileno(), False)

        # Ephemeral-port data plane; pure-python so local_port is cheap.
        self.sock = UdpSocket(0, "127.0.0.1", use_native=False)
        self.mig_port = self.sock.local_port()
        inner = self.sock
        self.chaos = None
        if cfg.get("chaos_plan"):
            from bevy_ggrs_tpu_torch.chaos.plan import ChaosPlan
            from bevy_ggrs_tpu_torch.chaos.socket import ChaosSocket

            plan = ChaosPlan.from_json(cfg["chaos_plan"])
            origin = float(cfg.get("chaos_t0") or time.time())
            # addr = server_id, not the ephemeral UDP tuple: Partition
            # directives can then name server ids that exist at
            # plan-generation time, and the per-socket fault RNG stream
            # is stable across runs. Bind the origin as a default arg —
            # a plain closure would see later rebindings of the local.
            self.chaos = ChaosSocket(
                inner, plan,
                clock=lambda _o=origin: time.time() - _o,
                addr=self.sid,
            )
            inner = self.chaos
        # Reliable sublayer ABOVE the chaos injector (acks and
        # retransmits must cross the faulty wire too); heartbeats pass
        # through unenveloped — the next beat is their retry.
        self.rel = ReliableSocket(inner, seed=self.sid)
        self.prov = None
        tracer = None
        ledger = None
        if cfg.get("obs_dir"):
            self.prov = ProvenanceLog(
                component=f"srv{self.sid}", pid=700 + self.sid
            )
            tracer = SpanTracer(
                pid=700 + self.sid, process_name=f"srv{self.sid}"
            )
            ledger = SpeculationLedger(
                component=f"srv{self.sid}-spec", pid=700 + self.sid
            )
        wire = SidecarSocket(self.rel, self.prov) if self.prov else self.rel
        self.wire = wire

        # Fleet-soak profiling leg (GGRS_HOST_PROFILE=1, inherited from
        # the parent's environment): a per-child sampling profiler over
        # this child's serving thread, exported with the other telemetry
        # artifacts at shutdown.
        self.profiler = None
        if os.environ.get("GGRS_HOST_PROFILE", "").lower() not in (
            "", "0", "false"
        ):
            from bevy_ggrs_tpu_torch.obs.profiler import HostProfiler

            self.profiler = HostProfiler(
                seed=self.sid, pid=700 + self.sid,
                process_name=f"srv{self.sid}",
            )

        parent = cfg.get("parent")
        t0 = time.perf_counter()
        self.server = MatchServer(
            box_game.make_schedule(),
            box_game.make_world(cfg["num_players"], device=self.device).commit(),
            cfg["max_prediction"],
            cfg["num_players"],
            box_game.INPUT_SPEC,
            capacity=cfg["capacity"],
            stagger_groups=cfg["stagger_groups"],
            num_branches=cfg["num_branches"],
            spec_frames=cfg["spec_frames"],
            frame_ms=cfg["frame_ms"],
            metrics=Metrics(),
            tracer=tracer,
            server_id=self.sid,
            fleet_socket=wire if parent else None,
            fleet_addr=tuple(parent) if parent else None,
            heartbeat_interval=cfg["heartbeat_interval"],
            checkpoint_dir=cfg.get("checkpoint_dir"),
            checkpoint_interval=cfg["checkpoint_interval"],
            trace_dir=cfg.get("obs_dir"),
            ledger=ledger,
            profiler=self.profiler,
            device=self.device,
        )
        self.server.warmup()
        if self.profiler is not None:
            self.profiler.start()
        self.warmup_s = time.perf_counter() - t0
        self.base_compiles = compile_counters()["backend_compiles"]
        self._emit(
            event="ready",
            server_id=self.sid,
            pid=os.getpid(),
            mig_port=self.mig_port,
            warmup_s=round(self.warmup_s, 3),
        )

    # -- plumbing --------------------------------------------------------

    def _emit(self, **ev) -> None:
        sys.stdout.write(json.dumps(ev) + "\n")
        sys.stdout.flush()

    def _read_cmds(self) -> List[dict]:
        try:
            data = os.read(sys.stdin.fileno(), 65536)
        except (BlockingIOError, InterruptedError):
            return []
        if data == b"":  # parent closed stdin: orphaned, shut down
            self.running = False
            return []
        self._stdin_buf += data
        out = []
        while b"\n" in self._stdin_buf:
            line, self._stdin_buf = self._stdin_buf.split(b"\n", 1)
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
        return out

    def _compiles(self) -> int:
        from bevy_ggrs_tpu_torch.utils.build_cache import compile_counters

        return compile_counters()["backend_compiles"] - self.base_compiles

    def _cost_columns(self) -> dict:
        """Cost-observatory columns for status/bye events, under the JAX
        package's names: the wall time this process has spent building
        kernels and preparing layouts (``xla_compile_ms``, the scale-up
        latency decomposition) and, on the card, the peak bytes the
        caching allocator has held (``hbm_peak_bytes``)."""
        import torch

        from bevy_ggrs_tpu_torch.utils.build_cache import (
            compile_summary,
            executable_costs,
        )

        out = {"xla_compile_ms": compile_summary()["total_ms"]}
        hbm = [
            rec["hbm_peak_bytes"]
            for rec in executable_costs().values()
            if rec.get("hbm_peak_bytes")
        ]
        if self.device.type == "cuda":
            hbm.append(torch.cuda.max_memory_allocated(self.device))
        if hbm:
            out["hbm_peak_bytes"] = int(max(hbm))
        return out

    # -- commands --------------------------------------------------------

    def _cmd_admit(self, cmd: dict) -> None:
        mid = int(cmd["match"])
        if self.draining or mid in self.matches:
            self._emit(
                event="admit_failed",
                match=mid,
                reason="draining" if self.draining else "duplicate",
            )
            return
        if not self.server.free_slot_handles():
            self._emit(event="admit_failed", match=mid, reason="full")
            return
        session = _make_session(self.cfg)
        inputs = _inputs_for(mid, self)
        handle = self.server.add_match(
            session, inputs, spec_on=self.cfg["spec_on"]
        )
        self.matches[mid] = {"handle": handle, "session": session,
                             "inputs": inputs}
        self._emit(
            event="admitted",
            match=mid,
            group=handle.group,
            slot=handle.slot,
            frame=int(session.current_frame),
        )

    def _cmd_retire_match(self, cmd: dict) -> None:
        mid = int(cmd["match"])
        m = self.matches.pop(mid, None)
        if m is None:
            self._emit(event="retire_failed", match=mid, reason="unknown")
            return
        self.server.suspend_match(m["handle"])  # drop the ticket: abandon
        self._emit(event="match_retired", match=mid)

    def _cmd_migrate(self, cmd: dict) -> None:
        from bevy_ggrs_tpu_torch.relay.delta import payload_digest
        from bevy_ggrs_tpu_torch.serve.faults import pack_match_record
        from bevy_ggrs_tpu_torch.session import protocol as proto

        mid = int(cmd["match"])
        nonce = int(cmd["nonce"])
        epoch = int(cmd.get("epoch", 0))
        dst = (str(cmd["dst"][0]), int(cmd["dst"][1]))
        m = self.matches.pop(mid, None)
        if m is None:
            self._emit(
                event="migrate_abort", match=mid, nonce=nonce,
                reason="unknown_match",
            )
            return
        if epoch:
            self.match_epochs[mid] = max(
                self.match_epochs.get(mid, 0), epoch
            )
        session_state = None
        sd = getattr(m["session"], "state_dict", None)
        if sd is not None:
            session_state = sd()
        ticket = self.server.suspend_match(m["handle"])
        blob = pack_match_record(
            self.server.state_codec(),
            {
                "handle": m["handle"],
                "kind": "synctest",
                "frame": ticket.frame,
                "state": ticket.state,
                "ring": ticket.ring,
                "input_log": ticket.input_log,
                "spec_on": ticket.spec_on,
                "session_state": session_state,
            },
        )
        digest = payload_digest(blob)
        chunks = [
            blob[i : i + CHUNK_PAYLOAD]
            for i in range(0, len(blob), CHUNK_PAYLOAD)
        ] or [b""]
        total = len(chunks)
        self.wire.send_to(
            proto.encode(
                proto.MigrateOffer(
                    nonce, mid, ticket.frame, total, digest, epoch
                )
            ),
            dst,
        )
        for seq, payload in enumerate(chunks):
            self.wire.send_to(
                proto.encode(
                    proto.MigrateChunk(
                        nonce, ticket.frame, seq, total,
                        zlib.crc32(payload) & 0xFFFFFFFF, payload, epoch,
                    )
                ),
                dst,
            )
        self.wire.send_to(
            proto.encode(proto.MigrateDone(nonce, ticket.frame, 1, epoch)),
            dst,
        )
        self.outgoing[nonce] = {
            "match": mid,
            "handle": m["handle"],
            "session": m["session"],
            "inputs": m["inputs"],
            "ticket": ticket,
            "epoch": epoch,
            "deadline": time.monotonic() + self.cfg["migrate_timeout_s"],
        }

    def _abort_outgoing(self, nonce: int, reason: str) -> None:
        out = self.outgoing.pop(nonce)
        try:
            handle = self.server.resume_match(
                out["session"], out["inputs"], out["ticket"],
                handle=out["handle"],
            )
        except RuntimeError:
            # The original slot was reused while the transfer was in
            # flight (a chaos-stretched timeout leaves a long window).
            # Slot identity is bookkeeping, not state — any free slot
            # preserves the match.
            try:
                handle = self.server.resume_match(
                    out["session"], out["inputs"], out["ticket"],
                )
            except RuntimeError:
                # Nowhere to land it: surface a typed loss instead of
                # crashing the child; the parent holds checkpoints.
                self._emit(
                    event="resume_failed", match=out["match"],
                    nonce=nonce, reason=reason,
                )
                return
        self.matches[out["match"]] = {
            "handle": handle, "session": out["session"],
            "inputs": out["inputs"],
        }
        self._emit(
            event="migrate_abort", match=out["match"], nonce=nonce,
            reason=reason, resumed=True,
            handle=[handle.group, handle.slot],
        )

    # -- migration wire (dst side + src acks) ----------------------------

    def _pump_wire(self) -> None:
        from bevy_ggrs_tpu_torch.session import protocol as proto

        for addr, data in self.wire.receive_all():
            msg = proto.decode(data)
            if msg is None:
                continue
            if isinstance(msg, proto.MigrateOffer):
                if msg.nonce in self.incoming:
                    # Duplicated offer for a transfer already underway
                    # (the reliable layer dedups envelopes, but a raw
                    # duplicate can still arrive): never reset chunk
                    # state, just re-affirm the accept.
                    self.wire.send_to(
                        proto.encode(
                            proto.MigrateAccept(msg.nonce, 1, msg.epoch, 0)
                        ),
                        addr,
                    )
                    continue
                refuse = None
                if msg.epoch and msg.epoch < self.match_epochs.get(
                    msg.match_id, 0
                ):
                    # Stale epoch: this offer belongs to a superseded
                    # migration attempt — admitting it would double-host
                    # the match.
                    refuse = proto.MIG_REFUSE_EPOCH
                    self.fence_refusals += 1
                    self._emit(
                        event="offer_refused", match=msg.match_id,
                        nonce=msg.nonce, reason="epoch_fence",
                        epoch=msg.epoch,
                        current=self.match_epochs.get(msg.match_id, 0),
                    )
                elif msg.match_id in self.matches:
                    refuse = proto.MIG_REFUSE_DUP
                    self._emit(
                        event="offer_refused", match=msg.match_id,
                        nonce=msg.nonce, reason="duplicate_match",
                        epoch=msg.epoch,
                    )
                elif self.draining or not self.server.free_slot_handles():
                    refuse = proto.MIG_REFUSE_CAPACITY
                accept = refuse is None
                self.wire.send_to(
                    proto.encode(
                        proto.MigrateAccept(
                            msg.nonce, int(accept), msg.epoch,
                            0 if accept else refuse,
                        )
                    ),
                    addr,
                )
                if accept:
                    if msg.epoch:
                        self.match_epochs[msg.match_id] = max(
                            self.match_epochs.get(msg.match_id, 0),
                            msg.epoch,
                        )
                    self.incoming[msg.nonce] = {
                        "offer": msg,
                        "src": addr,
                        "chunks": {},
                        "bad": None,
                        "begun_frames": self.server.frames_served,
                    }
            elif isinstance(msg, proto.MigrateChunk):
                inc = self.incoming.get(msg.nonce)
                if inc is None:
                    continue
                if msg.epoch != inc["offer"].epoch:
                    inc["bad"] = "epoch_mismatch"
                elif zlib.crc32(msg.payload) & 0xFFFFFFFF != msg.crc:
                    inc["bad"] = "chunk_crc"
                else:
                    inc["chunks"][msg.seq] = msg.payload
            elif isinstance(msg, proto.MigrateDone):
                if msg.nonce in self.incoming:
                    self._finish_incoming(msg.nonce)
                elif msg.nonce in self.outgoing:
                    # dst's verdict on our outbound transfer
                    if msg.ok:
                        out = self.outgoing.pop(msg.nonce)
                        self._emit(
                            event="migrated_out", match=out["match"],
                            nonce=msg.nonce, frame=msg.frame,
                        )
                    else:
                        self._abort_outgoing(msg.nonce, "dst_failed")
            elif isinstance(msg, proto.MigrateAccept):
                if msg.nonce in self.outgoing and not msg.accept:
                    if msg.reason == proto.MIG_REFUSE_EPOCH:
                        # The destination has seen a newer epoch for this
                        # match: OUR retained copy is the stale one, and
                        # resuming it would double-host. Drop it instead.
                        out = self.outgoing.pop(msg.nonce)
                        self.fence_refusals += 1
                        self._emit(
                            event="migrate_abort", match=out["match"],
                            nonce=msg.nonce, reason="epoch_fence",
                        )
                    else:
                        self._abort_outgoing(msg.nonce, "offer_refused")

    def _finish_incoming(self, nonce: int) -> None:
        from bevy_ggrs_tpu_torch.relay.delta import payload_digest
        from bevy_ggrs_tpu_torch.serve.faults import unpack_match_record
        from bevy_ggrs_tpu_torch.session import protocol as proto

        inc = self.incoming.pop(nonce)
        offer = inc["offer"]

        def fail(reason: str) -> None:
            self.wire.send_to(
                proto.encode(
                    proto.MigrateDone(nonce, offer.frame, 0, offer.epoch)
                ),
                inc["src"],
            )
            self._emit(
                event="migrate_in_failed", match=offer.match_id,
                nonce=nonce, reason=reason,
            )

        if inc["bad"]:
            fail(inc["bad"])
            return
        if len(inc["chunks"]) != offer.total:
            fail("missing_chunks")
            return
        blob = b"".join(inc["chunks"][i] for i in range(offer.total))
        if payload_digest(blob) != offer.digest:
            fail("blob_digest")
            return
        try:
            rec = unpack_match_record(
                self.server.state_codec(), blob, self.server._template
            )
        except ValueError:
            fail("record_digest")
            return
        mid = int(offer.match_id)
        session = _make_session(self.cfg)
        if rec["session_state"] is not None:
            session.load_state_dict(rec["session_state"])
        inputs = _inputs_for(mid, self)
        handle = self.server.resume_match(session, inputs, rec["ticket"])
        self.matches[mid] = {
            "handle": handle, "session": session, "inputs": inputs,
        }
        self.wire.send_to(
            proto.encode(
                proto.MigrateDone(nonce, rec["frame"], 1, offer.epoch)
            ),
            inc["src"],
        )
        self._emit(
            event="migrated_in", match=mid, nonce=nonce,
            group=handle.group, slot=handle.slot, frame=int(rec["frame"]),
            stall_frames=self.server.frames_served - inc["begun_frames"],
            epoch=offer.epoch,
        )

    # -- status / shutdown -----------------------------------------------

    def _status(self) -> None:
        hb = self.server.heartbeat()
        self._emit(
            event="status",
            frames=self.server.frames_served,
            matches={
                str(mid): int(m["session"].current_frame)
                for mid, m in self.matches.items()
            },
            slots_active=hb.slots_active,
            slots_free=hb.slots_free,
            quarantined=hb.quarantined,
            pages=hb.pages,
            faults=self.server.faults_total,
            evictions=self.server.evictions_total,
            compiles=self._compiles(),
            draining=self.draining,
            **self._cost_columns(),
            ctrl_retransmits=self.rel.retransmits,
            ctrl_crc_drops=self.rel.crc_drops,
            ctrl_dups_dropped=self.rel.duplicates_dropped,
            ctrl_gave_up=self.rel.gave_up,
            fence_refusals=self.fence_refusals,
            chaos_faults=len(self.chaos.faults) if self.chaos else 0,
        )

    def _shutdown(self) -> None:
        from bevy_ggrs_tpu_torch.ops import launch_counts

        if self.profiler is not None:
            self.profiler.stop()
        artifacts = {}
        cfg = self.cfg
        if cfg.get("obs_dir"):
            arts = self.server.export_telemetry(
                cfg["obs_dir"], prefix=f"proc_srv{self.sid}"
            )
            artifacts.update(arts or {})
            if self.prov is not None:
                p = os.path.join(
                    cfg["obs_dir"], f"proc_srv{self.sid}_prov.jsonl"
                )
                self.prov.export_jsonl(p)
                artifacts["provenance"] = p
        self._emit(
            event="bye",
            frames=self.server.frames_served,
            compiles=self._compiles(),
            **self._cost_columns(),
            faults=self.server.faults_total,
            ctrl_retransmits=self.rel.retransmits,
            ctrl_crc_drops=self.rel.crc_drops,
            ctrl_dups_dropped=self.rel.duplicates_dropped,
            ctrl_gave_up=self.rel.gave_up,
            fence_refusals=self.fence_refusals,
            chaos_faults=len(self.chaos.faults) if self.chaos else 0,
            artifacts=artifacts,
            launches=launch_counts(),
        )
        self.running = False

    # -- the loop --------------------------------------------------------

    def run(self) -> None:
        dt = 1.0 / self.cfg["fps"] if self.cfg["fps"] > 0 else 0.0
        next_t = time.perf_counter()
        last_status = 0
        while self.running:
            for cmd in self._read_cmds():
                kind = cmd.get("cmd")
                if kind == "admit":
                    self._cmd_admit(cmd)
                elif kind == "retire":
                    self._cmd_retire_match(cmd)
                elif kind == "migrate":
                    self._cmd_migrate(cmd)
                elif kind == "hiccup":
                    # Arm a burn window NOW: sleep `ms` once every
                    # `every`-th frame for the next `frames` frames —
                    # a 1-in-`every` deadline miss pages the SLO but
                    # can never fence the consecutive-strike watchdog.
                    fs = self.server.frames_served
                    self.hiccup = {
                        "start": fs,
                        "end": fs + int(cmd.get("frames", 600)),
                        "every": int(cmd.get("every", 3)),
                        "ms": float(cmd.get("ms", 60.0)),
                    }
                    self._emit(event="hiccup_armed", **self.hiccup)
                elif kind == "drain":
                    self.draining = True
                    self._emit(event="draining", server_id=self.sid)
                elif kind == "status":
                    self._status()
                elif kind == "rebase_compiles":
                    # Steady-state churn baseline: `compiles` in every
                    # later status/bye counts recompiles caused by
                    # migrations / failover / scaling alone, and the bye's
                    # `launches` the kernel launches made since.
                    from bevy_ggrs_tpu_torch.ops import wrappers
                    from bevy_ggrs_tpu_torch.utils.build_cache import (
                        compile_counters,
                    )

                    self.base_compiles = compile_counters()[
                        "backend_compiles"
                    ]
                    for fn in wrappers():
                        fn.launches = 0
                    self._emit(event="compiles_rebased")
                elif kind == "shutdown":
                    self._shutdown()
            if not self.running:
                break
            self._pump_wire()
            for nonce in list(self.outgoing):
                if time.monotonic() >= self.outgoing[nonce]["deadline"]:
                    self._abort_outgoing(nonce, "timeout")
            self.server.run_frame()
            fs = self.server.frames_served
            if fs - last_status >= self.cfg["status_interval"]:
                last_status = fs
                self._status()
            if dt:
                next_t += dt
                pause = next_t - time.perf_counter()
                if pause > 0:
                    time.sleep(pause)
                else:
                    next_t = time.perf_counter()
        self.sock.close()


def _child_main(argv: List[str]) -> int:
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(json.loads(argv[0]))
    child = _Child(cfg)
    child.run()
    return 0


# ---------------------------------------------------------------------------
# Parent: process supervision
# ---------------------------------------------------------------------------


class ServerProcess:
    """One supervised child: Popen + non-blocking stdout event pump +
    stdin command pipe. ``kill()`` is the crash lever (SIGKILL, no
    goodbye — detection is the heartbeat-timeout path); ``stop()`` is
    the graceful lifecycle. ``module`` selects the child entry point —
    the relay tier (relay/tree.py) reuses this wrapper for its
    subprocess relays."""

    def __init__(
        self,
        server_id: int,
        config: dict,
        stderr_path: Optional[str] = None,
        env: Optional[dict] = None,
        module: str = "bevy_ggrs_tpu_torch.fleet.proc",
    ):
        self.server_id = int(server_id)
        self.config = config
        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        penv = dict(os.environ if env is None else env)
        penv["PYTHONPATH"] = root + os.pathsep + penv.get("PYTHONPATH", "")
        self._stderr = (
            open(stderr_path, "ab") if stderr_path else subprocess.DEVNULL
        )
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, json.dumps(config)],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self._stderr,
            env=penv,
            cwd=root,
        )
        os.set_blocking(self.proc.stdout.fileno(), False)
        self._buf = b""

    def alive(self) -> bool:
        return self.proc.poll() is None

    def send(self, **cmd) -> bool:
        try:
            self.proc.stdin.write((json.dumps(cmd) + "\n").encode())
            self.proc.stdin.flush()
            return True
        except (BrokenPipeError, OSError, ValueError):
            return False

    def poll(self) -> List[dict]:
        """Drain available stdout into parsed events (non-JSON lines —
        stray library prints — are skipped)."""
        while True:
            try:
                data = os.read(self.proc.stdout.fileno(), 65536)
            except (BlockingIOError, InterruptedError):
                break
            except (OSError, ValueError):
                break
            if not data:
                break
            self._buf += data
        out: List[dict] = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if isinstance(ev, dict):
                out.append(ev)
        return out

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
        self._close_files()

    def stop(self, timeout: float = 30.0) -> None:
        if self.alive():
            self.send(cmd="shutdown")
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        self._close_files()

    def _close_files(self) -> None:
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except (OSError, ValueError):
                pass
        if self._stderr is not subprocess.DEVNULL:
            try:
                self._stderr.close()
            except (OSError, ValueError):
                pass


@dataclasses.dataclass
class _ProcMember:
    server_id: int
    process: ServerProcess
    checkpoint_dir: Optional[str]
    spawn_t0: float
    mig_addr: Optional[Tuple[str, int]] = None
    info: object = None  # last decoded FleetHeartbeat
    status: Optional[dict] = None
    last_beat: Optional[float] = None
    last_beat_seq: int = -1
    missed_beats: int = 0
    suspect: bool = False
    first_beat_s: Optional[float] = None
    alive: bool = True
    draining: bool = False
    retiring: bool = False
    artifacts: Optional[dict] = None
    warmup_s: Optional[float] = None  # the child's own, from its ready event
    # The served frame at which the child's armed burn window ends, from
    # its hiccup_armed event.
    hiccup_end: Optional[int] = None


class ProcFleet:
    """The parent-side fleet: supervises N subprocess MatchServers and
    implements the autopilot fleet-adapter protocol over them. One UDP
    socket ingests every child's heartbeats and doubles as the source
    end of checkpoint-failover transfers."""

    def __init__(
        self,
        root_dir: str,
        base_config: Optional[dict] = None,
        heartbeat_timeout: float = 3.0,
        obs_dir: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
        failover_timeout: float = 60.0,
        dead_beats: int = 3,
        suspect_factor: int = 3,
        chaos_plan=None,
        chaos_t0: Optional[float] = None,
    ):
        from bevy_ggrs_tpu_torch.transport.reliable import ReliableSocket
        from bevy_ggrs_tpu_torch.transport.udp import UdpSocket

        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self.base_config = dict(base_config or {})
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.failover_timeout = float(failover_timeout)
        self.dead_beats = max(1, int(dead_beats))
        # A silent-but-reachable child (the partition signature) is only
        # declared dead after suspect_factor x the normal silence budget
        # — the wedged-child backstop behind the suspect state.
        self.suspect_factor = max(1, int(suspect_factor))
        self.chaos_plan = chaos_plan  # ChaosPlan | JSON str | None
        self.chaos_t0 = chaos_t0
        self.obs_dir = obs_dir
        self.clock = clock
        # Reliable sublayer on the parent's sock too: failover shipments
        # are migration frames and children ack/retransmit envelopes.
        self.sock = ReliableSocket(
            UdpSocket(0, "127.0.0.1", use_native=False), seed=0x5EED
        )
        self.port = self.sock.local_port()
        self.members: Dict[int, _ProcMember] = {}
        self.book: Dict[int, int] = {}  # match -> server_id
        self.handles: Dict[int, Tuple[int, int]] = {}  # match -> (g, s)
        self._nonce = 0
        # nonce -> in-flight transfer ({match, src, dst, failover, deadline})
        self._migrations: Dict[int, dict] = {}
        # nonce -> match of failover transfers MigrateDone completed.
        self._failover_landed: Dict[int, int] = {}
        # match -> current migration epoch; the parent is the sole epoch
        # authority, bumping on every migrate()/failover shipment so a
        # stale attempt can never land after its successor.
        self._epochs: Dict[int, int] = {}
        self.epoch_fence_refusals = 0
        self._codec = None
        self._template = None
        self.events: List[dict] = []
        self.stall_frames: List[int] = []
        self.scale_up_s: List[float] = []
        self.failovers = 0
        self.matches_lost = 0
        self.matches_recovered = 0
        self.migrations_completed = 0
        self.migrations_aborted = 0
        self.admissions_rejected = 0

    # -- lifecycle -------------------------------------------------------

    def _booting(self) -> bool:
        return any(
            m.alive and not m.retiring and m.info is None
            for m in self.members.values()
        )

    def spawn_server(
        self,
        overrides: Optional[dict] = None,
        wait_ready: bool = False,
        timeout: float = 300.0,
    ) -> Optional[int]:
        """Start one child. Refuses while another child is still booting
        (its heartbeat hasn't landed) — the parent-side guard that keeps
        the policy's scale-up cooldown honest against a child's
        multi-second CUDA and kernel start. ``wait_ready`` blocks
        (pumping) until the first heartbeat, for test setup."""
        if self._booting():
            return None
        sid = max(self.members, default=-1) + 1
        cfg = dict(DEFAULT_CONFIG)
        cfg.update(self.base_config)
        cfg.update(overrides or {})
        ck = os.path.join(self.root_dir, f"srv{sid}", "checkpoints")
        os.makedirs(ck, exist_ok=True)
        cfg.update(
            server_id=sid,
            parent=["127.0.0.1", self.port],
            checkpoint_dir=ck,
            obs_dir=self.obs_dir,
        )
        if self.chaos_plan is not None:
            plan = self.chaos_plan
            cfg["chaos_plan"] = (
                plan if isinstance(plan, str) else plan.to_json()
            )
            if self.chaos_t0 is None:
                self.chaos_t0 = time.time()
            cfg["chaos_t0"] = self.chaos_t0
        proc = ServerProcess(
            sid, cfg,
            stderr_path=os.path.join(self.root_dir, f"srv{sid}.stderr.log"),
        )
        self.members[sid] = _ProcMember(
            server_id=sid, process=proc, checkpoint_dir=ck,
            spawn_t0=self.clock(),
        )
        self.events.append({"event": "spawned", "server": sid})
        if wait_ready:
            t0 = self.clock()
            while self.members[sid].info is None:
                if self.clock() - t0 > timeout:
                    raise TimeoutError(f"server {sid} never became ready")
                if not proc.alive():
                    raise RuntimeError(
                        f"server {sid} died during startup "
                        f"(see srv{sid}.stderr.log)"
                    )
                self.pump()
                time.sleep(0.02)
        return sid

    # -- event + heartbeat pump ------------------------------------------

    def pump(self, now: Optional[float] = None) -> None:
        from bevy_ggrs_tpu_torch.session import protocol as proto

        now = self.clock() if now is None else now
        for _addr, data in self.sock.receive_all():
            msg = proto.decode(data)
            if isinstance(msg, proto.FleetHeartbeat):
                m = self.members.get(msg.server_id)
                if m is None or not m.alive:
                    continue
                delta = m.last_beat_seq - msg.beat_seq
                if msg.beat_seq > 0 and 0 <= delta <= proto.BEAT_REORDER_WINDOW:
                    # A reordered stale beat must not refresh liveness:
                    # only monotonically newer beats count, so a delayed
                    # burst can't mask real silence (beat_seq == 0 is a
                    # legacy sender — no filtering). Staleness is a
                    # bounded WINDOW, not a bare compare: a corrupted
                    # beat that slipped decode with a high bit flipped
                    # in beat_seq would otherwise poison last_beat_seq
                    # forever; a far-off seq instead resets the floor
                    # (restart/corruption self-heal) below.
                    continue
                m.last_beat_seq = msg.beat_seq
                if m.info is None:
                    m.first_beat_s = now - m.spawn_t0
                    self.scale_up_s.append(m.first_beat_s)
                m.info, m.last_beat = msg, now
                m.missed_beats = 0
                if m.suspect:
                    m.suspect = False
                    self.events.append({
                        "event": "suspect_cleared", "server": msg.server_id,
                    })
            elif isinstance(msg, proto.MigrateDone):
                # Verdict on a parent-sourced failover transfer.
                ent = self._migrations.get(msg.nonce)
                if ent is not None and ent.get("failover"):
                    del self._migrations[msg.nonce]
                    if msg.ok:
                        # The child's migrated_in for this landing may
                        # still be in its pipe: it must not read as late.
                        self._failover_landed[msg.nonce] = ent["match"]
                        self.book[ent["match"]] = ent["dst"]
                        self.matches_recovered += 1
                        self.events.append({
                            "event": "recovered", "match": ent["match"],
                            "server": ent["dst"], "frame": msg.frame,
                        })
                    else:
                        self.book.pop(ent["match"], None)
                        self.matches_lost += 1
            elif isinstance(msg, proto.MigrateAccept):
                ent = self._migrations.get(msg.nonce)
                if (
                    ent is not None and ent.get("failover")
                    and not msg.accept
                ):
                    del self._migrations[msg.nonce]
                    self.book.pop(ent["match"], None)
                    self.matches_lost += 1
        for sid, m in sorted(self.members.items()):
            for ev in m.process.poll():
                self._handle_event(sid, m, ev)
        for nonce in list(self._migrations):
            ent = self._migrations[nonce]
            if now >= ent["deadline"]:
                del self._migrations[nonce]
                if ent.get("failover"):
                    self.book.pop(ent["match"], None)
                    self.matches_lost += 1
                else:
                    self.migrations_aborted += 1
                    self.events.append({
                        "event": "migrate_abort", "match": ent["match"],
                        "reason": "parent_timeout",
                    })

    def _handle_event(self, sid: int, m: _ProcMember, ev: dict) -> None:
        kind = ev.get("event")
        if kind == "ready":
            m.mig_addr = ("127.0.0.1", int(ev["mig_port"]))
            m.warmup_s = ev.get("warmup_s")
        elif kind == "status":
            m.status = ev
        elif kind == "hiccup_armed":
            m.hiccup_end = int(ev["end"])
        elif kind == "admitted":
            self.handles[int(ev["match"])] = (
                int(ev["group"]), int(ev["slot"]),
            )
        elif kind == "admit_failed":
            self.book.pop(int(ev["match"]), None)
            self.admissions_rejected += 1
        elif kind == "migrated_in":
            mid = int(ev["match"])
            nonce = int(ev["nonce"])
            epoch = int(ev.get("epoch", 0))
            if epoch and epoch < self._epochs.get(mid, 0):
                # Stale landing from a superseded attempt: a newer epoch
                # owns this match elsewhere. Refuse the landing and order
                # the zombie copy dropped — updating book/handles here
                # would be the split-brain.
                self._migrations.pop(nonce, None)
                self.epoch_fence_refusals += 1
                m.process.send(cmd="retire", match=mid)
                self.events.append({
                    "event": "epoch_fence", "match": mid, "server": sid,
                    "epoch": epoch, "current": self._epochs.get(mid, 0),
                })
                return
            ent = self._migrations.get(nonce)
            if ent is None and self._failover_landed.pop(nonce, None) == mid:
                # A failover whose MigrateDone reached the parent's socket
                # before this event left the child's pipe (the socket is
                # read first in a pump): the normal completion.
                self.handles[mid] = (int(ev["group"]), int(ev["slot"]))
                return
            if ent is not None and ent.get("failover"):
                # Failover completion stays with MigrateDone at our sock.
                self.handles[mid] = (int(ev["group"]), int(ev["slot"]))
                return
            self._migrations.pop(nonce, None)
            if ent is None:
                # A landing from an attempt the parent no longer
                # tracks: the source timed out, aborted, and resumed
                # its retained copy — which has been serving frames
                # since. The late landing is the stale copy; admitting
                # it would double-host the match. Retire it at the
                # destination and leave book/handles on the source.
                self.epoch_fence_refusals += 1
                m.process.send(cmd="retire", match=mid)
                self.events.append({
                    "event": "late_landing_refused", "match": mid,
                    "server": sid, "nonce": nonce,
                })
                return
            self.handles[mid] = (int(ev["group"]), int(ev["slot"]))
            self.book[mid] = ent["dst"]
            self.migrations_completed += 1
            self.stall_frames.append(int(ev["stall_frames"]))
            self.events.append({
                "event": "migrated", "match": mid,
                "src": ent["src"], "dst": ent["dst"],
                "stall_frames": int(ev["stall_frames"]),
            })
        elif kind == "migrate_abort":
            nonce = int(ev.get("nonce", -1))
            mid = ev.get("match")
            ent = self._migrations.pop(nonce, None)
            if ent is not None:
                self.migrations_aborted += 1
                if ev.get("resumed") and ev.get("handle") and mid is not None:
                    # Abort-resume may have landed in a different slot
                    # (the original was reused mid-flight).
                    self.handles[int(mid)] = tuple(ev["handle"])
            elif (
                ev.get("resumed")
                and mid is not None
                and self.book.get(int(mid)) not in (None, sid)
            ):
                # The transfer actually landed (migrated_in moved the
                # book to the destination) before the source's timeout
                # abort resumed its retained copy: that copy is the
                # zombie — retire it where it just resumed.
                self.epoch_fence_refusals += 1
                m.process.send(cmd="retire", match=int(mid))
                self.events.append({
                    "event": "stale_abort_retired", "match": int(mid),
                    "server": sid, "nonce": nonce,
                })
            if ev.get("reason") == "epoch_fence":
                self.epoch_fence_refusals += 1
            self.events.append({
                "event": "migrate_abort", "match": mid,
                "reason": ev.get("reason"), "server": sid,
            })
        elif kind == "resume_failed":
            # An aborted outgoing transfer found no slot to resume into
            # (original reused, server since filled): the running copy
            # is gone, but the checkpoint tier still has the match —
            # the same recovery the fleet uses for a dead server.
            mid = int(ev["match"])
            self._migrations.pop(int(ev.get("nonce", -1)), None)
            self.events.append({
                "event": "resume_failed", "match": mid, "server": sid,
            })
            if self.book.get(mid) == sid:
                self._recover_match(mid, exclude=sid)
        elif kind == "offer_refused":
            if ev.get("reason") == "epoch_fence":
                self.epoch_fence_refusals += 1
            self.events.append({
                "event": "offer_refused", "server": sid,
                "match": ev.get("match"), "reason": ev.get("reason"),
            })
        elif kind == "bye":
            m.artifacts = ev.get("artifacts") or {}
            # Fold the child's final counters into its last status so the
            # fleet aggregates survive shutdown.
            m.status = {**(m.status or {}), **ev}

    # -- death + failover ------------------------------------------------

    def check(self, now: Optional[float] = None) -> List[int]:
        """Partition-aware death detection. ``dead_beats`` missed beats
        (same total silence budget as the old wall-clock timeout) mark a
        member *suspect*; suspicion upgrades to death only when the
        control-plane probe fails too (the child process is gone — a
        SIGKILLed child both stops beating and fails the probe) or the
        silence outlasts ``suspect_factor`` x the budget (the
        wedged-child backstop). A mere network partition around a
        healthy child therefore never triggers a failover that would
        double-host its matches."""
        now = self.clock() if now is None else now
        period = self.heartbeat_timeout / self.dead_beats
        dead: List[int] = []
        for sid, m in sorted(self.members.items()):
            if not m.alive or m.retiring:
                continue
            if m.last_beat is not None:
                m.missed_beats = max(
                    0, int((now - m.last_beat) / period)
                )
            silent = (
                m.last_beat is not None
                and m.missed_beats >= self.dead_beats
            )
            exited_early = m.info is None and not m.process.alive()
            if silent and m.process.alive():
                if m.missed_beats < self.dead_beats * self.suspect_factor:
                    if not m.suspect:
                        m.suspect = True
                        self.events.append({
                            "event": "partition_suspected", "server": sid,
                            "missed_beats": m.missed_beats,
                        })
                    continue
            if silent or exited_early:
                m.alive = False
                dead.append(sid)
                self.events.append({"event": "dead", "server": sid})
        return dead

    def _parent_codec(self):
        """The codec of the children's world layout, with its template
        world (``self._template``), on which the parent decodes a dead
        child's checkpoint tickets before it re-packs them."""
        if self._codec is None:
            from bevy_ggrs_tpu_torch.models import box_game
            from bevy_ggrs_tpu_torch.relay.delta import StateCodec
            from bevy_ggrs_tpu_torch.state import to_host

            players = dict(
                DEFAULT_CONFIG, **self.base_config
            )["num_players"]
            # The codec needs the world's layout only, so the template is
            # built on the CPU: the parent opens no CUDA context of its
            # own beside its children on the card. The children serve on
            # their own device.
            self._template = box_game.make_world(
                players, device="cpu"
            ).commit()
            self._codec = StateCodec(to_host(self._template))
        return self._codec

    def failover(
        self, dead_id: int, preferred: Optional[Dict[int, int]] = None
    ) -> List[Tuple[int, int]]:
        """Re-seed a dead child's booked matches from its last on-disk
        checkpoint onto surviving children, shipping each record over
        the normal migration wire FROM THE PARENT'S SOCKET — the
        destination runs its ordinary migrate-in path and cannot tell
        recovery from migration. ``preferred`` (the autopilot's
        anti-affinity backup map) wins placement when that server is
        alive with capacity. Unrecoverable matches are counted lost."""
        from bevy_ggrs_tpu_torch.serve.faults import (
            ServerCheckpointer,
            load_checkpoint_matches,
            pack_match_record,
        )

        member = self.members[dead_id]
        member.alive = False
        member.process.kill()
        self.failovers += 1
        booked = sorted(
            mid for mid, sid in self.book.items() if sid == dead_id
        )
        by_key: Dict[Tuple[int, int], dict] = {}
        path = (
            ServerCheckpointer(member.checkpoint_dir).latest()
            if member.checkpoint_dir
            else None
        )
        if path is not None:
            codec = self._parent_codec()
            for rec in load_checkpoint_matches(
                path, codec, self._template
            ):
                by_key[rec["key"]] = rec
        initiated: List[Tuple[int, int]] = []
        for mid in booked:
            rec = by_key.get(self.handles.get(mid))
            dst = self._failover_dst(
                mid, dead_id, preferred or {}
            )
            if rec is None or rec["kind"] != "synctest" or dst is None:
                self.book.pop(mid, None)
                self.matches_lost += 1
                self.events.append({
                    "event": "lost", "match": mid,
                    "reason": "no_checkpoint" if rec is None else "no_dst",
                })
                continue
            self._ship_record(mid, rec, dst)
            initiated.append((mid, dst))
        return initiated

    def _failover_dst(
        self, mid: int, dead_id: int, preferred: Dict[int, int]
    ) -> Optional[int]:
        from bevy_ggrs_tpu_torch.fleet.autopilot import heartbeat_score

        def usable(sid: int) -> bool:
            m = self.members.get(sid)
            return (
                m is not None and m.alive and not m.retiring
                and m.mig_addr is not None and m.info is not None
                and m.info.slots_free > 0 and sid != dead_id
            )

        want = preferred.get(mid)
        if want is not None and usable(want):
            return want
        cands = [sid for sid in sorted(self.members) if usable(sid)]
        if not cands:
            return None
        return min(
            cands, key=lambda s: (heartbeat_score(self.members[s].info), s)
        )

    def _recover_match(self, mid: int, exclude: int) -> bool:
        """Re-seed ONE booked match from its host's last on-disk
        checkpoint onto another child — the per-match slice of
        :meth:`failover`, without declaring the host dead. Used when a
        live child reports it cannot keep a match it still owns (an
        aborted transfer with no slot left to resume into)."""
        from bevy_ggrs_tpu_torch.serve.faults import (
            ServerCheckpointer,
            load_checkpoint_matches,
        )

        member = self.members.get(exclude)
        rec = None
        path = (
            ServerCheckpointer(member.checkpoint_dir).latest()
            if member is not None and member.checkpoint_dir
            else None
        )
        if path is not None:
            codec = self._parent_codec()
            key = self.handles.get(mid)
            for r in load_checkpoint_matches(
                path, codec, self._template
            ):
                if r["key"] == key:
                    rec = r
                    break
        dst = self._failover_dst(mid, exclude, {})
        if rec is None or rec["kind"] != "synctest" or dst is None:
            self.book.pop(mid, None)
            self.matches_lost += 1
            self.events.append({
                "event": "lost", "match": mid,
                "reason": "no_checkpoint" if rec is None else "no_dst",
            })
            return False
        self._ship_record(mid, rec, dst)
        return True

    def _ship_record(self, mid: int, rec: dict, dst_id: int) -> None:
        from bevy_ggrs_tpu_torch.relay.delta import payload_digest
        from bevy_ggrs_tpu_torch.serve.server import MatchHandle
        from bevy_ggrs_tpu_torch.session import protocol as proto

        from bevy_ggrs_tpu_torch.serve.faults import pack_match_record

        codec = self._parent_codec()
        ticket = rec["ticket"]
        blob = pack_match_record(
            codec,
            {
                "handle": MatchHandle(*rec["key"]),
                "kind": rec["kind"],
                "frame": rec["frame"],
                "state": ticket.state,
                "ring": ticket.ring,
                "input_log": ticket.input_log,
                "spec_on": rec["spec_on"],
                "session_state": rec["session_state"],
            },
        )
        digest = payload_digest(blob)
        chunks = [
            blob[i : i + CHUNK_PAYLOAD]
            for i in range(0, len(blob), CHUNK_PAYLOAD)
        ] or [b""]
        self._nonce = (self._nonce + 1) & 0xFFFFFFFF
        nonce = self._nonce
        epoch = self._epochs.get(mid, 0) + 1
        self._epochs[mid] = epoch
        addr = self.members[dst_id].mig_addr
        self.sock.send_to(
            proto.encode(
                proto.MigrateOffer(
                    nonce, mid, rec["frame"], len(chunks), digest, epoch
                )
            ),
            addr,
        )
        for seq, payload in enumerate(chunks):
            self.sock.send_to(
                proto.encode(
                    proto.MigrateChunk(
                        nonce, rec["frame"], seq, len(chunks),
                        zlib.crc32(payload) & 0xFFFFFFFF, payload, epoch,
                    )
                ),
                addr,
            )
        self.sock.send_to(
            proto.encode(proto.MigrateDone(nonce, rec["frame"], 1, epoch)),
            addr,
        )
        self._migrations[nonce] = {
            "match": mid, "src": None, "dst": dst_id, "failover": True,
            "epoch": epoch,
            "deadline": self.clock() + self.failover_timeout,
        }

    # -- front door ------------------------------------------------------

    def place(self, exclude: Tuple[int, ...] = ()) -> Optional[int]:
        from bevy_ggrs_tpu_torch.fleet.autopilot import heartbeat_score

        cands = [
            (heartbeat_score(m.info), sid)
            for sid, m in sorted(self.members.items())
            if m.alive and not m.retiring and not m.draining
            and m.info is not None and m.info.slots_free > 0
            and sid not in exclude
        ]
        if not cands:
            return None
        return min(cands)[1]

    def admit(self, match_id: int, server_id: Optional[int] = None):
        sid = server_id if server_id is not None else self.place()
        if sid is None:
            self.admissions_rejected += 1
            return None
        self.members[sid].process.send(cmd="admit", match=int(match_id))
        self.book[int(match_id)] = sid
        return sid

    def retire_match(self, match_id: int) -> bool:
        sid = self.book.pop(int(match_id), None)
        if sid is None:
            return False
        self.handles.pop(int(match_id), None)
        return self.members[sid].process.send(
            cmd="retire", match=int(match_id)
        )

    # -- the autopilot fleet-adapter protocol ----------------------------

    def samples(self) -> Dict:
        from bevy_ggrs_tpu_torch.fleet.autopilot import ServerSample

        out = {}
        for sid, m in sorted(self.members.items()):
            if not m.alive or m.retiring or m.info is None:
                continue
            out[sid] = ServerSample.from_heartbeat(
                m.info, draining=m.draining,
                missed_beats=m.missed_beats,
                reachable=m.process.alive(),
            )
        return out

    def placements(self) -> Dict[int, int]:
        moving = {
            ent["match"] for ent in self._migrations.values()
        }
        return {
            mid: sid for mid, sid in self.book.items() if mid not in moving
        }

    def pump_migrations(self) -> None:
        self.pump()

    def migrate(self, match_id: int, dst_id: int) -> bool:
        mid = int(match_id)
        if any(ent["match"] == mid for ent in self._migrations.values()):
            return False
        src = self.book.get(mid)
        srcm, dstm = self.members.get(src), self.members.get(dst_id)
        if (
            src is None or src == dst_id
            or srcm is None or not srcm.alive
            or dstm is None or not dstm.alive or dstm.retiring
            or dstm.mig_addr is None
        ):
            return False
        self._nonce = (self._nonce + 1) & 0xFFFFFFFF
        nonce = self._nonce
        epoch = self._epochs.get(mid, 0) + 1
        self._epochs[mid] = epoch
        if not srcm.process.send(
            cmd="migrate", match=mid, dst=list(dstm.mig_addr), nonce=nonce,
            epoch=epoch,
        ):
            return False
        self._migrations[nonce] = {
            "match": mid, "src": src, "dst": int(dst_id), "failover": False,
            "epoch": epoch,
            "deadline": self.clock() + self.failover_timeout,
        }
        return True

    def spawn(self) -> bool:
        return self.spawn_server() is not None

    def set_draining(self, server_id: int) -> bool:
        m = self.members.get(server_id)
        if m is None or not m.alive:
            return False
        m.draining = True
        self.events.append({"event": "draining", "server": server_id})
        return m.process.send(cmd="drain")

    def retire(self, server_id: int) -> bool:
        m = self.members.get(server_id)
        if m is None or not m.alive or m.retiring:
            return False
        if any(
            ent["src"] == server_id or ent["dst"] == server_id
            for ent in self._migrations.values()
        ):
            return False
        if any(sid == server_id for sid in self.book.values()):
            return False
        m.retiring = True
        m.process.send(cmd="shutdown")
        self.events.append({"event": "retired", "server": server_id})
        return True

    # -- observability ---------------------------------------------------

    def _child_counter(self, key: str) -> int:
        return sum(
            int((m.status or {}).get(key, 0))
            for m in self.members.values()
        )

    @property
    def ctrl_retransmits(self) -> int:
        """Reliable-sublayer retransmits fleet-wide: the parent sock's
        live counter plus every child's last-reported one."""
        return getattr(self.sock, "retransmits", 0) + self._child_counter(
            "ctrl_retransmits"
        )

    @property
    def chaos_faults(self) -> int:
        return self._child_counter("chaos_faults")

    def fleet_rows(self) -> List[dict]:
        rows = []
        for sid, m in sorted(self.members.items()):
            row = {
                "server_id": sid,
                "alive": m.alive and not m.retiring,
                "draining": m.draining,
                "missed_beats": m.missed_beats,
                "suspect": m.suspect,
                "matches": sum(
                    1 for s in self.book.values() if s == sid
                ),
            }
            if m.info is not None:
                from bevy_ggrs_tpu_torch.fleet.autopilot import heartbeat_score

                hb = m.info
                total = hb.slots_active + hb.slots_free
                row.update(
                    slots_active=hb.slots_active,
                    slots_free=hb.slots_free,
                    occupancy=(
                        hb.slots_active / total if total else 0.0
                    ),
                    pages=hb.pages,
                    quarantined=hb.quarantined,
                    spec_hit_permille=hb.spec_hit_permille,
                    spec_waste_permille=hb.spec_waste_permille,
                    score=round(heartbeat_score(hb), 4),
                )
            # Cost-observatory columns ride the status events (the ops
            # report's fleet table renders them when present).
            st = m.status or {}
            if st.get("xla_compile_ms") is not None:
                row["xla_compile_ms"] = st["xla_compile_ms"]
            if st.get("hbm_peak_bytes") is not None:
                row["hbm_peak_bytes"] = st["hbm_peak_bytes"]
            rows.append(row)
        return rows

    def merge_observability(self, path: str) -> Optional[dict]:
        """Fold every child's exported Perfetto trace + provenance log
        into one cross-process fleet timeline (children must have shut
        down gracefully so their ``bye`` artifacts exist)."""
        if self.obs_dir is None:
            return None
        from bevy_ggrs_tpu_torch.obs.merge import merge_traces

        traces, provs = [], []
        for m in self.members.values():
            arts = m.artifacts or {}
            t = arts.get("trace")
            p = arts.get("provenance")
            c = arts.get("profile_counters")
            if t and os.path.exists(t):
                traces.append(t)
            if p and os.path.exists(p):
                provs.append(p)
            # Profiler counter tracks are trace-shaped files; they merge
            # through the same path onto the child's process row.
            if c and os.path.exists(c):
                traces.append(c)
        if not traces and not provs:
            return None
        return merge_traces(traces, provs, path=path)

    def close(self, timeout: float = 30.0) -> None:
        for m in self.members.values():
            if m.process.alive():
                m.process.send(cmd="shutdown")
        deadline = time.monotonic() + timeout
        for m in self.members.values():
            while m.process.alive() and time.monotonic() < deadline:
                self.pump()
                time.sleep(0.02)
            if m.process.alive():
                m.process.kill()
        self.pump()  # collect final bye events
        for m in self.members.values():
            m.process._close_files()
        self.sock.close()


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1:]))
