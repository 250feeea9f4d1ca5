"""Desync forensics: turn a desync ballot into a replayable artifact.

Counterpart of ``bevy_ggrs_tpu/obs/forensics.py``, over the port's
``state.checksum_breakdown``; its dumps carry the JAX package's schema
string, so tools read the dumps of either package alike.

When ``DESYNC_DETECTED`` fires, the evidence is still live in the session
(its own settled checksum history plus the retained ballot window of every
peer's reports) and in the runner's :class:`SnapshotRing` (the diverged
state itself). This module freezes all of it *at detection time* — the
session GCs checksum history a few exchange intervals behind the
confirmation frontier, so a dump taken later tells you less.

A dump answers the three forensic questions:

- **when** — ``first_divergent_frame``: the earliest retained exchange
  frame where a peer's reported checksum disagrees with ours;
- **what** — ``breakdown``: the per-field checksum decomposition
  (``state.checksum_breakdown``) of the divergent snapshot, reconstructed
  from the ring when the frame is still resident (labelled by source);
- **how to replay** — the chaos plan JSON (when the run was chaos-driven)
  plus the flight-recorder tail; a fixed-seed plan replays the identical
  fault sequence.

:meth:`DesyncForensics.compare` diffs two peers' dumps of the same
incident: the exact first frame their settled checksum histories disagree
on and the state fields whose lane checksums differ.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..state import checksum_breakdown

# The JAX package's schema name: the dump format is shared.
SCHEMA = "bevy_ggrs_tpu/desync-forensics/v1"
NULL_FRAME = -1


def desync_report(
    session,
    runner=None,
    frame: int = NULL_FRAME,
    recorder=None,
    chaos_plan=None,
) -> dict:
    """Snapshot everything the session still knows about a desync at
    ``frame`` (the event's exchange frame). Safe to call on any live
    session; ``runner`` enables the field-level breakdown."""
    local = {int(f): int(c) for f, c in session._local_checksums.items()}
    ballots = {
        int(f): {str(addr): int(c) for addr, c in votes.items()}
        for f, votes in session._checksum_votes.items()
    }
    divergent = sorted(
        f
        for f, votes in ballots.items()
        if f in local and any(c != local[f] for c in votes.values())
    )
    first = divergent[0] if divergent else (int(frame) if frame >= 0 else None)

    breakdown = None
    breakdown_frame = None
    breakdown_source = None
    if runner is not None:
        if first is not None:
            breakdown = runner.diagnose_frame(first)
            breakdown_frame = first
            breakdown_source = "ring"
        if breakdown is None:
            # Frame already rotated out of the ring: fall back to the live
            # state, which still carries the divergence until recovery.
            # (Whole, on an entity-sharded runner.)
            live = runner.whole_state() if hasattr(runner, "whole_state") else runner.state
            breakdown = checksum_breakdown(live)
            breakdown_frame = int(runner.frame)
            breakdown_source = "current_state"
        breakdown = {k: int(v) for k, v in breakdown.items()}

    dump = {
        "schema": SCHEMA,
        "event_frame": int(frame),
        "first_divergent_frame": first,
        "divergent_frames": divergent,
        "desync_interval": int(getattr(session, "desync_interval", 0)),
        "local_checksums": local,
        "ballots": ballots,
        "breakdown": breakdown,
        "breakdown_frame": breakdown_frame,
        "breakdown_source": breakdown_source,
    }
    # Silent-corruption context (integrity.py): the runner's undrained
    # StateFault records, each naming the first field whose lane digest
    # disagreed — for a desync that was really an un-detected SDC, this
    # points at the corrupt tensor directly.
    recs = getattr(runner, "state_faults", None)
    if recs:
        dump["state_faults"] = [
            {
                "reason": r.get("reason"),
                "frames": [int(f) for f in r.get("frames", ())],
                "repaired": bool(r.get("repaired")),
                "bitwise": r.get("bitwise"),
                "first_corrupt_field": r.get("field"),
            }
            for r in recs
        ]
    if chaos_plan is not None:
        dump["chaos_plan"] = chaos_plan.to_json()
    faults = getattr(session.socket, "faults", None)
    if faults is not None:
        dump["chaos_faults"] = [
            (float(t), str(kind), str(dst)) for t, kind, dst in faults
        ]
    if recorder is not None:
        dump["frames"] = recorder.to_dicts()
    return dump


class DesyncForensics:
    """Watches the event stream and builds one dump per desynced frame —
    and per silent-corruption incident (``STATE_FAULT``), whose dump
    additionally names the first corrupt field.

    Feed every drained event batch to :meth:`scan` (promptness matters —
    see module docstring). With ``out_dir`` set, each dump is also written
    as ``desync_f{frame}.json`` (``sdc_f{frame}.json`` for corruption
    incidents), the artifact CI uploads."""

    def __init__(
        self,
        session,
        runner=None,
        recorder=None,
        out_dir: Optional[str] = None,
        chaos_plan=None,
        tag: str = "",
    ):
        self.session = session
        self.runner = runner
        self.recorder = recorder
        self.out_dir = out_dir
        self.chaos_plan = chaos_plan
        self.tag = tag
        self.dumps: List[dict] = []
        self._seen_frames = set()

    def scan(self, events) -> List[dict]:
        """Returns the dumps newly built from this batch."""
        new = []
        for e in events:
            # Matched by name, not identity, so obs never imports the
            # session package (keeps the dependency one-directional).
            if e.kind.name == "STATE_FAULT":
                new.extend(self._scan_state_fault(e))
                continue
            if e.kind.name != "DESYNC_DETECTED":
                continue
            frame = e.data["frame"]
            if frame in self._seen_frames:
                continue
            self._seen_frames.add(frame)
            dump = desync_report(
                self.session,
                runner=self.runner,
                frame=frame,
                recorder=self.recorder,
                chaos_plan=self.chaos_plan,
            )
            dump["local"] = int(e.data["local"])
            dump["remote"] = int(e.data["remote"])
            self.dumps.append(dump)
            new.append(dump)
            if self.out_dir is not None:
                os.makedirs(self.out_dir, exist_ok=True)
                name = f"desync{self.tag}_f{frame}.json"
                with open(os.path.join(self.out_dir, name), "w") as f:
                    json.dump(dump, f, indent=1)
        return new

    def _scan_state_fault(self, e) -> List[dict]:
        """One dump per silent-corruption incident (``STATE_FAULT``,
        integrity.py): the same replayable artifact as a desync dump,
        plus the ``sdc`` record whose ``first_corrupt_field`` names the
        tensor the attestation sweep caught red-handed — the "what" a
        checksum breakdown can no longer answer once the repair landed
        bitwise."""
        frames = [int(f) for f in (e.data.get("frames") or ())]
        frame = frames[0] if frames else NULL_FRAME
        key = ("sdc", frame)
        if key in self._seen_frames:
            return []
        self._seen_frames.add(key)
        dump = desync_report(
            self.session,
            runner=self.runner,
            frame=frame,
            recorder=self.recorder,
            chaos_plan=self.chaos_plan,
        )
        dump["sdc"] = {
            "reason": e.data.get("reason"),
            "frames": frames,
            "repaired": bool(e.data.get("repaired")),
            "bitwise": e.data.get("bitwise"),
            "first_corrupt_field": e.data.get("field"),
        }
        self.dumps.append(dump)
        if self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            name = f"sdc{self.tag}_f{frame}.json"
            with open(os.path.join(self.out_dir, name), "w") as f:
                json.dump(dump, f, indent=1)
        return [dump]

    @staticmethod
    def compare(dump_a: dict, dump_b: dict) -> dict:
        """Cross-peer diff of two dumps of the same incident: the first
        frame their settled checksum histories disagree on, and the state
        fields whose per-field checksums differ."""
        cs_a = {int(f): c for f, c in dump_a["local_checksums"].items()}
        cs_b = {int(f): c for f, c in dump_b["local_checksums"].items()}
        disagree = sorted(
            f for f in set(cs_a) & set(cs_b) if cs_a[f] != cs_b[f]
        )
        fields: List[str] = []
        ba, bb = dump_a.get("breakdown"), dump_b.get("breakdown")
        if ba and bb:
            fields = sorted(
                k for k in set(ba) | set(bb) if ba.get(k) != bb.get(k)
            )
        return {
            "first_divergent_frame": disagree[0] if disagree else None,
            "divergent_frames": disagree,
            "divergent_fields": fields,
        }
