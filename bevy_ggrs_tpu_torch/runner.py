"""RollbackRunner: executes session request lists on the device.

Counterpart of ``bevy_ggrs_tpu/runner.py``. The runner owns the
device-resident world state, snapshot ring and frame counter, and runs
each ``advance_frame()`` request list, split into
``[Load?, (Save?, Advance?)*]`` segments at ``LoadGameState`` boundaries;
each segment is one :class:`~bevy_ggrs_tpu_torch.rollout.RolloutExecutor`
burst.

Invariants enforced:
- every ``SaveGameState.frame`` equals the runner's current frame;
- ``AdvanceFrame`` bumps the frame by one;
- ``LoadGameState`` rewinds the frame.

Checksums of saved frames go back to the session through
``session.report_checksum(frame, cs)``. That read is a device-to-host
sync per request list, and so is the restore guard's digest read at every
rollback: both are part of the semantics (SyncTest compares every frame,
and a corrupt row must never seed a resimulation).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch.obs.ledger import null_ledger
from bevy_ggrs_tpu_torch.obs.trace import null_tracer
from bevy_ggrs_tpu_torch.rollout import RolloutExecutor
from bevy_ggrs_tpu_torch.schedule import Schedule
from bevy_ggrs_tpu_torch.session.requests import (
    AdvanceFrame,
    LoadGameState,
    RestoreGameState,
    SaveGameState,
)
from bevy_ggrs_tpu_torch.state import (
    DEVICE_ID_BASE,
    WorldState,
    checksum_breakdown,
    combine64,
    np_dtype,
    resolve_device,
    ring_frame_at,
    ring_init,
    ring_load,
    to_host,
    tree_map,
)
from bevy_ggrs_tpu_torch.utils.metrics import null_metrics


@dataclasses.dataclass
class _Step:
    save_frame: Optional[int] = None
    adv: Optional[AdvanceFrame] = None


class RollbackRunner:
    def __init__(
        self,
        schedule: Schedule,
        initial_state: WorldState,
        max_prediction: int,
        num_players: int,
        input_spec,
        report_checksums: bool = True,
        metrics=None,
        tracer=None,
        ledger=None,
        device=None,
    ):
        """``device`` is where the session runs (default ``cuda``, raising
        when there is no GPU); ``initial_state`` is moved there."""
        self.metrics = metrics if metrics is not None else null_metrics
        self.tracer = tracer if tracer is not None else null_tracer
        self.ledger = ledger if ledger is not None else null_ledger
        self.device = resolve_device(device)
        self.schedule = schedule
        self.num_players = int(num_players)
        self.input_spec = input_spec
        self.max_prediction = int(max_prediction)
        self.state = tree_map(lambda x: x.to(self.device), initial_state)
        # Ring depth: max_prediction + 1 slack for the save of the frame
        # being left.
        self.ring = ring_init(self.state, self.max_prediction + 1)
        self.executor = RolloutExecutor(schedule, self.max_prediction + 2)
        self.frame = 0
        self.report_checksums = report_checksums
        self.rollback_frames_total = 0  # resimulated frames
        self.rollbacks_total = 0
        # Verify a rollback's target ring row against its save-time digest
        # before resimulating from it.
        self.verify_restores = True
        # As-used (bits, status) per advanced frame, kept a little past
        # ring depth: the input log the repair engine resimulates from.
        self._used_inputs: dict = {}
        # Detection reports (appended by attest_and_repair).
        self.state_faults: List[dict] = []
        self.sdc_detected_total = 0
        self.sdc_repaired_total = 0
        # Bursts dispatched to the device.
        self.device_dispatches_total = 0
        self.ticks_total = 0

    # ------------------------------------------------------------------

    def handle_requests(self, requests: Sequence[object], session=None) -> None:
        """Execute a request list in order, one burst per Load-delimited
        segment. ``RestoreGameState`` splits the list: everything before
        it runs first, then the restore replaces state, ring and frame."""
        with self.tracer.span("handle_requests"):
            self._handle_requests(requests, session)

    def _handle_requests(self, requests: Sequence[object], session=None) -> None:
        batch: List[object] = []
        for req in requests:
            if isinstance(req, RestoreGameState):
                if batch:
                    for load_frame, steps in self._segment(batch):
                        self._run_segment(load_frame, steps, session)
                    batch = []
                self.restore_state(req.frame, req.state)
            else:
                batch.append(req)
        for load_frame, steps in self._segment(batch):
            self._run_segment(load_frame, steps, session)

    def _segment(
        self, requests: Sequence[object]
    ) -> List[Tuple[Optional[int], List[_Step]]]:
        segments: List[Tuple[Optional[int], List[_Step]]] = []
        load: Optional[int] = None
        steps: List[_Step] = []
        for req in requests:
            if isinstance(req, LoadGameState):
                if steps or load is not None:
                    segments.append((load, steps))
                load, steps = req.frame, []
            elif isinstance(req, SaveGameState):
                steps.append(_Step(save_frame=req.frame))
            elif isinstance(req, AdvanceFrame):
                if steps and steps[-1].adv is None:
                    steps[-1].adv = req
                else:
                    steps.append(_Step(adv=req))
            else:
                raise TypeError(f"unknown request {req!r}")
        if steps or load is not None:
            segments.append((load, steps))
        return segments

    def _run_segment(
        self, load_frame: Optional[int], steps: List[_Step], session
    ) -> None:
        frame = self.frame if load_frame is None else load_frame
        start_frame = frame
        save_frames: List[Optional[int]] = []
        for step in steps:
            if step.save_frame is not None and step.save_frame != frame:
                raise AssertionError(
                    f"save frame {step.save_frame} != driver frame {frame}"
                )
            save_frames.append(step.save_frame)
            if step.adv is not None:
                self._used_inputs[frame] = (
                    np.asarray(step.adv.bits),
                    np.asarray(step.adv.status, np.int32),
                )
                frame += 1

        n = len(steps)
        if load_frame is not None and self.verify_restores:
            if not integrity.verify_row(self.ring, load_frame):
                # The rollback's target row no longer hashes to its
                # save-time digest: repair the ring first (raises
                # StateFault when it cannot), then resimulate from the
                # repaired row.
                self.attest_and_repair(session)
        if n == 0 and load_frame is not None:
            # Bare Load with no resimulation steps: still restore the state.
            self.state = ring_load(self.ring, load_frame)
            self.device_dispatches_total += 1
        if n:
            zero_bits = self.input_spec.zeros_np(self.num_players)
            bits = np.stack(
                [s.adv.bits if s.adv is not None else zero_bits for s in steps]
            )
            status = np.stack(
                [
                    s.adv.status
                    if s.adv is not None
                    else np.zeros(self.num_players, np.int32)
                    for s in steps
                ]
            )
            save_mask = np.array([s.save_frame is not None for s in steps])
            adv_mask = np.array([s.adv is not None for s in steps])
            self.device_dispatches_total += 1
            with self.metrics.timer("dispatch"), self.tracer.span(
                "dispatch", frames=n
            ):
                self.ring, self.state, checksums = self.executor.run(
                    self.ring,
                    self.state,
                    start_frame,
                    bits,
                    status,
                    n_frames=n,
                    load_frame=load_frame,
                    save_mask=save_mask,
                    adv_mask=adv_mask,
                )
            if session is not None and self.report_checksums and save_mask.any():
                # Only frames the session wants force the device->host
                # sync (P2P exchanges only some confirmed frames).
                wants = getattr(session, "wants_checksum", None)
                report = [
                    (t, sf) for t, sf in enumerate(save_frames)
                    if sf is not None and (wants is None or wants(sf))
                ]
                if report:
                    with self.metrics.timer("checksum_sync"), self.tracer.span(
                        "checksum_sync"
                    ):
                        cs_host = checksums.cpu().numpy()  # [T, 2] lo/hi lanes
                    for t, sf in report:
                        session.report_checksum(sf, combine64(cs_host[t]))
        self.metrics.count("frames_advanced", sum(1 for s in steps if s.adv))
        if load_frame is not None:
            depth = sum(1 for s in steps if s.adv is not None)
            self.rollbacks_total += 1
            self.rollback_frames_total += depth
            self.metrics.count("rollbacks")
            self.metrics.count("rollback_frames", depth)
            self.metrics.observe("rollback_depth", depth)
            self.ledger.record("unmatched", depth=depth,
                               frames_resimulated=depth, load_frame=load_frame)
        self.frame = frame
        horizon = self.frame - (self.max_prediction + 4)
        for f in [f for f in self._used_inputs if f < horizon]:
            del self._used_inputs[f]

    # ------------------------------------------------------------------
    # Corruption attestation and rollback-powered repair

    def attest_and_repair(self, session=None) -> dict:
        """Attest every occupied ring row against its save-time digest; on
        a mismatch restore the deepest clean snapshot and resimulate to the
        live frame from the as-used input log. Determinism makes the
        recomputed rows and live state bitwise equal to the originals,
        which the report's ``bitwise`` flag witnesses through the live
        state's digest. Raises :class:`~bevy_ggrs_tpu_torch.integrity.
        StateFault` when no clean base or no inputs cover the span."""
        mask = integrity.attest_ring(self.ring)
        report = {
            "corrupt_frames": [], "repaired": 0, "repair_frames": 0,
            "bitwise": None, "first_corrupt_field": None,
        }
        if not mask.any():
            return report
        frames_h = self.ring.frames.cpu().numpy()
        corrupt = sorted(int(f) for f in frames_h[mask])
        report["corrupt_frames"] = corrupt
        self.sdc_detected_total += len(corrupt)
        self.metrics.count("sdc_detected", len(corrupt))
        cset = set(corrupt)
        clean_below = sorted(
            int(f) for f in frames_h[frames_h >= 0]
            if int(f) < corrupt[0] and int(f) not in cset
        )

        def _fail(detail: str) -> None:
            fault = integrity.StateFault("sdc", corrupt, detail=detail)
            self.state_faults.append({
                "reason": "sdc", "frames": corrupt, "repaired": False,
                "bitwise": False, "field": None, "detail": detail,
            })
            self.metrics.count("sdc_unrepairable")
            raise fault

        if corrupt[-1] >= self.frame:
            _fail(f"corrupt row at frame {corrupt[-1]} >= live frame "
                  f"{self.frame} — resimulation cannot reach it")
        if not clean_below:
            _fail("no digest-clean snapshot below the corrupt rows")
        base = clean_below[-1]
        used = []
        for f in range(base, self.frame):
            got = self._used_inputs.get(f)
            if got is None:
                _fail(f"as-used input log does not cover frame {f}")
            used.append(got)
        before = integrity.host_row(self.ring, corrupt[0] % self.ring.depth)
        pre_live = integrity._state_digest(self.state).cpu().numpy()
        n = len(used)
        with self.metrics.timer("sdc_repair"), self.tracer.span(
            "sdc_repair", frames=n
        ):
            pos = base
            while pos < self.frame:
                take = min(self.frame - pos, self.max_prediction + 2)
                chunk = used[pos - base : pos - base + take]
                bits = np.stack([b for b, _ in chunk])
                status = np.stack([st for _, st in chunk])
                self.device_dispatches_total += 1
                self.ring, self.state, _cs = self.executor.run(
                    self.ring, self.state, pos, bits, status,
                    n_frames=take,
                    load_frame=base if pos == base else None,
                )
                pos += take
        post_live = integrity._state_digest(self.state).cpu().numpy()
        after = integrity.host_row(self.ring, corrupt[0] % self.ring.depth)
        report["first_corrupt_field"] = integrity.first_corrupt_field(
            before, after
        )
        report["repaired"] = len(corrupt)
        report["repair_frames"] = n
        report["bitwise"] = bool(
            (pre_live == post_live).all()
            and not integrity.attest_ring(self.ring).any()
        )
        self.sdc_repaired_total += len(corrupt)
        self.metrics.count("sdc_repaired", len(corrupt))
        if report["bitwise"]:
            self.metrics.count("sdc_repaired_bitwise", len(corrupt))
        self.metrics.observe("sdc_repair_frames", n)
        self.state_faults.append({
            "reason": "sdc", "frames": corrupt, "repaired": True,
            "bitwise": report["bitwise"],
            "field": report["first_corrupt_field"],
        })
        return report

    # ------------------------------------------------------------------

    def restore_state(self, frame: int, state: WorldState) -> None:
        """Adopt an external checkpoint: the world becomes a copy of
        ``state`` at driver frame ``frame``, and the ring is re-seeded from
        it (older rows belong to the abandoned timeline)."""
        self.state = tree_map(lambda x: x.to(self.device).clone(), state)
        self.ring = ring_init(self.state, self.max_prediction + 1)
        self.frame = int(frame)
        self.metrics.count("state_restores")

    def warmup(self) -> None:
        """Build the kernels and run each device pass once before the
        session goes live, so the first real frame pays no build."""
        zero = self.input_spec.zeros_np(self.num_players)
        bits = np.zeros((0,) + zero.shape, zero.dtype)
        status = np.zeros((0, self.num_players), np.int32)
        # n_frames=0: every step is padding, the live ring/state untouched.
        self.executor.run(self.ring, self.state, 0, bits, status, n_frames=0)
        integrity.warm(self.ring, state=self.state)

    def world(self):
        """Host copy of the current world (the only place non-rollback
        code should read simulated state from)."""
        return to_host(self.state)

    # ------------------------------------------------------------------
    # Live-session entity lifecycle (host side)

    def spawn(self, components: dict, rollback_id: int) -> int:
        """Spawn an entity into the live state between ticks; returns its
        slot. It exists in snapshots saved from now on: a rollback to an
        earlier frame restores a world without it, and resimulation does
        not recreate it."""
        if not 0 <= int(rollback_id) < DEVICE_ID_BASE:
            raise ValueError(
                f"rollback_id {rollback_id} outside the host id space "
                f"0..{DEVICE_ID_BASE - 1} (>= DEVICE_ID_BASE is reserved "
                "for device-minted ids)"
            )
        alive = self.state.alive.cpu().numpy()
        rids = self.state.rollback_id.cpu().numpy()
        if int(rollback_id) in rids[alive]:
            raise ValueError(f"duplicate rollback_id {rollback_id}")
        free = np.flatnonzero(~alive)
        if free.size == 0:
            raise RuntimeError(f"world capacity {alive.shape[0]} exhausted")
        slot = int(free[0])
        comps = dict(self.state.components)
        pres = dict(self.state.present)
        for name, value in components.items():
            if name not in comps:
                raise KeyError(f"component {name!r} not registered")
            comps[name] = comps[name].clone()
            comps[name][slot] = torch.as_tensor(
                np.asarray(value, np_dtype(comps[name].dtype)))
            pres[name] = pres[name].clone()
            pres[name][slot] = True
        new_alive = self.state.alive.clone()
        new_alive[slot] = True
        rid = self.state.rollback_id.clone()
        rid[slot] = int(rollback_id)
        self.state = self.state.replace(
            alive=new_alive, rollback_id=rid, components=comps, present=pres,
        )
        return slot

    def despawn(self, rollback_id: int) -> bool:
        """Despawn the live entity carrying ``rollback_id``; returns whether
        it existed. Snapshots saved before this call still hold it."""
        alive = self.state.alive.cpu().numpy()
        rids = self.state.rollback_id.cpu().numpy()
        hits = np.flatnonzero(alive & (rids == int(rollback_id)))
        if hits.size == 0:
            return False
        slot = int(hits[0])

        def cleared(t, value):
            t = t.clone()
            t[slot] = value
            return t

        self.state = self.state.replace(
            alive=cleared(self.state.alive, False),
            rollback_id=cleared(self.state.rollback_id, -1),
            present={n: cleared(p, False) for n, p in self.state.present.items()},
        )
        return True

    def diagnose_frame(self, frame: int):
        """Per-part checksum breakdown of the snapshot saved for ``frame``
        (None if its ring slot was overwritten): on a desync both peers
        diff these to find the registered type that diverged."""
        # frame < 0 would collide with the ring's -1 empty-slot sentinel.
        if frame < 0 or ring_frame_at(self.ring, frame) != frame:
            return None
        return checksum_breakdown(ring_load(self.ring, frame))
