"""PyTorch port, serve-tier fault domains: ``serve/faults.py``.

The slot-health FSM's transition table, strikes and SLO signals equal the
JAX package's; ``pack_match_record`` writes the JAX package's bytes and
each package unpacks the other's (a damaged blob is a ``ValueError``);
typed faults leave every slot untouched; extract -> singleton runner ->
readmit and the server checkpointer's save -> restore are bitwise against
uninterrupted runs and build or prepare nothing after warmup.
"""

import time

import numpy as np
import pytest
import torch

from bevy_ggrs_tpu import state as js
from bevy_ggrs_tpu.models import box_game as jbox
from bevy_ggrs_tpu.relay import delta as jdelta
from bevy_ggrs_tpu.serve import faults as jfaults
from bevy_ggrs_tpu.serve.server import MatchServer as JServer
from bevy_ggrs_tpu.session.builder import SessionBuilder as JBuilder
from bevy_ggrs_tpu_torch import integrity
from bevy_ggrs_tpu_torch import state as ts
from bevy_ggrs_tpu_torch.models import box_game as tbox
from bevy_ggrs_tpu_torch.relay import delta as tdelta
from bevy_ggrs_tpu_torch.serve import faults as tfaults
from bevy_ggrs_tpu_torch.serve.faults import (
    SlotFault,
    SlotHealth,
    SlotHealthFSM,
    SlotTicket,
    adopt_ticket,
)
from bevy_ggrs_tpu_torch.serve.server import MatchServer
from bevy_ggrs_tpu_torch.session import requests as treq
from bevy_ggrs_tpu_torch.session.builder import SessionBuilder
from bevy_ggrs_tpu_torch.session.requests import RestoreGameState, SaveGameState
from bevy_ggrs_tpu_torch.utils import build_cache
from tests.test_torch_serve_batch import (
    BRANCHES,
    MAXPRED,
    P,
    SPEC_FRAMES,
    assert_slot_equals_runner,
    drive,
    jax_core,
    make_core,
    make_script,
    make_singleton,
    requests_of,
    singleton_run,
)


def slot_cs(core, slot):
    return ts.combine64(ts.checksum(core.slot_state(slot)))


def test_fsm_transition_table_equals_jax():
    for a in SlotHealth:
        for b in SlotHealth:
            ja, jb = jfaults.SlotHealth[a.name], jfaults.SlotHealth[b.name]
            mine, theirs = SlotHealthFSM(0, initial=a), jfaults.SlotHealthFSM(0, initial=ja)
            ok_mine = ok_theirs = True
            try:
                mine.to(b)
            except ValueError:
                ok_mine = False
            try:
                theirs.to(jb)
            except ValueError:
                ok_theirs = False
            assert ok_mine == ok_theirs, (a, b)
            assert mine.state.name == theirs.state.name
    # Strikes, forgiveness and SLO signals step for step.
    mine, theirs = SlotHealthFSM(3, strike_limit=3), jfaults.SlotHealthFSM(3, strike_limit=3)
    for op, arg in [("strike", 1), ("clear", None), ("strike", 2), ("strike", 3),
                    ("slo_signal", "ok"), ("strike", 4), ("slo_signal", "page"),
                    ("clear", None), ("slo_signal", "page"), ("slo_signal", "ok")]:
        got = getattr(mine, op)(*(() if arg is None else (arg,)))
        want = getattr(theirs, op)(*(() if arg is None else (arg,)))
        assert got == want and mine.state.name == theirs.state.name
        assert mine.strikes == theirs.strikes


def test_slot_fault_reasons_are_typed():
    core = make_core(num_slots=2)
    slot = core.admit()
    with pytest.raises(SlotFault) as ei:
        core.tick({slot: ([RestoreGameState(0, None)], None, None)})
    assert (ei.value.slot, ei.value.reason) == (slot, "restore_request")
    with pytest.raises(SlotFault) as ei:
        core.tick({slot: ([SaveGameState(0)], None, None)})
    assert ei.value.reason == "non_canonical_burst"
    too_deep = requests_of(treq, [(None, [(f, [1, 2]) for f in range(core.burst_frames + 1)],
                                   None)])[0][0]
    with pytest.raises(SlotFault) as ei:
        core.tick({slot: (too_deep, None, None)})
    assert ei.value.reason == "burst_overflow" and ei.value.frame == 0


def test_fault_leaves_every_slot_bitwise_untouched():
    core = make_core(num_slots=3)
    a, b = core.admit(), core.admit()
    sa = make_script(seed=11, depth=2, cycles=2)
    sb = make_script(seed=12, depth=3, cycles=2)
    half = len(sb) // 2
    drive(core, {a: sa[: len(sa) // 2], b: sb[:half]})
    before = {s: (core.slots[s].frame, slot_cs(core, s), core.rings.checksums[s].clone())
              for s in (a, b)}
    rb = requests_of(treq, sb)
    bad = [treq.AdvanceFrame(bits=np.asarray([1, 2], np.uint8), status=np.zeros(P, np.int32))]
    with pytest.raises(SlotFault) as ei:
        core.tick({a: (bad, None, None), b: (rb[half][0], rb[half][1], None)})
    assert ei.value.slot == a
    for s in (a, b):
        frame, cs, ring_cs = before[s]
        assert core.slots[s].frame == frame and slot_cs(core, s) == cs
        assert torch.equal(core.rings.checksums[s], ring_cs)
    core.tick({b: (rb[half][0], rb[half][1], None)})
    drive(core, {a: sa[len(sa) // 2:], b: sb[half + 1:]})
    for s, script in ((a, sa), (b, sb)):
        assert_slot_equals_runner(core, s, singleton_run(script))


def test_extract_readmit_bitwise_and_builds_nothing():
    """Drain a slot to a ticket, run it on a singleton runner (the lane
    move), readmit at the same slot, finish: bitwise the uninterrupted run,
    and the ticket's rows are copies later ticks never reach."""
    core = make_core(num_slots=2)
    s = core.admit()
    script = make_script(seed=21, depth=3, cycles=4)
    third = len(script) // 3
    drive(core, {s: script[:third]})
    runner = make_singleton(spec=False)
    base = build_cache.compile_counters()
    shapes0 = core._exec.cache_size()
    ticket = core.extract(s)
    kept = ticket.ring.checksums.clone()
    other = core.admit()  # reuses no memory of the ticket
    drive(core, {other: make_script(seed=5, depth=2, cycles=1)})
    assert torch.equal(ticket.ring.checksums, kept)
    core.retire(other)
    adopt_ticket(runner, ticket)
    for reqs, _ in requests_of(treq, script)[third: 2 * third]:
        runner.handle_requests(reqs, None)
    back = SlotTicket(frame=runner.frame, state=runner.state, ring=runner.ring,
                      input_log=dict(runner._input_log or {}))
    assert core.admit(slot=s, ticket=back) == s
    drive(core, {s: script[2 * third:]})
    assert build_cache.compile_counters() == base
    assert core._exec.cache_size() == shapes0 == 1
    assert_slot_equals_runner(core, s, singleton_run(script))


# ---------------------------------------------------------------------------
# Match records: the JAX package's bytes
# ---------------------------------------------------------------------------


def _record(pkg):
    """The same box_game match (frame 9 of one script, a log tail) as a
    snapshot record of ``pkg``'s core."""
    script = make_script(seed=4, depth=2, cycles=2)[:9]
    if pkg == "torch":
        core = make_core(num_slots=2)
        slot = core.admit()
        drive(core, {slot: script})
        state, ring = core.slot_state(slot), core.slot_ring(slot)
        log = dict(core.slots[slot].input_log)
        codec = tdelta.StateCodec(ts.to_host(core._template))
    else:
        from bevy_ggrs_tpu.session import requests as jreq

        core = jax_core("box_game", 2)
        slot = core.admit()
        drive(core, {slot: script}, jreq)
        state, ring = core.slot_state(slot), core.slot_ring(slot)
        log = dict(core.slots[slot].input_log)
        codec = jdelta.StateCodec(js.to_host(core._template))
    return codec, dict(handle=None, kind="synctest", frame=core.slots[slot].frame, state=state,
                       ring=ring, input_log=log, spec_on=True,
                       session_state={"frame": 9})


def test_match_record_bytes_equal_jax_and_cross_unpack(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)  # the zip's member dates
    tcodec, trec = _record("torch")
    jcodec, jrec = _record("jax")
    assert tcodec.size == jcodec.size
    tblob = tfaults.pack_match_record(tcodec, trec)
    jblob = jfaults.pack_match_record(jcodec, jrec)
    assert tblob == jblob
    template = tbox.make_world(P, device="cpu").commit()
    mine = tfaults.unpack_match_record(tcodec, jblob, template)
    theirs = jfaults.unpack_match_record(jcodec, tblob)
    assert mine["frame"] == theirs["frame"] == 9
    assert mine["session_state"] == theirs["session_state"] == {"frame": 9}
    tk, jk = mine["ticket"], theirs["ticket"]
    assert tcodec.encode(ts.to_host(tk.state)) == jcodec.encode(js.to_host(jk.state))
    np.testing.assert_array_equal(tk.ring.frames.numpy(), np.asarray(jk.ring.frames))
    np.testing.assert_array_equal(tk.ring.checksums.numpy(),
                                  np.asarray(jk.ring.checksums).astype(np.int64))
    assert sorted(tk.input_log) == sorted(jk.input_log)
    # The ring rows as loaded still hash to their stored digests.
    assert not integrity.attest_ring(tk.ring).any()
    damaged = bytearray(jblob)
    damaged[len(damaged) // 2] ^= 0x10
    with pytest.raises(ValueError):
        tfaults.unpack_match_record(tcodec, bytes(damaged), template)


def test_state_codec_bytes_equal_jax():
    from tests.test_torch_speculate import box_worlds

    for host in box_worlds(6, 3):
        tcodec, jcodec = tdelta.StateCodec(host), jdelta.StateCodec(host)
        world = ts.from_host(tbox.make_registry(), host, device="cpu")
        data = tcodec.encode(world)
        assert data == jcodec.encode(host) and len(data) == tcodec.size == jcodec.size
        back = tcodec.decode_state(data)
        assert ts.combine64(ts.checksum(back)) == ts.combine64(ts.checksum(world))
        assert tdelta.payload_digest(data) == jdelta.payload_digest(data)
        moved = bytearray(data)
        moved[5] ^= 0x40
        delta = tdelta.delta_encode(data, bytes(moved))
        assert delta == jdelta.delta_encode(data, bytes(moved))
        assert tdelta.delta_apply(data, delta) == bytes(moved)


# ---------------------------------------------------------------------------
# The server checkpointer
# ---------------------------------------------------------------------------


def make_server(pkg="torch", **kw):
    kw.setdefault("capacity", 4)
    kw.setdefault("stagger_groups", 2)
    if pkg == "torch":
        server = MatchServer(tbox.make_schedule(), tbox.make_world(P, device="cpu").commit(),
                             MAXPRED, P, tbox.INPUT_SPEC, num_branches=BRANCHES,
                             spec_frames=SPEC_FRAMES, device="cpu", **kw)
    else:
        server = JServer(jbox.make_schedule(), jbox.make_world(P).commit(), MAXPRED, P,
                         jbox.INPUT_SPEC, num_branches=BRANCHES, spec_frames=SPEC_FRAMES,
                         **kw)
    server.warmup()
    return server


def make_synctest(pkg="torch"):
    builder = (SessionBuilder(tbox.INPUT_SPEC) if pkg == "torch"
               else JBuilder(jbox.INPUT_SPEC))
    return (builder.with_num_players(P).with_max_prediction_window(MAXPRED)
            .with_check_distance(2).start_synctest_session())


def inputs_for(seed):
    def f(frame, handle):
        return np.uint8((frame * 3 + handle * 5 + seed) % 16)

    return f


def test_checkpoint_restore_resumes_bitwise_and_loads_jax_files(tmp_path, monkeypatch):
    """Kill a checkpointed server after 12 frames, rebuild it from disk,
    play on: every match bitwise an uninterrupted twin's. A JAX server's
    checkpoint of the same matches loads into the same tickets."""
    ckpt = tmp_path / "port"
    server = make_server(checkpoint_dir=str(ckpt), checkpoint_interval=6)
    twin = make_server()
    hs = [server.add_match(make_synctest(), inputs_for(k)) for k in range(3)]
    ths = [twin.add_match(make_synctest(), inputs_for(k)) for k in range(3)]
    for _ in range(12):
        server.run_frame()
        twin.run_frame()
    assert server.checkpointer.saves_total == 2
    sessions = {(h.group, h.slot): server._matches[h].session for h in hs}
    del server  # the process dies; its sessions' state is in the file
    reborn = make_server(checkpoint_dir=str(ckpt), checkpoint_interval=6)
    base = build_cache.compile_counters()
    handles = reborn.checkpointer.restore(reborn, {
        key: {"session": make_synctest(), "local_inputs": inputs_for(k)}
        for k, key in enumerate(sorted(sessions))})
    assert sorted((h.group, h.slot) for h in handles) == sorted(sessions)
    for _ in range(6):
        reborn.run_frame()
        twin.run_frame()
    assert build_cache.compile_counters() == base
    for h, t in zip(sorted(handles, key=lambda h: (h.group, h.slot)),
                    sorted(ths, key=lambda h: (h.group, h.slot))):
        core, tcore = reborn.groups[h.group], twin.groups[t.group]
        assert core.slots[h.slot].frame == tcore.slots[t.slot].frame == 18
        assert slot_cs(core, h.slot) == slot_cs(tcore, t.slot)
        assert torch.equal(core.rings.checksums[h.slot], tcore.rings.checksums[t.slot])
    # The JAX package's checkpoint of the same 12 frames.
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    jdir = tmp_path / "jax"
    jserver = make_server("jax", checkpoint_dir=str(jdir), checkpoint_interval=12)
    for k in range(3):
        jserver.add_match(make_synctest("jax"), inputs_for(k))
    for _ in range(12):
        jserver.run_frame()
    jpath = jserver.checkpointer.last_save_path
    codec = reborn.state_codec()
    mine = tfaults.load_checkpoint_matches(str(ckpt / "server_ckpt_12.npz"), codec,
                                           reborn._template)
    theirs = tfaults.load_checkpoint_matches(jpath, codec, reborn._template)
    assert [r["key"] for r in mine] == [r["key"] for r in theirs]
    for a, b in zip(mine, theirs):
        assert a["frame"] == b["frame"] == 12
        assert codec.encode(a["ticket"].state) == codec.encode(b["ticket"].state)
        assert torch.equal(a["ticket"].ring.checksums, b["ticket"].ring.checksums)
    # A damaged newest file falls back to the one before.
    newest = reborn.checkpointer.latest()
    with open(newest, "r+b") as f:
        data = bytearray(f.read())
        data[len(data) // 2] ^= 0xFF  # inside a member's compressed data
        f.seek(0)
        f.write(bytes(data))
    again = make_server(checkpoint_dir=str(ckpt))
    again.checkpointer.restore(again, {
        key: {"session": make_synctest(), "local_inputs": inputs_for(k)}
        for k, key in enumerate(sorted(sessions))})
    assert again.checkpointer.load_fallbacks >= 1
