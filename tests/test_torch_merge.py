"""PyTorch port, the fleet's trace merger: ``obs/merge.py``.

Two port peers play through a port ``RelayServer``, every raw socket
wrapped in a provenance tap; the exported logs and the relay's trace go
through both packages' ``merge_traces``, ``frame_flows`` and ``follow``
and the CLI, which must give the same JSON. Pid remapping and wall
alignment are held equal on synthetic traces.
"""

import json

import pytest

from bevy_ggrs_tpu.obs import merge as jmerge
from bevy_ggrs_tpu_torch import obs as tobs
from bevy_ggrs_tpu_torch.obs import ProvenanceLog, SidecarSocket, SpanTracer
from bevy_ggrs_tpu_torch.obs import merge as tmerge
from bevy_ggrs_tpu_torch.relay import RelayServer, RelaySocket, peer_addr
from bevy_ggrs_tpu_torch.session import PlayerType, SessionBuilder
from bevy_ggrs_tpu_torch.models import box_game
from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork
from tests.test_torch_p2p import FPS_DT, make_runner, scripted_input, step_peer


def run_relayed_pair(tmp_path, frames=90):
    """Two port peers whose only transport is a port relay, each raw
    socket (and the relay's) tapped; returns the provenance paths and the
    relay's trace path."""
    net = LoopbackNetwork()
    logs = []

    def tap(sock, component, pid):
        log = ProvenanceLog(component, pid=pid, clock=lambda: net.now)
        logs.append(log)
        return SidecarSocket(sock, log)

    tracer = SpanTracer(clock=lambda: net.now, pid=100, process_name="relay",
                        wall_t0=1000.0)
    relay = RelayServer(tap(net.socket(("relay", 0)), "relay", 100),
                        clock=lambda: net.now, tracer=tracer)
    peers = []
    for me in range(2):
        rsock = RelaySocket(tap(net.socket(("peer", me)), f"peer{me}", me), [("relay", 0)],
                            session_id=1, peer_id=me, clock=lambda: net.now)
        builder = SessionBuilder(box_game.INPUT_SPEC).with_num_players(2) \
            .with_max_prediction_window(8)
        for h in range(2):
            builder.add_player(PlayerType.local() if h == me
                               else PlayerType.remote(peer_addr(h)), h)
        peers.append((builder.start_p2p_session(rsock, clock=lambda: net.now),
                      make_runner(2)))
    for _ in range(frames):
        net.advance(FPS_DT)
        relay.pump(net.now)
        for session, runner in peers:
            step_peer(session, runner, scripted_input)
    assert all(s.current_frame >= 40 for s, _ in peers)
    prov = []
    for log in logs:
        p = tmp_path / f"{log.component}.jsonl"
        log.export_jsonl(str(p))
        prov.append(str(p))
    trace = tmp_path / "relay_trace.json"
    tracer.export_perfetto(str(trace))
    return prov, str(trace)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    return run_relayed_pair(tmp_path_factory.mktemp("merge"))


def test_obs_exports_the_merge_names():
    assert tobs.merge_traces is tmerge.merge_traces
    assert tobs.follow is tmerge.follow and tobs.frame_flows is tmerge.frame_flows


@pytest.mark.parametrize("align", ["none", "wall"])
def test_merged_trace_equals_jax(exports, align, tmp_path):
    prov, trace = exports
    mine = tmerge.merge_traces([trace], prov, path=str(tmp_path / "m.json"), align=align)
    theirs = jmerge.merge_traces([trace], prov, path=str(tmp_path / "j.json"), align=align)
    assert json.dumps(mine) == json.dumps(theirs)
    assert (tmp_path / "m.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    ev = mine["traceEvents"]
    assert any(e["ph"] == "s" for e in ev) and any(e["ph"] == "f" for e in ev)


def test_flows_and_follow_equal_jax(exports):
    prov, _ = exports
    for frame in (20, 30, 45):
        mine, theirs = tmerge.frame_flows(prov, frame), jmerge.frame_flows(prov, frame)
        assert mine == theirs
    four_hop = {k: c for k, c in tmerge.frame_flows(prov, 30).items() if len(c) == 4}
    assert four_hop, "no input crossed the relay"
    for key, chain in four_hop.items():
        assert [r["dir"] for _, r in chain] == ["tx", "rx", "tx", "rx"]
        assert tmerge.follow(prov, key) == jmerge.follow(prov, key) == chain


def test_cli_equals_jax(exports, tmp_path, capsys):
    prov, trace = exports
    outs = {}
    for name, main in (("torch", tmerge.main), ("jax", jmerge.main)):
        out = tmp_path / f"{name}.json"
        assert main([trace, "--provenance", *prov, "--out", str(out)]) == 0
        outs[name] = (out.read_bytes(), capsys.readouterr().out.replace(str(out), "OUT"))
    assert outs["torch"] == outs["jax"]
    assert "flow hops" in outs["torch"][1]


def test_pid_remap_and_wall_alignment_equal_jax(tmp_path):
    paths = []
    for name, pid, wall in (("a", 0, 100.0), ("b", 0, 100.5), ("c", 3, 99.25)):
        t = SpanTracer(pid=pid, process_name=name, wall_t0=wall, clock=lambda: 2.0)
        with t.span("net_poll"):
            pass
        p = tmp_path / f"{name}.json"
        t.export_perfetto(str(p))
        paths.append(str(p))
    for align in ("none", "wall"):
        mine, theirs = tmerge.merge_traces(paths, align=align), \
            jmerge.merge_traces(paths, align=align)
        assert json.dumps(mine) == json.dumps(theirs)
    pids = {e["args"]["name"]: e["pid"] for e in mine["traceEvents"]
            if e.get("name") == "process_name"}
    assert len(set(pids.values())) == 3
