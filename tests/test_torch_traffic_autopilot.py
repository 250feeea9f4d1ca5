"""PyTorch port, the fleet's pure policy: ``fleet/traffic.py`` and
``fleet/autopilot.py``.

The same seed gives the same ``TrafficPlan`` JSON bytes in both packages;
the same observation trace gives the same ``AutopilotAction`` sequence and
the same ledger bytes, and each package's ``verify_ledger`` accepts the
other's ledger and rejects it with one decision changed. The Matchmaker
places a plan's arrivals on a port fleet as JAX's does on a JAX fleet.
"""

import dataclasses
import json

import numpy as np
import pytest

from bevy_ggrs_tpu.fleet import autopilot as jap
from bevy_ggrs_tpu.fleet import traffic as jtraffic
from bevy_ggrs_tpu.fleet.balancer import FleetBalancer as JBalancer
from bevy_ggrs_tpu.transport.loopback import LoopbackNetwork as JNet
from bevy_ggrs_tpu_torch.fleet import autopilot as tap
from bevy_ggrs_tpu_torch.fleet import traffic as ttraffic
from bevy_ggrs_tpu_torch.fleet.balancer import FleetBalancer
from bevy_ggrs_tpu_torch.transport.loopback import LoopbackNetwork
from bevy_ggrs_tpu_torch.utils.metrics import Metrics
from tests.test_torch_serve_server import inputs_for, make_server, make_synctest

PKGS = {"torch": (tap, ttraffic), "jax": (jap, jtraffic)}

# ---------------------------------------------------------------------------
# Traffic plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,rates", [
    (5, dict(duration=10.0, match_rate=1.5, spectate_rate=0.8, abandon_rate=0.4)),
    (11, dict(duration=3.0, match_rate=40.0, spectate_rate=0.0, abandon_rate=2.0,
              num_players=4)),
    (2024, dict(duration=60.0, match_rate=0.25, spectate_rate=5.0, abandon_rate=0.0,
                max_join_delay=2.5, first_match_id=100)),
])
def test_plan_json_bytes_equal_jax(seed, rates):
    mine = ttraffic.TrafficPlan.generate(seed=seed, **rates)
    theirs = jtraffic.TrafficPlan.generate(seed=seed, **rates)
    assert mine.to_json() == theirs.to_json()
    # Each package reads the other's plan back to the same bytes.
    assert ttraffic.TrafficPlan.from_json(theirs.to_json()).to_json() == mine.to_json()
    assert jtraffic.TrafficPlan.from_json(mine.to_json()).to_json() == theirs.to_json()
    assert len(mine.arrivals()) == len(theirs.arrivals())
    assert mine.horizon() == theirs.horizon()


def run_matchmaker(pkg):
    """A 1.5 s plan of arrivals, abandons and spectators over a two-server
    fleet of ``pkg``; returns what the Matchmaker booked."""
    if pkg == "torch":
        net, bal_cls, traffic = LoopbackNetwork(), FleetBalancer, ttraffic
    else:
        net, bal_cls, traffic = JNet(), JBalancer, jtraffic
    bal = bal_cls(metrics=Metrics())
    servers = []
    for k in range(2):
        srv = make_server(pkg, clock=lambda: net.now, server_id=k)
        bal.register(k, srv)
        servers.append(srv)
    plan = traffic.TrafficPlan.generate(seed=9, duration=1.2, match_rate=5.0,
                                        spectate_rate=2.0, abandon_rate=1.0)
    mm = traffic.Matchmaker(bal, plan, make_session=lambda a: make_synctest(pkg),
                            make_inputs=lambda a: inputs_for(a.input_seed % 32),
                            clock=lambda: net.now, metrics=Metrics())
    for _ in range(100):
        net.advance(1.0 / 60.0)
        mm.pump(net.now)
        for srv in servers:
            srv.run_frame()
    return dict(
        live=sorted(mm.live.items()),
        placements=sorted((m, p.server_id, p.handle.group, p.handle.slot)
                          for m, p in bal.placements.items()),
        counts=(mm.arrivals_seen, mm.admissions_started, mm.admissions_rejected,
                mm.abandons_applied, mm.drained),
        stages=sorted((m, tuple(sorted(t.durations))) for m, t in mm.traces.items()),
    )


def test_matchmaker_books_what_jax_books():
    mine, theirs = run_matchmaker("torch"), run_matchmaker("jax")
    assert mine == theirs
    assert mine["counts"][1] > 0 and mine["live"]


# ---------------------------------------------------------------------------
# The autopilot
# ---------------------------------------------------------------------------


class ScriptedFleet:
    """A fleet adapter replaying one scripted sample sequence with one
    package's ``ServerSample``; every actuation succeeds."""

    def __init__(self, ap, script):
        self.ap, self.script, self.t, self.calls = ap, script, 0, []

    def _now(self):
        return self.script[min(self.t, len(self.script) - 1)]

    def samples(self):
        return {sid: self.ap.ServerSample(server_id=sid, **kw)
                for sid, kw in self._now()[0].items()}

    def placements(self):
        return dict(self._now()[1])

    def pump_migrations(self):
        self.t += 1

    def migrate(self, m, d):
        self.calls.append(("migrate", m, d))
        return True

    def spawn(self):
        self.calls.append(("spawn",))
        return True

    def set_draining(self, s):
        self.calls.append(("drain", s))
        return True

    def retire(self, s):
        self.calls.append(("retire", s))
        return True


def random_script(seed, ticks=80):
    """Heartbeat samples of 2-5 servers under a load that rises, burns
    and falls, with pages, quarantines and speculation permilles drawn
    from ``seed``."""
    rng = np.random.default_rng(seed)
    script, matches = [], {m: int(rng.integers(0, 3)) for m in range(8)}
    for t in range(ticks):
        load = 0.2 + 0.7 * np.sin(np.pi * t / ticks)
        n = 2 + int(3 * load)
        servers = {}
        for sid in range(n):
            active = int(np.clip(round(4 * load + rng.normal(0, 1)), 0, 4))
            servers[sid] = dict(
                slots_active=active, slots_free=4 - active,
                pages=int(rng.random() < 0.15), quarantined=int(rng.random() < 0.05),
                spec_hit_permille=int(rng.integers(0, 1000)),
                spec_waste_permille=int(rng.integers(0, 1000)),
                draining=bool(rng.random() < 0.05))
        if rng.random() < 0.2:
            matches[int(rng.integers(0, 8))] = int(rng.integers(0, n))
        script.append((servers, {m: s for m, s in matches.items() if s < n}))
    return script


CFG = dict(confirm_beats=3, preempt_confirm=2, cooldown_scale_ticks=20,
           cooldown_preempt_ticks=10, min_servers=2, max_servers=4)


def run_autopilot(ap, script):
    fleet = ScriptedFleet(ap, script)
    pilot = ap.FleetAutopilot(fleet, config=ap.AutopilotConfig(**CFG))
    actions = [[dataclasses.asdict(a) for a in pilot.step(t)] for t in range(len(script))]
    return pilot, actions, fleet.calls


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_autopilot_decisions_and_ledgers_equal_jax(seed, tmp_path):
    script = random_script(seed)
    runs = {pkg: run_autopilot(ap, script) for pkg, (ap, _) in PKGS.items()}
    (tp, tacts, tcalls), (jp, jacts, jcalls) = runs["torch"], runs["jax"]
    assert tacts == jacts and tcalls == jcalls
    assert tp.counts == jp.counts
    assert sum(len(a) for a in tacts) > 0
    paths = {}
    for pkg, (pilot, _, _) in runs.items():
        paths[pkg] = str(tmp_path / f"{pkg}.jsonl")
        pilot.export_jsonl(paths[pkg])
    ledger = open(paths["torch"], "rb").read()
    assert ledger == open(paths["jax"], "rb").read()
    # Each package's harness accepts the other's ledger ...
    n = len(tp.ledger)
    assert tap.verify_ledger(paths["jax"]) == (True, n)
    assert jap.verify_ledger(paths["torch"]) == (True, n)
    assert tap._main([paths["jax"]]) == 0
    # ... and rejects it with one decision changed.
    recs = [json.loads(line) for line in ledger.decode().splitlines()]
    hit = next(r for r in recs[1:] if r["actions"])
    hit["actions"][0]["kind"] = "scale_down" if hit["actions"][0]["kind"] != "scale_down" \
        else "scale_up"
    tampered = str(tmp_path / "tampered.jsonl")
    with open(tampered, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    assert tap.verify_ledger(tampered)[0] is False
    assert jap.verify_ledger(tampered)[0] is False
    assert tap._main([tampered]) == 1


def test_heartbeat_scores_and_observation_json_equal_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        kw = dict(server_id=int(rng.integers(0, 8)), slots_active=int(rng.integers(0, 9)),
                  slots_free=int(rng.integers(0, 9)), pages=int(rng.integers(0, 3)),
                  quarantined=int(rng.integers(0, 3)),
                  spec_hit_permille=int(rng.integers(0, 1001)),
                  spec_waste_permille=int(rng.integers(0, 1001)))
        assert tap.heartbeat_score(tap.ServerSample(**kw)) == jap.heartbeat_score(
            jap.ServerSample(**kw))
    o = tap.FleetObservation(tick=3, servers={0: tap.ServerSample(0, 2, 2, pages=1)},
                             placements={9: 0}, backups={9: 1}, front_door="warn")
    j = jap.FleetObservation(tick=3, servers={0: jap.ServerSample(0, 2, 2, pages=1)},
                             placements={9: 0}, backups={9: 1}, front_door="warn")
    assert json.dumps(tap.observation_to_json(o)) == json.dumps(jap.observation_to_json(j))
    assert tap.observation_from_json(jap.observation_to_json(j)) == o
