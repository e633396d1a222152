"""The port's training-fleet simulator against the JAX package's, on the
CPU: FleetSim drives each package's own HeartbeatCoordinator,
FileConsensus / AsyncFileConsensus, ElasticPolicy, RecoveryPolicy and
RetryPolicy on a simulated clock and an in-memory rendezvous, so on one
seed the two must give the same summary and the same event stream, to
the event (pure Python arithmetic on the same seeded numpy draws). The
sweep's table likewise; a real multi-coordinator recording replays
exactly in the port's simulator; and the simfleet verb's training branch
prints what the JAX verb prints.
"""

import json

import pytest

from sparknet_tpu.cli import main as jax_main
from sparknet_tpu.sim import FleetSim as JFleetSim
from sparknet_tpu.sim import sweep as jsweep
from sparknet_tpu_torch.cli import main as port_main
from sparknet_tpu_torch.sim import FleetSim, sweep
from sparknet_tpu_torch.sim.replay import (SequenceSink, record_real,
                                           replay_sim)

# a failure process each, one seed
SCENARIOS = {
    "dead-hosts": dict(hosts=6, rounds=10, consensus="none",
                       deaths={2: 3, 4: 5}, readmit_after=3),
    "fail-rate": dict(hosts=12, rounds=12, consensus="none",
                      chaos="fail_rate=0.05,fail_seed=11,fail_corr=2",
                      recover_after=2),
    "stragglers": dict(hosts=4, rounds=8, consensus="sync",
                       chaos="slow_host=1,slow_s=0.4,slow_host_round=2"),
    "staleness": dict(hosts=4, rounds=8, consensus="async", staleness=2,
                      chaos="slow_worker=2,slow_s=0.5,slow_round=1"),
    "rejoin": dict(hosts=5, rounds=12, consensus="none",
                   chaos="preempt_host=3,preempt_round=2,rejoin_after=3"),
    "quorum-loss": dict(hosts=3, rounds=10, consensus="sync", quorum=3,
                        deaths={1: 2}),
}


class _Sink:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append(dict(fields, event=event))


def _run(cls, **kw):
    sink = _Sink()
    sim = cls(interval_s=0.25, lease_s=1.0, round_s=0.3, seed=5,
              metrics=sink, log_fn=None, **kw)
    return sim.run(), sink.events


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_sim_summary_and_events_equal_jax(scenario):
    kw = SCENARIOS[scenario]
    got, got_events = _run(FleetSim, **kw)
    ref, ref_events = _run(JFleetSim, **kw)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(ref, sort_keys=True, default=str)
    assert json.dumps(got_events, default=str) == \
        json.dumps(ref_events, default=str)
    assert got_events, "the scenario logged nothing"
    if scenario == "quorum-loss":
        assert got["quorum_lost"]
    if scenario in ("dead-hosts", "fail-rate"):
        assert got["evictions"] >= 1


GRID = "hosts=4:8,fail_rate=0.0:0.05,quorum=1"


def test_sweep_table_equals_jax():
    cells = sweep.parse_grid(GRID)
    assert cells == jsweep.parse_grid(GRID)
    kw = dict(rounds=6, interval_s=0.25, lease_s=1.0, round_s=0.3)
    got = [dict(sweep.run_cell(dict(c, **kw)), real_s=0) for c in cells]
    ref = [dict(jsweep.run_cell(dict(c, **kw)), real_s=0) for c in cells]
    assert got == ref
    assert sweep.render_table(got) == jsweep.render_table(ref)
    with pytest.raises(ValueError, match="hostz"):
        sweep.parse_grid("hostz=4")


def test_record_real_replays_exactly(tmp_path):
    rec = record_real(str(tmp_path), hosts=3, rounds=7, kill_round=2,
                      interval_s=0.1, lease_s=0.5, round_s=0.12,
                      readmit_after=3)
    assert rec["sequence"], "the real run recorded no membership"
    match, real_seq, sim_seq = replay_sim(rec)
    assert match, f"replay diverged:\n real {real_seq}\n sim {sim_seq}"
    sink = SequenceSink()
    sink.log("host_evicted", host=2, round=3)
    sink.log("train", iter=1)
    assert sink.sequence == [["host_evicted", 2, 3]]


@pytest.mark.parametrize("argv", [
    ["simfleet", "--hosts", "8", "--rounds", "6", "--chaos",
     "kill_host=2,kill_host_round=2"],
    ["simfleet", "--hosts", "6", "--rounds", "6", "--staleness", "1",
     "--consensus", "async"],
    ["simfleet", "--hosts", "3", "--rounds", "8", "--quorum", "3",
     "--chaos", "kill_host=1,kill_host_round=2", "--consensus", "sync"],
    ["simfleet", "--sweep", "hosts=4:6,quorum=1", "--rounds", "4"],
    ["simfleet", "--chaos", "kill_hots=1"],
], ids=["kill", "async", "quorum", "sweep", "bad-spec"])
def test_simfleet_training_branch_equals_jax(argv, capsys, tmp_path):
    got = port_main(argv + ["--json", str(tmp_path / "port.json")])
    got_io = capsys.readouterr()
    ref = jax_main(argv + ["--json", str(tmp_path / "jax.json")])
    ref_io = capsys.readouterr()
    assert got == ref
    if "--sweep" in argv:       # wall seconds a cell differ run to run
        strip = lambda s: [l.rsplit(None, 2)[0] for l in  # noqa: E731
                           s.strip().splitlines()]
        assert strip(got_io.out) == strip(ref_io.out)
    else:
        assert got_io.out == ref_io.out
        if got == 0 or got == 4:
            assert json.loads((tmp_path / "port.json").read_text()) == \
                json.loads((tmp_path / "jax.json").read_text())
    err = lambda s: [l.split(":", 1)[-1] for l in  # noqa: E731
                     s.strip().splitlines()]
    assert err(got_io.err) == err(ref_io.err)
