"""The port's serving-fleet simulator against the JAX package's, on the
CPU: ServeFleetSim drives the real Router, SLOAutoscaler,
CanaryController and ReplicaMember of each package on a simulated clock
and an in-memory rendezvous, so on one seed the two must give the same
summary and the same event stream, to the event. Exact equality: the
simulator is pure Python arithmetic on the same seeded numpy draws."""

import json

import pytest

from sparknet_tpu.sim import ServeFleetSim as JServeFleetSim
from sparknet_tpu.sim import sweep as jsweep
from sparknet_tpu.cli import main as jax_main
from sparknet_tpu_torch.cli import main as port_main
from sparknet_tpu_torch.sim import ServeFleetSim, sweep

SEED = 3

# the five traces: an arrival shape or a failure process each
SCENARIOS = {
    "flat": dict(trace="flat"),
    "spike": dict(trace="spike", spike_x=6.0, slo_p99_ms=60.0,
                  breach_windows=2),
    "kill": dict(chaos="kill_replica=1,kill_req=40"),
    "churn": dict(die_w=4, rejoin_w=9),
    "canary": dict(canary_w=5, canary_min_requests=8),
}


class _Sink:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append(dict(fields, event=event))


def _run(cls, **kw):
    sink = _Sink()
    sim = cls(replicas=3, windows=14, seed=SEED, trace_sample=0.25,
              tail_ms=40.0, slo_burn=True, burn_scale=0.01, metrics=sink,
              log_fn=None, **kw)
    return sim.run(), sink.events


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_simulator_summary_and_events_equal_jax(scenario):
    kw = SCENARIOS[scenario]
    got, got_events = _run(ServeFleetSim, **kw)
    ref, ref_events = _run(JServeFleetSim, **kw)
    assert got == ref
    assert got_events == ref_events
    # the scenario did what it is named for, and no request was lost
    assert got["lost"] == 0 and got["arrivals"] > 100
    kinds = {e["event"] for e in got_events}
    assert {"route", "serve_trace", "slo_burn"} <= kinds
    if scenario == "kill":
        assert got["evictions"] >= 1 and got["retries"] >= 1
        assert any(e["event"] == "chaos" for e in got_events)
    if scenario == "churn":
        assert got["evictions"] >= 1 and got["readmissions"] >= 1
    if scenario == "canary":
        assert got["canary_rollbacks"] == 1
    if scenario == "spike":
        assert got["grow"] >= 1


SWEEP = "replicas=2:3,trace=flat:spike,kill_replica=1,kill_req=30,windows=8"


def _without_wall(results):
    return [{k: v for k, v in r.items() if k != "real_s"} for r in results]


def test_sweep_results_and_table_equal_jax():
    cells = sweep.parse_serve_grid(SWEEP)
    assert cells == jsweep.parse_serve_grid(SWEEP) and len(cells) == 4
    got = sweep.run_sweep(cells, cell_fn=sweep.run_serve_cell)
    ref = jsweep.run_sweep(cells, cell_fn=jsweep.run_serve_cell)
    assert _without_wall(got) == _without_wall(ref)
    for r in got + ref:
        r["real_s"] = 0.0          # the one wall-clock column
    assert sweep.render_serve_table(got) == jsweep.render_serve_table(ref)
    assert all(r["lost"] == 0 for r in got)


def test_simfleet_verb_sweep_equals_jax_verb(tmp_path, capsys):
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        path = tmp_path / f"{name}.json"
        rc = main(["simfleet", "--serve", "--sweep", SWEEP, "--json",
                   str(path)])
        assert rc == 0, name
        outs[name] = _without_wall(json.load(open(path)))
    assert outs["port"] == outs["jax"]
    capsys.readouterr()


@pytest.mark.parametrize("argv, rc", [
    (["simfleet", "--serve", "--sweep", "replicas=2,bogus=1"], 2),
    (["simfleet", "--serve", "--chaos", "kill_replica=x"], 2),
    (["simfleet", "--serve", "--windows", "6", "--chaos",
      "kill_replica=0,kill_req=10", "--replicas", "1"], None),
])
def test_simfleet_verb_exit_codes_and_errors_equal_jax(argv, rc, capsys):
    got = port_main(argv)
    got_io = capsys.readouterr()
    ref = jax_main(argv)
    ref_io = capsys.readouterr()
    assert got == ref
    if rc is not None:
        assert got == rc
    # the error text after the program's name is the JAX verb's
    strip = lambda s: [line.split(":", 1)[-1] for line in  # noqa: E731
                       s.strip().splitlines()]
    assert strip(got_io.err) == strip(ref_io.err)
    assert got_io.out == ref_io.out


def test_simfleet_training_branch_refuses_naming_a6d(capsys):
    # the training fleet's simulator runs now, as the JAX verb's: the
    # same exit code and the same summary lines
    argv = ["simfleet", "--hosts", "8", "--rounds", "6"]
    assert port_main(argv) == 0
    got = capsys.readouterr()
    assert jax_main(argv) == 0
    ref = capsys.readouterr()
    assert "ROADMAP" not in got.err
    assert got.out == ref.out and got.out.startswith("fleet: 8 hosts")
