"""Request tracing, the chaos grammar, the monitor and the fleet verbs'
flags of the port against the JAX package's, on the CPU.

obs/tracing.py's header codec, head sampler, stage reservoirs and
burn-rate ledger are pure Python in both packages: on the same seeded
inputs they must give the same values and the same events, exactly.
ChaosMonkey.parse must accept and refuse the same specs with the same
texts; ``monitor --once`` must render the same text on one recorded
stream; and every flag of the JAX serving verbs must parse in the port
with the JAX default (``serve --device`` is the one addition).
"""

import argparse
from unittest import mock

import numpy as np
import pytest

from sparknet_tpu.obs import monitor as jmonitor
from sparknet_tpu.obs import tracing as jtracing
from sparknet_tpu.resilience.chaos import ChaosMonkey as JChaosMonkey
from sparknet_tpu.serve import batcher as jbatcher
from sparknet_tpu.serve import server as jserver
from sparknet_tpu.cli import main as jax_main
from sparknet_tpu_torch.obs import monitor as tmonitor
from sparknet_tpu_torch.obs import tracing as ttracing
from sparknet_tpu_torch.resilience.chaos import ChaosMonkey
from sparknet_tpu_torch.serve import batcher as tbatcher
from sparknet_tpu_torch.serve import server as tserver
from sparknet_tpu_torch.cli import main as port_main
from sparknet_tpu_torch.sim import ServeFleetSim
from sparknet_tpu_torch.utils.metrics import MetricsLogger


class _Sink:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append(dict(fields, event=event))


def _stage_dicts(seed, n=40):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        d = {k: float(np.round(rs.exponential(5.0), rs.randint(0, 6)))
             for k in jtracing.STAGES + ("total",)}
        d["net"] = None if rs.rand() < 0.2 else d["net"]
        out.append(d)
    return out


# -- the header codec, the sampler, the reservoirs --------------------------

def test_stage_names_and_headers_equal_jax():
    assert ttracing.STAGES == jtracing.STAGES
    assert ttracing.TRACE_HEADER == jtracing.TRACE_HEADER
    assert ttracing.STAGES_HEADER == jtracing.STAGES_HEADER


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_header_round_trips_equal_jax(seed):
    for d in _stage_dicts(seed):
        enc = ttracing.encode_stages(d)
        assert enc == jtracing.encode_stages(d)
        assert ttracing.decode_stages(enc) == jtracing.decode_stages(enc)
        # the other package decodes what this one encodes, to the
        # header's 3 decimals (half a unit of the last one, and the
        # binary representation of the decimal)
        assert jtracing.decode_stages(enc) == pytest.approx(
            {k: v for k, v in d.items() if v is not None}, abs=5e-4 + 1e-9)
    for junk in (None, "", "junk", "total=5;x=y;;=3", "a=1;b=nan;c=inf"):
        # repr: nan is not equal to itself
        assert repr(ttracing.decode_stages(junk)) == \
            repr(jtracing.decode_stages(junk))


@pytest.mark.parametrize("sample, tail_ms", [
    (1.0, None), (0.25, None), (0.05, 30.0), (0.0, 10.0), (0.5, 0.0)])
def test_sampler_decisions_equal_jax(sample, tail_ms):
    lat = np.random.RandomState(7).exponential(8.0, size=500)
    t = ttracing.TraceSampler(sample=sample, tail_ms=tail_ms)
    j = jtracing.TraceSampler(sample=sample, tail_ms=tail_ms)
    assert [t.decide(float(x)) for x in lat] == \
        [j.decide(float(x)) for x in lat]


@pytest.mark.parametrize("cap", [16, 4096])
def test_reservoir_percentiles_equal_jax(cap):
    t, j = ttracing.StageReservoir(cap=cap), jtracing.StageReservoir(cap=cap)
    for d in _stage_dicts(11, n=200):
        t.add(d)
        j.add(d)
    assert t.snapshot() == j.snapshot()
    assert t.p99() == j.p99()


@pytest.mark.parametrize("bad_share", [0.0, 0.02, 0.4, 1.0])
def test_burn_rate_ledger_evaluations_and_events_equal_jax(bad_share):
    rs = np.random.RandomState(int(bad_share * 100) + 3)
    sinks, logs, ledgers = (_Sink(), _Sink()), ([], []), []
    for mod, sink, lines in zip((ttracing, jtracing), sinks, logs):
        ledgers.append(mod.BurnRateLedger(
            slo_ms=50.0, objective=0.99, scale=0.01, metrics=sink,
            log_fn=lines.append))
    now, outs = 0.0, ([], [])
    for step in range(600):
        now += float(rs.exponential(0.05))
        code = 500 if rs.rand() < bad_share else 200
        lat = float(rs.exponential(20.0))
        for led in ledgers:
            led.record(now, led.good(code, lat))
        if step % 25 == 0:
            for led, out in zip(ledgers, outs):
                out.append(led.evaluate(now))
    assert outs[0] == outs[1]
    assert sinks[0].events == sinks[1].events and sinks[0].events
    assert logs[0] == logs[1]
    assert ledgers[0].snapshot() == ledgers[1].snapshot()


def _request(mod, stamps):
    r = mod.Request({"data": np.zeros((1, 2))}, 1, trace="t1")
    for k, v in stamps.items():
        setattr(r, k, v)
    return r


@pytest.mark.parametrize("missing", [(), ("t_enq",), ("t_dispatch",),
                                     ("t_fwd0", "t_fwd1"), ("t_done",)])
def test_stage_breakdown_telescopes_as_jax(missing):
    stamps = {"t_submit": 10.0, "t_enq": 10.001, "t_dispatch": 10.004,
              "t_fwd0": 10.0045, "t_fwd1": 10.012, "t_done": 10.0125}
    for k in missing:
        stamps[k] = None
    got = tserver.stage_breakdown(_request(tbatcher, stamps), 10.013)
    ref = jserver.stage_breakdown(_request(jbatcher, stamps), 10.013)
    assert got == ref
    assert sum(got[k] for k in ("queue", "batch", "infer", "fulfill")) == \
        pytest.approx(got["total"], abs=1e-9)


# -- the chaos grammar -------------------------------------------------------

CHAOS_SPECS = (
    "kill_replica=1,kill_req=40", "slow_replica=0,slow_ms=50",
    "nan_step=30,io_p=0.02,seed=1", "stall_step=3,stall_s=0.5,"
    "stall_worker=2,stall_repeat=1", "kill_worker=1,kill_round=4,dead_p=0.1",
    "kill_host=2,kill_host_round=5", "preempt_host=1,rejoin_after=3",
    "partition_host=0,partition_round=2", "slow_host=1,slow_host_s=2,"
    "slow_repeat=1", "slow_worker=0,slow_s=1.5,slow_round=2",
    "slow_h2d=0.01", "fail_rate=0.001,fail_seed=7,fail_corr=8",
    "sigterm_round=3", " kill_replica = 2 , kill_req = 5 ", "",
    # refused
    "bogus=1", "kill_replica", "kill_replica=x", "io_p=2", "dead_p=-0.5",
    "nan_step=1,nan_step=2", "slow_ms=5", "kill_req=3", "=3",
    "fail_rate=abc", "seed=1.5",
)


def _chaos_state(m):
    st = {k: v for k, v in vars(m).items()
          if k not in ("_rng", "metrics", "log")}
    rng = m._rng.get_state()
    return st, (rng[0], rng[1].tolist(), rng[2:])


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_parse_equals_jax(spec):
    outcome = []
    for cls in (ChaosMonkey, JChaosMonkey):
        try:
            m = cls.parse(spec)
        except ValueError as e:
            outcome.append(("error", str(e)))
        else:
            outcome.append(("ok", None if m is None else _chaos_state(m)))
    assert outcome[0] == outcome[1], outcome


# -- the monitor -------------------------------------------------------------

def test_monitor_once_renders_the_jax_text(tmp_path):
    """One stream recorded from the port's fleet simulator (routing,
    membership, traces, burn, chaos, canary events) plus a few serving
    replica events: both monitors render the same text."""
    path = str(tmp_path / "fleet.jsonl")
    metrics = MetricsLogger(path)
    ServeFleetSim(replicas=3, windows=10, seed=1, canary_w=4,
                  canary_min_requests=5, chaos="kill_replica=2,kill_req=30",
                  slo_burn=True, burn_scale=0.01, tail_ms=30.0,
                  trace_sample=0.5, metrics=metrics, log_fn=None).run()
    metrics.log("serve_batch", size=3, requests=2, bucket=4, fill=0.75,
                queue_depth=1, wait_ms=1.2, infer_ms=4.5, iter=7)
    metrics.log("serve_request", latency_ms=6.1, wait_ms=1.2, rows=1,
                bucket=4)
    metrics.log("serve_reload", iter=8, from_iter=7, model="m", ms=3.0)
    metrics.log("serve_summary", requests=2, rows=3, batches=1, rejects=0,
                reloads=1, rps=1.5, latency_ms_p50=6.0, latency_ms_p95=6.1,
                latency_ms_p99=6.1, batch_fill=0.75, uptime_s=2.0,
                drained=True)
    metrics.close()
    text = []
    for mod in (tmonitor, jmonitor):
        buf = []
        state = mod.monitor_file(path, once=True, out=buf.append,
                                 clear=False)
        assert state.events > 50
        text.append("\n".join(buf))
    assert text[0] == text[1]
    for part in ("routing:", "canary:", "tracing:", "slo burn:",
                 "membership:", "chaos injections 1"):
        assert part in text[0]


def test_monitor_verb_exit_codes_equal_jax(tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for argv in (["monitor", str(tmp_path / "none.jsonl"), "--once"],
                 ["monitor", str(empty), "--once"]):
        assert port_main(argv) == jax_main(argv) == 2
    capsys.readouterr()


# -- the fleet verbs' flags --------------------------------------------------

class _Parsed(Exception):
    pass


def _verb_parser(main, verb):
    """The argparse subparser of ``verb`` as ``main`` builds it."""
    box = {}

    def grab(self, args=None, namespace=None):
        box["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            main([verb])
    sub = next(a for a in box["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[verb]


def _flags(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        key = tuple(sorted(a.option_strings)) or (a.dest,)
        out[key] = dict(dest=a.dest, default=a.default, nargs=a.nargs,
                        const=a.const, required=a.required,
                        choices=None if a.choices is None
                        else list(a.choices),
                        type=getattr(a.type, "__name__", a.type),
                        kind=type(a).__name__,
                        allow=list(getattr(a, "allow", ())))
    return out


@pytest.mark.parametrize("verb", ["serve", "route", "serve-bench",
                                  "simfleet", "monitor"])
def test_fleet_verb_flags_parse_with_the_jax_defaults(verb):
    port, ref = (_flags(_verb_parser(m, verb)) for m in (port_main,
                                                          jax_main))
    extra = set(port) - set(ref)
    assert extra == ({("--device",)} if verb == "serve" else set())
    assert set(ref) <= set(port)
    for key, spec in ref.items():
        got = port[key]
        assert {k: v for k, v in got.items() if k != "allow"} == \
            {k: v for k, v in spec.items() if k != "allow"}, (verb, key)
    if verb == "serve":
        assert port[("--device",)]["default"] == "cuda"


def test_train_and_cifar_refuse_chaos_naming_a6d(capsys):
    # --chaos is the JAX verbs' in training too now: a spec parses as in
    # the JAX package, and a typo'd one ends the run naming its token
    # before any solver is built
    for verb in ("train", "cifar"):
        argv = [verb, "--chaos", "kill_replicaa=0", "--device", "cpu"]
        if verb == "train":
            argv += ["--solver", "none.prototxt"]
        with pytest.raises(SystemExit) as e:
            port_main(argv)
        assert "kill_replicaa" in str(e.value.code)
        assert "ROADMAP" not in capsys.readouterr().err


def test_serve_refuses_a_bad_chaos_spec_as_jax(tmp_path, capsys):
    argv = ["serve", "--prefix", str(tmp_path / "none"), "--chaos",
            "kill_replica=x"]
    assert port_main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert jax_main(argv) == 2
    ref = capsys.readouterr().err
    assert err.split("error:", 1)[1] == ref.split("error:", 1)[1]

