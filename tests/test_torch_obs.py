"""The port's observability (sparknet_tpu_torch/obs, utils/metrics.py)
against the JAX package's: the metrics stream of both train verbs, the
report verb's text, worker divergence and comms of the slot solvers,
the health detectors, the event registry, the span tracer and the
torch.profiler block, and the logger's thread safety."""

import collections
import contextlib
import io
import json
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from sparknet_tpu import cli as jcli
from sparknet_tpu.models import zoo as jzoo
from sparknet_tpu.obs import comms as jcomms
from sparknet_tpu.obs import event_schema as jschema
from sparknet_tpu.obs.health import HealthMonitor as JHealth
from sparknet_tpu.obs.stepstats import percentiles as jpercentiles
from sparknet_tpu.parallel import (DataParallelSolver as JDataParallel,
                                   LocalSGDSolver as JLocalSGD, make_mesh)
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.models import zoo as tzoo
from sparknet_tpu_torch.obs import comms, event_schema
from sparknet_tpu_torch.obs.health import HealthMonitor
from sparknet_tpu_torch.obs.stepstats import percentiles
from sparknet_tpu_torch.obs.trace import TorchProfiler, Tracer
from sparknet_tpu_torch.parallel import DataParallelSolver, LocalSGDSolver
from sparknet_tpu_torch.proto import Message, text_format
from sparknet_tpu_torch.utils.metrics import MetricsLogger

PORT = os.path.join(os.path.dirname(__file__), os.pardir,
                    "sparknet_tpu_torch")
# fields one package writes and the other cannot: the JAX package's
# executable-cache count (the port has no jit), and its bucketed
# gradient allreduce's overlap split (parallel/overlap.py; the port's
# slots share one card and register the whole-tree collective)
NOT_IN_PORT = {("memstats", "compile_cache"),
               ("memstats", "compile_cache_grew"),
               ("comms", "overlapped_bytes_per_step"),
               ("comms", "exposed_bytes_per_step"),
               ("comms", "overlap_ceiling")}


class _Sink:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append(dict(fields, event=event))


# -- the logger ------------------------------------------------------------

def test_metrics_logger_is_thread_safe(tmp_path):
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(str(path))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(tag):
            for i in range(1000):
                log.log("span", name=tag, i=i, pad="x" * 64)
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    log.close()
    log.log("after_close")               # dropped, never raises
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) == 2000
    for tag in ("a", "b"):
        assert [r["i"] for r in recs if r["name"] == tag] == \
            list(range(1000))


def test_metrics_logger_encodes_tensors_and_dtypes():
    buf = io.StringIO()
    with MetricsLogger(stream=buf) as log:
        log.log("x", scalar=torch.tensor(2.5), small=torch.arange(3),
                big=torch.zeros(100), dtype=torch.bfloat16,
                arr=np.float32(1.5), path=os.path)
    rec = json.loads(buf.getvalue())
    assert rec["scalar"] == 2.5 and rec["small"] == [0, 1, 2]
    assert rec["big"] == {"shape": [100], "dtype": "torch.float32",
                          "summary": "array too large; elided"}
    assert rec["dtype"] == "torch.bfloat16" and rec["arr"] == 1.5


# -- the train verbs' streams ---------------------------------------------

def _solver_file(tmp_path):
    sp = Message("SolverParameter", base_lr=0.01, momentum=0.9,
                 lr_policy="fixed", display=1, max_iter=6, snapshot=2,
                 snapshot_prefix=str(tmp_path / "snap" / "s"),
                 random_seed=1, test_iter=[1], test_interval=3)
    sp.net_param = tzoo.cifar10_full(batch_size=4)
    path = tmp_path / "solver.prototxt"
    text_format.dump(sp, str(path))
    return str(path)


def _fields(path):
    out = collections.defaultdict(set)
    for line in open(path):
        rec = json.loads(line)
        out[rec["event"]].update(k for k in rec if k not in ("event", "t"))
    return out


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Both train verbs on one solver (cifar10_full b4, synthetic feed,
    display 1, a test every 3 iterations, snapshots every 2 kept 2),
    single and --strategy dp over 2 workers; -> {(package, strategy):
    metrics path}."""
    out = {}
    for strategy in ("single", "dp"):
        for pkg, main, extra in (("jax", jcli.main, []),
                                 ("port", cli.main, ["--device", "cpu"])):
            d = tmp_path_factory.mktemp(f"{pkg}_{strategy}")
            m = str(d / "m.jsonl")
            argv = ["train", "--solver", _solver_file(d), "--metrics", m,
                    "--keep", "2"] + extra
            if strategy == "dp":
                argv += ["--strategy", "dp", "--mesh", "data=2"]
            with contextlib.redirect_stdout(io.StringIO()):
                assert main(argv) == 0
            out[pkg, strategy] = m
    return out


@pytest.mark.parametrize("strategy", ["single", "dp"])
def test_train_verbs_write_the_same_events_and_fields(streams, strategy):
    j = _fields(streams["jax", strategy])
    t = _fields(streams["port", strategy])
    assert set(t) == set(j)
    for ev in j:
        want = {f for f in j[ev] if (ev, f) not in NOT_IN_PORT}
        assert t[ev] == want, ev
    if strategy == "dp":
        assert {"divergence", "comms"} <= set(t)
    kinds = collections.Counter(json.loads(line)["event"]
                                for line in open(streams["port", strategy]))
    assert kinds["train"] == 6 and kinds["test"] == 2
    assert kinds["checkpoint"] == 3 and kinds["step_summary"] == 1


def test_checkpoint_events_keep_and_drop_as_in_jax(streams):
    def ck(path):
        return [(e["iter"], e["kept"], e["dropped"])
                for e in map(json.loads, open(path))
                if e["event"] == "checkpoint"]
    assert ck(streams["port", "single"]) == ck(streams["jax", "single"]) \
        == [(2, 1, 0), (4, 2, 0), (6, 2, 1)]


def _report(main, path, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["report", path, *extra])
    return rc, buf.getvalue()


@pytest.mark.parametrize("strategy", ["single", "dp"])
def test_report_prints_the_jax_reports_text(streams, strategy):
    path = streams["port", strategy]
    jrc, jtext = _report(jcli.main, path)
    rc, text = _report(cli.main, path)
    assert rc == jrc == 0
    assert text == jtext
    assert "step times" in text and "loss curve" in text
    rc, js = _report(cli.main, path, "--format", "json")
    assert rc == 0 and json.loads(js) == json.loads(
        _report(jcli.main, path, "--format", "json")[1])


def test_report_and_trace_verbs_on_bad_input(tmp_path, capsys):
    assert cli.main(["report", str(tmp_path / "none.jsonl")]) == 2
    assert "error" in capsys.readouterr().err
    (tmp_path / "junk.jsonl").write_text("not json\n")
    assert cli.main(["trace", str(tmp_path / "junk.jsonl")]) == 2


def test_trace_verb_reads_the_port_stream(streams, tmp_path, capsys):
    chrome = str(tmp_path / "fleet.json")
    path = streams["port", "single"]
    assert cli.main(["trace", path, "--chrome", chrome]) == 0
    assert jcli.main(["trace", path, "--chrome",
                      str(tmp_path / "j.json")]) == 0
    ours, theirs = (json.load(open(p)) for p in
                    (chrome, str(tmp_path / "j.json")))
    assert len(ours["traceEvents"]) == len(theirs["traceEvents"]) > 0
    capsys.readouterr()
    assert cli.main(["trace", path]) == 0
    assert "fleet: 1 track(s)" in capsys.readouterr().out


# -- the slot solvers' divergence and comms -------------------------------

B, TAU = 4, 3


def _sp(message):
    return message("SolverParameter", base_lr=0.02, lr_policy="fixed",
                   momentum=0.9, weight_decay=0.004, random_seed=11,
                   display=0)


def _batches(workers, seed, tau):
    rs = np.random.RandomState(seed)
    return {"data": rs.randn(tau, workers * B, 3, 32, 32).astype(np.float32),
            "label": rs.randint(0, 10, (tau, workers * B)).astype(np.int32)}


def _events(sink, kind):
    return [e for e in sink.events if e["event"] == kind]


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol)


@pytest.mark.parametrize("strategy", ["local_sgd", "dp"])
def test_slot_divergence_and_comms_match_jax(tmp_path, strategy,
                                             monkeypatch):
    """One LocalSGD round (tau 3) or one DP step over 2 workers from the
    same weights: the divergence event's distances within 1e-3 (the
    params themselves agree to ~1e-4 of their change; the distances are
    differences of them), the worker losses within 1e-5, the registered
    collective bytes exactly (the JAX DP solver's whole-tree allreduce,
    SPARKNET_OVERLAP=off, is the one the port registers)."""
    monkeypatch.setenv("SPARKNET_OVERLAP", "off")
    W = 2
    jsink, tsink = _Sink(), _Sink()
    if strategy == "local_sgd":
        js = JLocalSGD(_sp(JMessage), mesh=make_mesh({"data": W}), tau=TAU,
                       net_param=jzoo.cifar10_full(batch_size=B),
                       log_fn=None, metrics=jsink)
        ts = LocalSGDSolver(_sp(Message), workers=W, tau=TAU,
                            net_param=tzoo.cifar10_full(batch_size=B),
                            device="cpu", log_fn=None, metrics=tsink)
    else:
        js = JDataParallel(_sp(JMessage), mesh=make_mesh({"data": W}),
                           net_param=jzoo.cifar10_full(batch_size=W * B),
                           log_fn=None, metrics=jsink)
        ts = DataParallelSolver(_sp(Message), workers=W,
                                net_param=tzoo.cifar10_full(
                                    batch_size=W * B),
                                device="cpu", log_fn=None, metrics=tsink)
    _, state = js.snapshot(str(tmp_path / "start"))
    ts.restore(state)
    for seed in (50, 51):
        if strategy == "local_sgd":
            b = _batches(W, seed, TAU)
            np.testing.assert_allclose(float(ts.train_round(b)),
                                       float(js.train_round(b)), rtol=1e-5)
        else:
            b = {k: v[0] for k, v in _batches(W, seed, 1).items()}
            np.testing.assert_allclose(float(ts.train_step(b)),
                                       float(js.train_step(b)), rtol=1e-5)
    jd, td = _events(jsink, "divergence"), _events(tsink, "divergence")
    assert len(td) == len(jd) == 2
    for t, j in zip(td, jd):
        assert set(t) == set(j)
        assert t["kind"] == j["kind"] and t["iter"] == j["iter"]
        assert t["live"] == j["live"] == W
        _close(t["per_worker"] + [t["mean"], t["max"], t["update_norm"]],
               j["per_worker"] + [j["mean"], j["max"], j["update_norm"]],
               1e-3)
        assert [x[0] for x in t["top_layers"]] == \
            [x[0] for x in j["top_layers"]]
        _close(t["worker_loss"], j["worker_loss"], 1e-5)
        assert t["mean"] > 0
    ts.close()
    js.close()
    jc, tc = _events(jsink, "comms"), _events(tsink, "comms")
    assert tc and jc
    assert tc[0]["collective_bytes_per_step"] == \
        jc[0]["collective_bytes_per_step"] > 0
    assert tc[0]["collectives"] == jc[0]["collectives"]
    assert [e["event"] for e in tsink.events].count("step_summary") == 1


@pytest.mark.parametrize("nbytes,n", [(0, 4), (100, 1), (1000, 2),
                                      (12345, 4), (2 ** 31, 8)])
def test_comms_formulas_equal_the_jax_packages(nbytes, n):
    assert comms.ring_allreduce_bytes(nbytes, n) == \
        jcomms.ring_allreduce_bytes(nbytes, n)
    assert comms.broadcast_collect_bytes(nbytes, n) == \
        jcomms.broadcast_collect_bytes(nbytes, n)


def test_tree_bytes_counts_tensors_and_arrays():
    tree = {"a": [torch.zeros(3, 4), torch.zeros(2, dtype=torch.bfloat16)],
            "b": [[np.zeros(5, np.float64)]]}
    assert comms.tree_bytes(tree) == 48 + 4 + 40


# -- health, percentiles, schema -------------------------------------------

def test_health_alarms_equal_the_jax_packages():
    """The same per-slot losses, latencies and divergence summaries into
    both packages' HealthMonitor: the same alarms in the same order."""
    rs = np.random.RandomState(7)
    js, ts = _Sink(), _Sink()
    kw = dict(straggler_factor=1.5, loss_skew_factor=3.0, div_abs=0.5,
              trend_rounds=3, trend_factor=1.5, cooldown=2)
    jh = JHealth(js, log_fn=None, **kw)
    th = HealthMonitor(ts, log_fn=None, **kw)
    for r in range(40):
        losses = 2.0 + 0.01 * rs.randn(4)
        if 10 <= r < 14:
            losses[2] += 2.0                      # a skewed slot
        if r == 20:
            losses[1] = float("nan")              # one slot blows up
        lat = [1.0, 1.0, 1.0, 1.0 + (3.0 if 25 <= r < 28 else 0.0)]
        div = {"mean": 0.01 * 1.3 ** max(0, r - 30), "max": 0.02,
               "rel": 0.1}
        for h in (jh, th):
            h.observe_round(r * 10, round_idx=r, worker_losses=losses,
                            latencies=lat, divergence=div)
    assert ts.events == js.events
    assert len(ts.events) >= 4
    assert th.summary() == jh.summary()


def test_percentiles_equal_the_jax_packages():
    vals = np.random.RandomState(3).rand(101) * 50
    assert percentiles(vals) == jpercentiles(vals)
    assert percentiles([]) == jpercentiles([]) == {}


def test_event_registry_is_the_jax_packages_and_covers_the_port():
    assert event_schema.EVENTS == jschema.EVENTS
    names = set()
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                names.update(re.findall(
                    r"""(?:metrics|sink)\.log\(\s*["']([a-z_]+)["']""",
                    src))
    assert {"train", "test", "step", "checkpoint", "divergence",
            "watchdog", "recovery", "span", "round"} <= names
    assert names <= set(event_schema.EVENTS), \
        sorted(names - set(event_schema.EVENTS))


# -- spans and the profiler block -----------------------------------------

def test_tracer_nests_spans_and_exports_chrome(tmp_path):
    sink = _Sink()
    tr = Tracer(sink)
    with tr.span("outer", a=1) as attrs:
        with tr.span("inner"):
            pass
        attrs["n"] = 2
    tr.instant("mark")
    spans = _events(sink, "span")
    assert [s["name"] for s in spans] == ["inner", "outer", "mark"]
    assert spans[0]["parent"] == "outer" and spans[0]["depth"] == 1
    assert spans[1]["n"] == 2 and spans[1]["depth"] == 0
    doc = json.load(open(tr.export_chrome(str(tmp_path / "s.json"))))
    assert [e["name"] for e in doc["traceEvents"]] == \
        ["inner", "outer", "mark"]


def test_torch_profiler_traces_one_block(tmp_path):
    prof = TorchProfiler(str(tmp_path / "p"), log=None, cuda=False)
    assert not prof.maybe_start(0, 1000)       # the first block is skipped
    assert prof.maybe_start(1, 1000)
    torch.ones(64, 64) @ torch.ones(64, 64)
    prof.maybe_stop()
    assert prof.done and not prof.maybe_start(2, 1000)
    doc = json.load(open(tmp_path / "p" / TorchProfiler.TRACE_NAME))
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


# -- the apps' and the lm verb's streams -------------------------------------

def _within_schema(path):
    """Every event of a stream is registered, and a closed event carries
    no field its registry entry lacks; -> the events."""
    events = [json.loads(line) for line in open(path)]
    for e in events:
        spec = event_schema.EVENTS[e["event"]]
        if not spec["open"]:
            extra = set(e) - {"event", "t"} - set(spec["fields"])
            assert not extra, (e["event"], extra)
    return events


def test_cifar_imagenet_and_lm_verbs_write_registered_streams(tmp_path,
                                                              monkeypatch):
    """--metrics on the cifar verb (local SGD over 2 slots, with a
    --health-div-abs low enough to alarm), the imagenet verb and the lm
    verb: each stream is registered, and carries the app's round and
    test events, the slots' divergence and the health alarm."""
    runs = {
        "cifar": ["cifar", "--device", "cpu", "--workers", "2", "--tau",
                  "1", "--rounds", "2", "--test-every", "1",
                  "--health-div-abs", "1e-12", "--remat", "full"],
        "imagenet": ["imagenet", "--device", "cpu", "--workers", "2",
                     "--tau", "1", "--batch", "1", "--classes", "10",
                     "--rounds", "1", "--test-every", "1"],
        "lm": ["lm", "--device", "cpu", "--vocab", "32", "--seq-len", "16",
               "--batch", "2", "--d-model", "16", "--layers", "1",
               "--heads", "2", "--display", "1", "--steps", "2"]}
    kinds = {}
    monkeypatch.setenv("SPARKNET_REMAT", "none")   # undone at the end
    for name, argv in runs.items():
        path = str(tmp_path / f"{name}.jsonl")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(argv + ["--metrics", path]) == 0
        kinds[name] = collections.Counter(
            e["event"] for e in _within_schema(path))
        monkeypatch.setenv("SPARKNET_REMAT", "none")
    for app, rounds in (("cifar", 2), ("imagenet", 1)):
        assert kinds[app]["round"] == rounds
        assert kinds[app]["test"] >= rounds
        assert kinds[app]["divergence"] == rounds
        assert kinds[app]["step_summary"] == 1
    assert kinds["cifar"]["health"] >= 1
    assert kinds["lm"]["train"] == 2 and kinds["lm"]["summary"] == 1
    assert kinds["lm"]["step_summary"] == 1


def test_timers_and_the_profiler_context(tmp_path):
    """utils/timing.py: Timer accumulates across start/stop (its sync
    argument waits for a tensor's device), StepTimer's rolling rates
    equal the JAX package's on the same ticks, and torch_profile writes
    its Chrome trace."""
    from sparknet_tpu.utils.timing import StepTimer as JStepTimer
    from sparknet_tpu_torch.utils.timing import StepTimer, Timer, \
        torch_profile
    t = Timer().start()
    t.stop(sync=torch.ones(3))
    t.start().stop()
    assert t.seconds() >= 0 and t.milliseconds() == t.seconds() * 1e3
    ours, theirs = StepTimer(window=3), JStepTimer(window=3)
    for st in (ours, theirs):
        st._last = 0.0
        for i, dt in enumerate((0.1, 0.2, 0.3, 0.4)):
            st.times.append((dt, 8 * (i + 1)))
            st.times = st.times[-st.window:]
    assert ours.step_ms() == theirs.step_ms()
    assert ours.images_per_sec() == theirs.images_per_sec()
    with torch_profile(str(tmp_path / "p"), cuda=False):
        torch.ones(32, 32) @ torch.ones(32, 32)
    doc = json.load(open(tmp_path / "p" / "torch.trace.json"))
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
