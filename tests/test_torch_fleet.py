"""The port's serving fleet (serve/fleet.py, resilience/heartbeat.py and
elastic.py) against the JAX package's, on the CPU.

- Leases: a lease directory written by one package's
  HeartbeatCoordinator is read by the other's fresh_leases and Router,
  and a drain order written by one package's router reaches the other's
  replica — a JAX replica and a port router share one rendezvous.
- Decisions: Router, SLOAutoscaler and CanaryController fed the same
  sequence (leases, a dead replica, a faulty canary, a load spike) on
  each package's simulated clock make the same decisions and log the
  same events, exactly (pure Python on both sides).
- End to end over HTTP: two port replicas of a tiny GoogLeNet-shaped net
  (an across-channel LRN at pool1/norm1 and conv2/norm2) in threads, the
  port router and run_loadgen. Answers through the router are within
  1e-4 of the JAX ServeEngine's on the same snapshot (rtol 1e-4, atol
  1e-5 of the largest logit: f32 on both sides, XLA:CPU and PyTorch sum
  in different orders); each request's stages telescope to the router's
  total (to the 3-decimal rounding of the five stage fields); one trace
  id spans a retry; a replica that SIGKILLs itself mid-load (``serve
  --chaos kill_replica``, a subprocess) fails over with 0 errors.

Leases are short (0.3 s; 1 s over HTTP, where a replica's beat thread
shares its process with the forwards and a loaded machine's scheduler)
so the whole file stays within seconds.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from sparknet_tpu.obs import tracing as jtracing
from sparknet_tpu.resilience import heartbeat as jheartbeat
from sparknet_tpu.serve import ServeEngine as JEngine
from sparknet_tpu.serve import fleet as jfleet
from sparknet_tpu import sim as jsim
from sparknet_tpu_torch.graph import TEST, CompiledNet
from sparknet_tpu_torch.models import dsl as tdsl, zoo as tzoo
from sparknet_tpu_torch.obs import tracing as ttracing
from sparknet_tpu_torch.resilience import heartbeat as theartbeat
from sparknet_tpu_torch.resilience import save_model_snapshot
from sparknet_tpu_torch.serve import (Batcher, ReplicaMember, Router,
                                      ServeEngine, route_http, run_loadgen,
                                      serve_http)
from sparknet_tpu_torch.serve import fleet as tfleet
from sparknet_tpu_torch import sim as tsim
from sparknet_tpu_torch.utils.metrics import MetricsLogger
from tests.test_torch_compiler import mini_googlenet

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
OUT = "loss3/classifier"
LEASE, BEAT = 0.3, 0.1
HTTP_LEASE, HTTP_BEAT = 1.0, 0.2


class _Sink:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append(dict(fields, event=event))

    def of(self, kind):
        return [e for e in self.events if e["event"] == kind]


class _FakeBatcher:
    def __init__(self, depth=0):
        self.depth_ = depth

    def depth(self):
        return self.depth_

    def pending(self):
        return self.depth_

    def draining(self):
        return False


class _FakeEngine:
    def __init__(self, sha):
        self.sha = sha

    def status(self):
        return {"sha": self.sha, "iter": 7}


# -- leases across the packages ----------------------------------------------

def _payload(r):
    return lambda: {"url": f"http://127.0.0.1:1/{r}", "queue_depth": r,
                    "in_flight": 0, "draining": False, "sha": f"sha{r}",
                    "iter": 3}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_leases_are_read_by_the_other_package(tmp_path, writer):
    hb_w, hb_r = (jheartbeat, theartbeat) if writer == "jax" else \
        (theartbeat, jheartbeat)
    fl_r = tfleet if writer == "jax" else jfleet
    for r in range(2):
        hb_w.HeartbeatCoordinator(
            str(tmp_path), host=r, n_hosts=2, interval_s=BEAT,
            lease_s=LEASE, log_fn=None, payload_fn=_payload(r)).beat()
    leases = hb_r.fresh_leases(str(tmp_path), LEASE)
    assert sorted(leases) == [0, 1]
    assert leases[1]["url"] == "http://127.0.0.1:1/1"
    assert leases[1]["sha"] == "sha1" and leases[1]["queue_depth"] == 1
    router = fl_r.Router(str(tmp_path), replicas=2, lease_s=LEASE,
                         log_fn=None)
    assert sorted(router.poll()) == [0, 1]
    st = router.status()
    assert st["replicas"]["0"]["url"] == "http://127.0.0.1:1/0"
    # least queue depth: replica 0
    assert router.pick()[0] == 0
    # the reader's clock ages the writer's lease past lease_s: evicted
    time.sleep(LEASE * 2.5)
    assert router.poll() == [] or router.quorum_lost
    assert hb_r.fresh_leases(str(tmp_path), LEASE) == {}


@pytest.mark.parametrize("router_pkg", ["jax", "port"])
def test_a_drain_order_reaches_the_other_packages_replica(tmp_path,
                                                          router_pkg):
    fl_router, fl_member = (jfleet, tfleet) if router_pkg == "jax" else \
        (tfleet, jfleet)
    members = [fl_member.ReplicaMember(
        str(tmp_path), r, replicas=2, engine=_FakeEngine("a"),
        batcher=_FakeBatcher(), url=f"http://x/{r}", interval_s=BEAT,
        lease_s=LEASE, log_fn=None) for r in range(2)]
    for m in members:
        m.coord.beat()
    router = fl_router.Router(str(tmp_path), replicas=2, lease_s=LEASE,
                              log_fn=None)
    router.poll()
    assert router.request_drain() == 1       # the highest replica
    members[1].coord.beat()
    assert members[1].drain_event.is_set()
    assert not members[0].drain_event.is_set()
    router.poll()
    assert router.pick()[0] == 0              # a draining replica is skipped


# -- the same decisions on the same sequence ---------------------------------

def _decisions(fleet, sim, tracing):
    """Three leased replicas on a simulated clock; replica 2 dies at
    window 3 and rejoins at 9, replica 1 reloads a faulty sha at window
    5 (the canary), a load spike over windows 11-14; the router's window
    loop as route_http runs it. Returns everything it decided and
    logged."""
    clock = sim.SimClock()
    d = sim.MemDir(clock)
    sink, lines = _Sink(), []
    engines = [_FakeEngine("sha-base") for _ in range(3)]
    members = [fleet.ReplicaMember(
        d.root, r, replicas=3, engine=engines[r], batcher=_FakeBatcher(r),
        url=f"sim://replica/{r}", interval_s=0.2, lease_s=1.0,
        metrics=sink, log_fn=lines.append, clock=clock, dirops=d)
        for r in range(3)]
    rs = np.random.RandomState(5)
    state = {"spike": False}

    def post(url, body, timeout, headers=None):
        r = int(url.rsplit("/", 1)[1])
        lat = float(rs.exponential(80.0 if state["spike"] else 10.0))
        if engines[r].sha == "sha-canary" and rs.rand() < 0.8:
            return 500, b"{}", lat, None
        q = round(lat * 0.3, 3)
        return 200, b"{}", lat, {"total": round(lat * 0.9, 3), "queue": q,
                                 "batch": 0.0, "infer": round(
                                     lat * 0.9 - q, 3), "fulfill": 0.0}

    canary = fleet.CanaryController(pct=25.0, min_requests=6,
                                    metrics=sink, log_fn=lines.append)
    auto = fleet.SLOAutoscaler(p99_ms=150.0, depth=8, windows=2,
                               idle_windows=3, max_replicas=4,
                               metrics=sink, log_fn=lines.append)
    router = fleet.Router(
        d.root, replicas=3, lease_s=1.0, canary=canary, metrics=sink,
        log_fn=lines.append, clock=clock, dirops=d, post_fn=post,
        tracer=tracing.TraceSampler(sample=0.5, tail_ms=120.0),
        slo=tracing.BurnRateLedger(slo_ms=100.0, objective=0.99,
                                   scale=0.001, metrics=sink,
                                   log_fn=lines.append))
    out = []
    for w in range(18):
        state["spike"] = 11 <= w <= 14
        if w == 5:
            engines[1].sha = "sha-canary"
        for r, m in enumerate(members):
            if not (r == 2 and 3 <= w < 9):
                m.coord.beat()
        clock.sleep(0.5)
        live = router.poll()
        codes = [router.dispatch(b"{}")[0]
                 for _ in range(0 if w in (16, 17) else 24)]
        stats = router.window_stats()
        decision = auto.observe(stats, live=router.policy.live_count())
        drained = router.request_drain() if decision == "shrink" else None
        verdict = canary.evaluate()
        out.append((w, sorted(live), codes, stats, decision, drained,
                    verdict, canary.summary()))
    return out, sink.events, lines, router.stats_snapshot()


def test_router_autoscaler_canary_decide_and_log_as_jax():
    got = _decisions(tfleet, tsim, ttracing)
    ref = _decisions(jfleet, jsim, jtracing)
    for g, r, what in zip(got, ref, ("windows", "events", "log lines",
                                     "stats")):
        assert g == r, what
    windows, events, _, stats = got
    kinds = {e["event"] for e in events}
    assert {"route", "scale", "canary", "eviction", "readmission",
            "serve_trace", "slo_burn"} <= kinds
    assert any(w[4] == "grow" for w in windows)
    assert stats["errors"] > 0 and stats["retries"] == 0
    assert [e["action"] for e in events if e["event"] == "canary"][:2] == \
        ["start", "rollback"]


# -- end to end over HTTP ----------------------------------------------------

def _port_snapshot(prefix, seed=5):
    net = CompiledNet(mini_googlenet(tdsl, tzoo), TEST, device="cpu")
    params, state = net.init(torch.Generator().manual_seed(seed))
    save_model_snapshot(net, params, prefix, iter=0, state=state)


class _Replica:
    """A port replica in a thread: engine, batcher, lease, HTTP."""

    def __init__(self, prefix, fleet_dir, r, n, metrics_path):
        self.metrics = MetricsLogger(metrics_path)
        self.engine = ServeEngine(prefix, max_batch=2, device="cpu",
                                  metrics=self.metrics, log_fn=None)
        self.engine.load()
        self.batcher = Batcher(max_batch=2, max_wait_s=0.002,
                               queue_limit=64, metrics=self.metrics)
        self.member = ReplicaMember(fleet_dir, r, replicas=n,
                                    engine=self.engine, batcher=self.batcher,
                                    interval_s=HTTP_BEAT, lease_s=HTTP_LEASE,
                                    metrics=self.metrics, log_fn=None)
        self.stop = threading.Event()
        self.rc, urls, up = [], [], threading.Event()
        self.thread = threading.Thread(target=lambda: self.rc.append(
            serve_http(self.engine, self.batcher, port=0,
                       metrics=self.metrics, stop_event=self.stop,
                       member=self.member, replica=r,
                       tracer=ttracing.TraceSampler(), log_fn=None,
                       on_listen=lambda u: (urls.append(u), up.set()))),
            daemon=True)
        self.thread.start()
        assert up.wait(60)
        self.url = urls[0]

    def close(self):
        self.stop.set()
        self.thread.join(30)
        self.metrics.close()
        return self.rc


class _RouterThread:
    def __init__(self, fleet_dir, n, metrics_path, **kw):
        self.metrics = MetricsLogger(metrics_path)
        self.router = Router(fleet_dir, replicas=n, lease_s=HTTP_LEASE,
                             metrics=self.metrics, log_fn=None,
                             tracer=ttracing.TraceSampler(), **kw)
        self.stop = threading.Event()
        lines, up = [], threading.Event()

        def log(msg):
            lines.append(msg)
            if "listening on" in msg:
                up.set()

        self.thread = threading.Thread(target=lambda: route_http(
            self.router, port=0, window_s=HTTP_BEAT, stop_event=self.stop,
            log_fn=log), daemon=True)
        self.thread.start()
        assert up.wait(30)
        self.url = re.search(r"listening on (\S+)", lines[-1]).group(1)

    def close(self):
        self.stop.set()
        self.thread.join(30)
        self.metrics.close()


def _post(url, rows):
    req = urllib.request.Request(
        url + "/predict", data=json.dumps({"data": rows.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read()), dict(r.headers)


def _events(path, kind):
    return [e for e in map(json.loads, open(path)) if e["event"] == kind]


def _wait_live(router, n, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if len(router.policy.live()) >= n and len(router.status()[
                "replicas"]) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"fewer than {n} live replicas: "
                         f"{router.status()}")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    prefix = str(d / "snap")
    _port_snapshot(prefix)
    fleet_dir = str(d / "rendezvous")
    reps = [_Replica(prefix, fleet_dir, r, 2, str(d / f"r{r}.jsonl"))
            for r in range(2)]
    router = _RouterThread(fleet_dir, 2, str(d / "router.jsonl"))
    _wait_live(router.router, 2)
    yield dict(dir=d, prefix=prefix, fleet_dir=fleet_dir, reps=reps,
               router=router)
    router.close()
    for rep in reps:
        assert rep.close() == [0]         # drained cleanly


def test_answers_through_the_router_match_the_jax_engine(served):
    jeng = JEngine(served["prefix"], max_batch=2, log_fn=None)
    jeng.load()
    rs = np.random.RandomState(3)
    answered = set()
    for n in (1, 2, 1, 2, 1, 1):
        x = rs.randn(n, 3, 32, 32).astype(np.float32)
        got, hdrs = _post(served["router"].url, x)
        ref, _ = jeng.forward({"data": x})
        ref = np.asarray(ref[OUT])
        out = np.asarray(got["outputs"][OUT], np.float32)
        assert out.shape == ref.shape and np.abs(ref).max() > 0
        np.testing.assert_allclose(out, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())
        assert hdrs.get(ttracing.TRACE_HEADER)
        assert ttracing.decode_stages(hdrs.get(ttracing.STAGES_HEADER))
    for e in _events(str(served["dir"] / "router.jsonl"), "route"):
        answered.add(e["replica"])
    assert answered == {0, 1}                 # both replicas answered


def test_loadgen_through_the_router_and_stages_telescope(served):
    out = run_loadgen(served["router"].url, mode="closed", concurrency=4,
                      duration_s=2.0, log_fn=None)
    assert out["errors"] == 0 and out["ok"] > 10
    assert out["server_ms_p50"] > 0
    out = run_loadgen(served["router"].url, mode="open",
                      rate=max(5.0, out["rps"] / 2), duration_s=1.0,
                      log_fn=None)
    assert out["errors"] == 0 and out["dropped"] == 0
    traces = [e for e in _events(str(served["dir"] / "router.jsonl"),
                                 "serve_trace") if e["code"] == 200]
    assert len(traces) > 10
    for e in traces:
        parts = [e[f"{k}_ms"] for k in ttracing.STAGES]
        assert min(parts) >= 0.0
        # the router's total = net + the replica's four stages, each
        # field rounded to 3 decimals
        assert sum(parts) == pytest.approx(e["total_ms"], abs=3e-3)
        assert e["net_ms"] == pytest.approx(
            e["total_ms"] - e["server_ms"], abs=1.5e-3)


def test_one_trace_id_spans_a_retry(served):
    """A lease whose replica does not answer (its port is closed): the
    router's first attempt gets no response and the retry lands on a
    live replica under the same trace id, which the replica's own
    serve_trace event carries."""
    fleet_dir, router = served["fleet_dir"], served["router"].router
    from sparknet_tpu_torch.resilience.seam import RealDir
    d = RealDir(fleet_dir)
    stop = threading.Event()

    def ghost():                 # replica 2: leased, never answers
        seq = 0
        while not stop.is_set():
            seq += 1
            d.write_json("hb-2.json", {
                "host": 2, "seq": seq, "round": -1, "stamp": time.time(),
                "mono": time.monotonic(), "url": "http://127.0.0.1:9",
                "queue_depth": 0, "in_flight": 0, "draining": False,
                "sha": None, "iter": 0})
            stop.wait(HTTP_BEAT)

    t = threading.Thread(target=ghost, daemon=True)
    t.start()
    try:
        _wait_live(router, 3)
        x = np.random.RandomState(9).randn(1, 3, 32, 32).astype(np.float32)
        for _ in range(6):
            got, _ = _post(served["router"].url, x)
            assert OUT in got["outputs"]
    finally:
        stop.set()
        t.join()
        d.remove("hb-2.json")
        t0 = time.monotonic()          # the ghost is evicted
        while 2 in router.policy.live() and time.monotonic() - t0 < 10:
            time.sleep(0.05)
    retried = [e for e in _events(str(served["dir"] / "router.jsonl"),
                                  "serve_trace")
               if e["src"] == "router" and e["retried"]]
    assert retried, "no request was retried"
    tr = retried[-1]
    assert tr["code"] == 200 and tr["attempts"] == 2
    assert [s["code"] for s in tr["spans"]] == [-1, 200]
    assert tr["spans"][0]["replica"] == 2
    ans = tr["replica"]
    assert ans in (0, 1)
    mine = [e for e in _events(str(served["dir"] / f"r{ans}.jsonl"),
                               "serve_trace") if e["trace"] == tr["trace"]]
    assert len(mine) == 1 and mine[0]["src"] == f"replica{ans}"


def test_a_killed_replica_fails_over_with_zero_errors(served, tmp_path):
    """Replica 2, a ``serve`` process of the port, SIGKILLs itself after
    its 8th request (``--chaos kill_replica=2,kill_req=8``) while closed
    loops run through the router: no request fails, before, through or
    after the death, and the router evicts it."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch", "serve", "--prefix",
         served["prefix"], "--device", "cpu", "--fleet_dir",
         served["fleet_dir"], "--replica", "2", "--replicas", "3",
         "--lease", str(HTTP_LEASE), "--heartbeat_interval", str(HTTP_BEAT),
         "--max_batch", "2", "--chaos", "kill_replica=2,kill_req=8",
         "--metrics", str(tmp_path / "r2.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    router = served["router"].router
    runs = []
    try:
        _wait_live(router, 3, timeout=60)
        # load until the replica has died (a loaded machine serves fewer
        # requests a second; the kill comes at the 8th of R2's share, a
        # moment after its answer reached the client: wait that moment
        # out before the next loop, whose first GET /healthz the router
        # may hand to R2)
        t0 = time.monotonic()
        rc = None
        while rc is None and time.monotonic() - t0 < 120:
            runs.append(run_loadgen(served["router"].url, mode="closed",
                                    concurrency=4, duration_s=1.0,
                                    log_fn=None))
            try:
                rc = proc.wait(timeout=0.5)
            except subprocess.TimeoutExpired:
                pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == -9, proc.stdout.read()[-2000:]     # it killed itself
    t0 = time.monotonic()            # evicted within a lease and a window
    while 2 in router.policy.live() and time.monotonic() - t0 < 10:
        time.sleep(0.05)
    assert 2 not in router.policy.live()
    runs.append(run_loadgen(served["router"].url, mode="closed",
                            concurrency=4, duration_s=1.0, log_fn=None))
    assert sum(r["errors"] for r in runs) == 0
    assert sum(r["ok"] for r in runs) > 8 and runs[-1]["ok"] > 0
    evicted = [e for e in _events(str(served["dir"] / "router.jsonl"),
                                  "eviction") if e.get("worker") == 2]
    assert evicted
    chaos = _events(str(tmp_path / "r2.jsonl"), "chaos")
    # served counts requests by batch of up to 2: the 8th or 9th
    assert [(e["kind"], e["replica"]) for e in chaos] == \
        [("kill_replica", 2)] and chaos[0]["served"] in (8, 9)
