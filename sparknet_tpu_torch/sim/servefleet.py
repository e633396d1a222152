"""ServeFleetSim — adversarial validation of the serving fleet.

The REAL routing tier (serve/fleet.py: Router + ElasticPolicy +
SLOAutoscaler + CanaryController) and the REAL replica membership
(ReplicaMember -> HeartbeatCoordinator) run unmodified on the simulated
seam (SimClock + MemDir); only the replicas themselves are virtual — an
analytic single-server queue per replica (bounded backlog -> 429,
deterministic service time, seeded canary faults) standing in for the
engine+batcher at zero device cost.

An open-loop arrival process (flat/diurnal/spike/flash traces) fires
request events whose handlers call the real Router.dispatch(); the
virtual replica computes the request's queue wait + service time
analytically and returns it as the third element of the post_fn result
— SimClock event handlers must never nest sleeps (advance_to rewinds
the outer window), so simulated service time is computed, not slept.

Failure processes reuse the chaos grammar: ``kill_replica=R,kill_req=N``
kills replica R right AFTER it fulfills its kill_req-th request (the
dispatch-then-die case retry-once must never double — its lease then
lapses, the router evicts within one window and fails over);
``slow_replica=R,slow_ms=S`` inflates R's service time. Deterministic
``die_w``/``rejoin_w`` windows drive the eviction/readmission path for
replay-style assertions, and ``canary_w`` flips one replica to a faulty
checkpoint sha mid-run to prove auto-rollback.

The invariant the sweep proves: NO LOST REQUESTS — every arrival gets
a terminal response (200, explicit 429 backpressure, or explicit 5xx),
``lost = arrivals - responses == 0`` under kill, churn, and flash
crowds. ``simfleet --serve`` is the entry point; exit 1 when the
invariant breaks. A port of sparknet_tpu/sim/servefleet.py: the same
seed gives the same summary and event stream.
"""

import json
import math

import numpy as np

from ..obs.tracing import STAGES, BurnRateLedger, TraceSampler
from ..resilience.chaos import ChaosMonkey
from ..serve.fleet import CanaryController, ReplicaMember, Router, \
    SLOAutoscaler
from .clock import SimClock
from .memdir import MemDir

TRACES = ("flat", "diurnal", "spike", "flash")


def _quiet(*a, **k):
    pass


class _VBatcher:
    """The three batcher methods ReplicaMember's beat payload reads,
    answered from the virtual queue."""

    def __init__(self, rep):
        self.rep = rep

    def depth(self):
        return self.rep.depth()

    def pending(self):
        return self.rep.depth()

    def draining(self):
        return self.rep.draining


class _VEngine:
    def __init__(self, rep):
        self.rep = rep

    def status(self):
        return {"sha": self.rep.sha, "iter": 0}


class _VReplica:
    """One virtual serve replica: a bounded single-server queue with a
    REAL ReplicaMember leasing it into the rendezvous. Beats are
    scheduled as SimClock events (never member.start() — that spawns a
    real thread)."""

    def __init__(self, sim, rid, sha="sha-base"):
        self.sim = sim
        self.rid = int(rid)
        self.sha = sha
        self.up = True
        self.err_p = 0.0           # per-request fault prob (canary flip)
        self.served = 0
        self.busy_until = 0.0      # mono time the backlog clears
        self._completions = []     # completion times of queued requests
        self.member = ReplicaMember(
            sim.dirops.root, rid, replicas=sim.replicas,
            engine=_VEngine(self), batcher=_VBatcher(self),
            url=f"sim://replica/{rid}", interval_s=sim.interval_s,
            lease_s=sim.lease_s, metrics=sim.metrics, log_fn=sim.log,
            clock=sim.clock, dirops=sim.dirops)

    @property
    def draining(self):
        return self.member.drain_event.is_set()

    def depth(self):
        now = self.sim.clock.monotonic()
        self._completions = [t for t in self._completions if t > now]
        return len(self._completions)

    def serve(self, body):
        """-> (code, payload, latency_ms, stages): the analytic queue
        step. The stage breakdown uses the SAME shape the real replica
        echoes in X-Sparknet-Stages (serve/server.py stage_breakdown),
        so the router's tracing loop closes with zero special cases:
        queue = backlog wait, infer = service time (chaos slowness
        inflates it, matching the real tier where injected slowness
        lands inside the forward)."""
        now = self.sim.clock.monotonic()
        if not self.up:
            return (-1, b"", None, None)
        if self.draining:
            return (429, json.dumps(
                {"error": "draining", "reason": "replica_draining",
                 "queue_depth": self.depth()}).encode(), 0.0, None)
        if self.depth() >= self.sim.queue_limit:
            return (429, json.dumps(
                {"error": "queue full", "reason": "queue_full",
                 "queue_depth": self.depth()}).encode(), 0.0, None)
        service = self.sim.service_s
        chaos = self.sim.chaos
        if chaos is not None:
            spec = chaos.replica_slow_spec(self.rid)
            if spec is not None:
                service += spec[1]
        start = max(now, self.busy_until)
        done = start + service
        self.busy_until = done
        self._completions.append(done)
        self.served += 1
        lat_ms = (done - now) * 1e3
        stages = {"total": lat_ms,
                  "queue": (start - now) * 1e3,
                  "batch": 0.0,
                  "infer": service * 1e3,
                  "fulfill": 0.0}
        if chaos is not None and \
                chaos.replica_kill_due(self.rid, self.served):
            # dispatch-then-die: THIS request is fulfilled, then the
            # process dies — the router must return the 200 it already
            # holds and never re-send
            self.sim.kill(self, why="chaos kill_replica")
            self.sim.lat_ms.append(lat_ms)
            return (200, b'{"outputs": {}}', lat_ms, stages)
        if self.err_p > 0 and self.sim.rng.random_sample() < self.err_p:
            return (500, json.dumps(
                {"error": f"sim fault on {self.sha}"}).encode(),
                lat_ms, None)
        self.sim.lat_ms.append(lat_ms)
        return (200, b'{"outputs": {}}', lat_ms, stages)


class ServeFleetSim:
    """One simulated serving-fleet run; run() returns a summary dict.

    replicas/windows/window_s  fleet size and router-window count/size
    interval_s/lease_s         the real membership knobs (sim seconds)
    service_ms/queue_limit     the virtual replica's queue model
    rate/trace/spike_x         open-loop arrivals: base req/s shaped by
                               flat|diurnal|spike|flash (x spike_x)
    slo_p99_ms/slo_depth/breach_windows/idle_windows/min_replicas/
    max_replicas               the real SLOAutoscaler knobs; a grow
                               decision spawns a virtual replica after
                               spawn_delay_s (cold start), admitted via
                               the real grow path
    canary_w/canary_pct/canary_err/canary_min_requests
                               at window canary_w the highest live
                               replica hot-reloads to a faulty sha
                               (err_p=canary_err); the real controller
                               must detect and roll back
    die_w/rejoin_w             deterministic kill/rejoin windows for
                               the eviction/readmission contract
    chaos                      ChaosMonkey or spec string
                               (kill_replica/kill_req/slow_replica/
                               slow_ms)
    """

    def __init__(self, replicas=3, windows=30, window_s=1.0,
                 interval_s=0.25, lease_s=2.0, service_ms=20.0,
                 queue_limit=64, rate=40.0, trace="flat", spike_x=4.0,
                 slo_p99_ms=500.0, slo_depth=32, breach_windows=3,
                 idle_windows=10, min_replicas=1, max_replicas=8,
                 spawn_delay_s=1.0, canary_w=0, canary_pct=20.0,
                 canary_err=1.0, canary_min_requests=10,
                 die_w=None, rejoin_w=None, chaos=None, seed=0,
                 trace_sample=1.0, tail_ms=None, slo_burn=False,
                 burn_scale=1.0, metrics=None, log_fn=None):
        if trace not in TRACES:
            raise ValueError(f"unknown arrival trace {trace!r} "
                             f"(valid: {', '.join(TRACES)})")
        self.replicas = int(replicas)
        self.windows = int(windows)
        self.window_s = float(window_s)
        self.interval_s = float(interval_s)
        self.lease_s = float(lease_s)
        self.service_s = float(service_ms) / 1e3
        self.queue_limit = int(queue_limit)
        self.rate = float(rate)
        self.trace = trace
        self.spike_x = float(spike_x)
        self.spawn_delay_s = float(spawn_delay_s)
        self.canary_w = int(canary_w)
        self.canary_err = float(canary_err)
        self.die_w = None if die_w is None else int(die_w)
        self.rejoin_w = None if rejoin_w is None else int(rejoin_w)
        self.metrics = metrics
        self.log = log_fn or _quiet
        self.rng = np.random.RandomState(seed)
        self.clock = SimClock()
        self.dirops = MemDir(self.clock)
        if isinstance(chaos, str):
            chaos = ChaosMonkey.parse(chaos, metrics=metrics,
                                      log_fn=self.log) if chaos else None
        self.chaos = chaos
        self.reps = [_VReplica(self, r) for r in range(self.replicas)]
        self.canary = CanaryController(
            pct=float(canary_pct),
            min_requests=int(canary_min_requests), metrics=metrics,
            log_fn=self.log)
        self.router = Router(
            self.dirops.root, replicas=self.replicas,
            lease_s=self.lease_s, canary=self.canary, metrics=metrics,
            log_fn=self.log, clock=self.clock, dirops=self.dirops,
            post_fn=self._post,
            tracer=TraceSampler(sample=float(trace_sample),
                                tail_ms=tail_ms),
            slo=BurnRateLedger(slo_ms=float(slo_p99_ms),
                               scale=float(burn_scale),
                               metrics=metrics, log_fn=self.log)
            if slo_burn else None)
        self.autoscaler = SLOAutoscaler(
            p99_ms=float(slo_p99_ms), depth=int(slo_depth),
            windows=int(breach_windows), idle_windows=int(idle_windows),
            min_replicas=int(min_replicas),
            max_replicas=int(max_replicas), metrics=metrics,
            log_fn=self.log)
        self.duration = self.windows * self.window_s
        self.arrivals = 0
        self.responses = 0
        self.by_code = {}
        self.lat_ms = []
        self.killed = []
        self.spawned = []

    # -- transport + processes ----------------------------------------------
    def _post(self, url, body, timeout, headers=None):
        # accepting ``headers`` tells the router this transport can
        # carry the X-Sparknet-Trace header — the propagation path the
        # real tier uses, exercised verbatim in sim
        for rep in self.reps:
            if rep.member.url == url:
                return rep.serve(body)
        return (-1, b"", None, None)

    def kill(self, rep, why=""):
        """A replica dies: it stops beating and stops answering; its
        lease simply lapses — eviction flows through the real
        lease-expiry path, never injected into the policy."""
        if rep.up:
            rep.up = False
            self.killed.append(rep.rid)
            self.log(f"simserve: replica {rep.rid} died "
                     f"({why or 'scheduled'}) at "
                     f"t={self.clock.monotonic():.2f}s")

    def _revive(self, rep):
        if rep.up:
            return
        rep.up = True
        rep.busy_until = self.clock.monotonic()
        rep._completions = []
        self._schedule_beat(rep, 0.0)
        self.log(f"simserve: replica {rep.rid} rejoined at "
                 f"t={self.clock.monotonic():.2f}s")

    def _spawn(self):
        rid = len(self.reps)
        rep = _VReplica(self, rid)
        self.reps.append(rep)
        self.spawned.append(rid)
        self._schedule_beat(rep, self.spawn_delay_s)
        self.log(f"simserve: replica {rid} spawning "
                 f"(cold start {self.spawn_delay_s:g}s)")
        return rep

    def _schedule_beat(self, rep, delay):
        def fire():
            if not rep.up:
                return
            rep.member.coord.beat()
            if rep.draining and rep.depth() == 0:
                rep.up = False        # drained; the process exits 0
                self.log(f"simserve: replica {rep.rid} drained and "
                         "exited")
            else:
                self.clock.after(self.interval_s, fire)
        self.clock.after(delay, fire)

    # -- the arrival process -------------------------------------------------
    def _rate_at(self, t):
        x = t / max(self.duration, 1e-9)
        if self.trace == "diurnal":
            return self.rate * (0.15 + 0.425 * (1.0 - math.cos(
                2.0 * math.pi * x)))
        if self.trace == "spike":
            return self.rate * (self.spike_x if 0.4 <= x < 0.6 else 1.0)
        if self.trace == "flash":
            return self.rate * (self.spike_x if x >= 0.5 else 1.0)
        return self.rate

    def _schedule_arrival(self, delay):
        def fire():
            now = self.clock.monotonic()
            if now >= self.duration:
                return
            self._request()
            gap = self.rng.exponential(
                1.0 / max(self._rate_at(now), 1e-3))
            self.clock.after(gap, fire)
        self.clock.after(delay, fire)

    def _request(self):
        self.arrivals += 1
        code, _ = self.router.dispatch(b"{}", timeout=1.0)
        self.responses += 1
        self.by_code[code] = self.by_code.get(code, 0) + 1

    # -- the run -------------------------------------------------------------
    def run(self):
        for rep in self.reps:
            self._schedule_beat(rep, self.rng.uniform(0.0,
                                                      self.interval_s))
        # one beat cycle so every replica has leased in before traffic
        self.clock.sleep(self.interval_s * 1.5)
        self.router.poll()
        self._schedule_arrival(self.rng.exponential(
            1.0 / max(self._rate_at(0.0), 1e-3)))
        for w in range(self.windows):
            self.clock.sleep(self.window_s)
            if self.die_w is not None and w == self.die_w:
                live = [r for r in self.reps if r.up]
                if live:
                    self.kill(live[0], why="die_w")
            if self.rejoin_w is not None and w == self.rejoin_w:
                for rep in self.reps:
                    if not rep.up and not rep.draining:
                        self._revive(rep)
                        break
            if self.canary_w and w == self.canary_w:
                live = [r for r in self.reps if r.up]
                if live:
                    rep = live[-1]
                    rep.sha = "sha-canary"
                    rep.err_p = self.canary_err
                    self.log(f"simserve: replica {rep.rid} hot-reloaded"
                             f" to {rep.sha} (err_p={self.canary_err:g})")
            self.router.poll()
            stats = self.router.window_stats()
            decision = self.autoscaler.observe(
                stats, live=self.router.policy.live_count())
            if decision == "grow":
                self._spawn()
            elif decision == "shrink":
                self.router.request_drain()
            self.canary.evaluate()
        return self.summary()

    def summary(self):
        snap = self.router.stats_snapshot()
        lats = np.asarray(self.lat_ms or [0.0], np.float64)
        lost = self.arrivals - self.responses
        grow = sum(1 for _, a in self.autoscaler.decisions
                   if a == "grow")
        shrink = sum(1 for _, a in self.autoscaler.decisions
                     if a == "shrink")
        # attributed tail: which stage owns the p99 (the knob-ranking
        # signal a `simfleet --serve` sweep sorts by)
        stages_p99 = self.router.stages.p99()
        ranked = [(v, k) for k, v in stages_p99.items() if k in STAGES]
        top_stage = max(ranked)[1] if ranked else None
        return {
            "replicas": self.replicas,
            "replicas_final": self.router.policy.live_count(),
            "windows": self.windows, "window_s": self.window_s,
            "lease_s": self.lease_s, "interval_s": self.interval_s,
            "trace": self.trace, "rate": self.rate,
            "sim_s": round(self.clock.monotonic(), 3),
            "arrivals": self.arrivals, "responses": self.responses,
            "lost": lost,
            "ok": snap["ok"], "rejected": snap["rejected"],
            "errors": snap["errors"], "retries": snap["retries"],
            "availability": round(
                snap["ok"] / self.arrivals, 4) if self.arrivals else None,
            "p99_ms": round(float(np.percentile(lats, 99)), 3),
            "evictions": len(self.router.policy.evictions),
            "readmissions": len(self.router.policy.readmissions),
            "admissions": len(self.router.policy.admissions),
            "grow": grow, "shrink": shrink,
            "canary_rollbacks": self.canary.rollbacks,
            "killed": list(self.killed), "spawned": list(self.spawned),
            "quorum_lost": bool(self.router.quorum_lost),
            "stages_p99": stages_p99,
            "top_stage": top_stage,
            "burn": (self.router.slo.snapshot()
                     if self.router.slo is not None else None),
        }
