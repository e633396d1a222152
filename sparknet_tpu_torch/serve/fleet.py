"""Fleet serving: leased replica membership, router failover, SLO
autoscaling, canary rollout (the ``route`` verb). A port of
sparknet_tpu/serve/fleet.py with the same leases, drain-order files,
headers and events: a port router routes over JAX replicas and the
reverse, in one rendezvous directory.

One ``serve`` process is one SIGKILL from zero availability. This
module replicates it on the rendezvous machinery of
resilience/heartbeat.py + elastic.py:

  ReplicaMember   one serve replica's end of the liveness protocol: a
                  HeartbeatCoordinator whose beat payload carries the
                  serving truth (url, queue depth, in-flight count,
                  checkpoint sha, drain state). Replicas lease into the
                  rendezvous dir exactly like training hosts; a late
                  replica picks the next id and leases in — the
                  grow-mid-run path, unchanged.
  Router          reads the leases (receipt-monotonic freshness, the
                  same NTP-step-immune rule view() uses), spreads
                  POST /predict by least queue depth over live
                  non-draining replicas, retries a FAILED dispatch once
                  on a different replica (never a fulfilled one — a
                  response received means no second dispatch), and
                  feeds lease expiry into a real ElasticPolicy: replica
                  failover IS eviction, no new liveness protocol.
  SLOAutoscaler   grow when p99 or queue depth breaches target for K
                  consecutive windows, shrink on sustained idle. Grow
                  is a DECISION (a ``scale`` event + log line an
                  orchestrator acts on by launching a replica that
                  leases itself in); shrink is executed by the router
                  writing drain-<r>.json, which the victim's beat cycle
                  picks up and turns into a graceful drain.
  CanaryController  when live replicas disagree on checkpoint sha
                  (a hot reload rolling out), split traffic by
                  percentage, watch per-sha error/p99 deltas, and
                  auto-rollback — pin traffic to the baseline sha —
                  on SLO breach.

Everything observable flows through three closed-schema events
(``route``/``scale``/``canary``) plus the membership events the policy
already emits, so the ``report`` and ``monitor`` verbs render a serving
fleet with zero special cases. Clock/Dir seams are injectable: the same
Router runs against SimClock/MemDir in ``simfleet --serve``
(sim/servefleet.py) and against the wall clock on metal.
"""

import inspect
import json
import threading

from ..obs.tracing import (STAGES_HEADER, TRACE_HEADER, StageReservoir,
                           decode_stages, encode_stages)
from ..resilience.elastic import ElasticPolicy, QuorumLost
from ..resilience.heartbeat import HeartbeatCoordinator
from ..resilience.seam import WALL_CLOCK, RealDir


def _drain_name(replica):
    return f"drain-{int(replica)}.json"


def http_post(url, body, timeout, headers=None):
    """The real dispatch half: POST ``body`` to ``url``/predict.
    Returns (status, payload bytes, None, stages) — stages is the
    replica's echoed X-Sparknet-Stages breakdown ({stage: ms}) or
    None; status -1 means NO response was received (connect refused,
    reset, timeout) — the only case a retry is provably
    safe-or-necessary for."""
    from urllib.error import HTTPError, URLError
    from urllib.request import Request, urlopen
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    try:
        req = Request(url.rstrip("/") + "/predict", data=body,
                      headers=hdrs)
        with urlopen(req, timeout=timeout) as r:
            return (r.status, r.read(), None,
                    decode_stages(r.headers.get(STAGES_HEADER)))
    except HTTPError as e:
        try:
            data = e.read()
        except OSError:
            data = b""
        return e.code, data, None, None
    except (URLError, OSError, TimeoutError):
        return -1, b"", None, None


class ReplicaMember:
    """One serve replica's lease into the fleet rendezvous.

    The beat payload is gathered fresh per beat (every interval_s) from
    the live batcher/engine, so the router's view of queue depth and
    drain state is never older than one heartbeat. The same beat cycle
    polls for the router's drain-<replica>.json order and fires
    ``drain_event`` — the stop_event the serve loop already honors —
    so scale-down rides the existing graceful-drain path."""

    def __init__(self, directory, replica, replicas=None, engine=None,
                 batcher=None, url=None, interval_s=0.5, lease_s=3.0,
                 metrics=None, log_fn=print, clock=None, dirops=None):
        self.replica = int(replica)
        n = max(int(replicas or 0), self.replica + 1)
        self.engine = engine
        self.batcher = batcher
        self.url = url
        self.log = log_fn or (lambda *a: None)
        self.drain_event = threading.Event()
        self.coord = HeartbeatCoordinator(
            directory, host=self.replica, n_hosts=n,
            interval_s=interval_s, lease_s=lease_s, metrics=metrics,
            log_fn=log_fn, clock=clock, dirops=dirops,
            payload_fn=self._payload)

    def _payload(self):
        """The serving fields of this replica's lease record."""
        if not self.drain_event.is_set() and \
                self.coord.dirops.exists(_drain_name(self.replica)):
            self.log(f"serve: drain order for replica {self.replica} "
                     "found in the rendezvous; draining")
            self.drain_event.set()
        st = self.engine.status() if self.engine is not None else {}
        sha = st.get("sha")
        if isinstance(sha, dict):
            # the manifest's sha256 entry is per-file; the MODEL blob
            # sha is the weights identity the canary split keys on
            sha = sha.get("model")
        st = dict(st, sha=sha)
        draining = self.drain_event.is_set() or (
            self.batcher.draining() if self.batcher is not None else False)
        return {"url": self.url,
                "queue_depth": (self.batcher.depth()
                                if self.batcher is not None else 0),
                "in_flight": (self.batcher.pending()
                              if self.batcher is not None else 0),
                "draining": bool(draining),
                "sha": st.get("sha"), "iter": st.get("iter")}

    def start(self, url=None):
        """Lease in (removing any stale drain order a previous
        incarnation of this replica id left behind)."""
        if url is not None:
            self.url = url
        self.coord.dirops.remove(_drain_name(self.replica))
        self.coord.start()
        return self

    def stop(self):
        self.coord.stop()

    def health(self):
        """Lease/membership fields for GET /healthz — the same truth
        the router reads from the beat, so humans and the router can
        never disagree about this replica's state."""
        rec = self.coord.dirops.read_json(
            self.coord._hb_name(self.replica)) or {}
        age = max(0.0, self.coord.clock.time()
                  - float(rec.get("stamp", 0.0))) if rec else None
        return {"replica": self.replica,
                "world": self.coord.n,
                "lease_age_s": None if age is None else round(age, 3),
                "lease_s": self.coord.lease_s,
                "draining": bool(self.drain_event.is_set() or (
                    self.batcher.draining()
                    if self.batcher is not None else False))}


class SLOAutoscaler:
    """Window-hysteresis scaling decisions off the router's own
    measurements. Single-threaded: only the router's window loop calls
    observe()."""

    def __init__(self, p99_ms=500.0, depth=32, windows=3, idle_windows=10,
                 min_replicas=1, max_replicas=8, metrics=None,
                 log_fn=print):
        self.p99_ms = float(p99_ms)
        self.depth = int(depth)
        self.windows = max(1, int(windows))
        self.idle_windows = max(1, int(idle_windows))
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = int(max_replicas)
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self._breach = 0
        self._idle = 0
        self.decisions = []     # [(window, action), ...]

    def observe(self, stats, live):
        """One router window -> None | "grow" | "shrink". ``stats``:
        the router's window_stats() dict; ``live``: live replica
        count."""
        p99 = stats.get("p99_ms")
        depth = stats.get("queue_depth") or 0
        # a paging burn rate (obs/tracing.py BurnRateLedger) is an
        # EARLIER breach signal than the raw p99 gate: the fast window
        # confirms the budget is burning right now, before enough slow
        # windows accumulate for the p99 threshold to trip
        burn_page = (stats.get("burn") or {}).get("alert") == "page"
        breach = (p99 is not None and p99 > self.p99_ms) \
            or depth > self.depth or burn_page
        idle = stats.get("requests", 0) == 0 and depth == 0
        self._breach = self._breach + 1 if breach else 0
        self._idle = self._idle + 1 if idle else 0
        action = reason = None
        if self._breach >= self.windows:
            if live < self.max_replicas:
                action = "grow"
                if p99 is not None and p99 > self.p99_ms:
                    reason = "p99_breach"
                elif depth > self.depth:
                    reason = "depth_breach"
                else:
                    reason = "burn_rate"
            self._breach = 0     # re-arm either way (hysteresis)
        elif self._idle >= self.idle_windows:
            if live > self.min_replicas:
                action, reason = "shrink", "sustained_idle"
            self._idle = 0
        if action is None:
            return None
        self.decisions.append((stats.get("window"), action))
        self.log(f"route: scale {action} ({reason}): live {live}, "
                 f"p99 {p99} ms (target {self.p99_ms:g}), "
                 f"depth {depth} (target {self.depth}) for "
                 f"{self.windows} window(s)")
        if self.metrics is not None:
            self.metrics.log("scale", action=action, reason=reason,
                             live=int(live), p99_ms=p99,
                             queue_depth=int(depth),
                             breach_windows=self.windows,
                             target=(self.max_replicas if action == "grow"
                                     else self.min_replicas))
        return action


class CanaryController:
    """Percentage traffic split across two checkpoint shas with
    auto-rollback. choose()/record() are called from handler threads
    (locked); observe_shas()/evaluate() only from the window loop."""

    def __init__(self, pct=20.0, min_requests=20, max_err_delta=0.05,
                 max_p99_delta_ms=500.0, promote_windows=5,
                 metrics=None, log_fn=print):
        self.pct = float(pct)
        self.min_requests = max(1, int(min_requests))
        self.max_err_delta = float(max_err_delta)
        self.max_p99_delta_ms = float(max_p99_delta_ms)
        self.promote_windows = max(1, int(promote_windows))
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self._lock = threading.Lock()
        self.baseline_sha = None          # spk: guarded-by=_lock
        self.canary_sha = None            # spk: guarded-by=_lock
        self.rolled_back = set()          # spk: guarded-by=_lock
        self._counter = 0                 # spk: guarded-by=_lock
        self._stats = {}                  # spk: guarded-by=_lock
        self._healthy = 0                 # spk: guarded-by=_lock
        self.rollbacks = 0                # spk: guarded-by=_lock

    def _fresh(self):
        return {"ok": 0, "err": 0, "lat": []}

    def observe_shas(self, shas):
        """Window-loop: the distinct checkpoint shas currently live.
        A second sha starts a canary; the canary sha disappearing ends
        it; the baseline sha disappearing (full rollout done outside
        the canary flow) promotes."""
        ev = None
        with self._lock:
            shas = [s for s in shas if s]
            if self.baseline_sha is None:
                if shas:
                    self.baseline_sha = shas[0]
                return
            if self.baseline_sha not in shas and shas:
                # the old world is gone; whatever serves now is baseline
                self.baseline_sha = self.canary_sha \
                    if self.canary_sha in shas else shas[0]
                self.canary_sha = None
                self._stats = {}
            if self.canary_sha is None:
                cand = [s for s in shas if s != self.baseline_sha
                        and s not in self.rolled_back]
                if cand:
                    self.canary_sha = cand[0]
                    self._stats = {self.baseline_sha: self._fresh(),
                                   self.canary_sha: self._fresh()}
                    self._healthy = 0
                    ev = dict(action="start", sha=self.canary_sha,
                              baseline_sha=self.baseline_sha,
                              pct=self.pct)
            elif self.canary_sha not in shas:
                ev = dict(action="end", sha=self.canary_sha,
                          baseline_sha=self.baseline_sha,
                          reason="sha_gone")
                self.canary_sha = None
        if ev is not None:
            self._emit(**ev)

    def choose(self):
        """Preferred sha for the next request, or None (no canary in
        flight). Deterministic stride split: every round(100/pct)-th
        request goes to the canary."""
        with self._lock:
            if self.canary_sha is None or self.pct <= 0:
                return self.baseline_sha if self.rolled_back else None
            self._counter += 1
            stride = max(1, int(round(100.0 / self.pct)))
            if self._counter % stride == 0:
                return self.canary_sha
            return self.baseline_sha

    def record(self, sha, code, latency_ms):
        """One routed response attributed to the sha that served it."""
        with self._lock:
            st = self._stats.get(sha)
            if st is None:
                return
            if code == 200:
                st["ok"] += 1
                if len(st["lat"]) < 4096:
                    st["lat"].append(float(latency_ms))
            elif code != 429:        # backpressure is not a canary fault
                st["err"] += 1

    def _emit(self, **fields):
        self.log("route: canary " + " ".join(
            f"{k}={v}" for k, v in fields.items()))
        if self.metrics is not None:
            self.metrics.log(
                "canary", action=fields.get("action"),
                sha=fields.get("sha"),
                baseline_sha=fields.get("baseline_sha"),
                pct=fields.get("pct"), reason=fields.get("reason"),
                requests=fields.get("requests"),
                err_rate=fields.get("err_rate"),
                base_err_rate=fields.get("base_err_rate"),
                p99_ms=fields.get("p99_ms"),
                base_p99_ms=fields.get("base_p99_ms"))

    def evaluate(self):
        """Window-loop: compare per-sha error rate and p99; rollback on
        breach, promote after promote_windows healthy windows with
        enough canary traffic. Returns "rollback"/"promote"/None."""
        from ..obs.stepstats import percentiles
        ev = verdict = None
        with self._lock:
            if self.canary_sha is None:
                return None
            can = self._stats.get(self.canary_sha, self._fresh())
            base = self._stats.get(self.baseline_sha, self._fresh())
            n_can = can["ok"] + can["err"]
            n_base = base["ok"] + base["err"]
            if n_can < self.min_requests:
                return None
            err_rate = can["err"] / n_can
            base_err = base["err"] / n_base if n_base else 0.0
            p99 = round(percentiles(can["lat"])["p99"], 3) \
                if can["lat"] else None
            base_p99 = round(percentiles(base["lat"])["p99"], 3) \
                if base["lat"] else None
            breach = err_rate - base_err > self.max_err_delta
            if p99 is not None and base_p99 is not None:
                breach = breach or \
                    (p99 - base_p99 > self.max_p99_delta_ms)
            fields = dict(sha=self.canary_sha,
                          baseline_sha=self.baseline_sha,
                          requests=n_can, err_rate=round(err_rate, 4),
                          base_err_rate=round(base_err, 4), p99_ms=p99,
                          base_p99_ms=base_p99, pct=self.pct)
            if breach:
                verdict = "rollback"
                self.rolled_back.add(self.canary_sha)
                self.rollbacks += 1
                self.canary_sha = None
                self._stats = {}
                ev = dict(action="rollback",
                          reason=("err_delta" if err_rate - base_err
                                  > self.max_err_delta else "p99_delta"),
                          **fields)
            else:
                self._healthy += 1
                if self._healthy >= self.promote_windows:
                    verdict = "promote"
                    self.baseline_sha = self.canary_sha
                    self.canary_sha = None
                    self._stats = {}
                    ev = dict(action="promote", reason="slo_healthy",
                              **fields)
        if ev is not None:
            if ev["action"] == "rollback":
                # the greppable contract line (DEPLOY.md runbook)
                self.log(f"route: canary_rollback sha={ev['sha']} — "
                         "traffic pinned to baseline "
                         f"{ev['baseline_sha']}")
            self._emit(**ev)
        return verdict

    def pinned_sha(self):
        """The sha dispatch must prefer after a rollback (None before
        any rollback — normal least-depth routing)."""
        with self._lock:
            return self.baseline_sha if self.rolled_back else None

    def summary(self):
        with self._lock:
            return {"baseline_sha": self.baseline_sha,
                    "canary_sha": self.canary_sha, "pct": self.pct,
                    "rollbacks": self.rollbacks,
                    "rolled_back": sorted(self.rolled_back)}


class Router:
    """The routing tier: lease-derived membership + least-queue-depth
    dispatch + retry-once failover.

    Thread contract: HTTP handler threads call dispatch()/status()/
    stats_snapshot(); the single window loop calls poll()/
    window_stats()/request_drain(). The lease table and counters are
    guarded by ``_lock``; the ElasticPolicy is touched ONLY from the
    window loop (poll), so membership transitions never race dispatch —
    dispatch reads the lease snapshot, which is what actually gates
    traffic."""

    def __init__(self, directory, replicas=1, lease_s=3.0, quorum=1,
                 canary=None, metrics=None, log_fn=print, clock=None,
                 dirops=None, post_fn=None, retry=True, tracer=None,
                 slo=None):
        self.dir = str(directory)
        self.clock = WALL_CLOCK if clock is None else clock
        self.dirops = RealDir(self.dir) if dirops is None else dirops
        self.lease_s = float(lease_s)
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self.post_fn = http_post if post_fn is None else post_fn
        self.retry = bool(retry)
        self.canary = canary
        # request tracing (obs/tracing.py): the router mints the trace
        # id, closes the loop on the replica's echoed stage breakdown
        # (net = total − server-reported), and keeps per-stage
        # reservoirs for /metrics and the p99 decomposition. ``slo``
        # is an optional BurnRateLedger fed from dispatch outcomes.
        self.tracer = tracer
        self.slo = slo
        self.stages = StageReservoir()
        try:
            params = inspect.signature(self.post_fn).parameters
            self._post_headers = "headers" in params or any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        except (TypeError, ValueError):
            self._post_headers = False
        self.policy = ElasticPolicy(
            n_workers=max(1, int(replicas)), quorum=max(1, int(quorum)),
            evict_after=1, readmit_after=0, metrics=metrics,
            log_fn=log_fn, unit="replica")
        self.quorum_lost = False
        self._t0_mono = self.clock.monotonic()
        self._window = 0
        self._lock = threading.Lock()
        self._leases = {}                 # spk: guarded-by=_lock
        self._seen = {}                   # spk: guarded-by=_lock
        self._inflight = {}               # spk: guarded-by=_lock
        self._sent = {}                   # spk: guarded-by=_lock
        self._win_lat = []                # spk: guarded-by=_lock
        self._win_reqs = 0                # spk: guarded-by=_lock
        self._win_errs = 0                # spk: guarded-by=_lock
        self._rr = 0                      # spk: guarded-by=_lock
        self._trace_n = 0                 # spk: guarded-by=_lock
        self._by_replica = {}             # spk: guarded-by=_lock
        self.requests = 0                 # spk: guarded-by=_lock
        self.ok = 0                       # spk: guarded-by=_lock
        self.rejected = 0                 # spk: guarded-by=_lock
        self.errors = 0                   # spk: guarded-by=_lock
        self.retries = 0                  # spk: guarded-by=_lock
        self.no_replica = 0               # spk: guarded-by=_lock

    # -- membership (window loop only) --------------------------------------
    def poll(self):
        """Refresh the lease table and drive the ElasticPolicy:
        an expired lease is an eviction (reason lease_expired), a fresh
        lease from an unknown or evicted id is an admission (the
        grow path / a rejoin). Returns the live replica ids."""
        mono = self.clock.monotonic()
        wall = self.clock.time()
        recs = {}
        for name in self.dirops.glob("hb-*.json"):
            rec = self.dirops.read_json(name)
            if rec is not None and isinstance(rec.get("host"), int):
                recs[rec["host"]] = rec
        fresh = {}
        with self._lock:
            for r, rec in recs.items():
                key = (rec.get("seq"), rec.get("stamp"))
                seen = self._seen.get(r)
                if seen is None or seen[0] != key:
                    # receipt-monotonic freshness, seeded from the wall
                    # stamp on first sight so a ghost lease reads old
                    init = max(0.0, wall - float(rec.get("stamp", 0.0))) \
                        if seen is None else 0.0
                    seen = (key, mono, init)
                    self._seen[r] = seen
                    # a fresh beat carries a fresh queue_depth: what we
                    # dispatched since the previous beat is now counted
                    # in it, so the local correction resets
                    self._sent.pop(r, None)
                age = seen[2] + (mono - seen[1])
                if age <= self.lease_s:
                    fresh[r] = rec
            self._leases = dict(fresh)
            for r in list(self._seen):
                if r not in recs:
                    self._seen.pop(r)     # reaped/removed lease file
            self._window += 1
            w = self._window
        grace = mono - self._t0_mono <= self.lease_s
        for r in self.policy.live():
            if r not in fresh and not grace:
                try:
                    self.policy.evict(r, w, "lease_expired")
                except QuorumLost:
                    # a routing tier with zero capacity serves 503s —
                    # it does not exit; capacity can lease back in
                    self.quorum_lost = True
        for r in sorted(fresh):
            if r >= self.policy.n:
                self.policy.admit(r, w, via="grow")
                self.quorum_lost = False
            elif not self.policy.alive[r]:
                self.policy.admit(r, w, via="rejoin")
                self.quorum_lost = False
        if self.quorum_lost and \
                all(r in fresh for r in self.policy.live()):
            # the eviction that tripped quorum was REFUSED (the policy
            # raises before marking dead), so a returning beat shows up
            # as an already-live replica, not an admission: fresh
            # leases under every live id mean capacity is back
            self.quorum_lost = False
            self.log("route: capacity leased back in; quorum restored")
        if self.canary is not None:
            live = set(self.policy.live())
            self.canary.observe_shas(sorted(
                {rec.get("sha") for r, rec in fresh.items()
                 if r in live and rec.get("sha")}))
        return self.policy.live()

    def request_drain(self, replica=None):
        """Order a replica to drain (scale-down): write the drain file
        its beat cycle polls. Default victim: the highest live
        non-draining replica. Returns the victim id or None."""
        if replica is None:
            with self._lock:
                cands = [r for r, rec in self._leases.items()
                         if not rec.get("draining")]
            replica = max(cands) if cands else None
        if replica is None:
            return None
        self.dirops.write_json(_drain_name(replica), {
            "replica": int(replica), "stamp": self.clock.time()})
        self.log(f"route: drain ordered for replica {replica}")
        return int(replica)

    # -- dispatch (handler threads) ----------------------------------------
    def pick(self, exclude=(), sha=None):
        """Least-queue-depth live, non-draining replica (advertised
        depth plus this router's own in-flight count toward it — the
        advertised number is up to one heartbeat stale). ``sha``
        restricts to replicas serving that checkpoint."""
        with self._lock:
            leases = dict(self._leases)
            inflight = dict(self._inflight)
            sent = dict(self._sent)
        live = set(self.policy.live())
        cands = []
        for r, rec in leases.items():
            if r in exclude or r not in live or rec.get("draining") \
                    or not rec.get("url"):
                continue
            if sha is not None and rec.get("sha") != sha:
                continue
            depth = int(rec.get("queue_depth") or 0) \
                + int(rec.get("in_flight") or 0) + inflight.get(r, 0) \
                + sent.get(r, 0)
            cands.append((depth, r, rec))
        if not cands:
            return None
        best = min(c[0] for c in cands)
        mins = sorted(c for c in cands if c[0] == best)
        # round-robin among equal depths: advertised depth is up to one
        # heartbeat stale, so a fixed tie-break would herd every
        # dispatch in the window onto one replica
        with self._lock:
            self._rr += 1
            rr = self._rr
        _, r, rec = mins[rr % len(mins)]
        return r, rec.get("url"), rec.get("sha")

    def dispatch(self, body, timeout=30.0, want_headers=False):
        """Route one POST /predict body. Returns (status, payload
        bytes) — or (status, payload, echo-headers dict) with
        ``want_headers`` so the router front end can re-echo the
        replica's stage breakdown to the client. Transport failure (no
        response) retries ONCE on a different replica; any received
        response — including errors — is final (a fulfilled request is
        never doubled). No live non-draining replica -> 503
        immediately, never a hang.

        Mints one trace id per request and propagates it to every
        attempt via the X-Sparknet-Trace header (value
        "<id>;<attempt>" — retries share the id); collects one span
        per attempt plus the replica's echoed stage breakdown so a
        traced request attributes its milliseconds end to end."""
        t0 = self.clock.monotonic()
        with self._lock:
            self._trace_n += 1
            trace = f"t{self._trace_n:08x}"
        want_sha = self.canary.choose() if self.canary is not None \
            else None
        tried = []
        spans = []
        code, data, replica, sha = -1, b"", None, None
        sim_lat_ms = None
        stages_resp = None
        for attempt in (1, 2):
            picked = self.pick(exclude=tried, sha=want_sha)
            if picked is None and want_sha is not None:
                # no replica on the preferred sha: availability beats
                # the split — fall back to any live replica
                picked = self.pick(exclude=tried)
            if picked is None:
                break
            replica, url, sha = picked
            tried.append(replica)
            with self._lock:
                self._inflight[replica] = \
                    self._inflight.get(replica, 0) + 1
                self._sent[replica] = self._sent.get(replica, 0) + 1
                self._by_replica[replica] = \
                    self._by_replica.get(replica, 0) + 1
            att0 = self.clock.monotonic()
            try:
                # post_fn may return (code, body) — the legacy HTTP
                # transport shape — (code, body, latency_ms) from a
                # simulated replica (sim/servefleet.py) whose service
                # time is computed, not slept, or (code, body,
                # latency_ms, stages) when the replica echoes its
                # stage breakdown
                if self._post_headers:
                    res = self.post_fn(
                        url, body, timeout,
                        headers={TRACE_HEADER: f"{trace};{attempt}"})
                else:
                    res = self.post_fn(url, body, timeout)
                code, data = res[0], res[1]
                att_lat = None
                if len(res) > 2 and res[2] is not None:
                    sim_lat_ms = att_lat = float(res[2])
                if len(res) > 3:
                    stages_resp = res[3]
            finally:
                with self._lock:
                    n = self._inflight.get(replica, 1) - 1
                    if n <= 0:
                        self._inflight.pop(replica, None)
                    else:
                        self._inflight[replica] = n
            if att_lat is None:
                att_lat = (self.clock.monotonic() - att0) * 1e3
            spans.append({"replica": int(replica), "code": int(code),
                          "start_ms": round((att0 - t0) * 1e3, 3),
                          "dur_ms": round(att_lat, 3)})
            if code == 200 or not self.retry:
                break
            if code not in (-1, 429):
                break       # a response arrived: final, never re-sent
        latency_ms = sim_lat_ms if sim_lat_ms is not None \
            else (self.clock.monotonic() - t0) * 1e3
        retried = len(tried) > 1
        if not tried:
            code, data = 503, json.dumps(
                {"error": "no live replica",
                 "reason": "all_draining_or_dead"}).encode("utf-8")
        elif code == -1:
            code, data = 503, json.dumps(
                {"error": f"replica {replica} unreachable",
                 "reason": "replica_unreachable"}).encode("utf-8")
        with self._lock:
            self.requests += 1
            self._win_reqs += 1
            if code == 200:
                self.ok += 1
                if len(self._win_lat) < 65536:
                    self._win_lat.append(latency_ms)
            elif code == 429:
                self.rejected += 1
            else:
                self.errors += 1
                self._win_errs += 1
            if retried:
                self.retries += 1
            if not tried:
                self.no_replica += 1
        # close the tracing loop: net = router total − server-reported
        server_ms = net_ms = None
        stg = None
        if code == 200 and stages_resp:
            server_ms = stages_resp.get("total")
            if server_ms is not None:
                net_ms = max(0.0, latency_ms - float(server_ms))
            stg = {"net": net_ms,
                   "queue": stages_resp.get("queue"),
                   "batch": stages_resp.get("batch"),
                   "infer": stages_resp.get("infer"),
                   "fulfill": stages_resp.get("fulfill"),
                   "total": latency_ms}
            self.stages.add(stg)
        if self.slo is not None:
            self.slo.record(self.clock.monotonic(),
                            self.slo.good(code, latency_ms))
        if self.canary is not None and sha is not None:
            self.canary.record(sha, code, latency_ms)
        if self.metrics is not None:
            self.metrics.log("route", replica=replica, code=int(code),
                             attempts=len(tried), retried=retried,
                             latency_ms=round(latency_ms, 3), sha=sha)
            verdict = self.tracer.decide(latency_ms) \
                if self.tracer is not None else None
            if verdict is not None:
                rnd = lambda v: None if v is None else round(v, 3)  # noqa: E731
                self.metrics.log(
                    "serve_trace", src="router", trace=trace,
                    replica=replica, code=int(code),
                    attempts=len(tried), retried=retried,
                    total_ms=round(latency_ms, 3),
                    server_ms=rnd(server_ms), net_ms=rnd(net_ms),
                    queue_ms=rnd(stg["queue"]) if stg else None,
                    batch_ms=rnd(stg["batch"]) if stg else None,
                    infer_ms=rnd(stg["infer"]) if stg else None,
                    fulfill_ms=rnd(stg["fulfill"]) if stg else None,
                    tail=verdict == "tail", spans=spans)
        if want_headers:
            echo = {TRACE_HEADER: trace}
            if stages_resp:
                echo[STAGES_HEADER] = encode_stages(stages_resp)
            return code, data, echo
        return code, data

    # -- observation --------------------------------------------------------
    def window_stats(self):
        """Swap out and summarize this window's dispatch measurements
        (window loop only); feeds the SLO autoscaler."""
        from ..obs.stepstats import percentiles
        with self._lock:
            lats, self._win_lat = self._win_lat, []
            reqs, self._win_reqs = self._win_reqs, 0
            errs, self._win_errs = self._win_errs, 0
            depth = max((int(rec.get("queue_depth") or 0)
                         + int(rec.get("in_flight") or 0)
                         for rec in self._leases.values()), default=0)
            w = self._window
        out = {"window": w, "requests": reqs, "errors": errs,
               "queue_depth": depth,
               "p99_ms": (round(percentiles(lats)["p99"], 3)
                          if lats else None)}
        if self.slo is not None:
            # evaluated once per window (not per request) so the
            # slo_burn event volume rides the window cadence; the
            # autoscaler reads the verdict as an earlier breach signal
            out["burn"] = self.slo.evaluate(self.clock.monotonic())
        return out

    def stats_snapshot(self):
        with self._lock:
            by_rep = dict(self._by_replica)
            out = {"requests": self.requests, "ok": self.ok,
                   "rejected": self.rejected, "errors": self.errors,
                   "retries": self.retries,
                   "no_replica": self.no_replica,
                   "live": self.policy.live_count()}
        out["retry_rate"] = round(out["retries"]
                                  / out["requests"], 4) \
            if out["requests"] else 0.0
        total = sum(by_rep.values())
        out["dispatch_share"] = {
            str(r): round(n / total, 4)
            for r, n in sorted(by_rep.items())} if total else {}
        out["stages"] = self.stages.snapshot()
        if self.slo is not None:
            out["slo_burn"] = self.slo.snapshot()
        return out

    def status(self):
        """GET /healthz: the router's membership truth."""
        with self._lock:
            leases = {r: dict(rec) for r, rec in self._leases.items()}
            w = self._window
        out = {"status": "ok", "window": w,
               "live": self.policy.live(), "world": self.policy.n,
               "quorum_lost": self.quorum_lost,
               "replicas": {str(r): {
                   k: rec.get(k) for k in
                   ("url", "queue_depth", "in_flight", "draining",
                    "sha", "iter", "round")} for r, rec in
                   sorted(leases.items())}}
        out["stages_p99"] = self.stages.p99()
        if self.slo is not None:
            out["slo_burn"] = self.slo.snapshot()
        if self.canary is not None:
            out["canary"] = self.canary.summary()
        return out


def _make_router_handler(router, timeout_s):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet access log
            pass

        def _send(self, code, body, ctype="application/json",
                  headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj):
            self._send(code, json.dumps(obj).encode("utf-8"))

        def do_GET(self):
            if self.path == "/healthz":
                st = router.status()
                # loadgen discovers feed shapes through the router:
                # proxy a baseline replica's /healthz feeds — during a
                # canary (or after a rollback) an idle canary replica
                # may be the least-loaded one, and advertising its
                # shapes would steer every client into the minority
                # (or rolled-back) model
                want = None
                if router.canary is not None:
                    want = router.canary.pinned_sha() or \
                        router.canary.summary()["baseline_sha"]
                picked = router.pick(sha=want) if want is not None \
                    else None
                if picked is None:
                    picked = router.pick()
                if picked is not None:
                    try:
                        from urllib.request import urlopen
                        with urlopen(picked[1].rstrip("/") + "/healthz",
                                     timeout=timeout_s) as r:
                            rep = json.loads(r.read())
                        for k in ("feeds", "buckets", "iter", "model"):
                            if k in rep:
                                st[k] = rep[k]
                    except (OSError, ValueError):
                        pass
                self._send_json(200, st)
            elif self.path == "/metrics":
                self._send_json(200, router.stats_snapshot())
            else:
                self._send_json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send_json(404, {"error": "unknown path"})
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            code, data, hdrs = router.dispatch(
                body, timeout=timeout_s, want_headers=True)
            self._send(code, data, headers=hdrs)

    return Handler


def route_http(router, autoscaler=None, host="127.0.0.1", port=0,
               window_s=1.0, policy=None, stop_event=None,
               request_timeout_s=30.0, max_windows=None, log_fn=print):
    """Bind the router front end, run the membership/SLO window loop
    until a stop signal, drain, return 0 — the same supervisor
    contract the ``serve`` verb honors."""
    from http.server import ThreadingHTTPServer
    log = log_fn or (lambda *a: None)
    handler = _make_router_handler(router, request_timeout_s)
    httpd = ThreadingHTTPServer((host, int(port)), handler)
    httpd.daemon_threads = True
    addr = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    live = router.poll()
    log(f"sparknet_tpu_torch route: listening on {addr} ({len(live)} "
        f"replica(s) live of world {router.policy.n}, lease "
        f"{router.lease_s:g}s)")
    import sys
    sys.stdout.flush()      # the announce line is what launchers wait for
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    windows = 0
    try:
        while True:
            action = policy.pending() if policy is not None else None
            if action is not None and "stop" in action:
                log("route: stop requested; draining")
                break
            if stop_event is not None and stop_event.is_set():
                break
            if max_windows is not None and windows >= max_windows:
                break
            router.clock.sleep(window_s)
            router.poll()
            stats = router.window_stats()
            if autoscaler is not None:
                decision = autoscaler.observe(
                    stats, live=router.policy.live_count())
                if decision == "shrink":
                    router.request_drain()
            if router.canary is not None:
                router.canary.evaluate()
            windows += 1
    finally:
        httpd.shutdown()
        httpd.server_close()
    snap = router.stats_snapshot()
    log(f"route: drained cleanly after {snap['requests']} request(s) "
        f"({snap['ok']} ok, {snap['rejected']} rejected, "
        f"{snap['errors']} errors, {snap['retries']} retried); "
        "exiting 0")
    return 0
