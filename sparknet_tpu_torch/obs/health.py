"""A copy of sparknet_tpu/obs/health.py (numpy only). Training-dynamics anomaly detectors: the sensors that say WHEN to act.

Step accounting measures (steps, comms, spans), recovery reacts
(rollback, resume); this module sits between them. A HealthMonitor
ingests the
per-sync-round signals the solvers already materialize — per-worker
losses, per-worker round latencies, the divergence summary from
obs/divergence.py — runs rolling anomaly detectors over them, and emits
structured ``health`` events the report/monitor render and supervisors
can alert on:

  straggler         one worker's round latency stretches past
                    ``straggler_factor`` x the median of the others (a
                    synchronous round is as slow as its slowest worker —
                    the paper's broadcast/collect stalls on it)
  loss_skew         the spread of per-worker losses jumps past
                    ``loss_skew_factor`` x its own rolling EMA (and the
                    ``loss_skew_min`` absolute floor, so noise-level
                    spreads never alarm) — one shard is training on
                    different-looking data or a replica is going bad
  worker_nonfinite  a single worker's loss is NaN/inf while others are
                    healthy (an averaged NaN poisons everyone at the
                    next sync; this names the culprit BEFORE the pmean)
  divergence_trend  mean worker divergence grew ``trend_rounds``
                    observations in a row by ``trend_factor`` total —
                    tau is outrunning the averaging
  divergence_high   divergence crossed the absolute ``div_abs`` ceiling
  worker_masked     the compiled round's validity mask zeroed out a
                    worker the host still considers alive (its replica
                    went non-finite mid-round; the masked consensus of
                    resilience/elastic.py already excluded it — this
                    alarm is the paper trail, and the eviction streak
                    the ElasticPolicy acts on)
  host_down         a peer HOST's heartbeat lease expired (resilience/
                    heartbeat.py) — the fault-domain-granularity crash
                    signal; the eviction itself is the ElasticPolicy's,
                    this alarm is the sensor-side paper trail
  host_lease        a live host's lease age crossed half the lease —
                    it is still in the membership but its heartbeats
                    are lagging (pre-failure warning)
  staleness_high    (async bounded-staleness mode) a live worker's
                    version lag reached the staleness bound s — its
                    pushes are about to be excluded; carries
                    ``suggest_s`` (a bound that would keep it
                    contributing, the staleness twin of suggest_tau)
  parked_worker     the bound was hit: a worker is PARKED — excluded
                    from the consensus until it resyncs. By design, not
                    a failure, but the paper trail an operator needs to
                    tell "one chronic straggler" from "the whole fleet
                    thrashing" (check parks-by-worker in the report)

With an ElasticPolicy armed, the detectors receive the alive mask and
skip evicted workers — a dead slot's (masked, meaningless) latency or
NaN loss must not keep the straggler/skew alarms firing.

Alarms can *arm* the existing resilience RecoveryPolicy (the solver
rolls back instead of averaging poison) and carry a tau suggestion —
divergence alarms suggest halving tau (sync more often), a quiet run
with relatively tiny divergence suggests raising it. Every detector has
a per-kind cooldown so a persistent condition logs once per
``cooldown`` observations, not once per round.
"""

import collections
import math

import numpy as np


def _finite(v):
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


class HealthMonitor:
    """observe_round(...) once per materialized sync round (or sampled
    DP step). All detectors are independent; missing inputs simply skip
    their detector, so any solver can feed whatever it has."""

    def __init__(self, sink, log_fn=print, solver=None,
                 straggler_factor=1.5, straggler_min_s=0.05,
                 loss_skew_factor=3.0, loss_skew_min=0.01,
                 skew_ema_decay=0.8,
                 trend_rounds=5, trend_factor=2.0, div_abs=0.0,
                 cooldown=5, arm_recovery=False, recovery_kw=None):
        self.sink = sink
        self.log = log_fn or (lambda *a: None)
        self.solver = solver
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_s = float(straggler_min_s)
        self.loss_skew_factor = float(loss_skew_factor)
        self.loss_skew_min = float(loss_skew_min)
        self.skew_ema_decay = float(skew_ema_decay)
        self.trend_rounds = max(2, int(trend_rounds))
        self.trend_factor = float(trend_factor)
        self.div_abs = float(div_abs)
        self.cooldown = max(1, int(cooldown))
        self.arm_recovery = bool(arm_recovery)
        self.recovery_kw = dict(recovery_kw or {})

        self.alarms = 0
        self.last_alarm = None
        self.straggler_counts = collections.Counter()
        self.tau_suggestion = None
        self.s_suggestion = None
        self._obs = 0
        self._last_fired = {}           # kind -> observation index
        self._skew_ema = None
        self._div_window = collections.deque(maxlen=self.trend_rounds)

    # -- alarm plumbing ----------------------------------------------------
    def _alarm(self, kind, severity="warn", suggest_tau=None,
               suggest_s=None, **fields):
        if self._obs - self._last_fired.get(kind, -10**9) < self.cooldown:
            return None
        self._last_fired[kind] = self._obs
        self.alarms += 1
        ev = {"kind": kind, "severity": severity}
        ev.update(fields)
        if suggest_tau is not None:
            ev["suggest_tau"] = int(suggest_tau)
            self.tau_suggestion = int(suggest_tau)
        if suggest_s is not None:
            ev["suggest_s"] = int(suggest_s)
            self.s_suggestion = int(suggest_s)
        self.last_alarm = ev
        self.log("health: " + kind + " " + " ".join(
            f"{k}={v}" for k, v in fields.items())
            + (f" (suggest tau={suggest_tau})"
               if suggest_tau is not None else "")
            + (f" (suggest s={suggest_s})"
               if suggest_s is not None else ""))
        if self.sink is not None:
            self.sink.log("health", **ev)
        if severity == "critical":
            self._maybe_arm_recovery(kind)
        return ev

    def _maybe_arm_recovery(self, kind):
        """A critical alarm arms the resilience RecoveryPolicy on the
        attached solver (if it has none yet), so the NEXT bad loss rolls
        back instead of averaging poison."""
        s = self.solver
        if not self.arm_recovery or s is None or \
                getattr(s, "recovery", None) is not None or \
                not hasattr(s, "arm_recovery"):
            return
        try:
            s.arm_recovery(**self.recovery_kw)
            self.log(f"health: armed RecoveryPolicy after {kind} alarm")
            if self.sink is not None:
                self.sink.log("health", kind="recovery_armed", cause=kind,
                              severity="info")
        except Exception as e:      # monitoring must never kill the run
            self.log(f"health: failed to arm recovery: {e!r}")

    def _tau(self):
        return getattr(self.solver, "tau", None) if self.solver else None

    # -- detectors ---------------------------------------------------------
    @staticmethod
    def _live_subset(vec, live):
        """(values, global_worker_ids) restricted to live workers —
        evicted workers' signals are masked garbage, not anomalies."""
        vec = np.asarray(vec, np.float64).ravel()
        if live is None:
            return vec, np.arange(vec.size)
        idx = np.asarray([w for w in live if w < vec.size], np.int64)
        return vec[idx], idx

    def _check_stragglers(self, it, round_idx, latencies, live=None):
        lat, ids = self._live_subset(latencies, live)
        if lat.size < 2:
            return
        w = int(np.argmax(lat))
        others = np.delete(lat, w)
        med = float(np.median(others))
        if lat[w] - med < self.straggler_min_s:
            return
        ratio = float(lat[w] / max(med, 1e-9))
        if ratio < self.straggler_factor:
            return
        worker = int(ids[w])
        self.straggler_counts[worker] += 1
        self._alarm("straggler", iter=it, round=round_idx, worker=worker,
                    latency_s=round(float(lat[w]), 4),
                    median_s=round(med, 4), ratio=round(ratio, 3),
                    times_flagged=self.straggler_counts[worker])

    def _check_loss_skew(self, it, round_idx, worker_losses, live=None):
        wl, ids = self._live_subset(worker_losses, live)
        if wl.size < 2:
            return
        finite = np.isfinite(wl)
        if not finite.all():
            for w in np.nonzero(~finite)[0]:
                self._alarm("worker_nonfinite", severity="critical",
                            iter=it, round=round_idx, worker=int(ids[w]),
                            loss=str(wl[w]))
            return
        skew = float(wl.max() - wl.min())
        prior = self._skew_ema
        self._skew_ema = skew if prior is None else \
            self.skew_ema_decay * prior + (1 - self.skew_ema_decay) * skew
        if prior is None:
            return
        if skew > self.loss_skew_factor * max(prior, 1e-9) and \
                skew > self.loss_skew_min:
            self._alarm("loss_skew", iter=it, round=round_idx,
                        skew=round(skew, 6), ema=round(prior, 6),
                        worker=int(ids[int(np.argmax(wl))]),
                        worker_losses=[round(float(x), 6) for x in wl])

    def _check_validity(self, it, round_idx, valid, live=None):
        """A live worker the device mask zeroed out: its replica went
        non-finite inside the round. The masked consensus already kept
        it out of the average; this records WHO, per round, so the
        membership policy's eviction streaks have a paper trail."""
        v, ids = self._live_subset(valid, live)
        for i in range(v.size):
            if not v[i] > 0:
                self._alarm("worker_masked", severity="critical",
                            iter=it, round=round_idx, worker=int(ids[i]))

    def _check_staleness(self, it, round_idx, lag, parked, bound,
                         live=None):
        """Async-mode detectors: a live worker whose version lag reached
        the bound is about to be excluded (staleness_high, with a
        suggest_s that would keep it in), and every freshly-parked
        worker gets a parked_worker record. Evicted workers' lag is
        masked garbage and is skipped like every other signal."""
        if bound is None:
            return
        parked = set(int(w) for w in (parked or ()))
        lagv, ids = self._live_subset(lag, live)
        for i in range(lagv.size):
            w = int(ids[i])
            if w in parked:
                self._alarm("parked_worker", iter=it, round=round_idx,
                            worker=w, lag=int(lagv[i]), s=int(bound))
            elif bound > 0 and lagv[i] >= bound:
                # one more slow round and it parks: suggest the bound
                # that would keep this straggler contributing
                self._alarm("staleness_high", iter=it, round=round_idx,
                            worker=w, lag=int(lagv[i]), s=int(bound),
                            suggest_s=int(lagv[i]) + 1)

    def _check_divergence(self, it, round_idx, div):
        mean = div.get("mean")
        if not _finite(mean):
            return
        mean = float(mean)
        tau = div.get("tau", self._tau())
        half = max(1, tau // 2) if tau and tau > 1 else None
        if self.div_abs > 0 and mean > self.div_abs:
            self._alarm("divergence_high", severity="critical", iter=it,
                        round=round_idx, mean=round(mean, 8),
                        threshold=self.div_abs, suggest_tau=half)
        self._div_window.append(mean)
        w = list(self._div_window)
        if len(w) == self.trend_rounds and \
                all(b > a > 0 for a, b in zip(w, w[1:])) and \
                w[-1] >= self.trend_factor * w[0]:
            self._alarm("divergence_trend", iter=it, round=round_idx,
                        mean=round(mean, 8),
                        grew=f"x{w[-1] / max(w[0], 1e-20):.2f} over "
                             f"{self.trend_rounds} rounds",
                        suggest_tau=half)

    def observe_hosts(self, round_idx, alive=None, lease_age_s=None,
                      lease_s=None, wait_s=None):
        """Feed one round gate's host-liveness view (resilience/
        heartbeat.py): ``alive`` the per-host mask, ``lease_age_s`` the
        per-host lease ages, ``lease_s`` the lease the ages are judged
        against, ``wait_s`` the gate's wait. Fault-domain-granularity
        twins of the worker detectors."""
        self._obs += 1
        try:
            if alive is not None:
                a = np.asarray(alive).ravel()
                for h in range(a.size):
                    if not a[h]:
                        self._alarm("host_down", severity="critical",
                                    round=round_idx, host=int(h))
            if lease_age_s is not None and lease_s:
                ages = np.asarray(lease_age_s, np.float64).ravel()
                for h in range(ages.size):
                    if alive is not None and h < np.asarray(alive).size \
                            and not np.asarray(alive).ravel()[h]:
                        continue        # dead: host_down already fired
                    if float(lease_s) > ages[h] > 0.5 * float(lease_s):
                        self._alarm("host_lease", round=round_idx,
                                    host=int(h),
                                    lease_age_s=round(float(ages[h]), 3),
                                    lease_s=float(lease_s))
        except Exception as e:          # detectors must never kill a run
            self.log(f"health: host detector error: {e!r}")

    # -- public API --------------------------------------------------------
    def observe_round(self, it, round_idx=None, worker_losses=None,
                      latencies=None, divergence=None, valid=None,
                      alive=None, lag=None, parked=None, staleness=None):
        """Feed one sync round's signals. Any subset may be None.
        ``alive``: the elastic membership mask — evicted workers are
        excluded from every detector. ``valid``: the round's effective
        per-worker validity vector (alive AND device-finite). ``lag``/
        ``parked``/``staleness``: the async mode's per-worker version
        lag, parked worker ids, and the bound s."""
        self._obs += 1
        try:
            live = None
            if alive is not None:
                a = np.asarray(alive).ravel()
                live = [int(w) for w in range(a.size) if a[w]]
            if latencies is not None:
                self._check_stragglers(it, round_idx, latencies, live)
            if worker_losses is not None:
                self._check_loss_skew(it, round_idx, worker_losses, live)
            if valid is not None:
                self._check_validity(it, round_idx, valid, live)
            if lag is not None:
                self._check_staleness(it, round_idx, lag, parked,
                                      staleness, live)
            if divergence:
                self._check_divergence(it, round_idx, divergence)
        except Exception as e:          # detectors must never kill a run
            self.log(f"health: detector error: {e!r}")

    def summary(self):
        out = {"observations": self._obs, "alarms": self.alarms,
               "stragglers_by_worker": dict(self.straggler_counts),
               "last_alarm": self.last_alarm,
               "tau_suggestion": self.tau_suggestion}
        if self.s_suggestion is not None:
            out["s_suggestion"] = self.s_suggestion
        return out
