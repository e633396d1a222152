"""FleetSim — thousands of virtual hosts driving the real control plane.

One simulated fleet is: a shared MemDir rendezvous directory, one REAL
HeartbeatCoordinator per virtual host (the same class production runs,
via the Clock/Dir seam), one fleet-level ElasticPolicy(unit="host"),
and optionally the real FileConsensus/AsyncFileConsensus,
RecoveryPolicy and RetryPolicy — all unmodified. The simulator itself
only orchestrates: it schedules beats and round arrivals as events,
renders the chaos failure processes as hosts going silent, and lets the
protocol code discover everything the way it does on metal (leases
expire, gates time out, the policy evicts, the cooldown readmits).

Per round r:

  1. failure processes fire: chaos ``dead_hosts``/``fail_rate`` victims
     and scheduled deaths stop beating (their leases simply lapse —
     evictions flow through the real lease-expiry path, never injected
     directly into the policy); rejoining/recovered hosts resume
     beating and are admitted (via="rejoin"), mirroring
     ElasticPolicy.observe_round's own chaos branch.
  2. every live host draws a round duration (seeded jitter around
     round_s = tau x step_s; chaos stragglers pay extra) and its
     arrival (announce_round) is scheduled at that offset.
  3. the OBSERVER — the lowest live host, exactly the authority rule
     FileConsensus uses — runs the real gate(): its poll loop sleeps on
     the SimClock, which fires the pending beats/arrivals, and dead
     peers surface when their receipt age crosses lease_s.
  4. gate.dead is fed to ElasticPolicy.evict(reason "lease_expired")
     with QuorumLost deferred until survivors are recorded — the exact
     sequencing of the production round loop
     (parallel/data_parallel.py).
  5. at small fleets the real consensus transport runs over the MemDir
     (sync: post-then-exchange with the lowest-host mask authority;
     async: versioned deltas, parking on lag > s); at scale the
     policy-level virtual version clocks model staleness instead.
  6. surrogate losses drive RecoveryPolicy (chaos nan_step) and a
     surrogate ingest read drives RetryPolicy (chaos io_p) — both real,
     both sleeping on the SimClock.
  7. one closed-schema ``sim`` metrics event summarizes the round, and
     the standard host_round/host_alive/host_evicted/... events flow
     from the protocol code itself, so the `report`/`monitor` verbs
     render a simulated fleet with zero special cases.

Determinism: every random draw comes from seeded numpy generators, all
scheduling from the SimClock — same spec, same timeline, to the event.
"""

import numpy as np

from ..resilience.chaos import ChaosMonkey
from ..resilience.elastic import ElasticPolicy, QuorumLost
from ..resilience.heartbeat import (AsyncFileConsensus, FileConsensus,
                                    HeartbeatCoordinator)
from ..resilience.recovery import RecoveryAbort, RecoveryPolicy
from ..resilience.retry import RetryExhausted, RetryPolicy
from .clock import SimClock
from .memdir import MemDir

#: the real consensus transports exchange whole parameter sets per host
#: per round — rich, but O(hosts^2) loads; above this fleet size the
#: policy-level version clocks model staleness instead
CONSENSUS_MAX_HOSTS = 8


def _quiet(*a, **k):
    pass


class _SurrogateSolver:
    """The minimal solver surface RecoveryPolicy snapshots/rewinds
    (note_good/_rollback): numpy state standing in for the device
    training state, at zero device cost."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self.params = {"w": rng.normal(size=8).astype(np.float32)}
        self.state = {"m": np.zeros(8, np.float32)}
        self.history = {"loss": np.zeros(4, np.float32)}
        self.rng = np.zeros(2, np.uint32)
        self.iter = 0
        self._it_dev = None
        self._smoothed = {}


class FleetSim:
    """One simulated fleet run. ``run()`` returns a summary dict; the
    metrics stream (if a logger is given) carries the full story.

    hosts/rounds        fleet size and simulated round count
    interval_s/lease_s  the real heartbeat knobs, in simulated seconds
    tau, step_s         round_s = tau * step_s unless round_s is given
                        directly — sweeping tau changes how much round
                        compute amortizes each gate
    jitter              per-host per-round duration jitter (std dev as
                        a fraction of round_s, seeded)
    quorum/evict_after/readmit_after/staleness/s_decay/unpark_after
                        passed straight to the real ElasticPolicy
    consensus           "auto" | "sync" | "async" | "none" — auto picks
                        the real transport at <= CONSENSUS_MAX_HOSTS
                        hosts (async when staleness is set)
    chaos               a ChaosMonkey (or spec string) driving the
                        failure processes
    deaths/rejoins      {host: round} hard schedules (replay validation
                        uses these instead of probabilistic chaos)
    recover_after       revive chaos-killed hosts after this many
                        rounds (0 = never) — the repair half of the
                        MTBF cycle fail_rate models
    """

    def __init__(self, hosts=8, rounds=20, interval_s=0.5, lease_s=3.0,
                 round_s=None, jitter=0.15, tau=4, step_s=0.25,
                 quorum=1, evict_after=1, readmit_after=0,
                 staleness=None, s_decay=0.5, unpark_after=1,
                 consensus="auto", recover_after=0,
                 deaths=None, rejoins=None, chaos=None,
                 nan_recovery=True, seed=0, metrics=None, log_fn=None):
        self.n = int(hosts)
        self.rounds = int(rounds)
        self.interval_s = float(interval_s)
        self.lease_s = float(lease_s)
        self.round_s = float(round_s) if round_s is not None \
            else float(tau) * float(step_s)
        self.jitter = float(jitter)
        self.tau = int(tau)
        self.recover_after = int(recover_after)
        self.deaths = {int(h): int(r) for h, r in (deaths or {}).items()}
        self.rejoins = {int(h): int(r) for h, r in (rejoins or {}).items()}
        self.metrics = metrics
        self.log = log_fn or _quiet
        self.clock = SimClock()
        self.dirops = MemDir(self.clock)
        if isinstance(chaos, str):
            chaos = ChaosMonkey.parse(chaos, metrics=metrics,
                                      log_fn=self.log) if chaos else None
        self.chaos = chaos
        self.staleness = None if staleness is None else int(staleness)
        if consensus == "auto":
            consensus = "none" if self.n > CONSENSUS_MAX_HOSTS else \
                ("async" if self.staleness is not None else "sync")
        self.consensus = consensus
        self.rng = np.random.RandomState(seed)
        # the real control plane, on the simulated seam
        self.coords = [
            HeartbeatCoordinator(self.dirops.root, host=h, n_hosts=self.n,
                                 interval_s=self.interval_s,
                                 lease_s=self.lease_s, metrics=metrics,
                                 log_fn=_quiet, chaos=None,
                                 clock=self.clock, dirops=self.dirops)
            for h in range(self.n)]
        self.policy = ElasticPolicy(
            n_workers=self.n, quorum=int(quorum),
            evict_after=int(evict_after),
            readmit_after=int(readmit_after), metrics=metrics,
            log_fn=self.log, chaos=None, unit="host",
            staleness=self.staleness, s_decay=float(s_decay),
            unpark_after=int(unpark_after))
        if self.consensus == "sync":
            self.fc = [FileConsensus(c) for c in self.coords]
        elif self.consensus == "async":
            self.fc = [AsyncFileConsensus(c, s=self.staleness or 0,
                                          decay=float(s_decay))
                       for c in self.coords]
        else:
            self.fc = None
        # per-host surrogate weights only exist when a transport runs
        self.leaves = [np.full(16, float(h), np.float64)
                       for h in range(self.n)] if self.fc else None
        self.recovery = None
        self.solver = None
        if nan_recovery and self.chaos is not None \
                and getattr(self.chaos, "nan_step", None) is not None:
            self.solver = _SurrogateSolver(seed)
            self.recovery = RecoveryPolicy(metrics=metrics,
                                           log_fn=self.log)
        self.retry = None
        if self.chaos is not None and getattr(self.chaos, "io_p", 0) > 0:
            self.retry = RetryPolicy(attempts=4, base_s=self.interval_s / 4,
                                     sleep=self.clock.sleep,
                                     metrics=metrics, log_fn=self.log)
        # simulator-side host state (who is actually running)
        self.up = [True] * self.n
        self.died_at = {}
        self.announced = [-1] * self.n
        self.gate_waits = []
        self.retry_exhausted = 0
        self.recovery_aborted = False
        self.quorum_lost = False

    # -- event plumbing ------------------------------------------------------
    def _schedule_beat(self, h, delay):
        def fire():
            if self.up[h]:
                self.coords[h].beat()
                self._schedule_beat(h, self.interval_s)
        self.clock.after(delay, fire)

    def _schedule_arrival(self, h, r, delay):
        def fire():
            if self.up[h] and self.announced[h] < r:
                self.announced[h] = r
                self.coords[h].announce_round(r)
        self.clock.after(delay, fire)

    def _kill(self, h, r):
        """A host dies: it simply stops beating. Nothing tells the
        policy — the observer's gate discovers the lapsed lease, the
        real path."""
        if self.up[h]:
            self.up[h] = False
            self.died_at[h] = r
            self.log(f"sim: host {h} went silent at round {r}")

    def _revive(self, h, r):
        """A host comes back: it resumes beating at the current round
        front and is admitted (via="rejoin") exactly as
        ElasticPolicy.observe_round's chaos branch admits virtual
        rejoiners."""
        if self.up[h]:
            return
        self.up[h] = True
        self.died_at.pop(h, None)
        if self.chaos is not None:
            self.chaos.revive_host(h)
        self.announced[h] = r - 1
        self.coords[h].announce_round(r - 1)
        self._schedule_beat(h, 0.0)
        self.policy.admit(h, r, via="rejoin")

    # -- the run -------------------------------------------------------------
    def _failures(self, r):
        newly = []
        if self.chaos is not None:
            newly.extend(self.chaos.dead_hosts(r, self.n))
        newly.extend(h for h, rr in self.deaths.items()
                     if rr == r and self.up[h])
        for h in newly:
            if 0 <= h < self.n:
                self._kill(h, r)
        back = []
        if self.chaos is not None:
            back.extend(self.chaos.rejoining_hosts(r))
        back.extend(h for h, rr in self.rejoins.items() if rr == r)
        if self.recover_after:
            back.extend(h for h, d in list(self.died_at.items())
                        if r - d >= self.recover_after)
        for h in sorted(set(back)):
            if 0 <= h < self.n:
                self._revive(h, r)

    def _consensus_round(self, r, live_up, losses):
        order = sorted(live_up)
        if self.consensus == "sync":
            # pre-post every contribution, then exchange authority
            # (lowest host) first: the mask decision finds all parts
            # in place and nobody polls — the async transport never
            # waits by construction, so it needs no pre-post
            for h in order:
                self.fc[h]._post(r, [self.leaves[h]], True, losses[h])
        for h in order:
            out, aux = self.fc[h].exchange(r, [self.leaves[h]], True,
                                           losses[h], live_up)
            self.leaves[h] = np.asarray(out[0], np.float64)

    def _surrogates(self, r, loss):
        if self.retry is not None:
            def _read():
                self.chaos.maybe_io_error("sim-ingest")
                return True
            try:
                self.retry.call(_read, where="sim-ingest")
            except RetryExhausted:
                self.retry_exhausted += 1
        if self.recovery is not None and not self.recovery_aborted:
            if self.chaos.poison_loss(r):
                loss = float("nan")
            try:
                if not self.recovery.observe(self.solver, loss):
                    self.solver.iter += 1
            except RecoveryAbort:
                self.recovery_aborted = True

    def run(self):
        rng = self.rng
        for h in range(self.n):
            self._schedule_beat(h, rng.uniform(0.0, self.interval_s))
        r = 0
        while r < self.rounds:
            self._failures(r)
            if not any(self.up):
                self.quorum_lost = True
                break
            obs = next(h for h in range(self.n) if self.up[h])
            durs = self.round_s * np.clip(
                rng.normal(1.0, self.jitter, self.n), 0.4, 3.0)
            slow = self.chaos.slow_worker_spec(r) \
                if self.chaos is not None else None
            if slow is not None and 0 <= int(slow[0]) < self.n:
                durs[int(slow[0])] += float(slow[1])
            for h in range(self.n):
                if h != obs and self.up[h]:
                    self._schedule_arrival(h, r, durs[h])
            # the observer does its own round work, then gates — its
            # sleep is where everyone else's beats and arrivals fire
            self.clock.sleep(float(durs[obs]))
            self.announced[obs] = r
            expect = set(self.policy.live()) - {obs}
            res = self.coords[obs].gate(r, expect=expect, timeout=None)
            self.gate_waits.append(res.wait_s)
            # eviction sequencing exactly as the production round loop:
            # record every survivor-visible death, defer QuorumLost
            ql = False
            for h in res.dead:
                try:
                    self.policy.evict(h, r, "lease_expired")
                except QuorumLost:
                    ql = True
            base_loss = 2.5 * float(np.exp(-3.0 * r / self.rounds)) \
                + float(rng.normal(0.0, 0.01))
            if not ql and self.fc is not None:
                live_up = [h for h in self.policy.live() if self.up[h]]
                if live_up:
                    losses = {h: base_loss + 0.01 * h for h in live_up}
                    self._consensus_round(r, live_up, losses)
            if self.staleness is not None and self.consensus != "async":
                # at scale the policy-level virtual clocks model
                # bounded staleness (no transport needed)
                self.policy.advance_versions(r, self.round_s, slow=slow)
                self.policy.observe_staleness(r)
            self._surrogates(r, base_loss)
            if not ql:
                try:
                    self.policy.observe_round(r)
                except QuorumLost:
                    ql = True
            if self.metrics is not None:
                self.metrics.log(
                    "sim", round=r,
                    t_s=round(self.clock.monotonic(), 3), hosts=self.n,
                    live=self.policy.live_count(),
                    parked=int(self.policy.parked.sum()),
                    dead=len(res.dead), wait_s=round(res.wait_s, 4),
                    evictions=len(self.policy.evictions),
                    readmissions=len(self.policy.readmissions),
                    admissions=len(self.policy.admissions))
            if ql:
                self.quorum_lost = True
                self.log(f"sim: QUORUM LOST at round {r} "
                         f"({self.policy.live_count()} live / "
                         f"quorum {self.policy.quorum}); fleet halts "
                         "for coordinated restart")
                break
            r += 1
        return self.summary(rounds_done=r)

    def summary(self, rounds_done=None):
        w = np.asarray(self.gate_waits or [0.0], np.float64)
        out = {"hosts": self.n,
               "rounds": int(rounds_done if rounds_done is not None
                             else self.rounds),
               "sim_s": round(self.clock.monotonic(), 3),
               "round_s": self.round_s, "tau": self.tau,
               "lease_s": self.lease_s, "interval_s": self.interval_s,
               "consensus": self.consensus,
               "quorum": self.policy.quorum,
               "live_final": self.policy.live_count(),
               "quorum_lost": bool(self.quorum_lost
                                   or self.policy.quorum_lost),
               "evictions": len(self.policy.evictions),
               "readmissions": len(self.policy.readmissions),
               "admissions": len(self.policy.admissions),
               "parks": len(self.policy.parks),
               "unparks": len(self.policy.unparks),
               "retry_exhausted": self.retry_exhausted,
               "rollbacks": (self.recovery.rollbacks
                             if self.recovery else 0),
               "recovery_aborted": self.recovery_aborted,
               "gate_wait_s": {
                   "mean": round(float(w.mean()), 4),
                   "p50": round(float(np.percentile(w, 50)), 4),
                   "p95": round(float(np.percentile(w, 95)), 4),
                   "max": round(float(w.max()), 4)}}
        if self.staleness is not None:
            out["staleness"] = self.staleness
            out["max_lag"] = int(self.policy.lag().max())
        return out
