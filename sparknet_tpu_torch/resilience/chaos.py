"""Deterministic, seed-driven fault injection (the port of
sparknet_tpu/resilience/chaos.py, its whole grammar: a spec parses, and
fails, exactly as in the JAX package).

In the port only the serving hooks are wired: ``kill_replica``/
``kill_req`` and ``slow_replica``/``slow_ms`` in the ``serve`` verb and
the serving-fleet simulator (``simfleet --serve``). The training
injectors parse here, but the ``train`` and ``cifar`` verbs refuse
``--chaos`` until the multi-host training half lands (ROADMAP A6d).

Recovery paths that only run during real outages are recovery paths that
don't work. The ChaosMonkey injects the failure classes the resilience
subsystem claims to survive — on a schedule tests can replay exactly:

  nan_step=K       the loss observed at step K becomes NaN (once) —
                   exercises RecoveryPolicy rollback
  nan_repeat=1     ...at EVERY step >= K (persistent divergence) —
                   exercises the bounded-retry abort
  io_p=P           each data-source record read raises ChaosIOError with
                   probability P (seeded rng) — exercises retry backoff
  stall_step=K, stall_s=S   step K blocks the host for S seconds (once) —
                   exercises the watchdog stall path
  stall_worker=W   attribute the stall to mesh worker W: the injected
                   seconds land on W's per-round latency while its peers
                   finish early — a simulated straggler the health
                   detector (obs/health.py) must name
  stall_repeat=1   stall at EVERY step >= K (a persistent straggler)
  sigterm_round=R  the process SIGTERMs itself after round/block R (once)
                   — exercises snapshot-then-stop + `--resume auto`
  kill_worker=W, kill_round=R   mesh worker W "crashes" at sync round R
                   (once; R defaults to 0) — exercises the elastic
                   membership layer (resilience/elastic.py): eviction,
                   shard re-spreading, quorum accounting, readmission
  dead_p=P         each live worker independently crashes with
                   probability P at every round (seeded rng; a crashed
                   worker stays crashed until the policy readmits it)
  kill_host=H, kill_host_round=R   host (fault domain) H dies at round R
                   (once; R defaults to 0). In a real multi-process run
                   the targeted process SIGKILLs ITSELF at the round
                   gate, before announcing arrival — survivors see a
                   lease expiry, the true crash shape; in virtual
                   single-process host meshes the host is marked dead
                   like kill_worker. Exercises host eviction, the
                   no-hang gate, and coordinated restart.
  preempt_host=H, preempt_round=R, rejoin_after=K   host H is
                   PREEMPTED at round R (default 0) and rejoins K
                   rounds later through the rendezvous — the spot-fleet
                   cycle. In a real multi-process run the targeted
                   process SIGKILLs itself at the round gate (lease
                   drop; the orchestration layer relaunches it with
                   `--grow`, a real rejoin); in virtual single-process
                   host meshes the host is evicted like kill_host and
                   then ADMITTED back K rounds later
                   (ElasticPolicy.admit — a host_joined event).
  partition_host=H, partition_round=R   from round R, host H and the
                   rest of the fleet stop seeing each other's
                   heartbeats (both sides of the split independently
                   conclude the other is gone — the quorum breaks the
                   symmetry: the majority side keeps training, the
                   minority side exits 4)
  slow_host=H, slow_host_s=S, slow_host_round=R, slow_repeat=1
                   host H arrives S seconds late at the round gate
                   (once at round R, or every round with slow_repeat) —
                   the host-granularity straggler the health detectors
                   must name
  slow_worker=W, slow_s=S, slow_round=R
                   worker W is a PERSISTENT straggler from round R
                   (default 0): every local round costs it S extra
                   seconds. Synchronous solvers render it as a real
                   host stall per round (the barrier waits — round
                   latency tracks the straggler, the paper's failure
                   mode); the async bounded-staleness mode instead
                   feeds S to the virtual version clocks
                   (ElasticPolicy.advance_versions) and NEVER sleeps —
                   the round proceeds at the median worker's pace and
                   W's lag grows until it parks. The sync-vs-async
                   wall-clock gap under this injector IS the mode's
                   acceptance test (the JAX package's scripts/smoke.sh).
  slow_h2d=S       every host->device batch transfer costs S extra
                   seconds (persistent; hooked by the feed path's
                   H2DStager / round feed) — the artificially slow wire
                   under which data echoing must win wall clock
                   (the JAX package's scripts/smoke.sh)
  fail_rate=P, fail_seed=S   every round, every live host independently
                   crashes with probability P — the fleet-scale failure
                   process (MTBF model) the simulator sweeps. The draw
                   is a PER-ROUND derived rng (seeded from fail_seed and
                   the round index), so the schedule is a pure function
                   of (S, round): identical across replays and immune to
                   how many other injectors consumed randomness. Victims
                   stay down until explicitly revived (revive_host — the
                   simulator's recovery process, or a policy
                   readmission).
  fail_corr=K      correlate the failures: hosts are grouped into
                   failure domains of K consecutive ids (a rack, a
                   zone), the per-round Bernoulli is drawn PER DOMAIN,
                   and a failing domain takes all its hosts down
                   together — the correlated-outage shape quorum
                   settings must survive. K<=1 means independent hosts.
  kill_replica=R, kill_req=N   serve replica R dies after serving its
                   N-th request (N defaults to 0 — die on first). In a
                   real fleet the targeted `serve --replica R`
                   process SIGKILLs ITSELF mid-load — the router sees
                   in-flight dispatches fail and the lease lapse, the
                   true crash shape; in `simfleet --serve` the
                   virtual replica goes silent. Exercises router
                   retry-once + ElasticPolicy replica eviction.
  slow_replica=R, slow_ms=S   serve replica R pays S extra
                   milliseconds per request (persistent) — the serving
                   twin of slow_host: drives its queue depth up so the
                   router's least-depth spread and the SLO autoscaler
                   have a measurable straggler to route around.

Armed via `--chaos "nan_step=30,io_p=0.02,seed=1"` or the SPARKNET_CHAOS
env var (same spec), which data sources and solvers pick up through
active_chaos() without any plumbing. Unknown or malformed tokens raise a
ValueError naming the offending token and listing the valid injectors —
a typo'd spec must never let a resilience test pass vacuously. Every
injection logs a ``chaos`` metrics event so a report never confuses
injected faults with real ones.
"""

import os
import signal
import time

import numpy as np


class ChaosIOError(OSError):
    """An injected (not real) IO failure."""


_UNSET = object()
_active = _UNSET


def install_chaos(monkey):
    """Explicitly arm (or, with None, disarm) the process-wide monkey."""
    global _active
    _active = monkey
    return monkey


def active_chaos():
    """The process-wide ChaosMonkey, arming from SPARKNET_CHAOS on first
    use; None when chaos is off."""
    global _active
    if _active is _UNSET:
        spec = os.environ.get("SPARKNET_CHAOS", "").strip()
        _active = ChaosMonkey.parse(spec) if spec else None
    return _active


class ChaosMonkey:
    def __init__(self, nan_step=None, nan_repeat=False, io_p=0.0,
                 stall_step=None, stall_s=0.0, stall_worker=None,
                 stall_repeat=False, sigterm_round=None,
                 kill_worker=None, kill_round=0, dead_p=0.0,
                 kill_host=None, kill_host_round=0,
                 preempt_host=None, preempt_round=0, rejoin_after=1,
                 partition_host=None, partition_round=0,
                 slow_host=None, slow_host_s=0.0, slow_host_round=0,
                 slow_repeat=False,
                 slow_worker=None, slow_s=0.0, slow_round=0,
                 slow_h2d=0.0,
                 fail_rate=0.0, fail_seed=0, fail_corr=0,
                 kill_replica=None, kill_req=0,
                 slow_replica=None, slow_ms=0.0,
                 seed=0, metrics=None, log_fn=print):
        self.nan_step = None if nan_step is None else int(nan_step)
        self.nan_repeat = bool(nan_repeat)
        self.io_p = float(io_p)
        self.stall_step = None if stall_step is None else int(stall_step)
        self.stall_s = float(stall_s)
        self.stall_worker = None if stall_worker is None else int(stall_worker)
        self.stall_repeat = bool(stall_repeat)
        self._last_stall = None
        self.sigterm_round = None if sigterm_round is None \
            else int(sigterm_round)
        self.kill_worker = None if kill_worker is None else int(kill_worker)
        self.kill_round = int(kill_round)
        self.dead_p = float(dead_p)
        self._kill_fired = False
        self._dead = set()      # workers dead_p has already crashed
        # host-granularity injectors (fault domains; resilience/heartbeat)
        self.kill_host = None if kill_host is None else int(kill_host)
        self.kill_host_round = int(kill_host_round)
        self._host_kill_fired = False
        # set by a multi-process HeartbeatCoordinator: the target
        # process SIGKILLs itself (maybe_kill_self), so the virtual
        # dead_hosts rendering must not double-fire on survivors
        self.kill_host_self_mode = False
        # the preempt/rejoin cycle (spot fleets): preempt_host dies
        # like kill_host at preempt_round, then comes back through the
        # rendezvous rejoin_after rounds later (virtual hosts:
        # ElasticPolicy.admit; real runs: a relaunched --grow process)
        self.preempt_host = None if preempt_host is None \
            else int(preempt_host)
        self.preempt_round = int(preempt_round)
        self.rejoin_after = max(1, int(rejoin_after))
        self._preempt_fired = False
        self._preempted_at = None
        self._rejoin_fired = False
        self.partition_host = None if partition_host is None \
            else int(partition_host)
        self.partition_round = int(partition_round)
        self._partition_logged = False
        self.slow_host = None if slow_host is None else int(slow_host)
        self.slow_host_s = float(slow_host_s)
        self.slow_host_round = int(slow_host_round)
        self.slow_repeat = bool(slow_repeat)
        self._slow_fired = False
        self._last_slow = None
        # the worker-granularity persistent straggler (async local SGD)
        self.slow_worker = None if slow_worker is None else int(slow_worker)
        self.slow_s = float(slow_s)
        self.slow_round = int(slow_round)
        self._slow_worker_logged = False
        self._last_slow_worker = None
        # the persistent slow H2D wire (feed-path staging / echo tests)
        self.slow_h2d = float(slow_h2d)
        self._slow_h2d_logged = False
        # the fleet-scale failure process (per-round iid or
        # domain-correlated host crashes; resilience/README, sim/)
        self.fail_rate = float(fail_rate)
        if not 0.0 <= self.fail_rate <= 1.0:
            raise ValueError(f"fail_rate {self.fail_rate} must be a "
                             "probability in [0, 1]")
        self.fail_seed = int(fail_seed)
        self.fail_corr = max(0, int(fail_corr))
        self._fail_dead = set()   # hosts fail_rate already took down
        # serving-tier injectors (serve/fleet.py, sim/servefleet.py)
        self.kill_replica = None if kill_replica is None \
            else int(kill_replica)
        self.kill_req = int(kill_req)
        self._replica_kill_fired = False
        self.slow_replica = None if slow_replica is None \
            else int(slow_replica)
        self.slow_ms = float(slow_ms)
        self._slow_replica_logged = False
        self._rng = np.random.RandomState(seed)
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self._nan_fired = False
        self._stall_fired = False
        self._term_fired = False
        self.injected = 0

    @classmethod
    def parse(cls, spec, **kw):
        """"nan_step=30,io_p=0.05,stall_step=10,stall_s=2,sigterm_round=3,
        seed=1" -> ChaosMonkey. Unknown keys AND malformed values are an
        error naming the offending token and listing the valid injectors
        — a typo'd chaos spec silently injecting nothing would fake a
        green resilience test."""
        def truthy(v):
            return v not in ("0", "false", "False", "")
        known = {"nan_step": int, "nan_repeat": truthy, "io_p": float,
                 "stall_step": int, "stall_s": float,
                 "stall_worker": int, "stall_repeat": truthy,
                 "sigterm_round": int, "kill_worker": int,
                 "kill_round": int, "dead_p": float,
                 "kill_host": int, "kill_host_round": int,
                 "preempt_host": int, "preempt_round": int,
                 "rejoin_after": int,
                 "partition_host": int, "partition_round": int,
                 "slow_host": int, "slow_host_s": float,
                 "slow_host_round": int, "slow_repeat": truthy,
                 "slow_worker": int, "slow_s": float, "slow_round": int,
                 "slow_h2d": float,
                 "fail_rate": float, "fail_seed": int, "fail_corr": int,
                 "kill_replica": int, "kill_req": int,
                 "slow_replica": int, "slow_ms": float,
                 "seed": int}
        valid = f"valid injectors: {', '.join(sorted(known))}"
        fields = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, eq, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if not eq:
                raise ValueError(f"chaos spec token {part!r}: expected "
                                 f"key=value; {valid}")
            if k not in known:
                raise ValueError(f"chaos spec token {part!r}: unknown "
                                 f"injector {k!r}; {valid}")
            try:
                fields[k] = known[k](v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"chaos spec token {part!r}: bad value {v!r} for "
                    f"{k} (expects {known[k].__name__}); {valid}") from None
        return cls(**fields, **kw)

    def _event(self, kind, **fields):
        self.injected += 1
        self.log(f"[chaos] injecting {kind} "
                 + " ".join(f"{k}={v}" for k, v in fields.items()))
        if self.metrics is not None:
            self.metrics.log("chaos", kind=kind, **fields)

    # -- injectors ---------------------------------------------------------
    def poison_loss(self, it):
        """True when the loss at step ``it`` should be replaced by NaN."""
        if self.nan_step is None or it < self.nan_step:
            return False
        if self._nan_fired and not self.nan_repeat:
            return False
        if not self._nan_fired:
            self._event("nan", iter=it)
        self._nan_fired = True
        return True

    def maybe_io_error(self, where=""):
        if self.io_p > 0 and self._rng.random_sample() < self.io_p:
            self._event("io_error", where=where)
            raise ChaosIOError(f"injected IO error reading {where or '?'}")

    def maybe_stall(self, it):
        """Block the host for stall_s at/after stall_step (every step
        with stall_repeat). Returns the seconds injected (0.0 if none)
        and records the attribution for pop_stall()."""
        if self.stall_step is None or it < self.stall_step \
                or self.stall_s <= 0:
            return 0.0
        if self._stall_fired and not self.stall_repeat:
            return 0.0
        self._stall_fired = True
        ev = {"iter": it, "seconds": self.stall_s}
        if self.stall_worker is not None:
            ev["worker"] = self.stall_worker
        self._event("stall", **ev)
        self._last_stall = (self.stall_worker, self.stall_s)
        time.sleep(self.stall_s)
        return self.stall_s

    def pop_stall(self):
        """(worker, seconds) of the stall injected since the last call,
        or None — how the sync-round latency probe attributes the
        injected straggler to a worker."""
        rep, self._last_stall = self._last_stall, None
        return rep

    def dead_workers(self, round_, n_workers):
        """Worker indices newly "crashed" at sync round ``round_`` —
        the elastic membership layer evicts them (reason chaos_kill).
        kill_worker fires once at kill_round; dead_p is a per-round,
        per-worker seeded Bernoulli whose victims stay down (until the
        policy readmits them — a replacement arriving)."""
        out = []
        if self.kill_worker is not None and not self._kill_fired \
                and round_ >= self.kill_round:
            self._kill_fired = True
            if 0 <= self.kill_worker < n_workers:
                self._event("kill_worker", worker=self.kill_worker,
                            round=round_)
                out.append(self.kill_worker)
        if self.dead_p > 0:
            for w in range(int(n_workers)):
                if w in self._dead or w in out:
                    continue
                if self._rng.random_sample() < self.dead_p:
                    self._dead.add(w)
                    self._event("kill_worker", worker=w, round=round_,
                                via="dead_p")
                    out.append(w)
        return out

    def maybe_sigterm(self, round_):
        if self.sigterm_round is not None and not self._term_fired \
                and round_ >= self.sigterm_round:
            self._term_fired = True
            self._event("sigterm", round=round_)
            os.kill(os.getpid(), signal.SIGTERM)

    # -- host-granularity injectors (fault domains) ------------------------
    def fail_rate_victims(self, round_, n_hosts):
        """Host ids the fail_rate process newly takes down at round
        ``round_``. The Bernoulli draws come from a rng derived from
        (fail_seed, round_) alone — a pure function of the schedule, so
        replays and sweeps see identical failures no matter what other
        injectors drew from the shared rng or how often this round was
        polled. With fail_corr=K > 1 the draw is per failure DOMAIN of K
        consecutive host ids and a failing domain dies as one."""
        if self.fail_rate <= 0 or n_hosts <= 0:
            return []
        rng = np.random.RandomState(
            (self.fail_seed * 1000003 + int(round_)) % (2 ** 32))
        n_hosts = int(n_hosts)
        corr = self.fail_corr if self.fail_corr > 1 else 1
        n_domains = -(-n_hosts // corr)         # ceil
        draws = rng.random_sample(n_domains)
        out = []
        for d in range(n_domains):
            if draws[d] >= self.fail_rate:
                continue
            for h in range(d * corr, min((d + 1) * corr, n_hosts)):
                if h not in self._fail_dead:
                    self._fail_dead.add(h)
                    out.append(h)
        if out:
            self._event("fail_rate", hosts=out, round=int(round_),
                        corr=self.fail_corr)
        return out

    def revive_host(self, host):
        """Forget a fail_rate/dead_p crash for ``host`` so the failure
        process can take it down again — the simulator's (or an
        autoscaler's) recovery half of the MTBF cycle."""
        self._fail_dead.discard(int(host))
        self._dead.discard(int(host))

    def dead_hosts(self, round_, n_hosts):
        """Host ids newly "crashed" at round ``round_`` — the virtual
        (single-process host mesh) rendering of kill_host, consumed by
        an ElasticPolicy(unit="host") exactly like dead_workers."""
        out = []
        if self.kill_host is not None and not self._host_kill_fired \
                and not self.kill_host_self_mode \
                and round_ >= self.kill_host_round:
            self._host_kill_fired = True
            if 0 <= self.kill_host < n_hosts:
                self._event("kill_host", host=self.kill_host, round=round_)
                out.append(self.kill_host)
        if self.preempt_host is not None and not self._preempt_fired \
                and not self.kill_host_self_mode \
                and round_ >= self.preempt_round:
            self._preempt_fired = True
            if 0 <= self.preempt_host < n_hosts:
                self._event("preempt_host", host=self.preempt_host,
                            round=round_)
                self._preempted_at = round_
                out.append(self.preempt_host)
        if not self.kill_host_self_mode:
            out.extend(h for h in self.fail_rate_victims(round_, n_hosts)
                       if h not in out)
        return out

    def rejoining_hosts(self, round_):
        """Host ids rejoining through the rendezvous at ``round_`` —
        the second half of preempt_host: rejoin_after rounds after the
        virtual preemption the host is back and ElasticPolicy ADMITS
        it (a host_joined event). Empty until the preempt fired, and
        always empty in real multi-process runs (kill_host_self_mode),
        where the rejoin is a real relaunched `--grow` process."""
        if self._rejoin_fired or self._preempted_at is None:
            return []
        if round_ - self._preempted_at < self.rejoin_after:
            return []
        self._rejoin_fired = True
        self._event("rejoin_host", host=self.preempt_host, round=round_)
        return [self.preempt_host]

    def maybe_kill_self(self, host, round_, on_kill=None):
        """The REAL multi-process rendering of kill_host: the targeted
        process dies by SIGKILL at the round gate, before announcing
        arrival — no cleanup, no snapshot, exactly what a preemption or
        OOM kill looks like to the survivors (lease expiry). ``on_kill``
        runs first (stop heartbeating so the last lease predates the
        corpse)."""
        if self.kill_host is None or host != self.kill_host \
                or round_ < self.kill_host_round or self._host_kill_fired:
            return False
        self._host_kill_fired = True
        self._event("kill_host", host=host, round=round_, via="SIGKILL")
        if on_kill is not None:
            try:
                on_kill()
            except Exception:
                pass
        os.kill(os.getpid(), signal.SIGKILL)
        return True                           # not reached

    def maybe_preempt_self(self, host, round_, on_kill=None):
        """The REAL multi-process rendering of preempt_host: identical
        crash shape to maybe_kill_self (SIGKILL at the gate, lease
        expiry on the survivors), but the orchestration layer —
        scripts/smoke.sh's resize stage, an autoscaler — relaunches
        the corpse with `--grow`, turning the cycle into a real rejoin
        through the rendezvous."""
        if self.preempt_host is None or host != self.preempt_host \
                or round_ < self.preempt_round or self._preempt_fired:
            return False
        self._preempt_fired = True
        self._event("preempt_host", host=host, round=round_, via="SIGKILL")
        if on_kill is not None:
            try:
                on_kill()
            except Exception:
                pass
        os.kill(os.getpid(), signal.SIGKILL)
        return True                           # not reached

    def host_partitioned(self, a, b, round_):
        """True when hosts ``a`` and ``b`` can't see each other's
        heartbeats at ``round_`` — partition_host cuts the target off
        from the whole fleet (both directions)."""
        if self.partition_host is None or round_ < self.partition_round \
                or round_ < 0:
            return False
        cut = a != b and self.partition_host in (a, b)
        if cut and not self._partition_logged:
            self._partition_logged = True
            self._event("partition_host", host=self.partition_host,
                        round=round_)
        return cut

    def maybe_slow_host(self, host, round_):
        """Delay host ``host`` by slow_host_s at the round gate (once at
        slow_host_round, every round with slow_repeat). Returns the
        injected seconds; pop_slow_host() reports the attribution."""
        if self.slow_host is None or host != self.slow_host \
                or round_ < self.slow_host_round or self.slow_host_s <= 0:
            return 0.0
        if self._slow_fired and not self.slow_repeat:
            return 0.0
        self._slow_fired = True
        self._event("slow_host", host=host, round=round_,
                    seconds=self.slow_host_s)
        self._last_slow = (host, self.slow_host_s)
        time.sleep(self.slow_host_s)
        return self.slow_host_s

    def pop_slow_host(self):
        """(host, seconds) of the slow-host injection since the last
        call, or None — how the round-latency probe attributes the
        host-granularity straggler."""
        rep, self._last_slow = self._last_slow, None
        return rep

    # -- the persistent worker straggler (async bounded staleness) ---------
    def slow_worker_spec(self, round_):
        """(worker, extra_seconds) when the slow_worker injector is
        active at ``round_``, else None — the NON-BLOCKING query the
        async scheduler feeds to its virtual version clocks (the
        straggler pays its seconds on its own clock, never on the
        consensus's). Logs one ``slow_worker`` chaos event on first
        activation."""
        if self.slow_worker is None or round_ < self.slow_round \
                or self.slow_s <= 0:
            return None
        if not self._slow_worker_logged:
            self._slow_worker_logged = True
            self._event("slow_worker", worker=self.slow_worker,
                        round=round_, seconds=self.slow_s)
        return (self.slow_worker, self.slow_s)

    def maybe_slow_worker(self, round_):
        """The SYNCHRONOUS rendering of slow_worker: the barrier waits,
        so the whole round blocks for the straggler's extra seconds
        (every round from slow_round on — a persistent straggler).
        Returns the injected seconds; pop_slow_worker() reports the
        attribution for the round-latency probe."""
        spec = self.slow_worker_spec(round_)
        if spec is None:
            return 0.0
        self._last_slow_worker = spec
        time.sleep(spec[1])
        return spec[1]

    def pop_slow_worker(self):
        """(worker, seconds) of the sync slow-worker stall since the
        last call, or None."""
        rep, self._last_slow_worker = self._last_slow_worker, None
        return rep

    # -- the slow H2D wire (input-pipeline staging/echo) --------------------
    def maybe_slow_h2d(self, nbytes=0):
        """Delay the current host->device batch transfer by slow_h2d
        seconds (persistent — every FRESH transfer pays; echoed batches
        don't transfer, which is exactly the wall-clock edge the echo
        smoke test asserts). Logs one chaos event on first activation."""
        if self.slow_h2d <= 0:
            return 0.0
        if not self._slow_h2d_logged:
            self._slow_h2d_logged = True
            self._event("slow_h2d", seconds=self.slow_h2d,
                        nbytes=int(nbytes))
        time.sleep(self.slow_h2d)
        return self.slow_h2d

    # -- serving-tier injectors (replica fleets) ----------------------------
    def replica_kill_due(self, replica, served):
        """True once replica ``replica`` has served ``served`` >=
        kill_req requests — the non-firing query both renderings share
        (the simulator silences the virtual replica; the real process
        calls maybe_kill_replica_self). One-shot."""
        if self.kill_replica is None or replica != self.kill_replica \
                or self._replica_kill_fired or served < self.kill_req:
            return False
        self._replica_kill_fired = True
        self._event("kill_replica", replica=replica, served=int(served))
        return True

    def maybe_kill_replica_self(self, replica, served, on_kill=None):
        """The REAL fleet rendering of kill_replica: the targeted
        `serve --replica R` process dies by SIGKILL after its
        kill_req-th request — in-flight dispatches fail at the router
        and the lease lapses, exactly what an OOM kill mid-load looks
        like. ``on_kill`` runs first (stop heartbeating so the last
        lease predates the corpse)."""
        if not self.replica_kill_due(replica, served):
            return False
        if on_kill is not None:
            try:
                on_kill()
            except Exception:
                pass
        os.kill(os.getpid(), signal.SIGKILL)
        return True                           # not reached

    def replica_slow_spec(self, replica):
        """(replica, extra_seconds_per_request) when the slow_replica
        injector targets ``replica``, else None. Non-blocking — the
        simulator adds the seconds to virtual service time; the real
        serve loop sleeps them (maybe_slow_replica). Logs one chaos
        event on first activation."""
        if self.slow_replica is None or replica != self.slow_replica \
                or self.slow_ms <= 0:
            return None
        if not self._slow_replica_logged:
            self._slow_replica_logged = True
            self._event("slow_replica", replica=replica,
                        ms=self.slow_ms)
        return (self.slow_replica, self.slow_ms / 1e3)

    def maybe_slow_replica(self, replica):
        """The REAL rendering of slow_replica: the serve loop sleeps
        slow_ms before answering each request (persistent straggler).
        Returns the injected seconds."""
        spec = self.replica_slow_spec(replica)
        if spec is None:
            return 0.0
        time.sleep(spec[1])
        return spec[1]
