"""Host-level fault domains: leased heartbeats over one shared directory
(the membership half of sparknet_tpu/resilience/heartbeat.py).

A dead process cannot be detected from inside a collective — the
collective just hangs — so the liveness channel lives entirely on the
host side, in plain Python with no torch in it:

  HeartbeatCoordinator  each process leases its liveness into a shared
                        rendezvous directory (atomic JSON writes, a
                        background writer thread), a monitor view marks
                        peers dead on lease expiry, and the pre-round
                        ``gate()`` dispatches a round only after every
                        live peer arrived at it — a dead peer costs an
                        eviction, never a hang. The serving fleet
                        (serve/fleet.py) leases each replica through it.
  fresh_leases          the unexpired leases of a rendezvous directory,
                        read without a coordinator (a router, a late
                        joiner).
  FileConsensus         the tau-interval cross-host weight average
                        executed THROUGH the rendezvous directory — the
                        port's cross-process tier (it has no collective
                        across processes), and a faithful rendering of
                        the paper's own architecture: SparkNet's driver
                        collected and re-broadcast weights every tau
                        steps; here the shared filesystem is the driver,
                        the masked average is the consensus, and tau
                        amortizes the slow transport.
  AsyncFileConsensus    its bounded-staleness twin: versioned deltas, a
                        barrier-free merge.
  restart_barrier       coordinated restart: on quorum loss every
                        surviving process converges on the SAME
                        checkpoint manifest (barrier on the manifest
                        file's sha256) before exiting EXIT_QUORUM_LOST
                        (4), so a supervisor relaunch resumes one
                        consistent world.
  manifest_sha          the sha256 of a checkpoint manifest.

The files and their layout are the JAX module's, so a JAX host and a
port host share one rendezvous directory.

Time and storage go through the injectable seam (resilience/seam.py):
``clock`` (wall stamps, MONOTONIC durations, sleep) and ``dirops``
(atomic name-based file ops). The defaults are the process wall clock
and the real directory, while the serving-fleet simulator (sim/) injects
a discrete-event clock and an in-memory directory and runs this exact
code. Two time disciplines, deliberately split:

  * durations and deadlines (lease ages, gate timeouts, the startup
    grace) are computed on ``clock.monotonic()`` — an NTP step or
    suspend/resume must never mass-expire every peer's lease;
  * the stamps WRITTEN to disk stay wall-clock (human-readable, and
    the only time base two processes on different machines share).
    Cross-process stamp comparisons happen only where they must:
    startup ghost reaping and late-joiner discovery, where the other
    process may be long dead.

Lease freshness bridges the two: a peer's age is measured monotonically
from the moment THIS process last observed a new lease record (its
seq/stamp advanced); the on-disk wall stamp only seeds the age the
first time a pre-existing record is seen (a ghost's stale lease must
still read as old).

Rendezvous directory layout, the JAX package's, so a JAX process and a
port process lease into one directory:

  hb-<host>.json        the lease: {host, seq, round, stamp, mono, ...}
                        rewritten atomically by the writer thread every
                        ``interval_s`` and at every round arrival
  part-<host>-<r>.npz   FileConsensus: host's post-round contribution
                        (a ``meta`` uint8 JSON and ``leaf<i>`` arrays)
  mask-<r>.json         FileConsensus: the round's membership decided
                        by the lowest-indexed live host
  delta-<host>-<v>.*    AsyncFileConsensus: versioned contributions
  consensus-<v>.*       AsyncFileConsensus: the merged versions
  restart-<host>.json   restart_barrier: the manifest sha this host
                        will resume from
"""

import glob
import hashlib
import json
import os
import threading
import time

import numpy as np

from .seam import WALL_CLOCK, RealDir


def _read_json(path):
    """Parse a JSON file, or None — a torn write must read as absent,
    not an error (the writer re-writes within interval_s)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


class _HeartbeatDir(RealDir):
    """The default Dir seam, reading through this module's late-bound
    ``_read_json`` so tests can inject torn/racy reads exactly as they
    always have."""

    def read_json(self, name):
        return _read_json(self.path(name))


def fresh_leases(directory, lease_s, now=None, dirops=None):
    """{host: lease record} for every UNEXPIRED hb-*.json lease in a
    rendezvous dir — the running world a late joiner (`--grow`)
    discovers before it has a coordinator of its own (it picks host id
    max(existing)+1 and leases itself into the same directory). Wall
    stamps compared against wall ``now``: the prober has no receipt
    history yet, and the leaseholders are other processes."""
    now = time.time() if now is None else now
    if dirops is None:
        recs = (_read_json(p) for p in glob.glob(os.path.join(
            glob.escape(str(directory)), "hb-*.json")))
    else:
        recs = (dirops.read_json(n) for n in dirops.glob("hb-*.json"))
    out = {}
    for rec in recs:
        if rec is None or not isinstance(rec.get("host"), int):
            continue
        if now - float(rec.get("stamp", 0.0)) <= float(lease_s):
            out[rec["host"]] = rec
    return out


class HostDead(RuntimeError):
    """A peer host's lease expired (reported by gate/exchange)."""


class GateResult:
    """What the pre-round rendezvous saw: which hosts arrived at the
    round, which leases expired while waiting, and the wait itself —
    the cross-host round-latency signal the obs layer renders."""

    def __init__(self, arrived, dead, wait_s):
        self.arrived = sorted(arrived)
        self.dead = sorted(dead)
        self.wait_s = float(wait_s)


class HeartbeatCoordinator:
    """One process's end of the liveness protocol.

    Thread contract: a background writer/monitor thread re-leases this
    host's heartbeat and refreshes the peer view while the training
    loop reads it; the mutable shared state (seq/round counters, the
    published liveness view, the lease-receipt table, the stop flag) is
    guarded by ``_lock``.
    Configuration fields (dir/host/lease_s/...) are immutable after
    __init__; the world size ``n`` is the one exception —
    admit_host() GROWS it (with the view arrays, under ``_lock``) when
    a late-started `--grow` process leases itself into the rendezvous
    dir mid-run.

    ``clock``/``dirops``: the time + storage seam (resilience/seam.py).
    Leave at None for production (wall clock, real directory); the
    fleet simulator injects SimClock/MemDir and this class runs
    unchanged against virtual time."""

    def __init__(self, directory, host=None, n_hosts=None, interval_s=0.5,
                 lease_s=3.0, metrics=None, log_fn=print, chaos=None,
                 clock=None, dirops=None, payload_fn=None):
        if host is None or n_hosts is None:
            raise ValueError("heartbeat needs host= (this process's id) "
                             "and n_hosts= (the world size)")
        self.dir = str(directory)
        self.clock = WALL_CLOCK if clock is None else clock
        # the default Dir seam creates the rendezvous dir on disk; an
        # injected one (the simulator's MemDir) owns its own storage
        self.dirops = _HeartbeatDir(self.dir) if dirops is None else dirops
        self.host = int(host)
        self.n = int(n_hosts)
        if not (0 <= self.host < self.n):
            raise ValueError(f"host {self.host} outside world {self.n}")
        self.interval_s = float(interval_s)
        self.lease_s = float(lease_s)
        if self.lease_s <= self.interval_s:
            raise ValueError(f"lease_s {self.lease_s} must exceed the "
                             f"heartbeat interval_s {self.interval_s}")
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self.chaos = chaos
        # optional beat payload: a callable returning extra JSON-safe
        # fields merged into every lease record (a serve replica's
        # queue depth / in-flight / checkpoint sha / drain state —
        # serve/fleet.py). Core protocol keys always win on collision,
        # and readers use .get(), so beats from payload-free builds
        # stay interchangeable with enriched ones.
        self.payload_fn = payload_fn
        self._lock = threading.Lock()
        self._seq = 0                                # spk: guarded-by=_lock
        self._round = -1                             # spk: guarded-by=_lock
        self._alive_view = np.ones(self.n, bool)     # spk: guarded-by=_lock
        self._age_view = np.zeros(self.n, np.float64)  # spk: guarded-by=_lock
        self._ever_dead = set()                      # spk: guarded-by=_lock
        self._stopped = False                        # spk: guarded-by=_lock
        # lease receipts: host -> ((seq, stamp), monotonic-at-receipt,
        # initial age). Freshness is monotonic from the receipt, so a
        # wall-clock step can never mass-expire peers.
        self._lease_seen = {}                        # spk: guarded-by=_lock
        # trace_align throttle: host -> observer mono of the last beacon
        # emitted for that peer (at most one per lease_s per peer keeps
        # the metrics volume O(hosts / lease_s) even at sim scale)
        self._align_last = {}                        # spk: guarded-by=_lock
        self._t0_mono = self.clock.monotonic()
        self._stop = threading.Event()
        self._thread = None
        if self.chaos is not None and self.n > 1:
            # real multi-process world: kill_host is rendered by the
            # TARGET process SIGKILLing itself at the gate
            # (maybe_kill_self); the virtual dead_hosts injector must
            # not double-fire on the survivors
            self.chaos.kill_host_self_mode = True

    # -- the lease ---------------------------------------------------------
    def _hb_name(self, host):
        return f"hb-{int(host)}.json"

    def _hb_path(self, host):
        return os.path.join(self.dir, self._hb_name(host))

    def beat(self):
        """Re-lease this host's liveness (writer thread + round
        arrivals both call this). The lease record is snapshotted UNDER
        the lock (seq/round/stopped are shared with the training
        thread) but the file write happens OUTSIDE it:
        atomic_write_json gives every call a unique temp name, so
        concurrent beats cannot race each other's os.replace — and a
        slow fsync (NFS can stall for hundreds of ms) no longer blocks
        view()/gate() readers on the state lock. Two interleaved beats may land out of order; the loser
        differs by one seq and a stamp milliseconds older — noise far
        below lease_s, and the writer re-leases every interval_s.

        The record carries BOTH time bases: ``stamp`` (wall, the only
        cross-process base a shared directory offers) and ``mono``
        (this host's monotonic clock) — the send half of a sync beacon.
        A peer that observes the new record pairs ``mono`` with its own
        monotonic receipt time (a ``trace_align`` event), which is what
        obs/fleettrace.py solves per-host clock offsets from. Readers
        use .get(): beats from older builds without ``mono`` stay
        readable, they just contribute no beacon.

        ``payload_fn`` extras are gathered OUTSIDE the lock (the
        callable typically reads other locked state — a batcher's
        queue depth — and calling into foreign locks under ``_lock``
        would invert lock order); core protocol keys always win."""
        extra = None
        if self.payload_fn is not None:
            try:
                extra = self.payload_fn()
            except Exception as e:   # a payload bug must not stop leasing
                self.log(f"heartbeat: payload_fn error: {e!r}")
        with self._lock:
            if self._stopped:
                return
            self._seq += 1
            rec = dict(extra) if extra else {}
            rec.update({"host": self.host, "seq": self._seq,
                        "round": self._round, "stamp": self.clock.time(),
                        "mono": self.clock.monotonic()})
        self.dirops.write_json(self._hb_name(self.host), rec)

    def announce_round(self, round_idx):
        """Post this host's arrival at ``round_idx`` (the rendezvous
        half of gate())."""
        with self._lock:
            self._round = int(round_idx)
        self.beat()

    def _reap_ghosts(self):
        """Startup GC: a previous run that crashed in the SAME rendezvous
        directory leaves hb-*.json leases (and orphaned round files —
        part/delta/mask/consensus/restart) behind. A ghost's stale lease
        would count toward the pre-round gate and the quorum until its
        (already expired) stamp is re-examined — worse, a ghost with a
        FUTURE round number could satisfy gates it never attended. Reap
        every lease whose stamp is already older than lease_s at startup
        and every orphaned round file with an mtime that old, and emit
        one ``ghost_reaped`` metrics event naming them. Fresh files from
        live peers of THIS run are untouched (they re-lease every
        interval_s, so their stamps are never near the lease). Stamp
        comparisons here are wall-vs-wall across PROCESSES — the one
        place that has to be, because the ghost's clock is all it left
        behind."""
        now = self.clock.time()
        ghost_hosts, orphans = [], 0
        for name in self.dirops.glob("hb-*.json"):
            rec = self.dirops.read_json(name)
            stamp = float(rec.get("stamp", 0.0)) \
                if rec is not None else 0.0
            if now - stamp <= self.lease_s:
                continue
            # re-read immediately before removing: a REJOINING host
            # (chaos preempt/rejoin, a `--grow` relaunch) may have
            # re-leased this exact path between our glob read and now —
            # reaping its fresh lease would make the rejoin look like a
            # second crash. Fresh-on-second-read means live: skip it.
            rec2 = self.dirops.read_json(name)
            if rec2 is not None and \
                    self.clock.time() - float(rec2.get("stamp", 0.0)) \
                    <= self.lease_s:
                continue
            rec = rec2 or rec
            if not self.dirops.remove(name):
                continue        # a concurrent peer reaped it first
            ghost_hosts.append(rec.get("host") if rec is not None
                               else name)
        for pat in ("part-*.npz", "mask-*.json", "delta-*.npz",
                    "delta-*.json", "consensus-*.npz", "consensus-*.json",
                    "restart-*.json", "*.tmp.*"):
            for name in self.dirops.glob(pat):
                mt = self.dirops.mtime(name)
                if mt is None or now - mt <= self.lease_s:
                    continue
                if self.dirops.remove(name):
                    orphans += 1
        if ghost_hosts or orphans:
            self.log(f"heartbeat: reaped {len(ghost_hosts)} ghost "
                     f"lease(s) {sorted(map(str, ghost_hosts))} and "
                     f"{orphans} orphaned round file(s) left by a "
                     "previous run in this rendezvous dir")
            if self.metrics is not None:
                self.metrics.log("ghost_reaped",
                                 hosts=sorted(map(str, ghost_hosts)),
                                 orphaned_files=orphans,
                                 observer=self.host)

    def start(self):
        """First beat + the background re-leaser. Idempotent. Reaps
        ghost leases/round files from a previous run in the same
        rendezvous dir BEFORE the first beat, so ghosts never count
        toward the gate or the quorum."""
        if self._thread is not None:
            return self
        self._reap_ghosts()
        self.beat()
        self._refresh_view()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"sparknet-hb-{self.host}")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
                self._refresh_view()
            except Exception as e:   # liveness must never kill the run
                self.log(f"heartbeat: writer error: {e!r}")

    def stop(self):
        """Stop leasing (the host will be seen dead after lease_s).
        Idempotent; used by tests to simulate a silent host."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        with self._lock:
            self._stopped = True

    def close(self):
        self.stop()

    # -- the peer view -----------------------------------------------------
    def _peer_visible(self, peer, round_idx):
        """chaos partition_host: a partitioned pair can't see each
        other's heartbeats (each side independently concludes the other
        is gone — the classic split-brain the quorum resolves)."""
        if self.chaos is None or \
                not hasattr(self.chaos, "host_partitioned"):
            return True
        return not self.chaos.host_partitioned(self.host, peer, round_idx)

    def peers(self):
        """{host: lease record} for every heartbeat file present."""
        out = {}
        for name in self.dirops.glob("hb-*.json"):
            rec = self.dirops.read_json(name)
            if rec is not None and isinstance(rec.get("host"), int):
                out[rec["host"]] = rec
        return out

    def view(self, now=None):
        """-> (alive bool (n,), lease_age_s (n,)). A host is alive while
        its lease is fresh; a host with NO heartbeat yet is granted one
        lease of startup grace (it may still be initializing), then
        dead. This host is always alive to itself.

        Freshness is MONOTONIC: a peer's age counts from the moment
        this process last saw a NEW lease record for it (seq/stamp
        advanced), not as ``wall_now - stamp`` — so an NTP step or a
        suspend/resume can shift the wall clock arbitrarily without
        expiring (or resurrecting) anyone. The on-disk wall stamp seeds
        the age only the FIRST time a pre-existing record is seen: a
        ghost's stale lease still reads as old on first sight. ``now``:
        optional wall time for that first-sight seeding (tests)."""
        mono = self.clock.monotonic()
        wall = self.clock.time() if now is None else float(now)
        with self._lock:
            round_idx = self._round
        n = self.n
        peers = self.peers()
        recs = {}
        for h in range(n):
            if h == self.host:
                continue
            recs[h] = peers.get(h) \
                if self._peer_visible(h, round_idx) else None
        alive = np.zeros(n, bool)
        age = np.full(n, np.inf, np.float64)
        beacons = []
        with self._lock:
            for h in range(n):
                if h == self.host:
                    alive[h] = True
                    age[h] = 0.0
                    continue
                rec = recs.get(h)
                if rec is None:
                    # no heartbeat ever seen: one lease of startup
                    # grace (the peer may still be initializing), then
                    # dead
                    if mono - self._t0_mono <= self.lease_s:
                        alive[h] = True
                        age[h] = 0.0
                    continue
                key = (rec.get("seq"), rec.get("stamp"))
                seen = self._lease_seen.get(h)
                if seen is None or seen[0] != key:
                    # a new record: the receipt resets the age. First-
                    # ever sight seeds from the wall stamp so a record
                    # that predates this process (a ghost) reads old.
                    init = max(0.0, wall - float(rec.get("stamp", 0.0))) \
                        if seen is None else 0.0
                    seen = (key, mono, init)
                    self._lease_seen[h] = seen
                    # a fresh receipt is a clock-sync beacon: the
                    # sender's (stamp, mono) paired with OUR monotonic
                    # receipt time bounds the pairwise clock offset
                    # (obs/fleettrace.py). Old-format beats carry no
                    # mono and contribute nothing. Throttled per peer;
                    # emitted after the lock drops.
                    if self.metrics is not None and \
                            isinstance(rec.get("mono"), (int, float)):
                        last = self._align_last.get(h)
                        if last is None or mono - last >= self.lease_s:
                            self._align_last[h] = mono
                            beacons.append(
                                {"observer": self.host, "peer": h,
                                 "seq": int(rec.get("seq") or 0),
                                 "peer_mono": float(rec["mono"]),
                                 "peer_stamp":
                                     float(rec.get("stamp", 0.0)),
                                 "obs_mono": mono})
                age[h] = seen[2] + (mono - seen[1])
                alive[h] = age[h] <= self.lease_s
        for b in beacons:
            self.metrics.log(
                "trace_align", observer=b["observer"], peer=b["peer"],
                seq=b["seq"], peer_mono=b["peer_mono"],
                peer_stamp=b["peer_stamp"], obs_mono=b["obs_mono"])
        return alive, age

    def _refresh_view(self):
        """Fold the current view into the published one, emitting a
        ``host_alive`` metrics event per liveness transition (the
        per-host liveness stream `sparknet monitor`/`report` render)."""
        alive, age = self.view()
        n = len(alive)
        with self._lock:
            prev = self._alive_view
            self._alive_view = alive
            self._age_view = age
            self._ever_dead |= {h for h in range(n) if not alive[h]}
            flips = [h for h in range(min(n, len(prev)))
                     if alive[h] != prev[h]]
        for h in flips:
            self.log(f"heartbeat: host {h} is now "
                     f"{'ALIVE' if alive[h] else 'DEAD'} "
                     f"(lease age {min(age[h], 1e9):.2f}s / "
                     f"{self.lease_s}s)")
            if self.metrics is not None:
                self.metrics.log("host_alive", host=h, alive=bool(alive[h]),
                                 lease_age_s=round(float(min(
                                     age[h], 1e9)), 3),
                                 observer=self.host)

    def alive_hosts(self):
        """Host ids currently holding a fresh lease (this host's view)."""
        alive, _ = self.view()
        return [h for h in range(len(alive)) if alive[h]]

    def live_processes(self):
        return self.alive_hosts()

    def lease_ages(self):
        _, age = self.view()
        return [round(float(min(a, 1e9)), 3) for a in age]

    def ever_dead(self):
        """Hosts whose lease EVER expired this run — after any real
        peer-process death a shutdown barrier across the processes can
        never complete, so a caller must exit without it."""
        with self._lock:
            return set(self._ever_dead)

    # -- grow-mid-run: late joiners through the rendezvous dir -------------
    def poll_joiners(self):
        """Host ids with a FRESH lease at or beyond this coordinator's
        world size — late-started `--grow` processes leasing themselves
        into the rendezvous dir, waiting to be admitted at the next
        gate. Expired out-of-world leases (ghosts of a larger previous
        run) are ignored; _reap_ghosts removed them at startup anyway.
        Wall-vs-wall stamp comparison: the joiner is another process
        this coordinator has no receipt history for."""
        now = self.clock.time()
        return sorted(
            h for h, rec in self.peers().items()
            if h >= self.n and
            now - float(rec.get("stamp", 0.0)) <= self.lease_s)

    def admit_host(self, joiner):
        """Grow this coordinator's world to include host ``joiner``:
        the view arrays extend under ``_lock`` (the joiner starts
        alive — its fresh lease is what got it here) and every later
        view()/gate() spans the larger world. Returns True when the
        world actually grew (idempotent across repeated polls)."""
        j = int(joiner)
        if j < self.n:
            return False
        with self._lock:
            grow = j + 1 - self.n
            self._alive_view = np.append(self._alive_view,
                                         np.ones(grow, bool))
            self._age_view = np.append(self._age_view,
                                       np.zeros(grow, np.float64))
            self.n = j + 1
        self.log(f"heartbeat: host {j} joined the rendezvous; world "
                 f"grown to {self.n} host(s)")
        return True

    def peer_round_max(self):
        """The most advanced round any fresh peer lease announces, or
        -1 — how a joiner fast-forwards its round counter to the front
        of the running world before its first gate (incumbents' gates
        accept any arrival at round >= theirs)."""
        now = self.clock.time()
        front = -1
        for h, rec in self.peers().items():
            if h == self.host or \
                    now - float(rec.get("stamp", 0.0)) > self.lease_s:
                continue
            front = max(front, int(rec.get("round", -1)))
        return front

    # -- the pre-round rendezvous gate -------------------------------------
    def gate(self, round_idx, expect=None, timeout=None):
        """Arrive at ``round_idx`` and wait until every expected peer
        either arrived (its heartbeat shows round >= round_idx) or its
        lease expired. Never dispatch a cross-host collective before
        this returns: a dead peer must cost an eviction, not a hang.

        expect: host ids to wait for (default: everyone else). Returns
        a GateResult; hosts in ``.dead`` should be evicted by the
        caller's ElasticPolicy (reason "lease_expired"). The deadline
        (and the reported wait) live on the monotonic clock."""
        if self.chaos is not None:
            # deterministic host-level injections anchored at the gate:
            # a killed host dies BEFORE announcing arrival (so peers see
            # lease expiry, the real crash shape), a slow host arrives
            # late (the straggler shape)
            if hasattr(self.chaos, "maybe_kill_self"):
                self.chaos.maybe_kill_self(self.host, round_idx,
                                           on_kill=self.stop)
            if self.n > 1 and hasattr(self.chaos, "maybe_preempt_self"):
                # preempt_host in a REAL multi-process world: same
                # SIGKILL-at-the-gate crash shape as kill_host; the
                # orchestration layer relaunches the corpse with --grow
                self.chaos.maybe_preempt_self(self.host, round_idx,
                                              on_kill=self.stop)
            if hasattr(self.chaos, "maybe_slow_host"):
                self.chaos.maybe_slow_host(self.host, round_idx)
        self.announce_round(round_idx)
        expect = set(range(self.n)) - {self.host} if expect is None \
            else {int(h) for h in expect} - {self.host}
        t0 = self.clock.monotonic()
        deadline = None if timeout is None else t0 + timeout
        arrived, dead = set(), set()
        while True:
            alive, age = self.view()
            peers = self.peers()
            for h in sorted(expect - arrived - dead):
                rec = peers.get(h) \
                    if self._peer_visible(h, round_idx) else None
                if rec is not None and \
                        int(rec.get("round", -1)) >= round_idx:
                    arrived.add(h)
                elif h < len(alive) and not alive[h]:
                    dead.add(h)
            if expect <= arrived | dead:
                break
            if deadline is not None and \
                    self.clock.monotonic() >= deadline:
                # an unresponsive-but-leasing host: report as neither
                # arrived nor dead; the caller decides (straggler alarm)
                break
            self.clock.sleep(min(self.interval_s / 4, 0.05))
        res = GateResult(arrived, dead, self.clock.monotonic() - t0)
        if dead:
            with self._lock:
                self._ever_dead |= dead
        if self.metrics is not None:
            # mono: gate-exit time on this host's monotonic clock —
            # lets the fleet merger place the wait exactly on the
            # aligned timeline instead of via the wall-t fallback
            self.metrics.log("host_round", round=round_idx,
                             observer=self.host,
                             wait_s=round(res.wait_s, 4),
                             mono=self.clock.monotonic(),
                             arrived=res.arrived, dead=res.dead,
                             lease_age_s=self.lease_ages())
        for h in res.dead:
            self.log(f"heartbeat: host {h} missed round {round_idx} "
                     f"(lease expired after {self.lease_s}s)")
        return res


# -- tau-interval consensus over the rendezvous dir -------------------------


class FileConsensus:
    """Masked cross-host weight averaging through the shared directory.

    The device half of the hierarchy (per-step pmean inside a host)
    stays a compiled collective; this is the cross-host tier for
    backends without multi-process collectives. Protocol per round r:

      1. every live host atomically posts part-<host>-<r>.npz: its
         post-round leaves + {valid, loss} meta
      2. the LOWEST-indexed live host waits for the others (lease-
         bounded), then posts mask-<r>.json naming exactly which
         contributions count — ONE authority per round, so every host
         computes the identical consensus (the paper's driver, made
         crash-tolerant: if the authority dies, the next-lowest live
         host takes over on lease expiry)
      3. every host averages the masked-in contributions with weight
         1/n_live and adopts the result — evicted or readmitted hosts
         included, which makes readmission the same free re-broadcast
         as the replicated collective path

    All file I/O is atomic-rename through the coordinator's Dir seam;
    round r's part files are deleted at round r+2 so the directory
    stays O(hosts) files."""

    def __init__(self, coord, keep_rounds=2):
        self.coord = coord
        self.dir = coord.dir
        self.dirops = coord.dirops
        self.clock = coord.clock
        self.keep_rounds = max(1, int(keep_rounds))
        # the last exchange's seconds: posting the part, deciding (or
        # awaiting) the mask, loading and averaging the parts
        self.timing = {}

    def _part_name(self, host, round_idx):
        return f"part-{int(host)}-{int(round_idx)}.npz"

    def _mask_name(self, round_idx):
        return f"mask-{int(round_idx)}.json"

    def _post(self, round_idx, leaves, valid, loss):
        meta = json.dumps({"host": self.coord.host, "round": int(round_idx),
                           "valid": int(bool(valid)),
                           "loss": float(loss)})
        arrays = {"meta": np.frombuffer(meta.encode(), np.uint8)}
        for i, a in enumerate(leaves):
            arrays[f"leaf{i}"] = np.asarray(a)
        self.dirops.write_npz(self._part_name(self.coord.host, round_idx),
                              arrays)

    def _load(self, host, round_idx, n_leaves):
        z = self.dirops.load_npz(self._part_name(host, round_idx))
        if z is None:
            return None, None
        try:
            meta = json.loads(bytes(z["meta"]).decode())
            leaves = [z[f"leaf{i}"] for i in range(n_leaves)]
        except (KeyError, ValueError):
            return None, None
        return leaves, meta

    def _wait_parts(self, round_idx, hosts, deadline):
        """Hosts whose contribution for ``round_idx`` landed before
        monotonic ``deadline`` (polling; arrival is the atomic
        rename)."""
        got = set()
        hosts = set(hosts)
        while True:
            for h in hosts - got:
                if self.dirops.exists(self._part_name(h, round_idx)):
                    got.add(h)
            if got >= hosts or self.clock.monotonic() >= deadline:
                return got
            self.clock.sleep(min(self.coord.interval_s / 4, 0.05))

    def _decide_mask(self, round_idx, alive, deadline):
        """The round's membership: written once by the lowest live
        host, awaited by the rest. If the authority dies before
        posting, its lease expires, the next-lowest live host becomes
        the authority and posts instead — one mask per round either
        way, so every host computes the identical consensus."""
        me = self.coord.host
        while True:
            rec = self.dirops.read_json(self._mask_name(round_idx))
            if rec is not None and rec.get("round") == round_idx:
                return [int(h) for h in rec.get("included", [])]
            live = set(self.coord.alive_hosts())
            if min(live | {me}) == me:
                got = self._wait_parts(round_idx, set(alive) | {me},
                                       deadline)
                mask = sorted(got)
                self.dirops.write_json(self._mask_name(round_idx),
                                       {"round": int(round_idx),
                                        "included": mask, "authority": me})
                return mask
            self.clock.sleep(min(self.coord.interval_s / 4, 0.05))

    def _gc(self, round_idx):
        for name in self.dirops.glob("part-*.npz"):
            try:
                r = int(name.rsplit("-", 1)[1].split(".")[0])
            except ValueError:
                continue
            if r <= round_idx - self.keep_rounds:
                self.dirops.remove(name)

    def exchange(self, round_idx, leaves, valid, loss, alive_hosts,
                 timeout=None):
        """One cross-host averaging round. ``leaves``: this host's flat
        list of numpy arrays (params+state in tree order); ``valid``:
        this host's finite bit; ``alive_hosts``: the membership in
        force (ElasticPolicy.live()). Returns (consensus_leaves, aux)
        where aux mirrors the compiled masked_consensus_stats membership
        report: valid (n,), n_live, worker_loss (n,), div_worker_sq
        (n,) — so the divergence/health/monitor pipeline runs unchanged
        over the relay transport."""
        n = self.coord.n
        timeout = self.coord.lease_s if timeout is None else timeout
        t0 = self.clock.monotonic()
        self._post(round_idx, leaves, valid, loss)
        t1 = self.clock.monotonic()
        deadline = t1 + timeout
        included = self._decide_mask(round_idx, set(alive_hosts), deadline)
        t2 = self.clock.monotonic()
        parts, metas = {}, {}
        for h in included:
            lv, meta = self._load(h, round_idx, len(leaves))
            if lv is not None and meta.get("valid"):
                parts[h], metas[h] = lv, meta
        if not parts:
            # no valid contribution anywhere (every live host NaN'd):
            # keep our own leaves; the policy will see the all-invalid
            # vector and act (evict/quorum)
            parts = {self.coord.host: leaves}
            metas = {self.coord.host: {"loss": float(loss),
                                       "valid": int(bool(valid))}}
        w = 1.0 / len(parts)
        consensus = []
        for i in range(len(leaves)):
            acc = None
            for h in parts:
                x = np.asarray(parts[h][i], np.float64)
                acc = x * w if acc is None else acc + x * w
            consensus.append(acc.astype(np.asarray(leaves[i]).dtype))
        # admission skew (grow-mid-run): a peer that admitted a joiner
        # this round can publish a mask including a host id >= our
        # coord.n — size the aux vectors to the mask, not our (one
        # round stale) world, so the report indexes without blowing up
        n = max(n, max(parts) + 1)
        valid_vec = np.zeros(n, np.float32)
        loss_vec = np.full(n, np.nan, np.float32)
        div_sq = np.zeros(n, np.float32)
        for h in parts:
            valid_vec[h] = 1.0
            loss_vec[h] = metas[h].get("loss", float("nan"))
            div_sq[h] = sum(
                float(((np.asarray(parts[h][i], np.float64)
                        - np.asarray(consensus[i], np.float64)) ** 2).sum())
                for i in range(len(leaves)))
        live_div = div_sq[valid_vec > 0]
        aux = {"valid": valid_vec, "n_live": np.float32(len(parts)),
               "worker_loss": loss_vec, "div_worker_sq": div_sq,
               "div_mean_sq": np.float32(live_div.mean()),
               "div_max_sq": np.float32(live_div.max()),
               "transport": "relay"}
        self._gc(round_idx)
        self.timing = {"post_s": t1 - t0, "mask_s": t2 - t1,
                       "average_s": self.clock.monotonic() - t2}
        return consensus, aux


# -- bounded-staleness async consensus over the rendezvous dir ---------------

class AsyncFileConsensus(FileConsensus):
    """Versioned, BARRIER-FREE cross-host delta exchange — the async
    bounded-staleness rendering of FileConsensus. Where the
    synchronous relay's authority WAITS for every live host's part file
    before publishing the round mask, this one never waits for anyone:

      1. after each local round a host atomically posts
         ``delta-<host>-<v>.npz`` (payload) + ``delta-<host>-<v>.json``
         (meta: host, version, valid, loss, stamp) at ITS OWN version
         counter v — a slow host simply posts lower versions
      2. the LOWEST-live-host merge authority publishes
         ``consensus-<v*>`` at the fastest version it can see, averaging
         each live host's LATEST delta with weight decay**(v* - v_h);
         deltas more than ``s`` versions behind (and lease-expired
         hosts) are excluded — the same degradation as death
      3. every host adopts the newest published consensus it hasn't
         adopted yet, or keeps its own weights when none is visible yet
         (early rounds, a dead authority mid-failover) — it NEVER blocks
      4. a host that finds itself more than ``s`` versions behind the
         fastest live peer PARKS: it abandons its stale line, adopts the
         latest consensus, and jumps its version to the front (the
         relay twin of ElasticPolicy.park/unpark)

    GC is lease-driven: a host whose lease expired has ALL its delta
    files removed (its stale pushes must stop haunting merges), and
    superseded delta/consensus versions are trimmed to a keep window.
    s=0 with every host in step degenerates to one full-weight merge
    per version — the synchronous consensus, reached without a barrier.
    """

    def __init__(self, coord, s=0, decay=0.5, keep_versions=3):
        super().__init__(coord)
        self.s = max(0, int(s))
        self.decay = float(decay)
        self.keep_versions = max(2, int(keep_versions))
        self.version = 0            # this host's completed-round counter
        self.parks = 0
        self._adopted = -1          # newest consensus version adopted

    # -- files ---------------------------------------------------------------
    def _delta_npz(self, host, v):
        return f"delta-{int(host)}-{int(v)}.npz"

    def _delta_meta(self, host, v):
        return f"delta-{int(host)}-{int(v)}.json"

    def _consensus_npz(self, v):
        return f"consensus-{int(v)}.npz"

    def _consensus_meta(self, v):
        return f"consensus-{int(v)}.json"

    def _push(self, v, leaves, valid, loss):
        """Payload first, meta last — the meta's atomic rename commits
        the delta, so a reader that sees the meta can read the npz."""
        self.dirops.write_npz(self._delta_npz(self.coord.host, v),
                              {f"leaf{i}": np.asarray(a)
                               for i, a in enumerate(leaves)})
        self.dirops.write_json(self._delta_meta(self.coord.host, v),
                               {"host": self.coord.host, "version": int(v),
                                "valid": int(bool(valid)),
                                "loss": float(loss),
                                "stamp": self.clock.time()})

    def _peer_versions(self):
        """{host: newest committed delta version} from the meta files."""
        vers = {}
        for name in self.dirops.glob("delta-*.json"):
            rec = self.dirops.read_json(name)
            if rec is None or not isinstance(rec.get("host"), int):
                continue
            h, v = rec["host"], int(rec.get("version", -1))
            if v > vers.get(h, -1):
                vers[h] = v
        return vers

    def _load_delta(self, host, v, n_leaves):
        meta = self.dirops.read_json(self._delta_meta(host, v))
        if meta is None:
            return None, None
        z = self.dirops.load_npz(self._delta_npz(host, v))
        if z is None:
            return None, None
        try:
            leaves = [z[f"leaf{i}"] for i in range(n_leaves)]
        except KeyError:
            return None, None
        return leaves, meta

    # -- the merge authority -------------------------------------------------
    def _merge(self, v_ref, live, vers, n_leaves):
        """Publish consensus-<v_ref> from each live host's latest delta
        within the staleness bound, discounted by decay**lag. Runs on
        the lowest live host; failover is automatic (the next-lowest
        live host sees itself lowest once the lease expires). Idempotent
        per v_ref — an existing consensus file is left alone."""
        if self.dirops.read_json(self._consensus_meta(v_ref)) is not None:
            return
        included, wsum = [], 0.0
        parts = {}
        for h in sorted(live):
            vh = vers.get(h, -1)
            if vh < 0 or v_ref - vh > self.s:
                continue                    # over-stale == excluded
            leaves, meta = self._load_delta(h, vh, n_leaves)
            if leaves is None or not meta.get("valid"):
                continue                    # torn or non-finite: out
            lagh = max(0, v_ref - vh)
            w = 1.0 if lagh == 0 else self.decay ** lagh
            parts[h] = (leaves, meta, lagh, w)
            wsum += w
        if not parts:
            return                          # nothing mergeable yet
        consensus = []
        for i in range(n_leaves):
            a = None
            for h, (leaves, _, _, w) in parts.items():
                x = np.asarray(leaves[i], np.float64) * (w / wsum)
                a = x if a is None else a + x
            consensus.append(a)
        for h, (leaves, meta, lagh, w) in sorted(parts.items()):
            div = sum(float(((np.asarray(leaves[i], np.float64)
                              - consensus[i]) ** 2).sum())
                      for i in range(n_leaves))
            included.append({"host": h, "version": int(vers[h]),
                             "lag": int(lagh), "weight": round(w, 6),
                             "loss": float(meta.get("loss",
                                                    float("nan"))),
                             "div_sq": div})
        self.dirops.write_npz(self._consensus_npz(v_ref),
                              {f"leaf{i}": c.astype(np.float64)
                               for i, c in enumerate(consensus)})
        self.dirops.write_json(self._consensus_meta(v_ref),
                               {"version": int(v_ref),
                                "authority": self.coord.host,
                                "included": included,
                                "stamp": self.clock.time()})

    def _latest_consensus(self, n_leaves):
        """(version, leaves, meta) of the newest committed consensus,
        or (None,)*3 — purely a read, never a wait."""
        best = None
        for name in self.dirops.glob("consensus-*.json"):
            rec = self.dirops.read_json(name)
            if rec is not None and isinstance(rec.get("version"), int):
                if best is None or rec["version"] > best["version"]:
                    best = rec
        if best is None:
            return None, None, None
        z = self.dirops.load_npz(self._consensus_npz(best["version"]))
        if z is None:
            return None, None, None
        try:
            leaves = [z[f"leaf{i}"] for i in range(n_leaves)]
        except KeyError:
            return None, None, None
        return best["version"], leaves, best

    def _gc_async(self, vers, live):
        """Lease-expiry GC: every delta of a host whose lease expired is
        removed (its stale pushes must stop haunting merges), and
        committed versions older than the keep window are trimmed."""
        floor = max(vers.values(), default=0) - self.s - self.keep_versions
        for name in self.dirops.glob("delta-*.json"):
            rec = self.dirops.read_json(name)
            if rec is None:
                continue
            h, v = rec.get("host"), int(rec.get("version", -1))
            dead = isinstance(h, int) and h not in live
            if dead or v < floor:
                self.dirops.remove(name)
                self.dirops.remove(self._delta_npz(h, v))
        keep = self.keep_versions
        cons = sorted(int(name.rsplit("-", 1)[1].split(".")[0])
                      for name in self.dirops.glob("consensus-*.json")
                      if name.rsplit("-", 1)[1].split(".")[0].isdigit())
        for v in cons[:-keep] if len(cons) > keep else []:
            self.dirops.remove(self._consensus_npz(v))
            self.dirops.remove(self._consensus_meta(v))

    # -- the exchange --------------------------------------------------------
    def exchange(self, round_idx, leaves, valid, loss, alive_hosts,
                 timeout=None):
        """One barrier-free exchange (same signature as the synchronous
        FileConsensus so LocalSGDSolver._train_round_relay is transport-
        agnostic; ``round_idx``/``timeout`` are accepted but versioning
        is internal and nothing ever waits). Returns (consensus_leaves,
        aux) with the same aux fields plus ``lag`` (per-host version
        lag), ``parked_self`` and ``version``."""
        me = self.coord.host
        n = self.coord.n
        v = self.version
        self._push(v, leaves, valid, loss)
        vers = self._peer_versions()
        vers[me] = max(vers.get(me, -1), v)
        live = set(int(h) for h in alive_hosts) | {me}
        live &= set(self.coord.alive_hosts()) | {me}
        fastest = max((vers.get(h, -1) for h in live), default=v)
        my_lag = max(0, fastest - v)
        if me == min(live):
            self._merge(fastest, live, vers, len(leaves))
        cv, cleaves, cmeta = self._latest_consensus(len(leaves))
        parked = my_lag > self.s
        if parked:
            # the bound is hit: abandon the stale line, adopt the
            # consensus, rejoin at the front (the relay park/unpark)
            self.parks += 1
            self.coord.log(
                f"async relay: host {me} PARKED at version {v} "
                f"(lag {my_lag} > s={self.s}); resyncing to the front")
            if self.coord.metrics is not None:
                self.coord.metrics.log("parked", worker=me, unit="host",
                                       round=int(v), lag=int(my_lag))
            self.version = fastest          # resynced
        else:
            self.version = v + 1
        if cleaves is not None and cv > self._adopted:
            self._adopted = cv
            out = [c.astype(np.asarray(leaves[i]).dtype)
                   for i, c in enumerate(cleaves)]
            meta_inc = {e["host"]: e for e in cmeta.get("included", [])}
        else:
            # no (new) consensus visible — keep our own post-round
            # weights and keep moving; the next exchange will adopt
            out = [np.asarray(x) for x in leaves]
            meta_inc = {me: {"host": me, "version": v, "lag": 0,
                             "weight": 1.0, "loss": float(loss),
                             "div_sq": 0.0}}
        valid_vec = np.zeros(n, np.float32)
        weight_vec = np.zeros(n, np.float32)
        loss_vec = np.full(n, np.nan, np.float32)
        div_sq = np.zeros(n, np.float32)
        lag_vec = np.zeros(n, np.float32)
        for h in range(n):
            lag_vec[h] = max(0, fastest - vers.get(h, fastest))
            e = meta_inc.get(h)
            if e is not None:
                valid_vec[h] = 1.0
                weight_vec[h] = float(e.get("weight", 1.0))
                loss_vec[h] = e.get("loss", float("nan"))
                div_sq[h] = e.get("div_sq", 0.0)
        live_div = div_sq[valid_vec > 0] if (valid_vec > 0).any() \
            else np.zeros(1, np.float32)
        aux = {"valid": valid_vec, "weight": weight_vec,
               "n_live": np.float32((valid_vec > 0).sum()),
               "worker_loss": loss_vec, "div_worker_sq": div_sq,
               "div_mean_sq": np.float32(live_div.mean()),
               "div_max_sq": np.float32(live_div.max()),
               "lag": [int(x) for x in lag_vec],
               "parked": [me] if parked else [],
               "parked_self": parked, "version": int(self.version),
               "transport": "async-relay"}
        self._gc_async(vers, live)
        return out, aux


# -- coordinated restart -----------------------------------------------------

def manifest_sha(prefix):
    """sha256 of the checkpoint manifest file itself — the value every
    survivor must agree on before a coordinated exit."""
    from .checkpoint import manifest_path
    try:
        with open(manifest_path(prefix), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


def restart_barrier(coord, sha, timeout=30.0):
    """Post this host's resume manifest sha and wait for every LIVE
    peer to post theirs. Returns (agreed, shas_by_host). Used on quorum
    loss so all survivors exit 4 holding the SAME resumable manifest —
    the supervisor relaunch then resumes one consistent world."""
    coord.dirops.write_json(f"restart-{coord.host}.json",
                            {"host": coord.host, "sha": sha,
                             "stamp": coord.clock.time()})
    deadline = coord.clock.monotonic() + timeout
    while True:
        live = coord.alive_hosts()
        shas = {}
        for h in live:
            rec = coord.dirops.read_json(f"restart-{h}.json")
            if rec is not None:
                shas[h] = rec.get("sha")
        if set(live) <= set(shas) or \
                coord.clock.monotonic() >= deadline:
            agreed = len(set(shas.values())) == 1 and \
                set(live) <= set(shas)
            if coord.metrics is not None:
                coord.metrics.log("membership", kind="coordinated_restart",
                                  observer=coord.host, agreed=agreed,
                                  sha=sha, hosts=sorted(shas))
            if not agreed:
                coord.log(f"coordinated restart: survivors did NOT "
                          f"converge on one manifest: {shas}")
            else:
                coord.log("coordinated restart: all "
                          f"{len(shas)} survivor(s) agree on manifest "
                          f"{str(sha)[:12]}… — exiting for supervisor "
                          "relaunch")
            return agreed, shas
        coord.clock.sleep(min(coord.interval_s / 2, 0.1))
