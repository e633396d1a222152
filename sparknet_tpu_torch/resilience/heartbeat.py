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
  manifest_sha          the sha256 of a checkpoint manifest.

The training half of the JAX module — FileConsensus,
AsyncFileConsensus and restart_barrier — waits for ROADMAP A6d.

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
        self._seq = 0                                # guarded by _lock
        self._round = -1                             # guarded by _lock
        self._alive_view = np.ones(self.n, bool)     # guarded by _lock
        self._age_view = np.zeros(self.n, np.float64)  # guarded by _lock
        self._ever_dead = set()                      # guarded by _lock
        self._stopped = False                        # guarded by _lock
        # lease receipts: host -> ((seq, stamp), monotonic-at-receipt,
        # initial age). Freshness is monotonic from the receipt, so a
        # wall-clock step can never mass-expire peers.
        self._lease_seen = {}                        # guarded by _lock
        # trace_align throttle: host -> observer mono of the last beacon
        # emitted for that peer (at most one per lease_s per peer keeps
        # the metrics volume O(hosts / lease_s) even at sim scale)
        self._align_last = {}                        # guarded by _lock
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


def manifest_sha(prefix):
    """sha256 of the checkpoint manifest file itself — the value every
    survivor must agree on before a coordinated exit."""
    from .checkpoint import manifest_path
    try:
        with open(manifest_path(prefix), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None
