"""Replay validation: the simulator must reproduce reality, exactly.

The claim the whole package rests on is that FleetSim exercises the
SAME control plane as a real multi-process run. This module makes the
claim falsifiable:

  record_real()  runs N REAL HeartbeatCoordinators — real threads, real
                 wall clock, a real on-disk rendezvous directory, the
                 default seam — through a scripted SIGKILL-shaped crash
                 (the victim stops leasing mid-run, announcing nothing),
                 with one host driving the real ElasticPolicy off its
                 gate results. The coordinators share one process, but
                 the protocol is entirely file-based: the code paths are
                 byte-for-byte the ones separate processes execute (the
                 multi-process runs prove that equivalence
                 elsewhere).
  replay_sim()   feeds the recorded config + death schedule to FleetSim
                 (simulated clock, in-memory dir, same policy knobs) and
                 compares the ORDERED membership sequence — every
                 host_evicted / host_joined / readmission / parked event
                 with its host and round — which must match exactly.

A mismatch fails the check: either the simulator drifted
from the protocol, or a protocol change altered membership behavior
without anyone noticing. Both are exactly what this gate is for.
"""

import threading
import time

from ..resilience.elastic import ElasticPolicy, QuorumLost
from ..resilience.heartbeat import HeartbeatCoordinator
from .fleet import FleetSim

#: the membership events whose order defines a run's control-plane story
SEQ_EVENTS = ("host_evicted", "host_joined", "readmission", "parked")


def _quiet(*a, **k):
    pass


class SequenceSink:
    """A metrics-shaped recorder keeping the ordered membership
    sequence (and forwarding everything to an inner logger, if any)."""

    def __init__(self, inner=None):
        self.inner = inner
        self.sequence = []

    def log(self, event, **fields):
        if event in SEQ_EVENTS:
            host = fields.get("host", fields.get("worker"))
            self.sequence.append(
                [event, int(host), int(fields.get("round", -1))])
        if self.inner is not None:
            self.inner.log(event, **fields)


def record_real(directory, hosts=3, rounds=9, kill_round=3, victim=None,
                interval_s=0.1, lease_s=0.5, round_s=0.12,
                evict_after=1, readmit_after=3, quorum=1, log_fn=None):
    """Run a real multi-coordinator crash scenario and return the
    recording dict (config + membership sequence) replay_sim consumes.

    Every host gates every round in its own thread (the real rendezvous
    shape); the victim stops leasing right before ``kill_round`` and
    never announces it, so the survivors' gate discovers a lapsed lease
    — the true crash shape. Host 0 drives the real ElasticPolicy:
    eviction on gate.dead, cooldown readmission via observe_round, the
    production sequencing. With the cooldown shorter than the remaining
    rounds the recording contains the full churn signature —
    evict -> readmit -> re-evict — which is exactly the hard case the
    simulator must reproduce round-exact."""
    victim = hosts - 1 if victim is None else int(victim)
    sink = SequenceSink()
    log = log_fn or _quiet
    coords = [HeartbeatCoordinator(directory, host=h, n_hosts=hosts,
                                   interval_s=interval_s, lease_s=lease_s,
                                   log_fn=_quiet).start()
              for h in range(hosts)]
    policy = ElasticPolicy(n_workers=hosts, quorum=quorum,
                           evict_after=evict_after,
                           readmit_after=readmit_after, metrics=sink,
                           log_fn=log, unit="host")

    def peer_loop(h):
        for r in range(rounds):
            if h == victim and r >= kill_round:
                coords[h].stop()        # silent death: the lease lapses
                return
            time.sleep(round_s)
            if h == 0:
                expect = set(policy.live()) - {0}
                res = coords[0].gate(r, expect=expect, timeout=None)
                for d in res.dead:
                    try:
                        policy.evict(d, r, "lease_expired")
                    except QuorumLost:
                        return
                try:
                    policy.observe_round(r)
                except QuorumLost:
                    return
            else:
                coords[h].gate(r, timeout=None)

    threads = [threading.Thread(target=peer_loop, args=(h,),
                                name=f"sim-record-{h}")
               for h in range(hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=rounds * (round_s + lease_s) + 30)
    for c in coords:
        c.close()
    return {"config": {"hosts": hosts, "rounds": rounds,
                       "kill_round": kill_round, "victim": victim,
                       "interval_s": interval_s, "lease_s": lease_s,
                       "round_s": round_s, "evict_after": evict_after,
                       "readmit_after": readmit_after, "quorum": quorum},
            "sequence": sink.sequence}


def replay_sim(recording, metrics=None, log_fn=None):
    """Re-run a recording's scenario in the simulator and compare the
    membership sequences. Returns (match, real_seq, sim_seq)."""
    cfg = recording["config"]
    sink = SequenceSink(inner=metrics)
    sim = FleetSim(hosts=int(cfg["hosts"]), rounds=int(cfg["rounds"]),
                   interval_s=float(cfg["interval_s"]),
                   lease_s=float(cfg["lease_s"]),
                   round_s=float(cfg["round_s"]), jitter=0.0,
                   quorum=int(cfg["quorum"]),
                   evict_after=int(cfg["evict_after"]),
                   readmit_after=int(cfg["readmit_after"]),
                   consensus="none",
                   deaths={int(cfg["victim"]): int(cfg["kill_round"])},
                   seed=0, metrics=sink, log_fn=log_fn)
    sim.run()
    real_seq = [list(e) for e in recording["sequence"]]
    return sink.sequence == real_seq, real_seq, sink.sequence
