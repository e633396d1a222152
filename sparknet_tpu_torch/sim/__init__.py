"""Fleet-scale discrete-event simulation of the control plane (the port
of sparknet_tpu/sim, with no torch in it).

The robustness mechanisms — leased heartbeats, masked-consensus
eviction, staleness parking, grow-mid-run admission — only ever ran at
2–3 real processes, while the production questions (lease/quorum tuning
at 1,000 hosts, park storms, eviction cascades, gate-wait tails) are
control-plane questions. This package drives the REAL control-plane
code (HeartbeatCoordinator, FileConsensus/AsyncFileConsensus,
ElasticPolicy, RecoveryPolicy, RetryPolicy — none of it modified or
mocked) against the injectable Clock/Dir seam (resilience/seam.py):

  clock.SimClock   virtual wall + monotonic time with an event heap;
                   ``sleep`` advances time and drains due events, so the
                   protocol code's poll loops run unchanged in
                   microseconds of real time
  memdir.MemDir    the rendezvous directory as an in-memory dict with
                   the same atomic-visibility semantics as RealDir
  fleet.FleetSim   a seeded fleet: per-host round durations, the chaos
                   failure processes (fail_rate/fail_corr, kill/preempt/
                   rejoin), lease churn, gates, evictions, consensus —
                   emitting the standard closed-schema metrics stream so
                   `report`/`monitor` render a simulated fleet
                   with zero special cases
  replay           record a REAL multi-coordinator run's membership
                   sequence, then reproduce it in the simulator exactly
                   (the validation that the sim and reality share one
                   control plane)
  sweep            grids over fleet size × failure rate × τ × s ×
                   lease/quorum — the study behind the JAX package's
                   DEPLOY.md tuning tables
  servefleet       the SERVING fleet under open-loop arrival traces:
                   the real Router/SLOAutoscaler/CanaryController over
                   virtual replicas, proving no-lost-request-without-
                   429 under kill/churn/flash-crowd (``simfleet
                   --serve``)

Everything is deterministic given the seed: same spec, same timeline.
"""

from .clock import SimClock
from .memdir import MemDir
from .fleet import FleetSim
from .servefleet import ServeFleetSim
from . import replay, sweep

__all__ = ["SimClock", "MemDir", "FleetSim", "ServeFleetSim", "replay",
           "sweep"]
