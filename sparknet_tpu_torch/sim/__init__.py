"""Discrete-event simulation of the serving fleet's control plane (the
serving half of sparknet_tpu/sim).

The port's real control-plane code — HeartbeatCoordinator, ElasticPolicy,
ReplicaMember, Router, SLOAutoscaler, CanaryController, none of it
modified or mocked — runs against the injectable Clock/Dir seam
(resilience/seam.py):

  clock.SimClock   virtual wall + monotonic time with an event heap;
                   ``sleep`` advances time and drains due events, so the
                   protocol code's poll loops run unchanged in
                   microseconds of real time
  memdir.MemDir    the rendezvous directory as an in-memory dict with
                   the same atomic-visibility semantics as RealDir
  servefleet       the serving fleet under open-loop arrival traces:
                   the real Router/SLOAutoscaler/CanaryController over
                   virtual replicas, proving no-lost-request-without-
                   429 under kill/churn/flash-crowd (``simfleet
                   --serve``)
  sweep            grids over replicas x lease x trace x chaos

Everything is deterministic given the seed: same spec, same timeline,
the same summary and event stream as the JAX package's simulator. The
training fleet (FleetSim, replay) waits for ROADMAP A6d.
"""

from .clock import SimClock
from .memdir import MemDir
from .servefleet import ServeFleetSim
from . import sweep

__all__ = ["SimClock", "MemDir", "ServeFleetSim", "sweep"]
