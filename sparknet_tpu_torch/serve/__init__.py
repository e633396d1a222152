"""Serving tier of the port (sparknet_tpu/serve's counterpart).

engine.py   weights-only checkpoint loading into one TEST-phase net per
            padding bucket, on the card, with hot reload mid-serve
batcher.py  thread-safe request queue: continuous batching, pad-to-
            bucket, max-wait deadline, bounded-queue backpressure
server.py   stdlib HTTP front end (/predict /healthz /metrics) with
            graceful SIGTERM drain, request tracing and the supervisor
            exit contract
loadgen.py  closed- and open-loop load generator (the ``serve-bench``
            verb)
fleet.py    the ``route`` verb — lease-based replica membership over the
            heartbeat rendezvous, least-depth routing with retry-once
            failover, SLO autoscaling, canary rollout with rollback
"""

from .engine import ServeEngine, bucket_sizes, bucket_for, deploy_net_param
from .batcher import Batcher, RejectedError
from .server import ServeStats, serve_http, serve_loop
from .loadgen import run_loadgen
from .fleet import (ReplicaMember, Router, SLOAutoscaler,
                    CanaryController, route_http)

__all__ = ["ServeEngine", "bucket_sizes", "bucket_for", "deploy_net_param",
           "Batcher", "RejectedError", "ServeStats", "serve_http",
           "serve_loop", "run_loadgen", "ReplicaMember", "Router",
           "SLOAutoscaler", "CanaryController", "route_http"]
