"""Distributed solvers of the port over worker slots stacked on one
device — per-step data parallelism and SparkNet's tau-step local SGD,
single-tier or over (host, data) fault domains — and the multi-host
runtime (multihost.py: the process topology, slot grids, the relay
rule)."""

from .data_parallel import DataParallelSolver, LocalSGDSolver
from .multihost import (SlotGrid, auto_host_mesh, host_mesh, init_runtime,
                        needs_host_relay, survivor_mesh)

__all__ = ["DataParallelSolver", "LocalSGDSolver", "SlotGrid",
           "auto_host_mesh", "host_mesh", "init_runtime",
           "needs_host_relay", "survivor_mesh"]
