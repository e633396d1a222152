"""Observability of the port (the JAX package's sparknet_tpu/obs):
spans, step accounting, comms, worker divergence, health and memory,
all written through one utils.metrics.MetricsLogger, so a single JSONL
stream carries the run and the ``report`` and ``trace`` verbs read it.

  trace.py      nested span tracer (JSONL events, Chrome trace_event
                export) and the one-block torch.profiler toggle
  stepstats.py  host dispatch against device time (CUDA events on the
                sampled steps), p50/p95/p99 step-time histograms
  comms.py      bytes a sync round of the worker slots stands for
                (ring-allreduce and the paper's broadcast/collect), and
                host-to-device feed bytes
  divergence.py the slots' drift from their consensus, on the card
  health.py     anomaly detectors over the round signals (stragglers,
                loss skew, divergence trends): ``health`` alarms
  memstats.py   allocator, device-memory and host-rss sampling
  report.py     the ``report`` verb; critpath.py and fleettrace.py
                behind the ``trace`` verb (copies of the JAX modules)
"""

from .comms import (CommsMeter, broadcast_collect_bytes,
                    ring_allreduce_bytes, tree_bytes)
from .divergence import DivergenceMeter, slot_divergence, tree_sq_dist
from .health import HealthMonitor
from .memstats import MemoryMonitor
from .stepstats import StepAccounting, device_memory, percentiles
from .trace import TorchProfiler, Tracer, chrome_from_spans, export_chrome

__all__ = [
    "CommsMeter", "DivergenceMeter", "HealthMonitor", "MemoryMonitor",
    "StepAccounting", "TorchProfiler", "Tracer", "broadcast_collect_bytes",
    "chrome_from_spans", "device_memory", "export_chrome", "percentiles",
    "ring_allreduce_bytes", "slot_divergence", "tree_bytes",
    "tree_sq_dist",
]
