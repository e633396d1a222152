"""Span tracer and the one-block profiler (the port of
sparknet_tpu/obs/trace.py).

Each completed span emits one ``span`` event (name, start and duration
in ms since the tracer's epoch, nesting depth, parent span, thread id,
and the caller's attrs). Spans nest per thread through a thread-local
stack, so a worker thread's spans interleave correctly with the
training loop's. The tracer keeps a bounded buffer of completed spans
for Chrome ``trace_event`` export: load the file in chrome://tracing or
Perfetto next to the profiler's device trace. Times come from the
monotonic clock, so an NTP step cannot fold spans over each other.

``TorchProfiler`` takes the JAX package's JaxProfiler's place: the
same one steady block, traced by torch.profiler (the card's kernels
with CUDA activity) and written as ``torch.trace.json`` into the
``--profile`` directory, beside the spans' ``spans.trace.json``.
"""

import json
import os
import threading
import time
from contextlib import contextmanager


class Tracer:
    """Nested spans over a MetricsLogger sink (sink=None: spans still
    nest and buffer for the Chrome export, nothing reaches a JSONL)."""

    def __init__(self, sink=None, max_buffer=100_000):
        self.sink = sink
        self.t0 = time.monotonic()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._buf = []              # guarded by _lock
        self.dropped = 0            # guarded by _lock
        self.max_buffer = max_buffer

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextmanager
    def span(self, name, **attrs):
        """Time one phase; yields the attrs dict so the body can attach
        fields it learns on the way (attrs["n"] = ...)."""
        st = self._stack()
        parent = st[-1] if st else None
        st.append(name)
        start = time.monotonic() - self.t0
        try:
            yield attrs
        finally:
            st.pop()
            end = time.monotonic() - self.t0
            rec = {"name": name, "start_ms": round(start * 1e3, 3),
                   "dur_ms": round((end - start) * 1e3, 3),
                   "depth": len(st), "parent": parent,
                   "tid": threading.get_ident()}
            rec.update(attrs)
            self._record(rec)

    def instant(self, name, **attrs):
        """A zero-duration mark (a Chrome 'instant' event)."""
        st = self._stack()
        rec = {"name": name,
               "start_ms": round((time.monotonic() - self.t0) * 1e3, 3),
               "dur_ms": 0.0, "depth": len(st),
               "parent": st[-1] if st else None,
               "tid": threading.get_ident()}
        rec.update(attrs)
        self._record(rec)

    def _record(self, rec):
        with self._lock:
            if len(self._buf) < self.max_buffer:
                self._buf.append(rec)
            else:
                self.dropped += 1
        if self.sink is not None:
            self.sink.log("span", **rec)

    def spans(self):
        with self._lock:
            return list(self._buf)

    def export_chrome(self, path):
        """Write the buffered spans as a Chrome trace_event JSON file."""
        with self._lock:
            spans, dropped = list(self._buf), self.dropped
        return export_chrome(path, spans, dropped=dropped)


def chrome_from_spans(spans, pid=None):
    """span records (start_ms/dur_ms/name/tid + attrs) -> trace_event
    'X' (complete) events, timestamps in microseconds."""
    pid = pid if pid is not None else os.getpid()
    skip = {"name", "start_ms", "dur_ms", "tid", "depth", "parent",
            "event", "t", "run"}
    evs = []
    for s in spans:
        args = {k: v for k, v in s.items() if k not in skip}
        if s.get("parent"):
            args["parent"] = s["parent"]
        evs.append({"name": str(s.get("name", "?")),
                    "ph": "X" if s.get("dur_ms", 0) else "i",
                    "ts": round(float(s.get("start_ms", 0.0)) * 1e3, 1),
                    "dur": round(float(s.get("dur_ms", 0.0)) * 1e3, 1),
                    "pid": pid, "tid": int(s.get("tid", 0)) % (1 << 31),
                    "cat": "span", "args": args})
    return evs


def export_chrome(path, spans, pid=None, dropped=0):
    """Write span records to ``path`` in Chrome trace_event format."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    doc = {"traceEvents": chrome_from_spans(spans, pid=pid),
           "displayTimeUnit": "ms"}
    if dropped:
        doc["otherData"] = {"dropped_spans": dropped}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


class TorchProfiler:
    """The one-block torch.profiler toggle of the train verb: skip this
    process's first block (its kernel builds and warm-up) so the trace
    shows the steady state; a run short enough to have one block traces
    that block. ``cuda``: record the card's kernels (default: when the
    process sees a card)."""

    TRACE_NAME = "torch.trace.json"

    def __init__(self, logdir, log=print, block_iters=100, cuda=None):
        self.logdir = logdir
        self.log = log or (lambda *a: None)
        self.block_iters = block_iters
        self.cuda = cuda
        self.active = False
        self.done = False
        self._prof = None

    def maybe_start(self, blocks_done, iters_remaining):
        if not self.logdir or self.done or self.active:
            return False
        if blocks_done >= 1 or iters_remaining <= self.block_iters:
            import torch
            from torch.profiler import ProfilerActivity, profile
            cuda = torch.cuda.is_available() if self.cuda is None \
                else self.cuda
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            self._prof = profile(activities=acts)
            self._prof.start()
            self.active = True
        return self.active

    def _finish(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, self.TRACE_NAME)
        self._prof.export_chrome_trace(path)
        self._prof = None
        self.active = False
        return path

    def maybe_stop(self):
        if not self.active:
            return
        path = self._finish()
        self.done = True
        self.log(f"Wrote profiler trace to {path} (view in "
                 "chrome://tracing or Perfetto)")

    def abort(self):
        """Write the trace of a block that raised: the one most worth
        looking at."""
        if self.active:
            try:
                self._finish()
            except Exception:
                self.active = False
