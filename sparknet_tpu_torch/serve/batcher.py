"""Continuous batching with deadline flush and backpressure.

HTTP handler threads submit() requests; the single serve-loop thread
pulls next_batch(). Batching policy (the Orca/clipper recipe):

* a batch closes as soon as max_batch rows are queued, OR when the
  OLDEST queued request has waited max_wait — so p99 at low load is
  bounded by max_wait instead of starving for a full batch;
* the queue is bounded: a submit() that finds queue_limit rows already
  waiting is rejected immediately (RejectedError -> HTTP 429 + a
  serve_reject event) instead of building an unbounded latency tail —
  backpressure the supervisor/load-balancer can see;
* drain(): close() rejects new arrivals while next_batch() keeps
  returning whatever is queued, so SIGTERM finishes in-flight work.

Shared fields are guarded by the Condition's lock, and metrics events
are emitted outside it (emitting does file I/O).
"""

import collections
import threading
import time


class RejectedError(RuntimeError):
    """Queue full (or draining) — the 429 of the serving tier."""

    def __init__(self, reason, queue_depth, limit):
        super().__init__(
            f"request rejected ({reason}): queue {queue_depth}/{limit}")
        self.reason = reason
        self.queue_depth = queue_depth
        self.limit = limit


class Request:
    """One submitted request: input arrays + a completion event the
    handler thread waits on. ``result``/``error`` are written by the
    serve loop strictly before ``done.set()``, and only read after
    ``done.wait()`` returns — the Event is the fence."""

    __slots__ = ("arrays", "n", "t_submit", "done", "result", "error",
                 "t_done", "bucket", "trace", "t_enq", "t_dispatch",
                 "t_fwd0", "t_fwd1")

    def __init__(self, arrays, n, trace=None):
        self.arrays = arrays
        self.n = int(n)
        self.t_submit = time.monotonic()   # admission stamp
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.t_done = None
        self.bucket = None
        # request-tracing fields (obs/tracing.py): the router-minted
        # trace id plus per-stage monotonic stamps. Each stamp is
        # written by exactly one thread strictly before done.set().
        self.trace = trace
        self.t_enq = None        # queued in the batcher
        self.t_dispatch = None   # popped into a batch
        self.t_fwd0 = None       # engine.forward started
        self.t_fwd1 = None       # engine.forward returned

    def wait(self, timeout=None):
        return self.done.wait(timeout)


class Batcher:
    def __init__(self, max_batch=8, max_wait_s=0.005, queue_limit=64,
                 metrics=None):
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.queue_limit = int(queue_limit)
        self.metrics = metrics
        self._cv = threading.Condition()
        self._q = collections.deque()     # spk: guarded-by=_cv
        self._rows = 0                    # spk: guarded-by=_cv
        self._closed = False              # spk: guarded-by=_cv
        self._submitted = 0               # spk: guarded-by=_cv
        self._rejected = 0                # spk: guarded-by=_cv

    def submit(self, arrays, n=1, trace=None):
        """Queue one request from a handler thread; returns the Request
        to wait on, or raises RejectedError when over queue_limit or
        draining (emitting the serve_reject event)."""
        req = Request(arrays, n, trace=trace)
        reject = None
        with self._cv:
            if self._closed:
                # distinct from queue_full so a router (serve/fleet.py)
                # and `sparknet report` can tell planned drain from
                # overload backpressure
                reject = ("replica_draining", self._rows)
            elif self._rows + req.n > self.queue_limit:
                reject = ("queue_full", self._rows)
            else:
                self._submitted += 1
                req.t_enq = time.monotonic()
                self._q.append(req)
                self._rows += req.n
                self._cv.notify()
        if reject is not None:
            reason, depth = reject
            with self._cv:
                self._rejected += 1
            if self.metrics is not None:
                self.metrics.log("serve_reject", reason=reason,
                                 queue_depth=depth,
                                 limit=self.queue_limit)
            raise RejectedError(reason, depth, self.queue_limit)
        return req

    def next_batch(self, timeout=0.05):
        """Serve-loop side: block up to ``timeout`` for work, then
        apply the close-on-full / close-on-deadline policy. Returns
        (requests, wait_ms) — possibly ([], 0.0) so the caller can poll
        signals and reload between batches."""
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
                if not self._q:
                    return [], 0.0
            while self._rows < self.max_batch:
                oldest = self._q[0].t_submit
                remain = self.max_wait_s - (time.monotonic() - oldest)
                if remain <= 0:
                    break
                self._cv.wait(remain)
                if not self._q:
                    return [], 0.0
            out, rows = [], 0
            while self._q and rows + self._q[0].n <= self.max_batch:
                req = self._q.popleft()
                out.append(req)
                rows += req.n
            if not out and self._q:
                # single request wider than max_batch can never fit
                req = self._q.popleft()
                out.append(req)
                rows = req.n
            self._rows -= rows
        now = time.monotonic()
        for req in out:
            req.t_dispatch = now     # queue -> batch stage boundary
        wait_ms = (now - out[0].t_submit) * 1e3 if out else 0.0
        return out, wait_ms

    def depth(self):
        """Queued rows right now (handler threads read this for
        /metrics)."""
        with self._cv:
            return self._rows

    def counters(self):
        with self._cv:
            return {"submitted": self._submitted,
                    "rejected": self._rejected}

    def close(self):
        """Stop accepting new requests (drain mode); wakes the loop."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def draining(self):
        """True once close() ran — surfaced on /healthz and in the
        replica's lease payload so the router stops picking this
        replica within one beat."""
        with self._cv:
            return self._closed

    def pending(self):
        """Requests still queued (the drain loop runs until zero)."""
        with self._cv:
            return len(self._q)
