"""Background prefetch: the reference's double-buffered loader threads.

The port of sparknet_tpu/data/prefetch.py: ``PrefetchIterator`` (worker
threads running the host-side produce loop into a bounded queue,
Caffe's BasePrefetchingDataLayer, base_data_layer.cpp:70-101, with an
optional worker-side ``transform``, and the queue-depth ``prefetch``
metrics events), ``H2DStager`` (the host-to-card copy in that worker, on
a side stream, with its ``h2d_stage`` events and chaos hook) and
``EchoIterator`` (data echoing).

Every put a worker makes is bounded, so ``close()`` always ends the
pool: it stops the workers, drains the queue and joins the threads
within a timeout. (The JAX package's last worker ends with an unbounded
put of its end-of-stream marker, which can block on a full queue after
close.)
"""

import queue
import threading
import time

import numpy as np
import torch

_END = object()


class PrefetchIterator:
    """Wrap a batch iterator with ``workers`` background threads.

    depth: max buffered batches (2 = classic double buffering).
    transform: optional fn(item) -> item run in the worker (e.g. an
    H2DStager, so a batch's copy to the card overlaps the running step).
    workers > 1 share one upstream iterator under a lock and keep no
    ordering guarantee (the default, 1, keeps the source's order, as the
    reference's single reader does).
    metrics: optional utils.metrics.MetricsLogger; queue-depth gauges are
    emitted as ``prefetch`` events every ``emit_every`` consumer gets
    (and once at close). An empty queue at get time means the consumer
    is about to block on the producer: a sustained empty_frac near 1.0
    says the input pipeline, not the card, is the bound.
    extra: optional static fields (echo factor, wire mode, staging)
    merged into stats() and the ``prefetch`` event.

    A worker exception is raised in the consumer exactly once, with the
    original traceback, after the batches produced before the failure;
    iteration then ends (StopIteration). The failing worker also stops
    its siblings, so a poisoned source cannot keep a pool running.
    """

    def __init__(self, source, depth=2, transform=None, workers=1,
                 metrics=None, name="prefetch", emit_every=100, extra=None):
        self._q = queue.Queue(maxsize=depth)
        self._transform = transform
        self._stop = threading.Event()      # the workers stop producing
        self._closed = threading.Event()    # close(): no put waits on
        self._done = False
        self._error = None
        self._src_lock = threading.Lock()
        # workers > 1 share one upstream iterator; the lock checker
        # (`lint`, SPK201) verifies every next() holds the lock
        self._source = iter(source)         # spk: guarded-by=_src_lock
        self._metrics = metrics
        self._name = name
        self._emit_every = max(1, emit_every)
        self._extra = dict(extra) if extra else {}
        self._depth = depth
        self._gets = 0
        self._depth_sum = 0
        self._empty_gets = 0
        self._stats_emitted = False
        n = max(1, int(workers))
        self._live_lock = threading.Lock()
        self._live = n                      # spk: guarded-by=_live_lock
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"sparknet-{name}-{i}")
            for i in range(n)]
        for t in self._threads:
            t.start()

    def _put(self, item):
        """Queue ``item`` unless close() was called; False when it was."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            while not self._stop.is_set():
                with self._src_lock:
                    try:
                        item = next(self._source)
                    except StopIteration:
                        break
                if self._transform is not None:
                    item = self._transform(item)
                if self._stop.is_set() or not self._put(item):
                    break
        except BaseException as e:     # surfaced on the consumer side
            with self._live_lock:
                if self._error is None:      # the first failure wins
                    self._error = e
            self._stop.set()                 # and stops the siblings
        finally:
            with self._live_lock:
                self._live -= 1
                last = self._live == 0
            if last:
                self._put(_END)

    def __iter__(self):
        return self

    def _finish(self):
        # exactly-once error propagation, then a plain end of stream
        self._done = True
        err, self._error = self._error, None
        if err is not None:
            raise err
        raise StopIteration

    def __next__(self):
        if self._done:
            self._finish()
        d = self._q.qsize()          # approximate, fine for a gauge
        self._gets += 1
        self._depth_sum += d
        if d == 0:
            self._empty_gets += 1
        if self._metrics is not None and self._gets % self._emit_every == 0:
            self._emit_stats()
        item = self._q.get()
        if item is _END:
            self._finish()
        return item

    def stats(self):
        """Queue-depth gauges over the consumer's gets so far."""
        g = self._gets
        out = {"name": self._name, "gets": g, "depth_cap": self._depth,
               "depth_mean": round(self._depth_sum / g, 3) if g else None,
               "empty_frac": round(self._empty_gets / g, 3) if g else None}
        out.update(self._extra)
        return out

    def _emit_stats(self):
        self._metrics.log("prefetch", **self.stats())

    def close(self, timeout=5.0):
        """Emit the last gauge, stop the workers, drop what they buffered
        and join them; returns whether they all ended within ``timeout``
        seconds (a worker inside a slow ``next()`` of its source ends
        when that call returns)."""
        if self._metrics is not None and self._gets \
                and not self._stats_emitted:
            self._stats_emitted = True
            self._emit_stats()
        self._done = True
        self._stop.set()
        self._closed.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        end = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, end - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StagedBatch(dict):
    """A batch dict whose tensors an H2DStager is copying to the card on
    its side stream. ``wait()`` makes the caller's current stream wait
    for that copy (and tells the caching allocator that the stream uses
    the tensors); call it before reading them."""

    ready = None        # the copy's CUDA event
    device = None

    def wait(self):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.ready)
        for v in self.values():
            v.record_stream(stream)


def wait_staged(batch):
    """``batch.wait()`` for a StagedBatch; any other batch as it is."""
    if isinstance(batch, StagedBatch):
        batch.wait()
    return batch


class H2DStager:
    """Rotating-slot asynchronous host-to-card copies, used as a
    PrefetchIterator ``transform`` (the port of the JAX package's
    H2DStager, whose ``jax.device_put`` becomes pinned buffers and
    ``non_blocking`` copies on a side stream).

    Each call copies the batch's arrays into the pinned host buffers of
    the next of ``slots`` slots, enqueues their copies to the card on a
    side ``torch.cuda.Stream`` and records the slot's CUDA event after
    them; it returns a StagedBatch whose consumer waits on that event.
    Before a slot's buffers are rewritten, the host waits for the slot's
    previous copy to complete, so at most ``slots`` copies are in flight
    and the pinned memory stays at ``slots`` batches; the card holds the
    batches still queued, the one in use and those in flight.

    With ``device="cpu"`` it is the identity, as it is for a batch whose
    values are already tensors (made on the device, or staged); either
    way the call is counted. ``chaos`` hooks ChaosMonkey.maybe_slow_h2d:
    an armed ``slow_h2d`` makes every staged batch pay its injected wire
    time. ``metrics`` gets an ``h2d_stage`` event every ``emit_every``
    calls: bytes per item, the host's dispatch time (the pinned copy and
    the enqueue) and its wait for a slot's previous copy, and the copies
    still in flight.

    Safe from several prefetch workers: the slot rotation and counters
    are lock-guarded, and each slot's buffers are held under the slot's
    own lock from the wait for its last copy to the record of its new
    one.
    """

    def __init__(self, slots=2, device="cuda", chaos=None, metrics=None,
                 name="h2d", emit_every=50):
        self._chaos = chaos
        self.device = torch.device(device)
        self.slots = max(1, int(slots))
        self._metrics = metrics
        self._name = name
        self._emit_every = max(1, emit_every)
        self._pinned = [None] * self.slots
        self._events = [None] * self.slots
        self._slot_locks = [threading.Lock() for _ in range(self.slots)]
        self._lock = threading.Lock()
        self._stream = None                 # spk: guarded-by=_lock
        self._next = 0                      # spk: guarded-by=_lock
        self.puts = 0                       # spk: guarded-by=_lock
        self._bytes = 0                     # spk: guarded-by=_lock
        self._dispatch_s = 0.0              # spk: guarded-by=_lock
        self._wait_s = 0.0                  # spk: guarded-by=_lock

    def __call__(self, batch):
        nbytes = sum(int(getattr(v, "nbytes", 0)) for v in batch.values())
        if self._chaos is not None:
            self._chaos.maybe_slow_h2d(nbytes=nbytes)
        t0 = time.perf_counter()
        wait = 0.0
        out = batch
        if self.device.type == "cuda" and not any(
                torch.is_tensor(v) for v in batch.values()):
            out, wait = self._stage(batch)
        dispatch = time.perf_counter() - t0 - wait
        with self._lock:
            self.puts += 1
            self._bytes += nbytes
            self._dispatch_s += dispatch
            self._wait_s += wait
            emit = (self._metrics is not None
                    and self.puts % self._emit_every == 0)
            snap = self._stats_locked() if emit else None
        if emit:
            self._metrics.log(
                "h2d_stage", name=snap["name"], puts=snap["puts"],
                bytes=snap["bytes"], kb_per_item=snap["kb_per_item"],
                dispatch_ms=snap["dispatch_ms"], wait_ms=snap["wait_ms"],
                in_flight=snap["in_flight"], slots=snap["slots"])
        return out

    def _stage(self, batch):
        """Copy ``batch`` into the next slot's pinned buffers and enqueue
        their copies to the card; returns (StagedBatch, seconds waited
        for the slot's previous copy)."""
        with self._lock:
            slot = self._next
            self._next = (slot + 1) % self.slots
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            stream = self._stream
        with self._slot_locks[slot]:
            t = time.perf_counter()
            if self._events[slot] is not None:
                self._events[slot].synchronize()   # its last copy is done
            wait = time.perf_counter() - t
            arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in batch.items()}
            pinned = self._pinned[slot]
            if pinned is None or [(k, t.shape, t.dtype) for k, t in
                                  pinned.items()] != \
                    [(k, a.shape, a.dtype) for k, a in arrays.items()]:
                pinned = self._pinned[slot] = {
                    k: torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                    for k, a in arrays.items()}
            for k, a in arrays.items():
                pinned[k].copy_(a)
            out = StagedBatch()
            out.device = self.device
            with torch.cuda.stream(stream):
                for k, t in pinned.items():
                    out[k] = t.to(self.device, non_blocking=True)
                out.ready = torch.cuda.Event()
                out.ready.record(stream)
            self._events[slot] = out.ready
        return out, wait

    def _stats_locked(self):        # spk: holds=_lock
        p = self.puts
        return {
            "name": self._name, "puts": p, "bytes": self._bytes,
            "kb_per_item": round(self._bytes / p / 1024.0, 1) if p else 0.0,
            "dispatch_ms": round(self._dispatch_s / p * 1e3, 3) if p
            else 0.0,
            "wait_ms": round(self._wait_s / p * 1e3, 3) if p else 0.0,
            "in_flight": sum(1 for e in self._events
                             if e is not None and not e.query()),
            "slots": self.slots}



class EchoIterator:
    """Serve each upstream batch ``echo`` times (data echoing, Choi et
    al.).

    fresh_aux: optional fn(batch) -> {aux_key: array} giving new host-side
    crop/mirror draws for every echo after the first, so each echo is a
    distinct augmentation of the same shipped pixels. An echo is a plain
    dict copy of the batch with only the small aux arrays swapped: the
    staged pixels are reused, and the consumer has already waited for
    their copy when it took the first serving.

    echo == 1 is a strict passthrough: no extra draws, no copies.
    Delegates close() to the wrapped iterator."""

    def __init__(self, source, echo, fresh_aux=None):
        self._inner = source
        self._it = iter(source)
        self.echo = max(1, int(echo))
        self._fresh_aux = fresh_aux
        self._base = None
        self._left = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.echo == 1:
            return next(self._it)
        if self._left > 0:
            self._left -= 1
            b = self._base
            if self._fresh_aux is not None and isinstance(b, dict):
                b = dict(b)
                b.update(self._fresh_aux(self._base))
            return b
        self._base = next(self._it)
        self._left = self.echo - 1
        return self._base

    def close(self):
        inner = getattr(self._inner, "close", None)
        return inner() if inner is not None else True
