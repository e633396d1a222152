"""Background prefetch: the reference's double-buffered loader thread.

The port of sparknet_tpu/data/prefetch.py: ``PrefetchIterator`` (one
worker thread running the host-side produce loop into a bounded queue,
Caffe's BasePrefetchingDataLayer, base_data_layer.cpp:70-101, with an
optional worker-side ``transform``), ``H2DStager`` (the host-to-card
copy in that worker, on a side stream) and ``EchoIterator`` (data
echoing). Left out (ROADMAP A6): the queue-depth ``prefetch`` metrics
events and static extras, several workers, and the chaos hook of the
stager.

Every put the worker makes is bounded, so ``close()`` always ends it:
it stops the worker, drains the queue and joins the thread within a
timeout. (The JAX package's worker ends with an unbounded put of its
end-of-stream marker, which can block on a full queue after close.)
"""

import queue
import threading

import numpy as np
import torch

_END = object()


class PrefetchIterator:
    """Wrap a batch iterator with one background worker.

    depth: max buffered batches (2 = classic double buffering).
    transform: optional fn(item) -> item run in the worker (e.g. an
    H2DStager, so a batch's copy to the card overlaps the running step).

    A worker exception is raised in the consumer exactly once, with the
    original traceback, after the batches produced before the failure;
    iteration then ends (StopIteration).
    """

    def __init__(self, source, depth=2, name="prefetch", transform=None):
        self._q = queue.Queue(maxsize=depth)
        self._transform = transform
        self._stop = threading.Event()
        self._done = False
        self._error = None
        self._source = iter(source)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"sparknet-{name}")
        self._thread.start()

    def _put(self, item):
        """Queue ``item`` unless close() was called; False when it was."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._source:
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item):
                    return
        except BaseException as e:     # surfaced on the consumer side
            self._error = e
        finally:
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
        item = self._q.get()
        if item is _END:
            self._finish()
        return item

    def close(self, timeout=5.0):
        """Stop the worker, drop what it buffered and join it; returns
        whether it ended within ``timeout`` seconds (a worker inside a
        slow ``next()`` of its source ends when that call returns)."""
        self._done = True
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)
        return not self._thread.is_alive()


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
    values are already tensors (made on the device, or staged).
    ``chaos`` hooks ChaosMonkey.maybe_slow_h2d: an armed ``slow_h2d``
    makes every staged batch pay its injected wire time.
    """

    def __init__(self, slots=2, device="cuda", chaos=None):
        self._chaos = chaos
        self.device = torch.device(device)
        self.slots = max(1, int(slots))
        self._pinned = [None] * self.slots
        self._events = [None] * self.slots
        self._next = 0
        self._stream = None
        self.puts = 0

    def __call__(self, batch):
        if self._chaos is not None:
            self._chaos.maybe_slow_h2d(nbytes=sum(
                int(getattr(v, "nbytes", 0)) for v in batch.values()))
        if self.device.type != "cuda" or any(
                torch.is_tensor(v) for v in batch.values()):
            return batch
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        slot = self._next
        self._next = (slot + 1) % self.slots
        if self._events[slot] is not None:
            self._events[slot].synchronize()   # the slot's last copy is done
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
        with torch.cuda.stream(self._stream):
            for k, t in pinned.items():
                out[k] = t.to(self.device, non_blocking=True)
            out.ready = torch.cuda.Event()
            out.ready.record(self._stream)
        self._events[slot] = out.ready
        self.puts += 1
        return out


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
