"""Background prefetch: the reference's double-buffered loader thread.

The port of what the CIFAR app uses from sparknet_tpu/data/prefetch.py:
``PrefetchIterator`` (one worker thread running the host-side produce
loop into a bounded queue, Caffe's BasePrefetchingDataLayer,
base_data_layer.cpp:70-101) and ``EchoIterator`` (data echoing). Left
out until their readers are ported: the queue-depth ``prefetch`` metrics
events and static extras, several workers, the worker-side transform,
and the ``H2DStager``.

Every put the worker makes is bounded, so ``close()`` always ends it:
it stops the worker, drains the queue and joins the thread within a
timeout. (The JAX package's worker ends with an unbounded put of its
end-of-stream marker, which can block on a full queue after close.)
"""

import queue
import threading

_END = object()


class PrefetchIterator:
    """Wrap a batch iterator with one background worker.

    depth: max buffered batches (2 = classic double buffering).

    A worker exception is raised in the consumer exactly once, with the
    original traceback, after the batches produced before the failure;
    iteration then ends (StopIteration).
    """

    def __init__(self, source, depth=2, name="prefetch"):
        self._q = queue.Queue(maxsize=depth)
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


class EchoIterator:
    """Serve each upstream batch ``echo`` times (data echoing, Choi et
    al.). echo == 1 is a strict passthrough. Delegates close() to the
    wrapped iterator."""

    def __init__(self, source, echo):
        self._inner = source
        self._it = iter(source)
        self.echo = max(1, int(echo))
        self._base = None
        self._left = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._left > 0:
            self._left -= 1
            return self._base
        self._base = next(self._it)
        self._left = self.echo - 1
        return self._base

    def close(self):
        inner = getattr(self._inner, "close", None)
        return inner() if inner is not None else True
