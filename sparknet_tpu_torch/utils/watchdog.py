"""Training watchdog (the port of sparknet_tpu/utils/watchdog.py, as the
CIFAR app uses it).

SparkNet set spark.task.maxFailures=1 (CifarApp.scala:38): any failure
was fatal. With explicit checkpoints the right behavior is the opposite:
detect a stall (hung host callback, wedged device, dead peer) and say
so, and report a non-finite loss. Not ported (ROADMAP A6): the JAX
watchdog's kill-on-stall path (its emergency snapshot and exit code 42)
and its metrics events.
"""

import math
import sys
import threading
import time


class Watchdog:
    """Arm with the expected round cadence; the loop calls beat(loss).

    on_stall(elapsed) is invoked from the monitor thread once per stall
    detection (then re-arms); on_nan(loss) from beat()."""

    def __init__(self, stall_seconds=300.0, on_stall=None, on_nan=None,
                 poll_seconds=None):
        self.stall_seconds = float(stall_seconds)
        self.on_stall = on_stall or (lambda dt: print(
            f"[watchdog] no training step for {dt:.0f}s"))
        self.on_nan = on_nan or (lambda loss: print(
            f"[watchdog] non-finite loss {loss}"))
        self.poll = poll_seconds or min(10.0, self.stall_seconds / 4)
        # the beat time is written by the training thread and read and
        # re-armed by the monitor thread
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = None
        self.stalls = 0
        self.nans = 0

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self                     # idempotent: no leaked threads
        with self._lock:
            self._last = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sparknet-watchdog")
        self._thread.start()
        return self

    def beat(self, loss=None):
        """Call once per training round (host-side, costs nothing)."""
        with self._lock:
            self._last = time.monotonic()
        if loss is not None:
            v = float(loss)
            if not math.isfinite(v):
                self.nans += 1
                self.on_nan(v)

    def _run(self):
        while not self._stop.wait(self.poll):
            with self._lock:
                dt = time.monotonic() - self._last
            if dt > self.stall_seconds:
                self.stalls += 1
                try:
                    self.on_stall(dt)
                except Exception as e:      # a raising callback must not
                    print(f"[watchdog] on_stall raised: {e!r}",  # end the
                          file=sys.stderr)                # monitor thread
                with self._lock:
                    self._last = time.monotonic()   # re-arm

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
