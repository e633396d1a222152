"""Training watchdog (the port of sparknet_tpu/utils/watchdog.py).

SparkNet set spark.task.maxFailures=1 (CifarApp.scala:38): any failure
was fatal. With explicit checkpoints the right behavior is the opposite:
detect a stall (hung feed, wedged device, dead peer) and act — log it,
or, with ``kill_on_stall``, take an emergency snapshot and exit with
EXIT_WATCHDOG_STALL (42) so a supervisor restarts the run from the
checkpoint with ``--resume auto``. A non-finite loss is reported too.
"""

import math
import os
import sys
import threading
import time

from .exit_codes import EXIT_WATCHDOG_STALL


class Watchdog:
    """Arm with the expected step cadence; the loop calls beat(loss).

    on_stall(elapsed) is invoked from the monitor thread once per stall
    detection (then re-arms); on_nan(loss) from beat(). With
    ``kill_on_stall`` a stall escalates: ``emergency_snapshot`` (a
    zero-argument callable, tried in its own thread for at most
    ``emergency_timeout_s``: a wedged device can hang a snapshot too),
    a final metrics flush, then ``os._exit(42)`` (``exit_fn`` for
    tests). os._exit skips ``finally`` blocks, so the snapshot commits
    its manifest (written and fsynced) before the exit. With
    ``metrics`` every stall, non-finite loss and kill is a ``watchdog``
    event of the run's JSONL."""

    def __init__(self, stall_seconds=300.0, on_stall=None, on_nan=None,
                 kill_on_stall=False, poll_seconds=None, metrics=None,
                 emergency_snapshot=None, emergency_timeout_s=30.0,
                 exit_fn=None):
        self.stall_seconds = float(stall_seconds)
        self.on_stall = on_stall or (lambda dt: print(
            f"[watchdog] no training step for {dt:.0f}s"))
        self.on_nan = on_nan or (lambda loss: print(
            f"[watchdog] non-finite loss {loss}"))
        self.kill_on_stall = kill_on_stall
        self.emergency_snapshot = emergency_snapshot
        self.emergency_timeout_s = float(emergency_timeout_s)
        self._exit = exit_fn or os._exit
        self.metrics = metrics
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
        """Call once per training step or round (host-side; a loss given
        as a device tensor is fetched)."""
        with self._lock:
            self._last = time.monotonic()
        if loss is not None:
            v = float(loss)
            if not math.isfinite(v):
                self.nans += 1
                if self.metrics is not None:
                    self.metrics.log("watchdog", kind="nan", loss=v)
                self.on_nan(v)

    def _run(self):
        while not self._stop.wait(self.poll):
            with self._lock:
                dt = time.monotonic() - self._last
            if dt > self.stall_seconds:
                self.stalls += 1
                if self.metrics is not None:
                    self.metrics.log("watchdog", kind="stall",
                                     elapsed_s=round(dt, 1))
                try:
                    self.on_stall(dt)
                except Exception as e:      # a raising callback must not
                    print(f"[watchdog] on_stall raised: {e!r}",  # end the
                          file=sys.stderr)                # monitor thread
                if self.kill_on_stall:
                    self._emergency_exit()
                with self._lock:
                    self._last = time.monotonic()   # re-arm

    def _emergency_exit(self):
        """Best-effort snapshot and metrics flush, then exit 42."""
        ok = None
        if self.emergency_snapshot is not None:
            result = {}

            def work():
                try:
                    result["path"] = self.emergency_snapshot()
                except Exception as e:
                    result["error"] = repr(e)

            t = threading.Thread(target=work, daemon=True,
                                 name="sparknet-emergency-snapshot")
            t.start()
            t.join(self.emergency_timeout_s)
            ok = "error" not in result and not t.is_alive()
            if not ok:
                print("[watchdog] emergency snapshot "
                      + ("timed out" if t.is_alive()
                         else f"failed: {result.get('error')}"),
                      file=sys.stderr)
        if self.metrics is not None:
            self.metrics.log("watchdog", kind="killed",
                             exit_code=EXIT_WATCHDOG_STALL,
                             emergency_snapshot_ok=ok)
            self.metrics.close()            # the last flush before _exit
        sys.stdout.flush()
        sys.stderr.flush()
        self._exit(EXIT_WATCHDOG_STALL)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
