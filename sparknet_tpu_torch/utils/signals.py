"""A copy of sparknet_tpu/utils/signals.py. Signal-triggered snapshot/stop.

The reference installs SIGINT/SIGHUP handlers whose effects (snapshot /
stop / none) come from CLI flags (util/signal_handler.cpp:99-112,
tools/caffe.cpp:43-46); the solver polls CheckForSignals between steps.
Same design: handlers only record; the training loop polls pending().

Beyond the reference: SIGTERM — the preemption notice every scheduler
(k8s, borg, spot VMs) sends before a kill — maps to "snapshot_stop"
(snapshot, then stop cleanly), so a preempted job loses at most the
steps since its last sync round and `--resume auto` picks it back up.

Multi-process discipline: a scheduler delivers the SIGTERM to EVERY
process of the job, and each polls its own handler — but N processes
must not race N writes of the same (replicated) snapshot. The snapshot
the handlers trigger goes through Solver._snapshot, where only the
designated writer (process 0, or the lowest live host once failures
start) commits; the others barrier on the manifest it produced
(resilience/checkpoint.wait_for_manifest) and then stop with the same
documented exit code 0. See the DEPLOY.md preemption runbook.
"""

import signal


ACTIONS = ("snapshot", "stop", "snapshot_stop", "none")


class SignalPolicy:
    def __init__(self, sigint="stop", sighup="snapshot", sigterm="none"):
        for a in (sigint, sighup, sigterm):
            if a not in ACTIONS:
                raise ValueError(f"unknown signal action {a!r}")
        self.effects = {signal.SIGINT: sigint, signal.SIGHUP: sighup,
                        signal.SIGTERM: sigterm}
        self._pending = []
        self._prev = {}

    def _handler(self, signum, frame):
        action = self.effects.get(signum, "none")
        if action == "none":
            return
        if signum == signal.SIGINT and "stop" in action \
                and any("stop" in p for p in self._pending):
            # second ^C: restore default and re-raise (escape hatch)
            signal.signal(signal.SIGINT, signal.SIG_DFL)
            raise KeyboardInterrupt
        self._pending.append(action)

    def __enter__(self):
        for signum, action in self.effects.items():
            if action == "none" and signum == signal.SIGTERM:
                continue          # leave the default die-on-TERM alone
            try:
                self._prev[signum] = signal.signal(signum, self._handler)
            except ValueError:        # non-main thread: polling still works
                pass
        return self

    def __exit__(self, *exc):
        for signum, prev in self._prev.items():
            signal.signal(signum, prev)
        return False

    def pending(self):
        """Pop the oldest pending action ('snapshot'|'stop'|
        'snapshot_stop') or None — the Solver::GetRequestedAction analog."""
        return self._pending.pop(0) if self._pending else None
