"""Divergence recovery: roll back to the last known-good state instead
of dying (the port of sparknet_tpu/resilience/recovery.py).

A RecoveryPolicy keeps a copy of the solver's training state (every
tensor of ``solver.training_tensors()``: params, net state, optimizer
history, for the slot solvers the stacked slots) and its generators;
when a loss comes back non-finite or exploded it rewinds the solver to
that copy, optionally decaying the lr and reshuffling the data stream,
so one bad step degrades into a short replay. Retries are bounded:
after ``max_rollbacks`` rollbacks without reaching a new known-good
point past the failure it raises RecoveryAbort, which the train verb
turns into exit 3.

The copy lives on the solver's device, in buffers allocated at the
first capture and refreshed with one ``torch._foreach_copy_`` per
healthy observation (the JAX package copies to the host: its donated
buffers cannot be kept). Its cost is one device-to-device copy of the
training state per observed loss, which the solver observes at its
display points (and every SPARKNET_SYNC_STRIDE steps between them),
as in the JAX package.
"""

import math

import torch


class RecoveryAbort(RuntimeError):
    """Divergence persisted through the rollback budget; stop cleanly."""


class RecoveryPolicy:
    """observe(solver, loss) after each materialized loss:

    healthy  -> refresh the last-known-good copy (at most every
                ``good_interval`` iters) and return False
    bad      -> roll the solver back and return True (the caller redoes
                the work), or raise RecoveryAbort once ``max_rollbacks``
                consecutive rollbacks have not reached a new healthy
                point past the failure iter

    A loss is bad when it is non-finite, or, with ``explode_factor`` >
    0, larger than explode_factor x the EMA of recent healthy losses.
    ``lr_decay`` < 1 multiplies the lr schedule on every rollback.
    ``reshuffle`` is an optional zero-argument hook that re-seeds or
    skips the data stream so the replay does not meet the same batches.
    """

    def __init__(self, max_rollbacks=3, lr_decay=1.0, explode_factor=0.0,
                 good_interval=1, ema_decay=0.9, reshuffle=None,
                 metrics=None, log_fn=print):
        self.max_rollbacks = int(max_rollbacks)
        self.lr_decay = float(lr_decay)
        self.explode_factor = float(explode_factor)
        self.good_interval = max(1, int(good_interval))
        self.ema_decay = float(ema_decay)
        self.reshuffle = reshuffle
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self.rollbacks = 0          # lifetime count (for reporting)
        self._consecutive = 0
        self._ema = None
        self._good = None           # preallocated copies of the tensors
        self._good_rng = None
        self._good_iter = -1

    # -- last-known-good capture -------------------------------------------
    @torch.no_grad()
    def note_good(self, solver):
        """Copy the solver's training state into the known-good buffers."""
        if self._good is not None and \
                solver.iter - self._good_iter < self.good_interval:
            return
        live = solver.training_tensors()
        if self._good is None or len(self._good) != len(live):
            self._good = [t.detach().clone() for t in live]
        else:
            torch._foreach_copy_(self._good, [t.detach() for t in live])
        self._good_rng = solver.rng_state()
        self._good_iter = solver.iter

    def is_bad(self, loss):
        v = float(loss)
        if not math.isfinite(v):
            return "non-finite loss"
        if self.explode_factor > 0 and self._ema is not None and \
                abs(v) > self.explode_factor * max(abs(self._ema), 1e-8):
            return (f"loss {v:.6g} exploded past "
                    f"{self.explode_factor:g}x EMA {self._ema:.6g}")
        return None

    def observe(self, solver, loss):
        """-> True if the solver was rolled back (redo the work)."""
        if loss is None:
            return False
        v = float(loss)
        reason = self.is_bad(v)
        if reason is None:
            self._ema = v if self._ema is None else \
                self.ema_decay * self._ema + (1 - self.ema_decay) * v
            if self._consecutive and solver.iter > self._good_iter:
                self._consecutive = 0       # healthy past the failure
            self.note_good(solver)
            return False
        return self._rollback(solver, v, reason)

    # -- the rollback itself -----------------------------------------------
    def _rollback(self, solver, v, reason):
        if self._good is None:
            self._abort(solver, v, reason
                        + " before any known-good state was captured")
        self.rollbacks += 1
        self._consecutive += 1
        if self._consecutive > self.max_rollbacks:
            self._abort(solver, v, f"{reason}; {self._consecutive - 1} "
                        "rollbacks exhausted without progress")
        with torch.no_grad():
            torch._foreach_copy_(
                [t.detach() for t in solver.training_tensors()], self._good)
        solver.set_rng_state(self._good_rng)
        it = self._good_iter
        solver.iter = it
        solver._smoothed.clear()            # the window is poisoned
        if self.lr_decay != 1.0:
            solver.scale_lr(self.lr_decay)
        if self.reshuffle is not None:
            try:
                self.reshuffle()
            except Exception as e:          # a hook must not end recovery
                self.log(f"recovery: reshuffle hook raised: {e!r}")
        self.log(f"recovery: {reason}; rolled back to iter {it} "
                 f"(rollback {self._consecutive}/{self.max_rollbacks}"
                 + (f", lr x{self.lr_decay:g}" if self.lr_decay != 1.0
                    else "") + ")")
        if self.metrics is not None:
            self.metrics.log("recovery", kind="rollback", reason=reason,
                             loss=v, to_iter=it,
                             attempt=self._consecutive,
                             lr_decay=self.lr_decay)
        return True

    def _abort(self, solver, v, reason):
        if self.metrics is not None:
            self.metrics.log("recovery", kind="abort", reason=reason,
                             loss=v, iter=solver.iter,
                             rollbacks=self.rollbacks)
        self.log(f"recovery: ABORT at iter {solver.iter}: {reason}")
        raise RecoveryAbort(f"training diverged at iter {solver.iter}: "
                            f"{reason}")
