"""Jittered exponential backoff with a retry budget for flaky IO.

The reference's contract was one IO error = one dead job
(spark.task.maxFailures=1); here a transient read error on a data source
costs a short sleep. Backoff is exponential with seeded jitter (so two
workers hammered by the same outage don't retry in lockstep, and tests
are deterministic), attempts are bounded per call, and an optional
``budget`` bounds total retries across the policy's lifetime — a
permanently sick disk exhausts the budget and surfaces as a real error
instead of an infinite crawl.
"""

import os
import time

import numpy as np


class RetryExhausted(OSError):
    """Retries exhausted; ``last`` holds the final underlying error."""

    def __init__(self, msg, last=None):
        super().__init__(msg)
        self.last = last


class RetryPolicy:
    """call(fn, ...) runs fn, retrying ``retry_on`` errors up to
    ``attempts`` times per call with jittered exponential backoff
    (base_s * 2^attempt, capped at max_s, +/- jitter fraction)."""

    def __init__(self, attempts=4, base_s=0.05, max_s=2.0, jitter=0.5,
                 budget=None, retry_on=(OSError,), seed=0,
                 sleep=time.sleep, metrics=None, log_fn=None):
        self.attempts = int(attempts)
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self.budget = None if budget is None else int(budget)
        self.retry_on = tuple(retry_on)
        self.sleep = sleep
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self._rng = np.random.RandomState(seed)
        self.retries_used = 0

    def delay(self, attempt):
        d = min(self.max_s, self.base_s * (2.0 ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * float(self._rng.uniform(-1.0, 1.0))
        return max(0.0, d)

    def record_failure(self, e, attempt, where=""):
        """Book one failed try: raise RetryExhausted when ``attempt``
        exceeds the per-call attempts or the lifetime budget is spent,
        else sleep the backoff delay and return. For retry loops that
        can't be expressed as re-invoking a function (e.g. restarting a
        DB cursor mid-generator) — ``attempt`` is the caller's count,
        reset on progress."""
        self.retries_used += 1
        exhausted = attempt > self.attempts or (
            self.budget is not None and self.retries_used > self.budget)
        if self.metrics is not None:
            self.metrics.log("retry", where=where, attempt=attempt,
                             error=repr(e), exhausted=exhausted)
        if exhausted:
            why = f"{self.attempts} attempts" if attempt > self.attempts \
                else f"retry budget ({self.budget})"
            raise RetryExhausted(f"{where or 'io'}: {why} exhausted: {e}",
                                 last=e) from e
        d = self.delay(attempt)
        self.log(f"retry {attempt}/{self.attempts} "
                 f"{where or 'io'} in {d * 1e3:.0f} ms: {e!r}")
        self.sleep(d)

    def call(self, fn, *args, where="", **kw):
        attempt = 0
        while True:
            try:
                return fn(*args, **kw)
            except self.retry_on as e:
                attempt += 1
                self.record_failure(e, attempt, where=where)


def retry_from_env(metrics=None, log_fn=None):
    """Default policy for data sources: SPARKNET_IO_RETRIES attempts
    (default 4; 0 disables -> None)."""
    try:
        attempts = int(os.environ.get("SPARKNET_IO_RETRIES", "4"))
    except ValueError:
        attempts = 4
    if attempts <= 0:
        return None
    return RetryPolicy(attempts=attempts, metrics=metrics, log_fn=log_fn)
