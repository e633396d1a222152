"""Request-level tracing primitives for the serving fleet.

The router mints one trace id per request and propagates it to the
replica via the ``X-Sparknet-Trace`` header; the replica stamps every
batcher stage (admission, enqueue, dispatch, forward start/end,
fulfill) and echoes a compact ``X-Sparknet-Stages`` breakdown back, so
the router can close the loop with network time = total − server-
reported. Three pieces live here because BOTH the real tier
(serve/server.py, serve/fleet.py) and the simulated one
(sim/servefleet.py) use them unchanged:

TraceSampler     head sampling + always-keep-the-tail exemplars: at
                 fleet QPS the per-request emit is a metrics-file hot
                 spot, but the tail is exactly what must never be
                 sampled away — any request slower than ``tail_ms`` is
                 kept regardless of the head-sampling stride. The
                 stride is deterministic (every k-th request), so event
                 volume under load is bounded and testable.
StageReservoir   bounded per-stage latency reservoirs (a sliding
                 window of the most recent samples) feeding the
                 router's /metrics percentile snapshot and the
                 "where did the p99 go" decomposition.
BurnRateLedger   SLO error-budget accounting with multi-window burn-
                 rate alerts (the SRE-workbook recipe): page when the
                 fast pair (5m AND 1h) both burn above ``fast_x``,
                 ticket when the slow pair (1h AND 6h) both burn above
                 ``slow_x``. Windows scale by one knob so a simulated
                 fleet (sim seconds) and a smoke run exercise the same
                 code path as a week of wall clock. Time is always
                 CALLER-provided (the router's injected clock), never
                 read here — the same ledger runs real and simulated.
"""

import collections
import threading

#: the canonical per-request stage decomposition, in causal order.
#: ``net`` is router-measured (total − server-reported); the rest are
#: replica-side batcher stamps. Sum ≈ router total (the residual is
#: handler overhead outside the stamped region).
STAGES = ("net", "queue", "batch", "infer", "fulfill")

TRACE_HEADER = "X-Sparknet-Trace"
STAGES_HEADER = "X-Sparknet-Stages"


def encode_stages(stages):
    """Stage breakdown dict -> the compact header value
    (``total=12.3;queue=4.5;infer=7.1`` — ms, 3 decimals, Nones
    dropped)."""
    parts = []
    for k, v in stages.items():
        if v is None:
            continue
        parts.append(f"{k}={round(float(v), 3):g}")
    return ";".join(parts)


def decode_stages(text):
    """Header value -> {stage: ms} (None on anything unparseable — a
    replica without tracing simply reports no breakdown)."""
    if not text:
        return None
    out = {}
    for part in str(text).split(";"):
        if "=" not in part:
            continue
        k, _, v = part.partition("=")
        try:
            out[k.strip()] = float(v)
        except ValueError:
            continue
    return out or None


class TraceSampler:
    """Head sampling with unconditional tail exemplars.

    ``sample`` is the kept fraction (1.0 = keep everything, the
    default, so tests and smoke keep today's behavior); ``tail_ms``
    is the exemplar threshold — a request at least that slow is ALWAYS
    kept (verdict "tail"), because the tail is the part of the
    distribution sampling must never erase."""

    def __init__(self, sample=1.0, tail_ms=None):
        self.sample = min(1.0, max(0.0, float(sample)))
        self.tail_ms = None if tail_ms is None else float(tail_ms)
        self._stride = (0 if self.sample <= 0
                        else max(1, int(round(1.0 / self.sample))))
        self._lock = threading.Lock()
        self._n = 0

    def decide(self, latency_ms):
        """-> "tail" | "head" | None (drop). Deterministic stride head
        sampling; the tail threshold wins over the stride."""
        if self.tail_ms is not None and latency_ms is not None \
                and float(latency_ms) >= self.tail_ms:
            return "tail"
        if self._stride == 0:
            return None
        with self._lock:
            self._n += 1
            keep = self._n % self._stride == 0
        return "head" if keep else None


class StageReservoir:
    """Sliding-window per-stage latency samples for percentile
    snapshots (``cap`` most recent per stage — serving wants the
    recent window, not the run mean)."""

    def __init__(self, cap=4096):
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._samples = {}                # spk: guarded-by=_lock

    def add(self, stages):
        with self._lock:
            for k, v in stages.items():
                if v is None:
                    continue
                d = self._samples.get(k)
                if d is None:
                    d = self._samples[k] = collections.deque(
                        maxlen=self.cap)
                d.append(float(v))

    def snapshot(self):
        """{stage: {"p50","p95","p99","n"}} over the current window."""
        from .stepstats import percentiles
        with self._lock:
            samples = {k: list(d) for k, d in self._samples.items()}
        out = {}
        for k, vals in sorted(samples.items()):
            if not vals:
                continue
            out[k] = {q: round(v, 3)
                      for q, v in percentiles(vals).items()}
            out[k]["n"] = len(vals)
        return out

    def p99(self):
        return {k: rec["p99"] for k, rec in self.snapshot().items()}


class BurnRateLedger:
    """Error-budget ledger with multi-window burn-rate alerts.

    A request is GOOD when it met the SLO (the caller decides: 200
    within ``slo_ms``). Burn rate over a window = bad_fraction /
    (1 - objective): x1 spends the budget exactly at the objective's
    allowed pace, x14.4 exhausts a 30-day budget in ~2 days. Alerts
    follow the two-window rule — both the long window (real spend) and
    its short confirmation window (still burning NOW) must breach:

      page    fast pair  (fast_s = 5m, 1h)  both > fast_x (14.4)
      ticket  slow pair  (slow_s = 1h, 6h)  both > slow_x (6.0)

    ``scale`` multiplies every window so sim seconds and smoke runs
    drive the same ladder. Events are bucketed into bins of the
    shortest window / 30, so memory is bounded at any QPS."""

    def __init__(self, slo_ms=500.0, objective=0.999,
                 fast_s=(300.0, 3600.0), slow_s=(3600.0, 21600.0),
                 fast_x=14.4, slow_x=6.0, scale=1.0, metrics=None,
                 log_fn=None):
        self.slo_ms = float(slo_ms)
        self.objective = min(0.999999, max(0.0, float(objective)))
        s = float(scale)
        self.fast_s = (float(fast_s[0]) * s, float(fast_s[1]) * s)
        self.slow_s = (float(slow_s[0]) * s, float(slow_s[1]) * s)
        self.fast_x = float(fast_x)
        self.slow_x = float(slow_x)
        self.metrics = metrics
        self.log = log_fn or (lambda *a: None)
        self._bin_s = max(self.fast_s[0] / 30.0, 1e-6)
        self._lock = threading.Lock()
        self._bins = collections.deque()  # spk: guarded-by=_lock
        self._good = 0                    # spk: guarded-by=_lock
        self._bad = 0                     # spk: guarded-by=_lock
        self._alert = None                # spk: guarded-by=_lock
        self.last = None                  # spk: guarded-by=_lock

    def good(self, code, latency_ms):
        """The SLI: did this response meet the latency SLO?"""
        return code == 200 and latency_ms is not None \
            and float(latency_ms) <= self.slo_ms

    def record(self, now, good):
        """One terminal response at caller-clock time ``now``."""
        b = int(now / self._bin_s)
        with self._lock:
            if self._bins and self._bins[-1][0] == b:
                rec = self._bins[-1]
            else:
                rec = [b, 0, 0]           # [bin, total, bad]
                self._bins.append(rec)
            rec[1] += 1
            if not good:
                rec[2] += 1
            if good:
                self._good += 1
            else:
                self._bad += 1
            # prune past the longest window (+1 bin of slack)
            horizon = b - int(self.slow_s[1] / self._bin_s) - 1
            while self._bins and self._bins[0][0] < horizon:
                self._bins.popleft()

    def _burn(self, bins, now, window_s):
        lo = int((now - window_s) / self._bin_s)
        total = bad = 0
        for b, t, n_bad in bins:
            if b >= lo:
                total += t
                bad += n_bad
        if total == 0:
            return None
        return (bad / total) / (1.0 - self.objective)

    def evaluate(self, now):
        """Window-loop entry: burn rates, alert verdict, budget left.
        Emits one ``slo_burn`` event per evaluation (bounded by the
        window cadence, not QPS) and logs alert transitions."""
        with self._lock:
            bins = [tuple(b) for b in self._bins]
            good, bad = self._good, self._bad
            prev = self._alert
        fast = self._burn(bins, now, self.fast_s[0])
        fast_long = self._burn(bins, now, self.fast_s[1])
        slow = self._burn(bins, now, self.slow_s[0])
        slow_long = self._burn(bins, now, self.slow_s[1])
        alert = None
        if fast is not None and fast_long is not None \
                and fast > self.fast_x and fast_long > self.fast_x:
            alert = "page"
        elif slow is not None and slow_long is not None \
                and slow > self.slow_x and slow_long > self.slow_x:
            alert = "ticket"
        # budget left over the slow long window: 1 - spend/allowance
        lo = int((now - self.slow_s[1]) / self._bin_s)
        total = sum(t for b, t, _ in bins if b >= lo)
        w_bad = sum(n for b, _, n in bins if b >= lo)
        allowed = total * (1.0 - self.objective)
        budget = None if total == 0 else \
            max(0.0, min(1.0, 1.0 - (w_bad / allowed if allowed > 0
                                     else (1.0 if w_bad else 0.0))))
        out = {"alert": alert,
               "fast": None if fast is None else round(fast, 3),
               "fast_long": (None if fast_long is None
                             else round(fast_long, 3)),
               "slow": None if slow is None else round(slow, 3),
               "slow_long": (None if slow_long is None
                             else round(slow_long, 3)),
               "budget_left": (None if budget is None
                               else round(budget, 4)),
               "good": good, "bad": bad}
        with self._lock:
            self._alert = alert
            self.last = dict(out)
        if alert != prev:
            self.log(f"slo: burn-rate alert -> {alert or 'clear'} "
                     f"(fast x{out['fast']}/{out['fast_long']}, "
                     f"slow x{out['slow']}/{out['slow_long']}, "
                     f"budget left {out['budget_left']})")
        if self.metrics is not None and (good or bad):
            self.metrics.log("slo_burn", alert=alert,
                             fast=out["fast"],
                             fast_long=out["fast_long"],
                             slow=out["slow"],
                             slow_long=out["slow_long"],
                             budget_left=out["budget_left"],
                             good=good, bad=bad)
        return out

    def snapshot(self):
        """The last evaluate() verdict (for /healthz), or None."""
        with self._lock:
            return None if self.last is None else dict(self.last)
