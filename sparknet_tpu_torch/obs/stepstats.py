"""Step accounting: host dispatch against device time, and step-time
percentiles (the port of sparknet_tpu/obs/stepstats.py).

PyTorch returns before the card finishes, so the host time of a step
measures its dispatch. This module records that every step and SAMPLES
the device side at a low cadence (the first two steps, then every
``sample_every``): on a sampled step the solver records a CUDA event
before the step (``begin``) and ``observe`` records one after it and
waits for it — device_ms is the card's time from the first to the last
of the step's work, the one sync the sample costs. On the CPU the
sample is the wall clock since the previous one over the steps between,
as in the JAX package.

Recompiles: the port runs its step eagerly, so nothing is ever traced
or recompiled. The first observed step logs the ``recompile`` event the
JAX package logs for its first compile (first=True, reason
"first_compile", cache_size 1), and none follows; ``recompiles`` stays
0 in the summary.
"""

import time


def percentiles(vals, qs=(50, 95, 99)):
    """Linear-interpolation percentiles of a sequence -> {"p50": ...}."""
    if not len(vals):
        return {}
    s = sorted(float(v) for v in vals)
    n = len(s)
    out = {}
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        out[f"p{q}"] = s[lo] + (s[hi] - s[lo]) * (pos - lo)
    return out


def device_memory(device=None):
    """The card's memory gauge from the caching allocator (None on the
    CPU): bytes in use, their peak and the card's total, under the JAX
    package's names."""
    import torch
    if not torch.cuda.is_available():
        return None
    dev = torch.device(device) if device is not None else \
        torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        return None
    ms = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev).total_memory)}


class StepAccounting:
    """Per-step accounting the solver calls once per train_step.

    Emits to the JSONL sink:
      step         at sampled steps: host_ms (this dispatch), sync_ms
                   (the wait for the step's end), device_ms (the card's
                   time of the step), steps_since_sync
      recompile    once, at the first step (see the module docstring)
      hbm          at sampled steps, on a card
      step_summary on flush(): p50/p95/p99 of both times and counts
    """

    def __init__(self, sink, sample_every=20, max_hist=8192, name="train"):
        self.sink = sink
        self.sample_every = max(1, int(sample_every))
        self.max_hist = max_hist
        self.name = name
        self.host_s = []            # ring buffer of host dispatch seconds
        self.device_s = []          # device seconds per sample
        self.steps = 0
        self.recompiles = 0         # the eager step never recompiles
        self._nobs = 0
        self._last_sample_it = None
        self._last_sample_t = None
        self._start_event = None
        self._hbm_dead = False

    def _push_host(self, v):
        if len(self.host_s) < self.max_hist:
            self.host_s.append(v)
        else:                       # ring overwrite, keeps recent window
            self.host_s[self.steps % self.max_hist] = v

    def will_sample(self, it):
        """Does the automatic cadence sample step ``it``?"""
        return self._nobs < 2 or self._last_sample_it is None \
            or (it - self._last_sample_it) >= self.sample_every

    def begin(self, it, device):
        """Before the step that ``observe`` will record as iteration
        ``it``, on ``device``: record the start event when that step will
        be sampled on a card."""
        self._start_event = None
        if device.type == "cuda" and self.will_sample(it):
            import torch
            self._start_event = torch.cuda.Event(enable_timing=True)
            self._start_event.record()

    def observe(self, it, host_s, result=None, sample=None, steps=1):
        """Record one step (or a round of ``steps`` iterations ending at
        iteration ``it``: its device time is divided over them). host_s:
        dispatch wall seconds. result: the step's output tensor (waited
        for at sample points). sample: None for the automatic cadence,
        True/False to force. Returns True when this step was sampled
        (the host has paid the device sync), so callers piggyback other
        costly sampling on it."""
        import torch
        self.steps += 1
        self._push_host(host_s)
        if self._nobs == 0:
            self.sink.log("recompile", iter=it, cache_size=1, first=True,
                          reason="first_compile")
        if sample is None:
            sample = self.will_sample(it)
        self._nobs += 1
        start, self._start_event = self._start_event, None
        if not sample or result is None:
            return False
        t0 = time.perf_counter()
        cuda = isinstance(result, torch.Tensor) and result.is_cuda
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
        now = time.perf_counter()
        sync_s = now - t0
        ev = {"iter": it, "host_ms": round(host_s * 1e3, 3),
              "sync_ms": round(sync_s * 1e3, 3)}
        if cuda and start is not None:
            k = max(1, int(steps))
            dev = start.elapsed_time(end) / 1e3 / k
        elif self._last_sample_t is not None and \
                self._last_sample_it is not None:
            k = max(1, it - self._last_sample_it)
            dev = (now - self._last_sample_t) / k
        else:
            # the first sample without an event: this step's whole wall
            dev, k = host_s + sync_s, 1
        self.device_s.append(dev)
        ev["device_ms"] = round(dev * 1e3, 3)
        ev["steps_since_sync"] = k
        self._last_sample_t = now
        self._last_sample_it = it
        self.sink.log("step", **ev)
        if not self._hbm_dead:
            mem = device_memory(result.device) if cuda else None
            if mem is None:
                self._hbm_dead = True       # the CPU: never probe again
            else:
                self.sink.log("hbm", iter=it, **mem)
        return True

    def summary(self):
        host = percentiles([v * 1e3 for v in self.host_s])
        dev = percentiles([v * 1e3 for v in self.device_s])
        out = {"steps": self.steps, "recompiles": self.recompiles,
               "device_samples": len(self.device_s)}
        out.update({f"host_ms_{k}": round(v, 3) for k, v in host.items()})
        out.update({f"device_ms_{k}": round(v, 3) for k, v in dev.items()})
        if self.host_s:
            out["host_ms_mean"] = round(
                sum(self.host_s) / len(self.host_s) * 1e3, 3)
            out["host_ms_max"] = round(max(self.host_s) * 1e3, 3)
        return out

    def flush(self, it=None):
        if self.steps:
            self.sink.log("step_summary", iter=it, name=self.name,
                          **self.summary())
