"""Structured metrics: one JSONL stream, one line per event, in the JAX
package's utils/metrics.py format ({"event": ..., "t": seconds since
the logger opened, fields...}).

Every part of the port's observability writes through one
MetricsLogger (the span tracer, step accounting, the watchdog from its
monitor thread, recovery, checkpoints), so writes take a lock, the
logger is a context manager, and a field that JSON cannot encode
(a tensor, a dtype, a numpy array, a Path) goes through a safe encoder
instead of raising mid-run.
"""

import json
import sys
import threading
import time


def json_default(o):
    """Best-effort JSON encoding of a metric field value: scalars as
    numbers, small arrays and tensors as lists, large ones as their
    shape and dtype, anything else as its str()."""
    try:
        import torch
    except ImportError:             # the report verb runs without torch
        torch = None
    if torch is not None and isinstance(o, torch.Tensor):
        o = o.detach()
        if o.dim() == 0:
            return o.item()
        if o.numel() <= 64:
            return o.cpu().tolist()
        return {"shape": list(o.shape), "dtype": str(o.dtype),
                "summary": "array too large; elided"}
    if getattr(o, "ndim", None) == 0 and hasattr(o, "item"):
        try:
            return o.item()            # numpy scalar
        except Exception:
            pass
    if hasattr(o, "tolist"):           # ndarray
        try:
            if getattr(o, "size", 0) <= 64:
                return o.tolist()
            return {"shape": list(getattr(o, "shape", ())),
                    "dtype": str(getattr(o, "dtype", "?")),
                    "summary": "array too large; elided"}
        except Exception:
            pass
    if isinstance(o, (set, frozenset)):
        return sorted(str(x) for x in o)
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    return str(o)                      # torch.dtype, Paths, enums, ...


class MetricsLogger:
    """``path``: the JSONL file (appended to); without one the events go
    to ``stream`` (stderr by default)."""

    def __init__(self, path=None, stream=None, run_id=None):
        # the file handle and the closed flag are shared with the
        # watchdog and tracer threads that log through this object
        self._lock = threading.Lock()
        self.f = open(path, "a") if path else (stream or sys.stderr)
        self._own = path is not None
        self.run_id = run_id
        self.t0 = time.time()
        self._closed = False

    def log(self, event, **fields):
        rec = {"event": event, "t": round(time.time() - self.t0, 4)}
        if self.run_id:
            rec["run"] = self.run_id
        for k, v in fields.items():
            if getattr(v, "ndim", None) == 0 and hasattr(v, "item"):
                try:
                    v = v.item()       # numpy or torch scalar
                except Exception:
                    pass
            rec[k] = v
        try:
            line = json.dumps(rec, default=json_default)
        except (TypeError, ValueError) as e:
            # circular references etc.: record that the event existed
            line = json.dumps({"event": event, "t": rec["t"],
                               "encode_error": str(e)})
        with self._lock:
            if self._closed:
                return
            self.f.write(line + "\n")
            self.f.flush()

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._own:
                self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
