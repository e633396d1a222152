"""Structured metrics: one JSONL file, one line per event, in the JAX
package's utils/metrics.py format ({"event": ..., "t": seconds since
the logger opened, fields...})."""

import json
import time


class MetricsLogger:
    def __init__(self, path):
        self.f = open(path, "a")
        self.t0 = time.time()

    def log(self, event, **fields):
        rec = {"event": event, "t": round(time.time() - self.t0, 4),
               **fields}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()
