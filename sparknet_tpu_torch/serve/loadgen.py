"""Closed- and open-loop load generation against a ``serve`` replica or
a ``route`` router (the ``serve-bench`` verb; a port of
sparknet_tpu/serve/loadgen.py).

Closed loop — N workers each keep exactly one request in flight:
measures the server's capacity (throughput at full pipeline). Open
loop — requests arrive on a fixed-rate clock REGARDLESS of completions
(the honest way to measure latency under load: a closed loop slows its
own arrival rate when the server stalls, hiding the tail — the
coordinated-omission trap). Both emit `bench` rows through the metrics
stream, so serve latency lands in the run's JSONL beside its other
events.
"""

import json
import threading
import time

import numpy as np

from ..obs.tracing import STAGES_HEADER, decode_stages


def _discover(url, timeout=5.0):
    """GET /healthz -> feed shapes the payload must match."""
    from urllib.request import urlopen
    with urlopen(url.rstrip("/") + "/healthz", timeout=timeout) as r:
        return json.loads(r.read())


def _make_payload(feeds, rows, seed=0):
    rs = np.random.RandomState(seed)
    body = {}
    for name, per in feeds.items():
        if "label" in name or not per:
            continue              # labels zero-fill server-side
        body[name] = rs.randn(rows, *per).round(4).tolist()
    if not body:                  # label-only nets still need one feed
        name, per = next(iter(feeds.items()))
        body[name] = rs.randint(0, 10, (rows, *per)).tolist()
    return json.dumps(body).encode("utf-8")


class _Recorder:
    def __init__(self):
        self._lock = threading.Lock()
        self.lat_ms = []
        self.srv_ms = []    # server-attributed (echoed stage header)
        self.net_ms = []    # client-observed minus server-attributed
        self.ok = 0
        self.rejected = 0
        self.errors = 0
        self.dropped = 0

    def add(self, code, ms, server_ms=None):
        with self._lock:
            if code == 200:
                self.ok += 1
                self.lat_ms.append(ms)
                if server_ms is not None:
                    self.srv_ms.append(float(server_ms))
                    self.net_ms.append(
                        max(0.0, ms - float(server_ms)))
            elif code == 429:
                self.rejected += 1
            else:
                self.errors += 1

    def drop(self):
        with self._lock:
            self.dropped += 1

    def summary(self):
        from ..obs.stepstats import percentiles
        with self._lock:
            lats = list(self.lat_ms)
            srv = list(self.srv_ms)
            net = list(self.net_ms)
            out = {"ok": self.ok, "rejected": self.rejected,
                   "errors": self.errors, "dropped": self.dropped}
        out["requests"] = out["ok"] + out["rejected"] + out["errors"]
        if lats:
            out.update({f"latency_ms_{k}": round(v, 3)
                        for k, v in percentiles(lats).items()})
            out["latency_ms_mean"] = round(float(np.mean(lats)), 3)
            out["latency_ms_max"] = round(float(np.max(lats)), 3)
        if srv:
            # server-attributed vs network/client share: when these
            # disagree with the client-observed numbers, the missing
            # milliseconds are on the wire or in the client, not in
            # the server's batcher/forward path
            out.update({f"server_ms_{k}": round(v, 3)
                        for k, v in percentiles(srv).items()})
            out.update({f"net_ms_{k}": round(v, 3)
                        for k, v in percentiles(net).items()})
        return out


def _fire(url, payload, rec, timeout):
    from urllib.request import urlopen, Request
    from urllib.error import HTTPError, URLError
    t0 = time.perf_counter()
    server_ms = None
    try:
        req = Request(url.rstrip("/") + "/predict", data=payload,
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=timeout) as r:
            code = r.status
            r.read()
            stg = decode_stages(r.headers.get(STAGES_HEADER))
            if stg:
                server_ms = stg.get("total")
    except HTTPError as e:
        code = e.code
        e.read()
    except (URLError, OSError, TimeoutError):
        code = -1
    rec.add(code, (time.perf_counter() - t0) * 1e3,
            server_ms=server_ms)


def run_loadgen(url, mode="closed", concurrency=4, rate=50.0,
                duration_s=5.0, rows=1, seed=0, timeout=10.0,
                metrics=None, log_fn=print):
    """One load-generation run -> summary dict (also printed and, with
    ``metrics``, emitted as a `bench` row)."""
    log = log_fn or (lambda *a: None)
    health = _discover(url, timeout=timeout)
    feeds = {k: tuple(v) for k, v in (health.get("feeds") or {}).items()}
    payload = _make_payload(feeds, rows, seed=seed)
    rec = _Recorder()
    t_start = time.perf_counter()
    if mode == "closed":
        stop = time.perf_counter() + duration_s

        def worker():
            while time.perf_counter() < stop:
                _fire(url, payload, rec, timeout)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(int(concurrency))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    elif mode == "open":
        # fixed-rate arrivals; a bounded dispatch pool so a stalled
        # server surfaces as drops, not an unbounded thread pile-up
        gate = threading.Semaphore(max(4 * int(concurrency), 64))
        period = 1.0 / float(rate)
        next_t = time.perf_counter()
        end = next_t + duration_s
        live = []
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            if now < next_t:
                time.sleep(min(next_t - now, 0.01))
                continue
            next_t += period
            if not gate.acquire(blocking=False):
                rec.drop()
                continue

            def one():
                try:
                    _fire(url, payload, rec, timeout)
                finally:
                    gate.release()

            t = threading.Thread(target=one, daemon=True)
            t.start()
            live.append(t)
        for t in live:
            t.join(timeout)
    else:
        raise ValueError(f"unknown loadgen mode {mode!r}")
    wall = time.perf_counter() - t_start
    out = rec.summary()
    out.update({"mode": mode, "rows": rows, "duration_s": round(wall, 3),
                "url": url})
    out["rps"] = round(out["ok"] / wall, 2) if wall > 0 else None
    if mode == "closed":
        out["concurrency"] = int(concurrency)
    else:
        out["offered_rps"] = float(rate)
    log(f"serve-bench[{mode}]: {out['ok']} ok / "
        f"{out['rejected']} rejected / {out['errors']} errors in "
        f"{out['duration_s']}s -> {out['rps']} req/s, "
        f"p50={out.get('latency_ms_p50')} "
        f"p95={out.get('latency_ms_p95')} "
        f"p99={out.get('latency_ms_p99')} ms")
    if "server_ms_p99" in out:
        log(f"serve-bench[{mode}]: server share "
            f"p50={out['server_ms_p50']} p95={out['server_ms_p95']} "
            f"p99={out['server_ms_p99']} ms; network/client "
            f"p50={out['net_ms_p50']} p95={out['net_ms_p95']} "
            f"p99={out['net_ms_p99']} ms")
    if metrics is not None:
        metrics.log("bench", kind="serve", **out)
    return out
