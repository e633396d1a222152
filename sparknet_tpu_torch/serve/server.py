"""HTTP front end + serve loop for `python -m sparknet_tpu_torch serve`.

stdlib-only: a ThreadingHTTPServer owns the sockets (one handler
thread per connection), the calling thread runs serve_loop() — form a
batch, run the engine, fulfill the handler threads' Request events.
Endpoints:

  POST /predict   {"<feed blob>": [[...]...]} -> {"outputs": {...}}
                  (a bare list is taken as the first feed blob)
  GET  /healthz   loaded iter/model, buckets, feed shapes, queue depth
  GET  /metrics   latency percentiles + counters snapshot

Supervisor contract (the JAX package's DEPLOY.md "Serving"):
SIGTERM/SIGINT stop accepting (backpressure 429s), drain queued
requests, exit EXIT_OK(0). A checkpoint that cannot load exits
EXIT_RECOVERY_ABORT(3) before the socket ever opens, so an
orchestrator's restart loop can tell "bad checkpoint" from "crash".

Every batch emits the JAX package's events (serve_request, serve_batch,
serve_reject, serve_reload, serve_summary, serve_trace) so the
``report`` and ``monitor`` verbs render the serving section with no
special cases. A port of sparknet_tpu/serve/server.py with the same
events, headers and wire format: a port replica and a JAX replica serve
behind one router.
"""

import collections
import json
import sys
import threading
import time

import numpy as np

from .batcher import RejectedError
from ..obs.tracing import STAGES_HEADER, TRACE_HEADER, encode_stages


def stage_breakdown(req, now):
    """Per-stage wall attribution for one fulfilled Request, in ms:
    queue (admission->dispatch), batch (dispatch->forward), infer
    (the forward itself), fulfill (forward->response write). Missing
    stamps collapse to zero-width stages (never negative, never NaN),
    so the sum always ≈ total — the decomposition invariant the
    tests pin."""
    t_enq = req.t_enq if req.t_enq is not None else req.t_submit
    t_dis = req.t_dispatch if req.t_dispatch is not None else t_enq
    t_f0 = req.t_fwd0 if req.t_fwd0 is not None else t_dis
    t_f1 = req.t_fwd1 if req.t_fwd1 is not None else t_f0
    t_done = req.t_done if req.t_done is not None else t_f1
    ms = lambda a, b: max(0.0, (b - a) * 1e3)  # noqa: E731
    return {
        "queue": ms(req.t_submit, t_dis),
        "batch": ms(t_dis, t_f0),
        "infer": ms(t_f0, t_f1),
        "fulfill": ms(t_f1, max(t_done, now)),
        "total": ms(req.t_submit, max(t_done, now)),
    }


class ServeStats:
    """Latency window and counters; every field guarded by ``_lock``."""

    def __init__(self, window=4096):
        self._lock = threading.Lock()
        self.t0 = time.monotonic()
        self.lat_ms = collections.deque(maxlen=window)
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.fill_sum = 0.0
        self.rejects = 0
        self.reloads = 0

    def record_batch(self, reqs, bucket, infer_ms):
        now = time.monotonic()
        with self._lock:
            self.batches += 1
            rows = sum(r.n for r in reqs)
            self.rows += rows
            self.requests += len(reqs)
            self.fill_sum += rows / float(bucket)
            for r in reqs:
                self.lat_ms.append((now - r.t_submit) * 1e3)

    def record_reject(self):
        with self._lock:
            self.rejects += 1

    def record_reload(self):
        with self._lock:
            self.reloads += 1

    def snapshot(self):
        from ..obs.stepstats import percentiles
        with self._lock:
            lats = list(self.lat_ms)
            out = {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "rejects": self.rejects,
                "reloads": self.reloads,
                "uptime_s": round(time.monotonic() - self.t0, 3),
                "batch_fill": round(
                    self.fill_sum / self.batches, 4) if self.batches
                else None,
            }
        lat = {f"latency_ms_{k}": round(v, 3)
               for k, v in percentiles(lats).items()} if lats else {}
        out.update(lat)
        if out["uptime_s"] > 0:
            out["rps"] = round(out["requests"] / out["uptime_s"], 2)
        return out


def _make_handler(engine, batcher, stats, timeout_s, member=None,
                  metrics=None, tracer=None, replica=None):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet access log
            pass

        def _send_json(self, code, obj, headers=None):
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                st = engine.status()
                st["status"] = "ok"
                st["queue_depth"] = batcher.depth()
                st["draining"] = batcher.draining()
                if member is not None:
                    # lease/membership fields (serve/fleet.py): the
                    # same truth the router reads from the beat
                    st.update(member.health())
                self._send_json(200, st)
            elif self.path == "/metrics":
                snap = stats.snapshot()
                snap["queue_depth"] = batcher.depth()
                snap.update(batcher.counters())
                self._send_json(200, snap)
            else:
                self._send_json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send_json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, TypeError) as e:
                self._send_json(400, {"error": f"bad JSON: {e}"})
                return
            try:
                arrays, n = _parse_inputs(payload, engine.feed_shapes())
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            # router-minted trace id rides the request header; the
            # value is "<id>;<attempt>" so retries share one id
            trace = None
            raw = self.headers.get(TRACE_HEADER)
            if raw:
                trace = raw.split(";", 1)[0].strip() or None
            try:
                req = batcher.submit(arrays, n=n, trace=trace)
            except RejectedError as e:
                stats.record_reject()
                self._send_json(429, {"error": str(e),
                                      "reason": e.reason,
                                      "queue_depth": e.queue_depth})
                return
            if not req.wait(timeout_s):
                self._send_json(504, {"error": "inference timed out"})
                return
            if req.error is not None:
                self._send_json(500, {"error": req.error})
                return
            stg = stage_breakdown(req, time.monotonic())
            hdrs = {STAGES_HEADER: encode_stages(stg)}
            if trace:
                hdrs[TRACE_HEADER] = trace
            self._send_json(200, {
                "outputs": {k: v.tolist() for k, v in req.result.items()},
                "iter": engine.status().get("iter"),
                "bucket": req.bucket,
                "latency_ms": round((req.t_done - req.t_submit) * 1e3, 3),
                "stages": {k: round(v, 3) for k, v in stg.items()},
            }, headers=hdrs)
            # replica-side exemplar: lets fleettrace place this
            # request on the replica track with the router's id
            if metrics is not None:
                verdict = tracer.decide(stg["total"]) if tracer \
                    is not None else "head"
                if verdict is not None:
                    metrics.log("serve_trace",
                                src=f"replica{replica}"
                                    if replica is not None else "replica",
                                trace=trace, replica=replica, code=200,
                                total_ms=round(stg["total"], 3),
                                queue_ms=round(stg["queue"], 3),
                                batch_ms=round(stg["batch"], 3),
                                infer_ms=round(stg["infer"], 3),
                                fulfill_ms=round(stg["fulfill"], 3),
                                tail=verdict == "tail")

    return Handler


def _parse_inputs(payload, feed_shapes):
    """JSON body -> ({feed blob -> ndarray}, rows). A bare list feeds
    the first (primary) blob; labels and other feeds default to
    zero-fill in the engine."""
    names = list(feed_shapes)
    if not names:
        raise ValueError("net has no feed blobs")
    if isinstance(payload, list):
        payload = {names[0]: payload}
    if not isinstance(payload, dict) or not payload:
        raise ValueError(
            f"expected a JSON object keyed by feed blob {names}")
    arrays, n = {}, None
    for k, v in payload.items():
        if k not in feed_shapes:
            raise ValueError(f"unknown feed blob {k!r} (have {names})")
        arr = np.asarray(v)
        per = tuple(feed_shapes[k])
        if arr.shape == per:        # single sample without batch dim
            arr = arr[None]
        if arr.shape[1:] != per:
            raise ValueError(
                f"feed {k!r}: per-sample shape {arr.shape[1:]} != {per}")
        if n is None:
            n = arr.shape[0]
        elif arr.shape[0] != n:
            raise ValueError("feed blobs disagree on row count")
        arrays[k] = arr
    return arrays, int(n)


def _run_batch(engine, batcher, stats, metrics, reqs, wait_ms,
               tracer=None, chaos=None, replica=None):
    """One engine step for one closed batch; fulfills every Request."""
    rows = sum(r.n for r in reqs)
    depth = batcher.depth()
    arrays = {}
    for name, per in engine.feed_shapes().items():
        if not any(name in r.arrays for r in reqs):
            continue                # engine zero-fills the whole feed
        parts = [np.asarray(r.arrays[name]) if name in r.arrays
                 else np.zeros((r.n,) + tuple(per))
                 for r in reqs]
        arrays[name] = np.concatenate(parts, axis=0)
    fwd0 = time.monotonic()
    for r in reqs:
        r.t_fwd0 = fwd0
    if chaos is not None and replica is not None:
        # injected slowness lands INSIDE the forward stage, matching
        # the sim (which inflates service time) — so "where did the
        # p99 go" names infer, the stage a slow accelerator shows as
        chaos.maybe_slow_replica(int(replica))
    t0 = time.perf_counter()
    try:
        out, bucket = engine.forward(arrays, n=rows)
    except Exception as e:          # net-level failure -> 500s, keep serving
        now = time.monotonic()
        for r in reqs:
            r.error = f"{type(e).__name__}: {e}"
            r.t_fwd1 = now
            r.t_done = now
            r.done.set()
        return
    infer_ms = (time.perf_counter() - t0) * 1e3
    off = 0
    now = time.monotonic()
    for r in reqs:
        r.result = {k: v[off:off + r.n] for k, v in out.items()}
        r.bucket = bucket
        r.t_fwd1 = now
        r.t_done = now
        off += r.n
        r.done.set()
    stats.record_batch(reqs, bucket, infer_ms)
    if metrics is not None:
        it = engine.status().get("iter")
        metrics.log("serve_batch", size=rows, requests=len(reqs),
                    bucket=bucket, fill=round(rows / float(bucket), 4),
                    queue_depth=depth, wait_ms=round(wait_ms, 3),
                    infer_ms=round(infer_ms, 3), iter=it)
        for r in reqs:
            lat_ms = (r.t_done - r.t_submit) * 1e3
            if tracer is not None and tracer.decide(lat_ms) is None:
                continue    # head-sampled out; tails always kept
            metrics.log("serve_request",
                        latency_ms=round(lat_ms, 3),
                        wait_ms=round(wait_ms, 3), rows=r.n,
                        bucket=bucket)


def serve_loop(engine, batcher, stats, metrics=None, policy=None,
               reload_poll_s=0.0, stop_event=None, idle_timeout=0.05,
               chaos=None, replica=None, tracer=None, log_fn=print):
    """The single consumer thread: batches, signals, hot reload, drain.
    Returns 0 after a clean drain (the supervisor contract)."""
    log = log_fn or (lambda *a: None)
    next_reload = time.monotonic() + reload_poll_s if reload_poll_s else None
    inject = chaos is not None and replica is not None
    draining = False
    served = 0
    while True:
        if not draining:
            action = policy.pending() if policy is not None else None
            if action is not None and "stop" in action:
                log("serve: stop requested; draining "
                    f"{batcher.pending()} queued request(s)")
                batcher.close()
                draining = True
            elif stop_event is not None and stop_event.is_set():
                log("serve: drain requested; draining "
                    f"{batcher.pending()} queued request(s)")
                batcher.close()
                draining = True
        if next_reload is not None and not draining \
                and time.monotonic() >= next_reload:
            if engine.poll_reload() is not None:
                stats.record_reload()
            next_reload = time.monotonic() + reload_poll_s
        reqs, wait_ms = batcher.next_batch(timeout=idle_timeout)
        if reqs:
            _run_batch(engine, batcher, stats, metrics, reqs, wait_ms,
                       tracer=tracer,
                       chaos=chaos if inject else None,
                       replica=replica if inject else None)
            served += len(reqs)
            if inject:
                # kill_replica fires AFTER the kill_req-th request is
                # fulfilled: the dispatch-then-die case the router's
                # retry-once must never double
                chaos.maybe_kill_replica_self(int(replica), served)
        elif draining and batcher.pending() == 0:
            return 0


def serve_http(engine, batcher, host="127.0.0.1", port=0, metrics=None,
               policy=None, reload_poll_s=0.0, stop_event=None,
               request_timeout_s=30.0, member=None, chaos=None,
               replica=None, tracer=None, log_fn=print, on_listen=None):
    """Bind, announce, serve until drained; returns the exit code.
    With ``member`` (serve/fleet.py ReplicaMember) the replica leases
    into the fleet rendezvous once the socket is bound (the URL is in
    the beat payload) and its drain order rides ``stop_event``.
    ``on_listen(url)`` is called once the socket is bound."""
    from http.server import ThreadingHTTPServer
    log = log_fn or (lambda *a: None)
    stats = ServeStats()
    handler = _make_handler(engine, batcher, stats, request_timeout_s,
                            member=member, metrics=metrics,
                            tracer=tracer, replica=replica)
    httpd = ThreadingHTTPServer((host, int(port)), handler)
    httpd.daemon_threads = True
    addr = f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    if member is not None:
        member.start(url=addr)
        if stop_event is None:
            stop_event = member.drain_event
    st = engine.status()
    log(f"sparknet_tpu_torch serve: listening on {addr} (iter "
        f"{st.get('iter')}, buckets {st.get('buckets')}, device "
        f"{st.get('device')})")
    sys.stdout.flush()      # the announce line is what launchers wait for
    if on_listen is not None:
        on_listen(addr)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        rc = serve_loop(engine, batcher, stats, metrics=metrics,
                        policy=policy, reload_poll_s=reload_poll_s,
                        stop_event=stop_event, chaos=chaos,
                        replica=replica, tracer=tracer, log_fn=log)
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        if member is not None:
            member.stop()
    snap = stats.snapshot()
    if metrics is not None:
        metrics.log("serve_summary", requests=snap.get("requests"),
                    rows=snap.get("rows"), batches=snap.get("batches"),
                    rejects=snap.get("rejects"),
                    reloads=snap.get("reloads"),
                    rps=snap.get("rps"),
                    latency_ms_p50=snap.get("latency_ms_p50"),
                    latency_ms_p95=snap.get("latency_ms_p95"),
                    latency_ms_p99=snap.get("latency_ms_p99"),
                    batch_fill=snap.get("batch_fill"),
                    uptime_s=snap.get("uptime_s"), drained=True)
    log(f"serve: drained cleanly after {snap.get('requests', 0)} "
        f"request(s); exiting 0")
    return rc
