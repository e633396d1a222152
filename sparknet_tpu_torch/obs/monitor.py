"""The ``monitor`` verb — live terminal view of a training run or a
serving fleet (a port of sparknet_tpu/obs/monitor.py: the same text on
the same stream, over the port's report.py).

The ``report`` verb is a post-mortem; this is the in-flight view. It tails
the metrics JSONL a run writes via --metrics (the same single stream the
whole obs subsystem shares) and renders a compact summary that refreshes
in place: current round/iter and loss, per-worker losses, worker
divergence with top offender layers, straggler flags, memory/compile
state, and the last health alarm. Pure file tailing — no torch, no
connection to the training process — so it works over any shared
filesystem, from any machine, against a live or finished run.

Partial trailing lines (the run is mid-write) are buffered until their
newline arrives; malformed lines are counted and skipped, never fatal.
"""

import collections
import json
import os
import sys
import threading
import time

from .report import MetricsFileError, _fmt_bytes, _num


class MonitorState:
    """Fold metrics events into the "now" view of a run.

    Thread contract: the live view ingests on a background tailer
    thread (monitor_file) while the main thread renders, so every
    mutable field is guarded by ``_lock``; ``update``/``render`` take the lock, the ``_locked`` twins assume
    it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events = 0
        self.bad_lines = 0
        self.by_type = collections.Counter()
        self.iter = None
        self.round = None
        self.loss = None
        self.min_loss = None
        self.lr = None
        self.rate = None            # (name, value)
        self.step = None            # last step event
        self.worker_loss = None
        self.divergence = None      # last divergence event
        self.memstats = None
        self.comms = None
        self.alarms = collections.Counter()
        self.last_alarm = None
        self.straggler_counts = collections.Counter()
        self.recompiles = 0
        self.recoveries = 0
        self.chaos = 0
        self.checkpoint_iter = None
        # elastic membership (resilience/elastic.py)
        self.live = None            # last reported live worker count
        self.evictions = collections.Counter()   # worker -> count
        self.last_eviction = None
        self.readmissions = 0
        self.quorum_lost = None
        # async bounded staleness (resilience/elastic.py)
        self.staleness = None       # last staleness event (lag/version)
        self.parks = collections.Counter()       # worker -> park count
        self.unparks = 0
        self.last_park = None
        # host fault domains (resilience/heartbeat.py)
        self.host_alive = {}        # host -> bool (last transition)
        self.host_lease_age = None  # last per-host lease-age vector
        self.host_gate = None       # last host_round event
        self.host_evictions = collections.Counter()
        self.host_joins = collections.Counter()
        self.last_host_join = None
        self.coordinated_restart = None
        # fleet simulation (sim/fleet.py, per-round summary)
        self.sim = None             # last sim event
        # fleet timeline (obs/fleettrace.py): clock-sync beacons plus
        # per-observer gate waits of the newest round — the live
        # blocker estimate (the full solve is the trace verb)
        self.align_beacons = 0
        self.align_hosts = set()
        self.gate_waits = {}        # round -> {observer: wait_s}
        self.last_gate_round = None
        # elastic world resizing (resilience/checkpoint.py reshard)
        self.reshard = None         # last reshard event, if any
        # input pipeline (data/prefetch.py, data/ingest.py)
        self.prefetch = None        # last prefetch gauge event
        self.h2d_stage = None       # last h2d_stage event
        self.ingest_hosts = {}      # host -> last ingest event
        self.ingest_respreads = 0
        # serving tier (serve/server.py)
        self.serve_requests = 0
        self.serve_rows = 0
        self.serve_batches = 0
        self.serve_rejects = 0
        self.serve_reloads = 0
        self.serve_fill_sum = 0.0
        self.serve_lat_ms = collections.deque(maxlen=2048)
        self.last_serve_batch = None
        self.last_serve_reject = None
        self.last_serve_reload = None
        self.serve_summary = None
        # routing fleet (serve/fleet.py, the route verb)
        self.route_dispatches = 0
        self.route_by_code = collections.Counter()
        self.route_retried = 0
        self.route_lat_ms = collections.deque(maxlen=2048)
        self.scale_events = []      # (action, reason, live)
        self.last_canary = None
        self.canary_rollbacks = 0
        # request tracing + SLO burn (obs/tracing.py)
        self.trace_count = 0
        self.trace_tails = 0
        self.trace_stage_ms = {
            k: collections.deque(maxlen=2048)
            for k in ("net", "queue", "batch", "infer", "fulfill")}
        self.trace_total_ms = collections.deque(maxlen=2048)
        self.last_burn = None
        self.burn_alerts = collections.Counter()
        self.done = None            # summary event, if the run finished

    def update(self, ev):
        with self._lock:
            self._update_locked(ev)

    def note_bad_line(self):
        with self._lock:
            self.bad_lines += 1

    def _update_locked(self, ev):
        self.events += 1
        kind = ev.get("event", "?")
        self.by_type[kind] += 1
        if kind in ("train", "round"):
            if _num(ev.get("iter")):
                self.iter = ev["iter"]
            if _num(ev.get("round")):
                self.round = ev["round"]
            if _num(ev.get("loss")):
                self.loss = ev["loss"]
                self.min_loss = ev["loss"] if self.min_loss is None \
                    else min(self.min_loss, ev["loss"])
            if _num(ev.get("lr")):
                self.lr = ev["lr"]
            for r in ("images_per_sec", "tokens_per_sec", "images_per_s"):
                if _num(ev.get(r)):
                    self.rate = (r, ev[r])
        elif kind == "step":
            self.step = ev
            if _num(ev.get("iter")):
                self.iter = max(self.iter or 0, ev["iter"])
        elif kind == "divergence":
            self.divergence = ev
            if ev.get("worker_loss"):
                self.worker_loss = ev["worker_loss"]
            if _num(ev.get("round")):
                self.round = ev["round"]
        elif kind == "health":
            k = ev.get("kind", "?")
            self.alarms[k] += 1
            self.last_alarm = ev
            if k == "straggler" and ev.get("worker") is not None:
                self.straggler_counts[ev["worker"]] += 1
        elif kind == "memstats":
            self.memstats = ev
        elif kind == "comms":
            self.comms = ev
        elif kind == "recompile":
            if not ev.get("first"):
                self.recompiles += 1
        elif kind == "recovery":
            self.recoveries += 1
        elif kind == "chaos":
            self.chaos += 1
        elif kind == "checkpoint":
            if _num(ev.get("iter")):
                self.checkpoint_iter = ev["iter"]
        elif kind == "eviction":
            if ev.get("worker") is not None:
                self.evictions[ev["worker"]] += 1
            self.last_eviction = ev
            if _num(ev.get("live")):
                self.live = ev["live"]
        elif kind == "readmission":
            self.readmissions += 1
            if _num(ev.get("live")):
                self.live = ev["live"]
        elif kind == "membership":
            if ev.get("kind") == "quorum_lost":
                self.quorum_lost = ev
            if ev.get("kind") == "coordinated_restart":
                self.coordinated_restart = ev
            if _num(ev.get("live")):
                self.live = ev["live"]
        elif kind == "staleness":
            self.staleness = ev
        elif kind == "parked":
            if ev.get("worker") is not None:
                self.parks[ev["worker"]] += 1
            self.last_park = ev
        elif kind == "unparked":
            self.unparks += 1
        elif kind == "host_alive":
            if ev.get("host") is not None:
                self.host_alive[int(ev["host"])] = bool(ev.get("alive"))
        elif kind == "host_round":
            self.host_gate = ev
            if isinstance(ev.get("lease_age_s"), list):
                self.host_lease_age = ev["lease_age_s"]
            if _num(ev.get("round")) and ev.get("observer") is not None:
                r = int(ev["round"])
                self.gate_waits.setdefault(r, {})[int(ev["observer"])] \
                    = float(ev.get("wait_s") or 0.0)
                self.last_gate_round = r
                for old in sorted(self.gate_waits)[:-4]:
                    del self.gate_waits[old]
        elif kind == "trace_align":
            self.align_beacons += 1
            for f in ("observer", "peer"):
                if isinstance(ev.get(f), int):
                    self.align_hosts.add(ev[f])
        elif kind == "host_evicted":
            if ev.get("host") is not None:
                self.host_evictions[int(ev["host"])] += 1
        elif kind == "host_joined":
            if ev.get("host") is not None:
                self.host_joins[int(ev["host"])] += 1
                self.host_alive[int(ev["host"])] = True
            self.last_host_join = ev
        elif kind == "sim":
            self.sim = ev
            if _num(ev.get("round")):
                self.round = ev["round"]
        elif kind == "reshard":
            self.reshard = ev
        elif kind == "prefetch":
            self.prefetch = ev
        elif kind == "h2d_stage":
            self.h2d_stage = ev
        elif kind == "ingest":
            if ev.get("host") is not None:
                self.ingest_hosts[int(ev["host"])] = ev
            if ev.get("kind") == "respread":
                self.ingest_respreads += 1
        elif kind == "serve_request":
            self.serve_requests += 1
            if _num(ev.get("rows")):
                self.serve_rows += ev["rows"]
            if _num(ev.get("latency_ms")):
                self.serve_lat_ms.append(ev["latency_ms"])
        elif kind == "serve_batch":
            self.serve_batches += 1
            if _num(ev.get("fill")):
                self.serve_fill_sum += ev["fill"]
            self.last_serve_batch = ev
            if _num(ev.get("iter")):
                self.iter = max(self.iter or 0, ev["iter"])
        elif kind == "serve_reject":
            self.serve_rejects += 1
            self.last_serve_reject = ev
        elif kind == "serve_reload":
            self.serve_reloads += 1
            self.last_serve_reload = ev
        elif kind == "serve_summary":
            self.serve_summary = ev
        elif kind == "route":
            self.route_dispatches += 1
            if _num(ev.get("code")):
                self.route_by_code[int(ev["code"])] += 1
            if ev.get("retried"):
                self.route_retried += 1
            if _num(ev.get("latency_ms")):
                self.route_lat_ms.append(ev["latency_ms"])
        elif kind == "scale":
            self.scale_events.append((ev.get("action"),
                                      ev.get("reason"), ev.get("live")))
        elif kind == "canary":
            self.last_canary = ev
            if ev.get("action") == "rollback":
                self.canary_rollbacks += 1
        elif kind == "serve_trace":
            self.trace_count += 1
            if ev.get("tail"):
                self.trace_tails += 1
            if _num(ev.get("total_ms")):
                self.trace_total_ms.append(ev["total_ms"])
            for k, dq in self.trace_stage_ms.items():
                if _num(ev.get(f"{k}_ms")):
                    dq.append(ev[f"{k}_ms"])
        elif kind == "slo_burn":
            self.last_burn = ev
            if ev.get("alert"):
                self.burn_alerts[str(ev["alert"])] += 1
        elif kind == "summary":
            self.done = ev

    # -- rendering ---------------------------------------------------------
    @staticmethod
    def _fmt_workers(vals, fmt="{:.4g}"):
        return "[" + " ".join(fmt.format(v) for v in vals) + "]"

    def render(self, path=""):
        with self._lock:
            return self._render_locked(path)

    def _render_locked(self, path):
        L = []
        status = "FINISHED" if self.done else "live"
        L.append(f"sparknet monitor — {path} ({self.events} events, "
                 f"{self.bad_lines} bad lines, {status})")
        pos = []
        if self.round is not None:
            pos.append(f"round {self.round}")
        if self.iter is not None:
            pos.append(f"iter {self.iter}")
        if self.loss is not None:
            pos.append(f"loss {self.loss:.6g}"
                       + (f" (min {self.min_loss:.6g})"
                          if self.min_loss is not None else ""))
        if self.lr is not None:
            pos.append(f"lr {self.lr:.4g}")
        if self.rate:
            pos.append(f"{self.rate[0]} {self.rate[1]:,.0f}")
        if pos:
            L.append("  " + "  ".join(pos))
        if self.step:
            bits = [f"host {self.step.get('host_ms', '?')} ms",
                    f"device {self.step.get('device_ms', '?')} ms"]
            if self.recompiles:
                bits.append(f"recompiles {self.recompiles}")
            L.append("  step: " + "  ".join(bits))
        if self.worker_loss:
            L.append("  workers: loss " + self._fmt_workers(self.worker_loss)
                     + f"  skew {max(self.worker_loss) - min(self.worker_loss):.4g}")
        d = self.divergence
        if d:
            line = f"  divergence: mean {d.get('mean', 0):.4g} " \
                   f"max {d.get('max', 0):.4g}"
            if _num(d.get("rel")):
                line += f"  rel {d['rel']:.3g}"
            if _num(d.get("gns_proxy")):
                line += f"  gns~{d['gns_proxy']:.3g}"
            if d.get("tau"):
                line += f"  tau={d['tau']}"
            L.append(line)
            if d.get("top_layers"):
                L.append("    top layers: " + ", ".join(
                    f"{k}={v:.3g}" for k, v in d["top_layers"]))
        if self.evictions or self.quorum_lost or self.readmissions:
            bits = []
            if self.live is not None:
                bits.append(f"{self.live} live")
            bits.append(f"evictions {sum(self.evictions.values())}"
                        + (" (" + ", ".join(
                            f"w{w}:{c}" for w, c in
                            self.evictions.most_common()) + ")"
                           if self.evictions else ""))
            if self.readmissions:
                bits.append(f"readmissions {self.readmissions}")
            L.append("  membership: " + "  ".join(bits))
            if self.last_eviction is not None:
                e = self.last_eviction
                L.append(f"    last eviction: worker {e.get('worker')} "
                         f"round {e.get('round')} ({e.get('reason')})")
            if self.quorum_lost is not None:
                q = self.quorum_lost
                L.append(f"    QUORUM LOST: {q.get('live')} live < "
                         f"quorum {q.get('quorum')}")
        if self.staleness or self.parks or self.unparks:
            bits = []
            st = self.staleness or {}
            if _num(st.get("s")):
                bits.append(f"s={st['s']}")
            if isinstance(st.get("lag"), list):
                bits.append("lag " + self._fmt_workers(st["lag"], "{:d}"))
            if isinstance(st.get("parked"), list) and st["parked"]:
                bits.append(f"parked {st['parked']}")
            bits.append(f"parks {sum(self.parks.values())}"
                        + (" (" + ", ".join(
                            f"w{w}:{c}" for w, c in
                            self.parks.most_common()) + ")"
                           if self.parks else ""))
            if self.unparks:
                bits.append(f"unparks {self.unparks}")
            L.append("  staleness: " + "  ".join(bits))
            if self.last_park is not None:
                p = self.last_park
                L.append(f"    last park: {p.get('unit', 'worker')} "
                         f"{p.get('worker')} round {p.get('round')} "
                         f"(lag {p.get('lag')})")
        if (self.host_alive or self.host_gate or self.host_evictions
                or self.host_joins):
            bits = []
            if self.host_alive:
                down = sorted(h for h, a in self.host_alive.items() if not a)
                up = sorted(h for h, a in self.host_alive.items() if a)
                bits.append(f"up {up}" + (f" DOWN {down}" if down else ""))
            if self.host_evictions:
                bits.append("evicted " + ", ".join(
                    f"h{h}:{c}" for h, c in self.host_evictions.most_common()))
            if self.host_joins:
                bits.append("joined " + ", ".join(
                    f"h{h}" for h in sorted(self.host_joins)))
            if self.host_gate and _num(self.host_gate.get("wait_s")):
                bits.append(f"gate wait {self.host_gate['wait_s']:.3f}s "
                            f"@r{self.host_gate.get('round')}")
            L.append("  hosts: " + "  ".join(bits))
            if self.last_host_join is not None:
                j = self.last_host_join
                L.append(f"    last join: host {j.get('host')} at round "
                         f"{j.get('round')} ({j.get('via')}, world -> "
                         f"{j.get('world')})")
            if self.host_lease_age:
                L.append("    lease ages: " + " ".join(
                    f"{a:.2f}s" for a in self.host_lease_age))
            if self.coordinated_restart is not None:
                cr = self.coordinated_restart
                L.append("    coordinated restart "
                         + ("AGREED" if cr.get("agreed") else "DISAGREED")
                         + f" across hosts {cr.get('hosts')}")
        waits = self.gate_waits.get(self.last_gate_round) or {}
        if self.align_beacons or len(waits) > 1:
            bits = []
            if self.align_beacons:
                bits.append(f"{self.align_beacons} clock beacon(s) over "
                            f"{len(self.align_hosts)} host(s)")
            if len(waits) > 1:
                spread = max(waits.values()) - min(waits.values())
                if spread >= 0.02:
                    # the host that waited least entered the gate last —
                    # everyone else's wait is its exposed straggle
                    blk = min(sorted(waits), key=lambda h: waits[h])
                    bits.append(f"r{self.last_gate_round} blocked on "
                                f"host {blk} ({spread:.3f}s exposed)")
                else:
                    bits.append(f"r{self.last_gate_round} balanced")
            L.append("  fleet: " + "  ".join(bits))
        if self.sim is not None:
            s = self.sim
            bits = [f"{s.get('hosts')} hosts",
                    f"round {s.get('round')}",
                    f"live {s.get('live')}"]
            if _num(s.get("parked")) and s["parked"]:
                bits.append(f"parked {s['parked']}")
            if _num(s.get("wait_s")):
                bits.append(f"wait {s['wait_s']:.3f}s")
            tot = [f"{k} {s[k]}" for k in
                   ("evictions", "readmissions", "admissions")
                   if _num(s.get(k)) and s[k]]
            L.append("  sim: " + "  ".join(bits + tot))
        if self.serve_requests or self.serve_rejects or self.serve_summary:
            from .stepstats import percentiles
            bits = [f"requests {self.serve_requests}",
                    f"batches {self.serve_batches}"]
            if self.serve_rejects:
                bits.append(f"rejects {self.serve_rejects}")
            if self.serve_reloads:
                bits.append(f"reloads {self.serve_reloads}")
            if self.serve_lat_ms:
                p = percentiles(list(self.serve_lat_ms))
                bits.append(f"p50 {p['p50']:.1f}ms p99 {p['p99']:.1f}ms")
            if self.serve_batches:
                bits.append(
                    f"fill {self.serve_fill_sum / self.serve_batches:.0%}")
            L.append("  serving: " + "  ".join(bits))
            sb = self.last_serve_batch
            if sb is not None:
                L.append(f"    last batch: {sb.get('size')} rows -> "
                         f"bucket {sb.get('bucket')} "
                         f"({sb.get('infer_ms')} ms, "
                         f"depth {sb.get('queue_depth')})")
            if self.last_serve_reload is not None:
                r = self.last_serve_reload
                L.append(f"    hot reload: iter {r.get('iter')} "
                         f"(was {r.get('from_iter')}) in {r.get('ms')} ms")
            if self.last_serve_reject is not None:
                rj = self.last_serve_reject
                L.append(f"    last reject: {rj.get('reason')} "
                         f"(depth {rj.get('queue_depth')}/"
                         f"{rj.get('limit')})")
            if self.serve_summary is not None and \
                    self.serve_summary.get("drained"):
                L.append("    drained cleanly")
        if self.route_dispatches or self.scale_events or self.last_canary:
            from .stepstats import percentiles
            ok = self.route_by_code.get(200, 0)
            bits = [f"dispatches {self.route_dispatches}"]
            if self.route_dispatches:
                bits.append(f"avail {ok / self.route_dispatches:.1%}")
            if self.route_retried:
                bits.append(f"retried {self.route_retried}")
            bad = {c: n for c, n in sorted(self.route_by_code.items())
                   if c != 200}
            if bad:
                bits.append("codes " + " ".join(
                    f"{c}:{n}" for c, n in bad.items()))
            if self.route_lat_ms:
                p = percentiles(list(self.route_lat_ms))
                bits.append(f"p99 {p['p99']:.1f}ms")
            L.append("  routing: " + "  ".join(bits))
            if self.scale_events:
                a, reason, live = self.scale_events[-1]
                L.append(f"    scale: {len(self.scale_events)} "
                         f"decision(s); last {a} ({reason}) "
                         f"at live {live}")
            if self.last_canary is not None:
                c = self.last_canary
                line = f"    canary: {c.get('action')} " \
                       f"sha={c.get('sha')} " \
                       f"(baseline {c.get('baseline_sha')})"
                if self.canary_rollbacks:
                    line += f"  rollbacks {self.canary_rollbacks}"
                L.append(line)
        if self.trace_count:
            from .stepstats import percentiles
            bits = [f"traces {self.trace_count}",
                    f"tails {self.trace_tails}"]
            if self.trace_total_ms:
                p = percentiles(list(self.trace_total_ms))
                bits.append(f"total p99 {p['p99']:.1f}ms")
            stage_p99 = {k: percentiles(list(dq))["p99"]
                         for k, dq in self.trace_stage_ms.items() if dq}
            if stage_p99:
                top = max(stage_p99.items(), key=lambda kv: kv[1])
                bits.append(f"top stage {top[0]} ({top[1]:.1f}ms)")
            L.append("  tracing: " + "  ".join(bits))
            if stage_p99:
                L.append("    stage p99: " + "  ".join(
                    f"{k} {v:.1f}ms"
                    for k, v in sorted(stage_p99.items(),
                                       key=lambda kv: -kv[1])))
        if self.last_burn is not None:
            b = self.last_burn
            bits = [f"fast x{b.get('fast')}/{b.get('fast_long')}",
                    f"slow x{b.get('slow')}/{b.get('slow_long')}"]
            if _num(b.get("budget_left")):
                bits.append(f"budget left {b['budget_left']:.1%}")
            if b.get("alert"):
                bits.append(f"ALERT {b['alert']}")
            if self.burn_alerts:
                bits.append("alerts " + " ".join(
                    f"{k}:{n}" for k, n in sorted(
                        self.burn_alerts.items())))
            L.append("  slo burn: " + "  ".join(bits))
        if self.straggler_counts:
            worst = self.straggler_counts.most_common(1)[0]
            L.append(f"  stragglers: worker {worst[0]} flagged "
                     f"{worst[1]}x" + (
                         "  (others: " + ", ".join(
                             f"w{w}:{c}" for w, c in
                             self.straggler_counts.most_common()[1:]) + ")"
                         if len(self.straggler_counts) > 1 else ""))
        m = self.memstats
        if m:
            bits = []
            if _num(m.get("live_bytes")):
                bits.append(f"live {_fmt_bytes(m['live_bytes'])} "
                            f"({m.get('live_arrays', '?')} arrays)")
            if _num(m.get("hbm_peak_bytes_in_use")):
                bits.append(
                    f"hbm peak {_fmt_bytes(m['hbm_peak_bytes_in_use'])}")
            if _num(m.get("compile_cache")):
                bits.append(f"compile cache {m['compile_cache']}")
            if _num(m.get("host_rss_bytes")):
                bits.append(f"rss {_fmt_bytes(m['host_rss_bytes'])}")
            if bits:
                L.append("  memory: " + "  ".join(bits))
        if self.comms and _num(self.comms.get("collective_bytes_per_step")):
            L.append("  comms: "
                     f"{_fmt_bytes(self.comms['collective_bytes_per_step'])}"
                     "/step collective, h2d total "
                     f"{_fmt_bytes(self.comms.get('h2d_bytes_total'))}")
        if self.prefetch or self.h2d_stage or self.ingest_hosts:
            bits = []
            pf = self.prefetch or {}
            if pf.get("name"):
                bits.append(f"{pf['name']}")
            if _num(pf.get("echo")) and pf["echo"] > 1:
                bits.append(f"echo x{pf['echo']}")
            if pf.get("wire") and pf.get("wire") != "raw":
                bits.append(f"wire {pf['wire']}")
            if _num(pf.get("h2d_kb_per_image")):
                bits.append(f"{pf['h2d_kb_per_image']} KB/img")
            st = self.h2d_stage
            if st:
                bits.append(f"staged {st.get('puts', 0)} "
                            f"({st.get('kb_per_item', '?')} KB/item, "
                            f"wait {st.get('wait_ms', '?')} ms, "
                            f"{st.get('in_flight', '?')}/"
                            f"{st.get('slots', '?')} in flight)")
            if self.ingest_hosts:
                bits.append(f"ingest {len(self.ingest_hosts)} host(s)"
                            + (f", {self.ingest_respreads} re-spread(s)"
                               if self.ingest_respreads else ""))
            if bits:
                L.append("  feed: " + "  ".join(bits))
            for h, e in sorted(self.ingest_hosts.items()):
                rng = (f" [{e['lo']}..{e['hi']}]"
                       if _num(e.get("lo")) and e["lo"] >= 0 else "")
                L.append(f"    ingest host {h}: {e.get('records')} "
                         f"record(s){rng}, {e.get('reads', 0)} read(s)")
        extras = []
        if self.recoveries:
            extras.append(f"recoveries {self.recoveries}")
        if self.chaos:
            extras.append(f"chaos injections {self.chaos}")
        if self.checkpoint_iter is not None:
            extras.append(f"last checkpoint iter {self.checkpoint_iter}")
        if self.reshard is not None:
            extras.append(
                f"resharded ({self.reshard.get('direction')}) "
                f"{self.reshard.get('n_from')} -> "
                f"{self.reshard.get('n_to')} slots")
        if extras:
            L.append("  " + "  ".join(extras))
        if self.alarms:
            L.append("  alarms: " + ", ".join(
                f"{k}: {v}" for k, v in sorted(self.alarms.items())))
        a = self.last_alarm
        if a:
            detail = " ".join(f"{k}={v}" for k, v in a.items()
                              if k not in ("event", "t", "kind", "severity"))
            L.append(f"  last alarm: [{a.get('kind')}] {detail}")
        elif self.by_type.get("health") == 0 or not self.alarms:
            L.append("  no health alarms")
        return "\n".join(L)


class _Tail:
    """Incremental JSONL reader: returns complete new lines per poll,
    buffers a partial trailing line, survives truncation by reopening."""

    def __init__(self, path):
        self.path = path
        self.pos = 0
        self.buf = ""

    def poll(self):
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self.pos:            # truncated/rotated: start over
            self.pos, self.buf = 0, ""
        if size == self.pos:
            return []
        with open(self.path, "r", errors="replace") as f:
            f.seek(self.pos)
            chunk = f.read()
            self.pos = f.tell()
        self.buf += chunk
        lines = self.buf.split("\n")
        self.buf = lines.pop()         # '' after a complete final line
        return lines


def monitor_file(path, interval=1.0, once=False, wait=False,
                 duration=None, out=None, clear=None):
    """Tail ``path`` and render the live summary every ``interval``
    seconds. once=True renders the current state and returns. wait=True
    blocks for the file to appear (a run that hasn't started writing
    yet) instead of erroring. Returns the final MonitorState."""
    write = out or (lambda s: print(s, flush=True))
    t0 = time.time()
    while not os.path.exists(path):
        if not wait:
            raise MetricsFileError(f"metrics file not found: {path}")
        if duration is not None and time.time() - t0 > duration:
            raise MetricsFileError(
                f"metrics file never appeared: {path}")
        time.sleep(min(interval, 0.5))
    tail = _Tail(path)
    state = MonitorState()
    if clear is None:
        clear = sys.stdout.isatty()

    def ingest():
        got = False
        for line in tail.poll():
            line = line.strip()
            if not line:
                continue
            got = True
            try:
                ev = json.loads(line)
            except ValueError:
                state.note_bad_line()
                continue
            if isinstance(ev, dict):
                state.update(ev)
            else:
                state.note_bad_line()
        return got

    ingest()
    if once:
        if state.events == 0 and state.bad_lines == 0:
            raise MetricsFileError(f"metrics file is empty: {path}")
        write(state.render(path))
        return state
    # live view: a background tailer thread ingests continuously (the
    # _Tail cursor is confined to it between start and join), so a slow
    # terminal write or a long --interval never backs the cursor up;
    # MonitorState's lock makes the concurrent update/render safe
    stop = threading.Event()
    pump_err = []

    def pump():
        while not stop.wait(min(interval, 0.5)):
            try:
                ingest()
            except Exception as e:      # surfaced on the render side
                pump_err.append(e)
                return

    tailer = threading.Thread(target=pump, daemon=True,
                              name="sparknet-monitor-tail")
    tailer.start()
    try:
        while True:
            write(("\x1b[2J\x1b[H" if clear else "")
                  + state.render(path) + ("" if clear else "\n"))
            if pump_err:
                raise pump_err[0]
            if duration is not None and time.time() - t0 >= duration:
                break
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        tailer.join(timeout=2.0)
    if not pump_err:
        ingest()                        # final drain (tailer has quit)
    return state
