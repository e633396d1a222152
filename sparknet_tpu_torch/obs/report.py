"""A copy of sparknet_tpu/obs/report.py: the port's ``report`` verb. `sparknet report` — aggregate a metrics JSONL into a run report.

Input: the JSONL a run writes via --metrics (spans, steps, comms,
recompiles, train/test curve, watchdog, prefetch, bench rows — see the
obs package docstring). Output: a human-readable per-phase breakdown on
stdout and, with --json, a machine-readable report suitable for
BENCH_*.json-style comparison across runs.

Aggregation is pure dict-munging over parsed lines — no jax, no solver
imports — so the report verb works on any machine, including ones
without an accelerator stack.
"""

import collections
import json

from .stepstats import percentiles


class MetricsFileError(RuntimeError):
    """A metrics JSONL that can't be reported on (missing/unreadable/
    empty) — the CLI turns this into a one-line error, not a traceback."""


def load_events(path):
    """Parse a JSONL file -> (events, malformed_line_count). Bad lines
    (truncated writes, garbage) are skipped and counted, never fatal.
    Raises MetricsFileError when the file itself can't be read."""
    events, bad = [], 0
    try:
        f = open(path, errors="replace")
    except OSError as e:
        raise MetricsFileError(
            f"cannot read metrics file {path}: {e.strerror or e}")
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                bad += 1
                continue
            if isinstance(ev, dict):
                events.append(ev)
            else:
                bad += 1
    return events, bad


def _num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def aggregate(events):
    """Events -> report dict (all keys optional except counts)."""
    by_type = collections.Counter(e.get("event", "?") for e in events)
    rep = {"num_events": len(events), "events_by_type": dict(by_type)}

    # -- spans: per-name rollup + top-level phase breakdown ----------------
    spans = [e for e in events if e.get("event") == "span"]
    if spans:
        names = collections.defaultdict(lambda: {"count": 0, "total_ms": 0.0,
                                                 "max_ms": 0.0})
        for s in spans:
            d = float(s.get("dur_ms") or 0.0)
            r = names[s.get("name", "?")]
            r["count"] += 1
            r["total_ms"] += d
            r["max_ms"] = max(r["max_ms"], d)
        for r in names.values():
            r["total_ms"] = round(r["total_ms"], 3)
            r["mean_ms"] = round(r["total_ms"] / r["count"], 3)
            r["max_ms"] = round(r["max_ms"], 3)
        rep["spans"] = dict(names)
        top = [s for s in spans if not s.get("depth")]
        total_top = sum(float(s.get("dur_ms") or 0.0) for s in top) or 1.0
        phases = collections.defaultdict(float)
        for s in top:
            phases[s.get("name", "?")] += float(s.get("dur_ms") or 0.0)
        rep["phases"] = [
            {"phase": k, "total_ms": round(v, 3),
             "pct": round(100.0 * v / total_top, 1)}
            for k, v in sorted(phases.items(), key=lambda kv: -kv[1])]

    # -- steps: prefer the flushed full-histogram summary ------------------
    summaries = [e for e in events if e.get("event") == "step_summary"]
    steps = [e for e in events if e.get("event") == "step"]
    if summaries:
        s = dict(summaries[-1])
        s.pop("event", None)
        s.pop("t", None)
        rep["steps"] = s
    elif steps:
        host = [e["host_ms"] for e in steps if _num(e.get("host_ms"))]
        dev = [e["device_ms"] for e in steps if _num(e.get("device_ms"))]
        st = {"sampled_steps": len(steps)}
        st.update({f"host_ms_{k}": round(v, 3)
                   for k, v in percentiles(host).items()})
        st.update({f"device_ms_{k}": round(v, 3)
                   for k, v in percentiles(dev).items()})
        rep["steps"] = st

    recompiles = [e for e in events if e.get("event") == "recompile"]
    if recompiles:
        rep["recompiles"] = {
            "count": sum(1 for e in recompiles if not e.get("first")),
            "first_compile_iters": [e.get("iter") for e in recompiles
                                    if e.get("first")],
            "unexpected": [{"iter": e.get("iter"),
                            "reason": e.get("reason")}
                           for e in recompiles if not e.get("first")][:50]}

    # -- comms -------------------------------------------------------------
    comms = [e for e in events if e.get("event") == "comms"]
    if comms:
        last = comms[-1]
        c = {"h2d_bytes_total": last.get("h2d_bytes_total"),
             "collective_bytes_per_step":
                 last.get("collective_bytes_per_step"),
             "collectives": last.get("collectives", [])}
        for k in ("strategy", "n_devices", "axes", "param_bytes",
                  "overlapped_bytes_per_step", "exposed_bytes_per_step",
                  "overlap_ceiling"):
            if k in last:
                c[k] = last[k]
        rep["comms"] = c

    # -- training curve ----------------------------------------------------
    train = [e for e in events if e.get("event") == "train"
             and _num(e.get("loss"))]
    if train:
        losses = [e["loss"] for e in train]
        t = {"points": len(train),
             "first_loss": round(losses[0], 6),
             "final_loss": round(losses[-1], 6),
             "min_loss": round(min(losses), 6)}
        its = [e.get("iter") for e in train if _num(e.get("iter"))]
        if its:
            t["first_iter"], t["last_iter"] = its[0], its[-1]
        for rate in ("images_per_sec", "tokens_per_sec", "images_per_s"):
            vals = [e[rate] for e in train if _num(e.get(rate))]
            if vals:
                t[rate] = {"mean": round(sum(vals) / len(vals), 1),
                           "last": round(vals[-1], 1)}
        rep["train"] = t
    tests = [e for e in events if e.get("event") == "test"]
    if tests:
        last = tests[-1]
        rep["test"] = {k: v for k, v in last.items()
                       if k not in ("event", "t", "run")}
    summary = [e for e in events if e.get("event") == "summary"]
    if summary:
        rep["summary"] = {k: v for k, v in summary[-1].items()
                          if k not in ("event", "t", "run")}

    # -- resilience (sparknet_tpu.resilience) ------------------------------
    rec = [e for e in events if e.get("event") == "recovery"]
    if rec:
        rep["recovery"] = {
            "kinds": dict(collections.Counter(e.get("kind", "?")
                                              for e in rec)),
            "rollback_iters": [e.get("to_iter") for e in rec
                               if e.get("kind") == "rollback"][:20],
            "last_reason": rec[-1].get("reason")}
    ch = [e for e in events if e.get("event") == "chaos"]
    if ch:
        rep["chaos"] = dict(collections.Counter(e.get("kind", "?")
                                                for e in ch))
    rt = [e for e in events if e.get("event") == "retry"]
    if rt:
        rep["retries"] = {
            "count": len(rt),
            "exhausted": sum(1 for e in rt if e.get("exhausted")),
            "by_where": dict(collections.Counter(
                str(e.get("where", "?")) for e in rt))}
    # elastic membership (resilience/elastic.py)
    ev = [e for e in events if e.get("event") == "eviction"]
    rd = [e for e in events if e.get("event") == "readmission"]
    mem = [e for e in events if e.get("event") == "membership"]
    adm = [e for e in mem if e.get("kind") == "admission"]
    if ev or rd or mem:
        el = {"evictions": len(ev), "readmissions": len(rd)}
        if adm:
            el["admissions"] = len(adm)
            el["admission_records"] = [
                {"worker": e.get("worker"), "round": e.get("round"),
                 "via": e.get("via"),
                 "unit": e.get("unit", "worker")} for e in adm][:20]
        if ev:
            el["evictions_by_worker"] = {
                str(k): v for k, v in collections.Counter(
                    e.get("worker") for e in ev).items()}
            el["eviction_records"] = [
                {"worker": e.get("worker"), "round": e.get("round"),
                 "reason": e.get("reason"),
                 "unit": e.get("unit", "worker")} for e in ev][:20]
        lives = [e["live"] for e in (ev + rd + mem)
                 if _num(e.get("live"))]
        if lives:
            el["last_live"] = lives[-1]
            el["min_live"] = min(lives)
        if any(e.get("kind") == "quorum_lost" for e in mem):
            ql = next(e for e in mem if e.get("kind") == "quorum_lost")
            el["quorum_lost"] = {k: ql.get(k) for k in
                                 ("round", "live", "quorum")}
        if any(e.get("kind") == "mesh_shrunk" for e in mem):
            ms = [e for e in mem if e.get("kind") == "mesh_shrunk"][-1]
            el["mesh_shrunk"] = {"from": ms.get("from_world"),
                                 "to": ms.get("to_world")}
        rep["elasticity"] = el
    # multi-host fault domains (resilience/heartbeat.py): per-host
    # liveness transitions, lease ages, and the cross-host round gate
    ha = [e for e in events if e.get("event") == "host_alive"]
    hr = [e for e in events if e.get("event") == "host_round"]
    he = [e for e in events if e.get("event") == "host_evicted"]
    hj = [e for e in events if e.get("event") == "host_joined"]
    cr = [e for e in mem if e.get("kind") == "coordinated_restart"]
    if ha or hr or he or hj or cr:
        mh = {}
        if ha:
            last = {}
            for e in ha:
                if e.get("host") is not None:
                    last[int(e["host"])] = bool(e.get("alive"))
            mh["liveness_transitions"] = len(ha)
            mh["hosts_seen"] = sorted(last)
            mh["hosts_down"] = sorted(h for h, a in last.items() if not a)
            ages = [e["lease_age_s"] for e in ha
                    if _num(e.get("lease_age_s"))]
            if ages:
                mh["max_lease_age_s"] = round(max(ages), 3)
        if hr:
            waits = [e["wait_s"] for e in hr if _num(e.get("wait_s"))]
            g = {"rounds_gated": len(hr)}
            g.update({f"wait_s_{k}": round(v, 4)
                      for k, v in percentiles(waits).items()})
            lastages = hr[-1].get("lease_age_s")
            if isinstance(lastages, list):
                g["last_lease_age_s"] = lastages
            mh["round_gate"] = g
        if he:
            mh["host_evictions"] = [
                {"host": e.get("host"), "round": e.get("round"),
                 "reason": e.get("reason")} for e in he][:20]
        if hj:
            mh["host_joins"] = [
                {"host": e.get("host"), "round": e.get("round"),
                 "via": e.get("via"), "world": e.get("world")}
                for e in hj][:20]
        if cr:
            last = cr[-1]
            mh["coordinated_restart"] = {
                "agreed": last.get("agreed"),
                "sha": (str(last.get("sha"))[:12] + "…")
                if last.get("sha") else None,
                "hosts": last.get("hosts")}
        rep["multihost"] = mh
    # fleet simulation (sparknet_tpu/sim): the per-round closed summary
    # a simulated fleet emits beside the standard host_* stream — fleet
    # size, the live-count trajectory, and the gate-wait tail the
    # lease/quorum sweeps tune against
    sm = [e for e in events if e.get("event") == "sim"]
    if sm:
        waits = [e["wait_s"] for e in sm if _num(e.get("wait_s"))]
        lives = [e["live"] for e in sm if _num(e.get("live"))]
        fl = {"rounds": len(sm), "hosts": sm[-1].get("hosts"),
              "sim_s": sm[-1].get("t_s"),
              "live_final": lives[-1] if lives else None,
              "live_min": min(lives) if lives else None,
              "evictions": sm[-1].get("evictions"),
              "readmissions": sm[-1].get("readmissions"),
              "admissions": sm[-1].get("admissions"),
              "parked_max": max((e.get("parked") or 0) for e in sm)}
        fl.update({f"wait_s_{k}": round(v, 4)
                   for k, v in percentiles(waits).items()})
        rep["simulation"] = fl
    # fleet timeline (obs/fleettrace + obs/critpath): clock-beacon
    # alignment plus per-round critical-path attribution whenever the
    # stream carries mono-stamped events (trace_align beacons or
    # mono-bearing host_round gate exits)
    ta = [e for e in events if e.get("event") == "trace_align"]
    if ta or any(_num(e.get("mono")) for e in hr):
        from . import critpath as _critpath
        from . import fleettrace as _fleettrace
        ft = _fleettrace.merge_streams([events])
        fleet = _fleettrace.align_summary(ft)
        fleet["critpath"] = _critpath.compute(ft)["summary"]
        rep["fleet"] = fleet
    # bounded staleness (the async local-SGD mode): per-worker version
    # lag / park-time accounting + drift attribution
    st = [e for e in events if e.get("event") == "staleness"]
    pk = [e for e in events if e.get("event") == "parked"]
    up = [e for e in events if e.get("event") == "unparked"]
    if st or pk or up:
        sa = {"parks": len(pk), "unparks": len(up)}
        if pk:
            sa["parks_by_worker"] = {
                str(k): v for k, v in collections.Counter(
                    e.get("worker") for e in pk).items()}
        if up:
            sa["park_rounds_total"] = sum(
                e.get("parked_rounds") or 0 for e in up)
        if st:
            last = st[-1]
            if last.get("s") is not None:
                sa["s"] = last["s"]
            if isinstance(last.get("lag"), list):
                sa["last_lag"] = last["lag"]
            if isinstance(last.get("version"), list):
                sa["last_version"] = last["version"]
            if isinstance(last.get("park_rounds"), list):
                sa["park_rounds_by_worker"] = {
                    str(w): r for w, r in enumerate(last["park_rounds"])
                    if r}
            lags = [max(e["lag"]) for e in st
                    if isinstance(e.get("lag"), list) and e["lag"]]
            if lags:
                sa["max_lag"] = max(lags)
        div = [e for e in events if e.get("event") == "divergence"
               and e.get("drift_cause")]
        if div:
            sa["drift_cause"] = dict(collections.Counter(
                e["drift_cause"] for e in div))
            fracs = [e["drift_stale_frac"] for e in div
                     if _num(e.get("drift_stale_frac"))]
            if fracs:
                sa["drift_stale_frac_last"] = fracs[-1]
        rep["staleness"] = sa
    cp = [e for e in events if e.get("event") == "checkpoint"]
    if cp:
        writes = [e for e in cp if e.get("kind") != "resume"]
        resumes = [e for e in cp if e.get("kind") == "resume"]
        c = {"count": len(writes)}
        if writes:
            c["last_iter"] = writes[-1].get("iter")
            c["last_bytes"] = writes[-1].get("bytes")
        if resumes:
            c["resumed_from_iter"] = resumes[-1].get("iter")
            c["resume_refused"] = resumes[-1].get("refused")
        rep["checkpoints"] = c
    rs = [e for e in events if e.get("event") == "reshard"]
    if rs:
        last = rs[-1]
        rep.setdefault("checkpoints", {})["reshard"] = {
            "count": len(rs),
            "from_world": last.get("from_world"),
            "to_world": last.get("to_world"),
            "direction": last.get("direction"),
            "iter": last.get("iter")}

    # -- training health (obs divergence/health/memstats) ------------------
    div = [e for e in events if e.get("event") == "divergence"]
    if div:
        means = [e["mean"] for e in div if _num(e.get("mean"))]
        d = {"samples": len(div)}
        if means:
            d.update(first_mean=means[0], last_mean=means[-1],
                     peak_mean=max(means))
            if means[0] > 0:
                d["trend"] = round(means[-1] / means[0], 3)
        maxes = [e["max"] for e in div if _num(e.get("max"))]
        if maxes:
            d["peak_worker"] = max(maxes)
        last = div[-1]
        for k in ("kind", "tau", "rel", "gns_proxy", "update_norm",
                  "top_layers"):
            if last.get(k) is not None:
                d[k] = last[k]
        # the per-round curve itself (capped): iter -> mean divergence
        pts = [(e.get("round", e.get("iter")), e.get("mean"))
               for e in div if _num(e.get("mean"))]
        d["per_round"] = [[r, m] for r, m in pts[-50:]]
        rep["divergence"] = d
    hl = [e for e in events if e.get("event") == "health"]
    if hl:
        h = {"alarms": len(hl),
             "by_kind": dict(collections.Counter(
                 e.get("kind", "?") for e in hl))}
        stragglers = collections.Counter(
            e.get("worker") for e in hl
            if e.get("kind") == "straggler" and e.get("worker") is not None)
        if stragglers:
            h["stragglers_by_worker"] = {str(k): v
                                         for k, v in stragglers.items()}
            h["worst_straggler"] = stragglers.most_common(1)[0][0]
        last = hl[-1]
        h["last_alarm"] = {k: v for k, v in last.items()
                           if k not in ("event", "t", "run")}
        taus = [e["suggest_tau"] for e in hl if _num(e.get("suggest_tau"))]
        if taus:
            h["suggest_tau"] = taus[-1]
        esses = [e["suggest_s"] for e in hl if _num(e.get("suggest_s"))]
        if esses:
            h["suggest_s"] = esses[-1]
        rep["health"] = h
    mem = [e for e in events if e.get("event") == "memstats"]
    if mem:
        m = {"samples": len(mem)}
        live = [e["live_bytes"] for e in mem if _num(e.get("live_bytes"))]
        if live:
            m["live_bytes_last"] = live[-1]
            m["live_bytes_peak"] = max(live)
        caches = [e["compile_cache"] for e in mem
                  if _num(e.get("compile_cache"))]
        if caches:
            m["compile_cache_last"] = caches[-1]
        rss = [e["host_rss_bytes"] for e in mem
               if _num(e.get("host_rss_bytes"))]
        if rss:
            m["host_rss_peak"] = max(rss)
        hbm_keys = [e["hbm_peak_bytes_in_use"] for e in mem
                    if _num(e.get("hbm_peak_bytes_in_use"))]
        if hbm_keys:
            m["hbm_peak_bytes_in_use"] = max(hbm_keys)
        rep["memstats"] = m
    dc = [e for e in events if e.get("event") == "device_cache"]
    if dc:
        last = dc[-1]
        rep["device_cache"] = {k: v for k, v in last.items()
                               if k not in ("event", "t", "run")}

    # -- auxiliary streams -------------------------------------------------
    wd = [e for e in events if e.get("event") == "watchdog"]
    if wd:
        rep["watchdog"] = dict(collections.Counter(
            e.get("kind", "?") for e in wd))
    pf = [e for e in events if e.get("event") == "prefetch"]
    if pf:
        last = pf[-1]
        rep["prefetch"] = {k: v for k, v in last.items()
                           if k not in ("event", "t", "run")}
    ing = [e for e in events if e.get("event") == "ingest"]
    h2d = [e for e in events if e.get("event") == "h2d_stage"]
    if ing or h2d:
        ip = {}
        if ing:
            hosts = {}
            for e in ing:
                hosts[e.get("host", "?")] = {
                    k: e.get(k) for k in
                    ("hosts", "partitions", "records", "lo", "hi", "reads")}
            ip["ingest"] = {
                "hosts": hosts,
                "respreads": sum(1 for e in ing
                                 if e.get("kind") == "respread"),
            }
        if h2d:
            last = h2d[-1]
            ip["h2d_stage"] = {k: v for k, v in last.items()
                               if k not in ("event", "t", "run")}
        rep["input_pipeline"] = ip
    hbm = [e for e in events if e.get("event") == "hbm"]
    if hbm:
        peaks = [e.get("peak_bytes_in_use") or e.get("bytes_in_use") or 0
                 for e in hbm]
        rep["hbm"] = {"samples": len(hbm),
                      "peak_bytes_in_use": max(peaks)}
    bench = [e for e in events if e.get("event") == "bench"]
    if bench:
        rep["bench"] = [{k: v for k, v in e.items()
                         if k not in ("event", "t", "run")} for e in bench]

    # -- serving (sparknet_tpu.serve) --------------------------------------
    sreq = [e for e in events if e.get("event") == "serve_request"]
    sbat = [e for e in events if e.get("event") == "serve_batch"]
    srej = [e for e in events if e.get("event") == "serve_reject"]
    srel = [e for e in events if e.get("event") == "serve_reload"]
    ssum = [e for e in events if e.get("event") == "serve_summary"]
    if sreq or sbat or srej or srel or ssum:
        sv = {"requests": len(sreq), "batches": len(sbat),
              "rejects": len(srej), "reloads": len(srel)}
        lats = [e["latency_ms"] for e in sreq if _num(e.get("latency_ms"))]
        if lats:
            sv.update({f"latency_ms_{k}": round(v, 3)
                       for k, v in percentiles(lats).items()})
        waits = [e["wait_ms"] for e in sreq if _num(e.get("wait_ms"))]
        if waits:
            sv["queue_wait_ms_p99"] = round(percentiles(waits)["p99"], 3)
        fills = [e["fill"] for e in sbat if _num(e.get("fill"))]
        if fills:
            sv["batch_fill_mean"] = round(sum(fills) / len(fills), 4)
        depths = [e["queue_depth"] for e in sbat
                  if _num(e.get("queue_depth"))]
        if depths:
            sv["queue_depth_max"] = max(depths)
        if sbat:
            sv["buckets_used"] = sorted(
                {e.get("bucket") for e in sbat if _num(e.get("bucket"))})
        if srej:
            sv["rejects_by_reason"] = dict(collections.Counter(
                str(e.get("reason", "?")) for e in srej))
        if srel:
            sv["reload_iters"] = [e.get("iter") for e in srel][-10:]
        if ssum:
            # the drain-time flush aggregates the WHOLE run (the
            # per-request stream caps its ring); prefer its totals
            last = ssum[-1]
            for k in ("requests", "rows", "rps", "batch_fill",
                      "uptime_s", "drained", "latency_ms_p50",
                      "latency_ms_p95", "latency_ms_p99"):
                if last.get(k) is not None:
                    sv[k] = last[k]
        rep["serving"] = sv

    # -- routing fleet (serve/fleet.py: `sparknet route`) ------------------
    rt = [e for e in events if e.get("event") == "route"]
    sc = [e for e in events if e.get("event") == "scale"]
    cn = [e for e in events if e.get("event") == "canary"]
    if rt or sc or cn:
        fl = {"dispatches": len(rt)}
        if rt:
            codes = collections.Counter(
                int(e["code"]) for e in rt if _num(e.get("code")))
            fl["by_code"] = {str(k): v for k, v in sorted(codes.items())}
            fl["availability"] = round(codes.get(200, 0) / len(rt), 4)
            fl["retried"] = sum(1 for e in rt if e.get("retried"))
            lats = [e["latency_ms"] for e in rt
                    if _num(e.get("latency_ms"))]
            if lats:
                fl.update({f"latency_ms_{k}": round(v, 3)
                           for k, v in percentiles(lats).items()})
            fl["by_replica"] = dict(collections.Counter(
                str(e.get("replica")) for e in rt
                if e.get("replica") is not None))
        if sc:
            fl["scale_events"] = [
                {k: e.get(k) for k in ("action", "reason", "live",
                                       "p99_ms", "queue_depth")}
                for e in sc]
        if cn:
            fl["canary_events"] = [
                {k: e.get(k) for k in ("action", "sha", "baseline_sha",
                                       "reason", "err_rate",
                                       "base_err_rate", "requests")}
                for e in cn]
            fl["canary_rollbacks"] = sum(
                1 for e in cn if e.get("action") == "rollback")
        rep["routing"] = fl

    # -- request tracing (obs/tracing.py: serve_trace) ---------------------
    trc = [e for e in events if e.get("event") == "serve_trace"]
    if trc:
        # prefer the router's view (it closes the loop with net time);
        # replica-only streams still decompose their own stages
        rows = [e for e in trc if e.get("src") == "router"] or trc
        tr = {"traces": len(trc),
              "tails": sum(1 for e in trc if e.get("tail")),
              "retried": sum(1 for e in rows if e.get("retried"))}
        stage_keys = ("net", "queue", "batch", "infer", "fulfill")
        stages = {}
        for k in stage_keys:
            vals = [e[f"{k}_ms"] for e in rows
                    if _num(e.get(f"{k}_ms"))]
            if vals:
                stages[k] = {q: round(v, 3)
                             for q, v in percentiles(vals).items()}
        if stages:
            tr["stages"] = stages
        totals = [e["total_ms"] for e in rows
                  if _num(e.get("total_ms"))]
        if totals:
            tr["p99_total_ms"] = round(percentiles(totals)["p99"], 3)
            # "where did the p99 go": per-stage MEANS over the tail
            # cohort (total >= p99 threshold). Means over one cohort
            # sum to the cohort's mean total — unlike per-stage p99s,
            # which need not sum to anything — so the attribution is
            # checkable: sum(stages) ≈ cohort total
            thresh = percentiles(totals)["p99"]
            cohort = [e for e in rows if _num(e.get("total_ms"))
                      and e["total_ms"] >= thresh]
            attr = {}
            for k in stage_keys:
                vals = [e[f"{k}_ms"] for e in cohort
                        if _num(e.get(f"{k}_ms"))]
                if vals:
                    attr[k] = round(sum(vals) / len(vals), 3)
            if attr:
                tr["p99_attribution"] = attr
                tr["p99_cohort_ms"] = round(
                    sum(e["total_ms"] for e in cohort) / len(cohort), 3)
                tr["top_stage"] = max(attr.items(),
                                      key=lambda kv: kv[1])[0]
        rep["tracing"] = tr

    # -- SLO error budget (obs/tracing.py: slo_burn) -----------------------
    brn = [e for e in events if e.get("event") == "slo_burn"]
    if brn:
        alerts = collections.Counter(
            str(e.get("alert")) for e in brn if e.get("alert"))
        peak = max((e["fast"] for e in brn if _num(e.get("fast"))),
                   default=None)
        last = brn[-1]
        rep["slo_burn"] = {
            "evaluations": len(brn),
            "alerts": dict(alerts),
            "peak_fast_burn": None if peak is None else round(peak, 3),
            "last": {k: last.get(k) for k in
                     ("alert", "fast", "fast_long", "slow",
                      "slow_long", "budget_left", "good", "bad")}}
    return rep


def _fmt_bytes(n):
    if not _num(n):
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return "?"


def render(rep):
    """Report dict -> human-readable text."""
    L = []

    def hdr(s):
        L.append("")
        L.append(s)
        L.append("-" * len(s))

    L.append(f"run report: {rep.get('num_events', 0)} events "
             f"({', '.join(f'{k}:{v}' for k, v in sorted(rep.get('events_by_type', {}).items()))})")
    if rep.get("malformed_lines"):
        L.append(f"WARNING: {rep['malformed_lines']} malformed JSONL lines "
                 "skipped")

    if rep.get("phases"):
        hdr("per-phase time breakdown (top-level spans)")
        for p in rep["phases"]:
            L.append(f"  {p['phase']:<24} {p['total_ms']:>12.1f} ms "
                     f"{p['pct']:>5.1f}%")

    st = rep.get("steps")
    if st:
        hdr("step times")
        L.append(f"  steps observed: {st.get('steps', st.get('sampled_steps', '?'))}")
        for kind in ("host", "device"):
            ps = {q: st.get(f"{kind}_ms_{q}") for q in ("p50", "p95", "p99")}
            if any(_num(v) for v in ps.values()):
                L.append(f"  {kind + ' ms':<10} " + "  ".join(
                    f"{q}={ps[q]:.3f}" for q in ("p50", "p95", "p99")
                    if _num(ps[q])))
        if _num(st.get("recompiles")):
            L.append(f"  recompiles (beyond first): {st['recompiles']}")
    rc = rep.get("recompiles")
    if rc:
        hdr("recompiles")
        L.append(f"  first compiles at iters: {rc.get('first_compile_iters')}")
        L.append(f"  unexpected recompiles: {rc.get('count', 0)}")
        for u in rc.get("unexpected", [])[:10]:
            L.append(f"    iter {u.get('iter')}: {u.get('reason')}")

    c = rep.get("comms")
    if c:
        hdr("communication")
        if c.get("strategy"):
            line = f"  strategy: {c['strategy']} over " \
                   f"{c.get('n_devices', '?')} device(s)"
            if c.get("axes"):
                line += f", mesh axes {c['axes']}"
            L.append(line)
        L.append(f"  host->device feed total: "
                 f"{_fmt_bytes(c.get('h2d_bytes_total'))}")
        L.append(f"  collective volume/step (per chip): "
                 f"{_fmt_bytes(c.get('collective_bytes_per_step'))}")
        if _num(c.get("overlapped_bytes_per_step")):
            L.append(f"  overlappable with backward: "
                     f"{_fmt_bytes(c['overlapped_bytes_per_step'])}"
                     f" ({100 * c.get('overlap_ceiling', 0):.1f}% ceiling)"
                     f", exposed: "
                     f"{_fmt_bytes(c.get('exposed_bytes_per_step'))}")
        cols = c.get("collectives", [])
        buckets = [col for col in cols if col.get("bucket") is not None]
        for col in cols:
            if col.get("bucket") is not None:
                continue
            per = col.get("bytes_per_round", 0)
            tau = col.get("steps_per_round", 1)
            line = (f"    {col.get('kind'):<22} "
                    f"{_fmt_bytes(per)}/round, every {tau} step(s)")
            if col.get("paper_broadcast_collect_bytes"):
                line += (" (paper broadcast+collect: "
                         f"{_fmt_bytes(col['paper_broadcast_collect_bytes'])})")
            L.append(line)
        if buckets:
            tot = sum(col.get("bytes_per_round", 0) for col in buckets)
            nover = sum(1 for col in buckets if col.get("overlappable"))
            line = (f"    {buckets[0].get('kind'):<22} "
                    f"x{len(buckets)} buckets, {_fmt_bytes(tot)}/round "
                    f"total, {nover} overlappable + "
                    f"{len(buckets) - nover} exposed")
            paper = next((col["paper_broadcast_collect_bytes"]
                          for col in buckets
                          if col.get("paper_broadcast_collect_bytes")),
                         None)
            if paper:
                line += (" (paper broadcast+collect: "
                         f"{_fmt_bytes(paper)})")
            L.append(line)

    t = rep.get("train")
    if t:
        hdr("loss curve")
        L.append(f"  {t.get('points')} display points, iters "
                 f"{t.get('first_iter', '?')}..{t.get('last_iter', '?')}")
        L.append(f"  loss {t.get('first_loss')} -> {t.get('final_loss')} "
                 f"(min {t.get('min_loss')})")
        for rate in ("images_per_sec", "tokens_per_sec", "images_per_s"):
            if rate in t:
                L.append(f"  {rate}: mean {t[rate]['mean']} "
                         f"last {t[rate]['last']}")
    if rep.get("test"):
        hdr("last test scores")
        for k, v in sorted(rep["test"].items()):
            L.append(f"  {k} = {v}")
    if rep.get("summary"):
        hdr("run summary event")
        for k, v in sorted(rep["summary"].items()):
            L.append(f"  {k} = {v}")

    if any(rep.get(k) for k in ("recovery", "chaos", "retries",
                                "checkpoints", "elasticity")):
        hdr("resilience")
        cp = rep.get("checkpoints")
        if cp:
            line = f"  checkpoints: {cp.get('count', 0)}"
            if cp.get("last_iter") is not None:
                line += f" (last at iter {cp['last_iter']}, " \
                        f"{_fmt_bytes(cp.get('last_bytes'))})"
            L.append(line)
            if cp.get("resumed_from_iter") is not None:
                line = f"  resumed from iter {cp['resumed_from_iter']}"
                if cp.get("resume_refused"):
                    line += f" ({cp['resume_refused']} snapshot(s) refused)"
                L.append(line)
            if cp.get("reshard"):
                rsh = cp["reshard"]
                L.append(f"  resharded snapshot for this world "
                         f"({rsh.get('direction')}): "
                         f"{rsh.get('from_world')} -> "
                         f"{rsh.get('to_world')}")
        r = rep.get("recovery")
        if r:
            L.append("  recovery: " + ", ".join(
                f"{k}: {v}" for k, v in sorted(r["kinds"].items())))
            if r.get("rollback_iters"):
                L.append(f"    rolled back to iters {r['rollback_iters']}")
            if r.get("last_reason"):
                L.append(f"    last reason: {r['last_reason']}")
        if rep.get("chaos"):
            L.append("  chaos injected: " + ", ".join(
                f"{k}: {v}" for k, v in sorted(rep["chaos"].items())))
        rt = rep.get("retries")
        if rt:
            L.append(f"  io retries: {rt['count']} "
                     f"({rt['exhausted']} exhausted)")
        el = rep.get("elasticity")
        if el:
            line = f"  elastic membership: {el.get('evictions', 0)} " \
                   f"eviction(s), {el.get('readmissions', 0)} " \
                   "readmission(s)"
            if el.get("admissions"):
                line += f", {el['admissions']} admission(s)"
            if _num(el.get("min_live")):
                line += f", live dipped to {el['min_live']}"
            L.append(line)
            for r in el.get("eviction_records", [])[:10]:
                L.append(f"    evicted {r.get('unit', 'worker')} "
                         f"{r.get('worker')} at round "
                         f"{r.get('round')}: {r.get('reason')}")
            for r in el.get("admission_records", [])[:10]:
                L.append(f"    admitted {r.get('unit', 'worker')} "
                         f"{r.get('worker')} at round "
                         f"{r.get('round')} ({r.get('via')})")
            if el.get("mesh_shrunk"):
                L.append(f"    mesh shrunk {el['mesh_shrunk'].get('from')}"
                         f" -> {el['mesh_shrunk'].get('to')} workers")
            if el.get("quorum_lost"):
                q = el["quorum_lost"]
                L.append(f"    QUORUM LOST at round {q.get('round')}: "
                         f"{q.get('live')} live < quorum "
                         f"{q.get('quorum')} (exit 4)")
    sa = rep.get("staleness")
    if sa:
        hdr("async staleness (bounded-staleness local SGD)")
        line = f"  parks: {sa.get('parks', 0)}, unparks: " \
               f"{sa.get('unparks', 0)}"
        if _num(sa.get("s")):
            line += f", bound s={sa['s']}"
        if _num(sa.get("max_lag")):
            line += f", max lag seen {sa['max_lag']}"
        L.append(line)
        if sa.get("parks_by_worker"):
            L.append("  parks by worker: " + ", ".join(
                f"w{k}: {v}" for k, v in sorted(
                    sa["parks_by_worker"].items())))
        if _num(sa.get("park_rounds_total")):
            L.append(f"  total park time: {sa['park_rounds_total']} "
                     "round(s)")
        if sa.get("last_lag") is not None:
            L.append(f"  last version lag per worker: {sa['last_lag']}")
        if sa.get("drift_cause"):
            L.append("  drift attribution: " + ", ".join(
                f"{k}: {v}" for k, v in sorted(
                    sa["drift_cause"].items()))
                + (f" (last stale share "
                   f"{sa['drift_stale_frac_last']})"
                   if _num(sa.get("drift_stale_frac_last")) else ""))
    mh = rep.get("multihost")
    if mh:
        hdr("multi-host fault domains")
        if mh.get("hosts_seen") is not None:
            line = f"  hosts observed: {mh['hosts_seen']}"
            if mh.get("hosts_down"):
                line += f", DOWN: {mh['hosts_down']}"
            L.append(line)
        if _num(mh.get("max_lease_age_s")):
            L.append(f"  max lease age seen: {mh['max_lease_age_s']} s")
        g = mh.get("round_gate")
        if g:
            ps = {q: g.get(f"wait_s_{q}") for q in ("p50", "p95", "p99")}
            line = f"  round gate: {g.get('rounds_gated')} rounds"
            if any(_num(v) for v in ps.values()):
                line += ", wait " + "  ".join(
                    f"{q}={ps[q]:.3f}s" for q in ("p50", "p95", "p99")
                    if _num(ps[q]))
            L.append(line)
            if g.get("last_lease_age_s"):
                L.append(f"    last lease ages: {g['last_lease_age_s']}")
        for r in mh.get("host_evictions", [])[:10]:
            L.append(f"  evicted host {r.get('host')} at round "
                     f"{r.get('round')}: {r.get('reason')}")
        for r in mh.get("host_joins", [])[:10]:
            L.append(f"  joined host {r.get('host')} at round "
                     f"{r.get('round')} ({r.get('via')}, world -> "
                     f"{r.get('world')})")
        cr = mh.get("coordinated_restart")
        if cr:
            L.append(f"  coordinated restart: "
                     f"{'AGREED' if cr.get('agreed') else 'DISAGREED'} "
                     f"on manifest {cr.get('sha')} across hosts "
                     f"{cr.get('hosts')}")
    fl = rep.get("simulation")
    if fl:
        hdr("fleet simulation")
        L.append(f"  {fl.get('hosts')} virtual hosts x "
                 f"{fl.get('rounds')} rounds "
                 f"({fl.get('sim_s')} simulated s)")
        L.append(f"  live: min {fl.get('live_min')}, final "
                 f"{fl.get('live_final')}; "
                 f"{fl.get('evictions')} eviction(s), "
                 f"{fl.get('readmissions')} readmission(s), "
                 f"{fl.get('admissions')} admission(s), "
                 f"peak parked {fl.get('parked_max')}")
        ps = {q: fl.get(f"wait_s_{q}") for q in ("p50", "p95", "p99")}
        if any(_num(v) for v in ps.values()):
            L.append("  gate wait " + "  ".join(
                f"{q}={ps[q]:.3f}s" for q in ("p50", "p95", "p99")
                if _num(ps[q])))
    ftl = rep.get("fleet")
    if ftl:
        hdr("fleet timeline")
        L.append(f"  {len(ftl.get('hosts', []))} track(s), "
                 f"{ftl.get('beacons', 0)} clock beacon(s)")
        for h, o in sorted(ftl.get("offsets", {}).items()):
            if not o.get("aligned"):
                L.append(f"    host {h}: unaligned (no beacon path)")
                continue
            err = o.get("err_s")
            err_txt = "one-sided bound" if err is None \
                else f"±{err * 1e3:.1f} ms"
            L.append(f"    host {h}: offset "
                     f"{o.get('offset_s', 0.0) * 1e3:+.1f} ms "
                     f"({err_txt}, {o.get('samples', 0)} beacon(s))")
        cps = ftl.get("critpath") or {}
        if cps.get("rounds"):
            L.append(f"  critical path over {cps['rounds']} round(s), "
                     f"{cps.get('wall_s', 0)}s wall")
            pt = cps.get("phase_totals") or {}
            split = ", ".join(f"{k} {v}s" for k, v in sorted(pt.items())
                              if _num(v) and v > 0)
            if split:
                L.append(f"    phase totals: {split}")
            for b in cps.get("top_blockers", []):
                L.append(f"    blocker host {b['host']}: "
                         f"{b['rounds_blocked']} round(s), "
                         f"{b['exposed_s']}s exposed")
    if any(rep.get(k) for k in ("divergence", "health", "memstats")):
        hdr("training health")
        d = rep.get("divergence")
        if d:
            line = f"  divergence ({d.get('kind', 'params')}): " \
                   f"mean {d.get('first_mean', '?')} -> " \
                   f"{d.get('last_mean', '?')} " \
                   f"(peak {d.get('peak_mean', '?')}, " \
                   f"{d.get('samples')} samples"
            if _num(d.get("trend")):
                line += f", trend x{d['trend']}"
            if d.get("tau"):
                line += f", tau={d['tau']}"
            line += ")"
            L.append(line)
            if _num(d.get("rel")) or _num(d.get("gns_proxy")):
                bits = []
                if _num(d.get("rel")):
                    bits.append(f"drift/update ratio {d['rel']}")
                if _num(d.get("gns_proxy")):
                    bits.append(f"grad-noise-scale proxy {d['gns_proxy']}")
                L.append("    " + ", ".join(bits))
            if d.get("top_layers"):
                L.append("    top drifting layers: " + ", ".join(
                    f"{k}={v:.3g}" for k, v in d["top_layers"]))
            pr = d.get("per_round") or []
            if pr:
                L.append("    per-round mean divergence (last "
                         f"{len(pr[-8:])}): " + ", ".join(
                             f"{r}:{m:.3g}" for r, m in pr[-8:]))
        h = rep.get("health")
        if h:
            L.append(f"  health alarms: {h.get('alarms', 0)} (" + ", ".join(
                f"{k}: {v}" for k, v in sorted(
                    h.get("by_kind", {}).items())) + ")")
            if h.get("stragglers_by_worker"):
                L.append("    straggler: worker "
                         f"{h['worst_straggler']} flagged "
                         f"{h['stragglers_by_worker'][str(h['worst_straggler'])]}x "
                         f"(all: {h['stragglers_by_worker']})")
            la = h.get("last_alarm")
            if la:
                detail = " ".join(f"{k}={v}" for k, v in la.items()
                                  if k != "kind")
                L.append(f"    last alarm: [{la.get('kind')}] {detail}")
            if _num(h.get("suggest_tau")):
                L.append(f"    suggested tau: {h['suggest_tau']}")
            if _num(h.get("suggest_s")):
                L.append(f"    suggested staleness bound s: "
                         f"{h['suggest_s']}")
        m = rep.get("memstats")
        if m:
            bits = [f"{m.get('samples')} samples"]
            if _num(m.get("live_bytes_peak")):
                bits.append(f"peak live arrays "
                            f"{_fmt_bytes(m['live_bytes_peak'])}")
            if _num(m.get("hbm_peak_bytes_in_use")):
                bits.append(f"hbm peak "
                            f"{_fmt_bytes(m['hbm_peak_bytes_in_use'])}")
            if _num(m.get("compile_cache_last")):
                bits.append(f"compile cache {m['compile_cache_last']}")
            if _num(m.get("host_rss_peak")):
                bits.append(f"host rss peak "
                            f"{_fmt_bytes(m['host_rss_peak'])}")
            L.append("  memory: " + ", ".join(bits))
    if rep.get("device_cache"):
        hdr("device cache (last gauge)")
        for k, v in sorted(rep["device_cache"].items()):
            L.append(f"  {k} = {v}")
    if rep.get("watchdog"):
        hdr("watchdog")
        for k, v in sorted(rep["watchdog"].items()):
            L.append(f"  {k}: {v}")
    if rep.get("prefetch"):
        hdr("prefetch (last gauge)")
        for k, v in sorted(rep["prefetch"].items()):
            L.append(f"  {k} = {v}")
    ip = rep.get("input_pipeline")
    if ip:
        hdr("input pipeline")
        st = ip.get("h2d_stage")
        if st:
            L.append(f"  h2d staging: {st.get('puts', 0)} put(s), "
                     f"{_fmt_bytes(st.get('bytes'))} shipped, "
                     f"{st.get('kb_per_item', '?')} KB/item")
            L.append(f"    dispatch {st.get('dispatch_ms', '?')} ms, "
                     f"wait {st.get('wait_ms', '?')} ms, "
                     f"in flight {st.get('in_flight', '?')}/"
                     f"{st.get('slots', '?')} slot(s)")
        ig = ip.get("ingest")
        if ig:
            hosts = ig.get("hosts", {})
            L.append(f"  sharded ingest: {len(hosts)} host(s)"
                     + (f", {ig['respreads']} re-spread(s)"
                        if ig.get("respreads") else ""))
            for h, d in sorted(hosts.items()):
                rng = (f" [{d['lo']}..{d['hi']}]"
                       if _num(d.get("lo")) and d["lo"] >= 0 else "")
                L.append(f"    host {h}: partitions {d.get('partitions')}"
                         f", {d.get('records')} record(s){rng}, "
                         f"{d.get('reads', 0)} read(s)")
    if rep.get("hbm"):
        hdr("device memory")
        L.append(f"  peak bytes in use: "
                 f"{_fmt_bytes(rep['hbm'].get('peak_bytes_in_use'))} "
                 f"({rep['hbm'].get('samples')} samples)")
    if rep.get("bench"):
        hdr("bench rows")
        for r in rep["bench"]:
            bits = [str(r.get("model", "?")), str(r.get("mode", ""))]
            for k in ("images_per_sec", "tokens_per_sec", "mfu",
                      "rps", "latency_ms_p50", "latency_ms_p99"):
                if _num(r.get(k)):
                    bits.append(f"{k}={r[k]}")
            L.append("  " + "  ".join(b for b in bits if b))
    sv = rep.get("serving")
    if sv:
        hdr("serving")
        line = f"  requests: {sv.get('requests', 0)}"
        if _num(sv.get("rows")):
            line += f" ({sv['rows']} rows)"
        line += f", batches: {sv.get('batches', 0)}" \
                f", rejects: {sv.get('rejects', 0)}" \
                f", reloads: {sv.get('reloads', 0)}"
        L.append(line)
        ps = {q: sv.get(f"latency_ms_{q}") for q in ("p50", "p95", "p99")}
        if any(_num(v) for v in ps.values()):
            line = "  latency ms  " + "  ".join(
                f"{q}={ps[q]:.3f}" for q in ("p50", "p95", "p99")
                if _num(ps[q]))
            if _num(sv.get("queue_wait_ms_p99")):
                line += f"  (queue wait p99={sv['queue_wait_ms_p99']:.3f})"
            L.append(line)
        bits = []
        if _num(sv.get("rps")):
            bits.append(f"{sv['rps']} req/s")
        if _num(sv.get("batch_fill_mean")):
            bits.append(f"batch fill {sv['batch_fill_mean']:.0%}")
        elif _num(sv.get("batch_fill")):
            bits.append(f"batch fill {sv['batch_fill']:.0%}")
        if sv.get("buckets_used"):
            bits.append(f"buckets {sv['buckets_used']}")
        if _num(sv.get("queue_depth_max")):
            bits.append(f"max queue depth {sv['queue_depth_max']}")
        if bits:
            L.append("  " + ", ".join(bits))
        if sv.get("rejects_by_reason"):
            L.append("  rejects by reason: " + ", ".join(
                f"{k}: {v}" for k, v in sorted(
                    sv["rejects_by_reason"].items())))
        if sv.get("reload_iters"):
            L.append(f"  hot reloads to iters {sv['reload_iters']}")
        if sv.get("drained"):
            L.append("  drained cleanly")
    fl = rep.get("routing")
    if fl:
        hdr("routing fleet")
        line = f"  dispatches: {fl.get('dispatches', 0)}"
        if fl.get("by_code"):
            line += " (" + ", ".join(
                f"{k}: {v}" for k, v in sorted(fl["by_code"].items())) \
                + ")"
        L.append(line)
        if _num(fl.get("availability")):
            line = f"  availability {fl['availability']:.2%}, " \
                   f"retried {fl.get('retried', 0)}"
            if _num(fl.get("latency_ms_p99")):
                line += f", latency p99 {fl['latency_ms_p99']:.3f} ms"
            L.append(line)
        if fl.get("by_replica"):
            L.append("  by replica: " + ", ".join(
                f"{k}: {v}" for k, v in sorted(fl["by_replica"].items())))
        for e in fl.get("scale_events", []):
            L.append(f"  scale {e.get('action')} ({e.get('reason')}): "
                     f"live {e.get('live')}, p99 {e.get('p99_ms')} ms, "
                     f"depth {e.get('queue_depth')}")
        for e in fl.get("canary_events", []):
            bits = [f"  canary {e.get('action')} sha={e.get('sha')} "
                    f"(baseline {e.get('baseline_sha')})"]
            if e.get("reason"):
                bits.append(f"reason={e['reason']}")
            if _num(e.get("err_rate")):
                bits.append(f"err {e['err_rate']:.2%} vs "
                            f"{(e.get('base_err_rate') or 0):.2%}")
            L.append(" ".join(bits))
    tr = rep.get("tracing")
    if tr:
        hdr("request tracing")
        L.append(f"  traces: {tr.get('traces', 0)} "
                 f"({tr.get('tails', 0)} tail exemplar(s), "
                 f"{tr.get('retried', 0)} retried)")
        for k, st in (tr.get("stages") or {}).items():
            L.append(f"  {k:>8}  " + "  ".join(
                f"{q}={st[q]:.3f}" for q in ("p50", "p95", "p99")
                if _num(st.get(q))) + " ms")
        attr = tr.get("p99_attribution")
        if attr:
            total = tr.get("p99_cohort_ms") or sum(attr.values())
            top = tr.get("top_stage")
            L.append(f"  p99 attribution (where did the p99 go): "
                     f"top stage {top} "
                     f"({attr.get(top, 0):.3f} of {total:.3f} ms)")
            L.append("    " + "  ".join(
                f"{k}={v:.3f}" for k, v in attr.items()) + " ms")
    bn = rep.get("slo_burn")
    if bn:
        hdr("slo error budget")
        last = bn.get("last") or {}
        line = (f"  burn rate: fast x{last.get('fast')}"
                f"/{last.get('fast_long')}, "
                f"slow x{last.get('slow')}/{last.get('slow_long')}")
        if _num(last.get("budget_left")):
            line += f", budget left {last['budget_left']:.1%}"
        L.append(line)
        alerts = bn.get("alerts") or {}
        L.append("  alerts: " + (", ".join(
            f"{k}: {v}" for k, v in sorted(alerts.items()))
            if alerts else "none") +
            f" (peak fast burn x{bn.get('peak_fast_burn')}, "
            f"{bn.get('evaluations', 0)} evaluation(s))")
    L.append("")
    return "\n".join(L)


def filter_events(events, since=None, event_types=None):
    """Apply the report's --since / --event selection. ``since``: keep
    events with t >= since (seconds into the run — the ``t`` field every
    MetricsLogger line carries); ``event_types``: iterable of event
    names to keep. Returns the filtered list; the CALLER must treat an
    empty result as an error — an empty report renders exactly like
    "all healthy", which is the dangerous lie the exit-2 contract
    prevents."""
    out = events
    if since is not None:
        out = [e for e in out
               if isinstance(e.get("t"), (int, float))
               and e["t"] >= float(since)]
    if event_types:
        keep = {str(k) for k in event_types}
        out = [e for e in out if e.get("event") in keep]
    return out


def report_file(jsonl_path, json_out=None, chrome_out=None, out=print,
                since=None, event_types=None, fmt="text"):
    """Load + aggregate + render; optionally write JSON / Chrome trace.
    The implementation behind `sparknet report`. ``since``/
    ``event_types`` select a slice of the stream; a selection that
    matches ZERO events raises MetricsFileError (exit 2 at the CLI) —
    never an empty report that reads as "all healthy".

    ``fmt="json"`` emits the report dict itself on stdout (sorted keys,
    one stable document — the same keys --json writes) so CI and the
    bench perf gate can assert on report content without scraping the
    rendered text."""
    events, bad = load_events(jsonl_path)
    if not events:
        raise MetricsFileError(
            f"metrics file has no parseable events: {jsonl_path}"
            + (f" ({bad} malformed line(s) skipped)" if bad
               else " (file is empty)"))
    if since is not None or event_types:
        selected = filter_events(events, since=since,
                                 event_types=event_types)
        if not selected:
            sel = []
            if since is not None:
                sel.append(f"--since {since}")
            if event_types:
                sel.append(f"--event {','.join(sorted(event_types))}")
            raise MetricsFileError(
                f"{' '.join(sel)} selected 0 of {len(events)} events in "
                f"{jsonl_path} — refusing to print an empty report that "
                "would read as healthy")
        events = selected
    rep = aggregate(events)
    if bad:
        rep["malformed_lines"] = bad
    if fmt == "json":
        out(json.dumps(rep, indent=1, sort_keys=True, default=str))
    else:
        out(render(rep))
    if json_out:
        with open(json_out, "w") as f:
            json.dump(rep, f, indent=1, default=str)
        if fmt != "json":
            out(f"wrote {json_out}")
    if chrome_out:
        from .trace import export_chrome
        spans = [e for e in events if e.get("event") == "span"]
        export_chrome(chrome_out, spans)
        if fmt != "json":
            out(f"wrote {chrome_out} ({len(spans)} spans)")
    return rep
