"""A copy of sparknet_tpu/obs/fleettrace.py. Cross-host trace correlation: merge N per-host metrics streams into
one clock-aligned fleet timeline.

Every host writes its own metrics JSONL on its own clocks — wall for the
``t`` field, monotonic for gate deadlines and spans — and nothing on one
host's timeline is directly comparable to another's. The alignment
substrate is the heartbeat protocol itself: each beat record carries the
sender's monotonic send time (``mono``, heartbeat.beat), and the peer
that observes the new record emits a ``trace_align`` event pairing it
with its OWN monotonic receipt time. A receipt can only happen after the
send, so each beacon is a one-sided bound on the pairwise clock offset —
exactly the NTP interval argument:

    A observes B:  off(A,B) := monoA - monoB  <=  obs_mono - peer_mono
    B observes A:  off(A,B)  >= -(obs_monoB - peer_monoA)

Minimizing each side over many beacons gives an interval [lo, hi]; the
estimate is its midpoint and the error bar its half-width. Offsets reach
hosts with no direct pair through BFS over the bounds graph (error bars
add along the path). Simulated fleets (sparknet simfleet) share one
SimClock, so their beacons solve to ~zero offset through the exact same
path — no special cases.

Placement of an individual event on the merged timeline, best first:
  1. an explicit ``mono`` field (host_round gate exits, relay_io) —
     exact;
  2. the per-host wall->mono fit: ``t`` is wall seconds since the
     logger's epoch, and every trace_align/host_round event carries both
     ``t`` and a mono stamp, so median(mono - t) maps any event of that
     host onto its monotonic clock (robust to NTP steps between
     beacons — the median ignores a minority of pre/post-step samples);
  3. raw ``t`` (a stream with no mono-bearing events at all — marked
     unaligned).

The merged result exports as ONE Chrome trace_event file: one process
(track group) per host carrying its rounds, gate waits, spans, steps,
relay/consensus IO and H2D staging, with the solved clock offset and
error bar in the process label and in ``otherData.clock_offsets``.
"""

import json
import os
from collections import defaultdict

#: metrics events attributed to a host by which field
_HOST_FIELD = {"host_round": "observer", "trace_align": "observer",
               "host_alive": "observer", "ghost_reaped": "observer",
               "relay_io": "host"}

#: fleet-level events in a multiplexed (simfleet) stream — they belong
#: to the run, not to any one host's clock
_FLEET_EVENTS = {"sim", "membership"}

FLEET_TRACK = "fleet"


def host_of(ev):
    """The host id an event is attributed to, or None (stream-scoped —
    belongs to whichever host wrote the file)."""
    field = _HOST_FIELD.get(ev.get("event"))
    if field is None:
        # chaos slow_host events name the stalled host directly
        if ev.get("event") == "chaos" and ev.get("kind") == "slow_host" \
                and isinstance(ev.get("host"), int):
            return ev["host"]
        return None
    h = ev.get(field)
    return h if isinstance(h, int) else None


def split_streams(streams):
    """``streams``: list of per-file event lists -> {host: [events]},
    each host's events in file order. A file with ONE distinct
    self-attributed host (a real per-host run) contributes every event
    to that host; a multiplexed file (simfleet: many hosts through one
    logger) is split per event, with fleet-level events and unattributed
    leftovers going to the FLEET_TRACK pseudo-host. Files with no host
    evidence at all become synthetic hosts file<i>."""
    out = defaultdict(list)
    for i, events in enumerate(streams):
        owners = {host_of(ev) for ev in events} - {None}
        # observers see peers; the file's own host is the one that
        # OBSERVES (emits trace_align/host_round), not the ones observed
        self_ids = {ev.get("observer") for ev in events
                    if ev.get("event") in ("host_round", "trace_align")
                    and isinstance(ev.get("observer"), int)}
        if not self_ids and not owners:
            # a serving-tier stream (router or replica) has no beacon
            # observer ints; its serve_trace events name the writer in
            # ``src`` ("router", "replica0", ...) — one distinct src
            # means the whole file is that host's track
            srcs = {ev.get("src") for ev in events
                    if ev.get("event") == "serve_trace"} - {None}
            if len(srcs) == 1:
                out[next(iter(srcs))].extend(events)
                continue
        self_ids = self_ids or owners
        if len(self_ids) == 1:
            out[next(iter(self_ids))].extend(events)
        elif not self_ids:
            out[f"file{i}"].extend(events)
        else:
            for ev in events:
                if ev.get("event") in _FLEET_EVENTS:
                    out[FLEET_TRACK].append(ev)
                    continue
                h = host_of(ev)
                out[h if h is not None else FLEET_TRACK].append(ev)
    return dict(out)


def beacons(per_host):
    """All trace_align events across the split streams."""
    out = []
    for evs in per_host.values():
        out.extend(ev for ev in evs if ev.get("event") == "trace_align")
    return out


def pair_bounds(beacon_events):
    """{(observer, peer): (hi, n_samples)} — hi is the tightest upper
    bound on off(observer, peer) = mono_obs - mono_peer seen in any
    beacon for the ordered pair."""
    hi = {}
    for b in beacon_events:
        a, p = b.get("observer"), b.get("peer")
        om, pm = b.get("obs_mono"), b.get("peer_mono")
        if not (isinstance(a, int) and isinstance(p, int)):
            continue
        if not all(isinstance(x, (int, float)) for x in (om, pm)):
            continue
        bound = float(om) - float(pm)
        cur = hi.get((a, p))
        hi[(a, p)] = (bound, 1) if cur is None else \
            (min(cur[0], bound), cur[1] + 1)
    return hi


def solve_offsets(bounds, hosts, ref=None):
    """Per-host offset to the reference host's monotonic timeline.

    Returns {host: {"offset_s", "err_s", "samples", "one_sided"}} where
    ref_time = host_mono + offset_s. ``err_s`` is the accumulated
    interval half-width along the BFS path (None when every hop was
    one-sided — the estimate is then the bound itself, biased late by
    at most one delivery delay). Hosts unreachable through the beacon
    graph get offset 0.0 with err None (unaligned)."""
    hosts = [h for h in hosts if isinstance(h, int)]
    if not hosts:
        return {}
    ref = min(hosts) if ref is None else ref
    # pairwise interval per unordered pair, oriented as off(a, b)
    edges = defaultdict(list)   # a -> [(b, est_ab, err_ab, n, one_sided)]
    done = set()
    for (a, b), (hi_ab, n_ab) in bounds.items():
        if (b, a) in done or (a, b) in done:
            continue
        done.add((a, b))
        rev = bounds.get((b, a))
        if rev is not None:
            lo_ab, n = -rev[0], n_ab + rev[1]
            est = (lo_ab + hi_ab) / 2.0
            err = max(0.0, (hi_ab - lo_ab) / 2.0)
            one_sided = False
        else:
            est, err, n, one_sided = hi_ab, None, n_ab, True
        edges[a].append((b, est, err, n, one_sided))
        edges[b].append((a, -est, err, n, one_sided))
    out = {h: {"offset_s": 0.0, "err_s": None, "samples": 0,
               "one_sided": True, "aligned": False} for h in hosts}
    if ref not in out:
        return out
    out[ref] = {"offset_s": 0.0, "err_s": 0.0, "samples": 0,
                "one_sided": False, "aligned": True}
    frontier = [ref]
    while frontier:
        a = frontier.pop(0)
        for b, est_ab, err_ab, n, one_sided in edges.get(a, ()):
            if b not in out or out[b]["aligned"]:
                continue
            # off(a,b) = mono_a - mono_b at one instant, so a peer's
            # mono maps to the ref frame as mono_b + off(ref, b) where
            # off(ref, b) chains: offset_b = offset_a + off(a, b)
            base = out[a]
            err = None if (err_ab is None or base["err_s"] is None) \
                else base["err_s"] + err_ab
            out[b] = {"offset_s": base["offset_s"] + est_ab,
                      "err_s": None if err is None else round(err, 6),
                      "samples": n,
                      "one_sided": one_sided or base["one_sided"],
                      "aligned": True}
            frontier.append(b)
    for rec in out.values():
        rec["offset_s"] = round(rec["offset_s"], 6)
    return out


def wall_to_mono(events):
    """Median (mono - t) over this host's mono-bearing events — the
    wall->mono fit used to place events that carry only ``t``. None
    when the stream has no mono evidence (placement falls back to raw
    t)."""
    deltas = []
    for ev in events:
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            continue
        if ev.get("event") == "trace_align":
            m = ev.get("obs_mono")
        else:
            m = ev.get("mono")
        if isinstance(m, (int, float)):
            deltas.append(float(m) - float(t))
    if not deltas:
        return None
    deltas.sort()
    n = len(deltas)
    mid = n // 2
    return deltas[mid] if n % 2 else (deltas[mid - 1] + deltas[mid]) / 2


class FleetTrace:
    """The merged, clock-aligned fleet timeline.

    hosts     sorted track keys (ints, then synthetic string tracks)
    events    {host: [events]} as split from the input streams
    offsets   {host: offset record} from solve_offsets (int hosts only)
    fits      {host: wall->mono delta or None}
    """

    def __init__(self, per_host, offsets, fits):
        self.events = per_host
        self.offsets = offsets
        self.fits = fits
        self.hosts = sorted([h for h in per_host if isinstance(h, int)]) \
            + sorted([h for h in per_host if not isinstance(h, int)])

    def place(self, host, ev):
        """Event -> seconds on the reference timeline, or None (no time
        evidence). Explicit mono beats the wall fit beats raw t."""
        off = self.offsets.get(host, {}).get("offset_s", 0.0)
        m = ev.get("obs_mono") if ev.get("event") == "trace_align" \
            else ev.get("mono")
        if isinstance(m, (int, float)):
            return float(m) + off
        if ev.get("event") == "sim" and \
                isinstance(ev.get("t_s"), (int, float)):
            # simfleet events stamp virtual mono directly; every sim
            # host shares that clock, so no offset applies
            return float(ev["t_s"])
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            return None
        fit = self.fits.get(host)
        if fit is not None:
            return float(t) + fit + off
        return float(t)

    def aligned(self, host):
        rec = self.offsets.get(host)
        return bool(rec and rec.get("aligned"))


def merge_streams(streams):
    """Per-file event lists -> FleetTrace (split, solve, fit)."""
    per_host = split_streams(streams)
    offs = solve_offsets(pair_bounds(beacons(per_host)),
                         list(per_host.keys()))
    fits = {h: wall_to_mono(evs) for h, evs in per_host.items()}
    return FleetTrace(per_host, offs, fits)


# -- Chrome synthesis --------------------------------------------------------

#: synthetic track (tid) layout inside each host's process group
_TID_ROUNDS, _TID_IO, _TID_H2D, _TID_STEPS, _TID_SPANS = 0, 1, 2, 3, 4
_TID_SERVE = 5

_TRACK_NAMES = {_TID_ROUNDS: "rounds", _TID_IO: "relay/consensus",
                _TID_H2D: "h2d", _TID_STEPS: "steps",
                _TID_SPANS: "spans", _TID_SERVE: "serve"}


def _x(name, ts_s, dur_s, pid, tid, args):
    return {"name": name, "ph": "X", "cat": "fleet",
            "ts": round(ts_s * 1e6, 1),
            "dur": round(max(0.0, dur_s) * 1e6, 1),
            "pid": pid, "tid": tid, "args": args}


def _i(name, ts_s, pid, tid, args):
    return {"name": name, "ph": "i", "cat": "fleet", "s": "t",
            "ts": round(ts_s * 1e6, 1), "pid": pid, "tid": tid,
            "args": args}


def _host_events(ft, host, pid):
    """One host's metrics events -> Chrome events on the merged
    timeline. Durations come from each event's own duration fields;
    placement anchors at the event's EMIT time (the end of what it
    measures), so spans/waits are drawn end-anchored."""
    evs = []
    last_round_end = None
    for ev in ft.events[host]:
        kind = ev.get("event")
        at = ft.place(host, ev)
        if at is None:
            continue
        if kind == "host_round":
            wait = float(ev.get("wait_s") or 0.0)
            evs.append(_x(f"gate r{ev.get('round')}", at - wait, wait,
                          pid, _TID_ROUNDS,
                          {"round": ev.get("round"),
                           "arrived": ev.get("arrived"),
                           "dead": ev.get("dead")}))
        elif kind == "sim":
            wait = float(ev.get("wait_s") or 0.0)
            evs.append(_x(f"gate r{ev.get('round')}", at - wait, wait,
                          pid, _TID_ROUNDS,
                          {k: ev.get(k) for k in
                           ("round", "live", "parked", "dead")}))
        elif kind == "round":
            # round events mark completion; the span covers the gap
            # back to the previous round event on the same track
            start = last_round_end if last_round_end is not None else at
            evs.append(_x(f"round {ev.get('round')}", start,
                          at - start, pid, _TID_STEPS,
                          {k: ev.get(k) for k in
                           ("round", "iter", "loss", "images_per_s")
                           if ev.get(k) is not None}))
            last_round_end = at
        elif kind == "relay_io":
            dur = float(ev.get("seconds") or 0.0)
            evs.append(_x(f"relay r{ev.get('round')}", at - dur, dur,
                          pid, _TID_IO, {"round": ev.get("round"),
                                         "bytes": ev.get("bytes")}))
        elif kind == "h2d_stage":
            dur = (float(ev.get("dispatch_ms") or 0.0)
                   + float(ev.get("wait_ms") or 0.0)) / 1e3
            evs.append(_x(f"h2d {ev.get('name', '')}".strip(), at - dur,
                          dur, pid, _TID_H2D,
                          {k: ev.get(k) for k in
                           ("bytes", "wait_ms", "dispatch_ms")
                           if ev.get(k) is not None}))
        elif kind == "step":
            dur = float(ev.get("host_ms") or 0.0) / 1e3
            evs.append(_x("step", at - dur, dur, pid, _TID_STEPS,
                          {k: ev.get(k) for k in
                           ("iter", "host_ms", "device_ms")
                           if ev.get(k) is not None}))
        elif kind == "span":
            dur = float(ev.get("dur_ms") or 0.0) / 1e3
            args = {k: v for k, v in ev.items()
                    if k not in ("event", "t", "run", "start_ms",
                                 "dur_ms", "tid", "name")}
            evs.append(_x(str(ev.get("name", "span")), at - dur, dur,
                          pid, _TID_SPANS, args))
        elif kind == "serve_trace":
            # one traced serve request, end-anchored at its emit time.
            # Router events nest their per-attempt dispatch spans;
            # replica events nest the stage breakdown. The shared
            # trace id in args is what correlates the router's span
            # with the replica's across process tracks.
            total_s = float(ev.get("total_ms")
                            or ev.get("server_ms") or 0.0) / 1e3
            trace = ev.get("trace")
            start = at - total_s
            args = {k: ev.get(k) for k in
                    ("trace", "replica", "code", "attempts", "retried",
                     "tail", "net_ms", "queue_ms", "batch_ms",
                     "infer_ms", "fulfill_ms")
                    if ev.get(k) is not None}
            name = f"req {trace}" if trace else "req"
            if ev.get("tail"):
                name += " [tail]"
            evs.append(_x(name, start, total_s, pid, _TID_SERVE, args))
            spans = ev.get("spans")
            if spans:
                for sp in spans:
                    if not isinstance(sp, dict):
                        continue
                    dur = float(sp.get("dur_ms") or 0.0) / 1e3
                    evs.append(_x(
                        f"dispatch r{sp.get('replica')}",
                        start + float(sp.get("start_ms") or 0.0) / 1e3,
                        dur, pid, _TID_SERVE,
                        {"trace": trace, "replica": sp.get("replica"),
                         "code": sp.get("code")}))
            else:
                cursor = start
                for stage in ("net", "queue", "batch", "infer",
                              "fulfill"):
                    dur_ms = ev.get(f"{stage}_ms")
                    if not isinstance(dur_ms, (int, float)) \
                            or dur_ms <= 0:
                        continue
                    evs.append(_x(stage, cursor, dur_ms / 1e3, pid,
                                  _TID_SERVE, {"trace": trace}))
                    cursor += dur_ms / 1e3
        elif kind == "chaos":
            evs.append(_i(f"chaos {ev.get('kind')}", at, pid,
                          _TID_ROUNDS,
                          {k: v for k, v in ev.items()
                           if k not in ("event", "t", "run")}))
        elif kind in ("host_alive", "health", "recompile"):
            evs.append(_i(kind, at, pid, _TID_ROUNDS,
                          {k: v for k, v in ev.items()
                           if k not in ("event", "t", "run")}))
    return evs


def chrome_doc(ft):
    """FleetTrace -> Chrome trace_event document: one process per host
    (sorted, deterministic), labeled with the solved clock offset."""
    events = []
    pids = {}
    for idx, host in enumerate(ft.hosts):
        pid = idx + 1
        pids[host] = pid
        off = ft.offsets.get(host)
        if host == FLEET_TRACK:
            label = "fleet"
        elif off and off.get("aligned"):
            err = off.get("err_s")
            err_txt = "one-sided" if err is None \
                else f"±{err * 1e3:.1f}ms"
            label = (f"host {host} (offset "
                     f"{off['offset_s'] * 1e3:+.1f}ms {err_txt})")
        else:
            label = f"host {host} (unaligned)"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": label}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": pid, "args": {"sort_index": idx}})
        for tid, tname in _TRACK_NAMES.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        events.extend(_host_events(ft, host, pid))
    offsets_meta = {str(h): rec for h, rec in sorted(
        ft.offsets.items(), key=lambda kv: str(kv[0]))
        if isinstance(h, int)}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"clock_offsets": offsets_meta,
                          "hosts": [str(h) for h in ft.hosts]}}


def export_chrome(path, ft):
    """Write the merged fleet trace as a Chrome trace_event file."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_doc(ft), f)
    return path


def align_summary(ft):
    """Stable machine-readable alignment summary (report --format json
    and the report/monitor fleet sections render from this)."""
    n_beacons = sum(1 for evs in ft.events.values()
                    for ev in evs if ev.get("event") == "trace_align")
    return {"hosts": [str(h) for h in ft.hosts],
            "beacons": n_beacons,
            "offsets": {str(h): rec for h, rec in sorted(
                ft.offsets.items(), key=lambda kv: str(kv[0]))
                if isinstance(h, int)}}
