"""A copy of sparknet_tpu/obs/critpath.py. Per-sync-round critical-path attribution over the merged fleet
timeline — The Mystery Machine's observation applied to our
own closed event schema: the causal structure of a sync round is known
(gate -> local round -> relay exchange -> gate), so the per-phase wall
time and the blocking host can be mined from the timestamped events the
runtime already emits, no new instrumentation.

The unit is the round CYCLE ending at gate-exit of round r: every host
announces arrival at r only after finishing its round r-1 work, so the
host that ENTERS gate r last is the host the whole fleet waited on —
its own gate wait is ~0 while everyone else's wait_s is the exposed
straggler time. That is exactly the chaos ``slow_host``/``slow_worker``
shape, which is what the end-to-end tests inject and expect named.

Each cycle's wall time decomposes into phases:

  gate_wait   max peer wait at gate r (exposed, blocked on host H)
  relay       consensus/relay IO (relay_io events, measured)
  h2d         host->device staging (h2d_stage events in the window)
  ingest      spans whose name marks the input pipeline
  compute     the remainder (local tau steps; a chaos stall that
              happens outside any instrumented phase lands here too)

The fleet summary ranks top blockers by exposed seconds and reuses
comms.py's byte/cost models to report structurally exposed vs
overlappable collective traffic next to the measured relay time.
"""

from collections import defaultdict

from .comms import broadcast_collect_bytes, ring_allreduce_bytes

#: span names counted as input-pipeline time
INGEST_NAMES = ("ingest", "batch", "feed", "stage", "shard")

#: below this wait spread (seconds) a round has no meaningful blocker
BALANCED_S = 0.02


def _gates(ft):
    """{round: {host: {"wait_s", "at"(ref exit time or None)}}} from
    host_round events, plus simfleet ``sim`` gate records under the
    observer-less FLEET view (host key "sim")."""
    out = defaultdict(dict)
    for host, evs in ft.events.items():
        for ev in evs:
            kind = ev.get("event")
            if kind == "host_round":
                r = ev.get("round")
                if not isinstance(r, int):
                    continue
                out[r][ev.get("observer", host)] = {
                    "wait_s": float(ev.get("wait_s") or 0.0),
                    "at": ft.place(host, ev)}
            elif kind == "sim":
                r = ev.get("round")
                if not isinstance(r, int):
                    continue
                out[r].setdefault("sim", {
                    "wait_s": float(ev.get("wait_s") or 0.0),
                    "at": ft.place(host, ev),
                    "live": ev.get("live"), "dead": ev.get("dead")})
    return dict(out)


def _windowed(evs, ft, host, lo, hi):
    """Events of one host placed inside (lo, hi] on the ref timeline."""
    if lo is None or hi is None:
        return []
    out = []
    for ev in evs:
        at = ft.place(host, ev)
        if at is not None and lo < at <= hi:
            out.append((at, ev))
    return out


def _host_components(ft, host, lo, hi):
    """One host's measured phase seconds inside its cycle window."""
    comp = {"relay": 0.0, "h2d": 0.0, "ingest": 0.0}
    for _, ev in _windowed(ft.events.get(host, []), ft, host, lo, hi):
        kind = ev.get("event")
        if kind == "relay_io":
            comp["relay"] += float(ev.get("seconds") or 0.0)
        elif kind == "h2d_stage":
            comp["h2d"] += (float(ev.get("dispatch_ms") or 0.0)
                            + float(ev.get("wait_ms") or 0.0)) / 1e3
        elif kind == "span":
            name = str(ev.get("name", "")).lower()
            if any(k in name for k in INGEST_NAMES):
                comp["ingest"] += float(ev.get("dur_ms") or 0.0) / 1e3
    return comp


def _blocker(gates_r):
    """(host, spread_s) — the host the round waited on, by latest gate
    ENTRY when placement exists for everyone, else by smallest wait
    (the last arriver waits for nobody). None when waits are too even
    to name one."""
    hosts = {h: g for h, g in gates_r.items() if h != "sim"}
    if len(hosts) < 2:
        return None, 0.0
    waits = {h: g["wait_s"] for h, g in hosts.items()}
    spread = max(waits.values()) - min(waits.values())
    if spread < BALANCED_S:
        return None, spread
    if all(g["at"] is not None for g in hosts.values()):
        entry = {h: g["at"] - g["wait_s"] for h, g in hosts.items()}
        host = max(sorted(entry), key=lambda h: entry[h])
    else:
        host = min(sorted(waits), key=lambda h: waits[h])
    return host, spread


def _chaos_for(ft, host, round_idx):
    """A chaos event corroborating this blocker, if the stream has one
    (attribution annotation only — the blocker itself is timing-derived)."""
    for evs in ft.events.values():
        for ev in evs:
            if ev.get("event") != "chaos":
                continue
            if ev.get("round") != round_idx:
                continue
            if ev.get("kind") in ("slow_host", "slow_worker") and \
                    (ev.get("host") == host or ev.get("worker") == host
                     or len(ft.events) <= 1):
                return ev.get("kind")
    return None


def compute(ft, round_filter=None):
    """FleetTrace -> {"rounds": [per-round dicts], "summary": {...}}.

    Per round r (the cycle ENDING at gate-exit r): wall seconds,
    blocking host, the blocker's dominant phase, and the fleet phase
    split. round_filter limits to one round index (CLI --round N)."""
    gates = _gates(ft)
    rounds = []
    prev_exit = {}
    for r in sorted(gates):
        g = gates[r]
        hosts = {h: rec for h, rec in g.items() if h != "sim"}
        sim = g.get("sim")
        waits = {h: rec["wait_s"] for h, rec in hosts.items()}
        if sim is not None and not hosts:
            waits = {"sim": sim["wait_s"]}
        gate_wait = max(waits.values()) if waits else 0.0
        blocker, spread = _blocker(g)
        # cycle window per host: previous gate exit -> this gate entry
        wall = None
        exits = {h: rec["at"] for h, rec in hosts.items()
                 if rec["at"] is not None}
        if sim is not None and sim["at"] is not None:
            exits.setdefault("sim", sim["at"])
        if exits and all(h in prev_exit for h in exits):
            wall = max(exits[h] - prev_exit[h] for h in exits)
        phases = {"gate_wait": round(gate_wait, 4), "relay": 0.0,
                  "h2d": 0.0, "ingest": 0.0, "compute": None}
        blocker_phase = None
        chaos_kind = None
        if blocker is not None:
            lo = prev_exit.get(blocker)
            rec = hosts.get(blocker)
            hi = None if rec is None or rec["at"] is None \
                else rec["at"] - rec["wait_s"]
            comp = _host_components(ft, blocker, lo, hi)
            busy = None if lo is None or hi is None else max(0.0, hi - lo)
            comp["compute"] = None if busy is None else \
                max(0.0, busy - sum(comp.values()))
            named = {k: v for k, v in comp.items() if v}
            blocker_phase = max(sorted(named), key=lambda k: named[k]) \
                if named else "compute"
            chaos_kind = _chaos_for(ft, blocker, r) \
                or _chaos_for(ft, blocker, r - 1)
        # fleet phase split: max per-host measured components in the
        # cycle, remainder is compute
        for h in hosts:
            comp = _host_components(ft, h, prev_exit.get(h),
                                    exits.get(h))
            for k in ("relay", "h2d", "ingest"):
                phases[k] = round(max(phases[k], comp[k]), 4)
        if wall is not None:
            phases["compute"] = round(
                max(0.0, wall - phases["gate_wait"] - phases["relay"]
                    - phases["h2d"] - phases["ingest"]), 4)
        rounds.append({"round": r,
                       "wall_s": None if wall is None
                       else round(wall, 4),
                       "blocker": blocker,
                       "blocker_phase": blocker_phase,
                       "chaos": chaos_kind,
                       "spread_s": round(spread, 4),
                       "waits": {str(h): round(w, 4)
                                 for h, w in sorted(
                                     waits.items(),
                                     key=lambda kv: str(kv[0]))},
                       "phases": phases})
        for h, at in exits.items():
            prev_exit[h] = at
    if round_filter is not None:
        rounds = [rec for rec in rounds if rec["round"] == round_filter]
    return {"rounds": rounds, "summary": _summary(ft, rounds)}


def _summary(ft, rounds):
    blocked = defaultdict(lambda: [0, 0.0])   # host -> [rounds, seconds]
    phase_tot = defaultdict(float)
    wall_tot = 0.0
    for rec in rounds:
        if rec["blocker"] is not None:
            b = blocked[str(rec["blocker"])]
            b[0] += 1
            b[1] += rec["phases"]["gate_wait"]
        for k, v in rec["phases"].items():
            if isinstance(v, (int, float)):
                phase_tot[k] += v
        if rec["wall_s"]:
            wall_tot += rec["wall_s"]
    top = sorted(blocked.items(),
                 key=lambda kv: (-kv[1][1], -kv[1][0], kv[0]))
    out = {"rounds": len(rounds),
           "wall_s": round(wall_tot, 4),
           "phase_totals": {k: round(v, 4)
                            for k, v in sorted(phase_tot.items())},
           "top_blockers": [{"host": h, "rounds_blocked": n,
                             "exposed_s": round(s, 4)}
                            for h, (n, s) in top[:5]]}
    comms = _comms_exposure(ft)
    if comms:
        out["comms"] = comms
    return out


def _comms_exposure(ft):
    """Exposed vs overlappable collective traffic from the newest
    ``comms`` event, plus the relay's measured seconds against the
    analytic ring/broadcast volumes for the same payload — the paper's
    cost model next to the measured wire time."""
    newest = None
    for evs in ft.events.values():
        for ev in evs:
            if ev.get("event") == "comms":
                newest = ev
    relay_s, relay_bytes, relay_n = 0.0, 0, 0
    hosts = [h for h in ft.hosts if isinstance(h, int)]
    for evs in ft.events.values():
        for ev in evs:
            if ev.get("event") == "relay_io":
                relay_s += float(ev.get("seconds") or 0.0)
                relay_bytes = max(relay_bytes, int(ev.get("bytes") or 0))
                relay_n += 1
    out = {}
    if newest is not None:
        for k in ("collective_bytes_per_step", "exposed_bytes_per_step",
                  "overlapped_bytes_per_step", "overlap_ceiling"):
            if newest.get(k) is not None:
                out[k] = newest[k]
    if relay_n:
        n = max(2, len(hosts))
        out["relay_rounds"] = relay_n
        out["relay_s_total"] = round(relay_s, 4)
        out["relay_payload_bytes"] = relay_bytes
        out["ring_allreduce_bytes"] = ring_allreduce_bytes(relay_bytes, n)
        out["broadcast_collect_bytes"] = \
            broadcast_collect_bytes(relay_bytes, n)
    return out


def render(cp, out=print, top_rounds=10):
    """Human-readable critical-path report (CLI `sparknet trace
    --critpath` and report.py's fleet section)."""
    rounds, summary = cp["rounds"], cp["summary"]
    out("critical path "
        f"({summary['rounds']} round(s), "
        f"{summary['wall_s']:.2f}s wall)")
    worst = sorted(rounds, key=lambda r: -(r["wall_s"] or
                                           r["phases"]["gate_wait"]))
    for rec in worst[:top_rounds]:
        wall = f"{rec['wall_s']:.3f}s" if rec["wall_s"] is not None \
            else "?"
        if rec["blocker"] is not None:
            chaos = f" [chaos {rec['chaos']}]" if rec["chaos"] else ""
            who = (f"blocked on host {rec['blocker']} "
                   f"({rec['blocker_phase']}){chaos}")
        else:
            who = "balanced"
        ph = rec["phases"]
        split = ", ".join(f"{k} {v:.3f}s" for k, v in ph.items()
                          if isinstance(v, (int, float)) and v > 0)
        out(f"  round {rec['round']}: wall {wall} — {who}"
            + (f" | {split}" if split else ""))
    if summary["top_blockers"]:
        out("  top blockers:")
        for b in summary["top_blockers"]:
            out(f"    host {b['host']}: blocked {b['rounds_blocked']} "
                f"round(s), {b['exposed_s']:.3f}s exposed")
    comms = summary.get("comms")
    if comms:
        if "exposed_bytes_per_step" in comms:
            out(f"  comms: exposed {comms['exposed_bytes_per_step']} "
                f"B/step vs overlapped "
                f"{comms.get('overlapped_bytes_per_step', 0)} B/step "
                f"(ceiling {comms.get('overlap_ceiling', 0)})")
        if "relay_rounds" in comms:
            out(f"  relay: {comms['relay_rounds']} exchange(s), "
                f"{comms['relay_s_total']:.3f}s measured, payload "
                f"{comms['relay_payload_bytes']} B (ring model "
                f"{comms['ring_allreduce_bytes']} B/chip, paper "
                f"broadcast+collect {comms['broadcast_collect_bytes']} "
                "B)")
