"""Sweep grids over the control-plane knobs — the study driver.

A sweep spec is comma-separated ``key=v1:v2:...`` axes whose Cartesian
product defines the cells, e.g.::

    hosts=200:1000,fail_rate=0.0005:0.005,lease_s=1.0:3.0,quorum=1

Each cell is one deterministic FleetSim run; fail_rate/fail_seed/
fail_corr axes become the chaos failure process, everything else maps
straight onto FleetSim's knobs. Unknown keys and malformed values are
an error naming the token (same contract as the chaos grammar — a
typo'd axis must never produce a vacuous study). Results power the
JAX package's DEPLOY.md "Tuning the control plane at fleet scale"
tables; the simfleet CLI verb (``simfleet --sweep ...``) is the entry
point.
"""

import itertools
import time

from .fleet import FleetSim

INT_KEYS = {"hosts", "rounds", "tau", "quorum", "evict_after",
            "readmit_after", "staleness", "unpark_after", "fail_corr",
            "fail_seed", "recover_after", "seed", "slow_worker",
            "slow_round"}
FLOAT_KEYS = {"lease_s", "interval_s", "step_s", "round_s", "jitter",
              "fail_rate", "s_decay", "slow_s"}
#: chaos-process axes, routed into a ChaosMonkey spec rather than
#: FleetSim kwargs
CHAOS_KEYS = ("fail_rate", "fail_seed", "fail_corr", "slow_worker",
              "slow_s", "slow_round")

#: the serving-fleet study (``simfleet --serve --sweep``):
#: axes map onto ServeFleetSim knobs, chaos keys onto the grammar's
#: serving-tier injectors
SERVE_INT_KEYS = {"replicas", "windows", "queue_limit", "slo_depth",
                  "breach_windows", "idle_windows", "min_replicas",
                  "max_replicas", "seed", "canary_w",
                  "canary_min_requests", "die_w", "rejoin_w",
                  "kill_replica", "kill_req", "slow_replica"}
SERVE_FLOAT_KEYS = {"window_s", "lease_s", "interval_s", "service_ms",
                    "rate", "spike_x", "slo_p99_ms", "spawn_delay_s",
                    "canary_pct", "canary_err", "slow_ms"}
SERVE_STR_KEYS = {"trace"}
SERVE_CHAOS_KEYS = ("kill_replica", "kill_req", "slow_replica",
                    "slow_ms")


def _parse_axes(spec, int_keys, float_keys, str_keys=frozenset()):
    """Shared grid parser: ``key=v1:v2:...`` axes -> Cartesian-product
    cell dicts. Unknown keys and malformed values are an error naming
    the token (a typo'd axis must never produce a vacuous study)."""
    known = int_keys | float_keys | str_keys
    valid = f"valid axes: {', '.join(sorted(known))}"
    axes = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        k = k.strip()
        if not eq:
            raise ValueError(f"sweep token {part!r}: expected "
                             f"key=v1:v2:...; {valid}")
        if k not in known:
            raise ValueError(f"sweep token {part!r}: unknown axis "
                             f"{k!r}; {valid}")
        conv = int if k in int_keys else \
            float if k in float_keys else str
        try:
            vals = [conv(x.strip()) for x in v.split(":")]
            if conv is str and not all(vals):
                raise ValueError("empty value")
        except (TypeError, ValueError):
            raise ValueError(
                f"sweep token {part!r}: bad value(s) {v!r} for {k} "
                f"(expects {conv.__name__}); {valid}") from None
        axes.append((k, vals))
    keys = [k for k, _ in axes]
    return [dict(zip(keys, combo))
            for combo in itertools.product(*[vs for _, vs in axes])]


def parse_grid(spec):
    """"hosts=100:1000,fail_rate=0.001,tau=4:16" -> list of cell dicts
    (the Cartesian product over every axis, in spec order)."""
    return _parse_axes(spec, INT_KEYS, FLOAT_KEYS)


def parse_serve_grid(spec):
    """The serving-fleet variant, e.g.
    "replicas=2:4,lease_s=1:3,trace=spike:flash,kill_replica=1"."""
    return _parse_axes(spec, SERVE_INT_KEYS, SERVE_FLOAT_KEYS,
                       SERVE_STR_KEYS)


def run_cell(cell, metrics=None, log_fn=None):
    """One sweep cell -> FleetSim summary (with the cell echoed and the
    real wall seconds it cost)."""
    kw = dict(cell)
    chaos_bits = [f"{k}={kw.pop(k)}" for k in CHAOS_KEYS if k in kw]
    t0 = time.time()
    sim = FleetSim(chaos=",".join(chaos_bits) or None,
                   metrics=metrics, log_fn=log_fn, **kw)
    out = sim.run()
    out["cell"] = dict(cell)
    out["real_s"] = round(time.time() - t0, 2)
    return out


def run_serve_cell(cell, metrics=None, log_fn=None):
    """One serving-fleet sweep cell -> ServeFleetSim summary."""
    from .servefleet import ServeFleetSim
    kw = dict(cell)
    chaos_bits = [f"{k}={kw.pop(k)}" for k in SERVE_CHAOS_KEYS
                  if k in kw]
    t0 = time.time()
    sim = ServeFleetSim(chaos=",".join(chaos_bits) or None,
                        metrics=metrics, log_fn=log_fn, **kw)
    out = sim.run()
    out["cell"] = dict(cell)
    out["real_s"] = round(time.time() - t0, 2)
    return out


def run_sweep(cells, metrics=None, log_fn=None, budget_s=None,
              cell_fn=None):
    """Run the cells in order, stopping early (and saying so) when the
    real wall budget is exhausted — a bounded study never silently
    reads as a complete one. ``cell_fn`` picks the simulator (default:
    the training-fleet FleetSim via run_cell)."""
    log = log_fn or (lambda *a: None)
    cell_fn = cell_fn or run_cell
    out = []
    t0 = time.time()
    for i, cell in enumerate(cells):
        if budget_s is not None and time.time() - t0 >= budget_s:
            log(f"sweep: wall budget {budget_s:g}s exhausted after "
                f"{i}/{len(cells)} cells; {len(cells) - i} cell(s) "
                "NOT run")
            break
        log(f"sweep: cell {i + 1}/{len(cells)}: {cell}")
        out.append(cell_fn(cell, metrics=metrics, log_fn=log_fn))
    return out


_COLS = (("hosts", "hosts"), ("rounds", "rounds"), ("lease_s", "lease"),
         ("quorum", "quorum"), ("evictions", "evict"),
         ("readmissions", "readmit"), ("admissions", "admit"),
         ("parks", "park"), ("live_final", "live"),
         ("quorum_lost", "qlost"), ("real_s", "real_s"))


def render_table(results):
    """The sweep results as an aligned text table (one row per cell),
    with the gate-wait tail — the metric lease tuning trades against —
    pulled out explicitly."""
    rows = []
    for s in results:
        row = [str(s.get(k, "")) for k, _ in _COLS]
        row.insert(4, f"{s['gate_wait_s']['p95']:.3f}")
        row.insert(5, f"{s['gate_wait_s']['max']:.3f}")
        cell = s.get("cell", {})
        row.append(",".join(f"{k}={v}" for k, v in cell.items()
                            if k in CHAOS_KEYS + ("tau", "staleness"))
                   or "-")
        rows.append(row)
    hdr = [h for _, h in _COLS]
    hdr.insert(4, "wait_p95")
    hdr.insert(5, "wait_max")
    hdr.append("chaos/tau/s")
    widths = [max(len(hdr[i]), *(len(r[i]) for r in rows)) if rows
              else len(hdr[i]) for i in range(len(hdr))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(hdr, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


_SERVE_COLS = (("replicas", "reps"), ("replicas_final", "final"),
               ("trace", "trace"), ("rate", "rate"),
               ("lease_s", "lease"), ("arrivals", "arrive"),
               ("ok", "ok"), ("rejected", "rej"), ("errors", "err"),
               ("retries", "retry"), ("lost", "lost"),
               ("availability", "avail"), ("p99_ms", "p99_ms"),
               ("evictions", "evict"), ("admissions", "admit"),
               ("grow", "grow"), ("shrink", "shrink"),
               ("canary_rollbacks", "rollbk"), ("real_s", "real_s"))


def render_serve_table(results):
    """The serving-fleet sweep as an aligned table — the
    "no lost request without a 429" evidence rows (lost must read 0
    in every cell)."""
    rows = []
    for s in results:
        row = [str(s.get(k, "")) for k, _ in _SERVE_COLS]
        cell = s.get("cell", {})
        row.append(",".join(
            f"{k}={v}" for k, v in cell.items()
            if k in SERVE_CHAOS_KEYS + ("die_w", "rejoin_w",
                                        "canary_w", "spike_x")) or "-")
        rows.append(row)
    hdr = [h for _, h in _SERVE_COLS] + ["chaos/schedule"]
    widths = [max(len(hdr[i]), *(len(r[i]) for r in rows)) if rows
              else len(hdr[i]) for i in range(len(hdr))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(hdr, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)
