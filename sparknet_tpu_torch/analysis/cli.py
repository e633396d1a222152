"""`sparknet_tpu_torch lint` — the CLI face of sparknet_tpu_torch.analysis.

Exit codes (scripts/lint.sh relies on them):
  0  clean, modulo the baseline
  1  findings — errors always; warnings too under --strict; under
     --strict also stale or unjustified baseline entries
  2  usage / baseline-file errors

Deliberately jax-free: linting runs on checkout hosts (CI, laptops)
with no accelerator stack, like `sparknet monitor`.
"""

import json
import os
import sys

from .engine import LintEngine, ALL_CODES, all_rules, SEVERITY_ERROR
from .baseline import Baseline

DEFAULT_BASELINE = ".sparknet-torch-lint-baseline.json"
DEFAULT_CACHE = ".sparknet-torch-lint-cache.json"

# --select profiles: the relaxed per-tree rule sets scripts/lint.sh
# applies outside the package source. Tests monkeypatch state and poke
# internals on purpose, so only the parse + file-protocol + exit-code
# rules hold there; tools/experiments additionally get the host-sync
# JAX hazard rules.
SELECT_PROFILES = {
    "@tests": {"SPK001", "SPK301", "SPK302", "SPK304"},
    "@tools": {"SPK001", "SPK101", "SPK103", "SPK104", "SPK105",
               "SPK301", "SPK302", "SPK303", "SPK304"},
}


def default_target():
    """With no paths given, lint the installed sparknet_tpu_torch package —
    which, in a checkout, IS the repo source tree. Returns
    (paths, root) with root chosen so finding paths render as
    'sparknet_tpu_torch/...' (the form the committed baseline uses)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [pkg], os.path.dirname(pkg)


def _find_baseline(paths, root):
    """Default baseline file: next to the lint root, then the CWD."""
    for d in (root, os.getcwd()):
        p = os.path.join(d, DEFAULT_BASELINE)
        if os.path.exists(p):
            return p
    return os.path.join(root, DEFAULT_BASELINE)


def list_rules(out=print):
    all_rules()
    out(f"{'code':<8}{'severity':<10}rule")
    for code in sorted(ALL_CODES):
        name, severity, help_ = ALL_CODES[code]
        out(f"{code:<8}{severity:<10}{name}")
        first = " ".join((help_ or "").split(". ")[0].split())
        if first:
            out(f"{'':<18}{first if first.endswith('.') else first + '.'}")
    return 0


def run_lint(args, out=print, err=None):
    """Drive one lint run from parsed CLI args (see cli.py's `lint`
    subparser). Returns the process exit code."""
    err = err or (lambda s: print(s, file=sys.stderr))
    if args.list_rules:
        return list_rules(out)
    if args.paths:
        paths = [os.path.abspath(p) for p in args.paths]
        for p in paths:
            if not os.path.exists(p):
                err(f"sparknet lint: error: no such path: {p}")
                return 2
        root = os.path.abspath(args.root) if args.root else os.getcwd()
    else:
        paths, root = default_target()
        if args.root:
            root = os.path.abspath(args.root)
    if getattr(args, "write_event_schema", False):
        from .metrics_rules import write_event_schema
        path = write_event_schema(root)
        out(f"event schema written: {path}")
        return 0
    select = None
    if args.select:
        select = set()
        for c in args.select.split(","):
            c = c.strip()
            if not c:
                continue
            if c.lower() in SELECT_PROFILES:
                select |= SELECT_PROFILES[c.lower()]
            else:
                select.add(c.upper())
        all_rules()
        unknown = select - set(ALL_CODES) - {"SPK001"}
        if unknown:
            err(f"sparknet lint: error: unknown rule code(s) or "
                f"profile(s): {', '.join(sorted(unknown))}")
            return 2

    cache_path = None
    if getattr(args, "cache", False):
        cache_path = os.path.join(root, DEFAULT_CACHE)

    engine = LintEngine(select=select,
                        exclude=getattr(args, "exclude", None),
                        jobs=getattr(args, "jobs", 1) or 1,
                        cache_path=cache_path)
    findings = engine.run(paths, root=root)

    baseline_path = args.baseline or _find_baseline(paths, root)
    try:
        baseline = Baseline.load(baseline_path)
    except ValueError as e:
        err(f"sparknet lint: error: {e}")
        return 2
    new, baselined, stale = baseline.split(findings)

    if args.write_baseline:
        added, expired = baseline.update(findings,
                                         justification=args.justification)
        baseline.save(baseline_path)
        out(f"baseline written: {baseline_path} "
            f"({len(baseline.entries)} entries, +{added} added, "
            f"-{expired} expired)")
        if added and not args.justification:
            out("note: new entries carry a placeholder justification; "
                "edit the baseline file — --strict will refuse it")
        return 0

    if args.json:
        out(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in baselined],
            "stale_baseline": sorted(stale),
        }, indent=2))
    else:
        for f in new:
            out(f.render())
        if args.verbose:
            for f in baselined:
                just = baseline.entries[f.fingerprint()].get(
                    "justification", "")
                out(f"{f.render()}  [baselined: {just}]")
        for fp in sorted(stale):
            e = stale[fp]
            out(f"stale baseline entry {fp}: {e.get('code')} "
                f"{e.get('path')} ({e.get('symbol')}) — finding no "
                "longer exists; run --write-baseline to expire it")

    errors = sum(1 for f in new if f.severity == SEVERITY_ERROR)
    warns = len(new) - errors
    unjustified = baseline.unjustified() if args.strict else {}
    if not args.json:
        bits = [f"{len(new)} finding{'s' if len(new) != 1 else ''}",
                f"{errors} error{'s' if errors != 1 else ''}",
                f"{warns} warning{'s' if warns != 1 else ''}"]
        if baselined:
            bits.append(f"{len(baselined)} baselined")
        if stale:
            bits.append(f"{len(stale)} stale baseline "
                        f"entr{'ies' if len(stale) != 1 else 'y'}")
        out("sparknet lint: " + ", ".join(bits))
        if unjustified:
            for fp in sorted(unjustified):
                out(f"unjustified baseline entry {fp}: "
                    f"{unjustified[fp].get('code')} "
                    f"{unjustified[fp].get('path')} — every accepted "
                    "finding needs a written justification")

    if args.strict:
        if new or stale or unjustified:
            return 1
        return 0
    return 1 if errors else 0
