"""SPK4xx — metrics-schema rules, plus the event-registry generator.

The metrics pipeline is stringly-typed end to end: producers call
``metrics.log("host_round", host=..., round=...)`` and the consumers
(obs/report.py's aggregations, obs/monitor.py's live panes) filter on
those names with ``e.get("event") == "host_round"``. Nothing checks
the two sides agree — a renamed event or a typo'd consumer silently
reports zeros forever (the ``host_alive``/``host-alive`` class of bug).

The ProjectIndex collects every emit site via constant propagation
(literal first argument, or a name resolving to one), giving a
*registry* of event names and their field sets. Two rules compare the
sides:

  SPK401 (error)  a consumer filters on an event/kind string nobody
                  emits (checked against the live registry ∪ the
                  committed schema — the schema covers emitters
                  outside the lint target, e.g. repo-root bench.py)
  SPK402 (error)  an emit site drifts from the committed schema: the
                  event is unregistered, or it passes fields the
                  schema doesn't list — regenerate the schema
                  (``sparknet lint --write-event-schema``) and commit

The registry is also materialized as a generated module,
``sparknet_tpu_torch/obs/event_schema.py``, consumed by the runtime
regression tests (tests/test_torch_obs.py, tests/test_torch_lint.py). Both rules
resolve that file package-relative, so fixture runs with a different
root still see it.
"""

import ast
import os

from .engine import rule, make_finding, SEVERITY_ERROR


def _package_dir():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def schema_path():
    return os.path.join(_package_dir(), "obs", "event_schema.py")


_SCHEMA_CACHE = {}


def load_schema(path=None):
    """The committed registry as ``{"events": {...}, "kinds": set,
    "kinds_open": bool}``, or None when no schema file exists yet."""
    path = path or schema_path()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    cached = _SCHEMA_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read())
    data = {"events": {}, "kinds": set(), "kinds_open": False}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        try:
            val = ast.literal_eval(node.value)
        except (ValueError, SyntaxError):
            continue
        if name == "EVENTS":
            data["events"] = val
        elif name == "KINDS":
            data["kinds"] = set(val)
        elif name == "KINDS_OPEN":
            data["kinds_open"] = bool(val)
    _SCHEMA_CACHE[path] = (mtime, data)
    return data


# -- consumer extraction ----------------------------------------------------

_DOMAINS = ("event", "kind")


def _get_domain(call):
    """'event'/'kind' when ``call`` is ``<x>.get("event"|"kind", ...)``."""
    if isinstance(call, ast.Call) and \
            isinstance(call.func, ast.Attribute) and \
            call.func.attr == "get" and call.args and \
            isinstance(call.args[0], ast.Constant) and \
            call.args[0].value in _DOMAINS:
        return call.args[0].value
    return None


def _subscript_domain(node):
    if isinstance(node, ast.Subscript) and \
            isinstance(node.slice, ast.Constant) and \
            node.slice.value in _DOMAINS:
        return node.slice.value
    return None


def _literal_strs(node):
    """The string constants a comparator contributes: a literal, or a
    tuple/list/set of literals. Non-literal members poison the whole
    comparator (return None → don't judge)."""
    if isinstance(node, ast.Constant):
        return [node.value] if isinstance(node.value, str) else None
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


def iter_consumer_checks(tree):
    """Yield ``(node, domain, name)`` for every comparison of an
    event/kind lookup against a string literal anywhere in ``tree``:
    direct (``e.get("event") == "train"``, ``ev["kind"] in (...)``) and
    through a local (``kind = ev.get("event", "?")`` then
    ``kind == "train"`` / ``if kind in ("a", "b")``). This is the one
    implementation of "what names do the consumers filter on" — the
    lint rule and the runtime regression test both use it."""
    # pass 1: locals assigned from a domain lookup, per function scope
    var_domain = {}                     # (scope id, var) -> domain
    # map every node to its enclosing function via a parent walk
    enclosing = {}

    def _mark(node, scope):
        for child in ast.iter_child_nodes(node):
            s = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope
            enclosing[id(child)] = scope
            _mark(child, s)

    _mark(tree, None)

    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name):
            dom = _get_domain(n.value) or _subscript_domain(n.value)
            if dom is not None:
                var_domain[(id(enclosing.get(id(n))),
                            n.targets[0].id)] = dom

    def node_domain(node, scope_key):
        dom = _get_domain(node) or _subscript_domain(node)
        if dom is not None:
            return dom
        if isinstance(node, ast.Name):
            return var_domain.get((scope_key, node.id))
        return None

    # pass 2: comparisons
    for n in ast.walk(tree):
        if not isinstance(n, ast.Compare):
            continue
        scope_key = id(enclosing.get(id(n)))
        sides = [n.left] + list(n.comparators)
        for i, op in enumerate(n.ops):
            if not isinstance(op, (ast.Eq, ast.NotEq, ast.In, ast.NotIn)):
                continue
            a, b = sides[i], sides[i + 1]
            for lookup, lits in ((a, b), (b, a)):
                dom = node_domain(lookup, scope_key)
                if dom is None:
                    continue
                names = _literal_strs(lits)
                if names is None:
                    continue
                for name in names:
                    yield n, dom, name


@rule("SPK401", "unknown-event-consumer", SEVERITY_ERROR)
def unknown_event_consumer(module, ctx):
    """A consumer filters on an event (or kind) name that no emit site
    produces — the filter matches nothing, the report/pane shows zeros,
    and nobody notices. Known names = the live emit registry of this
    lint run ∪ the committed event schema (which covers emitters
    outside the lint target, like repo-root bench.py)."""
    proj = ctx.project
    schema = load_schema()
    known_events = set(proj.events)
    known_kinds = set(proj.kinds)
    kinds_open = proj.kinds_open
    events_open = any(s.event is None for s in proj.emit_sites)
    if schema is not None:
        known_events |= set(schema["events"])
        known_kinds |= schema["kinds"]
        kinds_open = kinds_open or schema["kinds_open"]
    # placeholder sentinels consumers use for "anything else"
    known_events |= {"?", ""}
    known_kinds |= {"?", ""}
    for node, dom, name in iter_consumer_checks(module.tree):
        if dom == "event":
            if events_open or name in known_events:
                continue
            universe = "emit site"
        else:
            if kinds_open or name in known_kinds:
                continue
            universe = "kind= emit"
        yield make_finding(
            unknown_event_consumer, module,
            f"consumer filters on {dom} `{name}` but no {universe} "
            "produces it — typo, or the producer was renamed; fix the "
            "name or regenerate the event schema",
            node=node, symbol="")


@rule("SPK402", "event-schema-drift", SEVERITY_ERROR)
def event_schema_drift(module, ctx):
    """An emit site disagrees with the committed event schema: the
    event name is unregistered, or the site passes fields the schema
    doesn't list for it. Regenerate and commit the schema
    (``sparknet lint --write-event-schema``) so consumers and the
    runtime regression test see the new shape."""
    schema = load_schema()
    if schema is None:
        return
    events = schema["events"]
    for site in ctx.project.emit_sites:
        if site.relpath != module.relpath or site.event is None:
            continue
        reg = events.get(site.event)
        if reg is None:
            yield make_finding(
                event_schema_drift, module,
                f"emit site for event `{site.event}` is not in the "
                "committed event schema — run `sparknet lint "
                "--write-event-schema` and commit the result",
                node=site.node, symbol="")
            continue
        if reg.get("open"):
            continue
        extra = sorted(set(site.fields) - set(reg.get("fields", ())))
        if site.open_fields:
            yield make_finding(
                event_schema_drift, module,
                f"emit site for `{site.event}` forwards **kwargs but "
                "the committed schema lists a closed field set — "
                "regenerate the event schema",
                node=site.node, symbol="")
        elif extra:
            yield make_finding(
                event_schema_drift, module,
                f"emit site for `{site.event}` passes fields "
                f"{extra} not in the committed schema — regenerate "
                "the event schema and commit it",
                node=site.node, symbol="")


# -- registry generation ----------------------------------------------------

def build_registry(repo_root):
    """Scan the package plus repo-root scripts and return the registry
    dict the schema module is rendered from."""
    from .engine import LintEngine, Module
    from .project import ProjectIndex
    pkg = _package_dir()
    targets = [pkg]
    for fn in sorted(os.listdir(repo_root)):
        if fn.endswith(".py"):
            targets.append(os.path.join(repo_root, fn))
    modules = []
    for path in LintEngine().collect_files(targets):
        if os.path.abspath(path) == os.path.abspath(schema_path()):
            continue                    # never self-feed the registry
        try:
            modules.append(Module.load(path, repo_root))
        except (SyntaxError, ValueError, UnicodeDecodeError):
            continue
    proj = ProjectIndex(modules)
    events = {}
    for name in sorted(proj.events):
        e = proj.events[name]
        events[name] = {
            "fields": sorted(e["fields"]),
            "open": bool(e["open"]),
            "sites": sorted(e["sites"]),
        }
    return {"events": events, "kinds": sorted(proj.kinds),
            "kinds_open": bool(proj.kinds_open)}


def render_schema(registry):
    """The generated module's source text, deterministic."""
    lines = [
        '"""Metrics event registry — GENERATED, do not edit by hand.',
        "",
        "Every event name the repo emits via ``metrics.log(...)`` with",
        "the union of field names seen at its emit sites (``open`` =",
        "some site forwards **kwargs, so the field set is not closed).",
        "Consumers (obs/report.py, obs/monitor.py) may only filter on",
        "names in this registry — lint rule SPK401 and",
        "tests/test_torch_obs.py both enforce it; the latter also holds",
        "it equal to the JAX package's registry.",
        "",
        "Regenerate with:  python -m sparknet_tpu_torch lint"
        " --write-event-schema",
        '"""',
        "",
        "EVENTS = {",
    ]
    for name, info in registry["events"].items():
        lines.append(f"    {name!r}: {{")
        lines.append(f"        \"fields\": {info['fields']!r},")
        lines.append(f"        \"open\": {info['open']!r},")
        lines.append("    },")
    lines.append("}")
    lines.append("")
    lines.append(f"KINDS = {registry['kinds']!r}")
    lines.append("")
    lines.append(f"KINDS_OPEN = {registry['kinds_open']!r}")
    lines.append("")
    return "\n".join(lines)


def write_event_schema(repo_root, out_path=None):
    """Generate and write the schema module; returns the path."""
    out_path = out_path or schema_path()
    content = render_schema(build_registry(repo_root))
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(content)
    return out_path
