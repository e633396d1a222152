"""SPK2xx — lock-discipline race checker for the threaded host side.

The solver loop shares host state with the watchdog monitor thread,
the prefetch workers, the metrics logger and the live monitor's tailer.
The discipline is annotation-driven, GuardedBy-style (ErrorProne /
Tricorder lineage):

  self._last = 0.0          # spk: guarded-by=_lock

declares that ``self._last`` may only be touched inside a
``with self._lock:`` block. A class-wide default exists for state
holders whose every field is shared:

  class MonitorState:
      # spk: guarded-by-default=_lock

(every field assigned in ``__init__`` becomes guarded, except the lock
itself, sync primitives, and lines annotated ``# spk: unguarded``).

Thread entry points are methods passed as ``target=self.m`` to
``threading.Thread`` plus methods annotated ``# spk: thread-entry``
(for cross-object handoffs the checker cannot see, e.g. a closure in
another function calling ``state.update``); reachability closes over
``self.m()`` calls.

Rules:
  SPK201 (error)  guarded field accessed without its lock in a method
                  reachable from a thread entry point — a data race
  SPK202 (warn)   guarded field accessed without its lock elsewhere
                  (the main-thread side of the same race; __init__ and
                  __del__ are exempt — the object isn't shared yet)
  SPK203 (warn)   guarded-by names a lock the class never creates —
                  a stale annotation to fix or narrow
  SPK204 (warn)   a field written both by thread-reachable and other
                  methods with no guarded-by at all — the checker's
                  "you have an unannotated shared field" tripwire

Known scope limits, on purpose: accesses through aliases
(``x = self.f``) and from *outside* the class are not tracked — the
annotation contract is that shared fields are touched via methods.
"""

import ast
import re

from .engine import (rule, make_finding, SEVERITY_ERROR, SEVERITY_WARN)

_GUARD_RE = re.compile(r"#\s*spk:\s*guarded-by\s*=\s*(\w+)")
_GUARD_DEFAULT_RE = re.compile(r"#\s*spk:\s*guarded-by-default\s*=\s*(\w+)")
_UNGUARDED_RE = re.compile(r"#\s*spk:\s*unguarded\b")
_THREAD_ENTRY_RE = re.compile(r"#\s*spk:\s*thread-entry\b")
_HOLDS_RE = re.compile(r"#\s*spk:\s*holds\s*=\s*(\w+)")

_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_SYNC_CTORS = _LOCK_CTORS | {"Event", "Semaphore", "BoundedSemaphore",
                             "Barrier", "Queue", "LifoQueue",
                             "PriorityQueue", "SimpleQueue",
                             "local", "Thread"}


def _ctor_basename(value):
    node = value
    while isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
        return None
    return None


class ClassInfo:
    """Everything SPK201-204 need to know about one class."""

    def __init__(self, module, node):
        self.module = module
        self.node = node
        self.name = node.name
        self.guards = {}          # field -> lock attr name
        self.unguarded = set()    # fields explicitly opted out
        self.locks = set()        # lock attrs the class creates
        self.sync_fields = set()  # Lock/Event/Queue/... fields
        self.methods = {}         # name -> FunctionDef
        self.entries = set()      # thread entry method names
        self.holds = {}           # method -> lock it requires held
        self.guard_lines = {}     # field -> annotation line (for SPK203)
        self._collect()

    def _collect(self):
        default_guard = None
        for i in range(self.node.lineno,
                       self._end_line() + 1):
            m = _GUARD_DEFAULT_RE.search(self.module.line_text(i))
            if m:
                default_guard = m.group(1)
                break
        for item in self.node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item
                if _THREAD_ENTRY_RE.search(
                        self.module.line_text(item.lineno)):
                    self.entries.add(item.name)
                hm = _HOLDS_RE.search(self.module.line_text(item.lineno))
                if hm:
                    self.holds[item.name] = hm.group(1)
        # field discovery: every `self.X = ...` in any method (guards
        # usually sit in __init__ but setters re-assign too)
        for mname, mnode in self.methods.items():
            for n in ast.walk(mnode):
                if not isinstance(n, ast.Assign):
                    continue
                for t in n.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    field = t.attr
                    text = self.module.line_text(n.lineno)
                    ctor = _ctor_basename(n.value)
                    if ctor in _LOCK_CTORS:
                        self.locks.add(field)
                    if ctor in _SYNC_CTORS:
                        self.sync_fields.add(field)
                    gm = _GUARD_RE.search(text)
                    if gm:
                        self.guards[field] = gm.group(1)
                        self.guard_lines.setdefault(field, n.lineno)
                    elif _UNGUARDED_RE.search(text):
                        self.unguarded.add(field)
                    elif default_guard and mname == "__init__" \
                            and field != default_guard \
                            and ctor not in _SYNC_CTORS:
                        self.guards.setdefault(field, default_guard)
                        self.guard_lines.setdefault(field, n.lineno)
        self.unguarded -= set(self.guards)
        for f in self.unguarded:
            self.guards.pop(f, None)

    def _end_line(self):
        return getattr(self.node, "end_lineno", self.node.lineno)

    def thread_reachable(self):
        """Method names reachable from the thread entry points via
        self.m() calls (the intra-class call graph)."""
        reach = set(self.entries)
        changed = True
        while changed:
            changed = False
            for name in list(reach):
                mnode = self.methods.get(name)
                if mnode is None:
                    continue
                for n in ast.walk(mnode):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and isinstance(n.func.value, ast.Name) \
                            and n.func.value.id == "self" \
                            and n.func.attr in self.methods \
                            and n.func.attr not in reach:
                        reach.add(n.func.attr)
                        changed = True
        return reach


def _classes(module):
    cache = getattr(module, "_thread_classes", None)
    if cache is not None:
        return cache
    cache = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef):
            cache.append(ClassInfo(module, node))
    # `target=self._run` thread creations can appear anywhere in the
    # module (even another class/function); attribute them by method
    # name to every class defining that method
    targets = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name != "Thread":
                continue
            for kw in node.keywords:
                if kw.arg == "target" and \
                        isinstance(kw.value, ast.Attribute) and \
                        isinstance(kw.value.value, ast.Name) and \
                        kw.value.value.id == "self":
                    targets.add(kw.value.attr)
    for ci in cache:
        ci.entries |= {t for t in targets if t in ci.methods}
    module._thread_classes = cache
    return cache


def _held_locks_walk(method, visit, initial_held=frozenset()):
    """Walk ``method``'s body tracking the set of self.<lock> names
    held via `with self.<lock>:` blocks; calls visit(node, held) on
    every node. Nested function defs inherit the held set at their
    definition point only if they are immediately-invoked — otherwise
    they run later on an unknown thread, so they get an empty held set
    (conservative for closures handed to Thread(target=...))."""

    def lock_names(withnode):
        names = []
        for item in withnode.items:
            e = item.context_expr
            if isinstance(e, ast.Attribute) and \
                    isinstance(e.value, ast.Name) and e.value.id == "self":
                names.append(e.attr)
        return names

    def walk(node, held):
        visit(node, held)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held | set(lock_names(node))
            for item in node.items:
                walk(item.context_expr, held)
                if item.optional_vars:
                    walk(item.optional_vars, held)
            for b in node.body:
                walk(b, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not method:
            body = node.body if isinstance(node.body, list) \
                else [node.body]
            for b in body:
                walk(b, frozenset())
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for b in method.body:
        walk(b, frozenset(initial_held))


@rule("SPK201", "lock-discipline", SEVERITY_ERROR)
def lock_discipline(module, ctx):
    """Guarded field accessed outside its `with <lock>:` block in a
    method reachable from a thread entry point — two threads can be in
    here at once, so this is a data race on the annotated field."""
    yield from _guard_findings(module, reachable_only=True,
                               fn=lock_discipline)


@rule("SPK202", "lock-discipline-main", SEVERITY_WARN)
def lock_discipline_main(module, ctx):
    """Guarded field accessed outside its lock in a method NOT on any
    thread path — the main-thread half of the same race (the other
    thread can still interleave). __init__/__del__ are exempt: the
    object isn't shared yet/anymore."""
    yield from _guard_findings(module, reachable_only=False,
                               fn=lock_discipline_main)


def _guard_findings(module, reachable_only, fn):
    for ci in _classes(module):
        if not ci.guards:
            continue
        reach = ci.thread_reachable()
        for mname, mnode in ci.methods.items():
            if mname in ("__init__", "__del__"):
                continue
            in_reach = mname in reach
            if reachable_only != in_reach:
                continue
            hits = []

            def visit(node, held, _hits=hits, _ci=ci):
                if isinstance(node, ast.Attribute) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == "self" and \
                        node.attr in _ci.guards and \
                        _ci.guards[node.attr] not in held:
                    _hits.append((node, node.attr,
                                  _ci.guards[node.attr], "field"))
                # calling a `# spk: holds=<lock>` helper without the
                # lock breaks its contract just like a naked access
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id == "self" and \
                        node.func.attr in _ci.holds and \
                        _ci.holds[node.func.attr] not in held:
                    _hits.append((node, node.func.attr,
                                  _ci.holds[node.func.attr], "holds"))

            # `# spk: holds=<lock>` on the def line: a private helper
            # whose contract is "only called with <lock> held" — the
            # checker trusts the annotation and verifies the callers
            # (they must wrap the call in `with self.<lock>:`)
            held0 = set()
            hm = _HOLDS_RE.search(module.line_text(mnode.lineno))
            if hm:
                held0.add(hm.group(1))
            _held_locks_walk(mnode, visit, initial_held=held0)
            for node, what, lock, kind in hits:
                where = "thread-reachable " if reachable_only else ""
                noun = "field" if kind == "field" else \
                    "lock-requiring helper"
                verb = "accessed" if kind == "field" else "called"
                yield make_finding(
                    fn, module,
                    f"{noun} `{what}` (guarded-by `{lock}`) "
                    f"{verb} without holding `self.{lock}` in "
                    f"{where}method `{ci.name}.{mname}`",
                    node=node, symbol=f"{ci.name}.{mname}")


@rule("SPK203", "stale-guard-annotation", SEVERITY_WARN)
def stale_guard_annotation(module, ctx):
    """A guarded-by annotation names a lock attribute the class never
    creates (threading.Lock/RLock/Condition assignment) — either the
    lock was renamed/removed or the annotation should be narrowed
    away."""
    for ci in _classes(module):
        for field, lock in sorted(ci.guards.items()):
            if lock not in ci.locks:
                yield make_finding(
                    stale_guard_annotation, module,
                    f"field `{field}` is guarded-by `{lock}` but "
                    f"`{ci.name}` never creates `self.{lock}` as a "
                    "Lock/RLock/Condition",
                    line=ci.guard_lines.get(field, ci.node.lineno),
                    symbol=f"{ci.name}")


@rule("SPK204", "unannotated-shared-write", SEVERITY_WARN)
def unannotated_shared_write(module, ctx):
    """A field written both from a thread-reachable method and from a
    non-thread method, with no guarded-by annotation: the checker can't
    prove anything about it, and that pattern is exactly how the
    watchdog's `_last` race looked. Annotate it (and lock the
    accesses) or mark it `# spk: unguarded` with a reason."""
    for ci in _classes(module):
        if not ci.entries:
            continue
        reach = ci.thread_reachable()
        writes_in, writes_out = {}, {}
        for mname, mnode in ci.methods.items():
            if mname in ("__init__", "__del__"):
                continue
            sink = writes_in if mname in reach else writes_out
            for n in ast.walk(mnode):
                targets = []
                if isinstance(n, ast.Assign):
                    targets = n.targets
                elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                    targets = [n.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        sink.setdefault(t.attr, n)
        for field in sorted(set(writes_in) & set(writes_out)):
            if field in ci.guards or field in ci.unguarded \
                    or field in ci.sync_fields:
                continue
            node = writes_in[field]
            yield make_finding(
                unannotated_shared_write, module,
                f"field `{field}` of `{ci.name}` is written both from "
                "thread-reachable and main-thread methods with no "
                "guarded-by annotation — annotate it (spk: guarded-by="
                "<lock>) or mark it `spk: unguarded` with a reason",
                node=node, symbol=f"{ci.name}")


# -- SPK205-207: the cross-module deadlock family ---------------------------
#
# These three run on the ProjectIndex (ctx.project): lock-acquisition
# edges follow resolved call edges across methods and classes, so a
# cycle split between heartbeat and the consensus helper it calls is
# still one cycle.


def _lock_graph(ctx):
    """{(class, lock): {(class, lock): (relpath, line, via)}} — edge
    A->B when some method acquires B while holding A, directly or
    through a resolved callee. Built once per lint run."""
    proj = ctx.project
    cached = getattr(proj, "_lock_graph", None)
    if cached is not None:
        return cached
    edges = {}

    def add(src, dst, relpath, line, via):
        edges.setdefault(src, {}).setdefault(dst, (relpath, line, via))

    for fi in proj.functions.values():
        if fi.cls is None:
            continue
        cls = fi.cls
        module = proj.modules.get(fi.relpath)
        held0 = set()
        hm = _HOLDS_RE.search(module.line_text(fi.node.lineno))
        if hm:
            held0.add(hm.group(1))

        def visit(node, held, _cls=cls, _mod=module, _fi=fi):
            held_locks = {h for h in held if h in _cls.locks}
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    e = item.context_expr
                    if isinstance(e, ast.Attribute) and \
                            isinstance(e.value, ast.Name) and \
                            e.value.id == "self" and \
                            e.attr in _cls.locks:
                        for h in held_locks:
                            add((_cls.name, h), (_cls.name, e.attr),
                                _fi.relpath, node.lineno,
                                _fi.qualname)
            elif isinstance(node, ast.Call) and held_locks:
                target = proj.resolve_call(node, _mod, _fi.node)
                if target is None:
                    return
                for dst in proj.transitive_acquires(target.key):
                    for h in held_locks:
                        add((_cls.name, h), dst, _fi.relpath,
                            node.lineno, target.qualname)

        _held_locks_walk(fi.node, visit, initial_held=held0)
    proj._lock_graph = edges
    return edges


def _sccs(edges):
    """Tarjan SCCs of the lock graph (iterative)."""
    index, low, on_stack = {}, {}, set()
    stack, out, counter = [], [], [0]
    nodes = set(edges)
    for tgts in edges.values():
        nodes |= set(tgts)

    def strongconnect(v0):
        work = [(v0, iter(edges.get(v0, ())))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on_stack.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(edges.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)
    return out


def _cycle_path(edges, start, comp):
    """One concrete simple cycle through ``start`` inside SCC ``comp``."""
    comp = set(comp)
    path, seen = [start], {start}
    v = start
    while True:
        nxt = None
        for w in sorted(edges.get(v, ())):
            if w == start and len(path) > 1:
                return path
            if w in comp and w not in seen:
                nxt = w
                break
        if nxt is None:
            return path
        path.append(nxt)
        seen.add(nxt)
        v = nxt


@rule("SPK205", "lock-order-cycle", SEVERITY_ERROR)
def lock_order_cycle(module, ctx):
    """Two locks are acquired in opposite orders on different paths
    (following resolved call edges across methods and classes), or a
    non-reentrant lock is re-acquired while already held — a deadlock
    waiting for the right interleaving. Fix by ordering every path the
    same way, or by narrowing one side to drop its lock first."""
    edges = _lock_graph(ctx)
    # self-edges: re-acquiring a non-reentrant lock you already hold
    for src in sorted(edges):
        info = edges[src].get(src)
        if info is None:
            continue
        relpath, line, via = info
        if relpath != module.relpath:
            continue
        cname, lock = src
        ctor = None
        for cf in ctx.project.classes_by_name.get(cname, []):
            ctor = cf.sync_ctors.get(lock, ctor)
        if ctor == "RLock":
            continue
        yield make_finding(
            lock_order_cycle, module,
            f"`{cname}.{lock}` ({ctor or 'Lock'}) is re-acquired via "
            f"`{via}` while already held — non-reentrant locks "
            "self-deadlock here",
            line=line, symbol=f"{cname}.{lock}")
    # multi-node SCCs: a genuine ordering cycle
    for comp in _sccs(edges):
        if len(comp) < 2:
            continue
        anchor = None          # smallest (relpath, line) edge in SCC
        cset = set(comp)
        for a in comp:
            for b, (relpath, line, _via) in edges.get(a, {}).items():
                if b in cset:
                    k = (relpath, line, a, b)
                    if anchor is None or k < anchor:
                        anchor = k
        if anchor is None or anchor[0] != module.relpath:
            continue
        path = _cycle_path(edges, anchor[2], comp)
        names = [f"`{c}.{l}`" for c, l in path] + \
            [f"`{path[0][0]}.{path[0][1]}`"]
        legs = []
        for i in range(len(path)):
            a = path[i]
            b = path[(i + 1) % len(path)]
            relpath, line, via = edges[a][b]
            legs.append(f"{relpath}:{line} (via `{via}`)")
        yield make_finding(
            lock_order_cycle, module,
            "lock-order cycle " + " -> ".join(names) +
            "; acquired at " + ", ".join(legs),
            line=anchor[1], symbol=f"{anchor[2][0]}.{anchor[2][1]}")


@rule("SPK206", "blocking-call-under-lock", SEVERITY_ERROR)
def blocking_call_under_lock(module, ctx):
    """A lock is held across a call that can block indefinitely —
    sleep, file I/O, a thread join, a queue get, an event wait — found
    transitively through resolved call edges. Every other thread
    touching that lock now stalls behind the slow operation (the
    heartbeat writer stalling the solver loop on a slow NFS fsync is
    the canonical case). Snapshot state under the lock, do the blocking
    work outside it."""
    proj = ctx.project
    for ci in _classes(module):
        if not ci.locks:
            continue
        for mname, mnode in ci.methods.items():
            fkey = (module.relpath, f"{ci.name}.{mname}")
            hits = []

            def visit(node, held, _ci=ci, _mnode=mnode, _hits=hits):
                held_locks = {h for h in held if h in _ci.locks}
                if not held_locks or not isinstance(node, ast.Call):
                    return
                # Condition.wait RELEASES the lock it is guarded by —
                # `with self._cv: self._cv.wait()` is the idiom, not a
                # stall
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in ("wait", "wait_for", "notify",
                                   "notify_all") and \
                        isinstance(f.value, ast.Attribute) and \
                        isinstance(f.value.value, ast.Name) and \
                        f.value.value.id == "self" and \
                        f.value.attr in held:
                    return
                lock = sorted(held_locks)[0]
                desc = proj.classify_blocking(node, module, _mnode)
                if desc is not None:
                    _hits.append((node, lock, desc))
                    return
                target = proj.resolve_call(node, module, _mnode)
                if target is not None:
                    sub = proj.transitively_blocking(target.key)
                    if sub is not None:
                        _hits.append(
                            (node, lock,
                             f"`{target.qualname}` → {sub}"))

            held0 = set()
            hm = _HOLDS_RE.search(module.line_text(mnode.lineno))
            if hm:
                held0.add(hm.group(1))
            _held_locks_walk(mnode, visit, initial_held=held0)
            for node, lock, desc in hits:
                yield make_finding(
                    blocking_call_under_lock, module,
                    f"`self.{lock}` is held across a blocking call: "
                    f"{desc} — snapshot under the lock, block outside "
                    "it",
                    node=node, symbol=f"{ci.name}.{mname}")


@rule("SPK207", "callback-under-lock", SEVERITY_ERROR)
def callback_under_lock(module, ctx):
    """A stored callback (``self.on_x = on_x``) is invoked while the
    emitter's own lock is held. The callback is arbitrary user code: if
    it calls back into this object (or logs through something that
    does) it deadlocks on the very lock we hold; and the dwell time
    under the lock is unbounded. Snapshot, release, then fire."""
    for ci in _classes(module):
        if not ci.locks:
            continue
        pcls = None
        for cf in ctx.project.classes_by_name.get(ci.name, []):
            if cf.relpath == module.relpath:
                pcls = cf
        callbacks = pcls.callback_fields if pcls is not None else set()
        if not callbacks:
            continue
        for mname, mnode in ci.methods.items():
            hits = []

            def visit(node, held, _ci=ci, _cb=callbacks, _hits=hits):
                held_locks = {h for h in held if h in _ci.locks}
                if not held_locks:
                    return
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id == "self" and \
                        node.func.attr in _cb:
                    _hits.append((node, node.func.attr,
                                  sorted(held_locks)[0]))

            held0 = set()
            hm = _HOLDS_RE.search(module.line_text(mnode.lineno))
            if hm:
                held0.add(hm.group(1))
            _held_locks_walk(mnode, visit, initial_held=held0)
            for node, cb, lock in hits:
                yield make_finding(
                    callback_under_lock, module,
                    f"callback `self.{cb}` invoked while holding "
                    f"`self.{lock}` — a callback that re-enters this "
                    "object deadlocks; snapshot under the lock and "
                    "fire after releasing it",
                    node=node, symbol=f"{ci.name}.{mname}")
