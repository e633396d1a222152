"""The whole-repo project index — cross-module facts rules query.

The per-file rules see one file at a time; the invariants the runtime now
carries (lock order across classes, the rendezvous write discipline,
the metrics event vocabulary) span modules. This index is built once
per lint run from every parsed module and hands rules four families of
facts:

  * **module graph**: which module imports which, with the imported
    names resolved back to in-repo files (relative and absolute forms)
  * **class/method resolution + call edges**: ``self.m()``,
    ``self.field.m()`` (via ``self.field = ClassName(...)``),
    ``imported_fn()``, and ``local = ClassName(...); local.m()`` all
    resolve to the defining function when the definition is in-repo
  * **string/int constant propagation**: module-level constants plus
    per-function single-assignment locals feed
    :meth:`ProjectIndex.expr_fragments`, which flattens a path
    expression (f-strings, ``+``/``%``, ``os.path.join``, calls into
    ``*_path`` helpers) into its best-effort literal fragments — how
    SPK301 knows ``self._part_path(h, r)`` names a ``part-*.npz``
    rendezvous file two modules away
  * **domain registries**: the metrics event/kind vocabulary from every
    ``.log("...")`` emit site (SPK401/402), the blocking-call and
    lock-acquisition summaries behind the deadlock family
    (SPK205-207), and the canonical ``EXIT_*`` table (SPK304)

Everything here is AST-only and jax-free, like the rest of the
package. Resolution is deliberately best-effort: when a name cannot be
resolved the index answers None/empty and rules stay silent —
the linter's contract is no false alarms over full recall.
"""

import ast
import hashlib
import os

_MAX_DEPTH = 8          # expansion recursion guard (self-recursive helpers)

# receivers whose ``.log("event", **fields)`` calls are metrics emit
# sites (utils.metrics.MetricsLogger and the names it travels under);
# ``self.log`` / ``coord.log`` are plain text loggers, not emit sites
_METRIC_RECEIVERS = {"metrics", "_metrics", "sink", "_sink", "mlog"}

# call shapes that block: (dotted-name prefixes, attribute names)
_BLOCKING_DOTTED = {
    "time.sleep", "os.fsync", "os.replace", "os.rename", "os.remove",
    "os.makedirs", "np.load", "np.savez", "np.savez_compressed",
    "numpy.load", "numpy.savez", "glob.glob", "shutil.copy",
    "shutil.move", "shutil.rmtree", "subprocess.run", "subprocess.call",
    "json.dump", "json.load",
}
_BLOCKING_NAME_CALLS = {"open"}
# sync-primitive ctors whose .join()/.get()/.wait() calls block
_JOINABLE_CTORS = {"Thread", "Process", "Pool"}
_GETTABLE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}
_WAITABLE_CTORS = {"Event", "Condition", "Barrier", "Thread", "Process"}
_LOCK_CTORS = {"Lock", "RLock", "Condition"}


def dotted(node):
    """'a.b.c' for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _ctor_basename(value):
    if isinstance(value, ast.Call):
        f = value.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
    return None


def _own_nodes(fn):
    """Walk ``fn``'s body without entering nested function/class defs."""
    stack = list(fn.body)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


class FuncInfo:
    """One function or method definition the index can resolve calls
    to."""

    __slots__ = ("relpath", "qualname", "node", "cls")

    def __init__(self, relpath, qualname, node, cls=None):
        self.relpath = relpath
        self.qualname = qualname        # "f" or "Class.m"
        self.node = node
        self.cls = cls                  # owning ClassFacts or None

    @property
    def key(self):
        return (self.relpath, self.qualname)


class ClassFacts:
    """Per-class facts for resolution and the deadlock family."""

    __slots__ = ("relpath", "name", "node", "methods", "locks",
                 "attr_types", "callback_fields", "sync_ctors")

    def __init__(self, relpath, node):
        self.relpath = relpath
        self.name = node.name
        self.node = node
        self.methods = {}           # name -> FuncInfo
        self.locks = set()          # self.<attr> Lock/RLock/Condition
        self.attr_types = {}        # self.<attr> -> ClassName str
        self.callback_fields = set()  # stored callables invoked via self.f()
        self.sync_ctors = {}        # self.<attr> -> ctor basename

    def _collect(self):
        called_fields, stored_callables = set(), set()
        for item in self.node.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for n in ast.walk(item):
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            ctor = _ctor_basename(n.value)
                            if ctor in _LOCK_CTORS:
                                self.locks.add(t.attr)
                            if ctor:
                                self.sync_ctors.setdefault(t.attr, ctor)
                                self.attr_types.setdefault(t.attr, ctor)
                            # ``self.on_x = on_x or default`` — a stored
                            # callable, not a method: the shape SPK207
                            # cares about (methods inherited from a base
                            # class are NOT this shape, so they never
                            # false-positive here)
                            if isinstance(n.value,
                                          (ast.Name, ast.Attribute,
                                           ast.Lambda, ast.BoolOp,
                                           ast.IfExp)):
                                stored_callables.add(t.attr)
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        isinstance(n.func.value, ast.Name) and \
                        n.func.value.id == "self":
                    called_fields.add(n.func.attr)
        self.callback_fields = ((called_fields & stored_callables)
                                - set(self.methods))


class EmitSite:
    """One ``metrics.log(<event name>, **fields)`` call."""

    __slots__ = ("relpath", "line", "event", "fields", "open_fields",
                 "node", "kind")

    def __init__(self, relpath, line, event, fields, open_fields, node,
                 kind=None):
        self.relpath = relpath
        self.line = line
        self.event = event              # str, or None when unresolvable
        self.fields = tuple(fields)
        self.open_fields = open_fields  # True when **kwargs forwarded
        self.node = node
        self.kind = kind                # literal kind= value if any


class ProjectIndex:
    """Cross-module facts over one set of parsed modules."""

    def __init__(self, modules):
        self.modules = {m.relpath: m for m in modules}
        self.functions = {}         # (relpath, qualname) -> FuncInfo
        self.classes_by_name = {}   # name -> [ClassFacts]
        self.classes = {}           # (relpath, name) -> ClassFacts
        self.imports = {}           # relpath -> {local name: (relpath, sym)}
        self.constants = {}         # (relpath, name) -> str|int
        self._global_consts = {}    # name -> value (first wins)
        self._ambiguous = set()
        self.exit_table = {}        # int -> EXIT_* name
        self.emit_sites = []        # [EmitSite]
        self.events = {}            # event -> {"fields", "open", "sites"}
        self.kinds = set()          # every literal kind value seen
        self.kinds_open = False     # a non-literal kind= was seen
        self._local_cache = {}      # id(fn-node) -> {name: value expr}
        self._blocking_memo = {}
        self._acquire_memo = {}
        for m in modules:
            self._index_module(m)
        for m in modules:
            self._index_imports(m)
        for m in modules:
            self._index_emits(m)

    # -- construction ------------------------------------------------------

    def _index_module(self, module):
        rel = module.relpath
        for node in module.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FuncInfo(rel, node.name, node)
                self.functions[fi.key] = fi
            elif isinstance(node, ast.ClassDef):
                cf = ClassFacts(rel, node)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        fi = FuncInfo(rel, f"{node.name}.{item.name}",
                                      item, cls=cf)
                        cf.methods[item.name] = fi
                        self.functions[fi.key] = fi
                cf._collect()
                self.classes[(rel, node.name)] = cf
                self.classes_by_name.setdefault(node.name, []).append(cf)
            elif isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, (str, int)) and \
                    not isinstance(node.value.value, bool):
                name, val = node.targets[0].id, node.value.value
                self.constants[(rel, name)] = val
                if name in self._global_consts and \
                        self._global_consts[name] != val:
                    self._ambiguous.add(name)
                else:
                    self._global_consts.setdefault(name, val)
                if name.startswith("EXIT_") and isinstance(val, int):
                    self.exit_table.setdefault(val, name)

    def _module_rel_for(self, importer_rel, level, modname):
        """Resolve an import to an in-repo relpath, or None."""
        if level:                                   # from . / .. import
            base = os.path.dirname(importer_rel)
            for _ in range(level - 1):
                base = os.path.dirname(base)
            parts = ([base] if base else []) + \
                (modname.split(".") if modname else [])
        else:
            parts = modname.split(".") if modname else []
        cand = "/".join(p for p in parts if p)
        for suffix in (".py", "/__init__.py"):
            if cand + suffix in self.modules:
                return cand + suffix
        return None

    def _index_imports(self, module):
        table = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom):
                target = self._module_rel_for(module.relpath,
                                              node.level,
                                              node.module or "")
                for a in node.names:
                    local = a.asname or a.name
                    if target is None:
                        continue
                    # `from pkg import mod` may name a submodule
                    sub = self._module_rel_for(
                        module.relpath, node.level,
                        f"{node.module or ''}.{a.name}".strip("."))
                    if sub is not None:
                        table[local] = (sub, None)
                    else:
                        table[local] = (target, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    target = self._module_rel_for(module.relpath, 0,
                                                  a.name)
                    if target is not None:
                        table[local] = (target, None)
        self.imports[module.relpath] = table

    def imported_modules(self, relpath):
        """In-repo module relpaths ``relpath`` imports (the module
        graph edge set)."""
        return sorted({rel for rel, _ in
                       self.imports.get(relpath, {}).values()})

    # -- emit sites / event registry ---------------------------------------

    @staticmethod
    def _is_metric_receiver(func):
        """True for ``<...>.metrics.log`` / ``metrics.log`` etc."""
        if not (isinstance(func, ast.Attribute) and func.attr == "log"):
            return False
        recv = func.value
        if isinstance(recv, ast.Name):
            return recv.id in _METRIC_RECEIVERS
        if isinstance(recv, ast.Attribute):
            return recv.attr in _METRIC_RECEIVERS
        return False

    def _index_emits(self, module):
        rel = module.relpath
        for fn in self._all_function_nodes(module):
            for n in _own_nodes(fn):
                if not (isinstance(n, ast.Call) and
                        self._is_metric_receiver(n.func) and n.args):
                    continue
                event = self._const_str(n.args[0], module, fn)
                fields, open_fields, kind = [], False, None
                for kw in n.keywords:
                    if kw.arg is None:
                        open_fields = True
                        continue
                    fields.append(kw.arg)
                    if kw.arg == "kind":
                        kv = self._const_str(kw.value, module, fn)
                        if kv is not None:
                            kind = kv
                            self.kinds.add(kv)
                        else:
                            self.kinds_open = True
                site = EmitSite(rel, n.lineno, event, fields,
                                open_fields, n, kind=kind)
                self.emit_sites.append(site)
                if event is not None:
                    e = self.events.setdefault(
                        event, {"fields": set(), "open": False,
                                "sites": []})
                    e["fields"].update(fields)
                    e["open"] = e["open"] or open_fields
                    e["sites"].append((rel, n.lineno))
        # kind vocabulary: kind= on emit sites is collected above (a
        # kind= on a non-emit call, e.g. divergence.observe, never
        # reaches the metrics stream); event rows built as dict
        # literals can also carry "kind"
        for n in ast.walk(module.tree):
            if isinstance(n, ast.Dict):
                for k, v in zip(n.keys, n.values):
                    if isinstance(k, ast.Constant) and k.value == "kind":
                        if isinstance(v, ast.Constant) and \
                                isinstance(v.value, str):
                            self.kinds.add(v.value)
                        else:
                            self.kinds_open = True
            elif isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Subscript):
                sub = n.targets[0]
                if isinstance(sub.slice, ast.Constant) and \
                        sub.slice.value == "kind" and \
                        isinstance(n.value, ast.Constant) and \
                        isinstance(n.value.value, str):
                    self.kinds.add(n.value.value)

    @staticmethod
    def _all_function_nodes(module):
        for n in ast.walk(module.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield n

    # -- constant / expression resolution ----------------------------------

    def resolve_constant(self, name, relpath=None):
        """Module-level constant value for ``name``: the defining
        module first, imported names next, then the global first-wins
        table (None when the name is ambiguous across modules)."""
        if relpath is not None:
            if (relpath, name) in self.constants:
                return self.constants[(relpath, name)]
            imp = self.imports.get(relpath, {}).get(name)
            if imp is not None and imp[1] is not None and \
                    (imp[0], imp[1]) in self.constants:
                return self.constants[(imp[0], imp[1])]
        if name in self._ambiguous:
            return None
        return self._global_consts.get(name)

    def _locals_of(self, fn):
        """{name: value-expr} for names assigned exactly once in ``fn``
        (the per-function half of constant propagation)."""
        cache = self._local_cache.get(id(fn))
        if cache is not None:
            return cache
        assigns, multi = {}, set()
        for n in _own_nodes(fn):
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            elif isinstance(n, ast.For):
                targets = [n.target]
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        if leaf.id in assigns or leaf.id in multi or \
                                not isinstance(n, ast.Assign):
                            multi.add(leaf.id)
                            assigns.pop(leaf.id, None)
                        else:
                            assigns[leaf.id] = n.value
        self._local_cache[id(fn)] = assigns
        return assigns

    def _const_str(self, node, module, fn):
        """The string value of ``node`` if statically known."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            if fn is not None:
                local = self._locals_of(fn).get(node.id)
                if local is not None:
                    return self._const_str(local, module, None)
            v = self.resolve_constant(node.id, module.relpath)
            return v if isinstance(v, str) else None
        return None

    def expr_fragments(self, node, module, fn, _depth=0):
        """Best-effort literal fragments of a (path) expression:
        constants, resolved names, f-string/%/+ pieces, ``os.path.join``
        arguments, and the return expressions of resolved in-repo call
        targets (``self._part_path(...)`` → ``["part-", ".npz", ...]``).
        Unresolvable sub-expressions contribute nothing."""
        if _depth > _MAX_DEPTH or node is None:
            return []
        out = []
        if isinstance(node, ast.Constant):
            if isinstance(node.value, str):
                out.append(node.value)
        elif isinstance(node, ast.JoinedStr):
            for part in node.values:
                if isinstance(part, ast.Constant):
                    if isinstance(part.value, str):
                        out.append(part.value)
                elif isinstance(part, ast.FormattedValue):
                    out.extend(self.expr_fragments(
                        part.value, module, fn, _depth + 1))
        elif isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.Add, ast.Mod)):
            out.extend(self.expr_fragments(node.left, module, fn,
                                           _depth + 1))
            out.extend(self.expr_fragments(node.right, module, fn,
                                           _depth + 1))
        elif isinstance(node, ast.Name):
            if fn is not None:
                local = self._locals_of(fn).get(node.id)
                if local is not None:
                    return self.expr_fragments(local, module, fn,
                                               _depth + 1)
            v = self.resolve_constant(node.id, module.relpath)
            if isinstance(v, str):
                out.append(v)
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            if d in ("os.path.join", "posixpath.join", "str"):
                for a in node.args:
                    out.extend(self.expr_fragments(a, module, fn,
                                                   _depth + 1))
            else:
                target = self.resolve_call(node, module, fn)
                if target is not None:
                    tmod = self.modules.get(target.relpath)
                    for r in _own_nodes(target.node):
                        if isinstance(r, ast.Return) and \
                                r.value is not None:
                            out.extend(self.expr_fragments(
                                r.value, tmod, target.node, _depth + 1))
        elif isinstance(node, ast.Attribute):
            pass                        # self.dir etc: unknown, silent
        return out

    # -- call resolution ---------------------------------------------------

    def _enclosing_class(self, module, fn):
        """ClassFacts whose method ``fn`` is (by identity), or None."""
        for (rel, _name), cf in self.classes.items():
            if rel != module.relpath:
                continue
            for mi in cf.methods.values():
                if mi.node is fn:
                    return cf
        return None

    def resolve_call(self, call, module, fn):
        """FuncInfo for ``call``'s target, or None. Handles:
        plain names (same module, then imports), ``self.m()``,
        ``self.field.m()`` via attr types, ``local = Cls(...);
        local.m()``, and ``imported_module.f()``."""
        func = call.func
        rel = module.relpath
        if isinstance(func, ast.Name):
            fi = self.functions.get((rel, func.id))
            if fi is not None:
                return fi
            imp = self.imports.get(rel, {}).get(func.id)
            if imp is not None:
                target_rel, sym = imp
                if sym is None:         # imported a module, not callable
                    return None
                fi = self.functions.get((target_rel, sym))
                if fi is not None:
                    return fi
                # `from m import ClassName` then ClassName(...) — the
                # constructor; resolution target is __init__
                cf = self.classes.get((target_rel, sym))
                if cf is not None:
                    return cf.methods.get("__init__")
            cf = self.classes.get((rel, func.id))
            if cf is not None:
                return cf.methods.get("__init__")
            return None
        if not isinstance(func, ast.Attribute):
            return None
        recv, mname = func.value, func.attr
        # self.m()
        if isinstance(recv, ast.Name) and recv.id == "self":
            cf = self._enclosing_class(module, fn) if fn is not None \
                else None
            if cf is not None and mname in cf.methods:
                return cf.methods[mname]
            return None
        # module.f() through an imported module name
        if isinstance(recv, ast.Name):
            imp = self.imports.get(rel, {}).get(recv.id)
            if imp is not None and imp[1] is None:
                return self.functions.get((imp[0], mname))
            # local = ClassName(...); local.m()
            if fn is not None:
                local = self._locals_of(fn).get(recv.id)
                ctor = _ctor_basename(local) if local is not None else None
                cf = self._class_by_ctor(ctor, rel)
                if cf is not None:
                    return cf.methods.get(mname)
            return None
        # self.field.m() via the field's recorded ctor type
        if isinstance(recv, ast.Attribute) and \
                isinstance(recv.value, ast.Name) and \
                recv.value.id == "self" and fn is not None:
            cf = self._enclosing_class(module, fn)
            if cf is not None:
                tname = cf.attr_types.get(recv.attr)
                tcf = self._class_by_ctor(tname, rel)
                if tcf is not None:
                    return tcf.methods.get(mname)
        return None

    def _class_by_ctor(self, name, from_rel):
        """ClassFacts for a constructor basename, same module first,
        then unique across the project."""
        if not name:
            return None
        cf = self.classes.get((from_rel, name))
        if cf is not None:
            return cf
        imp = self.imports.get(from_rel, {}).get(name)
        if imp is not None and imp[1] is not None:
            return self.classes.get((imp[0], imp[1]))
        cands = self.classes_by_name.get(name, [])
        return cands[0] if len(cands) == 1 else None

    def callees(self, func_key):
        """Resolved in-repo callees of a function (the call-edge set)."""
        fi = self.functions.get(func_key)
        if fi is None:
            return []
        module = self.modules.get(fi.relpath)
        out, seen = [], set()
        for n in _own_nodes(fi.node):
            if isinstance(n, ast.Call):
                t = self.resolve_call(n, module, fi.node)
                if t is not None and t.key not in seen:
                    seen.add(t.key)
                    out.append(t)
        return out

    # -- blocking-call summaries (SPK206) ----------------------------------

    def _sync_ctor_of_receiver(self, recv, module, fn):
        """Ctor basename of a ``.join()/.get()/.wait()`` receiver when
        statically known (self.field / single-assignment local)."""
        if isinstance(recv, ast.Attribute) and \
                isinstance(recv.value, ast.Name) and \
                recv.value.id == "self" and fn is not None:
            cf = self._enclosing_class(module, fn)
            if cf is not None:
                return cf.sync_ctors.get(recv.attr)
        if isinstance(recv, ast.Name) and fn is not None:
            local = self._locals_of(fn).get(recv.id)
            if local is not None:
                return _ctor_basename(local)
        return None

    def classify_blocking(self, n, module, fn):
        """Description when call node ``n`` blocks (sleep, file I/O,
        thread join, queue get, event wait), else None. `.get()` is
        queue-shaped only with zero positional args (dict.get has a
        key), `.join()` thread-shaped only when the receiver resolves
        to a Thread/Process or a timeout= is passed (str.join has
        neither)."""
        if not isinstance(n, ast.Call):
            return None
        d = dotted(n.func)
        if d in _BLOCKING_DOTTED:
            return f"`{d}(...)`"
        if isinstance(n.func, ast.Name) and \
                n.func.id in _BLOCKING_NAME_CALLS:
            return f"`{n.func.id}(...)` (file I/O)"
        if not isinstance(n.func, ast.Attribute):
            return None
        attr, recv = n.func.attr, n.func.value
        ctor = self._sync_ctor_of_receiver(recv, module, fn)
        if attr == "join" and (ctor in _JOINABLE_CTORS or
                               (ctor is None and any(
                                   kw.arg == "timeout"
                                   for kw in n.keywords))):
            return "`.join(...)` on a thread"
        if attr == "get" and ctor in _GETTABLE_CTORS:
            return "`.get(...)` on a queue"
        if attr == "get" and ctor is None and not n.args and \
                all(kw.arg in ("timeout", "block") for kw in n.keywords):
            return "`.get(...)` on a queue"
        if attr == "wait" and ctor in _WAITABLE_CTORS:
            return f"`.wait(...)` on a {ctor}"
        return None

    def direct_blocking_calls(self, module, fn):
        """[(call node, description)] for calls in ``fn`` that block."""
        out = []
        for n in _own_nodes(fn):
            desc = self.classify_blocking(n, module, fn)
            if desc is not None:
                out.append((n, desc))
        return out

    def transitively_blocking(self, func_key, _seen=None):
        """Description of the first blocking op reachable from
        ``func_key`` through resolved call edges, or None."""
        if func_key in self._blocking_memo:
            return self._blocking_memo[func_key]
        _seen = _seen or set()
        if func_key in _seen:
            return None
        _seen.add(func_key)
        fi = self.functions.get(func_key)
        if fi is None:
            return None
        module = self.modules.get(fi.relpath)
        direct = self.direct_blocking_calls(module, fi.node)
        if direct:
            res = f"{direct[0][1]} at {fi.relpath}:{direct[0][0].lineno}"
            self._blocking_memo[func_key] = res
            return res
        for callee in self.callees(func_key):
            sub = self.transitively_blocking(callee.key, _seen)
            if sub is not None:
                res = f"`{callee.qualname}` → {sub}"
                self._blocking_memo[func_key] = res
                return res
        self._blocking_memo[func_key] = None
        return None

    # -- lock-acquisition summaries (SPK205) -------------------------------

    def direct_acquires(self, func_key):
        """[(class name, lock attr, line)] for every ``with
        self.<lock>:`` in the method."""
        fi = self.functions.get(func_key)
        if fi is None or fi.cls is None:
            return []
        out = []
        for n in _own_nodes(fi.node):
            if isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    e = item.context_expr
                    if isinstance(e, ast.Attribute) and \
                            isinstance(e.value, ast.Name) and \
                            e.value.id == "self" and \
                            e.attr in fi.cls.locks:
                        out.append((fi.cls.name, e.attr, n.lineno))
        return out

    def transitive_acquires(self, func_key, _seen=None):
        """{(class name, lock attr)} acquired by the function or any
        resolved callee."""
        if func_key in self._acquire_memo:
            return self._acquire_memo[func_key]
        _seen = _seen or set()
        if func_key in _seen:
            return set()
        _seen.add(func_key)
        out = {(c, l) for c, l, _ in self.direct_acquires(func_key)}
        for callee in self.callees(func_key):
            out |= self.transitive_acquires(callee.key, _seen)
        self._acquire_memo[func_key] = out
        return out

    # -- cache invalidation ------------------------------------------------

    def fingerprint(self):
        """Hash of every cross-module summary a cached per-file result
        can depend on. Editing one file only invalidates OTHER files'
        cache entries when a summary actually changed."""
        h = hashlib.sha256()
        for key in sorted(self.constants):
            h.update(repr((key, self.constants[key])).encode())
        for name in sorted(self.events):
            e = self.events[name]
            h.update(repr((name, sorted(e["fields"]),
                           e["open"])).encode())
        h.update(repr(sorted(self.kinds)).encode())
        h.update(repr(sorted(self.exit_table.items())).encode())
        for (rel, name), cf in sorted(self.classes.items()):
            h.update(repr((rel, name, sorted(cf.locks),
                           sorted(cf.methods),
                           sorted(cf.callback_fields))).encode())
        for rel in sorted(self.imports):
            h.update(repr((rel, sorted(self.imports[rel].items()))
                          ).encode())
        return h.hexdigest()[:16]
