"""SPK1xx — JAX compiled-code hazard rules.

The common machinery is a per-module *scope index* (every function/
lambda with its lexical parent) plus a *traced-set* computation: find
the functions handed to ``jax.jit`` / ``jax.pmap`` / ``shard_map``
(directly, through ``grad``/``value_and_grad``/``vmap`` wrappers,
through a builder method that returns a local def — the
``jax.jit(self._train_step_fn(), ...)`` idiom — or as a decorator),
then close over local calls: everything a traced function defines or
calls locally runs under the tracer too. Rules then look only inside
that traced set, which is what keeps them quiet on host-side control
code where ``float(loss)`` is exactly right.

Rules:
  SPK101  host sync inside jit-traced code (.item()/float()/np.asarray/
          jax.device_get reachable from a jit/pmap/shard_map root) —
          each one is a device round trip serialized into the hot path
  SPK102  recompile/trace hazards: Python if/for/while on traced
          function parameters, closure capture of mutable module
          globals, unhashable literals passed to static jit args
  SPK103  PRNG key reuse: the same key name consumed by two
          ``jax.random.*`` sampler calls with no intervening
          split/fold_in rebind, or consumed inside a loop while bound
          outside it
  SPK104  collective axis-name mismatch: pmean/psum/all_gather/... axis
          names checked against the enclosing pmap/shard_map axis
          declarations (resolvable literals only — never guesses), incl.
          calls through axis-forwarding helpers like masked_consensus
  SPK105  missing buffer donation: a jitted update-style function
          (takes AND returns params/state/history) with no
          donate_argnums — every step pays a params-sized HBM copy
"""

import ast

from .engine import (rule, make_finding, qualname_of, SEVERITY_ERROR,
                     SEVERITY_WARN)


# -- scope index ------------------------------------------------------------

class Scope:
    """One function-ish lexical scope (module root included)."""

    def __init__(self, node, name, parent):
        self.node = node                # FunctionDef/Lambda/Module/Class
        self.name = name
        self.parent = parent
        self.children = {}              # name -> Scope (functions only)
        self.bound = set()              # names assigned/params here
        self.qualname = name if parent is None else (
            f"{parent.qualname}.{name}" if parent.qualname != "<module>"
            else name)

    def resolve(self, name):
        """Lexical lookup of a *function* scope named ``name``."""
        s = self
        while s is not None:
            if name in s.children:
                return s.children[name]
            if name in s.bound:          # shadowed by a non-function
                return None
            s = s.parent
        return None

    def binds(self, name):
        s = self
        while s is not None:
            if name in s.bound or name in s.children:
                return True
            s = s.parent
        return False

    def params(self):
        if not isinstance(self.node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
            return []
        a = self.node.args
        names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names


def _is_funcdef(node):
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda))


def build_scopes(module):
    """Index every function/lambda scope with lexical parents, bound
    names, and a node->scope map."""
    root = Scope(module.tree, "<module>", None)
    by_node = {module.tree: root}

    def handle(node, scope):
        if _is_funcdef(node):
            define_func(node, scope, getattr(node, "name", "<lambda>"))
            return
        if isinstance(node, ast.ClassDef):
            scope.bound.add(node.name)
            sub = Scope(node, node.name, scope)
            by_node[node] = sub
            for b in node.body:
                handle(b, sub)
            for extra in node.decorator_list + node.bases:
                handle(extra, scope)
            return
        _note_bindings(node, scope)
        # a lambda assigned to a name acts like a local def
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Lambda) \
                and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            define_func(node.value, scope, node.targets[0].id)
            return
        for child in ast.iter_child_nodes(node):
            handle(child, scope)

    def define_func(node, scope, name):
        sub = Scope(node, name, scope)
        for p in sub.params():
            sub.bound.add(p)
        scope.children[name] = sub
        by_node[node] = sub
        body = node.body if isinstance(node.body, list) else [node.body]
        for b in body:
            handle(b, sub)
        # decorators/defaults evaluate in the ENCLOSING scope
        for extra in (getattr(node, "decorator_list", []) +
                      node.args.defaults +
                      [d for d in node.args.kw_defaults if d]):
            handle(extra, scope)

    def _note_bindings(node, scope):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        scope.bound.add(n.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    scope.bound.add(n.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                scope.bound.add((alias.asname or
                                 alias.name.split(".")[0]))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    for n in ast.walk(item.optional_vars):
                        if isinstance(n, ast.Name):
                            scope.bound.add(n.id)

    for stmt in module.tree.body:
        handle(stmt, root)
    return root, by_node


# -- name/call classification ----------------------------------------------

def dotted(node):
    """'jax.lax.pmean' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def numpy_aliases(module):
    """Names the module binds to the numpy module ('np', 'numpy', ...)."""
    out = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    out.add(a.asname or "numpy")
    return out or {"np", "numpy"}


def random_aliases(module):
    """Names bound to the jax.random module ('jax.random', 'jr', ...),
    as dotted prefixes."""
    out = {"jax.random"}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "jax.random" and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "jax":
                for a in node.names:
                    if a.name == "random":
                        out.add(a.asname or "random")
    return out


_JIT_NAMES = {"jax.jit", "jit", "jax.pmap", "pmap"}
_SHARD_MAP_NAMES = {"shard_map", "jax.experimental.shard_map.shard_map"}
_WRAPPERS = {"jax.grad", "grad", "jax.value_and_grad", "value_and_grad",
             "jax.vmap", "vmap", "jax.checkpoint", "checkpoint",
             "jax.remat", "remat", "functools.partial", "partial"}


def _callable_kind(call_or_name):
    """Classify a dotted callee name: 'jit' | 'shard_map' | 'wrapper'
    | None."""
    d = call_or_name
    if d is None:
        return None
    if d in _JIT_NAMES or d.endswith(".jit") or d.endswith(".pmap"):
        return "jit"
    if d in _SHARD_MAP_NAMES or d.endswith(".shard_map"):
        return "shard_map"
    if d in _WRAPPERS:
        return "wrapper"
    return None


def _unwrap_target(arg, scope, depth=0):
    """Resolve the function ultimately wrapped by a jit/pmap/shard_map
    argument expression: a Name (local def / lambda), a Lambda literal,
    a wrapper call (grad/vmap/partial/shard_map of something), or a
    builder call whose return statement returns a local def."""
    if depth > 8:                        # self-referential assignments
        return None, None
    if isinstance(arg, ast.Lambda):
        return arg, scope
    if isinstance(arg, ast.Name):
        target = scope.resolve(arg.id)
        if target is not None:
            return target.node, target.parent
        # `fn = self._builder()` / `sharded = shard_map(step, ...)`:
        # chase the single local assignment and unwrap its RHS
        assign = _single_assignment(arg.id, scope)
        if assign is not None and isinstance(assign, ast.Call):
            return _unwrap_target(assign, scope, depth + 1)
        return None, None
    if isinstance(arg, ast.Call):
        kind = _callable_kind(dotted(arg.func))
        if kind in ("wrapper", "shard_map", "jit") and arg.args:
            return _unwrap_target(arg.args[0], scope, depth + 1)
        # builder idiom: jax.jit(self._train_step_fn()) — resolve the
        # builder and follow its `return <local def>`
        builder = None
        if isinstance(arg.func, ast.Attribute) and \
                isinstance(arg.func.value, ast.Name) and \
                arg.func.value.id in ("self", "cls"):
            cls_scope = scope
            while cls_scope and not isinstance(cls_scope.node,
                                               ast.ClassDef):
                cls_scope = cls_scope.parent
            if cls_scope:
                builder = cls_scope.children.get(arg.func.attr)
        elif isinstance(arg.func, ast.Name):
            builder = scope.resolve(arg.func.id)
        if builder and isinstance(builder.node, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef)):
            for n in ast.walk(builder.node):
                if isinstance(n, ast.Return) and \
                        isinstance(n.value, ast.Name):
                    t = builder.resolve(n.value.id)
                    if t:
                        return t.node, t.parent
    return None, None


def _single_assignment(name, scope):
    """RHS of the one assignment binding ``name`` in the lexical chain,
    or None when unbound or bound more than once (ambiguous)."""
    s = scope
    while s is not None:
        found = []
        it = _own_statements(s.node) if _is_funcdef(s.node) \
            else ast.walk(s.node)
        for n in it:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and n.targets[0].id == name:
                found.append(n.value)
        if found:
            return found[0] if len(found) == 1 else None
        s = s.parent
    return None


def _own_statements(fnode):
    """Walk a function's body WITHOUT descending into nested function
    definitions (those are separate scopes, analyzed on their own)."""
    body = fnode.body if isinstance(fnode.body, list) else [fnode.body]
    stack = list(body)
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if not _is_funcdef(child):
                stack.append(child)


class TraceIndex:
    """Per-module: which function scopes run under a jax tracer, which
    jit root each one descends from, and the axis names (if statically
    resolvable) declared by the enclosing pmap/shard_map."""

    def __init__(self, module, ctx):
        self.module = module
        self.root, self.by_node = build_scopes(module)
        self.traced = {}                # Scope -> root qualname
        self.axes = {}                  # Scope -> frozenset | None
        self.roots = set()              # scopes jit'd DIRECTLY: their
        self._find_roots(ctx)           # params are traced for sure;
        self.roots = set(self.traced)   # helpers may get static args
        self._propagate()

    def _find_roots(self, ctx):
        for node, scope in list(self.by_node.items()):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                d = dotted(dec if not isinstance(dec, ast.Call)
                           else dec.func)
                if d and _callable_kind(d) == "jit":
                    self._mark(scope, scope.qualname, axes=None)
                elif isinstance(dec, ast.Call) and d in (
                        "functools.partial", "partial") and dec.args:
                    inner = dotted(dec.args[0])
                    if inner and _callable_kind(inner) == "jit":
                        self._mark(scope, scope.qualname, axes=None)
        for node in ast.walk(self.module.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _callable_kind(dotted(node.func))
            if kind not in ("jit", "shard_map"):
                continue
            scope = self._enclosing_scope(node)
            if not node.args:
                continue
            target, tscope = _unwrap_target(node.args[0], scope)
            if target is None or target not in self.by_node:
                continue
            axes = self._declared_axes(node, scope, ctx, kind)
            self._mark(self.by_node[target],
                       self.by_node[target].qualname, axes)

    def _enclosing_scope(self, node):
        # cheap: recompute by walking — build a parent map once instead
        if not hasattr(self, "_parents"):
            self._parents = {}
            for n in ast.walk(self.module.tree):
                for c in ast.iter_child_nodes(n):
                    self._parents[c] = n
        n = self._parents.get(node)
        while n is not None:
            if n in self.by_node and not isinstance(n, ast.ClassDef):
                return self.by_node[n]
            n = self._parents.get(n)
        return self.root

    def _declared_axes(self, call, scope, ctx, kind):
        """Axis names declared by this pmap/shard_map call, or None
        when not statically resolvable."""
        if kind != "shard_map":
            d = dotted(call.func) or ""
            if d.endswith("pmap") or d == "pmap":
                for kw in call.keywords:
                    if kw.arg == "axis_name":
                        v = _axis_value(kw.value, scope, ctx)
                        return frozenset([v]) if v else None
                if len(call.args) >= 2:
                    v = _axis_value(call.args[1], scope, ctx)
                    return frozenset([v]) if v else None
            return None
        mesh_expr = None
        for kw in call.keywords:
            if kw.arg == "mesh":
                mesh_expr = kw.value
        if mesh_expr is None and len(call.args) >= 2:
            mesh_expr = call.args[1]
        return _mesh_axes(mesh_expr, scope, ctx)

    def _mark(self, scope, root_qualname, axes):
        if scope in self.traced:
            if axes:
                prev = self.axes.get(scope)
                self.axes[scope] = (prev | axes) if prev else axes
            return
        self.traced[scope] = root_qualname
        self.axes[scope] = axes

    def _propagate(self):
        changed = True
        while changed:
            changed = False
            for scope, rootq in list(self.traced.items()):
                axes = self.axes.get(scope)
                # (a) functions DEFINED inside a traced function trace
                for child in scope.children.values():
                    if child not in self.traced:
                        self._mark(child, rootq, axes)
                        changed = True
                    elif axes and not self.axes.get(child):
                        self.axes[child] = axes
                        changed = True
                # (b) local functions CALLED (or passed as callbacks)
                # from a traced body trace too
                for n in _own_statements(scope.node):
                    names = []
                    if isinstance(n, ast.Call):
                        if isinstance(n.func, ast.Name):
                            names.append(n.func.id)
                        names.extend(a.id for a in n.args
                                     if isinstance(a, ast.Name))
                    for name in names:
                        t = scope.resolve(name)
                        if t is None or t.node is scope.node:
                            continue
                        if not _is_funcdef(t.node):
                            continue
                        if t not in self.traced:
                            self._mark(t, rootq, axes)
                            changed = True
                        elif axes and not self.axes.get(t):
                            self.axes[t] = axes
                            changed = True


def _axis_value(node, scope, ctx):
    """Resolve an axis-name expression to a string, or None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return ctx.resolve_str_constant(node.id)
    return None


def _mesh_axes(expr, scope, ctx):
    """Axis names of a mesh expression, or None when unresolvable:
    make_mesh({"data": 8, ...}), Mesh(devs, ("data",)),
    Mesh(devs, axis_names=(...)), or a local Name bound to one."""
    seen = set()
    while isinstance(expr, ast.Name) and expr.id not in seen:
        seen.add(expr.id)
        target = None
        s = scope
        while s is not None and target is None:
            for n in _own_statements(s.node) \
                    if _is_funcdef(s.node) else ast.walk(s.node):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and n.targets[0].id == expr.id:
                    target = n.value
            s = s.parent
        if target is None:
            return None
        expr = target
    if not isinstance(expr, ast.Call):
        return None
    d = dotted(expr.func) or ""
    if d.endswith("make_mesh") or d == "make_mesh":
        if expr.args and isinstance(expr.args[0], ast.Dict):
            keys = []
            for k in expr.args[0].keys:
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    return None
                keys.append(k.value)
            return frozenset(keys)
        return None
    if d.endswith("Mesh") or d == "Mesh":
        names_expr = None
        for kw in expr.keywords:
            if kw.arg == "axis_names":
                names_expr = kw.value
        if names_expr is None and len(expr.args) >= 2:
            names_expr = expr.args[1]
        if isinstance(names_expr, (ast.Tuple, ast.List)):
            vals = []
            for e in names_expr.elts:
                if not (isinstance(e, ast.Constant)
                        and isinstance(e.value, str)):
                    return None
                vals.append(e.value)
            return frozenset(vals)
        if isinstance(names_expr, ast.Constant) \
                and isinstance(names_expr.value, str):
            return frozenset([names_expr.value])
    return None


def get_trace_index(module, ctx):
    cache = getattr(module, "_trace_index", None)
    if cache is None:
        cache = TraceIndex(module, ctx)
        module._trace_index = cache
    return cache


# -- SPK101: host sync in traced code ---------------------------------------

_SYNC_ATTRS = {"item", "tolist", "block_until_ready"}
_NP_SYNC = {"asarray", "array", "copy", "save"}


@rule("SPK101", "host-sync-in-jit", SEVERITY_ERROR)
def host_sync_in_jit(module, ctx):
    """Host-device synchronization inside jit-traced code: .item() /
    .tolist() / float() / int() / np.asarray / jax.device_get reachable
    from a jit/pmap/shard_map root. Each is a blocking device round
    trip serialized into the compiled hot path (and most fail outright
    on tracers)."""
    idx = get_trace_index(module, ctx)
    np_alias = numpy_aliases(module)
    for scope, rootq in idx.traced.items():
        for n in _own_statements(scope.node):
            if not isinstance(n, ast.Call):
                continue
            msg = None
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _SYNC_ATTRS and not n.args:
                msg = f"`.{n.func.attr}()`"
            elif isinstance(n.func, ast.Name) \
                    and n.func.id in ("float", "int") and n.args \
                    and not isinstance(n.args[0], ast.Constant):
                msg = f"`{n.func.id}()` on a traced value"
            else:
                d = dotted(n.func)
                if d:
                    head, _, tail = d.rpartition(".")
                    if head in np_alias and tail in _NP_SYNC:
                        msg = f"`{d}()` (numpy materializes on host)"
                    elif d in ("jax.device_get", "jax.device_put"):
                        msg = f"`{d}()`"
            if msg:
                yield make_finding(
                    host_sync_in_jit, module,
                    f"host sync {msg} inside jit-traced code "
                    f"(reachable from `{rootq}`); hoist it out of the "
                    "compiled path", node=n, symbol=scope.qualname)


# -- SPK102: recompile / trace hazards --------------------------------------

_SHAPE_ATTRS = {"shape", "ndim", "dtype", "size"}


def _static_name_uses(cond, params):
    """Names in ``cond`` that are traced params used as VALUES (not via
    .shape/.ndim/len()/`is None`, which are static under tracing)."""
    hits = []
    parents = {}
    for n in ast.walk(cond):
        for c in ast.iter_child_nodes(n):
            parents[c] = n
    for n in ast.walk(cond):
        if not (isinstance(n, ast.Name) and n.id in params):
            continue
        p = parents.get(n)
        if isinstance(p, ast.Attribute) and p.attr in _SHAPE_ATTRS:
            continue
        if isinstance(p, ast.Call) and p.func is not n:
            d = dotted(p.func)
            if isinstance(p.func, ast.Name) and p.func.id in (
                    "len", "isinstance", "hasattr", "getattr", "type"):
                continue
            if d and (d.rpartition(".")[2] in ("ndim", "result_type")):
                continue
        if isinstance(p, ast.Compare):
            ops = p.ops
            if all(isinstance(o, (ast.Is, ast.IsNot)) for o in ops):
                continue
        if isinstance(p, ast.Subscript) and p.value is not n:
            continue                     # x[i]: i static is common
        hits.append(n)
    return hits


@rule("SPK102", "recompile-hazard", SEVERITY_WARN)
def recompile_hazard(module, ctx):
    """Patterns that force retraces/recompiles (or TracerBoolConversion
    errors): Python `if`/`while` branching on a traced function
    parameter, `for` iterating a traced parameter or `range(<traced>)`,
    closure capture of a mutable module-level global inside traced
    code, and list/dict/set literals passed to jit static args."""
    idx = get_trace_index(module, ctx)
    mutable_globals = _mutable_module_globals(module)
    for scope, rootq in idx.traced.items():
        # only a jit ROOT's own parameters are traced for certain;
        # helpers it calls may legitimately take static arguments
        # (axis lists, tree_map flags), so param-flow checks stop there
        params = set(scope.params()) if scope in idx.roots else set()
        for n in _own_statements(scope.node):
            if isinstance(n, (ast.If, ast.While)):
                for hit in _static_name_uses(n.test, params):
                    yield make_finding(
                        recompile_hazard, module,
                        f"Python `{type(n).__name__.lower()}` on traced "
                        f"value `{hit.id}` (param of `{scope.qualname}`)"
                        ": branches on data retrace per value or fail "
                        "under jit; use lax.cond/jnp.where",
                        node=n, symbol=scope.qualname)
            elif isinstance(n, ast.For):
                it = n.iter
                bad = None
                if isinstance(it, ast.Name) and it.id in params:
                    bad = it.id
                elif isinstance(it, ast.Call) \
                        and isinstance(it.func, ast.Name) \
                        and it.func.id == "range" and it.args \
                        and isinstance(it.args[-1], ast.Name) \
                        and it.args[-1].id in params:
                    bad = it.args[-1].id
                if bad:
                    yield make_finding(
                        recompile_hazard, module,
                        f"Python `for` over traced value `{bad}` in "
                        f"`{scope.qualname}`: loop length becomes part "
                        "of the trace; use lax.scan/fori_loop",
                        node=n, symbol=scope.qualname)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                if n.id in mutable_globals \
                        and not _bound_below_module(scope, n.id):
                    yield make_finding(
                        recompile_hazard, module,
                        f"traced code in `{scope.qualname}` reads "
                        f"mutable module global `{n.id}`: its value is "
                        "baked in at trace time and silently goes "
                        "stale (or retraces)", node=n,
                        symbol=scope.qualname)
    yield from _static_arg_hazards(module, ctx, idx)


def _bound_below_module(scope, name):
    """Is ``name`` shadowed by any FUNCTION scope on the chain (the
    module root doesn't count — that's where the global itself lives)?"""
    s = scope
    while s is not None and s.parent is not None:
        if name in s.bound or name in s.children:
            return True
        s = s.parent
    return False


def _mutable_module_globals(module):
    """Module-level names bound to mutable literals, or rebound more
    than once at module level."""
    counts, mutable = {}, set()
    for node in module.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    counts[t.id] = counts.get(t.id, 0) + 1
                    if isinstance(node.value, (ast.List, ast.Dict,
                                               ast.Set)):
                        mutable.add(t.id)
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Name):
            mutable.add(node.target.id)
    mutable.update(n for n, c in counts.items() if c > 1)
    return mutable


def _static_arg_hazards(module, ctx, idx):
    """`f = jax.jit(g, static_argnums=(1,)); f(x, [1, 2])` — the list
    is unhashable, so every call raises (or, with tuple-ish coercions
    upstream, recompiles per call)."""
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            continue
        call = node.value
        if _callable_kind(dotted(call.func)) != "jit":
            continue
        static_nums, static_names = set(), set()
        for kw in call.keywords:
            if kw.arg == "static_argnums":
                static_nums = _int_tuple(kw.value)
            elif kw.arg == "static_argnames":
                static_names = _str_tuple(kw.value)
        if not static_nums and not static_names:
            continue
        jitted = node.targets[0].id
        fscope = idx._enclosing_scope(node)
        for n in _own_statements(fscope.node) \
                if _is_funcdef(fscope.node) else ast.walk(module.tree):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name)
                    and n.func.id == jitted):
                continue
            for i, a in enumerate(n.args):
                if i in static_nums and isinstance(
                        a, (ast.List, ast.Dict, ast.Set)):
                    yield make_finding(
                        recompile_hazard, module,
                        f"unhashable {type(a).__name__.lower()} literal "
                        f"passed to static arg {i} of jitted "
                        f"`{jitted}`", node=a, symbol=fscope.qualname)
            for kw in n.keywords:
                if kw.arg in static_names and isinstance(
                        kw.value, (ast.List, ast.Dict, ast.Set)):
                    yield make_finding(
                        recompile_hazard, module,
                        "unhashable "
                        f"{type(kw.value).__name__.lower()} literal "
                        f"passed to static arg `{kw.arg}` of jitted "
                        f"`{jitted}`", node=kw.value,
                        symbol=fscope.qualname)


def _int_tuple(node):
    out = set()
    elts = node.elts if isinstance(node, (ast.Tuple, ast.List)) \
        else [node]
    for e in elts:
        if isinstance(e, ast.Constant) and isinstance(e.value, int):
            out.add(e.value)
    return out


def _str_tuple(node):
    out = set()
    elts = node.elts if isinstance(node, (ast.Tuple, ast.List)) \
        else [node]
    for e in elts:
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            out.add(e.value)
    return out


# -- SPK103: PRNG key reuse -------------------------------------------------

_KEY_DERIVERS = {"split", "fold_in", "PRNGKey", "key", "clone",
                 "key_data", "wrap_key_data"}


@rule("SPK103", "prng-key-reuse", SEVERITY_ERROR)
def prng_key_reuse(module, ctx):
    """The same PRNG key consumed by two `jax.random.*` sampler calls
    without an intervening split/fold_in rebind — the draws are
    identical, which silently correlates what should be independent
    noise (dropout masks, init, augmentation). Also flags a sampler
    consuming, inside a loop, a key that was created outside the loop
    (every iteration redraws the same randomness)."""
    aliases = random_aliases(module)
    root, by_node = build_scopes(module)
    seen = set()

    def is_sampler(call):
        d = dotted(call.func)
        if d is None:
            return False
        head, _, tail = d.rpartition(".")
        return head in aliases and tail not in _KEY_DERIVERS

    def is_key_expr(expr):
        if isinstance(expr, ast.Call):
            d = dotted(expr.func)
            if d:
                head, _, tail = d.rpartition(".")
                if head in aliases and tail in _KEY_DERIVERS:
                    return True
        if isinstance(expr, ast.Subscript) and is_key_expr(expr.value):
            return True
        return False

    def walk_fn(fnode, qual):
        if id(fnode) in seen:
            return
        seen.add(id(fnode))
        keys = {}
        # params that are by-convention PRNG keys are tracked from the
        # start — `rng` consumed twice inside one body is the bug
        # whether the key was made here or passed in
        for a in fnode.args.posonlyargs + fnode.args.args \
                + fnode.args.kwonlyargs:
            n = a.arg.lower()
            if n in ("rng", "key", "rngs", "prng_key") \
                    or n.endswith("_rng") or n.endswith("_key"):
                keys[a.arg] = [0, None]
        body = fnode.body if isinstance(fnode.body, list) else []
        yield from walk_block(body, keys, 0, qual)

    def walk_block(stmts, keys, loop_depth, qual):
        # keys: name -> [bound_loop_depth, consumed_line_or_None]
        for st in stmts:
            if _is_funcdef(st):
                continue                 # separate scope, walked below
            # find sampler consumptions anywhere in this statement
            for call in _calls_in(st):
                if not is_sampler(call) or not call.args:
                    continue
                a = call.args[0]
                if not isinstance(a, ast.Name) or a.id not in keys:
                    continue
                rec = keys[a.id]
                if rec[1] is not None:
                    yield make_finding(
                        prng_key_reuse, module,
                        f"PRNG key `{a.id}` reused: already consumed "
                        f"by a jax.random call at line {rec[1]}; "
                        "split/fold_in a fresh key instead",
                        node=call, symbol=qual)
                elif rec[0] < loop_depth:
                    yield make_finding(
                        prng_key_reuse, module,
                        f"PRNG key `{a.id}` consumed inside a loop but "
                        "created outside it: every iteration draws "
                        "identical randomness; fold_in the loop index",
                        node=call, symbol=qual)
                    rec[1] = call.lineno
                else:
                    rec[1] = call.lineno
            # then process (re)bindings this statement makes
            if isinstance(st, ast.Assign):
                names = []
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        names.append(t.id)
                    elif isinstance(t, ast.Tuple):
                        names.extend(e.id for e in t.elts
                                     if isinstance(e, ast.Name))
                if is_key_expr(st.value):
                    for nm in names:
                        keys[nm] = [loop_depth, None]
                else:
                    for nm in names:
                        keys.pop(nm, None)
            # recurse into compound statements
            if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                inner = dict((k, list(v)) for k, v in keys.items())
                yield from walk_block(st.body, inner, loop_depth + 1,
                                      qual)
                yield from walk_block(st.orelse, keys, loop_depth, qual)
            elif isinstance(st, ast.If):
                then_keys = dict((k, list(v)) for k, v in keys.items())
                else_keys = dict((k, list(v)) for k, v in keys.items())
                yield from walk_block(st.body, then_keys, loop_depth,
                                      qual)
                yield from walk_block(st.orelse, else_keys, loop_depth,
                                      qual)
                # a key is consumed after the If only if BOTH branches
                # consumed it (conservative: no false reuse reports
                # across exclusive branches)
                for nm, rec in keys.items():
                    t = then_keys.get(nm, [0, None])[1]
                    e = else_keys.get(nm, [0, None])[1]
                    if t is not None and e is not None:
                        rec[1] = rec[1] or t
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                yield from walk_block(st.body, keys, loop_depth, qual)
            elif isinstance(st, ast.Try):
                for blk in (st.body, st.orelse, st.finalbody):
                    yield from walk_block(blk, keys, loop_depth, qual)
                for h in st.handlers:
                    yield from walk_block(h.body, keys, loop_depth, qual)
        return

    def _calls_in(stmt):
        """Calls in this statement, excluding nested function bodies
        AND nested statement blocks (compound statements only expose
        their header expressions here; their bodies are re-walked with
        the right loop depth / branch state by walk_block)."""
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            roots = [stmt.iter]
        elif isinstance(stmt, (ast.While, ast.If)):
            roots = [stmt.test]
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            roots = [i.context_expr for i in stmt.items]
        elif isinstance(stmt, ast.Try):
            roots = []
        else:
            roots = [stmt]
        stack = list(roots)
        while stack:
            n = stack.pop()
            if _is_funcdef(n) and n is not stmt:
                continue
            if isinstance(n, ast.Call):
                yield n
            for c in ast.iter_child_nodes(n):
                if not _is_funcdef(c):
                    stack.append(c)

    for node, scope in by_node.items():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from walk_fn(node, scope.qualname)


# -- SPK104: collective axis-name mismatch ----------------------------------

_COLLECTIVES = {"psum", "pmean", "pmax", "pmin", "all_gather",
                "all_to_all", "ppermute", "pshuffle", "psum_scatter",
                "axis_index", "pswapaxes"}
# which argument of each collective is the axis name
_AXIS_ARG = {"axis_index": 0, "ppermute": 1, "pshuffle": 1}
# collectives whose `axis=` KWARG is an array dimension, not the mesh
# axis name (all_gather(x, axis_name, *, axis=0, tiled=...) and
# friends) — the axis name is positional there, never that kwarg
_DIM_AXIS_KWARG = {"all_gather", "all_to_all", "pswapaxes"}


def _collective_axis_expr(call):
    d = dotted(call.func)
    if d is None:
        return None, None
    tail = d.rpartition(".")[2]
    if tail not in _COLLECTIVES:
        return None, None
    for kw in call.keywords:
        if kw.arg == "axis_name" or (kw.arg == "axis"
                                     and tail not in _DIM_AXIS_KWARG):
            return tail, kw.value
    pos = _AXIS_ARG.get(tail, 1)
    if len(call.args) > pos:
        return tail, call.args[pos]
    return tail, None


def collect_axis_helpers(module):
    """{function basename: set of param indices forwarded as a
    collective axis argument} — the cross-module summary that lets call
    sites of masked_consensus & co. be checked against the caller's
    declared axes."""
    out = {}
    root, by_node = build_scopes(module)
    for node, scope in by_node.items():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = scope.params()
        fwd = set()
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            tail, axis_expr = _collective_axis_expr(n)
            if tail and isinstance(axis_expr, ast.Name) \
                    and axis_expr.id in params:
                fwd.add(params.index(axis_expr.id))
        if fwd:
            out.setdefault(node.name, set()).update(fwd)
    return out


@rule("SPK104", "collective-axis-mismatch", SEVERITY_ERROR)
def collective_axis_mismatch(module, ctx):
    """A collective (pmean/psum/all_gather/axis_index/...) names an
    axis the enclosing pmap/shard_map does not declare — at runtime
    this is a NameError deep inside the compiled call, or worse, a
    reduction over the wrong axis. Only fires when both the declared
    mesh axes and the collective's axis argument resolve statically;
    calls through axis-forwarding helpers (e.g. masked_consensus) are
    checked at the call site."""
    idx = get_trace_index(module, ctx)
    for scope, rootq in idx.traced.items():
        axes = idx.axes.get(scope)
        if not axes:
            continue
        for n in _own_statements(scope.node):
            if not isinstance(n, ast.Call):
                continue
            tail, axis_expr = _collective_axis_expr(n)
            if tail:
                for val, enode in _axis_literals(axis_expr, scope, ctx):
                    if val not in axes:
                        yield make_finding(
                            collective_axis_mismatch, module,
                            f"collective `{tail}` uses axis "
                            f"`{val}` but the enclosing mesh declares "
                            f"{sorted(axes)}", node=enode or n,
                            symbol=scope.qualname)
                continue
            # helper forwarding: f(..., "axis", ...) where f is known
            # to forward that param to a collective
            fname = None
            if isinstance(n.func, ast.Name):
                fname = n.func.id
            elif isinstance(n.func, ast.Attribute):
                fname = n.func.attr
            helper_idxs = ctx.axis_helpers.get(fname)
            if not helper_idxs:
                continue
            for i in helper_idxs:
                if i < len(n.args):
                    for val, enode in _axis_literals(n.args[i], scope,
                                                     ctx):
                        if val not in axes:
                            yield make_finding(
                                collective_axis_mismatch, module,
                                f"`{fname}` forwards axis `{val}` to a "
                                "collective but the enclosing mesh "
                                f"declares {sorted(axes)}",
                                node=n, symbol=scope.qualname)


def _axis_literals(expr, scope, ctx):
    """Resolvable string axis names in an axis expression (handles
    tuples of axes); yields (value, node)."""
    if expr is None:
        return
    if isinstance(expr, (ast.Tuple, ast.List)):
        for e in expr.elts:
            yield from _axis_literals(e, scope, ctx)
        return
    v = _axis_value(expr, scope, ctx)
    if v is not None:
        yield v, expr


# -- SPK105: missing buffer donation ----------------------------------------

_STATE_PARAMS = {"params", "state", "history", "opt_state",
                 "optimizer_state", "variables", "weights"}


@rule("SPK105", "missing-donation", SEVERITY_WARN)
def missing_donation(module, ctx):
    """A jitted update-style function — it takes params/state/history
    AND returns them — without donate_argnums/donate_argnames: every
    step allocates a second copy of the model in HBM instead of
    updating in place. Eval-style functions (state in, scores out) are
    exempt — donating their params would free buffers the next call
    still needs."""
    idx = get_trace_index(module, ctx)
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if _callable_kind(dotted(node.func)) != "jit":
            continue
        if any(kw.arg in ("donate_argnums", "donate_argnames")
               for kw in node.keywords):
            continue
        if not node.args:
            continue
        scope = idx._enclosing_scope(node)
        target, tscope = _unwrap_target(node.args[0], scope)
        if target is None or not _is_funcdef(target) \
                or isinstance(target, ast.Lambda):
            continue
        tparams = [p.arg for p in target.args.args]
        statey = [p for p in tparams if p in _STATE_PARAMS]
        if not statey:
            continue
        returned = set()
        for n in ast.walk(target):
            if isinstance(n, ast.Return) and n.value is not None:
                vals = n.value.elts if isinstance(n.value, ast.Tuple) \
                    else [n.value]
                returned.update(v.id for v in vals
                                if isinstance(v, ast.Name))
        carried = [p for p in statey if p in returned]
        if carried:
            yield make_finding(
                missing_donation, module,
                f"jit of `{target.name}` carries {carried} through the "
                "update but declares no donate_argnums: each step pays "
                "a full extra copy of those buffers in HBM",
                node=node, symbol=idx.by_node[target].qualname
                if target in idx.by_node else target.name)
