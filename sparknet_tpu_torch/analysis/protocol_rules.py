"""SPK3xx — the distributed file-protocol rules.

The resilience layer has no control plane: hosts coordinate entirely
through files on the shared filesystem (heartbeats ``hb-*.json``,
consensus parts ``part-*.npz``, masks, restart barriers, checkpoint
manifests ``*.latest.json``). The protocol survives crashes only if
every write is atomic — unique temp name, fsync, ``os.replace`` — and
every wait on another host is bounded. These rules enforce that
discipline repo-wide, using the ProjectIndex to expand path
expressions (f-strings, constants, ``*_path`` helper returns) into
literal fragments so ``self._part_path(h, r)`` is recognized as a
rendezvous file two modules away.

Rules:
  SPK301 (error)  ``open(path, "w")`` / ``np.savez(path, ...)`` on a
                  protocol-marked path with no temp-file tag — a
                  reader (or the crash-restart scan) can observe the
                  torn half-written file. Use
                  ``checkpoint.atomic_write_bytes/atomic_write_json``.
  SPK302 (warn)   ``os.replace(src, dst)`` whose source is not created
                  in the same scope (no local assignment, no matching
                  ``open``) — the tmp+replace pair is split across
                  functions, where crash-cleanup and the unique-name
                  discipline rot independently.
  SPK303 (error)  a gate/barrier/manifest wait whose result is
                  discarded AND that passes no ``timeout=`` — a lost
                  peer parks this caller forever with nothing
                  (quorum check, eviction) to unstick it.
  SPK304 (error)  ``sys.exit``/``os._exit``/``SystemExit`` with a raw
                  integer literal — exit codes are a cross-process
                  protocol (the launcher pattern-matches them), so
                  they come from ``utils/exit_codes.py``, nowhere
                  else.
"""

import ast

from .engine import rule, make_finding, SEVERITY_ERROR, SEVERITY_WARN
from .project import dotted

# substrings that mark a path as part of the on-disk coordination
# protocol (heartbeats, consensus parts, masks, deltas, restart
# barriers, checkpoint snapshots + manifests)
_PROTOCOL_MARKERS = ("hb-", "part-", "mask-", "delta-", "consensus-",
                     "restart-", ".latest.json", "_iter_",
                     ".solverstate", ".caffemodel", ".lm.npz")

_WRITE_MODES = {"w", "wb", "w+", "wb+", "wt", "x", "xb"}

_SAVEZ_CALLS = {"np.savez", "np.savez_compressed", "numpy.savez",
                "numpy.savez_compressed"}

_GATE_CALLS = {"gate", "restart_barrier", "wait_for_manifest"}

_EXIT_CALLS = {"sys.exit", "os._exit", "exit", "SystemExit"}


def _functions_with_calls(module):
    """Yield (enclosing function or None, qualname, call node) for
    every Call in the module, tracking the scope stack."""

    def walk(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Call):
                fn = None
                for s in reversed(stack):
                    if isinstance(s, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        fn = s
                        break
                qual = ".".join(
                    s.name for s in stack
                    if isinstance(s, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.ClassDef))) or "<module>"
                yield fn, qual, child
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                yield from walk(child, stack + [child])
            else:
                yield from walk(child, stack)

    yield from walk(module.tree, [])


def _open_mode(call):
    """The literal mode of an ``open()`` call, default 'r'."""
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return "r"


def _protocol_marker(fragments):
    """The first protocol marker present in the expanded path, or None;
    tmp-tagged paths (any '.tmp' fragment) are exempt — they are the
    atomic protocol's own first half."""
    joined = "".join(fragments)
    if ".tmp" in joined or ".build." in joined:
        return None
    for marker in _PROTOCOL_MARKERS:
        if marker in joined:
            return marker
    return None


@rule("SPK301", "non-atomic-protocol-write", SEVERITY_ERROR)
def non_atomic_protocol_write(module, ctx):
    """Direct write to a rendezvous/checkpoint path. A peer polling the
    path (or the restart scan) can read the half-written file; a crash
    mid-write leaves a torn file that satisfies the existence check.
    Write to a unique temp name, fsync, then ``os.replace`` — i.e. use
    ``resilience.checkpoint.atomic_write_bytes``/``atomic_write_json``."""
    proj = ctx.project
    for fn, qual, call in _functions_with_calls(module):
        target = None
        if isinstance(call.func, ast.Name) and call.func.id == "open":
            if _open_mode(call) in _WRITE_MODES and call.args:
                target = call.args[0]
        elif dotted(call.func) in _SAVEZ_CALLS and call.args:
            target = call.args[0]
        if target is None:
            continue
        frags = proj.expr_fragments(target, module, fn)
        marker = _protocol_marker(frags)
        if marker is None:
            continue
        yield make_finding(
            non_atomic_protocol_write, module,
            f"non-atomic write to protocol path (marker `{marker}`) — "
            "a concurrent reader or crash-restart scan can observe the "
            "torn file; use atomic_write_bytes/atomic_write_json from "
            "resilience.checkpoint",
            node=call, symbol=qual)


@rule("SPK302", "replace-source-not-local", SEVERITY_WARN)
def replace_source_not_local(module, ctx):
    """``os.replace(src, dst)`` where ``src`` is not created in the
    same scope (not assigned locally, never opened here). Splitting the
    tmp-write from its commit across functions is how the unique-name
    and crash-cleanup halves of the discipline drift apart."""
    for fn, qual, call in _functions_with_calls(module):
        if dotted(call.func) != "os.replace" or len(call.args) < 2:
            continue
        src = call.args[0]
        if not isinstance(src, (ast.Name, ast.Attribute, ast.Constant)):
            continue                    # inline expression: built here
        scope = fn if fn is not None else module.tree
        created = False
        src_dump = ast.dump(src)
        for n in ast.walk(scope):
            if isinstance(n, ast.Assign) and isinstance(src, ast.Name) \
                    and any(isinstance(leaf, ast.Name) and
                            leaf.id == src.id
                            for t in n.targets
                            for leaf in ast.walk(t)):
                created = True
                break
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id == "open" and n.args \
                    and ast.dump(n.args[0]) == src_dump:
                created = True
                break
        if created:
            continue
        yield make_finding(
            replace_source_not_local, module,
            "os.replace source is not created in this scope — keep the "
            "tmp write and its os.replace commit in one function (or "
            "use checkpoint.atomic_write_bytes, which does both)",
            node=call, symbol=qual)


@rule("SPK303", "unbounded-gate-wait", SEVERITY_ERROR)
def unbounded_gate_wait(module, ctx):
    """A rendezvous wait (``gate``/``restart_barrier``/
    ``wait_for_manifest``) whose result is discarded and that passes no
    ``timeout=``: when a peer dies mid-round, this caller parks forever
    and the quorum/eviction machinery never runs. Pass ``timeout=`` and
    act on the result (evict the dead, or abort with
    EXIT_QUORUM_LOST)."""
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Expr) and
                isinstance(node.value, ast.Call)):
            continue
        call = node.value
        f = call.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name not in _GATE_CALLS:
            continue
        if any(kw.arg == "timeout" for kw in call.keywords):
            continue
        yield make_finding(
            unbounded_gate_wait, module,
            f"`{name}(...)` result discarded with no timeout= — a dead "
            "peer parks this caller forever; bound the wait and handle "
            "the stragglers in the result",
            node=call, symbol="")


@rule("SPK304", "raw-exit-code", SEVERITY_ERROR)
def raw_exit_code(module, ctx):
    """Exit with a raw integer literal. Exit codes are a cross-process
    protocol — the multi-host launcher and the restart logic
    pattern-match them — so every exit goes through the canonical
    table in ``sparknet_tpu_torch/utils/exit_codes.py``."""
    table = ctx.project.exit_table
    for fn, qual, call in _functions_with_calls(module):
        d = dotted(call.func)
        if d not in _EXIT_CALLS:
            continue
        if not (call.args and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, int)
                and not isinstance(call.args[0].value, bool)):
            continue
        n = call.args[0].value
        known = table.get(n)
        hint = (f"use `{known}`" if known else
                "add a named constant") + \
            " from sparknet_tpu_torch.utils.exit_codes"
        yield make_finding(
            raw_exit_code, module,
            f"raw exit-code literal `{n}` — exit codes are a "
            f"cross-process protocol; {hint}",
            node=call, symbol=qual)
