"""The checker framework under `sparknet lint`.

One pass parses every target file into a :class:`Module` (source, AST,
inline suppressions); registered rules then visit each module and yield
:class:`Finding`s. The engine owns everything rule-independent:

  * per-line ``# spk: disable=CODE[,CODE]`` (and bare ``disable``)
    suppressions, plus file-level ``# spk: disable-file=CODE``
  * stable fingerprints — code + path + enclosing symbol + message
    (never the line number), so a committed baseline survives edits
    above a finding
  * rule registry + severity ("error" blocks, "warn" informs; --strict
    promotes everything)

Rules are plain functions ``rule(module, ctx) -> iterable[Finding]``
registered with :func:`rule`; ``ctx`` is the :class:`LintContext`
holding cross-module summaries (module-level string constants for axis
resolution, collective-helper signatures) built before any rule runs.

No jax imports anywhere in this package: the linter must run on hosts
with no accelerator stack at all.
"""

import ast
import hashlib
import os
import re
import tokenize


SEVERITY_ERROR = "error"
SEVERITY_WARN = "warn"

_SKIP_DIRS = {"__pycache__", ".git", ".eggs", "build", "dist",
              "node_modules", ".tox", ".venv"}

_SUPPRESS_RE = re.compile(
    r"#\s*spk:\s*disable(?:-file)?\s*(?:=\s*([A-Za-z0-9_,\s]+))?")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*spk:\s*disable-file\s*(?:=\s*([A-Za-z0-9_,\s]+))?")

ALL = "*"


class Finding:
    """One diagnostic: a rule code anchored to a file/line, with the
    enclosing symbol (function/class qualname) carried for baseline
    fingerprinting."""

    __slots__ = ("code", "message", "path", "line", "col", "severity",
                 "symbol", "rule_name", "_occurrence")

    def __init__(self, code, message, path, line, col=0,
                 severity=SEVERITY_ERROR, symbol="", rule_name=""):
        self.code = code
        self.message = message
        self.path = path
        self.line = int(line)
        self.col = int(col)
        self.severity = severity
        self.symbol = symbol
        self.rule_name = rule_name
        self._occurrence = 0            # disambiguates identical findings

    def fingerprint(self):
        """Stable identity for baseline matching: everything but the
        line/col — and with digit runs normalized out of the message,
        since some messages cite other lines ("consumed at line N") —
        so edits above the finding don't invalidate the baseline entry.
        Identical (code, path, symbol, message) repeats are
        disambiguated by an occurrence index in line order (set by the
        engine)."""
        h = hashlib.sha256()
        msg = re.sub(r"\d+", "#", self.message)
        for part in (self.code, self.path, self.symbol, msg,
                     str(self._occurrence)):
            h.update(part.encode("utf-8", "replace"))
            h.update(b"\0")
        return h.hexdigest()[:16]

    def sort_key(self):
        return (self.path, self.line, self.col, self.code, self.message)

    def render(self):
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.code} {self.severity}: {self.message}")

    def to_dict(self):
        return {"code": self.code, "severity": self.severity,
                "path": self.path, "line": self.line, "col": self.col,
                "symbol": self.symbol, "message": self.message,
                "rule": self.rule_name,
                "fingerprint": self.fingerprint()}

    def __repr__(self):
        return f"<Finding {self.render()}>"


class Module:
    """One parsed source file: AST + the comment-derived metadata rules
    need (suppressions, per-line raw text for annotation comments)."""

    def __init__(self, path, relpath, source, tree):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self._suppress = None           # line -> set of codes (or ALL)
        self._suppress_file = None      # set of codes (or ALL)

    @classmethod
    def load(cls, path, root):
        with tokenize.open(path) as f:   # honors coding: declarations
            source = f.read()
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        tree = ast.parse(source, filename=path)
        return cls(path, relpath, source, tree)

    def _scan_suppressions(self):
        per_line, whole = {}, set()
        for i, text in enumerate(self.lines, start=1):
            if "spk:" not in text:
                continue
            fm = _SUPPRESS_FILE_RE.search(text)
            if fm:
                codes = _parse_codes(fm.group(1))
                whole |= codes
                continue
            m = _SUPPRESS_RE.search(text)
            if m:
                per_line.setdefault(i, set()).update(
                    _parse_codes(m.group(1)))
        self._suppress, self._suppress_file = per_line, whole

    def suppressed(self, code, line):
        """Is ``code`` suppressed at ``line`` (inline or file-level)?"""
        if self._suppress is None:
            self._scan_suppressions()
        if ALL in self._suppress_file or code in self._suppress_file:
            return True
        codes = self._suppress.get(line)
        return bool(codes) and (ALL in codes or code in codes)

    def line_text(self, line):
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


def _parse_codes(group):
    if not group or not group.strip():
        return {ALL}
    return {c.strip().upper() for c in group.split(",") if c.strip()}


# -- rule registry ----------------------------------------------------------

_RULES = []
ALL_CODES = {}


def rule(code, name, severity=SEVERITY_ERROR):
    """Register a rule function ``fn(module, ctx) -> iter[Finding]``.
    The decorator stamps code/name/severity so the rule only yields
    (message, node-or-line[, col]) tuples or full Findings."""
    def deco(fn):
        fn.code, fn.rule_name, fn.severity = code, name, severity
        _RULES.append(fn)
        ALL_CODES[code] = (name, severity, (fn.__doc__ or "").strip())
        return fn
    return deco


def all_rules():
    _load_rules()
    return list(_RULES)


_loaded = False


def _load_rules():
    global _loaded
    if _loaded:
        return
    _loaded = True
    # engine-emitted, not a visitor rule: a file that does not parse
    # cannot be checked at all, which is itself a finding
    ALL_CODES.setdefault(
        "SPK001", ("parse-error", SEVERITY_ERROR,
                   "File does not parse; nothing else can be checked."))
    from . import (jax_rules, thread_rules, protocol_rules,  # noqa: F401
                   metrics_rules)                            # (registration)


# -- helpers rules share ----------------------------------------------------

def make_finding(fn, module, message, node=None, line=None, col=None,
                 symbol="", severity=None):
    """Build a Finding for rule ``fn`` anchored at ``node`` (or an
    explicit line/col)."""
    if node is not None:
        line = getattr(node, "lineno", line or 1)
        col = getattr(node, "col_offset", col or 0)
    return Finding(fn.code, message, module.relpath, line or 1, col or 0,
                   severity=severity or fn.severity, symbol=symbol,
                   rule_name=fn.rule_name)


def qualname_of(stack):
    """Dotted symbol for a scope stack of ast nodes (class/function
    names, '<lambda>' for lambdas)."""
    parts = []
    for n in stack:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            parts.append(n.name)
        elif isinstance(n, ast.Lambda):
            parts.append("<lambda>")
    return ".".join(parts)


class LintContext:
    """Cross-module facts built before any rule runs.

    str_constants: UPPERCASE module-level string assignments from every
        scanned module (``DATA_AXIS = "data"``), keyed by bare name —
        the linter's one-level constant propagation for axis names.
        Name collisions keep the first value seen and mark the name
        ambiguous (resolution then declines to answer).
    axis_helpers: {function basename: set of parameter indices that the
        function forwards as a collective axis argument} — lets a call
        like ``masked_consensus(tree, valid, "data")`` be checked
        against the caller's declared mesh axes even though the psum
        lives in another module (resilience/elastic.py).
    project: the :class:`~.project.ProjectIndex` — module graph,
        class/method + call-edge resolution, expression-fragment
        constant propagation, event/kind registries, exit table.
        The SPK2xx/3xx/4xx cross-module families query this.
    """

    def __init__(self, modules):
        self.modules = modules
        self.str_constants = {}
        self._ambiguous = set()
        self.axis_helpers = {}
        for m in modules:
            self._collect_constants(m)
        _load_rules()
        from .jax_rules import collect_axis_helpers
        from .project import ProjectIndex
        for m in modules:
            for name, idxs in collect_axis_helpers(m).items():
                self.axis_helpers.setdefault(name, set()).update(idxs)
        self.project = ProjectIndex(modules)

    def _collect_constants(self, module):
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                name = node.targets[0].id
                if not name.isupper():
                    continue
                if name in self.str_constants and \
                        self.str_constants[name] != node.value.value:
                    self._ambiguous.add(name)
                else:
                    self.str_constants.setdefault(name, node.value.value)

    def resolve_str_constant(self, name):
        if name in self._ambiguous:
            return None
        return self.str_constants.get(name)


def _lint_module(module, ctx, select):
    """All unsuppressed findings for one module — the per-file unit of
    work the cache stores and the worker pool executes."""
    out = []
    for fn in all_rules():
        if select and fn.code not in select:
            continue
        try:
            found = list(fn(module, ctx))
        except RecursionError:              # pathological nesting: skip
            continue                        # the rule, not the run
        for f in found:
            if not module.suppressed(f.code, f.line):
                out.append(f)
    return out


# fork-pool plumbing: children inherit this via fork, so the parsed
# modules and the ProjectIndex are shared copy-on-write instead of
# pickled per task
_POOL_STATE = {}


def _pool_lint(i):
    ctx, select = _POOL_STATE["ctx"], _POOL_STATE["select"]
    return i, _lint_module(_POOL_STATE["modules"][i], ctx, select)


def _analysis_version():
    """Hash of this package's sources — cached results die with any
    rule change."""
    h = hashlib.sha256()
    pkg = os.path.dirname(os.path.abspath(__file__))
    for fn in sorted(os.listdir(pkg)):
        if fn.endswith(".py"):
            with open(os.path.join(pkg, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


class LintEngine:
    """Parse targets, run every registered rule (optionally across a
    worker pool, with a content-hash result cache), apply suppressions,
    stamp occurrence indices for stable fingerprints."""

    def __init__(self, select=None, exclude=None, jobs=1,
                 cache_path=None):
        self.select = set(select) if select else None
        self.exclude = list(exclude) if exclude else []
        self.jobs = max(1, int(jobs or 1))
        self.cache_path = cache_path

    def _excluded(self, path):
        norm = path.replace(os.sep, "/")
        import fnmatch
        for pat in self.exclude:
            if pat in norm or fnmatch.fnmatch(norm, pat) or \
                    any(fnmatch.fnmatch(part, pat)
                        for part in norm.split("/")):
                return True
        return False

    def collect_files(self, paths):
        files = []
        for p in paths:
            if os.path.isfile(p):
                if not self._excluded(p):
                    files.append(p)
                continue
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS
                                     and not d.startswith(".")
                                     and not self._excluded(
                                         os.path.join(dirpath, d)))
                for fn in sorted(filenames):
                    full = os.path.join(dirpath, fn)
                    if fn.endswith(".py") and not self._excluded(full):
                        files.append(full)
        return files

    # -- result cache ------------------------------------------------------

    def _load_cache(self):
        import json
        try:
            with open(self.cache_path) as f:
                data = json.load(f)
            if isinstance(data, dict) and \
                    isinstance(data.get("entries"), dict):
                return data["entries"]
        except (OSError, ValueError):
            pass
        return {}

    def _save_cache(self, entries):
        import json
        tmp = self.cache_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"entries": entries}, f)
            os.replace(tmp, self.cache_path)
        except OSError:
            pass

    @staticmethod
    def _file_key(module, ctx_fp):
        h = hashlib.sha256()
        h.update(module.source.encode("utf-8", "replace"))
        h.update(ctx_fp.encode())
        return h.hexdigest()[:24]

    @staticmethod
    def _finding_from_dict(d):
        return Finding(d["code"], d["message"], d["path"], d["line"],
                       d.get("col", 0), severity=d.get("severity",
                                                       SEVERITY_ERROR),
                       symbol=d.get("symbol", ""),
                       rule_name=d.get("rule", ""))

    def run(self, paths, root=None):
        """Lint ``paths`` (files or directories). Returns the sorted,
        unsuppressed findings. Unparseable files become SPK001 findings
        rather than crashes — a file that won't parse can't be checked,
        which is itself a finding."""
        root = root or os.getcwd()
        modules, findings = [], []
        for path in self.collect_files(paths):
            try:
                modules.append(Module.load(path, root))
            except (SyntaxError, ValueError, UnicodeDecodeError) as e:
                line = getattr(e, "lineno", 1) or 1
                findings.append(Finding(
                    "SPK001", f"file does not parse: {e}",
                    os.path.relpath(path, root).replace(os.sep, "/"),
                    line, severity=SEVERITY_ERROR,
                    symbol="<module>", rule_name="parse-error"))
        ctx = LintContext(modules)

        # cache key: file content + every cross-module input a rule can
        # see (project summaries, rule sources, selection) — editing one
        # file invalidates others only when a shared summary changed
        cache, ctx_fp = None, ""
        if self.cache_path:
            ctx_fp = "|".join([_analysis_version(),
                               ctx.project.fingerprint(),
                               ",".join(sorted(self.select or ()))])
            cache = self._load_cache()
        pending = []
        for i, module in enumerate(modules):
            if cache is not None:
                key = self._file_key(module, ctx_fp)
                hit = cache.get(module.relpath)
                if hit and hit.get("key") == key:
                    findings.extend(self._finding_from_dict(d)
                                    for d in hit.get("findings", ()))
                    continue
            pending.append(i)

        results = None
        if self.jobs > 1 and len(pending) > 1:
            results = self._run_pool(modules, ctx, pending)
        if results is None:
            results = {i: _lint_module(modules[i], ctx, self.select)
                       for i in pending}
        for i in pending:
            found = results.get(i, [])
            findings.extend(found)
            if cache is not None:
                cache[modules[i].relpath] = {
                    "key": self._file_key(modules[i], ctx_fp),
                    "findings": [f.to_dict() for f in found]}
        if cache is not None:
            live = {m.relpath for m in modules}
            self._save_cache({k: v for k, v in cache.items()
                              if k in live})

        findings.sort(key=Finding.sort_key)
        seen = {}
        for f in findings:
            # same normalization as Finding.fingerprint, so findings
            # that differ only in a cited line number still get
            # distinct occurrence indices
            key = (f.code, f.path, f.symbol,
                   re.sub(r"\d+", "#", f.message))
            f._occurrence = seen.get(key, 0)
            seen[key] = f._occurrence + 1
        return findings

    def _run_pool(self, modules, ctx, pending):
        """Fan pending modules over a fork pool; the children inherit
        the parsed modules and ProjectIndex copy-on-write. Returns
        {index: findings} or None when fork isn't available."""
        import multiprocessing
        try:
            mp = multiprocessing.get_context("fork")
        except ValueError:
            return None
        _POOL_STATE.update(modules=modules, ctx=ctx, select=self.select)
        try:
            with mp.Pool(min(self.jobs, len(pending))) as pool:
                return dict(pool.map(_pool_lint, pending))
        except Exception:
            return None                     # fall back to serial
        finally:
            _POOL_STATE.clear()


def lint_paths(paths, root=None, select=None):
    """Convenience wrapper: lint and return sorted findings."""
    return LintEngine(select=select).run(paths, root=root)
