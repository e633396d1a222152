"""Crash-safe snapshot manifests for training and serving.

The format is the JAX package's (sparknet_tpu/resilience/checkpoint.py):
a snapshot is a ``<prefix>_iter_<N>.caffemodel`` binaryproto NetParameter
plus a ``.solverstate`` (or, under ``snapshot_format: HDF5``, the
``.caffemodel.h5`` and ``.solverstate.h5`` pair), both committed by
atomic rename, and
``<prefix>.latest.json`` names them with their sha256 sums. The manifest
is written last (temp + fsync + rename), so a crash at any earlier point
leaves the previous manifest pointing at the previous complete snapshot.

  save_snapshot        a Solver's pair
  save_model_snapshot  the same files and entry without a solver
  find_resumable       the newest pair that verifies (manifested ones
                       first, then un-manifested ones), with the reason
                       every newer one was refused
  check_restorable     the guard of an explicit restore
  resume_auto          ``--resume auto``
  load_model_only      what serving reads

The port trains in one process on one device. The single-device Solver
stamps ``{"processes": 1}``, as the JAX package's does; the parallel
solvers, whose W worker slots stand in for a "data" mesh axis, stamp
``{"processes": 1, "mesh": {"data": W}}``, as the JAX package's do on a
W-device mesh. A restore compares the stamps as the JAX package does, so
snapshots restore in both directions between equal worlds.
"""

import glob
import hashlib
import itertools
import json
import os
import re
import threading
import time

MANIFEST_SUFFIX = ".latest.json"
_TMP_TAG = ".tmp."
_TMP_COUNTER = itertools.count()


def manifest_path(prefix):
    return prefix + MANIFEST_SUFFIX


def _sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(dirname):
    """Durability of the rename itself. Best-effort: some filesystems
    refuse O_RDONLY on directories."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _tmp_name(path):
    """A temp sibling of ``path`` unique to this (process, thread, call);
    the _TMP_TAG marker keeps every half-written file recognizable."""
    return (f"{path}{_TMP_TAG}{os.getpid()}."
            f"{threading.get_ident()}.{next(_TMP_COUNTER)}")


def atomic_write_bytes(path, write_fn, fsync_dir=False):
    """``write_fn(f)`` receives the binary temp file; after it returns
    the file is flushed, fsync'd, and atomically renamed to ``path`` — a
    crash at any point leaves either the old file or a recognizable
    ``.tmp.`` orphan, never a torn ``path``."""
    tmp = _tmp_name(path)
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):         # write_fn raised: no partials
            try:
                os.remove(tmp)
            except OSError:
                pass
    if fsync_dir:
        _fsync_dir(os.path.dirname(path))


def atomic_write_json(path, obj, indent=None, sort_keys=False,
                      fsync_dir=False):
    data = json.dumps(obj, indent=indent, sort_keys=sort_keys)
    atomic_write_bytes(path, lambda f: f.write(data.encode("utf-8")),
                       fsync_dir=fsync_dir)


def load_manifest(prefix):
    """The manifest dict, or None when missing/corrupt (a torn manifest
    write must read as "no manifest", not an error)."""
    try:
        with open(manifest_path(prefix)) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    return man if isinstance(man, dict) else None


class WorldMismatch(RuntimeError):
    """A snapshot written by a different world (process count or mesh
    shape) than the one restoring it. Not a ValueError, as in the JAX
    package: a damaged snapshot is one file's fault, a world mismatch
    damns every snapshot under the prefix."""


def world_signature(solver=None):
    """The world a snapshot is resumable in: one process, and for the
    parallel solvers their worker slots as the "data" mesh axis
    (``solver.mesh_shape``)."""
    sig = {"processes": 1}
    mesh = getattr(solver, "mesh_shape", None)
    if mesh:
        sig["mesh"] = {str(k): int(v) for k, v in mesh.items()}
    return sig


def check_world(entry, world, state_path):
    """Raise WorldMismatch when manifest ``entry`` carries a world stamp
    that disagrees with ``world`` (the restoring solver's
    world_signature): another process count, or another mesh where both
    stamps name one. Entries without a stamp pass."""
    want = entry.get("world") if isinstance(entry, dict) else None
    if not want or not world:
        return
    mismatches = []
    if want.get("processes") is not None and \
            int(want["processes"]) != int(world["processes"]):
        mismatches.append(f"process count {want['processes']} vs "
                          f"{world['processes']}")
    if want.get("mesh") and world.get("mesh") and \
            dict(want["mesh"]) != dict(world["mesh"]):
        mismatches.append(f"mesh {want['mesh']} vs {world['mesh']}")
    if mismatches:
        raise WorldMismatch(
            f"snapshot {state_path} was written by a different world: "
            f"snapshot world {want} vs this run's world {world} "
            f"({'; '.join(mismatches)}). Relaunch with the worker count "
            "the snapshot names, or start a new run under a different "
            "snapshot prefix; the port does not reshard snapshots.")


def _commit(prefix, model_path, state_path, write_files, iter_, world,
            format="binaryproto", keep=None, metrics=None):
    """Write a (model, state) pair of ``format`` through
    ``write_files(tmp_model, tmp_state)`` under temp names, fsync,
    checksum, rename both, then commit the manifest. ``keep``: retention
    — manifest entries beyond the newest N are dropped from it and their
    files deleted after the commit (None/0 keeps everything); with
    ``metrics`` a ``checkpoint`` event says how many were kept and
    dropped. Returns (model_path, state_path)."""
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tag = f"{_TMP_TAG}{os.getpid()}"
    tmp_model, tmp_state = model_path + tag, state_path + tag
    try:
        write_files(tmp_model, tmp_state)
        for p in (tmp_model, tmp_state):
            _fsync_file(p)
        entry = {
            "iter": int(iter_),
            "format": format,
            "model": os.path.basename(model_path),
            "state": os.path.basename(state_path),
            "sha256": {"model": _sha256(tmp_model),
                       "state": _sha256(tmp_state)},
            "bytes": {"model": os.path.getsize(tmp_model),
                      "state": os.path.getsize(tmp_state)},
            "time": round(time.time(), 3),
            "world": world,
        }
        os.replace(tmp_model, model_path)
        os.replace(tmp_state, state_path)
        _fsync_dir(d)
    finally:
        for p in (tmp_model, tmp_state):        # never leave partials
            if os.path.exists(p):
                try:
                    os.remove(p)
                except OSError:
                    pass
    man = load_manifest(prefix) or {}
    snaps = [e for e in man.get("snapshots", ())
             if isinstance(e, dict) and
             not (e.get("iter") == entry["iter"] and
                  e.get("format") == entry["format"])]
    snaps.append(entry)
    snaps.sort(key=lambda e: (e.get("iter", -1), e.get("time", 0)))
    dropped = []
    if keep and int(keep) > 0 and len(snaps) > int(keep):
        dropped, snaps = snaps[:-int(keep)], snaps[-int(keep):]
    atomic_write_json(manifest_path(prefix),
                      {"version": 1, "latest": entry, "snapshots": snaps},
                      indent=1, sort_keys=True, fsync_dir=True)
    for e in dropped:           # after the commit: never a dangling entry
        for k in ("model", "state"):
            if e.get(k):
                try:
                    os.remove(os.path.join(d, e[k]))
                except OSError:
                    pass
    if metrics is not None:
        metrics.log("checkpoint", iter=entry["iter"], format=format,
                    model=model_path, state=state_path,
                    bytes=entry["bytes"]["model"] + entry["bytes"]["state"],
                    kept=len(snaps), dropped=len(dropped))
    return model_path, state_path


def save_snapshot(solver, prefix, keep=None, metrics=None):
    """Atomically write one (model, state) snapshot pair for ``solver``,
    in its snapshot_format, and commit it to the manifest, keeping the
    newest ``keep`` (None/0: all); returns the final paths. The state
    file names the FINAL model path (SolverState.learned_net)."""
    model_path, state_path, format = solver._snapshot_paths(prefix)
    return _commit(
        prefix, model_path, state_path,
        lambda tm, ts: solver._write_snapshot_files(
            tm, ts, format, learned_net=model_path),
        solver.iter, world_signature(solver), format, keep=keep,
        metrics=metrics)


def save_model_snapshot(net, params, prefix, iter=0, state=None):
    """Write ``<prefix>_iter_<iter>.caffemodel`` (the binaryproto
    NetParameter of ``net`` with ``params``/``state`` as blobs) and a
    ``.solverstate`` holding only the iteration and the model's path,
    then commit both to the manifest exactly as save_snapshot does.
    Returns (model_path, state_path)."""
    from ..proto import Message, wire
    model_path = f"{prefix}_iter_{int(iter)}.caffemodel"
    state_path = f"{prefix}_iter_{int(iter)}.solverstate"

    def write(tmp_model, tmp_state):
        wire.dump(net.params_to_netproto(params, state), tmp_model)
        wire.dump(Message("SolverState", iter=int(iter),
                          learned_net=model_path, current_step=0), tmp_state)
    return _commit(prefix, model_path, state_path, write, iter,
                   world_signature())


def _verify_entry(d, entry):
    """Reason string this manifest entry is not restorable, or None."""
    for k in ("model", "state"):
        name = entry.get(k)
        if not name:
            return f"manifest entry has no {k} file recorded"
        path = os.path.join(d, name)
        if not os.path.exists(path):
            return f"{k} file {name} is missing"
        if os.path.getsize(path) == 0:
            return f"{k} file {name} is empty"
        want = (entry.get("sha256") or {}).get(k)
        if want and _sha256(path) != want:
            return f"{k} file {name} fails its sha256 check " \
                   "(truncated or corrupt)"
    return None


def _verify_model_entry(d, entry):
    """Reason string this entry's MODEL blob is not servable, or None.
    Serving never reads the optimizer-state file, so a missing or
    corrupt state blob does not disqualify a snapshot."""
    name = entry.get("model")
    if not name:
        return "manifest entry has no model file recorded"
    path = os.path.join(d, name)
    if not os.path.exists(path):
        return f"model file {name} is missing"
    if os.path.getsize(path) == 0:
        return f"model file {name} is empty"
    want = (entry.get("sha256") or {}).get("model")
    if want and _sha256(path) != want:
        return f"model file {name} fails its sha256 check " \
               "(truncated or corrupt)"
    return None


def load_model_only(prefix, log_fn=None):
    """Weights-only restore target: the newest manifest entry whose
    MODEL blob verifies -> (model_path, entry).

    Raises ValueError naming the manifest when there is no manifest at
    all or no entry's model blob verifies; every refused entry's reason
    is in the message (and logged via ``log_fn``). Serving trusts only
    sha256-stamped manifests: there is no legacy-pair fallback."""
    log = log_fn or (lambda *a: None)
    man_path = manifest_path(prefix)
    man = load_manifest(prefix)
    if man is None:
        raise ValueError(
            f"no checkpoint manifest at {man_path} (missing, torn, or "
            "corrupt) — write a snapshot first (training, or "
            "save_model_snapshot), or point --prefix at an existing "
            "manifest")
    d = os.path.dirname(prefix)
    refused = []
    entries = [man.get("latest")] + list(reversed(man.get("snapshots", [])))
    seen = set()
    for entry in entries:
        if not isinstance(entry, dict):
            continue
        key = (entry.get("iter"), entry.get("model"))
        if key in seen:
            continue
        seen.add(key)
        reason = _verify_model_entry(d, entry)
        if reason is None:
            for name, r in refused:
                log(f"refusing model blob {name}: {r}")
            return os.path.join(d, entry.get("model")), entry
        refused.append((entry.get("model") or "?", reason))
    detail = "; ".join(f"{name}: {r}" for name, r in refused) \
        or "manifest records no snapshots"
    raise ValueError(
        f"manifest {man_path} has no servable model blob ({detail})")


def find_resumable(prefix, log_fn=None, exclude=()):
    """Newest manifested snapshot for ``prefix`` whose pair verifies ->
    (state_path, skipped).

    skipped is [(state_path, reason), ...] for every newer snapshot that
    was refused (partial write, checksum mismatch, missing pair file).
    Returns (None, skipped) when nothing valid exists. Manifested
    snapshots are checksum-verified and come first; un-manifested pairs
    (``_iter_N.solverstate`` or ``.solverstate.h5`` beside its
    ``.caffemodel``/``.caffemodel.h5``, as a stock Caffe run leaves them)
    are only checked for existence and non-emptiness, as in the JAX
    package. ``exclude``: state paths to pass over even if they verify
    (resume_auto's fallback after a restore that failed)."""
    log = log_fn or (lambda *a: None)
    skipped, seen = [], set()
    exclude = {os.path.basename(p) for p in exclude}
    d = os.path.dirname(prefix)
    man = load_manifest(prefix)
    candidates = []
    for entry in reversed((man or {}).get("snapshots", [])):
        if not isinstance(entry, dict):
            continue
        path = os.path.join(d, entry.get("state") or "?")
        seen.add(os.path.basename(path))
        candidates.append((path, lambda e=entry: _verify_entry(d, e)))
    for _, model, path in _legacy_pairs(prefix):
        if os.path.basename(path) not in seen:  # the manifest ruled on it
            candidates.append((path, lambda m=model, s=path:
                               _verify_pair(m, s)))
    state = None
    for path, verify in candidates:
        if os.path.basename(path) in exclude:
            continue
        reason = verify()
        if reason is None:
            state = path
            break
        skipped.append((path, reason))
    for s, r in skipped:
        log(f"refusing snapshot {s}: {r}")
    return state, skipped


_ITER_RE = re.compile(r"_iter_(\d+)\.solverstate(\.h5)?$")


def _legacy_pairs(prefix):
    """Un-manifested (iter, model, state) snapshot pairs, newest first."""
    pairs = []
    for state in glob.glob(glob.escape(prefix) + "_iter_*.solverstate*"):
        m = _ITER_RE.search(state)
        if _TMP_TAG in state or not m:
            continue
        model = state[:m.start()] + f"_iter_{m.group(1)}.caffemodel" \
            + (m.group(2) or "")
        pairs.append((int(m.group(1)), model, state))
    return sorted(pairs, reverse=True)


def _verify_pair(model, state):
    """Why an un-manifested pair cannot be resumed from, or None."""
    if not os.path.exists(model):
        return f"model file {model} is missing"
    if os.path.getsize(model) == 0 or os.path.getsize(state) == 0:
        return "snapshot pair has an empty file (partial write)"
    return None


def check_restorable(state_path, world=None):
    """Guard an explicit restore(): if a manifest in the snapshot's
    directory covers this state file, verify the whole pair and raise
    ValueError naming the snapshot and the reason when it fails; raise
    WorldMismatch when its stamp names another world than ``world``
    (default: the single-device one).
    Temp files from torn writes are always refused. Returns the matched
    manifest entry, or None for an un-manifested snapshot."""
    if _TMP_TAG in os.path.basename(state_path):
        raise ValueError(f"refusing snapshot {state_path}: temp file from "
                         "an interrupted snapshot write")
    d = os.path.dirname(state_path)
    base = os.path.basename(state_path)
    for man_file in glob.glob(os.path.join(glob.escape(d) if d else ".",
                                           "*" + MANIFEST_SUFFIX)):
        man = load_manifest(man_file[:-len(MANIFEST_SUFFIX)])
        for entry in (man or {}).get("snapshots", []):
            if isinstance(entry, dict) and entry.get("state") == base:
                reason = _verify_entry(d, entry)
                if reason is not None:
                    raise ValueError(
                        f"refusing snapshot {state_path}: {reason}")
                check_world(entry, world or world_signature(),
                            state_path)
                return entry
    return None


def resume_auto(solver, prefix, log_fn=None):
    """``--resume auto``: restore ``solver`` from the newest valid
    snapshot under ``prefix``; returns the state path used, or None
    (fresh start). Every refused snapshot is logged with its reason.

    The verification and the restore are two reads: keep-N retention in
    a concurrent writer, or an external cleaner, can delete manifested
    files between them, and a manifest can outlive files a crashed
    pruner removed. A snapshot that verified but fails to restore is
    therefore logged with the reason and excluded, and the search falls
    back to the next valid one (as in the JAX package). WorldMismatch is
    not in the fallback set: a wrong-world stamp damns every snapshot
    under the prefix alike, so it propagates."""
    log = log_fn or (lambda *a: None)
    tried = []
    while True:
        state, skipped = find_resumable(prefix, log_fn=log, exclude=tried)
        if state is None:
            refused = len(skipped) + len(tried)
            log(f"resume auto: no resumable snapshot under {prefix!r}"
                + (f" ({refused} refused)" if refused else "")
                + "; starting fresh")
            return None
        try:
            solver.restore(state)
        except (OSError, ValueError, KeyError) as e:
            log(f"refusing snapshot {state}: restore failed ({e}); "
                "falling back to the next valid snapshot")
            tried.append(state)
            continue
        log(f"resume auto: restored iter {solver.iter} from {state}")
        if getattr(solver, "metrics", None) is not None:
            solver.metrics.log("checkpoint", kind="resume",
                               iter=solver.iter, state=state,
                               refused=len(skipped) + len(tried))
        return state
