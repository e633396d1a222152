"""Native host pipeline library: build on first use + ctypes bindings
(the port's copy of sparknet_tpu/native/__init__.py, over its own copy
of pipeline.cpp).

The reference shipped its native engine as a cmake-built libccaffe.so
loaded via JNA (CaffeLibrary.java:9); here the native surface is the
host data pipeline only (the card's kernels live in csrc/), compiled
lazily with g++ and loaded via ctypes. Everything has a numpy fallback
that gives the same numbers bit for bit — ``available()`` says which
path is active.

The library is built into ``sparknet_tpu_torch/_build/`` as
``libsparknet_native_<key>.so``: the key hashes the source, the compiler
flags and the host CPU's identity (``-march=native`` code built on one
machine must never load on another), so a stale or foreign build is
never loaded. A build goes to a per-pid temp file and is published with
``os.replace``, so concurrent builds (pytest workers, processes of one
run) never load a half-written file.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "pipeline.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_ABI = 3
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_identity():
    """The host CPU's model and feature flags (what -march=native reads),
    or the machine type where /proc/cpuinfo is absent."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8",
                  errors="replace") as f:
            keep = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(keep)))
    except OSError:
        return platform.machine()


def library_path():
    """Where the library for this source, these flags and this CPU
    lives (built or not)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_cpu_identity().encode())
    return os.path.join(BUILD_DIR,
                        f"libsparknet_native_{h.hexdigest()[:16]}.so")


def _build(so):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    base = ["g++"] + _FLAGS
    try:
        try:
            subprocess.run(base + ["-fopenmp", _SRC, "-o", tmp], check=True,
                           capture_output=True)
        except subprocess.CalledProcessError:   # no libgomp: one thread
            subprocess.run(base + [_SRC, "-o", tmp], check=True,
                           capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            if lib.native_abi_version() != _ABI:
                raise OSError(f"{so}: ABI {lib.native_abi_version()} "
                              f"!= {_ABI}")
            _bind(lib)
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _bind(lib):
    i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.transform_batch.argtypes = [
        u8p, i64, i64, i64, i64, i64, i32p, i32p, u8p, f32p,
        ctypes.c_int, ctypes.c_float, f32p]
    lib.transform_batch.restype = None
    lib.decode_cifar_records.argtypes = [u8p, i64, i64, u8p, i32p]
    lib.decode_cifar_records.restype = None
    lib.accumulate_sum.argtypes = [u8p, i64, i64, i64p]
    lib.accumulate_sum.restype = None
    lib.crc32c_update.argtypes = [u8p, i64, ctypes.c_uint32]
    lib.crc32c_update.restype = ctypes.c_uint32
    lib.snappy_uncompress.argtypes = [u8p, i64, u8p, i64]
    lib.snappy_uncompress.restype = i64


def available():
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def transform_batch(images, crop, ys=None, xs=None, mirror=None, mean=None,
                    scale=1.0, full_mean=False):
    """uint8 (N,C,H,W) -> float32 (N,C,crop,crop); native when possible.

    mean: None | (C,) per-channel | (C,crop,crop) cropped mean image
    (subtracted after the mirror) | with full_mean=True a (C,H,W)
    source-size mean image subtracted at the crop-window source index
    before the mirror — the reference mean_file semantics
    (data_transformer.cpp:42-51).
    ys/xs: per-image int32 crop offsets (None -> 0: top-left/no crop).
    mirror: per-image uint8 flags (None -> no flips).
    """
    lib = _load()
    images = np.ascontiguousarray(images, np.uint8)
    n, c, h, w = images.shape
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        if mean.ndim == 1:
            mean_kind = 1
        elif full_mean:
            mean_kind = 3
            if mean.shape != (c, h, w):
                raise ValueError(
                    f"full mean shape {mean.shape} != {(c, h, w)}")
        else:
            mean_kind = 2
            if mean.shape != (c, crop, crop):
                raise ValueError(
                    f"mean shape {mean.shape} != {(c, crop, crop)}")
    else:
        mean_kind = 0
    out = np.empty((n, c, crop, crop), np.float32)
    if lib is not None:
        ys_a = np.ascontiguousarray(ys, np.int32) if ys is not None else None
        xs_a = np.ascontiguousarray(xs, np.int32) if xs is not None else None
        mir = np.ascontiguousarray(mirror, np.uint8) \
            if mirror is not None else None
        lib.transform_batch(
            _ptr(images, ctypes.c_uint8), n, c, h, w, crop,
            _ptr(ys_a, ctypes.c_int32) if ys_a is not None else None,
            _ptr(xs_a, ctypes.c_int32) if xs_a is not None else None,
            _ptr(mir, ctypes.c_uint8) if mir is not None else None,
            _ptr(mean, ctypes.c_float) if mean is not None else None,
            mean_kind, ctypes.c_float(scale), _ptr(out, ctypes.c_float))
        return out
    for i in range(n):
        y0 = int(ys[i]) if ys is not None else 0
        x0 = int(xs[i]) if xs is not None else 0
        win = images[i, :, y0:y0 + crop, x0:x0 + crop].astype(np.float32)
        if mean_kind == 3:  # source-indexed subtract, then mirror
            win = win - mean[:, y0:y0 + crop, x0:x0 + crop]
        if mirror is not None and mirror[i]:
            win = win[:, :, ::-1]
        out[i] = win
    if mean_kind == 1:
        out -= mean.reshape(1, c, 1, 1)
    elif mean_kind == 2:
        out -= mean
    if scale != 1.0:
        out *= scale
    return out


def decode_cifar_records(raw, record):
    """Packed records -> (images uint8 (N, record-1), labels int32)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.size // record
    lib = _load()
    if lib is not None:
        images = np.empty((n, record - 1), np.uint8)
        labels = np.empty(n, np.int32)
        lib.decode_cifar_records(_ptr(raw, ctypes.c_uint8), n, record,
                                 _ptr(images, ctypes.c_uint8),
                                 _ptr(labels, ctypes.c_int32))
        return images, labels
    recs = raw[:n * record].reshape(n, record)
    return np.ascontiguousarray(recs[:, 1:]), recs[:, 0].astype(np.int32)


def accumulate_sum(images, acc):
    """Add the sum over the batch of uint8 (N,...) into int64 acc (...)."""
    images = np.ascontiguousarray(images, np.uint8)
    lib = _load()
    if lib is not None and acc.flags.c_contiguous:
        n = images.shape[0]
        chw = images.size // max(n, 1)
        if n:
            lib.accumulate_sum(_ptr(images, ctypes.c_uint8), n, chw,
                               _ptr(acc, ctypes.c_int64))
        return acc
    acc += images.astype(np.int64).sum(axis=0)
    return acc


def crc32c(data, crc=0):
    """Native crc32c (Castagnoli) with data/leveldb.py's (data, crc)
    semantics, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not len(data):
        return crc & 0xffffffff      # xor-in/xor-out cancel on empty input
    buf = np.frombuffer(data, np.uint8)      # zero-copy for bytes-likes
    return int(lib.crc32c_update(_ptr(buf, ctypes.c_uint8), len(buf), crc))


def snappy_uncompress(data, declared_len):
    """Decode a raw-Snappy payload to bytes via the native decoder.
    Returns None when the library is unavailable OR the decode fails —
    the caller's pure-Python decoder is both the fallback and the error
    path with the descriptive diagnostics."""
    lib = _load()
    if lib is None:
        return None
    # a corrupt preamble could claim terabytes: max snappy expansion is
    # ~64/3 bytes out per byte in (a 3-byte copy-2 element emitting 64),
    # so anything past 24x + slack cannot be a valid stream
    if declared_len < 0 or declared_len > len(data) * 24 + 64:
        return None
    src = np.frombuffer(data, np.uint8)      # zero-copy for bytes-likes
    out = np.empty(declared_len, np.uint8)
    got = lib.snappy_uncompress(
        _ptr(src, ctypes.c_uint8), len(src),
        _ptr(out, ctypes.c_uint8), declared_len)
    if got != declared_len:
        return None
    return out.tobytes()
