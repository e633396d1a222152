"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for sm_90a into ``sparknet_tpu_torch/
_build/<name>_<key>.so``. The key hashes the source, the shared headers
and the compiler flags, so an edited source rebuilds and an unchanged one
loads the library already there. ``build()`` starts one ``nvcc`` per
missing source, all at once. A failed compile raises with ``nvcc``'s
stderr; nothing falls back to the plain PyTorch versions. ``defines``
builds a variant with those preprocessor macros set, into a library of
its own (``<name>_<macros>_<key>.so``): the one-pass TF32 control of the
f32 flash kernels (``TF32_ONE_PASS``), which chip_smoke.py and
scripts/flash_ab.py build to show that the f32 limits reject 10-bit
products. The wrappers load no variant.

Nothing here runs at import time: the package imports on machines with
no ``nvcc`` and no card, and the CPU path never calls in here.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE, "csrc")
BUILD_DIR = os.path.join(PACKAGE, "_build")
SOURCES = ("lrn", "epilogue", "lrn_bwd", "flash_fwd", "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
# csrc/flash_tf32.cuh's one-pass TF32 control: split-TF32 products with
# the lo terms left out
TF32_ONE_PASS = ("SPARKNET_FLASH_TF32_ONE_PASS",)

_lock = threading.Lock()
_loaded = {}          # (name, defines) -> ctypes.CDLL, process-wide


def nvcc_path():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from "
            f"{CSRC} at first use on the card")
    return found


def _macro_flags(defines):
    return tuple(f"-D{d}" for d in defines)


def _key(name, defines=()):
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _macro_flags(defines))
                       .encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            h.update(fn.encode())
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name, defines=()):
    tag = "".join(f"_{d.lower()}" for d in defines)
    return os.path.join(BUILD_DIR, f"{name}{tag}_{_key(name, defines)}.so")


def build(names=SOURCES, ptxas_verbose=False, defines=()):
    """Compile every library in ``names`` that is not built yet (with
    the macros ``defines`` set), one ``nvcc`` process per source, all
    started together. Returns {name: compiler output} for the ones it
    compiled; raises RuntimeError with the stderr of every failed
    compile."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    procs = {}
    for name in names:
        out = library_path(name, defines)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, *_macro_flags(defines), *extra,
               "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu exited {proc.returncode}:\n"
                          f"{stderr}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)          # atomic: a racing loader never sees
        logs[name] = stdout + stderr  # a half-written library
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name, defines=()):
    """The loaded library for csrc/<name>.cu (built with the macros
    ``defines``), built first if needed."""
    defines = tuple(defines)
    with _lock:
        lib = _loaded.get((name, defines))
        if lib is None:
            path = library_path(name, defines)
            if not os.path.exists(path):
                build((name,), defines=defines)
            lib = ctypes.CDLL(path)
            _loaded[name, defines] = lib
        return lib


def function(name, symbol, argtypes, defines=()):
    """C function ``symbol`` of csrc/<name>.cu's library (built with the
    macros ``defines``), its argument types declared (each pointer as
    c_void_p, so none is cut to 32 bits) and returning the CUDA error
    code as an int."""
    fn = getattr(library(name, defines), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_handle(device):
    """PyTorch's current CUDA stream on ``device`` as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# storage types the kernels are instantiated for -> their C dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535
# The largest LRN windows the channel-walk wrappers take (the limits of
# the kernels' earlier per-thread rings, kept). A CTA's tiles
# (csrc/channel_walk.cuh, walk_geometry) narrow their span of columns as
# the window grows, and fit in shared memory well beyond these.
MAX_WINDOW = 227
MAX_WINDOW_BWD = 90

# What sparknet_<source>_info(dtype, variant, channels, hw, size, aligned,
# out) of csrc/lrn.cu, epilogue.cu and lrn_bwd.cu writes to out
WALK_INFO_FIELDS = ("chunk", "chunks", "span", "spans", "vec", "smem_bytes",
                    "registers", "ctas_per_sm", "local_bytes")


def walk_info(source, dtype, variant, channels, hw, size, aligned=True):
    """The launch that csrc/<source>.cu ("lrn", "epilogue" or "lrn_bwd")
    makes for a (N, channels, hw) tensor of ``dtype`` with LRN window
    ``size``: its geometry (``chunk`` output channels a CTA over
    ``chunks``, ``span`` columns over ``spans``, the 16-byte path ``vec``
    where the base pointers are ``aligned`` and H*W allows it), dynamic
    shared memory, registers, resident CTAs per SM and spills.
    ``variant`` is the entry point's flag (epilogue: with_lrn; lrn_bwd:
    bias_relu; lrn: 0). Needs the card."""
    fn = function(source, f"sparknet_{source}_info",
                  [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
    out = (ctypes.c_int * len(WALK_INFO_FIELDS))()
    err = fn(DTYPE_CODES[dtype], int(variant), int(channels), int(hw),
             int(size), int(aligned), ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"sparknet_{source}_info: cudaError {err}")
    return dict(zip(WALK_INFO_FIELDS, out))


def check_cuda_input(x, what, size=None, max_window=MAX_WINDOW):
    """Raise on a tensor the channel-window kernels do not take: not on
    a CUDA device, not 4-D NCHW contiguous, not f32/bf16, or a batch /
    window beyond the launch geometry."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {x.device}, want cuda")
    if x.dim() != 4:
        raise ValueError(f"{what}: want a 4-D NCHW tensor, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous NCHW")
    if x.shape[0] > MAX_GRID_Y:
        raise ValueError(f"{what}: batch {x.shape[0]} > {MAX_GRID_Y}")
    if size is not None and not 1 <= int(size) <= max_window:
        raise ValueError(f"{what}: local_size {size} outside "
                         f"[1, {max_window}]")
    return DTYPE_CODES[x.dtype]
