#!/usr/bin/env python3
"""Time the channel-walk kernels of two source trees on one card, in
turns: baseline, this tree, this tree, baseline.

    python3 scripts/channel_walk_ab.py --baseline <an older csrc/ dir>

The kernels are csrc/lrn.cu (LRN forward), csrc/lrn_bwd.cu (LRN
backward, plain and fused with bias+ReLU) and csrc/epilogue.cu (bias+ReLU
and bias+ReLU+LRN) of sparknet_tpu_torch. Both trees' sources are built
with this tree's nvcc flags into _work/channel_walk_ab/, and called
through their C entry points, whose signatures the two trees share. Each
row runs on the same inputs in both arms: the median of 30 launches over
CUDA events with the L2 flushed before each (chip_smoke.Timer), in the
order baseline, new, new, baseline, then each arm's device time from
torch.profiler as a check, with the library call (one PyTorch
call computing the same function, where there is one) and the bytes
bound beside them. Both arms are held against the plain PyTorch version
(chip_smoke.py's limits). Prints a line per row, the card's name and
power limit, and last one JSON object with every number.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from sparknet_tpu_torch.ops import cuda_build  # noqa: E402
from sparknet_tpu_torch.ops import cuda_epilogue as ce  # noqa: E402
from sparknet_tpu_torch.ops import cuda_lrn as cl  # noqa: E402

SOURCES = ("lrn", "lrn_bwd", "epilogue")
LRN = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)      # GoogLeNet's and
#                                                       CaffeNet's LRNs


def build(csrc, out_dir):
    """{source: ctypes.CDLL} of csrc/<source>.cu, one nvcc each, in
    parallel."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in SOURCES:
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {csrc}/{name}.cu: {err}")
        libs[name] = ctypes.CDLL(so)
    return libs


def entry_points(libs):
    """The three C entry points of one tree, their argument types set."""
    fns = {}
    for name, symbol, argtypes in (
            ("lrn", "sparknet_lrn_forward", cl._ARGTYPES),
            ("lrn_bwd", "sparknet_lrn_backward", cl._BWD_ARGTYPES),
            ("epilogue", "sparknet_epilogue_forward", ce._ARGTYPES)):
        fn = getattr(libs[name], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fns, kind, x, b, g, p):
    """A no-argument call of one tree's kernel of ``kind`` on these
    inputs, returning its output; raises on a launch error."""
    code = cuda_build.DTYPE_CODES[x.dtype]
    n, c, h, w = x.shape
    size, alpha, beta, k = p["size"], p["alpha"], p["beta"], p["k"]
    stream = cuda_build.stream_handle(x.device)

    def run():
        out = torch.empty_like(x)
        if kind == "lrn":
            err = fns["lrn"](x.data_ptr(), out.data_ptr(), code, n, c, h * w,
                             size, alpha / size, beta, k, stream)
        elif kind in ("lrn_bwd", "bias_relu_lrn_bwd"):
            fused = kind == "bias_relu_lrn_bwd"
            err = fns["lrn_bwd"](x.data_ptr(), b.data_ptr() if fused else 0,
                                 g.data_ptr(), out.data_ptr(), code,
                                 int(fused), n, c, h * w, size, alpha / size,
                                 beta, k, 2.0 * alpha * beta / size, stream)
        else:
            with_lrn = kind == "bias_relu_lrn"
            err = fns["epilogue"](x.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  code, int(with_lrn), n, c, h * w, size,
                                  alpha / size, beta, k, stream)
        if err != 0:
            raise RuntimeError(f"{kind}: cudaError {err}")
        return out
    return run


def device_ms(fn, flush, reps=10):
    """Mean device time of the channel_walk kernels that ``fn`` launches,
    read from torch.profiler, the L2 flushed before each call: a check
    on the CUDA-event times, which no host time can enter."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0)
             for e in prof.key_averages() if "channel_walk" in e.key)
    return us / 1e3 / reps


def rows(gen):
    """(kind, x, b, g, plain, library, bytes moved) of every row."""
    def randn(shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)

    def lrn_lib_bwd(x, g):
        with torch.enable_grad():
            xl = x.detach().clone().requires_grad_()
            y = F.local_response_norm(xl, LRN["size"], LRN["alpha"],
                                      LRN["beta"], LRN["k"])
        return lambda: torch.autograd.grad(y, xl, g, retain_graph=True)[0]

    out = []
    fwd_shapes = [((8, 64, 56, 56), torch.float32),
                  ((32, 64, 56, 56), torch.float32),
                  ((8, 64, 56, 56), torch.bfloat16),
                  ((32, 64, 56, 56), torch.bfloat16),
                  ((256, 96, 27, 27), torch.float32),
                  ((256, 256, 13, 13), torch.float32)]
    for shape, dtype in fwd_shapes:
        x = randn(shape, dtype)
        out.append(("lrn", x, None, None,
                    lambda x=x: cl.lrn_across_plain(x, **LRN),
                    lambda x=x: F.local_response_norm(
                        x, LRN["size"], LRN["alpha"], LRN["beta"], LRN["k"]),
                    2 * x.numel() * x.element_size()))
    for shape, dtype in (((32, 64, 56, 56), torch.float32),
                         ((256, 96, 27, 27), torch.float32),
                         ((256, 256, 13, 13), torch.float32),
                         ((32, 64, 56, 56), torch.bfloat16)):
        x, g = randn(shape, dtype), randn(shape, dtype)
        out.append(("lrn_bwd", x, None, g,
                    lambda x=x, g=g: cl.lrn_across_bwd_plain(x, g, **LRN),
                    lrn_lib_bwd(x, g), 3 * x.numel() * x.element_size()))
    b = randn((192,), scale=0.5)
    for dtype in (torch.float32, torch.bfloat16):
        x, g = randn((32, 192, 56, 56), dtype), randn((32, 192, 56, 56), dtype)
        # the kernel takes the bias in x's dtype, as the wrapper passes it
        out.append(("bias_relu_lrn_bwd", x, b.to(dtype), g,
                    lambda x=x, g=g: ce.bias_relu_lrn_bwd_plain(x, b, g,
                                                                **LRN)[0],
                    None, (3 * x.numel() + b.numel()) * x.element_size()))
    for shape in ((8, 192, 56, 56), (32, 192, 56, 56)):
        x = randn(shape)
        out.append(("bias_relu_lrn", x, b, None,
                    lambda x=x: ce.bias_relu_lrn_plain(x, b, **LRN), None,
                    2 * x.numel() * 4 + b.numel() * 4))
    x, b1 = randn((8, 64, 112, 112)), randn((64,), scale=0.5)
    out.append(("bias_relu", x, b1, None,
                lambda x=x: ce.bias_relu_plain(x, b1), None,
                2 * x.numel() * 4 + b1.numel() * 4))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="the csrc/ directory of the baseline tree")
    args = ap.parse_args()
    chip_smoke.check(torch.cuda.is_available(), "no CUDA card")
    card = chip_smoke.nvidia_smi()
    work = os.path.join(REPO, "_work", "channel_walk_ab")
    arms = {"baseline": entry_points(build(args.baseline,
                                           os.path.join(work, "baseline"))),
            "new": entry_points(build(cuda_build.CSRC,
                                      os.path.join(work, "new")))}
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    results = []
    with torch.no_grad():
        for kind, x, b, g, plain, library, nbytes in rows(gen):
            run = {arm: launcher(fns, kind, x, b, g, LRN)
                   for arm, fns in arms.items()}
            ref = plain()
            floor = None if g is None else \
                g.abs().float() * LRN["k"] ** -LRN["beta"]
            errs = {}
            for arm, fn in run.items():
                got = fn()
                torch.cuda.synchronize()
                abs_err, _, ok, limit = chip_smoke._errors(torch, got, ref,
                                                           floor)
                chip_smoke.check(ok, f"{arm} {kind} {list(x.shape)} "
                                     f"disagrees with the plain version "
                                     f"beyond {limit}")
                errs[arm] = abs_err
            turns = [("baseline", timer(run["baseline"])),
                     ("new", timer(run["new"])),
                     ("new", timer(run["new"])),
                     ("baseline", timer(run["baseline"]))]
            old = [t for a, t in turns if a == "baseline"]
            new = [t for a, t in turns if a == "new"]
            r = dict(kind=kind, shape=list(x.shape),
                     dtype=str(x.dtype).replace("torch.", ""),
                     baseline_ms=old, new_ms=new,
                     device_ms={arm: device_ms(fn, timer.flush)
                                for arm, fn in run.items()},
                     library_ms=timer(library) if library else None,
                     bound_ms=nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
                     max_abs_err=errs)
            r["speedup"] = min(old) / max(new)
            r["bound_share"] = r["bound_ms"] / min(new)
            results.append(r)
            print(f"[ab] {kind} {r['shape']} {r['dtype']}: baseline "
                  f"{old[0]:.4f} / {old[1]:.4f} ms, new {new[0]:.4f} / "
                  f"{new[1]:.4f} ms ({r['speedup']:.2f}x at the least; "
                  f"profiler {r['device_ms']['baseline']:.4f} / "
                  f"{r['device_ms']['new']:.4f} ms), "
                  f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f}"
                  f" ms ({100 * r['bound_share']:.1f}% of it); {card}")
    print(card)
    print(json.dumps({"card": card, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
