#!/usr/bin/env python3
"""Time the f32 flash-attention kernels of two source trees on one card,
in turns: baseline, this tree, this tree, baseline.

    python3 scripts/flash_f32_ab.py --baseline <an older csrc/ dir>

The kernels are the forward (csrc/flash_fwd.cu) and the dQ and dK/dV
kernels (csrc/flash_bwd.cu) of sparknet_tpu_torch on float32 tensors, at
the shapes of chip_smoke.py phase 6's f32 cases up to head_dim 256
(past it both trees run the same wide kernels). The baseline's sources
are built with this tree's nvcc flags into _work/flash_f32_ab/; this
tree's, and its one-pass TF32 control (cuda_build.TF32_ONE_PASS), are
the libraries of cuda_build (built there if chip_smoke.py has not built
them yet), all three at once. All are called through their C entry
points, whose signatures the trees share.
Every arm runs on the same inputs: the backward kernels on this tree's
O, LSE and delta. Each arm is held to the plain PyTorch versions at
chip_smoke.py's f32 limits (O and LSE 2e-5, dQ, dK, dV 5e-4 of the
largest element, delta 2e-5, every output's worst 64-row tile 1e-4);
this tree's kernels must give bitwise the same outputs when launched
twice, and the one-pass control must read over the O limit and over a
dQ limit. Times: the median of 30 launches over CUDA events with the L2
flushed before each (chip_smoke.Timer), in the order baseline, new, new,
baseline, with F.scaled_dot_product_attention and torch.autograd.grad
through it (dq, dk, dv together) beside them, and each kernel's bound
(FLOPs over 165 TFLOP/s, split TF32's rate of f32-accurate products, or
bytes over 3.35 TB/s, whichever is larger). Prints a line per kernel and
case, the card's name and power limit, and last one JSON object with
every number.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from sparknet_tpu_torch.ops import cuda_attention as ca  # noqa: E402
from sparknet_tpu_torch.ops import cuda_build  # noqa: E402

SOURCES = ("flash_fwd", "flash_bwd")
CASES = [(shape, causal) for shape, dtype, causal, _ in chip_smoke.FLASH_CASES
         if dtype == "float32" and shape[-1] <= ca.HEAD_DIMS[-1]]
KERNELS = (("fwd", "flash_attention", "O"), ("dq", "flash_attention_dq", "dQ"),
           ("dkv", "flash_attention_dkv", "dK"))


def build(csrc, out_dir):
    """Start one nvcc for each of SOURCES in ``csrc``; -> a function that
    waits for them and returns {source: ctypes.CDLL}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in SOURCES:
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       so)

    def wait():
        libs = {}
        for name, (proc, so) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {csrc}/{name}.cu: {err}")
            libs[name] = ctypes.CDLL(so)
        return libs
    return wait


def held_to_plain(arm, what, outs, refs):
    """Each of ``outs`` against the plain version's ``refs`` at the f32
    limits; -> {label: (of the largest element, worst tile)}."""
    readings = {}
    for label, got in outs.items():
        rel = chip_smoke._rel_err(got, refs[label])
        tile = chip_smoke._tile_err(torch, got, refs[label]) \
            if got.dim() == 4 else None
        limit = chip_smoke.ROW_LIMIT if got.dim() == 2 else \
            chip_smoke.F32_ELEMENT_LIMIT[label]
        chip_smoke.check(bool(torch.isfinite(got).all())
                         and rel <= limit and (tile is None or tile <= 1e-4),
                         f"{arm} {label} at {what}: {rel:.3e} of the largest "
                         f"element (limit {limit:g}), worst tile {tile}")
        readings[label] = (rel, tile)
    return readings


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="the csrc/ directory of the baseline tree")
    args = ap.parse_args()
    chip_smoke.check(torch.cuda.is_available(), "no CUDA card")
    card = chip_smoke.nvidia_smi()
    work = os.path.join(REPO, "_work", "flash_f32_ab")
    wait = build(args.baseline, os.path.join(work, "baseline"))
    variants = {"new": (), "control": cuda_build.TF32_ONE_PASS}
    with ThreadPoolExecutor(len(variants)) as pool:
        for done in [pool.submit(cuda_build.build, SOURCES, defines=d)
                     for d in variants.values()]:
            done.result()
    arms = {"baseline": chip_smoke.flash_entry_points(wait())}
    arms.update((arm, chip_smoke.flash_entry_points(defines=d))
                for arm, d in variants.items())
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    results = []
    for shape, causal in CASES:
        b, h, s, d = shape
        what = f"{list(shape)} float32 causal={causal}"
        q, k, v, do = (0.5 * torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4))
        with torch.no_grad():
            new = chip_smoke.flash_calls(torch, arms["new"], q, k, v, do,
                                         q, None, None, causal)
            o, lse = new["fwd"]()
            dq, delta = chip_smoke.flash_calls(
                torch, arms["new"], q, k, v, do, o, lse, None, causal)["dq"]()
            calls = {arm: chip_smoke.flash_calls(torch, fns, q, k, v, do, o,
                                                 lse, delta, causal)
                     for arm, fns in arms.items()}
            ro, rlse = ca.flash_attention_fwd_plain(q, k, v, causal)
            rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do,
                                                      causal)
            rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                    causal)
            refs = {"O": ro, "LSE": rlse, "dQ": rdq, "delta": rdelta,
                    "dK": rdk, "dV": rdv}
            outputs = {}
            for arm, c in calls.items():
                outs = dict(zip(("O", "LSE"), c["fwd"]()))
                outs.update(zip(("dQ", "delta"), c["dq"]()))
                outs.update(zip(("dK", "dV"), c["dkv"]()))
                torch.cuda.synchronize()
                outputs[arm] = outs
            errors = {arm: held_to_plain(arm, what, outputs[arm], refs)
                      for arm in ("baseline", "new")}
            again = dict(zip(("O", "LSE"), calls["new"]["fwd"]()))
            again.update(zip(("dQ", "delta"), calls["new"]["dq"]()))
            again.update(zip(("dK", "dV"), calls["new"]["dkv"]()))
            for label, t in again.items():
                chip_smoke.check(torch.equal(t, outputs["new"][label]),
                                 f"new {label} at {what}: two launches "
                                 "differ")
            control = {label: (chip_smoke._rel_err(t, refs[label]),
                               chip_smoke._tile_err(torch, t, refs[label]))
                       for label, t in outputs["control"].items()
                       if t.dim() == 4}
            chip_smoke.check(control["O"][0] > 2e-5,
                             f"the one-pass control's O at {what} reads "
                             f"{control['O'][0]:.3e}, within the f32 limit")
            chip_smoke.check(control["dQ"][0] > 5e-4 or control["dQ"][1]
                             > 1e-4, f"the one-pass control's dQ at {what} "
                             f"reads {control['dQ']}, within the f32 limits")
            del outputs, again, ro, rlse, rdq, rdelta, rdk, rdv, refs
            ql, kl, vl = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            with torch.enable_grad():
                lib_out = F.scaled_dot_product_attention(ql, kl, vl,
                                                         is_causal=causal)
            library = {
                "fwd": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal),
                "bwd": lambda: torch.autograd.grad(
                    lib_out, (ql, kl, vl), do, retain_graph=True)}
            library_ms = {key: timer(fn) for key, fn in library.items()}
            pairs = b * h * s * s * (0.5 if causal else 1.0)
            item, rows = 4 * q.numel(), 4 * b * h * s
            work_of = {"fwd": (4 * item + rows, 4 * pairs * d),
                       "dq": (6 * item + 2 * rows, 6 * pairs * d),
                       "dkv": (6 * item + 2 * rows, 8 * pairs * d)}
            for key, name, label in KERNELS:
                turns = [(arm, timer(calls[arm][key]))
                         for arm in ("baseline", "new", "new", "baseline")]
                old = [t for a, t in turns if a == "baseline"]
                ms = [t for a, t in turns if a == "new"]
                nbytes, flops = work_of[key]
                t_bytes = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
                t_ops = flops / chip_smoke.SPLIT_TF32_OPS_PER_S * 1e3
                r = dict(name=name, shape=list(shape), dtype="float32",
                         causal=causal, baseline_ms=old, new_ms=ms,
                         library_ms=library_ms["fwd" if key == "fwd"
                                               else "bwd"],
                         library="F.scaled_dot_product_attention"
                         if key == "fwd" else "torch.autograd.grad of "
                         "F.scaled_dot_product_attention (dq, dk, dv)",
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", flops=flops, bytes=nbytes,
                         errors=errors, control=control)
                r["speedup"] = min(old) / max(ms)
                r["tflops"] = flops / min(ms) / 1e9
                r["bound_share"] = r["bound_ms"] / min(ms)
                results.append(r)
                print(f"[ab] {name} {what}: baseline {old[0]:.4f} / "
                      f"{old[1]:.4f} ms, new {ms[0]:.4f} / {ms[1]:.4f} ms "
                      f"({r['speedup']:.2f}x at the least, "
                      f"{r['tflops']:.1f} TFLOP/s), library "
                      f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                      f"ms ({r['bound_by']}, {100 * r['bound_share']:.1f}% "
                      f"of it); one-pass control {label} "
                      f"{control[label][0]:.3e} of the largest element; "
                      f"{card}")
            del q, k, v, do, o, lse, dq, delta, calls, ql, kl, vl, lib_out
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
