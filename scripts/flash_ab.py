#!/usr/bin/env python3
"""Time the flash-attention kernels of two source trees on one card, in
turns: baseline, this tree, this tree, baseline.

    python3 scripts/flash_ab.py --baseline <an older csrc/ dir>
        [--cases bf16-256|bf16-128|f32|f32-256] [--sass] [--steps N]

The kernels are the forward (csrc/flash_fwd.cu) and the dQ and dK/dV
kernels (csrc/flash_bwd.cu) of sparknet_tpu_torch, at the shapes of
chip_smoke.py phase 6's cases (f32 up to head_dim 256, bf16 at every
tiled head_dim, and past 256 the wide kernels of csrc/flash_wide.cuh in
both dtypes), at phase 15's bf16 mesh-slot shapes (MESH_FLASH_CASES) and
at f32 head_dim 16 ((8, 8, 256, 16) causal),
with one case whose kernels the trees are meant to share
(SAME_KERNEL_CASE, the bf16 head_dim-256 LM row: its ratio is the
call's noise floor while neither tree changes those kernels);
``--cases bf16-256`` keeps only the bf16 cases at head_dim 256 and 192
and the shared case, ``--cases bf16-128`` the bf16 cases up to head_dim
128 and the shared case, ``--cases f32`` the f32 cases up to head_dim
128 and the shared case, ``--cases f32-256`` the f32 cases at head_dim
256 and 192 and the shared case; ``--sass`` first prints the
instructions (cuobjdump) in which the two trees' flash kernels differ,
for every kind of kernel that both trees build (SASS_SAME: all but the
f32 forward at head_dim 256, whose kernel this tree replaces), and
counts the wgmma (HGMMA) and mma.sync (HMMA) instructions of this
tree's kernels on wgmma (the backward's bf16 up to head_dim 128 and f32
at 64, 128 and 256, the f32 forward's at 32-128 and 256; the f32 ones'
HGMMA must read TF32 operands), which must be HGMMA only; ``--steps N`` last
times a train step with the baseline's and this tree's flash_fwd and
flash_bwd in turns, N steps an arm, baseline, new, new, baseline, and
prints each arm's median and its spread: the LM row's, bf16 on one
device and its tp 2 branch (chip_smoke.py phases 7 and 15, through the
lm verb's setup), or with ``--cases f32`` f32 (the lm verb's default
dtype) on one device; with ``--cases f32-256`` the f32 step of
chip_smoke.LM_D256 (``lm --d-model 2048 --heads 8``, phase 7) on one
device. The
baseline's sources are built here with this tree's nvcc flags into
_work/flash_ab/; this tree's kernels, and their one-pass TF32 control
(cuda_build.TF32_ONE_PASS), are the libraries of cuda_build
(cuda_build.library builds them there if chip_smoke.py has not yet).
All are called through their C entry points, whose signatures the
trees share, on the inputs zero-padded as this tree's wrappers pad them
(ca.built_head_dim; the baseline must take the same padding, as every
tree since the wide dK/dV moved onto clusters does).
Every arm runs on the same inputs: the backward kernels on this tree's
O, LSE and delta. Each arm is held to the plain PyTorch versions at
chip_smoke.py's limits (f32: O and LSE 2e-5, dQ, dK, dV 5e-4 of the
largest element, every output's worst 64-row tile 1e-4; bf16: every
output's worst tile 5e-3; delta and LSE 2e-5); this tree's kernels must
give bitwise the same outputs when launched twice, and at f32 the
one-pass control must read over the O limit and over a dQ limit. Times:
the median of 30 launches over CUDA events with the L2 flushed before
each (chip_smoke.Timer), in the order baseline, new, new, baseline (and
at f32 the one-pass control once, after them),
with F.scaled_dot_product_attention and torch.autograd.grad through it
(dq, dk, dv together) beside them, and each kernel's bound (FLOPs over
165 TFLOP/s, split TF32's rate of f32-accurate products, for f32, or
989 TFLOP/s for bf16, or bytes over 3.35 TB/s, whichever is larger).
Prints a line per kernel and case, the card's name and power limit, and
last one JSON object with every number.
"""

import argparse
import ctypes
import difflib
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from sparknet_tpu_torch.ops import cuda_attention as ca  # noqa: E402
from sparknet_tpu_torch.ops import cuda_build  # noqa: E402

SOURCES = ("flash_fwd", "flash_bwd")
# a case whose kernels both trees are meant to share: its ratio is the
# call's noise floor
SAME_KERNEL_CASE = ((2, 8, 4096, 256), "bfloat16", True)
CASES = [(shape, dtype, causal)
         for shape, dtype, causal, _ in chip_smoke.FLASH_CASES
         + chip_smoke.MESH_FLASH_CASES] + [
    # the lm verb's default widths with 16 heads: f32 head_dim 16, where
    # the forward keeps its mma.sync kernel (the wgmma kernel lost there)
    ((8, 8, 256, 16), "float32", True)]


def _bf16_at(c, dims):
    return c[1] == "bfloat16" and ca.built_head_dim(c[0][-1]) in dims


CASE_SETS = {"all": lambda c: True,
             "bf16-256": lambda c: c == SAME_KERNEL_CASE
             or _bf16_at(c, (256,)),
             "bf16-128": lambda c: c == SAME_KERNEL_CASE
             or _bf16_at(c, ca.HEAD_DIMS[:-1]),
             "f32": lambda c: c == SAME_KERNEL_CASE
             or (c[1] == "float32" and ca.built_head_dim(c[0][-1]) <= 128),
             "f32-256": lambda c: c == SAME_KERNEL_CASE
             or (c[1] == "float32" and ca.built_head_dim(c[0][-1]) == 256)}
# --sass: instantiations on wgmma, by the start of their mangled names:
# the bf16 forward up to head_dim 128 and the backward's bf16 ones up to
# 128, the f32 (split TF32) backward's at 64 and 128 and its cluster
# kernels at 256, and the f32 forward's at 32-128 and its cluster kernel
# at 256, whose HGMMA must read TF32 operands
SASS_FWD = re.compile(r"flash_fwd_wgmma_kernelILi")
SASS_FWD_TF32 = re.compile(r"flash_fwd_tf32_wgmma_kernelILi")
SASS_FWD_TF32_256 = re.compile(r"flash_fwd_tf32_wgmma256_kernel")
SASS_BWD = re.compile(r"flash_(dq|dkv)_wgmma_kernelILi")
SASS_BWD_TF32 = re.compile(r"flash_(dq|dkv)_tf32_wgmma_kernelILi")
SASS_BWD_TF32_256 = re.compile(r"flash_(dq|dkv)_tf32_wgmma256_kernel")
TF32_HEAD_DIMS = (64, 128)
# --sass: {library: {kind: (its instantiations, TF32 operands wanted)}}
# whose products are counted, and {library: kind} whose instructions a
# tree may mean to leave as they were (diffed against the baseline's)
SASS_PRODUCTS = {
    "flash_fwd": {SASS_FWD_TF32: (len(chip_smoke.F32_FWD_WGMMA_DIMS), True),
                  SASS_FWD_TF32_256: (1, True)},
    "flash_bwd": {SASS_BWD: (2 * (len(ca.HEAD_DIMS) - 1), False),
                  SASS_BWD_TF32: (2 * len(TF32_HEAD_DIMS), True),
                  SASS_BWD_TF32_256: (2, True)}}
SASS_SAME = {
    "flash_fwd": (SASS_FWD, re.compile(r"flash_fwd_wgmma256_kernel"),
                  SASS_FWD_TF32, re.compile(r"flash_fwd_tf32_kernelILi16E"),
                  re.compile(r"flash_wide_fwd_kernel")),
    "flash_bwd": (SASS_BWD, re.compile(r"flash_(dq|dkv)_wgmma256_kernel"),
                  SASS_BWD_TF32, SASS_BWD_TF32_256,
                  re.compile(r"flash_(dq|dkv)_tf32_kernelILi"),
                  re.compile(r"flash_wide_(dq|dkv)_kernel"))}
BRANCH = re.compile(r"\b(BRA|BRX|BSSY|CALL\.\S+|JMP|JMX)\b")
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


def sass_functions(so):
    """{mangled name: its instructions} of every kernel in the library
    ``so`` as cuobjdump prints them, without addresses and encodings; a
    branch's target, which moves with any instruction before it, reads
    TARGET."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    funcs, lines = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            lines = funcs[m.group(1)] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and lines is not None:
            text = m.group(1)
            lines.append(re.sub(r"0x[0-9a-f]+", "TARGET", text)
                         if BRANCH.search(text) else text)
    return funcs


def sass_diff(baseline_so, new_so, kind):
    """Print, for each instantiation whose name matches ``kind`` (the
    same set in both libraries), the two trees' instruction counts and
    every instruction one has and the other has not; -> the number of
    instantiations that differ."""
    a_all, b_all = sass_functions(baseline_so), sass_functions(new_so)
    names = sorted(fn for fn in a_all if kind.search(fn))
    chip_smoke.check(names and names == sorted(
        fn for fn in b_all if kind.search(fn)),
        f"{kind.pattern}: {names} in {baseline_so}, other names in {new_so}")
    differ = 0
    for fn in names:
        a, b = a_all[fn], b_all[fn]
        diff = [line for line in difflib.unified_diff(a, b, lineterm="", n=0)
                if line[:1] in "+-" and line[:3] not in ("+++", "---")]
        differ += bool(diff)
        print(f"[sass] {fn}: {len(a)} instructions in the baseline, "
              f"{len(b)} here; {sum(x[0] == '-' for x in diff)} only in the "
              f"baseline, {sum(x[0] == '+' for x in diff)} only here")
        for line in diff:
            print(f"[sass]   {line}")
    return differ


def sass_products(so, kinds):
    """Count the wgmma (HGMMA, and of those the ones on TF32 operands)
    and mma.sync (HMMA) instructions of every instantiation in the
    library ``so`` whose name matches a kind of ``kinds`` ({kind: (its
    instantiations, TF32 wanted)}); each must have HGMMA and no HMMA,
    and those of a TF32 kind TF32 in every HGMMA."""
    funcs = sass_functions(so)
    counts = {}
    for kind, (want, tf32) in kinds.items():
        names = sorted(fn for fn in funcs if kind.search(fn))
        chip_smoke.check(len(names) == want,
                         f"cuobjdump found {names} in {so}, want {want} "
                         f"of {kind.pattern}")
        for fn in names:
            c = counts[fn] = {"HGMMA": 0, "HGMMA TF32": 0, "HMMA": 0}
            for text in funcs[fn]:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", text):
                        c[op] += 1
                        if op == "HGMMA" and "TF32" in text:
                            c["HGMMA TF32"] += 1
            print(f"[sass] {fn}: {c['HGMMA']} HGMMA ({c['HGMMA TF32']} on "
                  f"TF32 operands), {c['HMMA']} HMMA")
            chip_smoke.check(c["HGMMA"] > 0 and c["HMMA"] == 0,
                             f"{fn}: {c}, want wgmma products only")
            if tf32:
                chip_smoke.check(c["HGMMA TF32"] == c["HGMMA"],
                                 f"{fn}: {c}, want TF32 operands in every "
                                 "HGMMA")
    return counts


def time_steps(libs, steps, dtype="bf16", widths=None):
    """A train step of the lm verb's setup (chip_smoke._branch_setup) at
    ``widths`` (chip_smoke.LM_FULL, the LM row, by default) in
    ``dtype``: bf16 on one device and its tp 2 branch, f32 on one
    device; timed by synchronisation: ``steps`` steps on one batch an
    arm, the baseline's flash_fwd and flash_bwd and this tree's in turns
    (baseline, new, new, baseline), after two warm-up steps; ->
    {branch: {"baseline": [[ms]...], "new": [[ms]...]}}."""
    import statistics
    import time
    f = widths or chip_smoke.LM_FULL
    full = ["--vocab", str(f["vocab"]), "--seq-len", str(f["seq_len"]),
            "--batch", str(f["batch"]), "--d-model", str(f["d_model"]),
            "--layers", str(f["layers"]), "--heads", str(f["heads"]),
            "--dtype", dtype]
    branches = (("one device", []), ("tp 2", ["--tp", "2"])) \
        if dtype == "bf16" else (("one device", []),)
    ours = {name: cuda_build.library(name) for name in SOURCES}
    out = {}
    for label, flags in branches:
        run = chip_smoke._branch_setup(label, full + flags)
        solver, batch = run["solver"], next(run["stream"])
        for _ in range(2):
            float(solver.train_step(batch))
        arms = {"baseline": [], "new": []}
        for arm in ("baseline", "new", "new", "baseline"):
            for name in SOURCES:
                cuda_build._loaded[name, ()] = libs[name] \
                    if arm == "baseline" else ours[name]
            times = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(solver.train_step(batch))   # the fetch synchronises
                times.append((time.perf_counter() - t0) * 1e3)
            arms[arm].append(times)
            print(f"[steps] {dtype} d_model {f['d_model']} {label} {arm}: "
                  f"median "
                  f"{statistics.median(times):.2f} ms, spread "
                  f"{min(times):.2f}-{max(times):.2f} ms over {steps} "
                  "steps")
        for name in SOURCES:
            cuda_build._loaded[name, ()] = ours[name]
        out[label] = arms
        del run, solver, batch
        torch.cuda.empty_cache()
    return out


def held_to_plain(arm, what, outs, refs, f32):
    """Each of ``outs`` against the plain version's ``refs`` at the
    dtype's limits; -> {label: (of the largest element, worst tile)}."""
    readings = {}
    tile_limit = chip_smoke.FLASH_TILE_LIMIT["float32" if f32 else "bfloat16"]
    for label, got in outs.items():
        rel = chip_smoke._rel_err(got, refs[label])
        tile = chip_smoke._tile_err(torch, got, refs[label]) \
            if got.dim() == 4 else None
        limit = chip_smoke.ROW_LIMIT if got.dim() == 2 else \
            chip_smoke.F32_ELEMENT_LIMIT[label] if f32 else None
        chip_smoke.check(bool(torch.isfinite(got).all())
                         and (limit is None or rel <= limit)
                         and (tile is None or tile <= tile_limit),
                         f"{arm} {label} at {what}: {rel:.3e} of the largest "
                         f"element (limit {limit}), worst tile {tile} "
                         f"(limit {tile_limit:g})")
        readings[label] = (rel, tile)
    return readings


def outputs_of(calls):
    outs = dict(zip(("O", "LSE"), calls["fwd"]()))
    outs.update(zip(("dQ", "delta"), calls["dq"]()))
    outs.update(zip(("dK", "dV"), calls["dkv"]()))
    torch.cuda.synchronize()
    return outs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="the csrc/ directory of the baseline tree")
    ap.add_argument("--cases", choices=sorted(CASE_SETS), default="all",
                    help="the cases to time (default: all)")
    ap.add_argument("--sass", action="store_true",
                    help="first diff the SASS of every flash kernel both "
                         "trees build, and count the wgmma and mma.sync "
                         "instructions of the forward's and the backward's "
                         "instantiations on wgmma")
    ap.add_argument("--steps", type=int, default=0,
                    help="last time the LM row's step with each tree's "
                         "flash_fwd and flash_bwd, N steps an arm: bf16 on "
                         "one device and tp 2, or f32 on one device with "
                         "--cases f32; with --cases f32-256 the f32 step "
                         "of lm --d-model 2048 --heads 8 (default 0: not "
                         "timed)")
    args = ap.parse_args()
    chip_smoke.check(torch.cuda.is_available(), "no CUDA card")
    card = chip_smoke.nvidia_smi()
    wait = build(args.baseline, os.path.join(REPO, "_work", "flash_ab",
                                             "baseline"))
    variants = {"new": (), "control": cuda_build.TF32_ONE_PASS}
    for defines in variants.values():
        for source in SOURCES:
            cuda_build.library(source, defines)
    baseline = wait()
    arms = {"baseline": chip_smoke.flash_entry_points(baseline)}
    if args.sass:
        for name in SOURCES:
            for kind in SASS_SAME[name]:
                differ = sass_diff(os.path.join(REPO, "_work", "flash_ab",
                                                "baseline", f"{name}.so"),
                                   cuda_build.library_path(name), kind)
                print(f"[sass] {kind.pattern}: {differ} instantiations "
                      "differ")
            sass_products(cuda_build.library_path(name), SASS_PRODUCTS[name])
    arms.update((arm, chip_smoke.flash_entry_points(defines=d))
                for arm, d in variants.items())
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    results = []
    for shape, dname, causal in filter(CASE_SETS[args.cases], CASES):
        b, h, s, d = shape
        f32 = dname == "float32"
        dtype = getattr(torch, dname)
        what = f"{list(shape)} {dname} causal={causal}"
        q, k, v, do = ((0.5 * torch.randn(shape, generator=gen,
                                          device="cuda")).to(dtype)
                       for _ in range(4))
        with torch.no_grad():
            new = chip_smoke.flash_calls(torch, arms["new"], q, k, v, do,
                                         q, None, None, causal)
            o, lse = new["fwd"]()
            dq, delta = chip_smoke.flash_calls(
                torch, arms["new"], q, k, v, do, o, lse, None, causal)["dq"]()
            calls = {arm: chip_smoke.flash_calls(
                torch, fns, q, k, v, do, o, lse, delta, causal)
                for arm, fns in arms.items() if f32 or arm != "control"}
            ro, rlse = ca.flash_attention_fwd_plain(q, k, v, causal)
            rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do,
                                                      causal)
            rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                    causal)
            refs = {"O": ro, "LSE": rlse, "dQ": rdq, "delta": rdelta,
                    "dK": rdk, "dV": rdv}
            outputs = {arm: outputs_of(c) for arm, c in calls.items()}
            errors = {arm: held_to_plain(arm, what, outputs[arm], refs, f32)
                      for arm in ("baseline", "new")}
            for label, t in outputs_of(calls["new"]).items():
                chip_smoke.check(torch.equal(t, outputs["new"][label]),
                                 f"new {label} at {what}: two launches "
                                 "differ")
            control = {}
            if f32:
                control = {label: (chip_smoke._rel_err(t, refs[label]),
                                   chip_smoke._tile_err(torch, t,
                                                        refs[label]))
                           for label, t in outputs["control"].items()
                           if t.dim() == 4}
                chip_smoke.check(control["O"][0] > 2e-5,
                                 f"the one-pass control's O at {what} reads "
                                 f"{control['O'][0]:.3e}, within the f32 "
                                 "limit")
                chip_smoke.check(control["dQ"][0] > 5e-4 or control["dQ"][1]
                                 > 1e-4, f"the one-pass control's dQ at "
                                 f"{what} reads {control['dQ']}, within the "
                                 "f32 limits")
            del outputs, ro, rlse, rdq, rdelta, rdk, rdv, refs
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
            item, rows = q.element_size() * q.numel(), 4 * b * h * s
            work_of = {"fwd": (4 * item + rows, 4 * pairs * d),
                       "dq": (6 * item + 2 * rows, 6 * pairs * d),
                       "dkv": (6 * item + 2 * rows, 8 * pairs * d)}
            peak = chip_smoke.SPLIT_TF32_OPS_PER_S if f32 else \
                chip_smoke.BF16_TENSOR_OPS_PER_S
            for key, name, label in KERNELS:
                turns = [(arm, timer(calls[arm][key]))
                         for arm in ("baseline", "new", "new", "baseline")]
                # the one-pass control's time: the kernels' work with a
                # third of the tensor-core passes
                control_ms = timer(calls["control"][key]) if f32 else None
                old = [t for a, t in turns if a == "baseline"]
                ms = [t for a, t in turns if a == "new"]
                nbytes, flops = work_of[key]
                t_bytes = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
                t_ops = flops / peak * 1e3
                r = dict(name=name, shape=list(shape), dtype=dname,
                         causal=causal, baseline_ms=old, new_ms=ms,
                         library_ms=library_ms["fwd" if key == "fwd"
                                               else "bwd"],
                         library="F.scaled_dot_product_attention"
                         if key == "fwd" else "torch.autograd.grad of "
                         "F.scaled_dot_product_attention (dq, dk, dv)",
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", flops=flops, bytes=nbytes,
                         errors=errors, control=control,
                         control_ms=control_ms)
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
                      "of it)" + (f"; one-pass control {label} "
                                  f"{control[label][0]:.3e} of the largest "
                                  f"element, {control_ms:.4f} ms"
                                  if control else "")
                      + f"; {card}")
            del q, k, v, do, o, lse, dq, delta, calls, ql, kl, vl, lib_out
            torch.cuda.empty_cache()
    steps = time_steps(baseline, args.steps,
                       "f32" if args.cases.startswith("f32") else "bf16",
                       chip_smoke.LM_D256 if args.cases == "f32-256"
                       else None) if args.steps else {}
    print(card)
    print(json.dumps({"card": card, "rows": results, "steps": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
