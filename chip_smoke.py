#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sparknet_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

 1. device  — the card's name and power limit (nvidia-smi), torch, CUDA
              and nvcc versions; fails when torch.cuda.is_available() is
              False.
 2. build   — compiles the port's CUDA kernels from csrc/ (one nvcc per
              source, in parallel) and prints the seconds it took and
              ptxas's registers and spills of every kernel.
 3. kernels — each kernel wrapper (the three forwards and the two
              LRN backwards) against its plain PyTorch version on the card
              at the serving (b8) and training (b32) shapes, f32 and bf16,
              at CaffeNet's norm1 (256, 96, 27, 27) and norm2 (256, 256,
              13, 13) and at one dp slot's share of them (64, ...: phase
              10's dp runs), and at the edge geometry of the tiled kernels (one
              channel, 31 and 33 channels about a CTA's chunk of 32, H*W
              = 323 and 729, the largest windows taken, a view at an odd
              offset): max errors against stated limits, median kernel
              time over CUDA events with the L2 flushed between launches
              (the fused backward's without the wrapper's dbias sum),
              the bound (bytes over 3.35 TB/s or f32 operations over 67
              TFLOP/s, whichever is larger) and the kernel's share of it,
              the plain version's time and, where one PyTorch call
              computes the same function, that call's time (for the LRN
              backward: torch.autograd.grad of F.local_response_norm);
              and each launch's chunk and span, 16-byte or 4-byte path,
              registers, shared memory and CTAs per SM (walk_info).
 4. serve   — full-width GoogLeNet (224x224, 1000 classes) with seeded
              random weights, written as a snapshot by the port's writer
              and served by the port's serve_http: requests of 1, 3, 8 and
              5 rows over HTTP, answers checked against a CPU forward of
              the port (the kernels' plain versions), launch counters
              checked, then the drain. Run twice: the default
              SPARKNET_EPILOGUE=auto path (bias+ReLU+LRN fused at conv2)
              and the SPARKNET_EPILOGUE=on path (every conv+ReLU fused).
              Per-bucket device forward times, images/s at bucket 8 and
              request latency are printed beside the card's name, then
              a torch.profiler window over bucket-8 forwards: device time
              by kernel group and the device's busy share.
 5. train   — full-width GoogLeNet train net (both aux heads, batch 32)
              with bvlc_googlenet's solver values: `python -m
              sparknet_tpu_torch train` for 24 iterations with snapshots,
              then `--resume auto` to 32 (the counter must continue); in
              process, 20 steps of the port's Solver on one fixed batch
              (the loss must fall; the LRN and fused-epilogue kernels,
              forward and backward, launch at least once per step) and 2
              under SPARKNET_EPILOGUE=on (bias_relu launches); the train
              step time (CUDA events) and images/s; a torch.profiler
              window (device time by group, busy share); and card against
              CPU: 2 steps at batch 4, dropout 0, from one snapshot, TF32
              left to the Solver, weights read by their change; controls:
              the CPU on one thread (must pass), a zeroed LRN backward at
              each site and TF32 on (each must fail the same reading).
 6. flash   — registers, spills, shared memory and CTAs per SM of every
              flash kernel instantiation, forward and backward (the bf16
              tensor-core kernels must not spill; the backward's must fit
              two CTAs per SM at head_dim 128); then the three
              flash-attention kernels (forward, dQ, dK/dV) against their
              plain versions: f32 at (2, 4, 1024, 64), causal and not,
              bf16 at (2, 4, 1024, 128) full, (2, 4, 1024, 64) causal
              and (2, 4, 1024, 96) causal (a head_dim that is not built,
              zero-padded to 128), and bf16 at the LM's full width (4, 8,
              4096, 128), causal;
              each output's worst 64-row tile against f32 1e-4 and bf16
              5e-3 of that tile's norm (a measure that does not shrink
              along the sequence as causal outputs do; the bf16 kernels
              round P, and dS, to bf16 before their second products),
              with two planted faults that must fail it and the library's
              own O and gradients read beside it, f32 also against 2e-5
              (forward) and 5e-4 (backward) of the largest reference
              element, LSE and delta against 2e-5 of theirs; median times
              over CUDA events with the L2 flushed, achieved TFLOP/s; the
              bound (the larger of bytes over 3.35 TB/s and FLOPs over 67
              TFLOP/s f32 or 989 TFLOP/s dense bf16 tensor); the library
              call (F.scaled_dot_product_attention forward, and
              torch.autograd.grad through it for dq, dk, dv together).
 7. lm      — the transformer LM at the full width of bench.py's larger
              row (vocab 8192, S 4096, batch 4, d 1024, 12 layers, 8
              heads, bf16 activations over f32 masters, Adam): `python -m
              sparknet_tpu_torch lm` for 3 steps with a snapshot, then
              --resume to 5 (the counter continues, each kernel launches
              exactly 12 times per step in both runs, the loss falls from
              about ln 8192); in process, the train step time (CUDA
              events) and tokens/s, launches per step, and a profiler
              window (port attention kernels, cuBLAS GEMMs, other; busy
              share); and card against CPU for a small LM (2 layers, d
              256, 4 heads, S 256, batch 2, f32): the first step's
              gradients under the lm verb's Solver, and two Adam steps
              from one snapshot (losses and weight changes), with controls
              (the CPU on one thread must pass; the dQ kernel's output
              zeroed and the dK/dV kernel's output zeroed must fail).
 8. local-sgd — SparkNet's own algorithm over 4 worker slots on the
              card: `python -m sparknet_tpu_torch make_synth_cifar`
              (10,000 + 1,000 records), then the `cifar` verb at
              CifarApp's settings (cifar10_full, per-worker batch 100,
              tau 10, the zoo solver) for 6 rounds with tests and
              snapshots (the round loss must fall), --resume auto for 2
              more (the counter continues from 60) and --strategy dp for
              2 steps; in process, a cifar10_full round and a CaffeNet
              round at the ImageNet app's widths (batch 256 a slot, tau
              cut from 50 to 10, f32) by CUDA events with images/s beside
              the K40's 267, CaffeNet's LRN launches (norm1 and norm2,
              forward and backward, once a step), the slot average's
              time, peak memory and a profiler window; card against CPU
              for one round of cifar10_full (2 slots x batch 8, tau 3),
              with the control (slot 0's params in place of the average)
              failing, and the tau-1 identity with one DataParallelSolver
              step on the card.
 9. records — CaffeNet trained from stock records: 2,560 + 512 Datums of
              3x256x256 uint8 (1,000-class class-gaussian images, one
              seed) written by the port's LMDBWriter, their mean by
              compute_image_mean; the device transform on the card
              against the host transform at CaffeNet's b256 (bit for bit,
              with a shifted-offset control that must differ), its time
              against its bound, the host transform's and the copies to
              the card; `python -m sparknet_tpu_torch train` (the
              device cache off) on a stock-form CaffeNet train_val (Data layers, LMDB, batch
              256, crop 227, mirror, mean_file; bvlc_reference_caffenet's
              solver) for 30 iterations and one test pass (finite losses,
              2 LRN forward and 2 backward launches an iteration); in
              process, the record-fed step in both modes (device
              transform, --host-transform) beside the step on a batch
              made on the card, each with images/s and a profiler
              window's busy share, and the host reader's time; then the
              `imagenet` verb at 4 slots x b256, 1,000 classes, tau cut
              from 50 to 2, 2 rounds (finite losses, images/s a round).
10. feeds  — the train verb's whole input path on phase 9's CaffeNet
              b256 records: the verb with default flags (the records
              resident on the card: `device-cached`), with
              SPARKNET_DEVICE_CACHE_MB=0 (`device-transform`) and with
              `--strategy dp --mesh data=4`, 10 iterations each (finite
              losses, the LRN launches); in process, bit for bit on the
              card the cached and streaming feeds' first transformed
              batches and the precrop and raw ones', then 12 timed steps
              of each feed (cached, streaming, `--wire precrop`, `--echo
              2`, a batch made on the card; the dp solver's 4 x 64,
              staged as the verb feeds it and unstaged as a control, in
              the order unstaged, staged, staged, unstaged) with
              images/s, busy share and bytes copied to the card a step,
              the cache's resident MiB, upload seconds and peak memory;
              the bit-pack wire on a 2-bit source (pack and
              precrop+pack against raw, bit for bit, KB an image);
              cifar10_full b100 from convert_cifar_data's records
              (10,000 + 1,000) cached, streaming and on the card; and
              `extract_features` of fc7 for 2 batches, read back and held
              to a forward on the card.
11. zoo    — the layer zoo and the Switch-MoE LM: `python -m
              sparknet_tpu_torch lm` at phase 7's full width with
              `--moe-experts 8 --moe-aux-weight 0.01` (top-1 routing,
              capacity factor 1.25, F 4096) for 4 steps (finite losses,
              each flash kernel 12 times a step); in process, its train
              step (median of 5, CUDA events), tokens/s, peak memory, a
              profiler window (f32 expert GEMMs, dispatch and combine,
              flash, bf16 GEMMs, other) and one layer's expert FFN alone
              times 12 against the step; card against CPU for a 2-layer
              MoE LM of 4 experts (one Adam step: loss, gradients, weight
              changes; every token's router margin above twice its
              card-CPU logit difference; the combine without its gate as
              a control that must fail); the stock BatchNorm/Sigmoid
              CIFAR net (zoo.cifar10_full_sigmoid_bn, batch 100) through
              the train verb for 30 iterations on convert_cifar_data
              records (3,000 + 200) with a test pass and a snapshot, its
              BN state blobs read back (moved, s = sum of 0.999^i), the
              snapshot served on the card (4 requests against a CPU
              TEST-phase forward); and each of the 24 layer types the
              zoo adds to the earlier paths' (BatchNorm, Deconvolution,
              Im2col, SPP, the neuron, structural, Python and MoE
              layers), and STOCHASTIC pooling, forward and backward on
              the card against the CPU at one realistic shape (f32, TF32
              off, 1e-5 or 1e-4 of the largest value), with its time.
12. levers, run safety and the metrics stream — GoogLeNet b32 (f32)
              under --remat none, dots and full in process: the step
              (median of 10, CUDA events), peak allocated memory and
              each LRN/epilogue kernel's launches an iteration (forwards
              double under remat, backwards do not); two SGD steps from
              one snapshot under each policy, deterministic cuDNN, within
              1e-4 relative on the loss and each blob's weight change;
              --precision bf16 against fp32, the losses bit for bit (C8);
              the train verb with --remat full --metrics --profile
              --stall-seconds 600 --keep 2 (every event registered, the
              report verb exits 0, its step p50 beside the in-process
              median, the torch.profiler trace naming the channel_walk
              kernels); the LM at phase 7's width under each policy (step
              median of 5, peak memory, flash forward launches against
              dQ/dK/dV) and the lm verb under --remat dots; and on a
              small net, each in a child under `timeout -s KILL`: SIGTERM
              snapshots and exits 0 (--resume auto restores it), a layer
              that hangs with --stall-seconds 5 exits 42 leaving a
              snapshot that restores, a NaN batch with --recover 2 rolls
              back and goes on with finite losses.
    After the phases: the kernel table as one JSON line, an entry for
    every timed f32 row of phase 3 and the LM's flash row of phase 6
    (launches from the
    serving path for the GoogLeNet forwards, the training path for their
    backwards, the train verb's default device-cached feed of phase 10
    for CaffeNet's LRN shapes, with the local-SGD rounds', the imagenet
    verb's, phase 9's streaming verb's and phase 10's streaming and dp
    verbs' beside them, phase 10's dp verb for one dp slot's LRN shapes,
    the lm verb's first run for the flash kernels, with the MoE LM's
    verb and in-process launches beside them),
    with phase 12's launches an iteration under each remat policy beside
    them), each phase's wall seconds and the total, the nvidia-smi line,
    and as the last line {"ok": true, "device": {...}}.

``python3 chip_smoke.py --phases 12`` (a comma-separated list) runs
phases 1 and 2 and those given, for development calls: it prints each
phase's seconds and no result lines. With no arguments every phase runs.
"""

import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
SEED = 1234
REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# -- phase 1 --------------------------------------------------------------

def phase_device(torch):
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: no card, no result")
    card = nvidia_smi()
    from sparknet_tpu_torch.ops import cuda_build
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    check(nvcc.returncode == 0, f"nvcc --version failed: {nvcc.stderr}")
    print(f"[device] {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | "
          f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return card


# -- phase 2 --------------------------------------------------------------

def phase_build():
    from sparknet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build(ptxas_verbose=True)
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"[build] {name}: {line}")
    print(f"[build] compiled {sorted(logs) or 'nothing (already built)'} "
          f"in {dt:.2f} s into {cuda_build.BUILD_DIR}")
    return dt


# -- phase 3 --------------------------------------------------------------

class Timer:
    """Median time of ``fn`` over CUDA events; with ``flush`` the L2
    cache (50 MB) is flushed by a 96 MB write before every launch, and
    the card then spins ~0.3 ms (torch.cuda._sleep) so that it is still
    busy while the host enqueues the start event and ``fn``'s kernels:
    the time is the device's, not the host's launch path."""

    def __init__(self, torch, reps=30, flush=True):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(96 * 2 ** 20 // 4, device="cuda") \
            if flush else None

    def __call__(self, fn):
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            if self.flush is not None:
                self.flush.zero_()
                torch.cuda._sleep(500_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def _errors(torch, got, ref, floor=None):
    """Max errors and the verdict against the limit: f32 1e-5 relative,
    bf16 one bf16 ulp, of |ref| per element, or of ``floor`` where that
    is larger (the backward kernels: see phase_kernels)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    scale = r.abs() if floor is None else torch.maximum(r.abs(), floor)
    if ref.dtype == torch.bfloat16:
        # one bf16 ulp: 2^(floor(log2 scale) - 7)
        ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
        limit = torch.where(scale == 0, torch.zeros_like(ulp), ulp)
        what = "1 bf16 ulp"
    else:
        limit = 1e-5 * scale
        what = "1e-5 relative"
    if floor is not None:
        what += " of max(|ref|, |g| k^-beta)"
    ok = bool((diff <= limit).all())
    rel = float((diff / r.abs().clamp_min(1e-30)).max())
    return float(diff.max()), rel, ok, what


# each channel-walk wrapper -> (csrc/<source>.cu, the entry's variant flag)
WALKS = {"lrn_across": ("lrn", 0), "bias_relu": ("epilogue", 0),
         "bias_relu_lrn": ("epilogue", 1), "lrn_across_bwd": ("lrn_bwd", 0),
         "bias_relu_lrn_bwd": ("lrn_bwd", 1)}


def phase_kernels(torch):
    """Each kernel against its plain version at the serving shapes (b8)
    and the training shapes (b32), f32 and bf16, plus a ragged edge case.

    The backward dx = g*s^-beta - c*x*sum(...) is a difference of two
    terms, so where they cancel its value is far smaller than the
    rounding of either; its limit is therefore taken of the larger of
    |dx| and |g|*k^-beta, which bounds the first term (s >= k)."""
    import torch.nn.functional as F
    from sparknet_tpu_torch.ops import cuda_build
    from sparknet_tpu_torch.ops import cuda_epilogue as ce
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timer = Timer(torch)
    lrn_p = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)   # GoogLeNet's LRNs
    edge = dict(size=4, alpha=1e-2, beta=0.6, k=2.0)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)

    def floor(g, p):
        return g.abs().float() * p["k"] ** -p["beta"]

    def lrn_lib_fwd(x, p):
        return lambda: F.local_response_norm(x, p["size"], p["alpha"],
                                             p["beta"], p["k"])

    def lrn_lib_bwd(x, g, p):
        """torch.autograd.grad of F.local_response_norm: the backward
        pass alone, over a graph built once."""
        with torch.enable_grad():
            xl = x.detach().clone().requires_grad_()
            y = F.local_response_norm(xl, p["size"], p["alpha"], p["beta"],
                                      p["k"])

        def run():
            with torch.enable_grad():
                return torch.autograd.grad(y, xl, g, retain_graph=True)[0]
        return run

    cases = []

    def lrn_fwd(x, p, row=False, edge_case=False):
        cases.append(dict(
            name="lrn_across", x=x, dtype=x.dtype,
            kernel=lambda: cl.lrn_across(x, **p),
            plain=lambda: cl.lrn_across_plain(x, **p),
            library=None if edge_case else lrn_lib_fwd(x, p),
            inputs=[x], ops_per_elem=2 * p["size"] + 4, row=row,
            edge=edge_case, size=p["size"]))

    def brl_fwd(x, b, p, row=False, edge_case=False):
        cases.append(dict(
            name="bias_relu_lrn", x=x, dtype=x.dtype,
            kernel=lambda: ce.bias_relu_lrn(x, b, **p),
            plain=lambda: ce.bias_relu_lrn_plain(x, b, **p), library=None,
            inputs=[x, b], ops_per_elem=2 * p["size"] + 6, row=row,
            edge=edge_case, size=p["size"]))

    def lrn_bwd(x, g, p, row=False, edge_case=False):
        cases.append(dict(
            name="lrn_across_bwd", x=x, dtype=x.dtype,
            kernel=lambda: cl.lrn_across_bwd(x, g, **p),
            plain=lambda: cl.lrn_across_bwd_plain(x, g, **p),
            library=None if edge_case else lrn_lib_bwd(x, g, p),
            inputs=[x, g], ops_per_elem=3 * p["size"] + 10, row=row,
            edge=edge_case, floor=floor(g, p), size=p["size"]))

    def brl_bwd(x, b, g, p, row=False, edge_case=False):
        bk = b.to(x.dtype).contiguous()     # as the wrapper passes it
        cases.append(dict(
            name="bias_relu_lrn_bwd", x=x, dtype=x.dtype,
            kernel=lambda: ce.bias_relu_lrn_bwd(x, b, g, **p)[0],
            # timed: dx alone, without the wrapper's dbias sum
            timed=lambda: cl.launch_lrn_backward(
                x, bk, g, p["size"], p["alpha"], p["beta"], p["k"],
                "bias_relu_lrn_bwd"),
            plain=lambda: ce.bias_relu_lrn_bwd_plain(x, b, g, **p)[0],
            library=None, inputs=[x, b, g],
            ops_per_elem=3 * p["size"] + 12, row=row, edge=edge_case,
            floor=floor(g, p), size=p["size"]))

    def bias_relu(x, b, row=False, edge_case=False):
        cases.append(dict(
            name="bias_relu", x=x, dtype=x.dtype,
            kernel=lambda: ce.bias_relu(x, b),
            plain=lambda: ce.bias_relu_plain(x, b), library=None,
            inputs=[x, b], ops_per_elem=2, row=row, edge=edge_case))

    def at_offset(t):
        """a contiguous view of t one element into a larger buffer: its
        rows are not 16-byte aligned"""
        buf = torch.empty(t.numel() + 1, device="cuda", dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        lrn_fwd(randn((8, 64, 56, 56), dtype), lrn_p, row=f32)   # serving
        lrn_fwd(randn((32, 64, 56, 56), dtype), lrn_p, row=f32)  # training
        x, g = randn((32, 64, 56, 56), dtype), randn((32, 64, 56, 56), dtype)
        lrn_bwd(x, g, lrn_p, row=f32)
        x2, b2 = randn((32, 192, 56, 56), dtype), randn((192,), scale=0.5)
        g2 = randn((32, 192, 56, 56), dtype)
        brl_bwd(x2, b2, g2, lrn_p, row=f32)
        # CaffeNet's norm1 and norm2 at the ImageNet app's batch (256),
        # and at one dp slot's share of it (64; phase 10's dp runs):
        # H*W = 729 and 169 take the kernels' scalar path
        for shape in CAFFENET_LRN_SHAPES + CAFFENET_DP_LRN_SHAPES:
            x3 = randn(shape, dtype)
            lrn_fwd(x3, lrn_p, row=f32)
            if f32:
                lrn_bwd(x3, randn(shape, dtype), lrn_p, row=True)
        # the edge geometry: one channel, a CTA's 32-channel chunk less and
        # more one, H*W not a multiple of 4 (323, 729), the largest windows
        # taken, and a contiguous view at an odd offset
        for shape, p in (((3, 3, 17, 19), edge), ((4, 1, 56, 56), lrn_p),
                         ((4, 31, 28, 28), lrn_p), ((4, 33, 27, 27), edge)):
            xe, ge = randn(shape, dtype, 3.0), randn(shape, dtype)
            be = randn(shape[1:2], scale=0.5)
            lrn_fwd(xe, p, edge_case=True)
            lrn_bwd(xe, ge, p, edge_case=True)
            brl_fwd(xe, be, p, edge_case=True)
            brl_bwd(xe, be, ge, p, edge_case=True)
        xe, ge = randn((2, 8, 13, 13), dtype, 3.0), randn((2, 8, 13, 13), dtype)
        lrn_fwd(xe, dict(edge, size=cuda_build.MAX_WINDOW), edge_case=True)
        lrn_bwd(xe, ge, dict(edge, size=cuda_build.MAX_WINDOW_BWD),
                edge_case=True)
        xe = at_offset(randn((4, 40, 56, 56), dtype, 3.0))
        ge = at_offset(randn((4, 40, 56, 56), dtype))
        be = randn((40,), scale=0.5)
        lrn_fwd(xe, edge, edge_case=True)
        lrn_bwd(xe, ge, edge, edge_case=True)
        brl_fwd(xe, be, edge, edge_case=True)
        brl_bwd(xe, be, ge, edge, edge_case=True)
        bias_relu(xe, be, edge_case=True)
    x2, b2 = randn((8, 192, 56, 56)), randn((192,), scale=0.5)
    brl_fwd(x2, b2, lrn_p, row=True)                        # serving
    brl_fwd(randn((32, 192, 56, 56)), b2, lrn_p, row=True)  # training
    bias_relu(randn((8, 64, 112, 112)), randn((64,), scale=0.5), row=True)

    results = []
    with torch.no_grad():
        for c in cases:
            got = c["kernel"]()
            torch.cuda.synchronize()
            ref = c["plain"]()
            check(got.shape == ref.shape and got.dtype == ref.dtype,
                  f"{c['name']}: shape/dtype {got.shape} {got.dtype} vs "
                  f"{ref.shape} {ref.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"{c['name']}: non-finite output")
            abs_err, rel_err, ok, limit = _errors(torch, got, ref,
                                                  c.get("floor"))
            source, variant = WALKS[c["name"]]
            aligned = all(t.data_ptr() % 16 == 0 for t in c["inputs"]
                          if t.dim() == 4)
            walk = cuda_build.walk_info(
                source, c["dtype"], variant, c["x"].shape[1],
                c["x"].shape[2] * c["x"].shape[3], c.get("size", 1), aligned)
            out_bytes = got.numel() * got.element_size()
            in_bytes = sum(t.numel() * t.element_size() for t in c["inputs"])
            nbytes = in_bytes + out_bytes
            ops = got.numel() * c["ops_per_elem"]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_OPS_PER_S * 1e3
            r = dict(
                name=c["name"], shape=list(c["x"].shape),
                dtype=str(c["dtype"]).replace("torch.", ""),
                max_abs_err=abs_err, max_rel_err=rel_err, limit=limit,
                ms=timer(c.get("timed", c["kernel"])),
                plain_ms=timer(c["plain"]),
                library_ms=timer(c["library"]) if c["library"] else None,
                bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                edge=c.get("edge", False), row=c["row"], size=c.get("size"),
                aligned=aligned, **walk)
            r["bound_share"] = r["bound_ms"] / r["ms"]
            print(f"[kernels] {r['name']} {r['shape']} {r['dtype']} size "
                  f"{r['size']}{'' if aligned else ' (unaligned)'}: "
                  f"max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} "
                  f"(limit {limit}: {'ok' if ok else 'FAIL'}) | kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {nbytes / 1e6:.1f} MB; "
                  f"{100 * r['bound_share']:.1f}% of it) | chunk "
                  f"{walk['chunk']} x {walk['chunks']}, span {walk['span']} "
                  f"x {walk['spans']}, {'16-byte' if walk['vec'] else '4-byte'}"
                  f" path, {walk['registers']} registers, "
                  f"{walk['smem_bytes']} B shared, {walk['ctas_per_sm']} CTAs "
                  f"per SM, {walk['local_bytes']} B spilled")
            check(ok, f"{c['name']} {r['shape']} {r['dtype']} disagrees "
                      f"with its plain version beyond {limit}")
            results.append(r)
    return results


# -- phase 4 --------------------------------------------------------------

def _post(url, rows):
    body = json.dumps({"data": rows.tolist()}).encode()
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = json.loads(resp.read())
    return out, (time.perf_counter() - t0) * 1e3


def _serve_requests(url, inputs, reference, path, top="loss3/classifier",
                    classes=1000):
    lat = []
    for x in inputs:
        out, ms = _post(url, x)
        lat.append(ms)
        logits = np.asarray(out["outputs"][top], np.float32)
        ref = reference(x)
        check(logits.shape == (x.shape[0], classes),
              f"{path}: logits shape {logits.shape} for {x.shape[0]} rows")
        check(np.isfinite(logits).all(), f"{path}: non-finite logits")
        check(np.abs(logits).max() > 0, f"{path}: all-zero logits")
        err = float(np.abs(logits - ref).max() / np.abs(ref).max())
        print(f"[serve] {path}: {x.shape[0]} rows -> bucket "
              f"{out['bucket']}, {ms:.1f} ms round trip, max |card - cpu| / "
              f"max |cpu| = {err:.3e} (limit 1e-3)")
        check(err <= 1e-3, f"{path}: logits differ from the CPU forward "
                           f"by {err:.3e} of the largest logit")
    return lat


def phase_serve(torch, card):
    from sparknet_tpu_torch.graph import CompiledNet, TEST
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    from sparknet_tpu_torch.resilience import save_model_snapshot
    from sparknet_tpu_torch.serve import (Batcher, ServeEngine,
                                          deploy_net_param, serve_http)
    os.environ.pop("SPARKNET_EPILOGUE", None)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    prefix = os.path.join(tmp, "googlenet")
    net = CompiledNet(deploy_net_param(zoo.googlenet(batch_size=8,
                                                     with_aux=False)),
                      TEST, device="cpu")
    params, state = net.init(torch.Generator().manual_seed(SEED))
    save_model_snapshot(net, params, prefix, iter=0, state=state)
    n_params = sum(t.numel() for v in params.values() for t in v)
    print(f"[serve] GoogLeNet deploy net: {len(net.layers)} layers, "
          f"{n_params} params, snapshot at {prefix}")

    engine = ServeEngine(prefix, max_batch=8, device="cuda", log_fn=None)
    engine.load()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    print(f"[serve] warmup of buckets {engine.buckets}: "
          f"{time.perf_counter() - t0:.2f} s")
    cpu = ServeEngine(prefix, max_batch=8, device="cpu", log_fn=None)
    cpu.load()

    rs = np.random.RandomState(SEED)
    inputs = [np.round(rs.randn(n, 3, 224, 224), 3).astype(np.float32)
              for n in (1, 3, 8, 5)]
    refs = {}

    def reference(x):
        key = id(x)
        if key not in refs:
            refs[key] = cpu.forward({"data": x})[0]["loss3/classifier"]
        return refs[key]

    batcher = Batcher(max_batch=8, max_wait_s=0.002, queue_limit=64)
    stop = threading.Event()
    listening = threading.Event()
    urls, rcs = [], []

    def run():
        rcs.append(serve_http(
            engine, batcher, port=0, stop_event=stop, log_fn=print,
            on_listen=lambda u: (urls.append(u), listening.set())))

    server = threading.Thread(target=run, daemon=True)
    server.start()
    check(listening.wait(120), "server did not start listening")
    url = urls[0]
    launches = {}
    latencies = []
    for path, mode in (("auto", None), ("on", "on")):
        if mode is None:
            os.environ.pop("SPARKNET_EPILOGUE", None)
        else:
            os.environ["SPARKNET_EPILOGUE"] = mode
        for fn in KERNEL_WRAPPERS:
            fn.launches = 0
        lat = _serve_requests(url, inputs, reference,
                              f"SPARKNET_EPILOGUE={path}")
        counts = kernel_launches()
        print(f"[serve] SPARKNET_EPILOGUE={path}: launches during the "
              f"requests {counts}")
        launches[path] = counts
        latencies += lat
    os.environ.pop("SPARKNET_EPILOGUE", None)
    stop.set()
    server.join(timeout=120)
    check(not server.is_alive(), "server did not drain")
    check(rcs == [0], f"drain returned {rcs}, want [0]")
    print("[serve] drain returned 0")
    check(launches["auto"]["lrn_across"] > 0,
          "lrn_across kernel never launched on the auto path")
    check(launches["auto"]["bias_relu_lrn"] > 0,
          "bias_relu_lrn kernel never launched on the auto path")
    check(launches["on"]["bias_relu"] > 0,
          "bias_relu kernel never launched on the on path")

    # per-bucket device forward (default path), CUDA events, median of 20
    timer = Timer(torch, reps=20)
    per_bucket = {}
    for b in engine.buckets:
        feeds = {"data": torch.as_tensor(
            np.round(rs.randn(b, 3, 224, 224), 3).astype(np.float32)
        ).cuda()}
        per_bucket[b] = timer(lambda: engine.run_bucket(b, feeds))
    ips = 8 / (per_bucket[8] / 1e3)
    p50 = statistics.median(latencies)
    for b, ms in per_bucket.items():
        print(f"[serve] bucket {b}: device forward {ms:.3f} ms "
              f"(median of 20, CUDA events; {card})")
    print(f"[serve] bucket 8: {ips:.1f} images/s; request round trip p50 "
          f"{p50:.1f} ms over {len(latencies)} requests (JSON encode and "
          f"parse included; {card})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feeds = {"data": torch.randn(8, 3, 224, 224, generator=gen,
                                 device="cuda")}
    profile = _profile(torch, lambda: engine.run_bucket(8, feeds), 10,
                       _serve_group, "bucket 8 forward", card)
    return {"auto": launches["auto"], "on": launches["on"],
            "per_bucket_ms": per_bucket, "images_per_s_b8": ips,
            "p50_ms": p50, "profile_b8": profile}


def _device_events(prof, reps):
    """[(ms per rep, count per rep, name)] of the events that ran on the
    card (kernels, copies, memsets); the host-side ops, whose device
    time repeats their kernels', are left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out.append((us / 1e3 / reps, e.count // reps, e.key))
    return out


_CONV = ("conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "fft",
         "complex", "winograd", "fprop")


def _serve_group(name):
    if "channel_walk" in name:
        return "port kernels (channel_walk)"
    if any(s in name for s in _CONV):
        return "convolution (cuDNN)"
    return "pooling" if "pool" in name else "other"


def _train_group(name):
    if "channel_walk" in name:
        return "port kernels (channel_walk)"
    if any(s in name for s in ("dgrad", "wgrad", "bprop", "backward",
                               "bwd")):
        return "convolution backward (cuDNN)" if any(
            s in name for s in _CONV + ("dgrad", "wgrad")) else "other"
    if any(s in name for s in _CONV):
        return "convolution forward (cuDNN)"
    return "other"


def _profile(torch, fn, reps, classify, label, card, top=8):
    """Device time by group (``classify(lowercase kernel name)``) over
    ``reps`` calls of ``fn`` under torch.profiler, after one call
    outside the window, each port kernel's own (a group named "port
    ..."), and the device's busy share of the window's wall time (host
    clock around synchronized work). None when the profiler recorded no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_events(prof, reps)
    groups = {}
    for ms, n, key in kernels:
        g = classify(key.lower())
        groups[g] = groups.get(g, 0.0) + ms
    busy = sum(groups.values())
    out = {"wall_ms_per_call": wall_ms / reps, "device_ms_per_call": busy,
           "busy_share": busy * reps / wall_ms, "groups_ms": groups}
    print(f"[profile] {label}: wall {out['wall_ms_per_call']:.3f} ms per "
          f"call, device busy {busy:.3f} ms "
          f"({100 * out['busy_share']:.1f}%); {card}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {g}: {ms:.4f} ms per call")
    ranked = sorted(kernels, reverse=True)
    port = [k for k in ranked if classify(k[2].lower()).startswith("port")]
    out["port_kernels_ms"] = {key[:80]: ms for ms, n, key in port}
    # the top kernels, and every port kernel below them
    shown = ranked[:top] + [k for k in port if k not in ranked[:top]]
    for ms, n, key in shown:
        print(f"[profile]   {ms:.4f} ms x{n}  {key[:80]}")
    if busy <= 0:        # a profiler without device access records none
        print("[profile] the profiler recorded no device time; the CUDA "
              "event times above stand")
        return None
    return out


# -- phase 5 --------------------------------------------------------------

def _googlenet_solver(batch, prefix, dropout=True):
    """bvlc_googlenet's solver (SGD, base_lr 0.01, step policy with gamma
    0.96, momentum 0.9, weight_decay 0.0002) over an inline
    zoo.googlenet(batch_size=batch) train net with both aux heads."""
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.proto import Message
    sp = Message("SolverParameter", base_lr=0.01, lr_policy="step",
                 gamma=0.96, stepsize=320000, momentum=0.9,
                 weight_decay=0.0002, display=8, average_loss=8,
                 snapshot=12, snapshot_prefix=prefix, random_seed=SEED)
    sp.net_param = zoo.googlenet(batch_size=batch)
    if not dropout:
        for lp in sp.net_param.layer:
            if lp.type == "Dropout":
                lp.dropout_param.dropout_ratio = 0.0
    return sp


def _batch(rs, n):
    return {"data": np.round(rs.randn(n, 3, 224, 224), 3).astype(np.float32),
            "label": rs.randint(0, 1000, n).astype(np.int32)}


def _train_cli(args, timeout=600):
    """``python -m sparknet_tpu_torch train`` in a child process that
    ends (or is killed at ``timeout``) before this returns."""
    cmd = [sys.executable, "-m", "sparknet_tpu_torch", "train", *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
    for line in out.stdout.strip().splitlines():
        print(f"[train-cli] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    print(f"[train-cli] exited 0 in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def _check_cli_launches(out, iterations):
    """The train verb's last line counts its kernels' launches: each of
    the four kernels of the ``auto`` path must have launched at least
    once per iteration of that run."""
    last = out.strip().splitlines()[-1]
    check(last.startswith("Kernel launches: "),
          f"the train verb's last line is not its launch counts: {last}")
    counts = json.loads(last[len("Kernel launches: "):])
    for name in ("lrn_across", "lrn_across_bwd", "bias_relu_lrn",
                 "bias_relu_lrn_bwd"):
        check(counts[name] >= iterations,
              f"train verb: {name} launched {counts[name]} times in "
              f"{iterations} iterations, want at least one per iteration")
    return counts


def phase_train_cli(tmp, batch=32):
    """The train verb at full width: 24 iterations with a snapshot every
    12, then --resume auto to 32; the counter must continue from 24, and
    each run's launch counts show the kernels ran in every iteration."""
    from sparknet_tpu_torch.proto import text_format
    path = os.path.join(tmp, "googlenet_solver.prototxt")
    prefix = os.path.join(tmp, "googlenet_train")
    text_format.dump(_googlenet_solver(batch, prefix), path)
    out = _train_cli(["--solver", path, "--iterations", "24"])
    check("Optimization done, iter=24" in out, "train did not reach 24")
    launches = [_check_cli_launches(out, 24)]
    for it in (12, 24):
        check(os.path.exists(f"{prefix}_iter_{it}.solverstate"),
              f"no snapshot at iteration {it}")
    out = _train_cli(["--solver", path, "--iterations", "32", "--resume",
                      "auto"])
    check("resume auto: restored iter 24" in out,
          "--resume auto did not pick up the iteration-24 snapshot")
    check("Iteration 24, loss" in out and "Iteration 0," not in out,
          "the resumed run did not continue from iteration 24")
    check("Optimization done, iter=32" in out, "resumed run did not reach 32")
    launches.append(_check_cli_launches(out, 8))
    losses = [float(l.split("loss = ")[1].split(",")[0])
              for l in out.splitlines() if "loss = " in l]
    check(losses and all(np.isfinite(losses)), f"losses {losses}")
    return {"resumed_losses": losses, "cli_launches": launches}


def phase_train(torch, card, tmp, batch=32, steps=20):
    """In-process training through the port's Solver at full width:
    a fixed batch for ``steps`` steps under SPARKNET_EPILOGUE=auto (the
    loss must fall; launches counted), 2 steps under =on, the train step
    time and a profiler window; then card against CPU at batch 4."""
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    from sparknet_tpu_torch.solver import Solver
    os.environ.pop("SPARKNET_EPILOGUE", None)
    rs = np.random.RandomState(SEED)
    solver = Solver(_googlenet_solver(batch, os.path.join(tmp, "fixed")),
                    device="cuda", log_fn=None)
    feed = {k: torch.as_tensor(v).cuda() for k, v in _batch(rs, batch).items()}
    float(solver.train_step(feed))              # warm-up: cuDNN plans
    launches = {}
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    losses = [float(solver.train_step(feed)) for _ in range(steps)]
    launches["auto"] = kernel_launches()
    print(f"[train] fixed batch, {steps} steps: losses "
          f"{[round(l, 4) for l in losses]}")
    print(f"[train] SPARKNET_EPILOGUE=auto: launches in {steps} steps "
          f"{launches['auto']}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"loss did not fall on a fixed batch: mean of the "
                        f"first 5 steps {first:.4f}, of the last 5 "
                        f"{last:.4f}")
    for name in ("lrn_across", "lrn_across_bwd", "bias_relu_lrn",
                 "bias_relu_lrn_bwd"):
        check(launches["auto"][name] >= steps,
              f"{name}: {launches['auto'][name]} launches in {steps} "
              "training steps, want at least one per step")
    os.environ["SPARKNET_EPILOGUE"] = "on"
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for _ in range(2):
        float(solver.train_step(feed))
    launches["on"] = kernel_launches()
    os.environ.pop("SPARKNET_EPILOGUE", None)
    print(f"[train] SPARKNET_EPILOGUE=on: launches in 2 steps "
          f"{launches['on']}")
    check(launches["on"]["bias_relu"] >= 2,
          "bias_relu never launched on the SPARKNET_EPILOGUE=on train path")

    # step time: CUDA events around train_step on a device-resident batch
    step_ms = Timer(torch, reps=10, flush=False)(
        lambda: solver.train_step(feed))
    ips = batch / (step_ms / 1e3)
    print(f"[train] GoogLeNet b{batch} fp32 (TF32 off) train step "
          f"{step_ms:.3f} ms (median of 10, CUDA events), {ips:.1f} "
          f"images/s; {card}")
    profile = _profile(torch, lambda: solver.train_step(feed), 3,
                       _train_group, "b32 train step", card, top=14)
    parity = _card_vs_cpu(torch, tmp)
    return {"launches": launches, "fixed_batch_losses": losses,
            "step_ms": step_ms, "images_per_s": ips, "profile": profile,
            "card_vs_cpu": parity}


# Between the sound readings (1.5e-2 at most: the gradients of a
# randomly initialised GoogLeNet cancel so much that a change of
# summation order alone moves them by that much) and the controls (TF32
# on 0.28, a zeroed LRN backward 1.0); see PERF.md.
WEIGHT_CHANGE_LIMIT = 5e-2


def _card_vs_cpu(torch, tmp, batch=4, steps=2):
    """Two SGD steps at full width, batch 4, dropout ratio 0, from one
    snapshot, on the card and on the CPU (the kernels' plain versions).

    Both TF32 settings are turned on first (cuDNN's is on by PyTorch's
    default), so the check fails unless the card's Solver turns them
    off itself. Losses must agree within 1e-4 relative. The weights are
    read by their change over the steps: for each blob, max |dw - dw_cpu|
    / max |dw_cpu| with dw = w - w_snapshot, worst blob, which must stay
    within WEIGHT_CHANGE_LIMIT. Controls from the same snapshot and
    batches: the CPU again on one thread (only the summation order
    changes: must read within the limit), and on the card the norm1 LRN
    backward zeroed, the conv2/norm2 fused backward zeroed, and TF32
    turned back on after the Solver is built (each must read above the
    limit: the check catches a dropped gradient and a lost precision
    setting)."""
    from sparknet_tpu_torch.ops import cuda_epilogue as ce
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.solver import Solver
    tf32 = (torch.backends.cudnn, torch.backends.cuda.matmul)
    for f in tf32:
        f.allow_tf32 = True
    prefix = os.path.join(tmp, "parity")
    sp = _googlenet_solver(batch, prefix, dropout=False)
    cpu = Solver(sp, device="cpu", log_fn=None)
    _, state = cpu.snapshot(prefix)
    w0 = {n: [p.detach().double().clone() for p in blobs]
          for n, blobs in cpu.params.items()}
    rs = np.random.RandomState(SEED + 1)
    batches = [_batch(rs, batch) for _ in range(steps)]
    cpu_losses = [float(cpu.train_step(b)) for b in batches]
    dw_cpu = {n: [p.detach().double() - w for p, w in zip(blobs, w0[n])]
              for n, blobs in cpu.params.items()}

    def run(label, device="cuda", tf32_after_build=False):
        solver = Solver(sp, device=device, log_fn=None)
        solver.restore(state)
        if tf32_after_build:
            for f in tf32:
                f.allow_tf32 = True
        losses = [float(solver.train_step(b)) for b in batches]
        for f in tf32:
            f.allow_tf32 = False
        worst, where = 0.0, None
        for name, dcs in dw_cpu.items():
            for i, dc in enumerate(dcs):
                dw = solver.params[name][i].detach().cpu().double() \
                    - w0[name][i]
                e = float((dw - dc).abs().max()
                          / dc.abs().max().clamp_min(1e-30))
                if e > worst:
                    worst, where = e, f"{name}[{i}]"
        print(f"[parity] {label}: weight change max |dw - dw_cpu| / max "
              f"|dw_cpu| = {worst:.3e} at {where} (limit "
              f"{WEIGHT_CHANGE_LIMIT:g})")
        return losses, worst, where

    losses, worst_w, where = run("card")
    worst_loss = 0.0
    for lg, lc in zip(losses, cpu_losses):
        err = abs(lg - lc) / abs(lc)
        worst_loss = max(worst_loss, err)
        print(f"[parity] loss card {lg:.7f} cpu {lc:.7f} (relative "
              f"{err:.3e}, limit 1e-4)")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reorder = run("control, CPU on one thread", device="cpu")[1]
    finally:
        torch.set_num_threads(threads)
    faults = {}
    lrn_bwd, brl_bwd = cl.lrn_across_bwd, ce.bias_relu_lrn_bwd
    try:
        cl.lrn_across_bwd = lambda x, g, *a: torch.zeros_like(g)
        faults["norm1 backward zeroed"] = run(
            "control, norm1 backward zeroed")[1]
        cl.lrn_across_bwd = lrn_bwd
        ce.bias_relu_lrn_bwd = lambda x, b, g, *a: (torch.zeros_like(g),
                                                    torch.zeros_like(b))
        faults["norm2 backward zeroed"] = run(
            "control, conv2/norm2 backward zeroed")[1]
    finally:
        cl.lrn_across_bwd, ce.bias_relu_lrn_bwd = lrn_bwd, brl_bwd
    faults["TF32 on"] = run("control, TF32 on", tf32_after_build=True)[1]
    check(worst_loss <= 1e-4,
          f"card and CPU losses differ by {worst_loss:.3e}")
    check(worst_w <= WEIGHT_CHANGE_LIMIT,
          f"card and CPU weight changes differ by {worst_w:.3e} at {where}")
    check(reorder <= WEIGHT_CHANGE_LIMIT,
          f"the CPU on one thread reads {reorder:.3e}: the limit does not "
          "admit a change of summation order")
    for name, e in faults.items():
        check(e > WEIGHT_CHANGE_LIMIT,
              f"control '{name}' reads {e:.3e}, within the limit: the "
              "check would not catch it")
    return {"loss_rel": worst_loss, "weight_change_rel": worst_w,
            "reorder_control": reorder, "fault_controls": faults}


# -- phase 6 --------------------------------------------------------------

# The flash kernels' limits against their plain versions. f32: O within
# 2e-5 and dQ, dK, dV within 5e-4 of the largest reference element
# (tests/test_flash.py's limits). Every dtype: each output's worst
# 64-row tile (_tile_err) within its limit below, set between the sound
# readings and those of the planted faults (_planted: 1e-2 and 1e-1);
# see PERF.md. f32 1e-4 for every output (5.5e-7 at most). bf16 5e-3 for
# every output, since the tensor-core kernels round P (and, in the
# backward, dS) to bf16 before their second products, as the library's
# kernels do: the forward's O reads 2.8e-3 to 2.9e-3 on the card at every
# bf16 case here, the library's own O the same (all but a few in a
# million of its elements equal the kernel's), the CPU emulation of its
# rounding points 2.6e-3 to 2.7e-3; dQ, dK, dV read 2.6e-3 to 3.0e-3,
# their CPU emulation the same (tests/test_torch_flash_rounding.py).
# LSE and delta within ROW_LIMIT of their largest reference element
# (they read 1.4e-7 at most).
FLASH_TILE_LIMIT = {"float32": 1e-4, "bfloat16": 5e-3}        # O
FLASH_BWD_TILE_LIMIT = {"float32": 1e-4, "bfloat16": 5e-3}    # dQ, dK, dV
ROW_LIMIT = 2e-5


def _rel_err(got, ref):
    """max |got - ref| over max |ref|, both read as f32."""
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def _tile_err(torch, got, ref, rows=64):
    """The worst tile's ||got - ref|| / ||ref||, over tiles of ``rows``
    rows along S in each (b, h), the ragged last one included. The
    kernels give each CTA one 64-row tile, and a tile is held to its own
    size: causal O, dQ, dK and dV shrink along the sequence, so an error
    taken of the largest element (row 0's) lets most of the rows be
    wrong by as much as they are large."""
    b, h, s, d = ref.shape
    pad = (-s) % rows

    def tiles(t):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, pad)).reshape(
            b * h, -1, rows * d)
    r = tiles(ref)
    return float(((tiles(got) - r).norm(dim=-1)
                  / r.norm(dim=-1).clamp_min(1e-30)).max())


def _planted(torch, t):
    """Two wrong kernels planted on a kernel's output ``t`` (B, H, S, D),
    in f32: the last 64-row tile of the last (b, h) 1% off, and every
    row past S/8 10% off."""
    s = t.shape[2]
    last, late = (t.to(torch.float32, copy=True) for _ in range(2))
    last[-1, -1, -64:] *= 1.01
    late[:, :, s // 8:] *= 1.1
    return {"last tile 1% off": last, "rows past S/8 10% off": late}


def _flash_kernel_info(torch):
    """{(name, dtype, head_dim): what the runtime says of that flash
    kernel instantiation}: registers a thread, local memory a thread
    (spills), dynamic shared memory, resident CTAs per SM. Fails if a
    tensor-core (bf16) kernel uses local memory, or a bf16 backward kernel
    fits fewer than two CTAs on an SM at head_dim 128."""
    import ctypes
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.ops import cuda_build
    fwd = cuda_build.function("flash_fwd", "sparknet_flash_forward_info",
                              [ctypes.c_int] * 2 + [ctypes.c_void_p])
    bwd = cuda_build.function("flash_bwd", "sparknet_flash_backward_info",
                              [ctypes.c_int] * 3 + [ctypes.c_void_p])
    queries = {"flash_attention": fwd,
               "flash_attention_dq": lambda *a: bwd(0, *a),
               "flash_attention_dkv": lambda *a: bwd(1, *a)}
    info = {}
    for name, query in queries.items():
        for dtype, code in cuda_build.DTYPE_CODES.items():
            dname = str(dtype).replace("torch.", "")
            for d in ca.HEAD_DIMS:
                out = (ctypes.c_int * 4)()
                err = query(code, d, ctypes.cast(out, ctypes.c_void_p))
                check(err == 0, f"the info query of {name} ({code}, {d}) "
                                f"returned cudaError {err}")
                r = info[name, dname, d] = dict(
                    registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                    ctas_per_sm=out[3])
                print(f"[flash] {name} {dname} D={d}: {out[0]} registers, "
                      f"{out[1]} bytes local (spills), {out[2]} bytes "
                      f"shared, {out[3]} CTAs per SM")
                if dtype == torch.bfloat16:
                    check(r["local_bytes"] == 0,
                          f"{name} bf16 D={d} uses local memory: {r}")
                    check(name == "flash_attention" or d != 128
                          or r["ctas_per_sm"] >= 2,
                          f"{name} bf16 D=128 fits {r['ctas_per_sm']} CTA "
                          "per SM, want 2")
    return info


def phase_flash_kernels(torch):
    """The forward, dQ and dK/dV kernels against their plain versions on
    the same inputs (the backward kernels take the kernel forward's O and
    LSE, dK/dV the dQ kernel's delta), the planted faults, the library's
    own backward read at the same measure against the same references,
    times, achieved TFLOP/s, bounds and the library call; and each flash
    kernel's registers, spills, shared memory and CTAs per SM."""
    import torch.nn.functional as F
    from sparknet_tpu_torch.ops import cuda_attention as ca
    info = _flash_kernel_info(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timer = Timer(torch)
    results = []
    for shape, dtype, causal, row in (
            ((2, 4, 1024, 64), torch.float32, False, False),
            ((2, 4, 1024, 64), torch.float32, True, False),
            ((2, 4, 1024, 128), torch.bfloat16, False, False),
            ((2, 4, 1024, 64), torch.bfloat16, True, False),
            # head_dim 96 is not built: zero-padded to 128
            ((2, 4, 1024, 96), torch.bfloat16, True, False),
            ((4, 8, 4096, 128), torch.bfloat16, True, True)):
        q, k, v, do = ((0.5 * torch.randn(shape, generator=gen,
                                          device="cuda")).to(dtype)
                       for _ in range(4))
        b, h, s, d = shape
        f32 = dtype == torch.float32
        dname = str(dtype).replace("torch.", "")
        what = f"{list(shape)} {dname} causal={causal}"
        peak = F32_OPS_PER_S if f32 else BF16_TENSOR_OPS_PER_S
        tile_tols = {"O": FLASH_TILE_LIMIT[dname],
                     **{g: FLASH_BWD_TILE_LIMIT[dname]
                        for g in ("dQ", "dK", "dV")}}
        pairs = b * h * s * s * (0.5 if causal else 1.0)
        item = q.element_size() * q.numel()        # one (B, H, S, D) tensor
        rows = 4 * b * h * s                        # one f32 (B*H, S)
        readings = {}
        with torch.enable_grad():
            ql, kl, vl = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl,
                                                 is_causal=causal)

        def lib_bwd():
            with torch.enable_grad():
                return torch.autograd.grad(out, (ql, kl, vl), do,
                                           retain_graph=True)
        with torch.no_grad():
            o, lse = ca.flash_attention_fwd(q, k, v, causal)
            dq, delta = ca.flash_attention_dq(q, k, v, o, lse, do, causal)
            dk, dv = ca.flash_attention_dkv(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            ro, rlse = ca.flash_attention_fwd_plain(q, k, v, causal)
            rdq, rdelta = ca.flash_attention_dq_plain(q, k, v, o, lse, do,
                                                      causal)
            rdk, rdv = ca.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                    causal)
            lib = dict(zip(("dQ", "dK", "dV"), lib_bwd()), O=out.detach())
            outputs = {"flash_attention": (("O", o, ro),),
                       "flash_attention_dq": (("dQ", dq, rdq),),
                       "flash_attention_dkv": (("dK", dk, rdk),
                                               ("dV", dv, rdv))}
            for name, outs in outputs.items():
                el_tol = None if not f32 else \
                    2e-5 if name == "flash_attention" else 5e-4
                rd = readings[name] = {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                       "tile_err": 0.0, "planted": {}}
                for label, got, ref in outs:
                    tile_tol = tile_tols[label]
                    check(bool(torch.isfinite(got).all()),
                          f"flash: non-finite {label} at {what}")
                    rel, tile = _rel_err(got, ref), _tile_err(torch, got, ref)
                    rd["max_abs_err"] = max(rd["max_abs_err"], float(
                        (got.float() - ref.float()).abs().max()))
                    rd["max_rel_err"] = max(rd["max_rel_err"], rel)
                    rd["tile_err"] = max(rd["tile_err"], tile)
                    lib_note = ""
                    if label in lib:
                        lt = _tile_err(torch, lib[label], ref)
                        rd["library_tile_err"] = max(
                            rd.get("library_tile_err", 0.0), lt)
                        lib_note = "; the library's " + (
                            f"forward (SDPA) {lt:.3e}" if label == "O" else
                            f"backward (autograd through SDPA) {lt:.3e}")
                        if label == "O":
                            same = float((got == lib[label]).float().mean())
                            rd["library_same_share"] = same
                            lib_note += (f", {same:.1%} of its elements "
                                         "equal to the kernel's")
                    print(f"[flash] {label} {what}: worst 64-row tile "
                          f"{tile:.3e} (limit {tile_tol:g}){lib_note}, of "
                          f"the largest element {rel:.3e}"
                          + (f" (limit {el_tol:g})" if el_tol else ""))
                    for fault, bad in _planted(torch, got).items():
                        ptile, prel = (_tile_err(torch, bad, ref),
                                       _rel_err(bad, ref))
                        rd["planted"][f"{label} {fault}"] = {
                            "tile_err": ptile, "max_rel_err": prel}
                        print(f"[flash]   planted, {label} {fault}: worst "
                              f"tile {ptile:.3e}, of the largest element "
                              f"{prel:.3e}")
                        check(ptile > tile_tol,
                              f"planted fault '{label} {fault}' at {what} "
                              f"reads {ptile:.3e}, within the limit "
                              f"{tile_tol:g}: the check would not catch it")
                    check(tile <= tile_tol,
                          f"{label} at {what} disagrees with the plain "
                          f"version: worst tile {tile:.3e} > {tile_tol:g}")
                    if el_tol is not None:
                        check(rel <= el_tol,
                              f"{label} at {what} disagrees with the plain "
                              f"version: {rel:.3e} of the largest element "
                              f"> {el_tol:g}")
            for label, got, ref in (("LSE", lse, rlse),
                                    ("delta", delta, rdelta)):
                rel = _rel_err(got, ref)
                print(f"[flash] {label} {what}: of the largest element "
                      f"{rel:.3e} (limit {ROW_LIMIT:g})")
                check(rel <= ROW_LIMIT, f"{label} at {what} disagrees with "
                      f"the plain version: {rel:.3e} > {ROW_LIMIT:g}")
            readings["flash_attention"]["lse_rel_err"] = _rel_err(lse, rlse)
            readings["flash_attention_dq"]["delta_rel_err"] = _rel_err(
                delta, rdelta)
            del ro, rlse, rdq, rdelta, rdk, rdv, outputs, lib
            lib_bwd_ms = timer(lib_bwd)
            cases = (
                ("flash_attention", lambda: ca.flash_attention_fwd(
                    q, k, v, causal),
                 lambda: ca.flash_attention_fwd_plain(q, k, v, causal),
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        is_causal=causal),
                 3 * item + item + rows, 4 * pairs * d),
                ("flash_attention_dq", lambda: ca.flash_attention_dq(
                    q, k, v, o, lse, do, causal),
                 lambda: ca.flash_attention_dq_plain(q, k, v, o, lse, do,
                                                     causal),
                 None, 5 * item + rows + item + rows, 6 * pairs * d),
                ("flash_attention_dkv", lambda: ca.flash_attention_dkv(
                    q, k, v, do, lse, delta, causal),
                 lambda: ca.flash_attention_dkv_plain(q, k, v, do, lse,
                                                      delta, causal),
                 None, 4 * item + 2 * rows + 2 * item, 8 * pairs * d))
            for name, kernel, plain, library, nbytes, flops in cases:
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / peak * 1e3
                r = dict(
                    name=name, shape=list(shape), dtype=dname, causal=causal,
                    **readings[name],
                    limit="worst 64-row tile "
                    f"{tile_tols['O' if name == 'flash_attention' else 'dQ']:g}"
                    + (f"; {2e-5 if name == 'flash_attention' else 5e-4:g}"
                       " of the largest element" if f32 else ""),
                    ms=timer(kernel), plain_ms=timer(plain),
                    library_ms=timer(library) if library else lib_bwd_ms,
                    library="F.scaled_dot_product_attention" if library
                    else "torch.autograd.grad of F.scaled_dot_product_"
                         "attention (dq, dk, dv together)",
                    bytes=nbytes, flops=flops,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    row=row, **info.get((name, dname, d), {}))
                r["tflops"] = flops / r["ms"] / 1e9
                print(f"[flash] {name} {what}: kernel {r['ms']:.4f} ms "
                      f"({r['tflops']:.1f} TFLOP/s), plain "
                      f"{r['plain_ms']:.4f} ms, library "
                      f"{r['library_ms']:.4f} ms ({r['library']}), bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
                      f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
                results.append(r)
        del q, k, v, do, o, lse, dq, delta, dk, dv, out, ql, kl, vl
        torch.cuda.empty_cache()
    return results


# -- phase 7 --------------------------------------------------------------

LM_FULL = dict(vocab=8192, seq_len=4096, batch=4, d_model=1024, layers=12,
               heads=8)
FLASH_KERNELS = ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv")


def _lm_cli(args, timeout=600, tag="lm-cli"):
    """``python -m sparknet_tpu_torch lm`` at full width, bf16, in a child
    process that ends (or is killed at ``timeout``) before this
    returns; -> (stdout, its launch counts)."""
    f = LM_FULL
    cmd = [sys.executable, "-m", "sparknet_tpu_torch", "lm",
           "--vocab", str(f["vocab"]), "--seq-len", str(f["seq_len"]),
           "--batch", str(f["batch"]), "--d-model", str(f["d_model"]),
           "--layers", str(f["layers"]), "--heads", str(f["heads"]),
           "--dtype", "bf16", "--display", "1", *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
    for line in out.stdout.strip().splitlines():
        print(f"[{tag}] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    print(f"[{tag}] exited 0 in {time.perf_counter() - t0:.1f} s")
    last = out.stdout.strip().splitlines()[-1]
    check(last.startswith("Kernel launches: "),
          f"the lm verb's last line is not its launch counts: {last}")
    return out.stdout, json.loads(last[len("Kernel launches: "):])


def _losses(out):
    return {int(l.split()[1].rstrip(",")): float(
        l.split("loss = ")[1].split(",")[0])
        for l in out.splitlines() if l.startswith("Iteration ")}


def phase_lm_cli(tmp):
    """The lm verb at full width: 3 steps with a snapshot at 3, then
    --resume from it to 5. Each flash kernel must launch exactly
    ``layers`` times per step in each run, the resumed run must start
    at iteration 3, and the loss must fall from about ln(vocab)."""
    prefix = os.path.join(tmp, "lm")
    layers = LM_FULL["layers"]
    out1, counts1 = _lm_cli(["--steps", "3", "--snapshot-every", "3",
                             "--snapshot-prefix", prefix])
    check(os.path.exists(f"{prefix}_iter_3.solverstate"),
          "no lm snapshot at iteration 3")
    out2, counts2 = _lm_cli(["--steps", "5", "--resume",
                             f"{prefix}_iter_3.solverstate"])
    for out, counts, steps in ((out1, counts1, 3), (out2, counts2, 2)):
        check(f"done: {steps} steps, " in out, f"lm verb: not {steps} steps")
        for name in FLASH_KERNELS:
            check(counts[name] == layers * steps,
                  f"lm verb: {name} launched {counts[name]} times in "
                  f"{steps} steps of a {layers}-layer net, want "
                  f"{layers * steps}")
    first, second = _losses(out1), _losses(out2)
    check(sorted(first) == [0, 1, 2] and sorted(second) == [3, 4],
          f"iterations {sorted(first)} then {sorted(second)}: the resumed "
          "run did not continue from 3")
    ln_v = float(np.log(LM_FULL["vocab"]))
    check(abs(first[0] - ln_v) < 1.5,
          f"first loss {first[0]:.4f} is not about ln(vocab) = {ln_v:.4f}")
    check(second[4] < first[0], f"loss did not fall: {first[0]:.4f} at "
                                f"iteration 0, {second[4]:.4f} at 4")
    rates = [float(l.split("steps, ")[1].split(" tokens/s")[0]
                   .replace(",", ""))
             for l in (out1 + out2).splitlines() if l.startswith("done: ")]
    return {"losses": {**first, **second}, "launches": counts1,
            "launches_resumed": counts2, "tokens_per_s_wall": rates}


def _lm_group(name):
    if "flash_" in name:
        return "port attention kernels (flash_*)"
    if any(s in name for s in ("gemm", "cutlass", "nvjet", "cublas",
                               "sm90_xmma")):
        return "cuBLAS GEMMs"
    return "other"


def phase_lm_step(torch, card, steps=3):
    """In process at full width: launches per step, the train step time
    (median of 5, CUDA events, device-resident batch), tokens/s and a
    profiler window."""
    from sparknet_tpu_torch.data import lm_batch_stream
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    from sparknet_tpu_torch.proto import Message
    from sparknet_tpu_torch.solver import Solver
    f = LM_FULL
    sp = Message("SolverParameter", base_lr=3e-4, lr_policy="fixed",
                 type="Adam", random_seed=SEED, display=0)
    net = zoo.transformer_lm(vocab_size=f["vocab"], seq_len=f["seq_len"],
                             batch_size=f["batch"], d_model=f["d_model"],
                             num_layers=f["layers"], num_heads=f["heads"])
    solver = Solver(sp, net_param=net, device="cuda", log_fn=None,
                    compute_dtype=torch.bfloat16)
    n_params = sum(p.numel() for v in solver.params.values() for p in v)
    stream, _ = lm_batch_stream(f["vocab"], f["batch"], f["seq_len"],
                                seed=SEED)
    feed = {k: torch.as_tensor(v).cuda() for k, v in next(stream).items()}
    float(solver.train_step(feed))              # warm-up: cuBLAS plans
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    losses = [float(solver.train_step(feed)) for _ in range(steps)]
    launches = kernel_launches()
    print(f"[lm] in process, {steps} steps on one batch: losses "
          f"{[round(l, 4) for l in losses]}, launches {launches}")
    for name in FLASH_KERNELS:
        check(launches[name] == f["layers"] * steps,
              f"{name}: {launches[name]} launches in {steps} steps, want "
              f"{f['layers'] * steps}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = Timer(torch, reps=5, flush=False)(
        lambda: solver.train_step(feed))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tps = f["batch"] * f["seq_len"] / (step_ms / 1e3)
    print(f"[lm] transformer LM {n_params / 1e6:.1f}M params, b{f['batch']} "
          f"S{f['seq_len']} bf16 train step {step_ms:.3f} ms (median of 5, "
          f"CUDA events), {tps:,.0f} tokens/s, peak memory {peak_gb:.1f} GB; "
          f"{card}")
    profile = _profile(torch, lambda: solver.train_step(feed), 2, _lm_group,
                       "full-width LM train step", card, top=12)
    del solver, feed
    torch.cuda.empty_cache()
    return {"params": n_params, "launches": launches, "losses": losses,
            "step_ms": step_ms, "tokens_per_s": tps, "peak_gb": peak_gb,
            "profile": profile}


def _weight_change_error(params, w0, dw_ref):
    """Worst blob's max |dw - dw_ref| / max |dw_ref| with dw = w - w0,
    and the blob. The attention's key bias is left out: it adds q.b_k to
    every score of a row, which the softmax cancels, so its gradient is
    zero up to rounding, and Adam scales that noise up to steps of about
    lr whatever computes it."""
    worst, where = 0.0, None
    for name, refs in dw_ref.items():
        for i, dr in enumerate(refs):
            dw = params[name][i].detach().cpu().double() - w0[name][i]
            if name.endswith("/attn") and i == 1:
                keep = dr.new_ones(dr.shape[0]).bool()
                keep[dr.shape[0] // 3:2 * dr.shape[0] // 3] = False
                dw, dr = dw[keep], dr[keep]
            e = float((dw - dr).abs().max() / dr.abs().max().clamp_min(1e-30))
            if e > worst:
                worst, where = e, f"{name}[{i}]"
    return worst, where


# Between the sound readings (card 1.2e-4, the CPU on one thread 5.3e-5)
# and the controls (dQ zeroed 1.85, dK/dV zeroed 1.99); see PERF.md.
LM_WEIGHT_CHANGE_LIMIT = 1e-2
# Between the sound readings of the first step's gradients (card 9.7e-7,
# the CPU on one thread 6.1e-8) and the controls' (dQ zeroed 0.51, dK/dV
# zeroed 1.03); see PERF.md.
LM_GRAD_LIMIT = 1e-4


def _grad_error(params, g_ref):
    """Worst blob's max |g - g_ref| / max |g_ref| over the params'
    gradients, and the blob."""
    worst, where = 0.0, None
    for name, refs in g_ref.items():
        for i, gr in enumerate(refs):
            g = params[name][i].grad.detach().cpu().double()
            e = float((g - gr).abs().max() / gr.abs().max().clamp_min(1e-30))
            if e > worst:
                worst, where = e, f"{name}[{i}]"
    return worst, where


def phase_lm_card_vs_cpu(torch, tmp, steps=2):
    """A small LM (vocab 512, 2 layers, d 256, 4 heads, S 256, batch 2,
    f32, TF32 off) from one snapshot on the card (the flash kernels) and
    on the CPU (their plain versions), read two ways:

    - the first step's gradients under the lm verb's own Solver (Adam,
      Caffe's delta 1e-8): each blob's within LM_GRAD_LIMIT of the CPU's
      largest in that blob;
    - two Adam steps with delta 1e-6: losses within 1e-5 relative and
      each blob's weight change within LM_WEIGHT_CHANGE_LIMIT of the
      CPU's largest change in that blob.

    Controls from the same snapshot and batches, read both ways: the CPU
    on one thread (must pass), and on the card the dQ kernel's output
    zeroed and the dK/dV kernel's output zeroed (each must fail).

    The weight changes take delta 1e-6, not 1e-8: Adam divides each
    gradient by its own RMS, so an element whose gradient lies within
    rounding of zero takes a step of about lr in a sign set by rounding,
    and with delta 1e-8 one such element in 80,000 decides the reading
    (a card run read 1.13 at tok_embed while every gradient agreed with
    the CPU's within 1.1e-6 of its blob's largest). With 1e-6, gradients
    below ~3e-5 take steps in proportion to their size; a dropped
    gradient still reads about 1. The gradients themselves come before
    any update and read the main path's setting as it is."""
    from sparknet_tpu_torch.data import lm_batch_stream
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.proto import Message
    from sparknet_tpu_torch.solver import Solver
    sp_verb = Message("SolverParameter", base_lr=1e-3, lr_policy="fixed",
                      type="Adam", random_seed=SEED, display=0)
    sp = sp_verb.copy()
    sp.delta = 1e-6
    net = zoo.transformer_lm(vocab_size=512, seq_len=256, batch_size=2,
                             d_model=256, num_layers=2, num_heads=4)
    cpu = Solver(sp, net_param=net, device="cpu", log_fn=None)
    _, state = cpu.snapshot(os.path.join(tmp, "lm_parity"))
    w0 = {n: [p.detach().double().clone() for p in blobs]
          for n, blobs in cpu.params.items()}
    stream, _ = lm_batch_stream(512, 2, 256, seed=SEED + 1)
    batches = [next(stream) for _ in range(steps)]
    first = Solver(sp_verb, net_param=net, device="cpu", log_fn=None)
    first.restore(state)
    first.train_step(batches[0])
    g_cpu = {n: [p.grad.detach().double() for p in blobs]
             for n, blobs in first.params.items()}
    cpu_losses = [float(cpu.train_step(b)) for b in batches]
    dw_cpu = {n: [p.detach().double() - w for p, w in zip(blobs, w0[n])]
              for n, blobs in cpu.params.items()}

    def run(label, device="cuda"):
        solver = Solver(sp_verb, net_param=net, device=device, log_fn=None)
        solver.restore(state)
        solver.train_step(batches[0])
        g_err, g_where = _grad_error(solver.params, g_cpu)
        solver = Solver(sp, net_param=net, device=device, log_fn=None)
        solver.restore(state)
        losses = [float(solver.train_step(b)) for b in batches]
        worst, where = _weight_change_error(solver.params, w0, dw_cpu)
        print(f"[lm-parity] {label}: first-step gradients max |g - g_cpu| "
              f"/ max |g_cpu| = {g_err:.3e} at {g_where} (limit "
              f"{LM_GRAD_LIMIT:g}); weight change max |dw - dw_cpu| / max "
              f"|dw_cpu| = {worst:.3e} at {where} (limit "
              f"{LM_WEIGHT_CHANGE_LIMIT:g})")
        return {"losses": losses, "grad_rel": g_err, "grad_where": g_where,
                "weight_change_rel": worst, "where": where}

    for f in (torch.backends.cudnn, torch.backends.cuda.matmul):
        f.allow_tf32 = True           # the Solver must turn them off
    card = run("card")
    worst_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(card["losses"], cpu_losses))
    for a, b in zip(card["losses"], cpu_losses):
        print(f"[lm-parity] loss card {a:.7f} cpu {b:.7f} (relative "
              f"{abs(a - b) / abs(b):.3e}, limit 1e-5)")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reorder = run("control, CPU on one thread", device="cpu")
    finally:
        torch.set_num_threads(threads)
    faults = {}
    dq_fn, dkv_fn = ca.flash_attention_dq, ca.flash_attention_dkv

    def dq_zeroed(*a):
        dq, delta = dq_fn(*a)
        return torch.zeros_like(dq), delta

    def dkv_zeroed(*a):
        return tuple(torch.zeros_like(t) for t in dkv_fn(*a))
    # the wrappers count through their module-level names
    dq_zeroed.launches = dkv_zeroed.launches = 0
    try:
        ca.flash_attention_dq = dq_zeroed
        faults["dQ kernel output zeroed"] = run("control, dQ zeroed")
        ca.flash_attention_dq = dq_fn
        ca.flash_attention_dkv = dkv_zeroed
        faults["dK/dV kernel output zeroed"] = run("control, dK/dV zeroed")
    finally:
        ca.flash_attention_dq, ca.flash_attention_dkv = dq_fn, dkv_fn
    check(worst_loss <= 1e-5, f"card and CPU LM losses differ by "
                              f"{worst_loss:.3e}")
    for key, limit in (("grad_rel", LM_GRAD_LIMIT),
                       ("weight_change_rel", LM_WEIGHT_CHANGE_LIMIT)):
        check(card[key] <= limit,
              f"card and CPU LM {key} {card[key]:.3e} > {limit:g}")
        check(reorder[key] <= limit,
              f"the CPU on one thread reads {key} {reorder[key]:.3e}: the "
              "limit does not admit a change of summation order")
        for name, r in faults.items():
            check(r[key] > limit,
                  f"control '{name}' reads {key} {r[key]:.3e}, within the "
                  "limit: the check would not catch it")
    return {"loss_rel": worst_loss, **{k: card[k] for k in (
        "grad_rel", "grad_where", "weight_change_rel", "where")},
        "reorder_control": {k: reorder[k] for k in (
            "grad_rel", "weight_change_rel")},
        "fault_controls": {n: {k: r[k] for k in (
            "grad_rel", "weight_change_rel")} for n, r in faults.items()}}


# -- phase 8 --------------------------------------------------------------

# Local SGD card against CPU: each blob's change over the round within
# LOCAL_SGD_LIMIT of the CPU's largest change in that blob, between the
# sound readings and the control's (the slot average replaced by slot
# 0's params); see PERF.md. The tau = 1 identity (local SGD against one
# data-parallel step) reads against the same limit.
LOCAL_SGD_LIMIT = 1e-2
K40_CAFFENET_IMAGES_PER_S = 267.0   # BASELINE.md:8, cuDNN, CaffeNet b256
CAFFENET_LRN_SHAPES = ((256, 96, 27, 27), (256, 256, 13, 13))
CAFFENET_DP_LRN_SHAPES = ((64, 96, 27, 27), (64, 256, 13, 13))  # b256 / 4


def _cifar_cli(args, timeout=600):
    """``python -m sparknet_tpu_torch cifar`` (or ``make_synth_cifar``)
    in a child process that ends (or is killed at ``timeout``) before
    this returns; -> its stdout."""
    cmd = [sys.executable, "-m", "sparknet_tpu_torch", *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
    for line in out.stdout.strip().splitlines():
        print(f"[cifar-cli] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    print(f"[cifar-cli] exited 0 in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def _round_losses(out):
    return [float(line.split(": loss = ")[1]) for line in out.splitlines()
            if ": loss = " in line]


def phase_cifar_cli(tmp):
    """The cifar verb on the card, at CifarApp's own settings
    (cifar10_full, per-worker batch 100, tau 10, the zoo solver) over 4
    worker slots, on 10,000 + 1,000 records from make_synth_cifar: 6
    rounds with a test every 3 and a snapshot every 3, then --resume
    auto for 2 more (the counter continues from 60), then --strategy dp
    for 2 steps."""
    data = os.path.join(tmp, "cifar_data")
    prefix = os.path.join(tmp, "cifar")
    _cifar_cli(["make_synth_cifar", data, "--train", "10000", "--test",
                "1000"])
    common = ["cifar", "--data", data, "--workers", "4"]
    out = _cifar_cli(common + ["--tau", "10", "--rounds", "6",
                               "--test-every", "3", "--snapshot-prefix",
                               prefix, "--snapshot-every", "3"])
    check("strategy=local_sgd, device=cuda" in out,
          "the cifar verb did not train on the card")
    losses = _round_losses(out)
    check(len(losses) == 6 and all(np.isfinite(losses)),
          f"round losses {losses}")
    check(losses[-1] < losses[0], f"the round loss did not fall: {losses}")
    accuracy = [float(line.split("test accuracy = ")[1])
                for line in out.splitlines() if "test accuracy = " in line]
    check(len(accuracy) == 2, f"test accuracies {accuracy}, want 2")
    check("done: 6 rounds, iter=60" in out, "the cifar verb did not reach "
                                            "iter 60")
    for it in (30, 60):
        check(os.path.exists(f"{prefix}_iter_{it}.solverstate"),
              f"no cifar snapshot at iteration {it}")
    out2 = _cifar_cli(common + ["--tau", "10", "--rounds", "2",
                                "--test-every", "5", "--snapshot-prefix",
                                prefix, "--resume", "auto"])
    check("resume auto: restored iter 60" in out2,
          "--resume auto did not pick up the iteration-60 snapshot")
    check("done: 2 rounds, iter=80" in out2,
          "the resumed run did not continue from iteration 60 to 80")
    resumed = _round_losses(out2)
    check(len(resumed) == 2 and all(np.isfinite(resumed)),
          f"resumed round losses {resumed}")
    out3 = _cifar_cli(common + ["--strategy", "dp", "--rounds", "2",
                                "--test-every", "5"])
    check("strategy=dp, device=cuda" in out3 and
          "done: 2 rounds, iter=2" in out3, "--strategy dp did not take 2 "
                                            "steps on the card")
    dp = _round_losses(out3)
    check(len(dp) == 2 and all(np.isfinite(dp)), f"dp losses {dp}")
    return {"round_losses": losses, "test_accuracy": accuracy,
            "resumed_losses": resumed, "dp_losses": dp}


def _time_rounds(torch, fn, reps=3):
    """Median of ``reps`` calls of ``fn`` over CUDA events after one
    warm-up call (ms)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def _caffenet_group(name):
    if "channel_walk" in name:
        return "port kernels (channel_walk)"
    if any(s in name for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                               "implicit", "winograd", "fft", "bprop")):
        return "cuDNN"
    if any(s in name for s in ("gemm", "cublas", "cutlass", "nvjet")):
        return "cuBLAS"
    return "other"


def _synthetic_rounds(torch, tau, workers, batch, shape, classes, seed):
    """A round's batches made on the card: N(0, 1) images and uniform
    labels, (tau, workers*batch, ...)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = workers * batch
    return {"data": torch.randn((tau, n) + tuple(shape), generator=gen,
                                device="cuda"),
            "label": torch.randint(0, classes, (tau, n), generator=gen,
                                   device="cuda", dtype=torch.int32)}


def phase_local_sgd(torch, card, tau=10, workers=4):
    """Rounds in process on the card: cifar10_full at CifarApp's
    settings (4 slots x batch 100, tau 10), then CaffeNet at the ImageNet
    app's widths (zoo.caffenet(batch_size=256), its solver, 4 slots,
    tau cut from the app's 50 to 10), f32 with TF32 off, on synthetic
    batches made on the card. Each: the round by CUDA events (median of
    3 after one warm-up) and images/s. CaffeNet also: the LRN kernels'
    launches in those 4 rounds (each of norm1 and norm2 forward and
    backward once a step), the averaging step alone (median of 5), the
    peak memory, and a profiler window over one round (time by group,
    busy share)."""
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    from sparknet_tpu_torch.parallel import LocalSGDSolver
    from sparknet_tpu_torch.proto import Message
    out = {}
    sp = Message("SolverParameter", base_lr=0.001, momentum=0.9,
                 weight_decay=0.004, lr_policy="fixed", display=0,
                 random_seed=SEED)
    solver = LocalSGDSolver(sp, workers=workers, tau=tau,
                            net_param=zoo.cifar10_full(batch_size=100),
                            device="cuda", log_fn=None)
    batches = _synthetic_rounds(torch, tau, workers, 100, (3, 32, 32), 10,
                                SEED)
    ms, all_ms = _time_rounds(torch, lambda: solver.train_round(batches))
    ips = tau * workers * 100 / (ms / 1e3)
    print(f"[local-sgd] cifar10_full {workers} slots x b100, tau {tau}: "
          f"round {ms:.2f} ms (median of 3 over CUDA events, {all_ms}), "
          f"{ips:,.0f} images/s; {card}")
    out["cifar10_full"] = {"round_ms": ms, "rounds_ms": all_ms,
                           "images_per_s": ips}
    del solver, batches
    torch.cuda.empty_cache()

    sp = Message("SolverParameter", base_lr=0.01, momentum=0.9,
                 weight_decay=0.0005, lr_policy="step", gamma=0.1,
                 stepsize=100000, display=0, random_seed=SEED)
    solver = LocalSGDSolver(sp, workers=workers, tau=tau,
                            net_param=zoo.caffenet(batch_size=256),
                            device="cuda", log_fn=None)
    n_params = sum(p.numel() for v in solver.params.values() for p in v)
    batches = _synthetic_rounds(torch, tau, workers, 256, (3, 227, 227),
                                1000, SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    losses = []
    ms, all_ms = _time_rounds(
        torch, lambda: losses.append(solver.train_round(batches)))
    launches = kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    ips = tau * workers * 256 / (ms / 1e3)
    print(f"[local-sgd] CaffeNet {n_params / 1e6:.1f}M params, {workers} "
          f"slots x b256, tau {tau}, f32 (TF32 off): round {ms:.1f} ms "
          f"(median of 3 over CUDA events, {all_ms}), {ips:,.0f} images/s "
          f"(K40 + cuDNN, the reference's own GPU: "
          f"{K40_CAFFENET_IMAGES_PER_S:g} images/s on one worker); round "
          f"losses {[round(l, 4) for l in losses]}; peak memory "
          f"{peak_gb:.1f} GB; {card}")
    print(f"[local-sgd] CaffeNet launches in 4 rounds: {launches}")
    check(all(np.isfinite(losses)), f"CaffeNet round losses {losses}")
    per_run = 2 * tau * workers * 4     # norm1 + norm2, every step
    for name in ("lrn_across", "lrn_across_bwd"):
        check(launches[name] == per_run,
              f"{name}: {launches[name]} launches in 4 CaffeNet rounds, "
              f"want {per_run} (norm1 and norm2 each step)")
    avg_ms, _ = _time_rounds(torch, solver.average_slots, reps=5)
    avg_bytes = 2 * (workers + 1) * 4 * n_params
    print(f"[local-sgd] the slot average alone: {avg_ms:.3f} ms (median of "
          f"5), {avg_bytes / 1e9:.2f} GB moved ({avg_bytes / 1e9 / avg_ms:.2f}"
          f" TB/s), {100 * avg_ms / ms:.3f}% of the round")
    profile = _profile(torch, lambda: solver.train_round(batches), 1,
                       _caffenet_group, "CaffeNet local-SGD round", card,
                       top=12)
    out["caffenet"] = {"params": n_params, "round_ms": ms,
                       "rounds_ms": all_ms, "images_per_s": ips,
                       "losses": losses, "launches": launches,
                       "peak_gb": peak_gb, "average_ms": avg_ms,
                       "profile": profile}
    del solver, batches
    torch.cuda.empty_cache()
    return out


def _cifar_local(workers, tau, momentum, base_lr, device, batch=8):
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.parallel import LocalSGDSolver
    return LocalSGDSolver(_cifar_sp(momentum, base_lr), workers=workers,
                          tau=tau, net_param=zoo.cifar10_full(
                              batch_size=batch),
                          device=device, log_fn=None)


def _cifar_sp(momentum, base_lr):
    from sparknet_tpu_torch.proto import Message
    return Message("SolverParameter", base_lr=base_lr, lr_policy="step",
                   gamma=0.5, stepsize=2, momentum=momentum,
                   weight_decay=0.004, random_seed=SEED, display=0)


def _change_error(params, w0, dw_ref):
    """Worst blob's max |dw - dw_ref| / max |dw_ref| with dw = w - w0."""
    worst, where = 0.0, None
    for name, refs in dw_ref.items():
        for i, ref in enumerate(refs):
            dw = params[name][i].detach().cpu().double() - w0[name][i]
            e = float((dw - ref).abs().max()
                      / ref.abs().max().clamp_min(1e-30))
            if e > worst:
                worst, where = e, f"{name}[{i}]"
    return worst, where


def _params64(params):
    return {n: [p.detach().cpu().double().clone() for p in blobs]
            for n, blobs in params.items()}


def phase_local_sgd_card_vs_cpu(torch, tmp, device="cuda"):
    """One local-SGD round of cifar10_full (per-worker batch 8, 2 slots,
    tau 3, momentum 0.9, lr stepping inside the round) on the card and on
    the CPU from one snapshot and the same batches: the round losses
    within 1e-4 relative and each blob's change within LOCAL_SGD_LIMIT.
    Control: the card's round with the slot average replaced by slot 0's
    params must read above it. Then, on the card, tau 1 and no momentum
    (lr 1, a step far above the weights' rounding): the round must equal
    one DataParallelSolver step on the global batch within the same
    limit."""
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.parallel import DataParallelSolver
    from sparknet_tpu_torch.parallel import data_parallel as dpm
    cpu = _cifar_local(2, 3, 0.9, 0.02, "cpu")
    _, state = cpu.snapshot(os.path.join(tmp, "local_sgd_parity"))
    w0 = _params64(cpu.params)
    rs = np.random.RandomState(SEED + 2)
    batches = {"data": rs.randn(3, 16, 3, 32, 32).astype(np.float32),
               "label": rs.randint(0, 10, (3, 16)).astype(np.int32)}
    cpu_loss = float(cpu.train_round(batches))
    dw_cpu = {n: [p - w for p, w in zip(ps, w0[n])]
              for n, ps in _params64(cpu.params).items()}

    def run(label):
        solver = _cifar_local(2, 3, 0.9, 0.02, device)
        solver.restore(state)
        loss = float(solver.train_round(batches))
        worst, where = _change_error(solver.params, w0, dw_cpu)
        print(f"[local-sgd-parity] {label}: round loss {loss:.7f} (cpu "
              f"{cpu_loss:.7f}); weight change max |dw - dw_cpu| / max "
              f"|dw_cpu| = {worst:.3e} at {where} (limit "
              f"{LOCAL_SGD_LIMIT:g})")
        return loss, worst

    loss, worst = run("card")
    mean = dpm.slot_mean
    try:
        dpm.slot_mean = lambda stacked: stacked[0].clone()
        _, control = run("control, slot 0 in place of the average")
    finally:
        dpm.slot_mean = mean
    loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)

    ls = _cifar_local(4, 1, 0.0, 1.0, device)
    dp = DataParallelSolver(_cifar_sp(0.0, 1.0), workers=4,
                            net_param=zoo.cifar10_full(batch_size=32),
                            device=device, log_fn=None)
    with torch.no_grad():
        for n, ps in dp.params.items():
            for p, q in zip(ps, ls.params[n]):
                p.copy_(q)
    v0 = _params64(dp.params)
    rs = np.random.RandomState(SEED + 3)
    one = {"data": rs.randn(1, 32, 3, 32, 32).astype(np.float32),
           "label": rs.randint(0, 10, (1, 32)).astype(np.int32)}
    ls.train_round(one)
    dp.train_step({k: v[0] for k, v in one.items()})
    dv = {n: [p - w for p, w in zip(ps, v0[n])]
          for n, ps in _params64(dp.params).items()}
    identity, where = _change_error(ls.params, v0, dv)
    print(f"[local-sgd-parity] tau 1, no momentum: local SGD against one "
          f"data-parallel step, max |dw - dw_dp| / max |dw_dp| = "
          f"{identity:.3e} at {where} (limit {LOCAL_SGD_LIMIT:g})")
    check(loss_rel <= 1e-4, f"card and CPU round losses differ by "
                            f"{loss_rel:.3e}")
    check(worst <= LOCAL_SGD_LIMIT,
          f"card and CPU local-SGD rounds differ by {worst:.3e}")
    check(control > LOCAL_SGD_LIMIT,
          f"control 'slot 0 in place of the average' reads {control:.3e}, "
          "within the limit: the check would not catch it")
    check(identity <= LOCAL_SGD_LIMIT,
          f"tau-1 local SGD and one data-parallel step differ by "
          f"{identity:.3e}")
    return {"loss_rel": loss_rel, "weight_change_rel": worst,
            "control_slot0": control, "tau1_identity_rel": identity}


def phase_local_sgd_all(torch, card, tmp):
    t0 = time.perf_counter()
    cli_out = phase_cifar_cli(tmp)
    rounds = phase_local_sgd(torch, card)
    parity = phase_local_sgd_card_vs_cpu(torch, tmp)
    wall = time.perf_counter() - t0
    print(f"[local-sgd] phase 8 wall time {wall:.1f} s")
    return {"cli": cli_out, "rounds": rounds, "card_vs_cpu": parity,
            "wall_s": wall}

# -- phase 9 --------------------------------------------------------------

RECORD_SHAPE = (3, 256, 256)          # ImageNet app's SOURCE_SIZE
CAFFENET_BATCH, CAFFENET_CROP = 256, 227
DB_TRAIN, DB_TEST = 2560, 512
DB_ITERS, DB_TEST_ITER, DB_TEST_INTERVAL = 30, 2, 20
IMAGENET_TAU, IMAGENET_ROUNDS = 2, 2


def _caffenet_db_files(tmp):
    """The records of phase 9 and a stock-form CaffeNet train_val over
    them: DB_TRAIN + DB_TEST 3x256x256 uint8 Datums of 1,000-class
    class-gaussian images (the ImageNet app's synthetic images, one
    seed) in two LMDBs, their mean image, zoo.caffenet's body under two
    Data layers (TRAIN: 227 random crops, mirror, mean_file; TEST: center
    crops) and bvlc_reference_caffenet's solver values. -> (solver path,
    seconds to write)."""
    from sparknet_tpu_torch import tools
    from sparknet_tpu_torch.data.datum import array_to_datum
    from sparknet_tpu_torch.data.lmdb import LMDBWriter
    from sparknet_tpu_torch.data.synthetic import class_gaussian_images
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.proto import Message, text_format
    t0 = time.perf_counter()
    images, labels = class_gaussian_images(
        DB_TRAIN + DB_TEST, shape=RECORD_SHAPE, num_classes=1000, seed=SEED)
    images = np.clip(images * 32 + 128, 0, 255).astype(np.uint8)
    t_gen = time.perf_counter() - t0
    for name, lo, hi in (("train_lmdb", 0, DB_TRAIN),
                         ("test_lmdb", DB_TRAIN, DB_TRAIN + DB_TEST)):
        with LMDBWriter(os.path.join(tmp, name)) as w:
            for i in range(lo, hi):
                w.put(b"%08d" % (i - lo),
                      array_to_datum(images[i], int(labels[i])))
    del images
    t_write = time.perf_counter() - t0 - t_gen
    tools.compute_image_mean(os.path.join(tmp, "train_lmdb"),
                             os.path.join(tmp, "mean.binaryproto"),
                             log=lambda *a: None)
    net = Message("NetParameter", name="CaffeNet")
    for phase, src, mirror in (("TRAIN", "train_lmdb", True),
                               ("TEST", "test_lmdb", False)):
        lp = Message("LayerParameter", name="data", type="Data",
                     data_param=dict(source=src, batch_size=CAFFENET_BATCH,
                                     backend="LMDB"),
                     transform_param=dict(crop_size=CAFFENET_CROP,
                                          mirror=mirror,
                                          mean_file="mean.binaryproto"))
        lp.top.append("data")
        lp.top.append("label")
        lp.add("include", phase=phase)
        net.layer.append(lp)
    for lp in zoo.caffenet(batch_size=CAFFENET_BATCH, with_data=False).layer:
        net.layer.append(lp)
    text_format.dump(net, os.path.join(tmp, "train_val.prototxt"))
    sp = Message("SolverParameter", net="train_val.prototxt", base_lr=0.01,
                 lr_policy="step", gamma=0.1, stepsize=100000, momentum=0.9,
                 weight_decay=0.0005, display=10, max_iter=DB_ITERS,
                 test_iter=[DB_TEST_ITER], test_interval=DB_TEST_INTERVAL,
                 test_initialization=False, random_seed=SEED)
    path = os.path.join(tmp, "solver.prototxt")
    text_format.dump(sp, path)
    mb = sum(os.path.getsize(os.path.join(tmp, d, "data.mdb"))
             for d in ("train_lmdb", "test_lmdb")) / 1e6
    dt = time.perf_counter() - t0
    print(f"[records] {DB_TRAIN} + {DB_TEST} Datums of {RECORD_SHAPE} uint8 "
          f"({mb:.0f} MB of LMDB): images {t_gen:.1f} s, LMDBWriter "
          f"{t_write:.1f} s, all with the mean {dt:.1f} s")
    return path, dt


def _launches_line(out, tag):
    last = out.strip().splitlines()[-1]
    check(last.startswith("Kernel launches: "),
          f"[{tag}] the verb's last line is not its launch counts: {last}")
    return json.loads(last[len("Kernel launches: "):])


def phase_db_cli(tmp, solver_path, device="cuda"):
    """The train verb on the records: DB_ITERS iterations of CaffeNet
    b256 streamed from the LMDB through the device transform (the device
    cache off: phase 10 runs the verb's cached default), one test pass at
    DB_TEST_INTERVAL. The loss must be finite and each LRN kernel launch
    twice per iteration (norm1, norm2), the forward also twice per test
    batch."""
    cmd = [sys.executable, "-m", "sparknet_tpu_torch", "train", "--solver",
           solver_path, "--device", device]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               SPARKNET_DEVICE_CACHE_MB="0"))
    for line in out.stdout.strip().splitlines():
        print(f"[db-cli] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    print(f"[db-cli] exited 0 in {wall:.1f} s")
    stdout = out.stdout
    check(f"({DB_TRAIN} records, device-transform)" in stdout,
          "the train verb did not train from the LMDB records")
    check("synthetic" not in stdout, "the train verb fed synthetic batches")
    losses = [float(l.split("loss = ")[1].split(",")[0])
              for l in stdout.splitlines() if "Iteration " in l]
    check(len(losses) == DB_ITERS // 10 and all(np.isfinite(losses)),
          f"train verb losses {losses}")
    tests = [l for l in stdout.splitlines() if "Test net output" in l]
    check(len(tests) == 2, f"want one test pass (accuracy, loss): {tests}")
    launches = _launches_line(stdout, "db-cli")
    # 2 a training iteration, the forward also 2 a test batch; none on
    # the CPU, where the plain versions run
    on_card = device == "cuda"
    want = (on_card * (2 * DB_ITERS + 2 * DB_TEST_ITER),
            on_card * 2 * DB_ITERS)
    check((launches["lrn_across"], launches["lrn_across_bwd"]) == want,
          f"train verb LRN launches {launches}: want {want} (forward, "
          "backward)")
    return {"losses": losses, "tests": tests, "launches": launches,
            "wall_s": wall}


def _host_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_transform_check(torch, card, tmp):
    """The device transform on the card against the host transform at
    CaffeNet's shapes (b256 of 3x256x256 uint8 records, 227 crops,
    mirror, the full mean file) with the same draws from one seeded
    RandomState: equal bit for bit. Control: #x shifted by one column
    must differ. Then the device transform's time per batch (CUDA
    events, L2 flushed) against its bound (uint8 in, f32 out over 3.35
    TB/s), the host transform's and the copy of each batch to the card
    from pinned memory."""
    from sparknet_tpu_torch.data.device_transform import \
        build_device_transformer
    from sparknet_tpu_torch.data.transforms import DataTransformer
    from sparknet_tpu_torch.proto import Message
    tp = Message("TransformationParameter", crop_size=CAFFENET_CROP,
                 mirror=True,
                 mean_file=os.path.join(tmp, "mean.binaryproto"))
    rs = np.random.RandomState(SEED)
    images = rs.randint(0, 256, (CAFFENET_BATCH,) + RECORD_SHAPE) \
        .astype(np.uint8)
    host = DataTransformer(tp, phase=0, rng=np.random.RandomState(SEED + 1))
    dev = build_device_transformer(tp, phase=0,
                                   rng=np.random.RandomState(SEED + 1))
    want = host(images)
    aux = dev.aux(CAFFENET_BATCH, RECORD_SHAPE)
    fn = dev.device_fn()
    x = torch.from_numpy(images).cuda()
    auxd = {k: torch.from_numpy(v).cuda() for k, v in aux.items()}
    got = fn({"data": x, **auxd})["data"]
    torch.cuda.synchronize()
    err = float(np.abs(got.cpu().numpy() - want).max())
    shifted = dict(auxd)
    shifted[dev.kx] = (auxd[dev.kx] + 1).clamp_max(256 - CAFFENET_CROP)
    control = float(np.abs(fn({"data": x, **shifted})["data"].cpu().numpy()
                           - want).max())
    timer = Timer(torch)
    ms = timer(lambda: fn({"data": x, **auxd}))
    nbytes = x.numel() + want.size * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    host_ms = _host_ms(lambda: host(images))
    pinned = torch.from_numpy(images).pin_memory()
    pinned_f32 = torch.from_numpy(want).pin_memory()
    h2d_ms = Timer(torch, reps=10, flush=False)(
        lambda: pinned.to("cuda", non_blocking=True))
    h2d_f32_ms = Timer(torch, reps=10, flush=False)(
        lambda: pinned_f32.to("cuda", non_blocking=True))
    print(f"[transform] device against host at CaffeNet's b256 "
          f"(3x256x256 uint8 -> 227 crops, mirror, full mean): max abs "
          f"difference {err:g} (want 0); control, #x shifted one column: "
          f"{control:g} (want > 0)")
    print(f"[transform] device transform {ms:.4f} ms a batch (median of 30,"
          f" L2 flushed; bound {bound_ms:.4f} ms: {nbytes / 1e6:.1f} MB over"
          f" 3.35 TB/s, {100 * bound_ms / ms:.1f}% of it); host transform "
          f"{host_ms:.1f} ms (numpy, median of 5); copy to the card from "
          f"pinned memory: uint8 batch {images.nbytes / 1e6:.1f} MB "
          f"{h2d_ms:.3f} ms, f32 crops {want.nbytes / 1e6:.1f} MB "
          f"{h2d_f32_ms:.3f} ms; {card}")
    check(err == 0.0, f"device transform differs from the host's by {err}")
    check(control > 0.0, "control: shifted crops read equal, the check "
                         "would not catch a wrong offset")
    return {"max_abs_err": err, "control": control, "ms": ms,
            "bound_ms": bound_ms, "host_ms": host_ms, "h2d_u8_ms": h2d_ms,
            "h2d_f32_ms": h2d_f32_ms}


def _step_events(torch, solver, batches, steps):
    """Per-step times (ms) from CUDA events recorded between consecutive
    train steps with no synchronization: the card's clock, which counts
    its idle time waiting for the host between steps."""
    events = []
    for _ in range(steps + 1):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if len(events) <= steps:
            solver.train_step(next(batches))
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def phase_record_steps(torch, card, tmp, solver_path, steps=12):
    """CaffeNet b256 train steps in process from the records, through the
    train verb's own feed (the source, a PrefetchIterator whose worker
    runs the H2DStager), in both modes: the device transform and the
    host transform; and on one batch made on the card (phase 8's input),
    with the same Solver. Each: the median step over CUDA events between
    steps, images/s, the LRN launches and a profiler window's busy
    share. Also the host reader's time per batch."""
    from sparknet_tpu_torch.data.db_source import build_db_feed
    from sparknet_tpu_torch.data.prefetch import H2DStager, PrefetchIterator
    from sparknet_tpu_torch.graph.compiler import TRAIN
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    from sparknet_tpu_torch.proto import text_format
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.solver.solver import resolve_nets
    sp = text_format.load(solver_path, "SolverParameter")
    train_np, _ = resolve_nets(sp, tmp)
    shapes, probe = build_db_feed(train_np, TRAIN, tmp, seed=SEED,
                                  device_transform=True)
    it = iter(probe)
    reader_ms = _host_ms(lambda: next(it))
    probe.close()
    solver = Solver(sp, base_dir=tmp, feed_shapes=shapes, device="cuda",
                    log_fn=None)
    out = {"reader_ms": reader_ms}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    on_card = {"data": torch.randn((CAFFENET_BATCH, 3, CAFFENET_CROP,
                                    CAFFENET_CROP), generator=gen,
                                   device="cuda"),
               "label": torch.randint(0, 1000, (CAFFENET_BATCH,),
                                      generator=gen, device="cuda",
                                      dtype=torch.int32)}
    for mode in ("device-transform", "host-transform", "on-card batch"):
        src = data = None
        if mode == "on-card batch":
            solver.set_input_transform(None)
            data = iter(lambda: on_card, None)
        else:
            _, src = build_db_feed(train_np, TRAIN, tmp, seed=SEED,
                                   device_transform=mode.startswith("dev"))
            if src.device_mode:
                solver.set_input_transform(src.device_fn,
                                           src.raw_feed_overrides)
            else:
                solver.set_input_transform(None)
            data = PrefetchIterator(iter(src), depth=3,
                                    transform=H2DStager(slots=2),
                                    name="train_feed")
        try:
            for _ in range(3):                          # warm-up
                solver.train_step(next(data))
            torch.cuda.synchronize()
            for fn in KERNEL_WRAPPERS:
                fn.launches = 0
            times = _step_events(torch, solver, data, steps)
            launches = kernel_launches()
            ms = statistics.median(times)
            prof = _profile(torch, lambda: solver.train_step(next(data)), 4,
                            _caffenet_group, f"CaffeNet b256 step, {mode}",
                            card, top=6)
        finally:
            if src is not None:
                data.close()
                src.close()
        busy = "not measured" if prof is None \
            else f"{100 * prof['busy_share']:.1f}%"
        print(f"[db-steps] CaffeNet b256, {mode}: step {ms:.2f} ms (median "
              f"of {steps} over CUDA events between steps; "
              f"{[round(t, 2) for t in times]}), "
              f"{CAFFENET_BATCH / (ms / 1e3):,.0f} images/s, device busy "
              f"{busy}; LRN launches {launches['lrn_across']} forward, "
              f"{launches['lrn_across_bwd']} backward in {steps} steps; "
              f"{card}")
        check(launches["lrn_across"] == 2 * steps and
              launches["lrn_across_bwd"] == 2 * steps,
              f"{mode}: LRN launches {launches} in {steps} steps, want "
              f"{2 * steps} each")
        out[mode] = {"step_ms": ms, "steps_ms": times,
                     "images_per_s": CAFFENET_BATCH / (ms / 1e3),
                     "launches": launches, "profile": prof}
    print(f"[db-steps] host reader (LMDB -> uint8 batch + draws): "
          f"{reader_ms:.1f} ms a batch (median of 5); {card}")
    del solver
    torch.cuda.empty_cache()
    return out


def phase_imagenet_cli(workers=4, batch=256, classes=1000, device="cuda"):
    """The imagenet verb at the app's widths: 4 slots x b256, 1,000
    classes, CaffeNet, tau cut from 50 to IMAGENET_TAU (steps only),
    IMAGENET_ROUNDS rounds, a test at round 0. Round losses must be
    finite; each prints its images/s; the LRN kernels launch twice a
    step (and the forward twice a test batch)."""
    cmd = [sys.executable, "-m", "sparknet_tpu_torch", "imagenet",
           "--workers", str(workers), "--batch", str(batch), "--classes",
           str(classes), "--tau", str(IMAGENET_TAU), "--rounds",
           str(IMAGENET_ROUNDS), "--device", device]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    for line in out.stdout.strip().splitlines():
        print(f"[imagenet-cli] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    print(f"[imagenet-cli] exited 0 in {wall:.1f} s")
    rounds = [l for l in out.stdout.splitlines() if ": loss = " in l]
    losses = [float(l.split(": loss = ")[1].split(",")[0]) for l in rounds]
    rates = [float(l.rsplit(", ", 1)[1].split()[0]) for l in rounds]
    check(len(losses) == IMAGENET_ROUNDS and all(np.isfinite(losses)),
          f"imagenet round losses {losses}")
    check(f"device={device}" in out.stdout,
          f"the imagenet verb did not run on {device}")
    launches = _launches_line(out.stdout, "imagenet-cli")
    # 2 a step, the forward also 2 for each of the 4 test batches
    steps = IMAGENET_TAU * workers * IMAGENET_ROUNDS * (device == "cuda")
    want = (2 * steps + 8 * bool(steps), 2 * steps)
    check((launches["lrn_across"], launches["lrn_across_bwd"]) == want,
          f"imagenet LRN launches {launches}: want {want} (forward, "
          "backward)")
    return {"losses": losses, "images_per_s": rates, "launches": launches,
            "wall_s": wall}


def phase_records_all(torch, card, tmp):
    t0 = time.perf_counter()
    db = os.path.join(tmp, "records")
    os.makedirs(db, exist_ok=True)
    solver_path, write_s = _caffenet_db_files(db)
    transform = phase_transform_check(torch, card, db)
    cli_out = phase_db_cli(tmp, solver_path)
    steps = phase_record_steps(torch, card, db, solver_path)
    imagenet = phase_imagenet_cli()
    wall = time.perf_counter() - t0
    print(f"[records] phase 9 wall time {wall:.1f} s")
    return {"write_s": write_s, "transform": transform, "cli": cli_out,
            "steps": steps, "imagenet": imagenet, "wall_s": wall,
            "dir": db, "solver": solver_path}


# -- phase 10 -------------------------------------------------------------

FEED_ITERS = 10            # the train verb's iterations in phase 10
FEED_STEPS = 12            # timed steps of each feed in process
DP_SLOTS = 4
PACK_RECORDS = 256
CIFAR_TRAIN, CIFAR_TEST, CIFAR_BATCH = 10000, 1000, 100
FEATURE_LIMIT = 1e-4       # of the largest |fc7| of the reference forward


def _train_verb(solver_path, tag, extra=(), env=None):
    """``python -m sparknet_tpu_torch train`` for FEED_ITERS iterations in
    a child process that ends before this returns; -> (stdout, seconds).
    ``env`` adds to (None values remove from) this process's environment."""
    cmd = [sys.executable, "-m", "sparknet_tpu_torch", "train", "--solver",
           solver_path, "--iterations", str(FEED_ITERS), *extra]
    full_env = dict(os.environ)
    for k, v in (env or {}).items():
        if v is None:
            full_env.pop(k, None)
        else:
            full_env[k] = v
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=full_env)
    for line in out.stdout.strip().splitlines():
        print(f"[{tag}] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    print(f"[{tag}] exited 0 in {wall:.1f} s")
    return out.stdout, wall


def phase_feeds_cli(solver_path, card, device="cuda"):
    """The train verb on phase 9's CaffeNet records for FEED_ITERS
    iterations, three ways: default flags (the records go to the card
    once: `device-cached`), SPARKNET_DEVICE_CACHE_MB=0 (the streaming
    `device-transform` feed), and `--strategy dp --mesh data=4` (4 slots
    x 64, streaming, as the JAX verb's dp). Each loss must be finite and
    the LRN kernels (norm1, norm2) must launch twice a step and slot,
    forward and backward."""
    out = {}
    for name, extra, env, kind, slots in (
            ("cached", (), {"SPARKNET_DEVICE_CACHE_MB": None},
             "device-cached", 1),
            ("streaming", (), {"SPARKNET_DEVICE_CACHE_MB": "0"},
             "device-transform", 1),
            ("dp", ("--strategy", "dp", "--mesh", f"data={DP_SLOTS}"),
             {"SPARKNET_DEVICE_CACHE_MB": None}, "device-transform",
             DP_SLOTS)):
        stdout, wall = _train_verb(solver_path, f"feeds-cli {name}",
                                   (*extra, "--device", device), env)
        check(f"({DB_TRAIN} records, {kind})" in stdout,
              f"{name}: the train verb did not say {kind}")
        losses = [float(l.split("loss = ")[1].split(",")[0])
                  for l in stdout.splitlines() if "Iteration " in l]
        check(losses and all(np.isfinite(losses)),
              f"{name}: train verb losses {losses}")
        launches = _launches_line(stdout, f"feeds-cli {name}")
        # none on the CPU, where the plain versions run
        want = 2 * FEED_ITERS * slots * (device == "cuda")
        check(launches["lrn_across"] == want and
              launches["lrn_across_bwd"] == want,
              f"{name}: LRN launches {launches}, want {want} forward and "
              "backward")
        print(f"[feeds-cli] {name}: {kind}, losses {losses}, LRN launches "
              f"{launches['lrn_across']} / {launches['lrn_across_bwd']} in "
              f"{FEED_ITERS} iterations, {wall:.1f} s; {card}")
        out[name] = {"losses": losses, "launches": launches, "wall_s": wall}
    return out


class _Shipped:
    """Wraps a batch iterator and, while ``counting``, adds up the bytes
    each served batch copies to the card: its numpy arrays (copied when
    the step takes them) and its tensors that the previous batch did not
    hold (a staged copy; an echo reuses its base's)."""

    def __init__(self, torch, it):
        self.torch, self.it = torch, it
        self.bytes, self.counting, self._last = 0, False, {}

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        if self.counting:
            for k, v in b.items():
                if self.torch.is_tensor(v):
                    if v is not self._last.get(k):
                        self.bytes += v.numel() * v.element_size()
                else:
                    self.bytes += np.asarray(v).nbytes
        self._last = dict(b)
        return b

    def close(self):
        close = getattr(self.it, "close", None)
        return close() if close is not None else True


def _first_transformed(torch, src, device="cuda"):
    """The device transform of ``src``'s first batch, on ``device``."""
    from sparknet_tpu_torch.solver.solver import to_device
    out = src.device_fn(to_device(next(iter(src)), device))["data"]
    if device == "cuda":
        torch.cuda.synchronize()
    return out


def _feed_steps(torch, card, solver, feeds, label, batch, group,
                steps=FEED_STEPS):
    """Each of ``feeds`` ({name: (fn() -> data iterator, transform,
    overrides)}), its iterator made when its turn comes, through
    ``solver``'s train step: 3 warm-up steps, then ``steps``
    timed by CUDA events between steps (median), images/s, the bytes
    copied to the card a step, the LRN launches, and a profiler window's
    busy share."""
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    out = {}
    for name, (make, fn, over) in feeds.items():
        solver.set_input_transform(fn, over)
        shipped = _Shipped(torch, make())
        try:
            for _ in range(3):
                solver.train_step(next(shipped))
            torch.cuda.synchronize()
            for w in KERNEL_WRAPPERS:
                w.launches = 0
            shipped.counting = True
            times = _step_events(torch, solver, shipped, steps)
            shipped.counting = False
            launches = kernel_launches()
            ms = statistics.median(times)
            prof = _profile(torch, lambda: solver.train_step(next(shipped)),
                            4, group, f"{label}, {name}", card, top=6)
        finally:
            shipped.close()
        busy = "not measured" if prof is None \
            else f"{100 * prof['busy_share']:.1f}%"
        per_step = shipped.bytes / steps
        print(f"[feeds] {label}, {name}: step {ms:.2f} ms (median of {steps}"
              f" over CUDA events between steps; "
              f"{[round(t, 2) for t in times]}), "
              f"{batch / (ms / 1e3):,.0f} images/s, device busy {busy}, "
              f"{per_step / 1e6:.4f} MB copied to the card a step; LRN "
              f"launches {launches['lrn_across']} / "
              f"{launches['lrn_across_bwd']}; {card}")
        out[name] = {"step_ms": ms, "steps_ms": times,
                     "images_per_s": batch / (ms / 1e3),
                     "h2d_bytes_per_step": per_step, "launches": launches,
                     "profile": prof}
    return out


def _with_wire(mode, build):
    """``build()`` with SPARKNET_WIRE set to ``mode`` (restored after)."""
    old = os.environ.get("SPARKNET_WIRE")
    os.environ["SPARKNET_WIRE"] = mode
    try:
        return build()
    finally:
        if old is None:
            os.environ.pop("SPARKNET_WIRE")
        else:
            os.environ["SPARKNET_WIRE"] = old


def phase_feed_steps(torch, card, db, solver_path):
    """CaffeNet b256 from phase 9's records in process, one Solver, five
    feeds: the records resident on the card (the cache), the streaming
    device transform, `--wire precrop` on it, `--echo 2` on it, and a
    batch made on the card; then the dp solver (4 slots x 64) on the
    streaming feed, staged and unstaged. Bit for bit first: the cached
    and streaming feeds' first transformed batches, and the precrop and
    raw feeds'. The cache also reports its resident MiB, its upload
    seconds and the peak memory. Returns the results and the Solver's weights path (for
    extract_features)."""
    from sparknet_tpu_torch.data.db_source import build_db_feed
    from sparknet_tpu_torch.data.device_cache import (DeviceCachedSource,
                                                      maybe_device_cache)
    from sparknet_tpu_torch.data.prefetch import (EchoIterator, H2DStager,
                                                  PrefetchIterator)
    from sparknet_tpu_torch.graph.compiler import TRAIN
    from sparknet_tpu_torch.parallel import DataParallelSolver
    from sparknet_tpu_torch.proto import text_format, wire
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.solver.solver import resolve_nets
    sp = text_format.load(solver_path, "SolverParameter")
    train_np, _ = resolve_nets(sp, db)

    def source(mode="raw"):
        return _with_wire(mode, lambda: build_db_feed(
            train_np, TRAIN, db, seed=SEED, device_transform=True))

    shapes, stream = source()
    first_stream = _first_transformed(torch, stream)
    it = iter(stream)
    reader_ms = _host_ms(lambda: next(it))
    raw_batch = next(it)
    stream.close()
    _, pre = source("precrop")
    first_pre = _first_transformed(torch, pre)
    encode_ms = _host_ms(lambda: pre.wire.encode(raw_batch))
    pre.close()
    print(f"[feeds] host work a CaffeNet b256 batch (median of 5): the "
          f"reader (LMDB -> uint8 batch + draws) {reader_ms:.1f} ms, the "
          f"precrop encode {encode_ms:.1f} ms; {card}")
    torch.cuda.reset_peak_memory_stats()
    _, inner = source()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cached = maybe_device_cache(inner, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    check(isinstance(cached, DeviceCachedSource),
          "the CaffeNet records were not promoted to the card")
    first_cached = _first_transformed(torch, cached)
    cache_eq = bool(torch.equal(first_cached, first_stream))
    pre_eq = bool(torch.equal(first_pre, first_stream))
    resident_mib = cached.nbytes / 2 ** 20
    print(f"[feeds] bit for bit on the card, CaffeNet b256 first batch "
          f"{tuple(first_stream.shape)}: cached == streaming {cache_eq}, "
          f"precrop == raw {pre_eq}; the cache: {resident_mib:.1f} MiB "
          f"resident ({cached.num_records} records), uploaded in "
          f"{upload_s:.2f} s (LMDB read included); {card}")
    check(cache_eq, "the cached feed's first batch differs from the "
                    "streaming feed's")
    check(pre_eq, "the precrop feed's first batch differs from the raw "
                  "feed's")
    del first_stream, first_pre, first_cached

    solver = Solver(sp, base_dir=db, feed_shapes=shapes, device="cuda",
                    log_fn=None)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    on_card = {"data": torch.randn((CAFFENET_BATCH, 3, CAFFENET_CROP,
                                    CAFFENET_CROP), generator=gen,
                                   device="cuda"),
               "label": torch.randint(0, 1000, (CAFFENET_BATCH,),
                                      generator=gen, device="cuda",
                                      dtype=torch.int32)}
    out = {"bit_equal": {"cached_streaming": cache_eq, "precrop_raw": pre_eq},
           "resident_mib": resident_mib, "upload_s": upload_s,
           "reader_ms": reader_ms, "precrop_encode_ms": encode_ms}

    def staged(src):
        return PrefetchIterator(iter(src), depth=3,
                                transform=H2DStager(slots=2),
                                name="train_feed")

    srcs = [cached]
    try:
        feeds = {"cached": (lambda: staged(cached), cached.device_fn,
                            cached.raw_feed_overrides)}
        out.update(_feed_steps(torch, card, solver, feeds, "CaffeNet b256",
                               CAFFENET_BATCH, _caffenet_group))
        out["cached"]["peak_memory_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        print(f"[feeds] the cached feed's peak memory "
              f"{out['cached']['peak_memory_gb']:.2f} GB "
              f"(torch.cuda.max_memory_allocated); {card}")
        cached.close()
        srcs = [source()[1], source("precrop")[1], source()[1]]
        plain, pre, echo_src = srcs
        feeds = {
            "streaming": (lambda: staged(plain), plain.device_fn,
                          plain.raw_feed_overrides),
            "precrop": (lambda: staged(pre), pre.device_fn,
                        pre.raw_feed_overrides),
            "echo 2": (lambda: EchoIterator(
                staged(echo_src), 2, fresh_aux=lambda b: echo_src.fresh_aux()),
                echo_src.device_fn, echo_src.raw_feed_overrides),
            "on-card batch": (lambda: iter(lambda: on_card, None), None,
                              None)}
        out.update(_feed_steps(torch, card, solver, feeds, "CaffeNet b256",
                               CAFFENET_BATCH, _caffenet_group))
    finally:
        for src in srcs:
            src.close()
    weights = os.path.join(db, "feeds.caffemodel")
    wire.dump(solver.net.params_to_netproto(solver.params, solver.state),
              weights)
    del solver, on_card
    torch.cuda.empty_cache()

    # the dp solver on the streaming feed, staged as the train verb feeds
    # it, and unstaged (each step's train_step copies the host batch) as
    # the control, in the order unstaged, staged, staged, unstaged so
    # that neither arm gains from the solver's warm-up
    dp = DataParallelSolver(sp, workers=DP_SLOTS, base_dir=db,
                            feed_shapes=shapes, device="cuda", log_fn=None)
    arms = ("unstaged", "staged", "staged", "unstaged")
    srcs = [source()[1] for _ in arms]
    tag = f"dp {DP_SLOTS} x {CAFFENET_BATCH // DP_SLOTS}, streaming"

    def dp_feed(arm, src):
        make = (lambda: staged(src)) if arm == "staged" else (
            lambda: PrefetchIterator(iter(src), depth=3, name="train_feed"))
        return make, src.device_fn, src.raw_feed_overrides

    try:
        res = _feed_steps(
            torch, card, dp, {f"{tag}, {arm} {i + 1}": dp_feed(arm, src)
                              for i, (arm, src) in enumerate(zip(arms, srcs))},
            "CaffeNet b256", CAFFENET_BATCH, _caffenet_group)
    finally:
        for src in srcs:
            src.close()
    want = 2 * DP_SLOTS * FEED_STEPS
    for name, r in res.items():
        check(r["launches"]["lrn_across"] == want and
              r["launches"]["lrn_across_bwd"] == want,
              f"{name}: LRN launches {r['launches']}, want {want} each")
    for arm in ("staged", "unstaged"):
        runs = [r for name, r in res.items() if name.split(", ")[-1]
                .startswith(arm + " ")]
        times = [t for r in runs for t in r["steps_ms"]]
        out["dp" if arm == "staged" else "dp_unstaged"] = {
            "step_ms": statistics.median(times), "steps_ms": times,
            "arm_step_ms": [r["step_ms"] for r in runs],
            "busy_share": [r["profile"] and r["profile"]["busy_share"]
                           for r in runs],
            "h2d_bytes_per_step": runs[0]["h2d_bytes_per_step"],
            "launches": runs[0]["launches"]}
    print(f"[feeds] dp {DP_SLOTS} slots, median of {2 * FEED_STEPS} steps: "
          f"staged {out['dp']['step_ms']:.2f} ms (arms "
          f"{[round(t, 2) for t in out['dp']['arm_step_ms']]}), unstaged "
          f"{out['dp_unstaged']['step_ms']:.2f} ms (arms "
          f"{[round(t, 2) for t in out['dp_unstaged']['arm_step_ms']]}), "
          f"against the single-slot cached step "
          f"{out['cached']['step_ms']:.2f} ms; {card}")
    for name in ("cached", "streaming", "precrop", "echo 2"):
        check(out[name]["launches"]["lrn_across"] == 2 * FEED_STEPS,
              f"{name}: LRN launches {out[name]['launches']}")
    del dp
    torch.cuda.empty_cache()
    return out, weights


def phase_pack(torch, card, tmp, mean_file, device="cuda"):
    """The bit-pack wire on the card: PACK_RECORDS records of 3x256x256
    with values in 0..3 (a 2-bit source) written by the port's writer;
    the pack and precrop+pack feeds' unpacked, transformed first batch
    against the raw wire's (CaffeNet's transform: 227 crops, mirror, the
    full mean), bit for bit; KB shipped an image."""
    from sparknet_tpu_torch.data.datum import array_to_datum
    from sparknet_tpu_torch.data.db_source import DatumBatchSource
    from sparknet_tpu_torch.data.lmdb import LMDBWriter
    from sparknet_tpu_torch.proto import Message
    path = os.path.join(tmp, "pack_lmdb")
    rs = np.random.RandomState(SEED)
    with LMDBWriter(path) as w:
        for i in range(PACK_RECORDS):
            w.put(b"%05d" % i, array_to_datum(
                rs.randint(0, 4, RECORD_SHAPE).astype(np.uint8), i % 1000))
    tp = Message("TransformationParameter", crop_size=CAFFENET_CROP,
                 mirror=True, mean_file=mean_file)

    def source(mode):
        return _with_wire(mode, lambda: DatumBatchSource(
            path, PACK_RECORDS, transform_param=tp, seed=SEED,
            device_transform=True))

    raw = source("raw")
    want = _first_transformed(torch, raw, device)
    raw.close()
    out = {}
    for mode in ("pack", "precrop+pack"):
        src = source(mode)
        got = _first_transformed(torch, src, device)
        src.close()
        eq = bool(torch.equal(got, want))
        kb, raw_kb = src.wire.kb_per_image, src.wire.raw_kb_per_image
        print(f"[pack] {mode} ({src.wire.bits} bits) at CaffeNet's b256: "
              f"{kb:.2f} KB shipped an image (raw {raw_kb:.0f}), unpacked "
              f"and transformed on the card == raw wire's: {eq}; {card}")
        check(eq, f"{mode}: the unpacked batch differs from the raw wire's")
        out[mode] = {"kb_per_image": kb, "bits": src.wire.bits,
                     "bit_equal": eq}
    return out


def _cifar_db_files(tmp, data):
    """cifar10_full from records: make_synth_cifar's CIFAR-10-format
    binaries (phase 8's, or made here; CIFAR_TRAIN + CIFAR_TEST, cut from
    CIFAR-10's 50,000 + 10,000), convert_cifar_data's LMDBs, their mean,
    and a stock-form cifar10_full_train_test (two Data layers, batch 100,
    mean_file) with cifar10_full_solver's values. -> solver path."""
    from sparknet_tpu_torch import tools
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.proto import Message, text_format
    quiet = lambda *a: None  # noqa: E731
    if not os.path.exists(os.path.join(data, "test_batch.bin")):
        tools.make_synth_cifar(data, n_train=CIFAR_TRAIN, n_test=CIFAR_TEST,
                               log=quiet)
    db = os.path.join(tmp, "cifar_records")
    os.makedirs(db, exist_ok=True)
    t0 = time.perf_counter()
    tools.convert_cifar_data(data, db, log=quiet)
    tools.compute_image_mean(os.path.join(db, "cifar10_train_lmdb"),
                             os.path.join(db, "mean.binaryproto"), log=quiet)
    print(f"[cifar-records] convert_cifar_data + compute_image_mean "
          f"{time.perf_counter() - t0:.1f} s")
    net = Message("NetParameter", name="CIFAR10_full")
    for phase, src in (("TRAIN", "cifar10_train_lmdb"),
                       ("TEST", "cifar10_test_lmdb")):
        lp = Message("LayerParameter", name="cifar", type="Data",
                     data_param=dict(source=src, batch_size=CIFAR_BATCH,
                                     backend="LMDB"),
                     transform_param=dict(mean_file="mean.binaryproto"))
        lp.top.append("data")
        lp.top.append("label")
        lp.add("include", phase=phase)
        net.layer.append(lp)
    for lp in zoo.cifar10_full(batch_size=CIFAR_BATCH,
                               with_data=False).layer:
        net.layer.append(lp)
    text_format.dump(net, os.path.join(db, "cifar10_full_train_test.prototxt"))
    sp = Message("SolverParameter", net="cifar10_full_train_test.prototxt",
                 base_lr=0.001, momentum=0.9, weight_decay=0.004,
                 lr_policy="fixed", display=0, max_iter=60000,
                 test_iter=[10], test_interval=1000, random_seed=SEED)
    path = os.path.join(db, "cifar10_full_solver.prototxt")
    text_format.dump(sp, path)
    return db, path


def phase_cifar_feeds(torch, card, tmp):
    """cifar10_full b100 from records, in process: the cached feed, the
    streaming feed and a batch made on the card, in one Solver (the
    small-net case, where the pure-Python reader can set the pace). No
    port kernel runs (its LRNs are WITHIN_CHANNEL)."""
    from sparknet_tpu_torch.data.db_source import build_db_feed
    from sparknet_tpu_torch.data.device_cache import (DeviceCachedSource,
                                                      maybe_device_cache)
    from sparknet_tpu_torch.data.prefetch import H2DStager, PrefetchIterator
    from sparknet_tpu_torch.graph.compiler import TRAIN
    from sparknet_tpu_torch.proto import text_format
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.solver.solver import resolve_nets
    db, solver_path = _cifar_db_files(tmp, os.path.join(tmp, "cifar_data"))
    sp = text_format.load(solver_path, "SolverParameter")
    train_np, _ = resolve_nets(sp, db)

    def source():
        return build_db_feed(train_np, TRAIN, db, seed=SEED,
                             device_transform=True)

    shapes, probe = source()
    it = iter(probe)
    reader_ms = _host_ms(lambda: next(it))
    probe.close()
    _, inner = source()
    t0 = time.perf_counter()
    cached = maybe_device_cache(inner, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    check(isinstance(cached, DeviceCachedSource),
          "the cifar10 records were not promoted to the card")
    solver = Solver(sp, base_dir=db, feed_shapes=shapes, device="cuda",
                    log_fn=None)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    on_card = {"data": torch.randn((CIFAR_BATCH, 3, 32, 32), generator=gen,
                                   device="cuda"),
               "label": torch.randint(0, 10, (CIFAR_BATCH,), generator=gen,
                                      device="cuda", dtype=torch.int32)}
    _, plain = source()

    def staged(src):
        return PrefetchIterator(iter(src), depth=3,
                                transform=H2DStager(slots=2),
                                name="train_feed")

    try:
        out = _feed_steps(torch, card, solver, {
            "cached": (lambda: staged(cached), cached.device_fn,
                       cached.raw_feed_overrides),
            "streaming": (lambda: staged(plain), plain.device_fn,
                          plain.raw_feed_overrides),
            "on-card batch": (lambda: iter(lambda: on_card, None), None,
                              None)},
            "cifar10_full b100", CIFAR_BATCH,
            lambda name: "other" if "channel_walk" not in name
            else "port kernels (channel_walk)")
    finally:
        cached.close()
        plain.close()
    print(f"[feeds] cifar10_full: {cached.num_records} records resident "
          f"({CIFAR_TRAIN * 3 * 32 * 32 / 2 ** 20:.1f} MiB), uploaded in "
          f"{upload_s:.2f} s; the host reader {reader_ms:.2f} ms a batch of "
          f"{CIFAR_BATCH} (median of 5); {card}")
    out.update(reader_ms=reader_ms, upload_s=upload_s)
    del solver, on_card
    torch.cuda.empty_cache()
    return out


def phase_extract_features(torch, card, db, weights, device="cuda"):
    """`python -m sparknet_tpu_torch extract_features` of CaffeNet's fc7
    for 2 batches of phase 9's TEST records on the card; the LMDB it
    writes read back (2 x 256 float Datums of 4,096), the first batch
    against a forward of the same net and weights on the card (the TEST
    data layer's host transform, seed 0, as the tool's), within
    FEATURE_LIMIT of the largest reference value."""
    from sparknet_tpu_torch.data.datum import datum_to_array
    from sparknet_tpu_torch.data.db_source import resolve_db_feed
    from sparknet_tpu_torch.data.lmdb import LMDBReader
    from sparknet_tpu_torch.graph.compiler import TEST, CompiledNet
    from sparknet_tpu_torch.proto import text_format, wire
    model = os.path.join(db, "train_val.prototxt")
    out_db = os.path.join(db, "fc7_lmdb")
    cmd = [sys.executable, "-m", "sparknet_tpu_torch", "extract_features",
           weights, model, "fc7", out_db, "2", "lmdb", "--device", device]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    for line in run.stdout.strip().splitlines():
        print(f"[extract] {line}")
    check(run.returncode == 0,
          f"{' '.join(cmd)} exited {run.returncode}: {run.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    with LMDBReader(out_db) as r:
        keys = list(r.keys())
        feats = np.stack([datum_to_array(r.get(k))[0] for k in keys])
    check(len(keys) == 2 * CAFFENET_BATCH and feats.shape[1:] ==
          (4096, 1, 1), f"extract_features wrote {len(keys)} Datums of "
          f"{feats.shape[1:]}")
    net_param = text_format.load(model, "NetParameter")
    shapes, src = resolve_db_feed(net_param, TEST, db, seed=0)
    try:
        net = CompiledNet(net_param, TEST, feed_shapes=shapes, device=device)
        params, state = net.init(torch.Generator().manual_seed(0))
        params, state = net.load_netproto(
            wire.load(weights, "NetParameter"), params, state)
        with torch.inference_mode():
            blobs, _ = net.apply(params, state, next(iter(src)),
                                 train=False)
        ref = blobs["fc7"].float().cpu().numpy()
    finally:
        src.close()
    got = feats[:CAFFENET_BATCH].reshape(ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    print(f"[extract] fc7 of {len(keys)} TEST records in {wall:.1f} s; first "
          f"batch against a forward on the card: max abs difference {err:g} "
          f"of max |fc7| {scale:g} (limit {FEATURE_LIMIT:g} of it); {card}")
    check(scale > 0, "fc7 is all zero: the comparison would say nothing")
    check(err <= FEATURE_LIMIT * scale,
          f"extract_features' fc7 differs from the forward by {err}")
    return {"datums": len(keys), "max_abs_err": err, "max_abs_fc7": scale,
            "wall_s": wall}


def phase_feeds_all(torch, card, tmp, db, solver_path):
    t0 = time.perf_counter()
    cli_out = phase_feeds_cli(solver_path, card)
    steps, weights = phase_feed_steps(torch, card, db, solver_path)
    pack = phase_pack(torch, card, tmp,
                      os.path.join(db, "mean.binaryproto"))
    cifar = phase_cifar_feeds(torch, card, tmp)
    extract = phase_extract_features(torch, card, db, weights)
    wall = time.perf_counter() - t0
    print(f"[feeds] phase 10 wall time {wall:.1f} s")
    return {"cli": cli_out, "caffenet": steps, "pack": pack,
            "cifar10_full": cifar, "extract_features": extract,
            "wall_s": wall}


# -- phase 11 -------------------------------------------------------------

MOE_EXPERTS = 8            # Switch Transformer's top-1 routing (arXiv:2101.03961)
MOE_AUX_WEIGHT = 0.01      # its load-balancing weight alpha
MOE_STEPS = 4
ZOO_CIFAR_TRAIN, ZOO_CIFAR_TEST = 3000, 200
BN_ITERS = 30
BN_MAF = 0.999             # BatchNorm's moving_average_fraction default
# the layer sweep, card against CPU in f32 with TF32 off: max |card - cpu|
# / max |cpu| of each top and each gradient
SWEEP_LIMIT = 1e-5          # elementwise maps, copies and selections
SWEEP_SUM_LIMIT = 1e-4      # sums of products and long reductions
# a token's top-2 router-logit margin over the card's and the CPU's
# logit difference for that token: above it, no token's expert can flip
ROUTING_FACTOR = 2.0


def _moe_group(name):
    if "flash_" in name:
        return "port attention kernels (flash_*)"
    if any(s in name for s in ("gemm", "cutlass", "nvjet", "cublas",
                               "xmma")):
        return "bf16 GEMMs" if "bf16" in name else \
            "f32 GEMMs (expert einsums, router)"
    if any(s in name for s in ("sort", "radix", "index", "scatter",
                               "gather", "searchsorted", "bincount")):
        return "MoE dispatch and combine (sort, index)"
    return "other"


def phase_moe_cli():
    """The lm verb at LM_FULL with a Switch-MoE FFN of MOE_EXPERTS
    experts (F 4096, capacity factor 1.25) in every block, bf16, for
    MOE_STEPS steps: finite losses, each flash kernel ``layers`` times a
    step."""
    layers = LM_FULL["layers"]
    out, counts = _lm_cli(["--steps", str(MOE_STEPS), "--moe-experts",
                           str(MOE_EXPERTS), "--moe-aux-weight",
                           str(MOE_AUX_WEIGHT)], tag="moe-cli")
    check(f"done: {MOE_STEPS} steps, " in out,
          f"moe lm verb: not {MOE_STEPS} steps")
    for name in FLASH_KERNELS:
        check(counts[name] == layers * MOE_STEPS,
              f"moe lm verb: {name} launched {counts[name]} times in "
              f"{MOE_STEPS} steps of a {layers}-layer net, want "
              f"{layers * MOE_STEPS}")
    losses = _losses(out)
    check(sorted(losses) == list(range(MOE_STEPS)) and
          all(np.isfinite(v) for v in losses.values()),
          f"moe lm verb losses {losses}")
    rate = [float(l.split("steps, ")[1].split(" tokens/s")[0]
                  .replace(",", ""))
            for l in out.splitlines() if l.startswith("done: ")]
    return {"losses": losses, "launches": counts, "tokens_per_s_wall": rate}


def phase_moe_step(torch, card, steps=3):
    """In process at LM_FULL with the MoE FFN: launches per step, the
    train step (median of 5, CUDA events), tokens/s, peak memory, a
    profiler window, and one layer's expert FFN alone (two f32 einsums
    with bias and ReLU, forward and backward) times ``layers`` against
    the step."""
    import math
    from sparknet_tpu_torch.data import lm_batch_stream
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    from sparknet_tpu_torch.proto import Message
    from sparknet_tpu_torch.solver import Solver
    f = LM_FULL
    sp = Message("SolverParameter", base_lr=3e-4, lr_policy="fixed",
                 type="Adam", random_seed=SEED, display=0)
    net = zoo.transformer_lm(vocab_size=f["vocab"], seq_len=f["seq_len"],
                             batch_size=f["batch"], d_model=f["d_model"],
                             num_layers=f["layers"], num_heads=f["heads"],
                             moe_experts=MOE_EXPERTS,
                             moe_aux_weight=MOE_AUX_WEIGHT)
    solver = Solver(sp, net_param=net, device="cuda", log_fn=None,
                    compute_dtype=torch.bfloat16)
    n_params = sum(p.numel() for v in solver.params.values() for p in v)
    stream, _ = lm_batch_stream(f["vocab"], f["batch"], f["seq_len"],
                                seed=SEED)
    feed = {k: torch.as_tensor(v).cuda() for k, v in next(stream).items()}
    float(solver.train_step(feed))              # warm-up: cuBLAS plans
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    losses = [float(solver.train_step(feed)) for _ in range(steps)]
    launches = kernel_launches()
    check(all(np.isfinite(losses)), f"moe lm losses {losses}")
    for name in FLASH_KERNELS:
        check(launches[name] == f["layers"] * steps,
              f"moe lm: {name}: {launches[name]} launches in {steps} "
              f"steps, want {f['layers'] * steps}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = Timer(torch, reps=5, flush=False)(
        lambda: solver.train_step(feed))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tps = f["batch"] * f["seq_len"] / (step_ms / 1e3)
    print(f"[moe] MoE LM {n_params / 1e6:.1f}M params ({MOE_EXPERTS} "
          f"experts, F {4 * f['d_model']}), b{f['batch']} S{f['seq_len']} "
          f"bf16 train step {step_ms:.3f} ms (median of 5, CUDA events), "
          f"{tps:,.0f} tokens/s, peak memory {peak_gb:.1f} GB; losses "
          f"{[round(l, 4) for l in losses]}; {card}")
    profile = _profile(torch, lambda: solver.train_step(feed), 2,
                       _moe_group, "MoE LM train step", card, top=14)
    del solver, feed
    torch.cuda.empty_cache()

    X, E, F = MOE_EXPERTS, f["d_model"], 4 * f["d_model"]
    C = math.ceil(f["batch"] * f["seq_len"] / X * 1.25)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xe = torch.randn(X, C, E, device="cuda", generator=gen)
    ws = [torch.randn(s, device="cuda", generator=gen) * 0.02
          for s in ((X, F, E), (X, F), (X, E, F), (X, E))]
    gy = torch.randn(X, C, E, device="cuda", generator=gen)

    def ffn():
        x, w1, b1, w2, b2 = (t.detach().requires_grad_(True)
                             for t in (xe, *ws))
        h = torch.relu(torch.einsum("xce,xfe->xcf", x, w1) + b1[:, None])
        y = torch.einsum("xcf,xef->xce", h, w2) + b2[:, None]
        torch.autograd.grad(y, (x, w1, b1, w2, b2), gy)
    expert_ms = Timer(torch, reps=5, flush=False)(ffn)
    flops = 3 * 2 * 2 * X * C * E * F
    share = f["layers"] * expert_ms / step_ms
    print(f"[moe] one layer's expert FFN ({X} x {C} x {E} -> {F}, f32, "
          f"TF32 off), forward and backward: {expert_ms:.3f} ms "
          f"({flops / expert_ms / 1e9:.1f} TFLOP/s); x{f['layers']} layers "
          f"= {100 * share:.1f}% of the step; {card}")
    del xe, ws, gy
    torch.cuda.empty_cache()
    return {"params": n_params, "launches": launches, "losses": losses,
            "step_ms": step_ms, "tokens_per_s": tps, "peak_gb": peak_gb,
            "profile": profile, "expert_ffn_ms": expert_ms,
            "expert_ffn_tflops": flops / expert_ms / 1e9,
            "expert_share": share}


def _routing_ratio(x_card, x_cpu, router):
    """Smallest over tokens of the top-2 margin of the CPU's router
    logits over max(|card logits - CPU logits| of that token, 1e-6):
    above 1 no token's expert can differ between the two."""
    r = router.detach().cpu().double().t()
    t = x_cpu.detach().cpu().double().reshape(-1, r.shape[0]) @ r
    c = x_card.detach().cpu().double().reshape(-1, r.shape[0]) @ r
    top2 = t.topk(2, dim=1).values
    shift = (c - t).abs().max(dim=1).values.clamp_min(1e-6)
    return float(((top2[:, 0] - top2[:, 1]) / shift).min())


def phase_moe_card_vs_cpu(torch, tmp, device="cuda"):
    """A small MoE LM (vocab 512, 2 layers, d 256, 4 heads, 4 experts,
    S 256, batch 2, f32, TF32 off) from one snapshot: one Adam step
    (delta 1e-6) on the card and on the CPU, its loss within 1e-5, its
    gradients within LM_GRAD_LIMIT and its weight changes within
    LM_WEIGHT_CHANGE_LIMIT. Every token's top-2 router margin must exceed
    ROUTING_FACTOR times its card-CPU logit difference (else its expert
    could flip: a near-tie, not a port defect). Control: the combine's
    gate weighting left out on the card (must fail)."""
    from sparknet_tpu_torch.data import lm_batch_stream
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.ops.moe import MoE
    from sparknet_tpu_torch.proto import Message
    from sparknet_tpu_torch.solver import Solver
    sp = Message("SolverParameter", base_lr=1e-3, lr_policy="fixed",
                 type="Adam", random_seed=SEED, display=0, delta=1e-6)
    net = zoo.transformer_lm(vocab_size=512, seq_len=256, batch_size=2,
                             d_model=256, num_layers=2, num_heads=4,
                             moe_experts=4)
    cpu = Solver(sp, net_param=net, device="cpu", log_fn=None)
    _, state = cpu.snapshot(os.path.join(tmp, "moe_parity"))
    w0 = {n: [p.detach().double().clone() for p in blobs]
          for n, blobs in cpu.params.items()}
    stream, _ = lm_batch_stream(512, 2, 256, seed=SEED + 2)
    batch = next(stream)
    with torch.no_grad():
        cpu_blobs, _ = cpu.net.apply(cpu.params, cpu.state, batch)
    cpu_loss = float(cpu.train_step(batch))
    g_cpu = {n: [p.grad.detach().double() for p in blobs]
             for n, blobs in cpu.params.items()}
    dw_cpu = {n: [p.detach().double() - w for p, w in zip(blobs, w0[n])]
              for n, blobs in cpu.params.items()}

    def run(label):
        solver = Solver(sp, net_param=net, device=device, log_fn=None)
        solver.restore(state)
        with torch.no_grad():
            blobs, _ = solver.net.apply(solver.params, solver.state, batch)
        ratio = min(_routing_ratio(blobs[f"block{i}/ln2"],
                                   cpu_blobs[f"block{i}/ln2"],
                                   solver.params[f"block{i}/moe"][0])
                    for i in range(2))
        loss = float(solver.train_step(batch))
        g_err, g_where = _grad_error(solver.params, g_cpu)
        w_err, w_where = _weight_change_error(solver.params, w0, dw_cpu)
        rel = abs(loss - cpu_loss) / abs(cpu_loss)
        print(f"[moe-parity] {label}: loss card {loss:.7f} cpu "
              f"{cpu_loss:.7f} ({rel:.3e}, limit 1e-5); gradients "
              f"{g_err:.3e} at {g_where} (limit {LM_GRAD_LIMIT:g}); weight "
              f"change {w_err:.3e} at {w_where} (limit "
              f"{LM_WEIGHT_CHANGE_LIMIT:g}); smallest routing margin over "
              f"the card-CPU logit difference {ratio:.1f} (limit "
              f"{ROUTING_FACTOR:g})")
        return {"loss_rel": rel, "grad_rel": g_err, "grad_where": g_where,
                "weight_change_rel": w_err, "where": w_where,
                "routing_ratio": ratio}

    card = run("card")
    route = MoE.route

    def ungated(self, xt, router):
        gates, idx, gate = route(self, xt, router)
        return gates, idx, torch.ones_like(gate)
    MoE.route = ungated
    try:
        control = run("control, combine without the gate")
    finally:
        MoE.route = route
    check(card["routing_ratio"] > ROUTING_FACTOR,
          f"a token's router margin is only {card['routing_ratio']:.2f} "
          "times its card-CPU logit difference: a near-tie whose expert "
          "may flip, not a port defect; this input cannot decide")
    check(card["loss_rel"] <= 1e-5,
          f"card and CPU MoE LM losses differ by {card['loss_rel']:.3e}")
    for key, limit in (("grad_rel", LM_GRAD_LIMIT),
                       ("weight_change_rel", LM_WEIGHT_CHANGE_LIMIT)):
        check(card[key] <= limit,
              f"card and CPU MoE LM {key} {card[key]:.3e} > {limit:g}")
    check(control["grad_rel"] > LM_GRAD_LIMIT,
          f"the ungated control reads gradients {control['grad_rel']:.3e}, "
          "within the limit: the check would not catch it")
    return {"card": card, "control": control}


def _bn_cifar_files(tmp):
    """make_synth_cifar (ZOO_CIFAR_TRAIN + ZOO_CIFAR_TEST, cut from
    CIFAR-10's 50,000 + 10,000), convert_cifar_data's LMDBs, their mean,
    and a stock-form train_val of zoo.cifar10_full_sigmoid_bn (two Data
    layers, batch 100, mean_file) with the rate and momentum of Caffe's
    cifar10_full_sigmoid_solver_bn (0.001, 0.9): a test pass at
    iteration 20 of BN_ITERS, a snapshot at BN_ITERS. -> (db, solver)."""
    from sparknet_tpu_torch import tools
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.proto import Message, text_format
    quiet = lambda *a: None  # noqa: E731
    data = os.path.join(tmp, "zoo_cifar_data")
    db = os.path.join(tmp, "zoo_cifar_records")
    os.makedirs(db, exist_ok=True)
    tools.make_synth_cifar(data, n_train=ZOO_CIFAR_TRAIN,
                           n_test=ZOO_CIFAR_TEST, log=quiet)
    tools.convert_cifar_data(data, db, log=quiet)
    tools.compute_image_mean(os.path.join(db, "cifar10_train_lmdb"),
                             os.path.join(db, "mean.binaryproto"), log=quiet)
    net = Message("NetParameter", name="CIFAR10_full_sigmoid_bn")
    for phase, src in (("TRAIN", "cifar10_train_lmdb"),
                       ("TEST", "cifar10_test_lmdb")):
        lp = Message("LayerParameter", name="cifar", type="Data",
                     data_param=dict(source=src, batch_size=CIFAR_BATCH,
                                     backend="LMDB"),
                     transform_param=dict(mean_file="mean.binaryproto"))
        lp.top.append("data")
        lp.top.append("label")
        lp.add("include", phase=phase)
        net.layer.append(lp)
    for lp in zoo.cifar10_full_sigmoid_bn(batch_size=CIFAR_BATCH,
                                          with_data=False).layer:
        net.layer.append(lp)
    text_format.dump(net, os.path.join(
        db, "cifar10_full_sigmoid_bn_train_test.prototxt"))
    sp = Message("SolverParameter",
                 net="cifar10_full_sigmoid_bn_train_test.prototxt",
                 base_lr=0.001, momentum=0.9, lr_policy="fixed", display=10,
                 max_iter=60000, test_iter=[ZOO_CIFAR_TEST // CIFAR_BATCH],
                 test_interval=20, test_initialization=False,
                 snapshot=BN_ITERS, snapshot_prefix="bn",
                 random_seed=SEED)
    path = os.path.join(db, "cifar10_full_sigmoid_bn_solver.prototxt")
    text_format.dump(sp, path)
    return db, path


def phase_bn_cifar(torch, card, tmp, device="cuda"):
    """The stock BN/Sigmoid CIFAR net through the train verb (BN_ITERS
    iterations from records, one test pass, a snapshot); its BatchNorm
    state blobs against their start (zero) and s against the sum of
    BN_MAF^i over the BN_ITERS updates; then the snapshot served on
    ``device``, 4 requests held to a TEST-phase forward of the same
    weights and state on the CPU."""
    from sparknet_tpu_torch.graph.compiler import blob_to_array
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.proto import wire
    from sparknet_tpu_torch.serve import Batcher, ServeEngine, serve_http
    db, solver_path = _bn_cifar_files(tmp)
    out, wall = _train_verb(solver_path, "bn-cli",
                            extra=("--iterations", str(BN_ITERS),
                                   "--device", device))
    losses = [float(l.split("loss = ")[1].split(",")[0])
              for l in out.splitlines() if l.startswith("Iteration ")]
    check(len(losses) == 3 and all(np.isfinite(losses)),
          f"bn train verb losses {losses}")
    tests = [l for l in out.splitlines() if "Test net output" in l]
    check(len(tests) == 2 and "device-cached" in out,
          f"bn train verb: {len(tests)} test outputs (want the loss and "
          "the accuracy of one pass) or not the device-cached feed")
    prefix = os.path.join(db, "bn")
    model = f"{prefix}_iter_{BN_ITERS}.caffemodel"
    check(os.path.exists(model), f"no snapshot {model}")
    layers = {l.name: [blob_to_array(b) for b in l.blobs]
              for l in wire.load(model, "NetParameter").layer}
    want_s = sum(BN_MAF ** i for i in range(BN_ITERS))
    state = {}
    for name in ("bn1", "bn2", "bn3"):
        mean, var, s = layers[name]
        check(np.abs(mean).max() > 0 and var.min() > 0,
              f"{name}: the state did not move from its zero start")
        check(abs(float(s[0]) - want_s) <= 1e-5 * want_s,
              f"{name}: s = {float(s[0])}, want {want_s}")
        state[name] = {"mean_abs_max": float(np.abs(mean).max() / s[0]),
                       "var_min": float(var.min() / s[0]), "s": float(s[0])}
    print(f"[bn] state after {BN_ITERS} iterations (s want {want_s:.6f}): "
          f"{state}")

    # the snapshot's net feeds from TRAIN-phase Data layers: serve the
    # same layers behind a feed blob (the serve verb's --model)
    deploy = zoo.cifar10_full_sigmoid_bn(batch_size=8)
    engine = ServeEngine(prefix, net_param=deploy, max_batch=8,
                         device=device, log_fn=None)
    engine.load()
    cpu = ServeEngine(prefix, net_param=deploy, max_batch=8, device="cpu",
                      log_fn=None)
    cpu.load()
    rs = np.random.RandomState(SEED)
    inputs = [rs.randn(n, 3, 32, 32).astype(np.float32) * 50
              for n in (1, 3, 8, 5)]
    batcher = Batcher(max_batch=8, max_wait_s=0.002, queue_limit=64)
    stop, listening = threading.Event(), threading.Event()
    urls, rcs = [], []

    def run():
        rcs.append(serve_http(
            engine, batcher, port=0, stop_event=stop, log_fn=print,
            on_listen=lambda u: (urls.append(u), listening.set())))

    server = threading.Thread(target=run, daemon=True)
    server.start()
    try:
        check(listening.wait(120), "server did not start listening")
        lat = _serve_requests(
            urls[0], inputs, lambda x: cpu.forward({"data": x})[0]["ip1"],
            "BN CIFAR snapshot", top="ip1", classes=10)
    finally:
        stop.set()
        server.join(timeout=120)
    check(not server.is_alive() and rcs == [0], "server did not drain")
    return {"losses": losses, "tests": tests, "verb_s": wall,
            "state": state, "serve_ms": lat}


def _sweep_cases(tmp):
    """[(type, layer fields, bottom shapes, phase, limit)]: each layer
    type of the zoo sweep, and STOCHASTIC pooling, at a shape its users run
    (batch 100 CIFAR activations, CaffeNet's pool5 input at batch 32 and
    fc7 at 256, GoogLeNet's 56x56 planes, an LM block's tokens)."""
    mod = "zoo_sweep_layer"
    with open(os.path.join(tmp, f"{mod}.py"), "w") as f:
        f.write("import torch\n\n\nclass Gate:\n"
                "    def reshape(self, bottom_shapes):\n"
                "        return [bottom_shapes[0]]\n\n"
                "    def param_shapes(self):\n"
                "        return [((64,), None, 1.0, 1.0)]\n\n"
                "    def forward(self, params, bottoms):\n"
                "        x = bottoms[0]\n"
                "        return [x * torch.sigmoid(params[0][None, :, None,"
                " None] * x)]\n")
    os.environ["SPARKNET_PYTHON_LAYER_PATH"] = tmp
    act = (100, 32, 32, 32)         # cifar10_full's conv1 at batch 100
    p5 = (32, 256, 13, 13)          # CaffeNet's pool5 input at batch 32
    fc = (256, 4096)                # CaffeNet's fc7 at batch 256
    train, test = 0, 1
    lo, hi = SWEEP_LIMIT, SWEEP_SUM_LIMIT
    return [
        ("PReLU", {}, [(32, 64, 56, 56)], train, lo),
        ("Sigmoid", {}, [act], train, lo),
        ("TanH", {}, [act], train, lo),
        ("BNLL", {}, [act], train, lo),
        ("AbsVal", {}, [act], train, lo),
        ("Power", dict(power_param=dict(power=2.0, scale=0.5, shift=1.0)),
         [act], train, lo),
        ("Exp", dict(exp_param=dict(base=2.0, scale=0.5)), [act], train, lo),
        ("Log", dict(log_param=dict(shift=6.0, scale=0.5)), [act], train,
         lo),
        ("Threshold", dict(threshold_param=dict(threshold=0.5)), [act],
         train, lo),
        ("Slice", dict(top=["a", "b"], slice_param=dict(
            axis=1, slice_point=[96])), [p5], train, lo),
        ("Split", dict(top=["a", "b"]), [p5], train, lo),
        ("Reshape", dict(reshape_param=dict(shape=dict(dim=[0, -1]))),
         [p5], train, lo),
        ("Tile", dict(tile_param=dict(axis=1, tiles=2)), [p5], train, lo),
        ("ArgMax", dict(argmax_param=dict(top_k=5, out_max_val=True)),
         [(256, 1000)], test, lo),
        ("Reduction", dict(reduction_param=dict(operation="SUMSQ", axis=1,
                                                coeff=0.5)), [act], train,
         hi),
        ("Silence", {}, [fc], train, lo),
        ("BatchReindex", {}, [fc, (256,)], train, lo),
        ("Filter", dict(top=["f", "l", "n"]), [fc, (256,), (256,)], train,
         lo),
        ("Deconvolution", dict(convolution_param=dict(
            num_output=64, kernel_size=[4], stride=[2], pad=[1])),
         [(8, 64, 56, 56)], train, hi),
        ("Im2col", dict(convolution_param=dict(kernel_size=[3], pad=[1])),
         [(8, 64, 28, 28)], train, lo),
        ("SPP", dict(spp_param=dict(pyramid_height=3, pool="MAX")), [p5],
         train, lo),
        ("Pooling", dict(pooling_param=dict(pool="STOCHASTIC",
                                            kernel_size=3, stride=2)),
         [act], test, hi),
        ("BatchNorm", {}, [act], train, hi),
        ("Python", dict(top=["y"], python_param=dict(module=mod,
                                                     layer="Gate")),
         [(32, 64, 56, 56)], train, lo),
        ("MoE", dict(top=["y", "aux", "stats"], moe_param=dict(
            num_experts=8, hidden_dim=4096)), [(2, 1024, 1024)], train, hi),
    ]


def _sweep_inputs(type_name, shapes, rs):
    xs = [rs.randn(*s).astype(np.float32) for s in shapes]
    if type_name == "BatchReindex":
        xs[1] = rs.randint(0, shapes[0][0], shapes[1]).astype(np.float32)
    elif type_name == "Filter":
        xs[1] = rs.randint(0, 10, shapes[1]).astype(np.float32)
        xs[2] = (rs.rand(*shapes[2]) < 0.5).astype(np.float32)
    elif type_name == "Pooling":
        xs[0] = np.maximum(xs[0], 0)             # STOCHASTIC after a ReLU
    return xs


def _stochastic_draws(torch, layer, x):
    """TRAIN-phase STOCHASTIC draws on x's device: every output is an
    element of its window, and a window with a positive element draws a
    positive one. -> the windows checked."""
    from sparknet_tpu_torch.ops.pooling import _patches
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    y, = layer.apply([], [x], True, gen)
    p = _patches(x, layer.kernel, layer.stride, layer.pad, layer.out)
    member = (p == y[:, :, None]).any(dim=2)
    live = (p > 0).any(dim=2)
    check(bool(member.all()), "STOCHASTIC TRAIN drew a value outside its "
                              "window")
    check(bool((y[live] > 0).all()), "STOCHASTIC TRAIN drew a non-positive "
                                     "element of a window with a positive "
                                     "one")
    return member.numel()


def phase_layer_sweep(torch, card, tmp, device="cuda"):
    """Each of the 24 zoo layer types (and STOCHASTIC pooling),
    forward and backward on ``device`` against the same layer on the CPU
    from the same inputs, params and cotangents (f32, TF32 off; the
    limits above); STOCHASTIC's TRAIN draws checked to be elements of
    their windows; fwd+bwd time on the card (median of 10, CUDA
    events)."""
    from sparknet_tpu_torch.device import resolve_device
    from sparknet_tpu_torch.graph.registry import get
    from sparknet_tpu_torch.proto import Message
    resolve_device(device)                       # TF32 off on the card
    rows = {}
    for i, (type_name, fields, shapes, phase, limit) in enumerate(
            _sweep_cases(tmp)):
        rs = np.random.RandomState(SEED + i)
        lp = Message("LayerParameter", name=type_name.lower(),
                     type=type_name, **fields)
        layer = get(type_name)(lp, shapes, phase)
        params = [(0.1 * rs.randn(*s)).astype(np.float32)
                  for s, *_ in layer.param_shapes()]
        xs = _sweep_inputs(type_name, shapes, rs)
        state = [np.full(s, v, np.float32) for s, v in layer.state_shapes()]
        outs = [np.asarray(rs.randn(*s), np.float32)
                for s in layer.out_shapes()]

        def tensors(dev):
            return ([torch.tensor(p, device=dev) for p in params],
                    [torch.tensor(x, device=dev) for x in xs],
                    [torch.tensor(v, device=dev) for v in state],
                    [torch.tensor(c, device=dev) for c in outs])

        def run(ps, bs, st, cots):
            ps = [p.detach().requires_grad_(True) for p in ps]
            bs = [b.detach().requires_grad_(b.is_floating_point())
                  for b in bs]
            if layer.has_state:
                tops, _ = layer.apply_stateful(ps, st, bs, phase == 0)
            else:
                tops = layer.apply(ps, bs, phase == 0)
            terms = [(t * c).sum() for t, c in zip(tops, cots)
                     if t.requires_grad]
            wrt = [t for t in ps + bs if t.requires_grad]
            grads = torch.autograd.grad(sum(terms), wrt, allow_unused=True) \
                if terms else []
            # an index or selector bottom takes no gradient
            return tops, [torch.zeros_like(t) if g is None else g
                          for t, g in zip(wrt, grads)]

        cpu = tensors("cpu")
        dev = tensors(device)
        cpu_tops, cpu_grads = run(*cpu)
        tops, grads = run(*dev)
        ms = Timer(torch, reps=10, flush=False)(lambda: run(*dev)) \
            if device == "cuda" else float("nan")
        e_out = max([_rel_err(t.detach().double().cpu(),
                              r.detach().double())
                     for t, r in zip(tops, cpu_tops)] or [0.0])
        e_grad = max([_rel_err(a.double().cpu(), b.double())
                      for a, b in zip(grads, cpu_grads)] or [0.0])
        extra = ""
        if type_name == "MoE":
            ratio = _routing_ratio(dev[1][0], cpu[1][0], dev[0][0])
            extra = f"; routing margin / logit difference {ratio:.1f}"
            check(ratio > ROUTING_FACTOR, f"MoE sweep: a token's router "
                  f"margin is {ratio:.2f} times its card-CPU logit "
                  "difference: a near-tie, not a port defect")
        if type_name == "Pooling":
            n = _stochastic_draws(torch, layer, dev[1][0])
            extra = f"; TRAIN draws in their windows ({n} windows)"
        print(f"[zoo-sweep] {type_name:<13} {str(shapes[0]):<18} fwd+bwd "
              f"{ms:.3f} ms; max |card - cpu| / max |cpu|: tops "
              f"{e_out:.2e}, grads {e_grad:.2e} (limit {limit:g}){extra}")
        check(e_out <= limit and e_grad <= limit,
              f"{type_name}: card and CPU differ by {e_out:.2e} (tops), "
              f"{e_grad:.2e} (grads), limit {limit:g}")
        rows[type_name] = {"shape": list(shapes[0]), "ms": ms,
                           "tops_rel": e_out, "grads_rel": e_grad,
                           "limit": limit}
    check(len(rows) == 25, f"{len(rows)} sweep rows, want 24 types and "
                           "STOCHASTIC pooling")
    print(f"[zoo-sweep] {len(rows)} layers within their limits; {card}")
    return rows


def phase_zoo_all(torch, card, tmp):
    t0 = time.perf_counter()
    moe_cli = phase_moe_cli()
    moe_step = phase_moe_step(torch, card)
    moe_parity = phase_moe_card_vs_cpu(torch, tmp)
    torch.cuda.empty_cache()
    bn = phase_bn_cifar(torch, card, tmp)
    sweep = phase_layer_sweep(torch, card, tmp)
    wall = time.perf_counter() - t0
    print(f"[zoo] phase 11 wall time {wall:.1f} s")
    return {"moe_cli": moe_cli, "moe_step": moe_step,
            "moe_card_vs_cpu": moe_parity, "bn_cifar": bn, "sweep": sweep,
            "wall_s": wall}


# -- phase 12 -------------------------------------------------------------

REMAT_POLICIES = ("none", "dots", "full")
CNN_KERNELS = ("lrn_across", "lrn_across_bwd", "bias_relu_lrn",
               "bias_relu_lrn_bwd")
FORWARD_OF = {"lrn_across": "lrn_across_bwd",
              "bias_relu_lrn": "bias_relu_lrn_bwd",
              "flash_attention": "flash_attention_dq"}
REMAT_LIMIT = 1e-4          # relative, remat against none on the card
GOOGLENET_STEPS = 10
VERB_ITERS = 24             # the metrics verb run: samples at 0, 1, 21


def _zero_launches():
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def _policy_runs(torch, solver, feed, steps, label, card):
    """Under each remat policy: the step (median of ``steps``, CUDA
    events), the peak allocated memory and the launches of one step."""
    from sparknet_tpu_torch.ops import kernel_launches
    out = {}
    for pol in REMAT_POLICIES:
        solver.set_remat(pol)
        float(solver.train_step(feed))               # warm-up
        _zero_launches()
        float(solver.train_step(feed))
        launches = kernel_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = Timer(torch, reps=steps, flush=False)(
            lambda: solver.train_step(feed))
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[pol] = {"step_ms": ms, "peak_gb": peak, "launches": launches}
        print(f"[remat] {label} --remat {pol}: step {ms:.3f} ms (median of "
              f"{steps}, CUDA events), peak allocated {peak:.2f} GB, "
              f"launches an iteration "
              f"{ {k: v for k, v in launches.items() if v} }; {card}")
    solver.set_remat("none")
    return out


def _check_recompute(runs, kernels):
    """Forwards launch twice an iteration under dots and full, once
    under none; backwards the same number under every policy."""
    for name in kernels:
        bwd = FORWARD_OF.get(name)
        if bwd is None:
            continue
        n = runs["none"]["launches"][name]
        check(n >= 1, f"{name} never launched under --remat none")
        for pol in ("dots", "full"):
            got = runs[pol]["launches"]
            check(got[name] == 2 * n,
                  f"--remat {pol}: {name} launched {got[name]} times an "
                  f"iteration, want twice none's {n}")
            for b in [bwd] + (["flash_attention_dkv"]
                              if name == "flash_attention" else []):
                check(got[b] == runs["none"]["launches"][b],
                      f"--remat {pol}: {b} launched {got[b]} times, none "
                      f"{runs['none']['launches'][b]}")


def _two_steps(torch, solver, state_path, batches):
    """Two SGD steps from the snapshot -> (losses, {blob: weight
    change}) as float64 arrays on the host."""
    solver.restore(state_path)
    solver.generator.manual_seed(SEED)
    w0 = {n: [p.detach().double().cpu() for p in ps]
          for n, ps in solver.params.items()}
    losses = [float(solver.train_step(b)) for b in batches]
    dw = {n: [(p.detach().double().cpu() - w).numpy()
              for p, w in zip(ps, w0[n])]
          for n, ps in solver.params.items()}
    return np.array(losses), dw


def _remat_agreement(torch, solver, tmp, batches):
    """Two steps under each policy from one snapshot, cuDNN restricted
    to deterministic algorithms: losses and every blob's weight change
    within REMAT_LIMIT of --remat none's, relative to its largest
    value; -> the readings."""
    torch.backends.cudnn.deterministic = True
    try:
        solver.set_remat("none")
        _, state = solver.snapshot(os.path.join(tmp, "remat_start"))
        ref_l, ref_dw = _two_steps(torch, solver, state, batches)
        out = {}
        for pol in ("dots", "full"):
            solver.set_remat(pol)
            l, dw = _two_steps(torch, solver, state, batches)
            loss_err = float(np.max(np.abs(l - ref_l) / np.abs(ref_l)))
            worst, where = 0.0, None
            for n, ds in ref_dw.items():
                for i, d in enumerate(ds):
                    scale = max(float(np.abs(d).max()), 1e-30)
                    e = float(np.abs(dw[n][i] - d).max()) / scale
                    if e > worst:
                        worst, where = e, f"{n}[{i}]"
            print(f"[remat] two SGD steps, --remat {pol} against none: "
                  f"loss {loss_err:.3e}, worst weight change {worst:.3e} "
                  f"({where}), limit {REMAT_LIMIT:g}")
            check(loss_err <= REMAT_LIMIT and worst <= REMAT_LIMIT,
                  f"--remat {pol} disagrees with none: loss {loss_err:.3e}"
                  f", weight change {worst:.3e} at {where}")
            out[pol] = {"loss_rel": loss_err, "weight_change_rel": worst,
                        "blob": where}
        solver.set_remat("none")
        # C8: SPARKNET_PRECISION reaches no CNN layer, so bf16 is fp32
        from sparknet_tpu_torch.solver import Solver
        os.environ["SPARKNET_PRECISION"] = "bf16"
        try:
            bf = Solver(solver.param, device=solver.device, log_fn=None)
        finally:
            os.environ.pop("SPARKNET_PRECISION")
        check(bf.net.compute_dtype == torch.bfloat16 and all(
            getattr(impl, "compute_dtype", None) is None
            for _, impl, _, _ in bf.net.layers),
            "--precision bf16 did not resolve net.compute_dtype alone")
        again, _ = _two_steps(torch, solver, state, batches)
        bl, _ = _two_steps(torch, bf, state, batches)
        print(f"[remat] --precision fp32 losses {ref_l.tolist()} (again "
              f"{again.tolist()}), --precision bf16 {bl.tolist()}")
        check(np.array_equal(again, ref_l),
              "fp32 twice is not bit for bit with deterministic cuDNN")
        check(np.array_equal(bl, ref_l),
              "--precision bf16 changed GoogLeNet's losses")
        out["precision_bf16_equal"] = True
        del bf
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _safety_costs(torch, solver, feed, card, tmp, iters=24):
    """ms an iteration of Solver.step (display every 8, as the solver
    prototxt says) with nothing armed, with the metrics stream, with
    recovery and with both: the host clock over ``iters`` iterations
    ending in a synchronize, each arm three times in turns (forward,
    backward, forward); -> {arm: [ms, ms, ms]}."""
    from sparknet_tpu_torch.obs import (CommsMeter, MemoryMonitor,
                                        StepAccounting)
    from sparknet_tpu_torch.utils.metrics import MetricsLogger

    def batches():
        while True:
            yield feed

    arms = (("off", False, False), ("metrics", True, False),
            ("recover", False, True), ("metrics+recover", True, True))
    solver.param.snapshot = 0
    logger = MetricsLogger(os.path.join(tmp, "costs.jsonl"))
    out = {label: [] for label, _, _ in arms}
    for order in (arms, arms[::-1], arms):
        for label, metrics, recover in order:
            solver.metrics = logger if metrics else None
            solver.stepstats = StepAccounting(logger) if metrics else None
            solver.comms = CommsMeter(logger) if metrics else None
            solver.memstats = MemoryMonitor(logger, device=solver.device) \
                if metrics else None
            solver._comms_registered = False
            solver.recovery = None
            if recover:
                solver.arm_recovery(max_rollbacks=2)
            solver.step(8, batches())                # warm the arm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.step(iters, batches())
            torch.cuda.synchronize()
            out[label].append((time.perf_counter() - t0) / iters * 1e3)
    solver.metrics = solver.stepstats = solver.comms = None
    solver.memstats = solver.recovery = None
    logger.close()
    print(f"[costs] GoogLeNet b32 Solver.step, ms an iteration over "
          f"{iters}, three turns each: " + "; ".join(
              f"{k} {[round(v, 3) for v in vs]} (median "
              f"{statistics.median(vs):.3f})" for k, vs in out.items())
          + f"; {card}")
    return out


def phase_remat_googlenet(torch, card, tmp, batch=32):
    from sparknet_tpu_torch.solver import Solver
    os.environ.pop("SPARKNET_EPILOGUE", None)
    rs = np.random.RandomState(SEED + 12)
    solver = Solver(_googlenet_solver(batch, os.path.join(tmp, "remat")),
                    device="cuda", log_fn=None)
    check(set(solver.net._remat_groups()) and all(
        any(lo <= i < hi for lo, hi in solver.net._remat_groups().items())
        for i, (lp, _, _, _) in enumerate(solver.net.layers)
        if lp.name in ("pool1/norm1", "conv2/norm2")),
        "GoogLeNet's LRN sites are not inside remat segments")
    feed = {k: torch.as_tensor(v).cuda() for k, v in _batch(rs, batch).items()}
    runs = _policy_runs(torch, solver, feed, GOOGLENET_STEPS,
                        f"GoogLeNet b{batch} f32", card)
    _check_recompute(runs, CNN_KERNELS)
    costs = _safety_costs(torch, solver, feed, card, tmp)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in
                _batch(rs, batch).items()} for _ in range(2)]
    agreement = _remat_agreement(torch, solver, tmp, batches)
    del solver, feed, batches
    torch.cuda.empty_cache()
    return {"policies": runs, "agreement": agreement, "costs": costs}


def phase_remat_lm(torch, card, steps=5):
    """The LM at phase 7's width under each policy, then the lm verb
    under --remat dots."""
    from sparknet_tpu_torch.data import lm_batch_stream
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.proto import Message
    from sparknet_tpu_torch.solver import Solver
    f = LM_FULL
    sp = Message("SolverParameter", base_lr=3e-4, lr_policy="fixed",
                 type="Adam", random_seed=SEED, display=0)
    net = zoo.transformer_lm(vocab_size=f["vocab"], seq_len=f["seq_len"],
                             batch_size=f["batch"], d_model=f["d_model"],
                             num_layers=f["layers"], num_heads=f["heads"])
    solver = Solver(sp, net_param=net, device="cuda", log_fn=None,
                    compute_dtype=torch.bfloat16)
    stream, _ = lm_batch_stream(f["vocab"], f["batch"], f["seq_len"],
                                seed=SEED)
    feed = {k: torch.as_tensor(v).cuda() for k, v in next(stream).items()}
    runs = _policy_runs(torch, solver, feed, steps, "LM d1024x12 S4096 bf16",
                        card)
    _check_recompute(runs, ("flash_attention",))
    for pol in ("dots", "full"):
        check(runs[pol]["launches"]["flash_attention"] == 2 * f["layers"],
              f"--remat {pol}: the flash forward is not recomputed in "
              "every block")
    del solver, feed
    torch.cuda.empty_cache()
    out, counts = _lm_cli(["--steps", "2", "--remat", "dots"],
                          tag="lm-cli remat")
    check("done: 2 steps, " in out, "lm verb --remat dots: not 2 steps")
    check(counts["flash_attention"] == 2 * counts["flash_attention_dq"]
          == 2 * counts["flash_attention_dkv"] == 4 * f["layers"],
          f"lm verb --remat dots launches {counts}")
    return {"policies": runs, "verb_launches": counts}


def _registered(path):
    from sparknet_tpu_torch.obs.event_schema import EVENTS
    events = [json.loads(line) for line in open(path)]
    unknown = sorted({e["event"] for e in events} - set(EVENTS))
    check(not unknown, f"events not in obs/event_schema.py: {unknown}")
    return events


def phase_metrics_verb(torch, card, tmp, googlenet, batch=32,
                       device="cuda"):
    """The slice's verb path: GoogLeNet b32 under --remat full with the
    metrics stream, the profiler block, the watchdog and keep-2
    retention; then the report verb on the stream. ``device="cpu"``
    rehearses it without a card (no kernel names in its trace)."""
    from sparknet_tpu_torch import cli
    from sparknet_tpu_torch.proto import text_format
    path = os.path.join(tmp, "googlenet_metrics_solver.prototxt")
    prefix = os.path.join(tmp, "googlenet_metrics")
    text_format.dump(_googlenet_solver(batch, prefix), path)
    metrics = os.path.join(tmp, "googlenet.jsonl")
    prof = os.path.join(tmp, "googlenet_profile")
    out = _train_cli(["--solver", path, "--iterations", str(VERB_ITERS),
                      "--remat", "full", "--metrics", metrics, "--profile",
                      prof, "--stall-seconds", "600", "--keep", "2",
                      "--device", device])
    counts = {}
    if device == "cuda":        # the CPU runs the plain versions
        counts = _check_cli_launches(out, VERB_ITERS)
        for fwd in ("lrn_across", "bias_relu_lrn"):
            check(counts[fwd] == 2 * counts[FORWARD_OF[fwd]],
                  f"train verb --remat full: {fwd} {counts[fwd]} launches "
                  f"against {counts[FORWARD_OF[fwd]]} backwards")
    events = _registered(metrics)
    kinds = sorted({e["event"] for e in events})
    buf = subprocess.run([sys.executable, "-m", "sparknet_tpu_torch",
                          "report", metrics], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    check(buf.returncode == 0, f"report exited {buf.returncode}: "
                               f"{buf.stderr[-2000:]}")
    for line in buf.stdout.splitlines():
        print(f"[report] {line}")
    summary = [e for e in events if e["event"] == "step_summary"][-1]
    trace = open(os.path.join(prof, "torch.trace.json")).read()
    walks = trace.count("channel_walk")
    check(walks > 0 or device != "cuda",
          "the torch.profiler trace names no channel_walk kernel")
    check(os.path.exists(os.path.join(prof, "spans.trace.json")),
          "no spans.trace.json beside the profiler trace")
    print(f"[metrics] {len(events)} events of kinds {kinds}, all "
          f"registered; stream step p50 {summary['device_ms_p50']} ms "
          f"(device, {summary['device_samples']} samples) against phase "
          f"12's in-process --remat full median "
          f"{googlenet['policies']['full']['step_ms']:.3f} ms; the trace "
          f"names channel_walk {walks} times; {card}")
    return {"events": len(events), "kinds": kinds, "launches": counts,
            "step_summary": summary, "channel_walk_in_trace": walks}


# a pass-through layer that, from its param_str "MODE:N", hangs (stall) or
# turns its input NaN (nan) at its N-th call: a feed that stops, one bad
# batch
TAP_LAYER = """
import time


class Tap:
    def setup(self, bottom_shapes):
        mode, at = self.param_str.split(":")
        self.mode, self.at, self.calls = mode, int(at), 0

    def reshape(self, bottom_shapes):
        return [bottom_shapes[0]]

    def forward(self, params, bottoms):
        self.calls += 1
        if self.calls == self.at and self.mode == "stall":
            time.sleep(3600)
        if self.calls == self.at and self.mode == "nan":
            return [bottoms[0] * float("nan")]
        return [bottoms[0]]
"""


def _safety_files(tmp, name, tap, **fields):
    """A small net (two InnerProducts over a (64, 256) feed) behind a
    Tap layer, and its solver with a snapshot prefix -> (solver path,
    prefix)."""
    from sparknet_tpu_torch.models import dsl
    from sparknet_tpu_torch.proto import Message, text_format
    with open(os.path.join(tmp, "tap_layer.py"), "w") as fh:
        fh.write(TAP_LAYER)
    lp = Message("LayerParameter", name="tap", type="Python")
    lp.bottom.append("data")
    lp.top.append("tapped")
    lp.python_param = Message("PythonParameter", module="tap_layer",
                              layer="Tap", param_str=tap)
    filler = dict(type="gaussian", std=0.05)
    net = dsl.NetParam(
        name, dsl.RDDLayer("data", (64, 256)), dsl.RDDLayer("label", (64,)),
        lp, dsl.InnerProductLayer("ip1", ["tapped"], 512,
                                  weight_filler=filler),
        dsl.ReLULayer("relu", ["ip1"], tops=["ip1"]),
        dsl.InnerProductLayer("ip2", ["ip1"], 10, weight_filler=filler),
        dsl.SoftmaxWithLoss("loss", ["ip2", "label"]))
    prefix = os.path.join(tmp, name, "s")
    sp = Message("SolverParameter", base_lr=0.05, momentum=0.9,
                 lr_policy="fixed", display=1, random_seed=SEED,
                 snapshot_prefix=prefix, **fields)
    sp.net_param = net
    path = os.path.join(tmp, f"{name}_solver.prototxt")
    text_format.dump(sp, path)
    return path, prefix


def _safety_env(tmp):
    return dict(os.environ, PYTHONUNBUFFERED="1",
                SPARKNET_PYTHON_LAYER_PATH=tmp)


def _killable(args, device, limit=180):
    return ["timeout", "-s", "KILL", str(limit), sys.executable, "-m",
            "sparknet_tpu_torch", "train", "--device", device, *args]


def _resume_iter(solver_path, prefix, tmp, device):
    """--resume auto through the train verb in process, one iteration
    past the snapshot -> the iteration it restored."""
    import contextlib
    import io
    from sparknet_tpu_torch import cli
    from sparknet_tpu_torch.resilience import checkpoint
    it = checkpoint.load_manifest(prefix)["latest"]["iter"]
    buf = io.StringIO()
    os.environ["SPARKNET_PYTHON_LAYER_PATH"] = tmp
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train", "--solver", solver_path, "--resume",
                           "auto", "--iterations", str(it + 1),
                           "--device", device])
    finally:
        os.environ.pop("SPARKNET_PYTHON_LAYER_PATH")
    out = buf.getvalue()
    check(rc == 0 and f"resume auto: restored iter {it}" in out,
          f"--resume auto did not restore iteration {it}: {out[-2000:]}")
    return it


def phase_run_safety(tmp, device="cuda"):
    """SIGTERM, the watchdog's kill and a NaN batch, each through the
    train verb in a child under `timeout -s KILL` (``device="cpu"``
    rehearses it without a card)."""
    out = {}
    # SIGTERM after a few iterations: the block ends, snapshot, exit 0
    path, prefix = _safety_files(tmp, "sigterm", "nan:0")
    t0 = time.perf_counter()
    p = subprocess.Popen(_killable(["--solver", path, "--iterations",
                                    "100000"], device),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, cwd=REPO, env=_safety_env(tmp))
    lines = []
    for line in p.stdout:
        lines.append(line)
        if line.startswith("Iteration 2,"):
            p.send_signal(signal.SIGTERM)
            break
    lines.append(p.communicate(timeout=300)[0])
    text = "".join(lines)
    done = [l for l in text.splitlines()
            if l.startswith("Optimization done, iter=")]
    check(p.returncode == 0 and "stopping early on signal" in text and done,
          f"SIGTERM: exit {p.returncode}: {text[-2000:]}")
    it = int(done[-1].split("=")[1])
    check(_resume_iter(path, prefix, tmp, device) == it,
          f"SIGTERM: the snapshot is not iteration {it}")
    print(f"[safety] SIGTERM after iteration 2: snapshot at {it}, exit 0 "
          f"({time.perf_counter() - t0:.1f} s); --resume auto restored it")
    out["sigterm_iter"] = it
    # a layer that hangs at its 6th call: the watchdog kills with 42
    path, prefix = _safety_files(tmp, "stall", "stall:6")
    t0 = time.perf_counter()
    r = subprocess.run(_killable(["--solver", path, "--iterations", "50",
                                  "--stall-seconds", "5"], device),
                       capture_output=True, text=True, cwd=REPO,
                       env=_safety_env(tmp), timeout=300)
    check(r.returncode == 42, f"stall: exit {r.returncode}, want 42: "
                              f"{r.stdout[-1500:]} {r.stderr[-1500:]}")
    it = _resume_iter(path, prefix, tmp, device)
    check(it == 5, f"stall: the emergency snapshot is iteration {it}, "
                   "want 5")
    print(f"[safety] a layer hung at iteration 5: exit 42 after "
          f"{time.perf_counter() - t0:.1f} s, the emergency snapshot of "
          "iteration 5 restores")
    out["stall_exit"], out["stall_iter"] = r.returncode, it
    # one NaN batch at iteration 4 with --recover 2
    path, prefix = _safety_files(tmp, "nan", "nan:5")
    r = subprocess.run(_killable(["--solver", path, "--iterations", "12",
                                  "--recover", "2"], device),
                       capture_output=True, text=True, cwd=REPO,
                       env=_safety_env(tmp), timeout=300)
    check(r.returncode == 0, f"recover: exit {r.returncode}: "
                             f"{r.stdout[-1500:]} {r.stderr[-1500:]}")
    losses = [float(l.split("loss = ")[1].split(",")[0])
              for l in r.stdout.splitlines() if l.startswith("Iteration ")]
    check("rolled back to iter 4" in r.stdout and len(losses) == 12 and
          all(np.isfinite(losses)),
          f"recover: no rollback to 4 or a non-finite loss: "
          f"{r.stdout[-2000:]}")
    print(f"[safety] a NaN batch at iteration 4 with --recover 2: rolled "
          f"back to 4, then losses {[round(l, 4) for l in losses]}")
    out["recover_losses"] = losses
    return out


def phase_levers_all(torch, card, tmp):
    googlenet = phase_remat_googlenet(torch, card, tmp)
    verb = phase_metrics_verb(torch, card, tmp, googlenet)
    torch.cuda.empty_cache()
    lm = phase_remat_lm(torch, card)
    safety = phase_run_safety(tmp)
    return {"googlenet": googlenet, "metrics_verb": verb, "lm": lm,
            "safety": safety}


KERNELS = {
    # name: (source, replaces, path whose launches the row reports)
    "lrn_across": ("sparknet_tpu_torch/csrc/lrn.cu",
                   "sparknet_tpu/ops/pallas_lrn.py:52", "serve auto"),
    "bias_relu_lrn": ("sparknet_tpu_torch/csrc/epilogue.cu",
                      "sparknet_tpu/ops/pallas_epilogue.py:58", "serve auto"),
    "bias_relu": ("sparknet_tpu_torch/csrc/epilogue.cu",
                  "sparknet_tpu/ops/pallas_epilogue.py:52", "serve on"),
    "lrn_across_bwd": ("sparknet_tpu_torch/csrc/lrn_bwd.cu",
                       "sparknet_tpu/ops/pallas_lrn.py:59", "train auto"),
    "bias_relu_lrn_bwd": ("sparknet_tpu_torch/csrc/lrn_bwd.cu",
                          "sparknet_tpu/ops/pallas_lrn.py:59", "train auto"),
    "flash_attention": ("sparknet_tpu_torch/csrc/flash_fwd.cu",
                        "sparknet_tpu/ops/pallas_attention.py:38", "lm verb"),
    "flash_attention_dq": ("sparknet_tpu_torch/csrc/flash_bwd.cu",
                           "sparknet_tpu/ops/pallas_attention.py:144",
                           "lm verb"),
    "flash_attention_dkv": ("sparknet_tpu_torch/csrc/flash_bwd.cu",
                            "sparknet_tpu/ops/pallas_attention.py:187",
                            "lm verb"),
}


PHASES = {1: "device", 2: "build", 3: "kernels", 4: "serve", 5: "train",
          6: "flash", 7: "lm", 8: "local-sgd", 9: "records", 10: "feeds",
          11: "zoo", 12: "levers, run safety, metrics"}


def _selected(argv):
    """--phases 3,12 -> {1, 2, 3, 12} (phase 10 brings 9, whose records
    it reads); no argument -> every phase."""
    if not argv:
        return set(PHASES)
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases N[,N...]]")
    want = {int(x) for x in argv[1].split(",")}
    bad = want - set(PHASES)
    if bad:
        raise SystemExit(f"no phase {sorted(bad)}; phases are 1-12")
    if 10 in want:
        want.add(9)
    return want | {1, 2}


def main(argv=None):
    sys.path.insert(0, REPO)
    phases = _selected(sys.argv[1:] if argv is None else argv)
    import torch
    seconds = {}
    t_start = time.perf_counter()

    def run(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[n] = time.perf_counter() - t0
        print(f"[phase {n}] {PHASES[n]}: {seconds[n]:.1f} s")
        return out

    def section(n, fn, *args):
        if n not in phases:
            return None
        out = run(n, fn, *args)
        torch.cuda.empty_cache()
        return out

    card = run(1, phase_device, torch)
    run(2, phase_build)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    results = section(3, phase_kernels, torch)
    served = section(4, phase_serve, torch, card)
    trained_cli, trained = section(5, lambda: (
        phase_train_cli(tmp), phase_train(torch, card, tmp))) or (None, None)
    flash = section(6, phase_flash_kernels, torch)
    lm_cli, lm_step, lm_parity = section(7, lambda: (
        phase_lm_cli(tmp), phase_lm_step(torch, card),
        phase_lm_card_vs_cpu(torch, tmp))) or (None, None, None)
    local_sgd = section(8, phase_local_sgd_all, torch, card, tmp)
    records = section(9, phase_records_all, torch, card, tmp)
    feeds = section(10, lambda: phase_feeds_all(
        torch, card, tmp, records["dir"], records["solver"]))
    zoo = section(11, phase_zoo_all, torch, card, tmp)
    levers = section(12, phase_levers_all, torch, card, tmp)
    total = time.perf_counter() - t_start
    print("[phases] " + json.dumps(
        {PHASES[n]: round(v, 1) for n, v in sorted(seconds.items())}))
    print(f"[phases] total {total:.1f} s")
    if phases != set(PHASES):
        print(f"partial run of phases {sorted(phases)}: no result lines")
        return 0
    paths = {"serve auto": served["auto"], "serve on": served["on"],
             "train auto": trained["launches"]["auto"],
             "train on": trained["launches"]["on"],
             "lm verb": lm_cli["launches"],
             "local-sgd caffenet": local_sgd["rounds"]["caffenet"][
                 "launches"],
             "train verb on records": records["cli"]["launches"],
             "train verb, device-cached": feeds["cli"]["cached"]["launches"],
             "train verb, dp": feeds["cli"]["dp"]["launches"]}
    remat = levers["googlenet"]["policies"]
    remat_lm = levers["lm"]["policies"]
    table = []
    for name, (source, replaces, own_path) in KERNELS.items():
        rows = [r for r in results + flash if r["name"] == name and r["row"]]
        check(rows, f"no timed row of {name}")
        for r in rows:          # one entry per timed shape of the kernel
            # CaffeNet's shapes: the train verb's default, device-cached
            # feed, and its dp slots (phase 10)
            caffenet = tuple(r["shape"]) in CAFFENET_LRN_SHAPES
            path = "train verb, device-cached" if caffenet else \
                "train verb, dp" if tuple(r["shape"]) in \
                CAFFENET_DP_LRN_SHAPES else own_path
            per_iter, model = (remat_lm, "lm") if name in FLASH_KERNELS \
                else (remat, "googlenet")
            table.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": paths[path][name],
                "launches_path": path,
                "launches_train": trained["launches"]["auto"][name],
                "launches_lm_step": lm_step["launches"][name],
                f"launches_{model}_iteration_by_remat": {
                    pol: per_iter[pol]["launches"][name]
                    for pol in REMAT_POLICIES},
                **({"launches_moe_lm_verb": zoo["moe_cli"]["launches"][name],
                    "launches_moe_lm_step": zoo["moe_step"]["launches"][
                        name]} if name in FLASH_KERNELS else {}),
                **({"launches_local_sgd": paths["local-sgd caffenet"][name],
                    "launches_imagenet": records["imagenet"]["launches"][
                        name],
                    "launches_records_streaming":
                        paths["train verb on records"][name],
                    "launches_streaming_verb":
                        feeds["cli"]["streaming"]["launches"][name],
                    "launches_dp_verb": feeds["cli"]["dp"]["launches"][name]}
                   if caffenet else {}),
                "shape": r["shape"], "dtype": r["dtype"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **{k: r[k] for k in ("tflops", "registers", "smem_bytes",
                                     "ctas_per_sm", "bound_share")
                   if k in r}})
    print("[details] " + json.dumps({
        "card": card, "cases": results, "flash_cases": flash,
        "serve": {k: served[k] for k in ("per_bucket_ms", "images_per_s_b8",
                                         "p50_ms", "profile_b8")},
        "train": {**{k: trained[k] for k in (
            "launches", "fixed_batch_losses", "step_ms", "images_per_s",
            "profile", "card_vs_cpu")}, **trained_cli},
        "lm": {"cli": lm_cli, "step": lm_step, "card_vs_cpu": lm_parity},
        "local_sgd": local_sgd, "records": records, "feeds": feeds,
        "zoo": zoo, "levers": levers,
        "phase_seconds": {PHASES[n]: v for n, v in seconds.items()},
        "total_seconds": total}, default=str))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
