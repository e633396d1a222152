#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sparknet_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

 1. device  — the card's name and power limit (nvidia-smi), torch, CUDA
              and nvcc versions; fails when torch.cuda.is_available() is
              False.
 2. build   — compiles the port's CUDA kernels from csrc/ (one nvcc per
              source, all at once: the flash kernels, and beside them the
              one-pass TF32 control of the f32 flash kernels, go on
              building behind phases 3-5, which do not launch them, and
              phase 6 waits for them) and prints the seconds it took and
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
 6. flash   — registers, spills, shared memory, CTAs per SM, and for the
              cluster kernels (past head_dim 256, and the f32 forward and
              backward at 256) the cluster size and co-resident clusters,
              of every flash kernel instantiation, forward and backward
              (none may spill; the backward's on wgmma, the f32
              forward's on wgmma and the f32 forward's and backward's
              clusters of two at head_dim 256 must read their designs'
              168 registers, shared memory, one CTA an SM and cluster
              size); then the three
              flash-attention kernels (forward, dQ, dK/dV) against their
              plain versions: f32 at (2, 4, 1024, 64), causal and not,
              bf16 at (2, 4, 1024, 128) full, (2, 4, 1024, 64) causal
              and (2, 4, 1024, 96) causal (a head_dim that is not built,
              zero-padded to 128), f32 and bf16 at (1, 4, 1024, 256) and
              (1, 4, 1024, 192) (zero-padded to 256), causal and not,
              f32 and bf16 at (1, 4, 1024, D) for D in 320, 512 and 1024
              (the wide kernels of csrc/flash_wide.cuh: the forward, dQ
              and dK/dV on thread-block clusters, each launch counted),
              causal and not,
              bf16 at the LM's full width (4, 8, 4096, 128), causal, and
              at (1, 4, 1000, 128), causal (a ragged last 128-row tile),
              f32 (the lm verb's default dtype) there and at the verb's
              default widths (8, 8, 256, 32), causal;
              each output's worst 64-row tile against f32 1e-4 and bf16
              5e-3 of that tile's norm (a measure that does not shrink
              along the sequence as causal outputs do; the bf16 kernels
              round P, and dS, to bf16 before their second products),
              with two planted faults that must fail it and the library's
              own O and gradients read beside it, f32 also against 2e-5
              (forward) and 5e-4 (backward) of the largest reference
              element, LSE and delta against 2e-5 of theirs; every f32
              case and every bf16 case up to head_dim 256 launched
              twice, bitwise equal; every f32 case run
              through the one-pass TF32
              control build (lo terms left out), whose O must read over
              2e-5 and whose dQ over a dQ limit; median times
              over CUDA events with the L2 flushed, achieved TFLOP/s; the
              bound (the larger of bytes over 3.35 TB/s and FLOPs over 165
              TFLOP/s for f32 (495 TF32 over the 3 products of split
              TF32), or 989 TFLOP/s dense bf16 tensor); the library
              call (F.scaled_dot_product_attention forward, and
              torch.autograd.grad through it for dq, dk, dv together).
 7. lm      — the transformer LM at the full width of bench.py's larger
              row (vocab 8192, S 4096, batch 4, d 1024, 12 layers, 8
              heads, bf16 activations over f32 masters, Adam): the lm
              verb in process for 3 steps with a snapshot, then
              --resume to 5 (the counter continues, each kernel launches
              exactly 12 times per step in both runs, the loss falls from
              about ln 8192); in process, the train step time (CUDA
              events) and tokens/s, launches per step, and a profiler
              window (port attention kernels, cuBLAS GEMMs, other; busy
              share); the same step in f32 throughout (the lm verb's
              default dtype: no compute dtype, TF32 off) with its flash
              kernels' share of the profiler window; the lm verb at its
              defaults (vocab 512, S 256, b 8, d 256, 4 layers, f32) for 2
              steps, each flash kernel 4 times a step at (8, 8, 256, 32);
              the lm verb at d_model 2048, 8 heads (LM_D256: 2 layers,
              b2, S 4096) for 2 steps in bf16 and at the verb's default
              dtype, f32 (TF32 left off), each flash kernel 2 times a
              step at (2, 8, 4096, 256) and the first loss within 1.5 of
              ln 8192;
              and card against CPU for a small LM (2 layers, d
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
              from 50 to 1, 1 round and its test at round 0 (finite
              losses, the test accuracy, images/s a round, 2 LRN
              launches a step and 2 a test batch).
10. feeds  — the train verb's whole input path on phase 9's CaffeNet
              b256 records: the verb with default flags (the records
              resident on the card: `device-cached`) and with
              `--strategy dp --mesh data=4` (phase 9 ran it streaming),
              10 iterations each (finite
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
11. zoo    — the layer zoo and the Switch-MoE LM: the lm verb in
              process at phase 7's full width with
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
              (median of 5, CUDA events), peak allocated memory and
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
              median of 3, peak memory, flash forward launches against
              dQ/dK/dV) and the lm verb under --remat dots; and on a
              small net, each in a child under `timeout -s KILL`: SIGTERM
              snapshots and exits 0 (--resume auto restores it), a layer
              that hangs under a Solver armed with
              arm_watchdog(kill_on_stall=True) exits 42 leaving a
              snapshot that restores (the train verb's --stall-seconds
              only logs, as the JAX verb's), a NaN batch with --recover 2
              rolls back and goes on with finite losses.
13. fleet  — the serving fleet on phase 4's GoogLeNet snapshot (f32,
              buckets 1-8, a copy of the prefix for each replica): R0 is
              serve_http in this process with a ReplicaMember (its
              launch counters readable), R1 and R2 `python -m
              sparknet_tpu_torch serve --fleet_dir` processes, R2 with
              --chaos kill_replica=2,kill_req=25; `route --lease 3` in
              front; 8 inputs through the router within 1e-3 of the CPU
              forward; `serve-bench` closed (16 in flight, 5 s) and open
              (half the closed rate, 5 s) with 0 errors through R2's
              kill, the router evicting it within a lease and a window;
              R0's LRN and fused bias+ReLU+LRN launches equal to its
              serve_batch events, bias+ReLU 0; a snapshot written under
              R1's prefix served within the reload poll and a beat,
              R1's answers then the new weights', the router seeing two
              shas; SIGTERM to R1 under load: exit 0 after a drain, 0
              errors; the report verb's stage breakdown over the
              router's stream and `monitor --once`. Prints req/s, rows/s,
              the open loop's p50/p95/p99, each stage's p50/p99, the
              mean batch fill, the failover window and its seconds.
14. hosts  — multi-host training on the one card. A: CaffeNet at the
              ImageNet app's widths (4 slots x b256, tau 10, phase 8's
              solver) under LocalSGDSolver(host_axis="host"): 4 hosts x 1
              slot against the single-tier round and 1 host x 4 slots
              against 10 DataParallelSolver steps, bit for bit with
              deterministic cuDNN; 2 hosts x 2 slots beside phase 8's
              round, then 4 rounds with elastic membership (quorum 1,
              evict_after 1, readmit_after 2) and chaos kill_host=1 at
              round 1: each round's consensus within 1e-6 of a float64
              masked mean of the live hosts' post-round weights, host 1
              evicted at round 1 and readmitted at round 3, every host
              holding the consensus, the LRN launches a round equal to
              the unarmed round's, the masked consensus alone timed. B:
              the train verb on phase 9's records with `--strategy dp
              --mesh data=4 --quorum 3 --evict-after 1 --readmit-after 2
              --staleness 1 --chaos kill_worker=1,kill_round=2
              --metrics`: exit 0, the eviction and readmission events,
              finite losses, phase 10's dp LRN launches. C: `cifar
              --hosts N --workers 2N` processes (2 slots x b100 a host,
              cifar10_full, make_synth_cifar records) relaying through
              --heartbeat-dir (lease 2 s, beat 0.25 s): 2 processes with
              host 1 killed at round 3 (the consensus bit for bit across
              the hosts before it, the eviction within a lease and a
              beat, the survivor's exit 0, the relay's post, mask and
              average ms); 3 processes at --quorum 3 with host 2 killed
              (both survivors exit 4 agreed on the manifest's sha256; a
              2-process relaunch with --resume auto --reshard auto goes
              on from it); a running pair joined by a `--hosts 1 --grow
              --resume auto --reshard auto` process (its reshard event,
              masks of three hosts). D: the wide flash rows of phase 6.
15. mesh   — the lm verb's mesh branches over slots on the card, each
              built by the verb's own setup (cli.lm_setup). (a) A small
              LM (vocab 512, 2 layers, d 256, 4 heads, S 512, batch 8,
              f32, SGD lr 0.01) from one init and one batch stream, 3
              steps of --dp 4, --fsdp on --dp 4, --tp 2, --sp 4 (ring
              attention) and --pipeline-stages 2 --microbatches 4 against
              the single-device port on the card (each loss within 1e-5
              relative, every param within 1e-4 max-abs, the first
              step's change 1e-2); --ep 4 --moe-experts 8 against the port's own EP
              run on the CPU (the capacity is each slot's, so no single
              device matches it): losses 1e-5, first-step gradients
              1e-4, weight changes 1e-2, every token whose router margin
              clears twice its card-CPU shift routed alike. (b) Phase 7's
              full-width LM (bf16 over f32 masters) through --dp 4,
              --fsdp on --dp 4, --tp 2, --tp 4, --sp 4 (under --remat
              full: b4 without it fills the card) and --pipeline-stages 4
              --microbatches 4, and phase 11's MoE row over --ep 4: 3
              steps each, the step median, tokens/s, peak allocated
              memory and the flash launches a step (every branch but
              --sp launches them). (c) The flash kernels at the per-slot
              shapes (1, 8, 4096, 128) and (4, 4, 4096, 128), bf16
              causal, by phase 6's method.
16. rest   — the JAX package's last modules. (a) GoogLeNet b32 (dropout
              0) 20 steps with inception fission on (SPARKNET_FISSION,
              the default) and off from the same weights on the same
              batches, free-running, then in lock step under
              deterministic cuDNN (each step from the on arm's state):
              each loss within 1e-4 relative, every param within 1e-4
              max-abs, each leaf's weight change within 5e-2 of that
              leaf's largest change, but for the rows of an aux-head
              unit whose ReLU took another sign in the two arms at a
              near-tie (a flip at a clear input fails), and two planted
              faults that must fail that check; the port kernels'
              launches equal,
              each arm's step median, convolution kernels a step and
              busy share (a profiler window); a bucket-8 batch served
              under both, within 1e-3 of the largest logit, and each
              arm's bucket-8 forward timed as phase 4 times it. (b) The
              native host library built (available()), its b256
              transform (3x256x256 uint8, 227 crops, mirror) equal to
              the numpy path and the device transform for every mean
              kind, with both host times; the train verb's
              --host-transform feed on phase 9's records (written anew
              when phase 9 does not run) through one Solver, native and
              numpy, step medians over CUDA events
              and the LRN launches; a LevelDB of 2,000 Datums read
              native and in pure Python, with and without crc checks
              (records/s). (c) The lm verb's setup at phase 7's full
              width under --scan off and on, 3 steps each: losses
              within 1e-5 relative, step medians, each flash kernel 12
              times a step. (d) `train --metrics` on a small LMDB
              (cifar10_full b16, the cached feed, 60 iterations): the
              prefetch, h2d_stage and device_cache events with the JAX
              emit sites' fields, read back by the report verb.
    After the phases: the kernel table as one JSON line, an entry for
    every timed f32 row of phase 3 and the LM's flash rows of phase 6,
    bf16 and f32 (launches from the
    serving path for the GoogLeNet forwards, the training path for their
    backwards, the train verb's default device-cached feed of phase 10
    for CaffeNet's LRN shapes, with the local-SGD rounds', the imagenet
    verb's, phase 9's streaming verb's and phase 10's dp verb's beside
    them, phase 10's dp verb for one dp slot's LRN shapes,
    the lm verb's first run for the flash kernels, phase 7's f32 step for
    their f32 row at the LM's width, the lm verb at its defaults for
    the (8, 8, 256, 32) row and the lm verb at d_model 2048 for the
    head_dim-256 rows (bf16, and f32 at the verb's default dtype), with
    the MoE LM's
    verb and in-process launches beside them),
    with phase 12's launches an iteration under each remat policy beside
    them, and phase 13's R0 launches beside the serving kernels'; the
    head_dim 256 and wide (320, 512, 1024) flash rows of phase 6 with the
    LM's; phase 14's two-tier and elastic dp verb launches beside
    CaffeNet's LRN rows; phase 16's: fission on and off beside the
    GoogLeNet rows, the host-transform feed native and numpy beside
    CaffeNet's, --scan off and on beside the flash rows), each phase's wall
    seconds and the total, the nvidia-smi line,
    and as the last line {"ok": true, "device": {...}}.

The kernel table also holds the flash rows of phase 15's per-slot
shapes, launches from the branch that gives the shape, and every
branch's flash launches a step.

Verbs run in child processes that share no files run at the same
time, after their phase's timed work (_beside): phase 5's train verb
beside card against CPU, phase 8's resumed and dp cifar runs, phase
9's imagenet and records verbs, phase 10's two train verbs and
extract_features, phase 12's metrics verb and the three run-safety
children. Each prints its lines in one block.

``python3 chip_smoke.py --phases 12`` (a comma-separated list) runs
phases 1 and 2 and those given (13 brings 4, 10 brings 9, 14 brings 9
and 10), for
development calls: it prints each phase's seconds and no result lines.
With no arguments every phase runs.
"""

import contextlib
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
# H100 SXM dense TF32 (495 TFLOP/s) over the three products of split TF32
# (3xTF32): the f32 flash kernels' rate of f32-accurate products
SPLIT_TF32_OPS_PER_S = 495e12 / 3
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
SEED = 1234
REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_HELD = threading.local()       # the lines of a call that _beside defers


def _say(line):
    """print(line), or, in a call that _beside runs in a thread, keep it
    to print when that call has ended."""
    held = getattr(_HELD, "lines", None)
    if held is None:
        print(line)
    else:
        held.append(line)


def _beside(first, *rest):
    """Runs ``first()`` here and each of ``rest`` (no-argument calls that
    mostly wait on child processes of their own, print only through _say
    and leave stdout and os.environ as they are) in a thread of its own
    at the same time; then prints each of ``rest``'s lines, call after
    call, and returns all the results in order. An error of any call is
    raised once all have ended. For work that shares no files, timed
    section or device measurement: the log reads as if the calls had
    run one after another."""
    def held(call):
        _HELD.lines = []
        try:
            return call(), _HELD.lines, None
        except BaseException as e:      # raised below, after the join
            return None, _HELD.lines, e

    done = [None] * len(rest)

    def run(i):
        done[i] = held(rest[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(rest))]
    for t in threads:
        t.start()
    try:
        out = [first()]
    finally:
        for t in threads:
            t.join()
    for _, lines, _ in done:
        for line in lines:
            print(line)
    for result, _, err in done:
        if err is not None:
            raise err
        out.append(result)
    return out


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

FLASH_SOURCES = ("flash_fwd", "flash_bwd")
_BEHIND = {}      # phase 2's builds that go on behind phases 3-5


def phase_build():
    """Every source, all at once: the LRN and epilogue libraries before
    phase 3; the flash kernels, and beside them their one-pass TF32
    control (cuda_build.TF32_ONE_PASS, phase 6's), behind phases 3-5,
    none of which launches them (_flash_built waits for them)."""
    from sparknet_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()

    def build(key, defines=()):
        try:
            _BEHIND[key] = cuda_build.build(
                FLASH_SOURCES, ptxas_verbose=not defines, defines=defines)
        except Exception as e:          # raised where it is waited for
            _BEHIND[key] = e
    _BEHIND["threads"] = [
        threading.Thread(target=build, args=("flash",)),
        threading.Thread(target=build,
                         args=("control", cuda_build.TF32_ONE_PASS))]
    _BEHIND["t0"] = t0
    for thread in _BEHIND["threads"]:
        thread.start()
    logs = cuda_build.build([n for n in cuda_build.SOURCES
                             if n not in FLASH_SOURCES], ptxas_verbose=True)
    dt = time.perf_counter() - t0
    _print_build(logs)
    print(f"[build] compiled {sorted(logs) or 'nothing (already built)'} "
          f"in {dt:.2f} s into {cuda_build.BUILD_DIR}; the flash kernels "
          "and their one-pass TF32 control build behind phases 3-5")
    return dt


def _print_build(logs):
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"[build] {name}: {line}")


def _flash_built():
    """Wait for phase 2's builds of the flash kernels and their one-pass
    control, once: print their compiler output and raise a failed
    build's error."""
    threads = _BEHIND.pop("threads", None)
    if threads is None:
        return
    t0 = time.perf_counter()
    for thread in threads:
        thread.join()
    logs = {}
    for key in ("flash", "control"):
        got = _BEHIND.pop(key)
        if isinstance(got, Exception):
            raise got
        logs[key] = got
    _print_build(logs["flash"])
    print(f"[build] compiled {sorted(logs['flash']) or 'nothing'} and the "
          f"one-pass TF32 control of {sorted(logs['control']) or 'nothing'}"
          f" {time.perf_counter() - _BEHIND.pop('t0'):.2f} s after phase 2 "
          f"began (waited {time.perf_counter() - t0:.1f} s for them)")


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
            "p50_ms": p50, "profile_b8": profile, "prefix": prefix}


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
        _say(f"[train-cli] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    _say(f"[train-cli] exited 0 in {time.perf_counter() - t0:.1f} s")
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
    time and a profiler window."""
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
    return {"launches": launches, "fixed_batch_losses": losses,
            "step_ms": step_ms, "images_per_s": ips, "profile": profile}


def phase_train_all(torch, card, tmp):
    """phase_train, then card against CPU beside the train verb's
    children (phase_train_cli) -> (the verb's results, phase_train's
    with "card_vs_cpu")."""
    trained = phase_train(torch, card, tmp)
    trained["card_vs_cpu"], verb = _beside(
        lambda: _card_vs_cpu(torch, tmp), lambda: phase_train_cli(tmp))
    return verb, trained


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
    (spills), dynamic shared memory, resident CTAs per SM, the cluster
    size (1: none) and the clusters that fit on the card at once
    (cudaOccupancyMaxActiveClusters; the three kernels past head_dim
    256). Fails if any instantiation uses local memory (spills), or a
    backward kernel on wgmma (bf16 up to head_dim 128, _bf16_bwd_design;
    f32 at 64 and 128, _f32_bwd_design; f32 at 256 in clusters of two,
    _f32_bwd256_design) or the f32 forward on wgmma (32 to 128,
    _f32_fwd_design; 256 in clusters of two, _f32_fwd256_design) is not
    as it was built: 384 threads (a producer and two consumer
    warpgroups) at 168 registers, its shared memory, one CTA an SM (and
    its cluster size)."""
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
            for d in ca.HEAD_DIMS + WIDE_DIMS:
                out = (ctypes.c_int * 6)()
                err = query(code, ca.built_head_dim(d),
                            ctypes.cast(out, ctypes.c_void_p))
                check(err == 0, f"the info query of {name} ({code}, {d}) "
                                f"returned cudaError {err}")
                r = info[name, dname, d] = dict(
                    registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                    ctas_per_sm=out[3], cluster_size=out[4],
                    max_active_clusters=out[5])
                print(f"[flash] {name} {dname} D={d}: {out[0]} registers, "
                      f"{out[1]} bytes local (spills), {out[2]} bytes "
                      f"shared, {out[3]} CTAs per SM"
                      + (f", clusters of {out[4]}, {out[5]} co-resident"
                         if out[4] > 1 else ""))
                check(r["local_bytes"] == 0,
                      f"{name} {dname} D={d} uses local memory: {r}")
                check(out[4] == 1 or out[5] > 0,
                      f"{name} {dname} D={d}: no cluster of {out[4]} fits")
                built = ca.built_head_dim(d)
                f32 = dtype == torch.float32
                if name == "flash_attention":
                    design = _f32_fwd_design \
                        if f32 and built in F32_FWD_WGMMA_DIMS \
                        else _f32_fwd256_design if f32 and built == 256 \
                        else None
                else:
                    design = _bf16_bwd_design if not f32 and built <= 128 \
                        else _f32_bwd_design \
                        if f32 and built in F32_WGMMA_DIMS \
                        else _f32_bwd256_design if f32 and built == 256 \
                        else None
                if design is not None:
                    want = design(name, built)
                    got = {key: r[key] for key in want}
                    check(got == want, f"{name} {dname} D={d} reads {got}, "
                          f"built for {want}")
    return info


def _bf16_bwd_design(name, d):
    """What the runtime should say of the bf16 dQ or dK/dV kernel
    (``name``) at a built head_dim ``d`` <= 128 (csrc/flash_bwd.cu,
    BwdTiles): 384 threads at launch_bounds(384, 1) leave 168 registers
    a thread (the consumers take 240 through setmaxnreg); shared memory
    for the CTA's own 128-row pair, three stages of the streamed 64-row
    pair, 64 bytes of mbarriers and 1024 to align the tiles, and in
    dK/dV each stage's 64 f32 LSE and delta rows; one CTA an SM."""
    rows = 3 * 2 * 64 * 4 if name == "flash_attention_dkv" else 0
    return {"registers": 168,
            "smem_bytes": 2 * 128 * d * 2 + 3 * 2 * 64 * d * 2 + 64 + 1024
            + rows,
            "ctas_per_sm": 1}


# the f32 backward's head_dims on wgmma (flash_dq_tf32_wgmma_kernel,
# flash_dkv_tf32_wgmma_kernel); the others run split TF32 on mma.sync
F32_WGMMA_DIMS = (64, 128)


def _f32_bwd_design(name, d):
    """What the runtime should say of the f32 dQ or dK/dV kernel on wgmma
    (``name``) at a head_dim ``d`` of F32_WGMMA_DIMS (csrc/flash_bwd.cu,
    Tf32WgTiles): 384 threads at launch_bounds(384, 1) leave 168
    registers a thread (the consumers take 240 through setmaxnreg);
    shared memory in dQ for six 64-row f32 tiles (Q, dO and their lo
    parts, K, V), the 64 x 64 dS^T handoff hi and lo, 512 bytes of LSE
    and delta, 64 of mbarriers and 1024 to align the tiles; in dK/dV
    for K and V, two stages of a 32-query tile's Q, dO and their lo
    parts, the 64 x 32 P^T and dS^T handoffs hi and lo, mbarriers and
    alignment; one CTA an SM."""
    tile = 64 * d * 4
    smem = 6 * tile + 2 * 64 * 64 * 4 + 512 if name == "flash_attention_dq" \
        else 2 * tile + 2 * 4 * 32 * d * 4 + 4 * 64 * 32 * 4
    return {"registers": 168, "smem_bytes": smem + 64 + 1024,
            "ctas_per_sm": 1}


def _f32_bwd256_design(name, d=256):
    """What the runtime should say of the f32 dQ or dK/dV kernel at
    head_dim 256 (``name``; csrc/flash_bwd.cu, Tf32ClusterTiles), each
    CTA of a cluster of two owning 128 columns: 384 threads at
    launch_bounds(384, 1) leave 168 registers a thread; shared memory in
    dQ for a 32-query tile's Q, dO and their lo parts, two stages of a
    64-key tile's K and V, the 32 x 64 dS^T handoff hi and lo, four
    exchange buffers of 8 f32 a warpgroup thread (P^T from warpgroup 0 to
    1; the other rank's S^T and dP^T partials and dS^T), 256 bytes of
    LSE and delta, 128 of mbarriers and 1024 to align the tiles; in dK/dV
    for K and V, two stages of a 32-query tile's Q and dO, the lo parts
    of one, the 64 x 32 P^T and dS^T handoffs hi and lo, four exchange
    buffers (the other rank's partials, P^T and dS^T), mbarriers and
    alignment; one CTA an SM, clusters of two."""
    cols, xch = d // 2, 2 * 128 * 16
    qtile, ktile, hand = 32 * cols * 4, 64 * cols * 4, 64 * 32 * 4
    smem = 4 * qtile + 4 * ktile + 2 * hand + 4 * xch + 256 \
        if name == "flash_attention_dq" \
        else 2 * ktile + 6 * qtile + 4 * hand + 4 * xch
    return {"registers": 168, "smem_bytes": smem + 128 + 1024,
            "ctas_per_sm": 1, "cluster_size": 2}


# the f32 forward's head_dims on wgmma (flash_fwd_tf32_wgmma_kernel); 256
# runs on wgmma in clusters of two (flash_fwd_tf32_wgmma256_kernel), 16
# split TF32 on mma.sync
F32_FWD_WGMMA_DIMS = (32, 64, 128)


def _f32_fwd_design(name, d):
    """What the runtime should say of the f32 forward on wgmma at a
    head_dim ``d`` of F32_FWD_WGMMA_DIMS (csrc/flash_fwd.cu,
    Tf32WgFwdTiles; ``name`` is the forward's): 384 threads at
    launch_bounds(384, 1) leave 168 registers a thread (the consumers
    take 232 through setmaxnreg, the producer 40); shared memory for the
    CTA's 128 queries, a 64-key tile of K, its lo and V as TMA lands them,
    V^T hi and lo (d rows of 64 keys), 64 bytes of mbarriers and 1024 to
    align the tiles; one CTA an SM."""
    return {"registers": 168,
            "smem_bytes": 128 * d * 4 + 3 * 64 * d * 4 + 2 * d * 64 * 4
            + 64 + 1024,
            "ctas_per_sm": 1}


def _f32_fwd256_design(name, d=256):
    """What the runtime should say of the f32 forward at head_dim 256
    (csrc/flash_fwd.cu, Tf32ClusterFwdTiles; ``name`` is the forward's),
    each CTA of a cluster of two owning 128 columns: 384 threads at
    launch_bounds(384, 1) leave 168 registers a thread (the consumers
    take 232 through setmaxnreg, the producer 40); shared memory for the
    cluster's 64 queries, a 64-key tile of K, its lo and V as TMA lands
    them, V^T hi and lo (128 rows of 64 keys), the received partial
    scores (16 f32 a thread of warpgroup 0), P (32 f32 a thread of
    warpgroup 1), alpha and l (2 f32 a thread each), 128 bytes of
    mbarriers and 1024 to align the tiles; one CTA an SM, clusters of
    two."""
    cols, threads = d // 2, 128
    tile = 64 * cols * 4
    smem = 6 * tile + (16 + 32 + 2 + 2) * threads * 4
    return {"registers": 168, "smem_bytes": smem + 128 + 1024,
            "ctas_per_sm": 1, "cluster_size": 2}


def _kernel_name(name, dtype, d):
    """The CUDA kernel of a flash wrapper (``name``) at a storage
    ``dtype`` and head_dim ``d`` up to 256 (csrc/flash_fwd.cu,
    csrc/flash_bwd.cu), or None (past 256: csrc/flash_wide.cuh)."""
    from sparknet_tpu_torch.ops import cuda_attention as ca
    d = ca.built_head_dim(d)
    if d > 256:
        return None
    if name == "flash_attention":
        if dtype == "bfloat16":
            return "flash_fwd_wgmma256_kernel" if d == 256 else \
                f"flash_fwd_wgmma_kernel<{d}>"
        return f"flash_fwd_tf32_wgmma_kernel<{d}>" \
            if d in F32_FWD_WGMMA_DIMS \
            else "flash_fwd_tf32_wgmma256_kernel" if d == 256 \
            else f"flash_fwd_tf32_kernel<{d}>"
    which = "dq" if name == "flash_attention_dq" else "dkv"
    if dtype == "bfloat16":
        return f"flash_{which}_wgmma256_kernel" if d == 256 else \
            f"flash_{which}_wgmma_kernel<{d}>"
    return f"flash_{which}_tf32_wgmma_kernel<{d}>" if d in F32_WGMMA_DIMS \
        else f"flash_{which}_tf32_wgmma256_kernel" if d == 256 \
        else f"flash_{which}_tf32_kernel<{d}>"


# head_dims past 256 (the wide kernels, one instantiation for every D)
WIDE_DIMS = (320, 512, 1024)
# (shape, dtype, causal, a row of the kernels line): phase 6's cases
FLASH_CASES = (
    ((2, 4, 1024, 64), "float32", False, False),
    ((2, 4, 1024, 64), "float32", True, False),
    ((2, 4, 1024, 128), "bfloat16", False, False),
    ((2, 4, 1024, 64), "bfloat16", True, False),
    # head_dim 96 is not built: zero-padded to 128
    ((2, 4, 1024, 96), "bfloat16", True, False),
    # head_dim 256, the widest of the tiled kernels, and 192, zero-padded
    # to it
    *(((1, 4, 1024, d), dt, causal, d == 256)
      for d in (256, 192) for dt in ("float32", "bfloat16")
      for causal in (False, True)),
    # past 256: the wide kernels
    *(((1, 4, 1024, d), dt, causal, True)
      for d in WIDE_DIMS for dt in ("float32", "bfloat16")
      for causal in (False, True)),
    ((4, 8, 4096, 128), "bfloat16", True, True),
    # S not a multiple of 128: the bf16 backward's last 128-row tile is
    # 104 rows, its second warpgroup 40 of them; the f32 dQ's last 64-row
    # tile 40 rows, the f32 dK/dV's last 32-query tile 8
    ((1, 4, 1000, 128), "bfloat16", True, False),
    ((1, 4, 1000, 128), "float32", True, False),
    # head_dim 256 at the attention shape of the lm verb's d_model 2048, 8
    # heads (LM_D256): the card-filling row of the head_dim-256 kernels
    ((2, 8, 4096, 256), "bfloat16", True, True),
    # f32, the lm verb's default dtype: the LM's full width, and the
    # verb's default widths (vocab 512, S 256, b 8, d 256, 8 heads)
    ((4, 8, 4096, 128), "float32", True, True),
    ((8, 8, 256, 32), "float32", True, True),
    # the attention of lm --d-model 2048 --heads 8 at the verb's default
    # dtype (phase 7's f32 LM_D256 run): the f32 head_dim-256 kernels at
    # a card-filling shape
    ((2, 8, 4096, 256), "float32", True, True))
# the kernels line's launches for a flash row: the path that gives its
# shape (the lm verb's bf16 run for the rest)
FLASH_ROW_PATHS = {((4, 8, 4096, 128), "float32"): "lm step, f32",
                   ((8, 8, 256, 32), "float32"): "lm verb, defaults (f32)",
                   ((1, 4, 1024, 256), "bfloat16"): "lm verb, d_model 2048",
                   ((2, 8, 4096, 256), "bfloat16"): "lm verb, d_model 2048",
                   ((1, 4, 1024, 256), "float32"):
                       "lm verb, d_model 2048, f32",
                   ((2, 8, 4096, 256), "float32"):
                       "lm verb, d_model 2048, f32"}


def flash_entry_points(libs=None, defines=()):
    """The flash kernels' three C entry points, their argument types set:
    {"fwd", "dq", "dkv"} from ``libs`` ({"flash_fwd": CDLL, "flash_bwd":
    CDLL}, another tree's build), or else from this tree's sources built
    with the macros ``defines``."""
    import ctypes
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.ops import cuda_build
    fns = {}
    for key, source, symbol, argtypes in (
            ("fwd", "flash_fwd", "sparknet_flash_forward", ca._FWD_ARGTYPES),
            ("dq", "flash_bwd", "sparknet_flash_backward_dq",
             ca._BWD_ARGTYPES),
            ("dkv", "flash_bwd", "sparknet_flash_backward_dkv",
             ca._BWD_ARGTYPES)):
        if libs is None:
            fns[key] = cuda_build.function(source, symbol, argtypes, defines)
        else:
            fn = getattr(libs[source], symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[key] = fn
    return fns


def flash_calls(torch, fns, q, k, v, do, o, lse, delta, causal):
    """No-argument calls of one set of flash entry points on these
    (B, H, S, D) inputs, zero-padded to the head_dim this tree's wrappers
    pad them to: {"fwd": -> (O, LSE), "dq": -> (dQ, delta), "dkv": ->
    (dK, dV)}, the backward on the given O, LSE and delta."""
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.ops import cuda_build
    b, h, s, d = q.shape
    scale = ca.default_scale(q)

    qp, kp, vp, op, dop = (t.contiguous() for t in ca.pad_head_dim(
        (q, k, v, o, do), ca.built_head_dim(d)))
    code = cuda_build.DTYPE_CODES[q.dtype]
    stream = cuda_build.stream_handle(q.device)

    def launch(what, fn, *tensors):
        err = fn(*(t.data_ptr() for t in tensors), code, b * h, s,
                 tensors[0].shape[-1], scale, int(causal), stream)
        check(err == 0, f"flash {what} launch failed: cudaError {err}")

    def fwd():
        out = torch.empty_like(qp)
        rows = torch.empty(b * h, s, device=q.device)
        launch("forward", fns["fwd"], qp, kp, vp, out, rows)
        return out[..., :d], rows

    def dq():
        out = torch.empty_like(qp)
        rows = torch.empty(b * h, s, device=q.device)
        launch("dQ", fns["dq"], qp, kp, vp, op, dop, lse, out, rows)
        return out[..., :d], rows

    def dkv():
        dk, dv = torch.empty_like(kp), torch.empty_like(vp)
        launch("dK/dV", fns["dkv"], qp, kp, vp, dop, lse, delta, dk, dv)
        return dk[..., :d], dv[..., :d]
    return {"fwd": fwd, "dq": dq, "dkv": dkv}


# The f32 limits of the largest element (tests/test_flash.py's): the
# one-pass TF32 control must read over O's, and over dQ's or its tile's
F32_ELEMENT_LIMIT = {"O": 2e-5, "dQ": 5e-4, "dK": 5e-4, "dV": 5e-4}


def _split_tf32_checks(torch, what, q, k, v, do, causal, kern, refs):
    """The f32 kernels' own checks at one case: each kernel launched
    again on the same inputs gives bitwise the same outputs, and the
    one-pass TF32 build of the same sources (cuda_build.TF32_ONE_PASS:
    the lo terms left out) reads over the f32 O limit in the forward and
    over a dQ limit in the backward. ``kern``: the wrappers' O, LSE, dQ,
    delta, dK, dV; ``refs``: the plain versions' O, dQ, dK, dV."""
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.ops import cuda_build
    o, lse, delta = kern["O"], kern["LSE"], kern["delta"]
    again = dict(zip(("O", "LSE"), ca.flash_attention_fwd(q, k, v, causal)))
    again.update(zip(("dQ", "delta"), ca.flash_attention_dq(
        q, k, v, o, lse, do, causal)))
    again.update(zip(("dK", "dV"), ca.flash_attention_dkv(
        q, k, v, do, lse, delta, causal)))
    for name, t in again.items():
        check(torch.equal(t, kern[name]),
              f"f32 {name} at {what}: two launches on the same inputs "
              "differ")
    calls = flash_calls(torch, flash_entry_points(
        defines=cuda_build.TF32_ONE_PASS), q, k, v, do, o, lse, delta,
        causal)
    got = {"O": calls["fwd"]()[0], "dQ": calls["dq"]()[0]}
    got.update(zip(("dK", "dV"), calls["dkv"]()))
    torch.cuda.synchronize()
    out = {}
    for name, t in got.items():
        out[name] = {"max_rel_err": _rel_err(t, refs[name]),
                     "tile_err": _tile_err(torch, t, refs[name])}
        print(f"[flash]   one-pass TF32 control, {name} {what}: worst tile "
              f"{out[name]['tile_err']:.3e} (limit 1e-4), of the largest "
              f"element {out[name]['max_rel_err']:.3e} (limit "
              f"{F32_ELEMENT_LIMIT[name]:g})")
    check(out["O"]["max_rel_err"] > F32_ELEMENT_LIMIT["O"],
          f"the one-pass TF32 control's O at {what} reads "
          f"{out['O']['max_rel_err']:.3e}, within the f32 limit: the check "
          "would not tell one TF32 pass from split TF32")
    check(out["dQ"]["max_rel_err"] > F32_ELEMENT_LIMIT["dQ"]
          or out["dQ"]["tile_err"] > FLASH_BWD_TILE_LIMIT["float32"],
          f"the one-pass TF32 control's dQ at {what} reads {out['dQ']}, "
          "within the f32 limits")
    print(f"[flash] f32 {what}: O, LSE, dQ, delta, dK, dV bitwise equal "
          "over two launches")
    return {"bitwise_repeat": True, "one_pass_control": out}


def phase_flash_kernels(torch, cases=FLASH_CASES):
    """The forward, dQ and dK/dV kernels against their plain versions on
    the same inputs (the backward kernels take the kernel forward's O and
    LSE, dK/dV the dQ kernel's delta), the planted faults, the library's
    own backward read at the same measure against the same references,
    times, achieved TFLOP/s, bounds and the library call; and each flash
    kernel's registers, spills, shared memory and CTAs per SM."""
    import torch.nn.functional as F
    from sparknet_tpu_torch.ops import cuda_attention as ca
    _flash_built()
    info = _flash_kernel_info(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timers = {False: Timer(torch), True: Timer(torch, reps=10)}
    results = []
    for shape, dtype, causal, row in cases:
        timer = timers[shape[-1] > ca.HEAD_DIMS[-1]]   # the wide kernels
        dtype = getattr(torch, dtype)
        q, k, v, do = ((0.5 * torch.randn(shape, generator=gen,
                                          device="cuda")).to(dtype)
                       for _ in range(4))
        b, h, s, d = shape
        f32 = dtype == torch.float32
        dname = str(dtype).replace("torch.", "")
        what = f"{list(shape)} {dname} causal={causal}"
        wide = d > ca.HEAD_DIMS[-1]
        # f32: the rate of f32-accurate products on the tensor cores
        peak = SPLIT_TF32_OPS_PER_S if f32 else BF16_TENSOR_OPS_PER_S
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
            n0 = {n: getattr(ca, n).launches for n in FLASH_KERNELS}
            o, lse = ca.flash_attention_fwd(q, k, v, causal)
            dq, delta = ca.flash_attention_dq(q, k, v, o, lse, do, causal)
            dk, dv = ca.flash_attention_dkv(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            launched = {n: getattr(ca, n).launches - n0[n]
                        for n in FLASH_KERNELS}
            check(all(c == 1 for c in launched.values()),
                  f"flash at {what}: the wrappers counted {launched}, want "
                  "one launch each")
            if not f32 and not wide:
                # the bf16 wgmma kernels: no atomics, one thread sums
                # each output element in a fixed order
                again = ca.flash_attention_fwd(q, k, v, causal)
                again += ca.flash_attention_dq(q, k, v, o, lse, do, causal)
                again += ca.flash_attention_dkv(q, k, v, do, lse, again[3],
                                                causal)
                for label, a, b in zip(("O", "LSE", "dQ", "delta", "dK",
                                        "dV"), again,
                                       (o, lse, dq, delta, dk, dv)):
                    check(torch.equal(a, b), f"bf16 {label} at {what}: two "
                          "launches on the same inputs differ")
                print(f"[flash] bf16 {what}: O, LSE, dQ, delta, dK, dV "
                      "bitwise equal over two launches")
                readings["bitwise_repeat"] = True
                del again
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
            if f32:
                readings["split_tf32"] = _split_tf32_checks(
                    torch, what, q, k, v, do, causal,
                    {"O": o, "LSE": lse, "dQ": dq, "delta": delta, "dK": dk,
                     "dV": dv}, {"O": ro, "dQ": rdq, "dK": rdk, "dV": rdv})
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
                r["bound_share"] = r["bound_ms"] / r["ms"]
                r["launches_phase6"] = launched[name]
                kernel_name = _kernel_name(name, dname, d)
                if kernel_name:
                    r["kernel"] = kernel_name
                if wide:
                    r["source"] = "sparknet_tpu_torch/csrc/flash_wide.cuh"
                if "split_tf32" in readings:
                    r["split_tf32"] = readings["split_tf32"]
                if "bitwise_repeat" in readings:
                    r["bitwise_repeat"] = True
                print(f"[flash] {name} {what}: "
                      + (f"{kernel_name} " if kernel_name else "")
                      + f"kernel {r['ms']:.4f} ms "
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


def _lm_in_process(args, tag, full_width=True, widths=None, dtype="bf16"):
    """The lm verb at full width (LM_FULL, or ``widths``) in ``dtype``
    (None: the verb's default, f32), bf16 by default (or, with
    full_width False, at the verb's own defaults), in this process (no
    interpreter start): the launch counters zeroed first and the
    variables its flags write put back after; -> (stdout, its launch
    counts)."""
    import io
    from sparknet_tpu_torch import cli
    f = widths or LM_FULL
    sizes = ["--vocab", str(f["vocab"]), "--seq-len", str(f["seq_len"]),
             "--batch", str(f["batch"]), "--d-model", str(f["d_model"]),
             "--layers", str(f["layers"]), "--heads", str(f["heads"]),
             *(["--dtype", dtype] if dtype else [])] if full_width else []
    argv = ["lm", *sizes, "--display", "1", *args]
    env = dict(os.environ)
    _zero_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        os.environ.clear()
        os.environ.update(env)
    out = buf.getvalue()
    for line in out.strip().splitlines():
        print(f"[{tag}] {line}")
    check(rc == 0, f"lm {' '.join(args)} returned {rc}")
    print(f"[{tag}] returned 0 in {time.perf_counter() - t0:.1f} s")
    last = out.strip().splitlines()[-1]
    check(last.startswith("Kernel launches: "),
          f"the lm verb's last line is not its launch counts: {last}")
    return out, json.loads(last[len("Kernel launches: "):])


def _losses(out):
    return {int(l.split()[1].rstrip(",")): float(
        l.split("loss = ")[1].split(",")[0])
        for l in out.splitlines() if l.startswith("Iteration ")}


def phase_lm_cli(tmp):
    """The lm verb at full width, in process (phase 15 starts it as a
    child): 3 steps with a snapshot at 3, then --resume from it to 5.
    Each flash kernel must launch exactly
    ``layers`` times per step in each run, the resumed run must start
    at iteration 3, and the loss must fall from about ln(vocab)."""
    prefix = os.path.join(tmp, "lm")
    layers = LM_FULL["layers"]
    out1, counts1 = _lm_in_process(["--steps", "3", "--snapshot-every",
                                    "3", "--snapshot-prefix", prefix],
                                   "lm-cli")
    check(os.path.exists(f"{prefix}_iter_3.solverstate"),
          "no lm snapshot at iteration 3")
    out2, counts2 = _lm_in_process(["--steps", "5", "--resume",
                                    f"{prefix}_iter_3.solverstate"],
                                   "lm-cli")
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


def phase_lm_step(torch, card, steps=3, dtype="bf16"):
    """In process at full width, bf16 activations over f32 masters or
    f32 throughout (the lm verb's default dtype: no compute dtype, TF32
    off): launches per step, the train step time (median of 5, CUDA
    events, device-resident batch), tokens/s, peak memory and a profiler
    window with the flash kernels' share of its device time."""
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
                    compute_dtype=torch.bfloat16 if dtype == "bf16"
                    else None)
    if dtype == "f32":
        check(not torch.backends.cuda.matmul.allow_tf32
              and not torch.backends.cudnn.allow_tf32,
              "the f32 Solver left TF32 on")
    n_params = sum(p.numel() for v in solver.params.values() for p in v)
    stream, _ = lm_batch_stream(f["vocab"], f["batch"], f["seq_len"],
                                seed=SEED)
    feed = {k: torch.as_tensor(v).cuda() for k, v in next(stream).items()}
    float(solver.train_step(feed))              # warm-up: cuBLAS plans
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    losses = [float(solver.train_step(feed)) for _ in range(steps)]
    launches = kernel_launches()
    print(f"[lm] {dtype} in process, {steps} steps on one batch: losses "
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
          f"S{f['seq_len']} {dtype} train step {step_ms:.3f} ms (median of "
          f"5, CUDA events), {tps:,.0f} tokens/s, peak memory "
          f"{peak_gb:.1f} GB; {card}")
    profile = _profile(torch, lambda: solver.train_step(feed), 2, _lm_group,
                       f"full-width LM train step, {dtype}", card, top=12)
    flash_share = None
    if profile is not None:
        flash_share = profile["groups_ms"].get(
            "port attention kernels (flash_*)", 0.0) / \
            profile["device_ms_per_call"]
        print(f"[lm] {dtype}: the flash kernels take {100 * flash_share:.1f}%"
              " of the window's device time")
    del solver, feed
    torch.cuda.empty_cache()
    return {"dtype": dtype, "params": n_params, "launches": launches,
            "losses": losses, "step_ms": step_ms, "tokens_per_s": tps,
            "peak_gb": peak_gb, "profile": profile,
            "flash_share": flash_share}


def phase_lm_default_verb(steps=2):
    """The lm verb at its defaults (vocab 512, S 256, b 8, d 256, 4
    layers, 8 heads, f32) in process for ``steps`` steps: each flash
    kernel ``layers`` times a step at (8, 8, 256, 32) f32 causal."""
    out, launches = _lm_in_process(["--steps", str(steps)], "lm-default",
                                   full_width=False)
    check(f"done: {steps} steps, " in out, f"lm verb: not {steps} steps")
    for name in FLASH_KERNELS:
        check(launches[name] == 4 * steps,
              f"lm at its defaults: {name} launched {launches[name]} times "
              f"in {steps} steps of 4 layers")
    return {"launches": launches, "losses": _losses(out)}


# The lm verb's path to the head_dim-256 flash kernels: Gemma 2B's
# attention width and head count (google/gemma-2b's config: hidden 2048,
# 8 heads of head_dim 256; the port has no grouped KV heads and runs its
# one KV head as full heads), cut to 2 layers at batch 2
LM_D256 = dict(vocab=8192, seq_len=4096, batch=2, d_model=2048, layers=2,
               heads=8)


def phase_lm_d256(steps=2, dtype="bf16"):
    """The lm verb at LM_D256 in process for ``steps`` steps, bf16 or, with
    ``dtype`` None, at the verb's default dtype (f32, TF32 left off for
    the library's products): each flash kernel ``layers`` times a step at
    (2, 8, 4096, 256) causal, and the first loss finite and within 1.5 of
    ln(vocab)."""
    import torch
    f = LM_D256
    out, launches = _lm_in_process(["--steps", str(steps)],
                                   "lm-d256" if dtype else "lm-d256-f32",
                                   widths=f, dtype=dtype)
    check(f"done: {steps} steps, " in out, f"lm verb: not {steps} steps")
    if dtype is None:
        check(not torch.backends.cuda.matmul.allow_tf32
              and not torch.backends.cudnn.allow_tf32,
              "the lm verb at its default dtype left TF32 on")
    for name in FLASH_KERNELS:
        check(launches[name] == f["layers"] * steps,
              f"lm at d_model 2048: {name} launched {launches[name]} times "
              f"in {steps} steps of {f['layers']} layers, want "
              f"{f['layers'] * steps}")
    losses = _losses(out)
    ln_v = float(np.log(f["vocab"]))
    check(np.isfinite(losses[0]) and abs(losses[0] - ln_v) < 1.5,
          f"lm at d_model 2048: first loss {losses[0]:.4f} is not about "
          f"ln(vocab) = {ln_v:.4f}")
    return {"launches": launches, "losses": losses}


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
        _say(f"[cifar-cli] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    _say(f"[cifar-cli] exited 0 in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def _round_losses(out):
    return [float(line.split(": loss = ")[1]) for line in out.splitlines()
            if ": loss = " in line]


def phase_cifar_cli(tmp):
    """The cifar verb on the card, at CifarApp's own settings
    (cifar10_full, per-worker batch 100, tau 10, the zoo solver) over 4
    worker slots, on 10,000 + 1,000 records from make_synth_cifar: 6
    rounds with a test every 3 and a snapshot every 3, then --resume
    auto for 2 more (the counter continues from 60) and, beside it,
    --strategy dp for 2 steps."""
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
    # the resumed run and the dp run share no file: they run together
    out2, out3 = _beside(
        lambda: _cifar_cli(common + ["--tau", "10", "--rounds", "2",
                                     "--test-every", "5", "--snapshot-prefix",
                                     prefix, "--resume", "auto"]),
        lambda: _cifar_cli(common + ["--strategy", "dp", "--rounds", "2",
                                     "--test-every", "5"]))
    check("resume auto: restored iter 60" in out2,
          "--resume auto did not pick up the iteration-60 snapshot")
    check("done: 2 rounds, iter=80" in out2,
          "the resumed run did not continue from iteration 60 to 80")
    resumed = _round_losses(out2)
    check(len(resumed) == 2 and all(np.isfinite(resumed)),
          f"resumed round losses {resumed}")
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


def _synthetic_rounds(torch, tau, workers, batch, shape, classes, seed,
                      device="cuda"):
    """A round's batches made on the card: N(0, 1) images and uniform
    labels, (tau, workers*batch, ...)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = workers * batch
    return {"data": torch.randn((tau, n) + tuple(shape), generator=gen,
                                device=device),
            "label": torch.randint(0, classes, (tau, n), generator=gen,
                                   device=device, dtype=torch.int32)}


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
    consensus = dpm.masked_consensus
    try:
        dpm.masked_consensus = lambda stacked, valid: (
            {n: [P[0].clone() for P in ps] for n, ps in stacked.items()},
            valid.sum())
        _, control = run("control, slot 0 in place of the average")
    finally:
        dpm.masked_consensus = consensus
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
IMAGENET_TAU, IMAGENET_ROUNDS = 1, 1   # the time budget (C10)


def _class_gaussian_uint8(n, classes, device=None):
    """n class-gaussian images of RECORD_SHAPE as uint8 (the ImageNet
    app's synthetic images: a unit-normal prototype per class, twice it
    plus unit noise, scaled by 32 about 128), and their labels, drawn
    from SEED on the card where there is one (numpy takes ~35 s for
    phase 9's 3,072 on one host thread)."""
    import torch
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    gen = torch.Generator(device=device).manual_seed(SEED)
    protos = torch.randn((classes,) + RECORD_SHAPE, generator=gen,
                         device=device)
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    images = torch.empty((n,) + RECORD_SHAPE, dtype=torch.uint8)
    for lo in range(0, n, 256):
        hi = min(n, lo + 256)
        x = 2.0 * protos[labels[lo:hi]] + torch.randn(
            (hi - lo,) + RECORD_SHAPE, generator=gen, device=device)
        images[lo:hi] = (x * 32 + 128).clamp(0, 255).to(torch.uint8).cpu()
    return images.numpy(), labels.cpu().numpy().astype(np.int32)


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
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.proto import Message, text_format
    t0 = time.perf_counter()
    images, labels = _class_gaussian_uint8(DB_TRAIN + DB_TEST, 1000)
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
        _say(f"[db-cli] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    _say(f"[db-cli] exited 0 in {wall:.1f} s")
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
    IMAGENET_ROUNDS rounds, a test at round 0 (the app's centre crops
    through the slots' test()). Every synthetic batch makes 1,000 fresh
    class prototypes on the host (the round's 16 batches of 64 images
    take most of the verb's time), hence tau 1. Round losses must be
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
        _say(f"[imagenet-cli] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    _say(f"[imagenet-cli] exited 0 in {wall:.1f} s")
    rounds = [l for l in out.stdout.splitlines() if ": loss = " in l]
    losses = [float(l.split(": loss = ")[1].split(",")[0]) for l in rounds]
    rates = [float(l.rsplit(", ", 1)[1].split()[0]) for l in rounds]
    check(len(losses) == IMAGENET_ROUNDS and all(np.isfinite(losses)),
          f"imagenet round losses {losses}")
    tests = [float(l.split(" = ")[1]) for l in out.stdout.splitlines()
             if "round 0: test accuracy = " in l]
    check(len(tests) == 1 and 0 <= tests[0] <= 1,
          f"imagenet round 0 test accuracy {tests}")
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
    steps = phase_record_steps(torch, card, db, solver_path)
    # two verbs in children of their own, after the timed steps
    imagenet, cli_out = _beside(phase_imagenet_cli,
                                lambda: phase_db_cli(tmp, solver_path))
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
        _say(f"[{tag}] {line}")
    check(out.returncode == 0,
          f"{' '.join(cmd)} exited {out.returncode}: {out.stderr[-4000:]}")
    wall = time.perf_counter() - t0
    _say(f"[{tag}] exited 0 in {wall:.1f} s")
    return out.stdout, wall


def phase_feeds_cli(solver_path, card, device="cuda", beside=()):
    """The train verb on phase 9's CaffeNet records for FEED_ITERS
    iterations, two ways at once: default flags (the records go to the
    card once: `device-cached`) and `--strategy dp --mesh data=4` (4
    slots x 64, streaming, as the JAX verb's dp), with the calls of
    ``beside`` (see _beside) run with them; phase 9's verb run streams
    them (SPARKNET_DEVICE_CACHE_MB=0). Each loss must be finite and the
    LRN kernels (norm1, norm2) must launch twice a step and slot,
    forward and backward. -> (results, the results of ``beside``)."""
    modes = (("cached", (), "device-cached", 1),
             ("dp", ("--strategy", "dp", "--mesh", f"data={DP_SLOTS}"),
              "device-transform", DP_SLOTS))
    runs = _beside(*(lambda name=name, extra=extra: _train_verb(
        solver_path, f"feeds-cli {name}", (*extra, "--device", device),
        {"SPARKNET_DEVICE_CACHE_MB": None})
        for name, extra, _, _ in modes), *beside)
    out = {}
    for (name, _, kind, slots), (stdout, wall) in zip(modes, runs):
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
    return out, runs[len(modes):]


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
        _say(f"[extract] {line}")
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
    _say(f"[extract] fc7 of {len(keys)} TEST records in {wall:.1f} s; first "
          f"batch against a forward on the card: max abs difference {err:g} "
          f"of max |fc7| {scale:g} (limit {FEATURE_LIMIT:g} of it); {card}")
    check(scale > 0, "fc7 is all zero: the comparison would say nothing")
    check(err <= FEATURE_LIMIT * scale,
          f"extract_features' fc7 differs from the forward by {err}")
    return {"datums": len(keys), "max_abs_err": err, "max_abs_fc7": scale,
            "wall_s": wall}


def phase_feeds_all(torch, card, tmp, db, solver_path):
    t0 = time.perf_counter()
    steps, weights = phase_feed_steps(torch, card, db, solver_path)
    pack = phase_pack(torch, card, tmp,
                      os.path.join(db, "mean.binaryproto"))
    cifar = phase_cifar_feeds(torch, card, tmp)
    # the verbs and the extract tool in children of their own, after the
    # timed feeds
    cli_out, (extract,) = phase_feeds_cli(
        solver_path, card, beside=(lambda: phase_extract_features(
            torch, card, db, weights),))
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
    experts (F 4096, capacity factor 1.25) in every block, bf16, in
    process, for MOE_STEPS steps: finite losses, each flash kernel
    ``layers`` times a step."""
    layers = LM_FULL["layers"]
    out, counts = _lm_in_process(["--steps", str(MOE_STEPS),
                                  "--moe-experts", str(MOE_EXPERTS),
                                  "--moe-aux-weight", str(MOE_AUX_WEIGHT)],
                                 "moe-cli")
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



# A ReLU input of the MoE's expert FFN within rounding of zero can take
# one sign on the card and the other on the CPU, a near-tie of the same
# kind as the router's, and that one unit moves its expert's w1 gradient
# by ~1e-3 of the blob (1.365e-03 at block1/moe[1] in phase 11). So the
# CPU reference takes the card's decision only at a near-tie, by a
# measure independent of the card's expert FFN: the CPU's input lies
# within ROUTING_FACTOR times the largest change that the difference
# between the two devices' inputs to the FFN (the dispatched rows, w1,
# b1, as each device handed them in) makes to that row's ReLU inputs,
# in f64, plus the f32 einsum's rounding bound on each device (E u
# sum |x w| + |b|, u = 2^-24). A flip anywhere else fails, and the
# near-ties taken are at most RELU_NEAR_TIE_SHARE of the units of the
# filled capacity slots: the readings were 1 of 782,336 (phase 11,
# 1.3e-06) and 4 of 16,813,056 (phase 15's ep check, 2.4e-07) on an
# NVIDIA H100 80GB HBM3 at 700 W; the planted fault (expert 0's w1 and
# b1 negated on the card, phase 11) read 163,740 flips at clear inputs
# of block 0's 470,016.
RELU_NEAR_TIE_SHARE = 4e-6


def _relu_ties(torch, rec, xe, w1, b1, pre):
    """-> (near, flip): the CPU's expert ReLU inputs ``pre`` (from xe,
    w1, b1) that are near-ties of the card's record ``rec``, and those
    whose sign differs from the card's."""
    f64 = [t.detach().cpu().double() for t in (xe, w1, b1)]
    card = [rec[k].double() for k in ("x", "w1", "b1")]

    def pre64(x, w, b):
        return torch.einsum("xce,xfe->xcf", x, w) + b[:, None, :]
    shift = (pre64(*card) - pre64(*f64)).abs().amax(-1, keepdim=True)
    x, w, b = f64
    rounding = 2 * x.shape[-1] * 2.0 ** -24 * pre64(x.abs(), w.abs(),
                                                    b.abs())
    near = pre.detach().cpu().double().abs() <= ROUTING_FACTOR * (shift
                                                               + rounding)
    return near, (pre.detach().cpu() > 0) != rec["on"]


@contextlib.contextmanager
def _expert_relu(torch, record=None, replay=None, fault=False):
    """Around MoE.experts: with ``record`` (a list), each call's inputs
    (the dispatched rows, w1, b1) and ReLU decisions (input > 0) are
    appended and the port's function computes the output, unchanged;
    ``fault`` negates expert 0's w1 and b1 first (a planted fault). With
    ``replay`` (the card's records), the CPU takes the card's decision at
    each near-tie whose sign differs (_relu_ties) and the port's function
    is called as it is when there is none. Yields the counts {"units"
    and "near" (those of the capacity slots a token fills), "taken",
    "clear": flips at clear inputs} and "first": the CPU's first call's
    (xe, w1, b1)."""
    from sparknet_tpu_torch.ops.moe import MoE
    orig = MoE.__dict__["experts"]
    port = orig.__func__
    count = {"calls": 0, "units": 0, "near": 0, "taken": 0, "clear": 0,
             "first": None}

    def pre_of(xe, w1, b1):
        return torch.einsum("xce,xfe->xcf", xe, w1.float()) \
            + b1.float()[:, None, :]

    def experts(xe, w1, b1, w2, b2):
        i = count["calls"]
        count["calls"] += 1
        if record is not None:
            rec = {k: t.detach().to("cpu", torch.float32, copy=True)
                   for k, t in (("x", xe), ("w1", w1), ("b1", b1))}
            if fault:
                sign = torch.ones(w1.shape[0], 1, device=w1.device)
                sign[0] = -1.0
                w1, b1 = w1 * sign[:, :, None], b1 * sign
            with torch.no_grad():
                rec["on"] = (pre_of(xe, w1, b1) > 0).cpu()
            record.append(rec)
            return port(xe, w1, b1, w2, b2)
        pre = pre_of(xe, w1, b1)
        if i == 0:
            count["first"] = tuple(t.detach().clone() for t in (xe, w1, b1))
        near, flip = _relu_ties(torch, replay[i], xe, w1, b1, pre)
        take = flip & near
        used = xe.detach().cpu().ne(0).any(-1, keepdim=True)  # not empty
        count["units"] += int(used.sum()) * pre.shape[-1]
        count["near"] += int((near & used).sum())
        count["taken"] += int(take.sum())
        count["clear"] += int((flip & ~near).sum())
        if not bool(take.any()):
            return port(xe, w1, b1, w2, b2)
        keep = torch.where(take, replay[i]["on"], pre.detach().cpu() > 0)
        h = pre * keep.to(pre.device)     # relu(pre) but where taken
        return torch.einsum("xcf,xef->xce", h, w2.float()) \
            + b2.float()[:, None, :]
    MoE.experts = staticmethod(experts)
    try:
        yield count
    finally:
        MoE.experts = orig


def _check_relu_flips(count, what):
    print(f"[{what}] expert ReLU inputs: {count['units']} in all, "
          f"{count['near']} near-ties (within {ROUTING_FACTOR:g}x their "
          f"inputs' card-CPU shift and rounding), at {count['taken']} of "
          f"them the CPU took the card's other sign (limit "
          f"{RELU_NEAR_TIE_SHARE:g} of all), {count['clear']} clear inputs "
          "with another sign (must be 0)")
    check(count["units"] > 0 and count["clear"] == 0,
          f"{what}: {count['clear']} expert ReLU inputs clear of a near-tie "
          "take another sign on the card than on the CPU")
    check(count["taken"] <= RELU_NEAR_TIE_SHARE * count["units"],
          f"{what}: {count['taken']} of {count['units']} expert ReLU "
          "near-ties take another sign on the card than on the CPU")


def phase_moe_card_vs_cpu(torch, tmp, device="cuda"):
    """A small MoE LM (vocab 512, 2 layers, d 256, 4 heads, 4 experts,
    S 256, batch 2, f32, TF32 off) from one snapshot: one Adam step
    (delta 1e-6) on the card and on the CPU, its loss within 1e-5, its
    gradients within LM_GRAD_LIMIT and its weight changes within
    LM_WEIGHT_CHANGE_LIMIT. Every token's top-2 router margin must exceed
    ROUTING_FACTOR times its card-CPU logit difference (else its expert
    could flip: a near-tie, not a port defect). The CPU step takes the
    card's expert ReLU decision at a near-tie whose sign differs
    (_expert_relu; a flip at a clear input fails, the near-ties taken
    are bounded). Controls: the combine's gate weighting left out on the
    card (must fail the gradients), and expert 0's w1 and b1 negated on
    the card (must read flips the ReLU check rejects)."""
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

    def step(record, fault=False):
        """One step on ``device`` from the snapshot, its expert inputs
        and ReLU decisions into ``record`` (_expert_relu, ``fault``
        planted); -> (solver, loss, the routing ratio)."""
        solver = Solver(sp, net_param=net, device=device, log_fn=None)
        solver.restore(state)
        with torch.no_grad():
            blobs, _ = solver.net.apply(solver.params, solver.state, batch)
        ratio = min(_routing_ratio(blobs[f"block{i}/ln2"],
                                   cpu_blobs[f"block{i}/ln2"],
                                   solver.params[f"block{i}/moe"][0])
                    for i in range(2))
        with _expert_relu(torch, record=record, fault=fault):
            loss = float(solver.train_step(batch))
        return solver, loss, ratio

    decisions = []
    card_run = step(decisions)
    with _expert_relu(torch, replay=decisions) as flips:
        cpu_loss = float(cpu.train_step(batch))
    _check_relu_flips(flips, "moe-parity")
    g_cpu = {n: [p.grad.detach().double() for p in blobs]
             for n, blobs in cpu.params.items()}
    dw_cpu = {n: [p.detach().double() - w for p, w in zip(blobs, w0[n])]
              for n, blobs in cpu.params.items()}

    def read(label, run):
        solver, loss, ratio = run
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

    card = read("card", card_run)
    route = MoE.route

    def ungated(self, xt, router):
        gates, idx, gate = route(self, xt, router)
        return gates, idx, torch.ones_like(gate)
    MoE.route = ungated
    try:
        control = read("control, combine without the gate", step([]))
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
    # the planted fault: expert 0's ReLU decisions of block 0 (whose
    # inputs the fault leaves as they were) against the CPU's
    faulty = []
    step(faulty, fault=True)
    xe, w1, b1 = flips["first"]
    with torch.no_grad():
        pre = torch.einsum("xce,xfe->xcf", xe, w1.float()) \
            + b1.float()[:, None, :]
    near, flip = _relu_ties(torch, faulty[0], xe, w1, b1, pre)
    planted = {"clear": int((flip & ~near).sum()),
               "taken": int((flip & near).sum()),
               "units": int(xe.ne(0).any(-1).sum()) * pre.shape[-1]}
    print(f"[moe-parity] control, expert 0's w1 and b1 negated on the "
          f"card: block 0 reads {planted['clear']} of {planted['units']} "
          f"expert ReLU inputs with another sign at clear inputs and "
          f"{planted['taken']} near-ties")
    check(planted["clear"] > 0 or planted["taken"]
          > RELU_NEAR_TIE_SHARE * planted["units"],
          "the negated expert reads no flip the ReLU check would reject")
    return {"card": card, "control": control,
            "relu_flips": {k: flips[k] for k in ("units", "near", "taken",
                                                 "clear")},
            "relu_fault": planted}


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
GOOGLENET_STEPS = 5
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


def _safety_costs(torch, solver, feed, card, tmp, iters=8):
    """ms an iteration of Solver.step (display every 8, as the solver
    prototxt says) with nothing armed, with the metrics stream, with
    recovery and with both: the host clock over ``iters`` iterations
    ending in a synchronize, each arm twice in turns (forward, then
    backward, so a drift weighs on every arm alike); -> {arm: [ms,
    ms]}."""
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
    for order in (arms, arms[::-1]):
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
          f"{iters}, two turns each: " + "; ".join(
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


def phase_remat_lm(torch, card, steps=3):
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
    out, counts = _lm_in_process(["--steps", "2", "--remat", "dots"],
                                 tag="lm-cli remat")
    torch.cuda.empty_cache()
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
    Tap layer (``tmp``/tap_layer.py, which phase_run_safety writes),
    and its solver with a snapshot prefix -> (solver path, prefix)."""
    from sparknet_tpu_torch.models import dsl
    from sparknet_tpu_torch.proto import Message, text_format
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


# the watchdog's kill path as an API (the train verb only logs a stall,
# as the JAX verb does): a Solver on a solver file armed with
# kill_on_stall, fed the net's shapes from a seed
KILL_SCRIPT = """
import sys
import numpy as np
from sparknet_tpu_torch.proto import text_format
from sparknet_tpu_torch.solver import Solver
sp = text_format.load(sys.argv[1], "SolverParameter")
s = Solver(sp, device=sys.argv[2])
s.arm_watchdog(stall_seconds=float(sys.argv[3]), kill_on_stall=True)
rs = np.random.RandomState(0)
feed = ({"data": rs.randn(64, 256).astype(np.float32),
         "label": rs.randint(0, 10, 64).astype(np.int32)} for _ in range(50))
s.step(50, feed)
print("NOT REACHED")
"""


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


def _sigterm_child(tmp, device):
    """The SIGTERM case's child: the train verb, sent SIGTERM once it
    has logged iteration 2 -> (solver path, prefix, exit code, output,
    seconds)."""
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
    return (path, prefix, p.returncode, "".join(lines),
            time.perf_counter() - t0)


def _stall_child(tmp, device):
    """The stall case's child: KILL_SCRIPT on a layer that hangs at its
    6th call -> (solver path, prefix, the run, seconds)."""
    path, prefix = _safety_files(tmp, "stall", "stall:6")
    t0 = time.perf_counter()
    r = subprocess.run(["timeout", "-s", "KILL", "180", sys.executable, "-c",
                        KILL_SCRIPT, path, device, "5"],
                       capture_output=True, text=True, cwd=REPO,
                       env=_safety_env(tmp), timeout=300)
    return path, prefix, r, time.perf_counter() - t0


def _nan_child(tmp, device):
    """The NaN case's child: 12 iterations with a NaN batch at 4 and
    --recover 2 -> the run."""
    path, _ = _safety_files(tmp, "nan", "nan:5")
    return subprocess.run(_killable(["--solver", path, "--iterations", "12",
                                     "--recover", "2"], device),
                          capture_output=True, text=True, cwd=REPO,
                          env=_safety_env(tmp), timeout=300)


def phase_run_safety(tmp, device="cuda", beside=None):
    """SIGTERM and a NaN batch through the train verb, and the
    watchdog's kill through a Solver armed with kill_on_stall, each in a
    child under `timeout -s KILL`, the three at once (and ``beside()``
    here with them: see _beside); then the resumes, in this process
    (``device="cpu"`` rehearses it without a card). -> (results, what
    ``beside`` returned)."""
    with open(os.path.join(tmp, "tap_layer.py"), "w") as fh:
        fh.write(TAP_LAYER)     # before the children import it
    result, sigterm, stall, nan = _beside(
        beside or (lambda: None), lambda: _sigterm_child(tmp, device),
        lambda: _stall_child(tmp, device), lambda: _nan_child(tmp, device))
    out = {}
    # SIGTERM after a few iterations: the block ends, snapshot, exit 0
    path, prefix, rc, text, sigterm_s = sigterm
    done = [l for l in text.splitlines()
            if l.startswith("Optimization done, iter=")]
    check(rc == 0 and "stopping early on signal" in text and done,
          f"SIGTERM: exit {rc}: {text[-2000:]}")
    it = int(done[-1].split("=")[1])
    check(_resume_iter(path, prefix, tmp, device) == it,
          f"SIGTERM: the snapshot is not iteration {it}")
    print(f"[safety] SIGTERM after iteration 2: snapshot at {it}, exit 0 "
          f"({sigterm_s:.1f} s); --resume auto restored it")
    out["sigterm_iter"] = it
    # a layer that hangs at its 6th call under a Solver armed with
    # kill_on_stall: the watchdog kills with 42 after an emergency
    # snapshot (the train verb's --stall-seconds only logs, as the JAX
    # verb's does)
    path, prefix, r, kill_s = stall
    check(r.returncode == 42 and "NOT REACHED" not in r.stdout,
          f"stall: exit {r.returncode}, want 42: {r.stdout[-1500:]} "
          f"{r.stderr[-1500:]}")
    it = _resume_iter(path, prefix, tmp, device)
    check(it == 5, f"stall: the emergency snapshot is iteration {it}, "
                   "want 5")
    print(f"[safety] a layer hung at iteration 5 under arm_watchdog("
          f"kill_on_stall=True): exit 42 after {kill_s:.1f} s, the "
          "emergency snapshot of iteration 5 restores")
    out["stall_exit"], out["stall_iter"] = r.returncode, it
    out["stall_kill_s"] = kill_s
    # one NaN batch at iteration 4 with --recover 2
    r = nan
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
    return out, result


def phase_levers_all(torch, card, tmp):
    googlenet = phase_remat_googlenet(torch, card, tmp)
    torch.cuda.empty_cache()
    lm = phase_remat_lm(torch, card)
    # the metrics verb's child beside the run-safety children, after the
    # timed steps
    safety, verb = phase_run_safety(tmp, beside=lambda: phase_metrics_verb(
        torch, card, tmp, googlenet))
    return {"googlenet": googlenet, "metrics_verb": verb, "lm": lm,
            "safety": safety}


# -- phase 13 -------------------------------------------------------------

FLEET_REPLICAS = 3
FLEET_LEASE_S = 3.0          # route --lease (the JAX default)
FLEET_BEAT_S = 0.5           # serve --heartbeat_interval (the JAX default)
FLEET_WINDOW_S = 1.0         # route --window_s (the JAX default)
FLEET_RELOAD_POLL_S = 2.0    # serve --reload_poll (the JAX default)
FLEET_KILL_REQ = 25          # R2's kill_req: about a third of its share
FLEET_LIMIT = 1e-3           # answers against the CPU forward (phase 4's)
FLEET_SECONDS = 5.0          # each serve-bench mode


def _fleet_proc(args, log_path, env=None):
    """``python -m sparknet_tpu_torch ARGS`` with its output in a file."""
    fh = open(log_path, "w")
    return subprocess.Popen([sys.executable, "-m", "sparknet_tpu_torch",
                             *args], stdout=fh, stderr=subprocess.STDOUT,
                            cwd=REPO, env=env or dict(
                                os.environ, PYTHONUNBUFFERED="1"))


def _wait_for(cond, what, timeout, poll=0.1):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        got = cond()
        if got:
            return got
        time.sleep(poll)
    check(False, f"fleet: {what} within {timeout:g} s")


def _listening(log_path):
    def find():
        try:
            text = open(log_path).read()
        except OSError:
            return None
        for line in text.splitlines():
            if "listening on " in line:
                return line.split("listening on ", 1)[1].split()[0]
        return None
    return find


def _get_json(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _jsonl(path, kind=None):
    out = []
    with open(path) as fh:
        for line in fh:
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if kind is None or e.get("event") == kind:
                out.append(e)
    return out


def _copy_prefix(prefix, dst_dir):
    """The snapshot files of ``prefix`` (manifest, model, state) copied
    into ``dst_dir`` under the same basename -> the copy's prefix."""
    import glob
    import shutil
    os.makedirs(dst_dir, exist_ok=True)
    for f in glob.glob(glob.escape(prefix) + "*"):
        shutil.copy(f, dst_dir)
    return os.path.join(dst_dir, os.path.basename(prefix))


def _bench(url, mode, log_dir, tag, concurrency=16, rate=None,
           duration=FLEET_SECONDS):
    """serve-bench as a user runs it -> its summary dict."""
    out = os.path.join(log_dir, f"bench_{tag}.json")
    args = ["serve-bench", "--url", url, "--mode", mode, "--duration",
            str(duration), "--concurrency", str(concurrency), "--json", out,
            "--metrics", os.path.join(log_dir, f"bench_{tag}.jsonl")]
    if rate is not None:
        args += ["--rate", f"{rate:.3f}"]
    p = _fleet_proc(args, os.path.join(log_dir, f"bench_{tag}.log"))
    rc = p.wait(timeout=duration + 240)
    summary = json.load(open(out))[0]
    print(f"[fleet] serve-bench --mode {mode}: exit {rc}, "
          f"{summary['ok']} ok, {summary['rejected']} rejected (429), "
          f"{summary['errors']} errors, {summary['dropped']} dropped, "
          f"{summary['rps']} req/s, p50/p95/p99 "
          f"{summary.get('latency_ms_p50')}/{summary.get('latency_ms_p95')}"
          f"/{summary.get('latency_ms_p99')} ms")
    return rc, summary


def phase_fleet(torch, card, prefix, device="cuda"):
    """The serving fleet on the card: R0 (serve_http in this process,
    with a ReplicaMember, so its launch counters can be read), R1 and R2
    (``serve --fleet_dir`` processes; R2 kills itself through --chaos),
    the ``route`` router and ``serve-bench``, all on phase 4's GoogLeNet
    snapshot, each replica on its own copy of the prefix.
    ``device="cpu"`` rehearses it without a card (with FLEET_KILL_REQ and
    FLEET_SECONDS cut to the CPU's pace): no kernel launches then."""
    from sparknet_tpu_torch.graph import CompiledNet, TEST
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.obs.tracing import STAGES, TraceSampler
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    from sparknet_tpu_torch.resilience import save_model_snapshot
    from sparknet_tpu_torch.serve import (Batcher, ReplicaMember,
                                          ServeEngine, deploy_net_param,
                                          serve_http)
    from sparknet_tpu_torch.obs.stepstats import percentiles
    from sparknet_tpu_torch.utils.metrics import MetricsLogger
    t_phase = time.perf_counter()
    os.environ.pop("SPARKNET_EPILOGUE", None)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    fleet_dir = os.path.join(tmp, "rendezvous")
    prefixes = [_copy_prefix(prefix, os.path.join(tmp, f"r{i}"))
                for i in range(FLEET_REPLICAS)]
    streams = {name: os.path.join(tmp, f"{name}.jsonl")
               for name in ("r0", "r1", "r2", "router")}
    procs = {}
    r0_stop = threading.Event()
    r0_rc, r0_thread, r0_metrics = [], None, None
    try:
        for i in (1, 2):
            args = ["serve", "--prefix", prefixes[i], "--fleet_dir",
                    fleet_dir, "--replica", str(i), "--replicas",
                    str(FLEET_REPLICAS), "--max_batch", "8", "--metrics",
                    streams[f"r{i}"], "--device", device]
            if i == 2:
                args += ["--chaos", f"kill_replica=2,kill_req="
                                    f"{FLEET_KILL_REQ}"]
            procs[f"r{i}"] = _fleet_proc(args, os.path.join(tmp,
                                                            f"r{i}.log"))
        # R0 in this process
        r0_metrics = MetricsLogger(streams["r0"])
        engine = ServeEngine(prefixes[0], max_batch=8, device=device,
                             metrics=r0_metrics, log_fn=None)
        engine.load()
        engine.warmup()
        if device == "cuda":
            torch.cuda.synchronize()
        batcher = Batcher(max_batch=8, max_wait_s=0.005, queue_limit=64,
                          metrics=r0_metrics)
        member = ReplicaMember(fleet_dir, 0, replicas=FLEET_REPLICAS,
                               engine=engine, batcher=batcher,
                               interval_s=FLEET_BEAT_S,
                               lease_s=FLEET_LEASE_S, metrics=r0_metrics,
                               log_fn=print)
        up = threading.Event()
        r0_thread = threading.Thread(target=lambda: r0_rc.append(serve_http(
            engine, batcher, port=0, metrics=r0_metrics, stop_event=r0_stop,
            reload_poll_s=FLEET_RELOAD_POLL_S, member=member, replica=0,
            tracer=TraceSampler(), log_fn=print,
            on_listen=lambda u: up.set())), daemon=True)
        r0_thread.start()
        check(up.wait(120), "fleet: R0 did not start listening")
        procs["router"] = _fleet_proc(
            ["route", "--fleet_dir", fleet_dir, "--replicas",
             str(FLEET_REPLICAS), "--lease", str(FLEET_LEASE_S),
             "--metrics", streams["router"]],
            os.path.join(tmp, "router.log"))
        router = _wait_for(_listening(os.path.join(tmp, "router.log")),
                           "the router announced its URL", 120)
        # every replica's lease read (the policy counts a replica live
        # before its first beat)
        health = _wait_for(lambda: (lambda h: h if len(h["replicas"]) ==
                                    FLEET_REPLICAS else None)(
            _get_json(router + "/healthz")),
            "three replicas leased in", 240, poll=0.5)
        urls = {int(r): rec["url"] for r, rec in health["replicas"].items()}
        t_setup = time.perf_counter() - t_phase
        print(f"[fleet] router {router}, replicas {urls} live after "
              f"{t_setup:.1f} s")

        # 1. answers through the router against the CPU forward
        for fn in KERNEL_WRAPPERS:
            fn.launches = 0
        cpu = ServeEngine(prefix, max_batch=8, device="cpu", log_fn=None)
        cpu.load()
        rs = np.random.RandomState(SEED + 13)
        worst = 0.0
        for n in range(1, 9):
            x = np.round(rs.randn(n, 3, 224, 224), 3).astype(np.float32)
            out, _ = _post(router, x)
            got = np.asarray(out["outputs"]["loss3/classifier"], np.float32)
            ref = cpu.forward({"data": x})[0]["loss3/classifier"]
            check(got.shape == ref.shape and np.isfinite(got).all() and
                  np.abs(got).max() > 0, f"fleet: bad answer {got.shape}")
            worst = max(worst, float(np.abs(got - ref).max()
                                     / np.abs(ref).max()))
        answered = sorted({e["replica"] for e in _jsonl(streams["router"],
                                                         "route")})
        print(f"[fleet] 8 inputs of 1-8 rows through the router (answered "
              f"by replicas {answered}): max |card - cpu| / max |cpu| = "
              f"{worst:.3e} (limit {FLEET_LIMIT:g})")
        check(worst <= FLEET_LIMIT, f"fleet: answers differ from the CPU "
                                    f"forward by {worst:.3e}")

        # 2. the load: closed loop through R2's kill, then open loop
        rc, closed = _bench(router, "closed", tmp, "closed")
        check(rc == 0 and closed["errors"] == 0,
              f"fleet: closed loop exit {rc}, {closed['errors']} errors")
        r2_rc = procs["r2"].wait(timeout=120)
        check(r2_rc == -signal.SIGKILL,
              f"fleet: R2 exited {r2_rc}, want SIGKILL by its chaos spec")
        rc, opened = _bench(router, "open", tmp, "open",
                            rate=max(1.0, closed["rps"] / 2))
        check(rc == 0 and opened["errors"] == 0,
              f"fleet: open loop exit {rc}, {opened['errors']} errors")
        routes = _jsonl(streams["router"], "route")
        evict = [e for e in _jsonl(streams["router"], "eviction")
                 if e.get("worker") == 2]
        check(evict, "fleet: the router never evicted R2")
        last_r2 = max(e["t"] for e in routes
                      if e.get("replica") == 2 and e.get("code") == 200)
        failover_s = evict[0]["t"] - last_r2
        print(f"[fleet] R2 killed itself after {FLEET_KILL_REQ}+ requests;"
              f" the router evicted it {failover_s:.2f} s after its last "
              f"answer (lease {FLEET_LEASE_S:g} s, window "
              f"{FLEET_WINDOW_S:g} s); 429s: closed "
              f"{closed['rejected']}, open {opened['rejected']}; retried "
              f"dispatches {sum(1 for e in routes if e.get('retried'))}")
        check(failover_s <= FLEET_LEASE_S + FLEET_WINDOW_S + FLEET_BEAT_S,
              f"fleet: eviction {failover_s:.2f} s after R2's last answer,"
              f" more than one lease ({FLEET_LEASE_S:g} s) plus a window "
              "and a beat")

        # 4. hot reload under R1's prefix
        net = CompiledNet(deploy_net_param(zoo.googlenet(
            batch_size=8, with_aux=False)), TEST, device="cpu")
        params, state = net.init(torch.Generator().manual_seed(SEED + 1))
        save_model_snapshot(net, params, prefixes[1], iter=1, state=state)
        t0 = time.perf_counter()
        _wait_for(lambda: _get_json(urls[1] + "/healthz").get("iter") == 1,
                  "R1 hot-reloaded", 60, poll=0.05)
        reload_s = time.perf_counter() - t0
        reload_ms = [e["ms"] for e in _jsonl(streams["r1"], "serve_reload")]
        check(reload_ms, "fleet: R1 logged no serve_reload")
        print(f"[fleet] R1 served the new snapshot {reload_s:.2f} s after "
              f"its commit (reload poll {FLEET_RELOAD_POLL_S:g} s, beat "
              f"{FLEET_BEAT_S:g} s, the reload itself {reload_ms[-1]:.0f} "
              "ms)")
        check(reload_s <= FLEET_RELOAD_POLL_S + FLEET_BEAT_S
              + reload_ms[-1] / 1e3,
              f"fleet: R1 took {reload_s:.2f} s to serve the new snapshot")
        new_cpu = ServeEngine(prefixes[1], max_batch=8, device="cpu",
                              log_fn=None)
        new_cpu.load()
        x = np.round(rs.randn(3, 3, 224, 224), 3).astype(np.float32)
        got = np.asarray(_post(urls[1], x)[0]["outputs"]["loss3/classifier"],
                         np.float32)
        ref = new_cpu.forward({"data": x})[0]["loss3/classifier"]
        old = cpu.forward({"data": x})[0]["loss3/classifier"]
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        moved = float(np.abs(old - ref).max() / np.abs(ref).max())
        check(err <= FLEET_LIMIT and moved > 10 * FLEET_LIMIT,
              f"fleet: R1 after the reload is {err:.3e} from the new "
              f"weights' CPU forward (the old weights are {moved:.3e})")
        shas = _wait_for(lambda: (lambda s: s if len(s) == 2 else None)({
            rec.get("sha") for rec in _get_json(router + "/healthz")[
                "replicas"].values()}), "the router saw two shas",
            3 * FLEET_BEAT_S + 2 * FLEET_WINDOW_S + 5)
        print(f"[fleet] R1 after the reload: {err:.3e} of the largest "
              f"logit from the new weights' CPU forward (the old weights: "
              f"{moved:.3e}); the router sees shas "
              f"{sorted(s[:12] for s in shas)}")

        # 5. drain R1 under load
        p = _fleet_proc(["serve-bench", "--url", router, "--mode", "closed",
                         "--duration", "4", "--concurrency", "4", "--json",
                         os.path.join(tmp, "bench_drain.json")],
                        os.path.join(tmp, "bench_drain.log"))
        time.sleep(1.5)
        procs["r1"].send_signal(signal.SIGTERM)
        r1_rc = procs["r1"].wait(timeout=120)
        p.wait(timeout=240)
        drain = json.load(open(os.path.join(tmp, "bench_drain.json")))[0]
        r1_log = open(os.path.join(tmp, "r1.log")).read()
        print(f"[fleet] SIGTERM to R1 under a closed loop: exit {r1_rc}, "
              f"the loop {drain['ok']} ok, {drain['rejected']} rejected, "
              f"{drain['errors']} errors")
        check(r1_rc == 0 and "drained cleanly" in r1_log and
              drain["errors"] == 0,
              f"fleet: R1's drain: exit {r1_rc}, {drain['errors']} "
              f"errors: {r1_log[-1500:]}")

        # 3. R0's launches against its batches
        r0_stop.set()
        r0_thread.join(timeout=120)
        check(r0_rc == [0], f"fleet: R0's drain returned {r0_rc}")
        counts = kernel_launches()
        batches = len(_jsonl(streams["r0"], "serve_batch"))
        print(f"[fleet] R0: {batches} forward batches (serve_batch "
              f"events), launches {counts}")
        want = batches if device == "cuda" else 0
        check(batches > 0 and counts["lrn_across"] == want and
              counts["bias_relu_lrn"] == want and counts["bias_relu"] == 0,
              f"fleet: R0's launches {counts} against {batches} batches")
        procs["router"].send_signal(signal.SIGTERM)
        router_rc = procs["router"].wait(timeout=60)
        check(router_rc == 0, f"fleet: the router exited {router_rc}")

        # 6. the report's stage breakdown, and the monitor
        rep_json = os.path.join(tmp, "router_report.json")
        rep = subprocess.run(
            [sys.executable, "-m", "sparknet_tpu_torch", "report",
             streams["router"], "--json", rep_json],
            capture_output=True, text=True, cwd=REPO, timeout=120)
        check(rep.returncode == 0 and "request tracing" in rep.stdout and
              "routing fleet" in rep.stdout,
              f"fleet: report: exit {rep.returncode} {rep.stdout[-1500:]}"
              f" {rep.stderr[-1500:]}")
        for name in ("r0", "r1", "r2"):
            r = subprocess.run(
                [sys.executable, "-m", "sparknet_tpu_torch", "report",
                 streams[name]], capture_output=True, text=True, cwd=REPO,
                timeout=120)
            # R2 was killed: its stream ends without a summary
            check(r.returncode == 0 and ("serving" in r.stdout
                                         or name == "r2"),
                  f"fleet: report of {name}: exit {r.returncode} "
                  f"{r.stdout[-1000:]}")
        stages_rep = json.load(open(rep_json))["tracing"]["stages"]
        mon = subprocess.run(
            [sys.executable, "-m", "sparknet_tpu_torch", "monitor",
             streams["router"], "--once"], capture_output=True, text=True,
            cwd=REPO, timeout=120)
        check(mon.returncode == 0 and "tracing:" in mon.stdout and
              "routing:" in mon.stdout,
              f"fleet: monitor --once: exit {mon.returncode} "
              f"{mon.stdout[-1500:]}")
        print("[fleet] report (request tracing):\n" + "\n".join(
            "  " + l for l in rep.stdout.splitlines()
            if l.strip().split(" ")[0] in STAGES + ("total", "traces:")))
        print("[fleet] monitor --once:\n" + "\n".join(
            "  " + l for l in mon.stdout.splitlines()[:12]))
    finally:
        r0_stop.set()
        if r0_thread is not None:
            r0_thread.join(timeout=60)
        if r0_metrics is not None:
            r0_metrics.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    traces = [e for e in _jsonl(streams["router"], "serve_trace")
              if e.get("src") == "router" and e.get("code") == 200]
    stage_pct = {k: percentiles([e[f"{k}_ms"] for e in traces
                                 if e.get(f"{k}_ms") is not None],
                                qs=(50, 99))
                 for k in STAGES}
    fills = [e["fill"] for name in ("r0", "r1", "r2")
             for e in _jsonl(streams[name], "serve_batch")]
    seconds = time.perf_counter() - t_phase
    print(f"[fleet] closed loop: {closed['rps']} req/s, "
          f"{closed['rps'] * closed['rows']} rows/s ({card})")
    print(f"[fleet] open loop at {opened['offered_rps']:.1f} req/s: p50 "
          f"{opened.get('latency_ms_p50')} ms, p95 "
          f"{opened.get('latency_ms_p95')} ms, p99 "
          f"{opened.get('latency_ms_p99')} ms ({card})")
    print("[fleet] stages over " + str(len(traces)) + " traced requests: "
          + ", ".join(f"{k} p50 {v['p50']:.3f} / p99 {v['p99']:.3f} ms"
                      for k, v in stage_pct.items()) + f" ({card})")
    print(f"[fleet] mean batch fill {np.mean(fills):.4f} over "
          f"{len(fills)} batches; failover window {failover_s:.2f} s; "
          f"phase {seconds:.1f} s")
    return {"launches": counts, "batches": batches, "closed": closed,
            "open": opened, "drain": drain, "stages": stage_pct,
            "report_stages": stages_rep, "batch_fill": float(np.mean(fills)),
            "failover_s": failover_s, "reload_s": reload_s,
            "answers_err": worst, "reload_err": err, "seconds": seconds}


# -- phase 14 -------------------------------------------------------------

HOSTS_TAU = 10              # phase 8's tau for CaffeNet
HOSTS_BATCH = 256           # a slot's batch (the ImageNet app's)
HOSTS_ROUNDS = 4            # the armed two-tier rounds
CONSENSUS_LIMIT = 1e-6      # relative, against a float64 masked mean
RELAY_LEASE_S, RELAY_BEAT_S = 2.0, 0.25
RELAY_TAU = 10              # CifarApp's
RELAY_ROUNDS = 6            # each process's rounds in the survival run
RELAY_KILL_ROUND = 3
GROW_ROUNDS, JOINER_ROUNDS = 60, 8
RELAY_TIMEOUT = 300


def _hosts_caffenet(torch, hosts=None, workers=4, dp=False, device="cuda"):
    """CaffeNet at the ImageNet app's widths (phase 8's solver): a
    LocalSGDSolver of 4 slots x b256 (two-tier over ``hosts`` when
    given), or with ``dp`` a DataParallelSolver over the same 4 x 256."""
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.parallel import DataParallelSolver, LocalSGDSolver
    from sparknet_tpu_torch.proto import Message
    sp = Message("SolverParameter", base_lr=0.01, momentum=0.9,
                 weight_decay=0.0005, lr_policy="step", gamma=0.1,
                 stepsize=100000, display=0, random_seed=SEED)
    if dp:
        return DataParallelSolver(sp, workers=workers, log_fn=None,
                                  net_param=zoo.caffenet(
                                      batch_size=HOSTS_BATCH * workers),
                                  device=device)
    kw = dict(host_axis="host", hosts=hosts) if hosts else {}
    return LocalSGDSolver(sp, workers=workers, tau=HOSTS_TAU, log_fn=None,
                          net_param=zoo.caffenet(batch_size=HOSTS_BATCH),
                          device=device, **kw)


def _bitwise_params(a, b):
    """Every param blob of ``a`` equal to ``b``'s, bit for bit."""
    return all(x.detach().equal(y.detach()) for n in a.params
               for x, y in zip(a.params[n], b.params[n]))


def _one_round_ms(torch, fn):
    """(fn(), its ms over CUDA events; the host clock on the CPU)."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def phase_two_tier(torch, card, device="cuda"):
    """Part A: the two-tier local-SGD round in process at the ImageNet
    app's widths (CaffeNet, 4 slots x b256, tau 10, f32, TF32 off), on
    batches made on the card. The degeneracies first: 4 hosts x 1 slot
    against phase 8's single-tier round, and 1 host x 4 slots against
    tau DataParallelSolver steps, each bit for bit (losses and params).
    Then 2 hosts x 2 slots: one unarmed round (its LRN launches), and
    HOSTS_ROUNDS rounds with elastic membership armed (quorum 1,
    evict_after 1, readmit_after 2) and chaos kill_host=1 at round 1 —
    host 1 holds slots 2 and 3; in two-tier mode the membership unit is
    the host, whose injector is kill_host (the JAX grammar's kill_worker
    feeds worker-unit membership). Each round's consensus against a
    float64 masked mean, computed on the card, of the live hosts'
    post-round weights; the eviction at round 1, the readmission after
    the cooldown, every host holding the consensus after every round;
    the LRN launches a round equal to the unarmed round's; the masked
    consensus alone timed."""
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    r0 = _synthetic_rounds(torch, HOSTS_TAU, 4, HOSTS_BATCH, (3, 227, 227),
                           1000, SEED + 40, device)
    # bit for bit needs cuDNN's deterministic algorithms (its default
    # backward sums with atomics: two runs of one solver differ)
    torch.backends.cudnn.deterministic = True
    try:
        same_41, same_14 = _degeneracies(torch, card, r0, device)
    finally:
        torch.backends.cudnn.deterministic = False

    # 2 hosts x 2 slots, unarmed, beside phase 8's single-tier round:
    # the round times and the LRN launches of one round
    ref = _hosts_caffenet(torch, device=device)
    _one_round_ms(torch, lambda: ref.train_round(r0))       # warm-up
    _, ref_ms = _one_round_ms(torch, lambda: ref.train_round(r0))
    del ref
    torch.cuda.empty_cache()
    solver = _hosts_caffenet(torch, hosts=2, device=device)
    _one_round_ms(torch, lambda: solver.train_round(r0))    # warm-up
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    _, plain_ms = _one_round_ms(torch, lambda: solver.train_round(r0))
    unarmed = kernel_launches()
    del solver
    torch.cuda.empty_cache()
    return _two_tier_armed(torch, card, device, unarmed, plain_ms, ref_ms,
                           same_41, same_14)


def _degeneracies(torch, card, r0, device):
    """4 hosts x 1 slot against the single-tier round and 1 host x 4
    slots against tau DataParallelSolver steps, each on ``r0`` from one
    seed: -> (both bit for bit?, ...)."""
    # 4 hosts x 1 slot == the single-tier round of phase 8, bit for bit
    ref = _hosts_caffenet(torch, device=device)
    ref_loss, ref_ms = _one_round_ms(torch, lambda: ref.train_round(r0))
    hier = _hosts_caffenet(torch, hosts=4, device=device)
    hier_loss, hier_ms = _one_round_ms(torch, lambda: hier.train_round(r0))
    same_41 = float(ref_loss) == float(hier_loss) and \
        _bitwise_params(ref, hier)
    print(f"[hosts] 4 hosts x 1 slot against the single-tier round: losses "
          f"{float(hier_loss):.7f} / {float(ref_loss):.7f}, params bit for "
          f"bit {same_41}; round {hier_ms:.1f} ms, single-tier {ref_ms:.1f} "
          f"ms; {card}")
    check(same_41, "4 hosts x 1 slot is not the single-tier round bit for "
                   "bit")
    del ref, hier
    torch.cuda.empty_cache()
    # 1 host x 4 slots == tau DataParallelSolver steps, bit for bit
    one = _hosts_caffenet(torch, hosts=1, device=device)
    one_loss, one_ms = _one_round_ms(torch, lambda: one.train_round(r0))
    dp = _hosts_caffenet(torch, dp=True, device=device)
    steps = [dp.train_step({k: v[i] for k, v in r0.items()})
             for i in range(HOSTS_TAU)]
    dp_loss = float(torch.stack(steps).mean())
    same_14 = float(one_loss) == dp_loss and _bitwise_params(one, dp)
    print(f"[hosts] 1 host x 4 slots against {HOSTS_TAU} data-parallel "
          f"steps: losses {float(one_loss):.7f} / {dp_loss:.7f}, params bit "
          f"for bit {same_14}; round {one_ms:.1f} ms")
    check(same_14, "1 host x 4 slots is not tau DataParallelSolver steps "
                   "bit for bit")
    del one, dp, steps
    torch.cuda.empty_cache()
    return same_41, same_14


def _two_tier_armed(torch, card, device, unarmed, plain_ms, ref_ms, same_41,
                    same_14):
    """2 hosts x 2 slots armed, host 1 killed at round 1 (see
    phase_two_tier)."""
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    from sparknet_tpu_torch.resilience import chaos as chaos_mod
    from sparknet_tpu_torch.resilience.elastic import masked_consensus
    chaos_mod.install_chaos(chaos_mod.ChaosMonkey.parse(
        "kill_host=1,kill_host_round=1"))
    try:
        solver = _hosts_caffenet(torch, hosts=2, device=device)
        solver.arm_elastic(quorum=1, evict_after=1, readmit_after=2)
    finally:
        chaos_mod.install_chaos(None)
    captured = []
    local_round = solver._local_round

    def capture(batches):
        res = local_round(batches)
        captured.append({n: [P.detach().double() for P in ps]
                         for n, ps in solver.slot_params.items()})
        return res
    solver._local_round = capture
    losses, worst, per_round, rounds_ms = [], 0.0, [], []
    for r in range(HOSTS_ROUNDS):
        batches = _synthetic_rounds(torch, HOSTS_TAU, 4, HOSTS_BATCH,
                                    (3, 227, 227), 1000, SEED + 41 + r,
                                    device)
        alive = torch.as_tensor(solver.elastic.alive.astype(np.float64),
                                device=device)
        for fn in KERNEL_WRAPPERS:
            fn.launches = 0
        loss, ms = _one_round_ms(torch, lambda: solver.train_round(batches))
        rounds_ms.append(ms)
        per_round.append(kernel_launches())
        losses.append(float(loss))
        units = captured.pop()
        finite = torch.stack([
            torch.stack([torch.isfinite(P[u]).all() for ps in units.values()
                         for P in ps]).all() for u in range(solver.units)])
        mask = alive * finite.double()
        err = 0.0
        for name, ps in units.items():
            for i, P in enumerate(ps):
                m = mask.reshape((-1,) + (1,) * (P.dim() - 1))
                want = (P * m).sum(0) / mask.sum()
                got = solver.slot_params[name][i]
                for u in range(solver.units):     # every host holds it
                    e = float((got[u].double() - want).abs().max()
                              / want.abs().max().clamp_min(1e-30))
                    err = max(err, e)
        worst = max(worst, err)
        print(f"[hosts] 2 hosts x 2 slots, armed, round {r}: loss "
              f"{losses[-1]:.6f}, alive during the round "
              f"{mask.tolist()}, consensus against the float64 masked "
              f"mean {err:.3e} (limit {CONSENSUS_LIMIT:g}), {ms:.1f} ms, LRN "
              f"launches {per_round[-1]['lrn_across']} / "
              f"{per_round[-1]['lrn_across_bwd']} (unarmed "
              f"{unarmed['lrn_across']} / {unarmed['lrn_across_bwd']})")
    el = solver.elastic
    ev = [(e["worker"], e["round"], e["reason"]) for e in el.evictions]
    rd = [(e["worker"], e["round"]) for e in el.readmissions]
    valid = solver._alive_mask()
    _one_round_ms(torch, lambda: masked_consensus(solver.slot_params,
                                                  valid))    # warm-up
    cons_ms = statistics.median(
        _one_round_ms(torch, lambda: masked_consensus(solver.slot_params,
                                                      valid))[1]
        for _ in range(5))
    n_params = sum(P[0].numel() for ps in solver.slot_params.values()
                   for P in ps)
    armed_ms = statistics.median(rounds_ms)
    print(f"[hosts] evictions {ev}, readmissions {rd}; the masked "
          f"consensus alone {cons_ms:.3f} ms over {n_params / 1e6:.1f}M "
          f"params x 2 hosts; the armed round {armed_ms:.1f} ms (median of "
          f"{HOSTS_ROUNDS}), unarmed {plain_ms:.1f} ms, phase 8's "
          f"single-tier {ref_ms:.1f} ms in this call; {card}")
    check(all(np.isfinite(losses)), f"armed two-tier losses {losses}")
    check(worst <= CONSENSUS_LIMIT,
          f"the two-tier consensus differs from the float64 masked mean by "
          f"{worst:.3e}")
    check(ev == [(1, 1, "chaos_kill")], f"evictions {ev}, want host 1 at "
                                        "round 1")
    check(rd == [(1, 3)], f"readmissions {rd}, want host 1 at round 3")
    for name in ("lrn_across", "lrn_across_bwd"):
        check(all(p[name] == unarmed[name] for p in per_round),
              f"{name} launches a round {[p[name] for p in per_round]}, "
              f"unarmed {unarmed[name]}")
    launches = {k: sum(p[k] for p in per_round) for k in per_round[0]}
    out = {"degenerate_4x1_bitwise": same_41, "degenerate_1x4_bitwise":
           same_14, "single_tier_round_ms": ref_ms,
           "unarmed_round_ms": plain_ms,
           "armed_rounds_ms": rounds_ms, "losses": losses,
           "consensus_err": worst, "consensus_ms": cons_ms,
           "evictions": ev, "readmissions": rd, "launches": launches,
           "unarmed_launches": unarmed}
    solver.close()
    del solver, captured
    torch.cuda.empty_cache()
    return out


def phase_elastic_train_verb(solver_path, card, dp_launches, tmp,
                             device="cuda"):
    """Part B: `train --strategy dp --mesh data=4` on phase 9's CaffeNet
    records (4 x b64) with elastic membership, bounded staleness 1 and
    chaos killing worker 1 at step 2: exit 0, the eviction and the
    readmission in its --metrics stream, finite losses, and the LRN
    launches of the unarmed dp verb's run (phase 10), every slot still
    computing."""
    metrics = os.path.join(tmp, "elastic_dp.jsonl")
    stdout, wall = _train_verb(
        solver_path, "hosts-train",
        ("--strategy", "dp", "--mesh", f"data={DP_SLOTS}", "--quorum", "3",
         "--evict-after", "1", "--readmit-after", "2", "--staleness", "1",
         "--chaos", "kill_worker=1,kill_round=2", "--metrics", metrics,
         "--device", device), {"SPARKNET_DEVICE_CACHE_MB": None})
    losses = [float(l.split("loss = ")[1].split(",")[0])
              for l in stdout.splitlines() if "Iteration " in l]
    launches = _launches_line(stdout, "hosts-train")
    ev = [(e["worker"], e["round"], e["reason"])
          for e in _jsonl(metrics, "eviction")]
    rd = [(e["worker"], e["round"]) for e in _jsonl(metrics, "readmission")]
    print(f"[hosts-train] evictions {ev}, readmissions {rd}, losses "
          f"{losses}, LRN launches {launches['lrn_across']} / "
          f"{launches['lrn_across_bwd']} (the unarmed dp verb "
          f"{dp_launches['lrn_across']} / {dp_launches['lrn_across_bwd']}) "
          f"in {FEED_ITERS} iterations, {wall:.1f} s; {card}")
    check(losses and all(np.isfinite(losses)), f"losses {losses}")
    check(ev == [(1, 2, "chaos_kill")], f"evictions {ev}")
    check(rd == [(1, 4)], f"readmissions {rd}")
    for name in ("lrn_across", "lrn_across_bwd"):
        check(launches[name] == dp_launches[name],
              f"{name}: {launches[name]} launches, the unarmed dp verb "
              f"{dp_launches[name]}")
    return {"losses": losses, "evictions": ev, "readmissions": rd,
            "launches": launches, "wall_s": wall}


def _cifar_procs(tmp, tag, hosts, flags, per_host=None, env=None,
                 world=None):
    """Start ``hosts`` `cifar` verb processes (one host each, ids 0..n-1
    of a world of ``world`` processes, default ``hosts``), all on the
    card; ``per_host`` {pid: extra flags}. -> [(Popen, stdout path,
    metrics path)]."""
    procs = []
    for pid in range(hosts):
        log = os.path.join(tmp, f"{tag}-{pid}.log")
        met = os.path.join(tmp, f"{tag}-{pid}.jsonl")
        e = dict(os.environ, SPARKNET_NUM_PROCESSES=str(world or hosts),
                 SPARKNET_PROCESS_ID=str(pid), **(env or {}))
        cmd = [sys.executable, "-m", "sparknet_tpu_torch", "cifar",
               *flags, "--metrics", met,
               *((per_host or {}).get(pid, ()))]
        with open(log, "w") as fh:
            procs.append((subprocess.Popen(cmd, cwd=REPO, stdout=fh,
                                           stderr=subprocess.STDOUT,
                                           env=e), log, met))
    return procs


def _wait_procs(procs, timeout=RELAY_TIMEOUT):
    """Exit codes of ``procs``; kills what outlives ``timeout``."""
    deadline = time.time() + timeout
    rcs = []
    try:
        for p, _, _ in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.time())))
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs


def _read(path):
    with open(path) as fh:
        return fh.read()


def _relay_lines(text):
    """{round: (hosts, sha, post ms, mask ms, average ms)} from a
    process's `relay:` log lines."""
    out = {}
    for line in text.splitlines():
        if "relay: round " not in line:
            continue
        part = line.split("relay: round ", 1)[1]
        r = int(part.split(" ", 1)[0])
        sha = part.split("sha256 ", 1)[1].split(";")[0].strip()
        hosts = part.split("hosts ", 1)[1].split("]")[0] + "]"
        ms = [float(x.split(" ms")[0]) for x in part.split(
            "; post ", 1)[1].replace("mask ", "").replace(
            "average ", "").split(", ")] if "; post " in part else []
        out[r] = (hosts, sha, *ms)
    return out


def phase_relay_processes(tmp, card, device="cuda"):
    """Part C: `cifar --hosts N --strategy local_sgd --tau 10` processes
    on the one card, each one host of 2 slots x b100 of cifar10_full on
    make_synth_cifar records, relaying the cross-host average through
    the rendezvous directory (--heartbeat-dir, --lease-s 2,
    --heartbeat-interval 0.25, --metrics).
    1. survival: 2 processes, --quorum 1 --evict-after 1, host 1 with
       --chaos kill_host=1,kill_host_round=3: until the kill both adopt
       the same consensus bit for bit (each round's sha256 in the log);
       host 0 evicts host 1 (lease_expired) within a lease and a beat of
       its last lease, and finishes with exit 0.
    2. coordinated restart: 3 processes, --quorum 3, host 2 killed at
       round 2: both survivors exit 4 after agreeing on the sha256 of the
       manifest (a coordinated_restart event, agreed); relaunched as a
       2-process world with --resume auto --reshard auto, both restore
       that snapshot's iteration and go on.
    3. grow: a pair with --snapshot-prefix P --snapshot-every 1, and a
       third standalone process with --hosts 1 --grow --snapshot-prefix P
       --resume auto --reshard auto started once P has a snapshot: its
       reshard event names both worlds, and the pair's next masks count
       three hosts."""
    from sparknet_tpu_torch import tools
    data = os.path.join(tmp, "relay_cifar")
    tools.make_synth_cifar(data, n_train=5000, n_test=500, seed=SEED,
                           log=lambda *a: None)

    def flags(hosts):           # 2 slots x b100 a host
        return ["--data", data, "--hosts", str(hosts), "--workers",
                str(2 * hosts), "--strategy", "local_sgd", "--tau",
                str(RELAY_TAU),
                "--test-every", "1000", "--lease-s", str(RELAY_LEASE_S),
                "--heartbeat-interval", str(RELAY_BEAT_S), "--device",
                device]
    base = flags(2)
    out = {}
    # 1. survival
    hb = os.path.join(tmp, "hb-survive")
    t0 = time.perf_counter()
    procs = _cifar_procs(
        tmp, "relay-survive", 2,
        base + ["--rounds", str(RELAY_ROUNDS), "--heartbeat-dir", hb,
                "--quorum", "1", "--evict-after", "1"],
        per_host={1: ("--chaos", f"kill_host=1,kill_host_round="
                                 f"{RELAY_KILL_ROUND}")})
    rcs = _wait_procs(procs)
    wall = time.perf_counter() - t0
    logs = [_read(p[1]) for p in procs]
    for pid, text in enumerate(logs):
        for line in text.strip().splitlines()[-8:]:
            print(f"[relay-survive {pid}] {line}")
    check(rcs[0] == 0, f"survivor exited {rcs[0]}: {logs[0][-3000:]}")
    check(rcs[1] == -signal.SIGKILL, f"host 1 exited {rcs[1]}, want "
                                     "SIGKILL")
    rel = [_relay_lines(t) for t in logs]
    shared = sorted(set(rel[0]) & set(rel[1]))
    check(shared == list(range(RELAY_KILL_ROUND)),
          f"rounds both hosts relayed: {shared}")
    same = all(rel[0][r][1] == rel[1][r][1] for r in shared)
    check(same, f"the hosts' consensus differs before the kill: "
                f"{[(rel[0][r][1], rel[1][r][1]) for r in shared]}")
    m0 = procs[0][2]
    ev = [(e["worker"], e["round"], e["reason"]) for e in
          _jsonl(m0, "eviction")]
    check(ev == [(1, RELAY_KILL_ROUND, "lease_expired")],
          f"host 0's evictions {ev}")
    gate = [e for e in _jsonl(m0, "host_round") if 1 in e.get("dead", [])]
    window = float(gate[0]["lease_age_s"][1])
    check(window <= RELAY_LEASE_S + RELAY_BEAT_S + 0.25,
          f"host 1 evicted {window:.3f} s after its last lease, beyond a "
          f"lease and a beat")
    relay_ms = [v[2:] for r, v in sorted(rel[0].items()) if len(v) == 5]
    post, mask, avg = (float(np.median([m[i] for m in relay_ms]))
                       for i in range(3))
    io = [e["seconds"] for e in _jsonl(m0, "relay_io")]
    print(f"[relay] survival: consensus bit for bit across the hosts for "
          f"rounds {shared}; host 1 evicted (lease_expired) at round "
          f"{RELAY_KILL_ROUND}, {window:.3f} s after its last lease (lease "
          f"{RELAY_LEASE_S} s, beat {RELAY_BEAT_S} s); the relay a round "
          f"(median over host 0's {len(relay_ms)}): post {post:.2f} ms, mask "
          f"{mask:.2f} ms, average {avg:.2f} ms (relay_io {1e3 * float(np.median(io)):.2f} ms); "
          f"{wall:.1f} s; {card}")
    out["survival"] = {"rcs": rcs, "shared_rounds": shared,
                       "eviction_window_s": window, "post_ms": post,
                       "mask_ms": mask, "average_ms": avg,
                       "relay_io_ms": 1e3 * float(np.median(io)),
                       "wall_s": wall}

    # 2. coordinated restart
    hb = os.path.join(tmp, "hb-restart")
    prefix = os.path.join(tmp, "restart", "snap")
    t0 = time.perf_counter()
    procs = _cifar_procs(
        tmp, "relay-restart", 3,
        flags(3) + ["--rounds", str(RELAY_ROUNDS), "--heartbeat-dir", hb,
                  "--quorum", "3", "--evict-after", "1",
                  "--snapshot-prefix", prefix],
        per_host={2: ("--chaos", "kill_host=2,kill_host_round=2")})
    rcs = _wait_procs(procs)
    logs = [_read(p[1]) for p in procs]
    for pid, text in enumerate(logs):
        for line in text.strip().splitlines()[-6:]:
            print(f"[relay-restart {pid}] {line}")
    check(rcs[:2] == [4, 4], f"survivors exited {rcs[:2]}, want 4 and 4")
    cr = [[e for e in _jsonl(p[2], "membership")
           if e.get("kind") == "coordinated_restart"] for p in procs[:2]]
    from sparknet_tpu_torch.resilience.heartbeat import manifest_sha
    sha = manifest_sha(prefix)
    check(all(c and c[-1]["agreed"] and c[-1]["sha"] == sha for c in cr),
          f"coordinated_restart events {cr}, manifest sha {sha}")
    barrier = [float(t.split("coordinated restart: barrier ")[1].split(
        " s")[0]) for t in logs[:2]]
    from sparknet_tpu_torch.resilience.checkpoint import load_manifest
    it = int(load_manifest(prefix)["latest"]["iter"])
    hb2 = os.path.join(tmp, "hb-restart-2")
    procs = _cifar_procs(
        tmp, "relay-resume", 2,
        base + ["--rounds", "2", "--heartbeat-dir", hb2, "--quorum", "1",
                "--snapshot-prefix", prefix, "--resume", "auto",
                "--reshard", "auto"])
    rcs2 = _wait_procs(procs)
    logs2 = [_read(p[1]) for p in procs]
    wall = time.perf_counter() - t0
    for pid, text in enumerate(logs2):
        for line in text.strip().splitlines()[-4:]:
            print(f"[relay-resume {pid}] {line}")
    check(rcs2 == [0, 0], f"relaunch exited {rcs2}")
    check(all(f"resume auto: restored iter {it} " in t for t in logs2),
          f"the relaunch did not restore iter {it}")
    check(all(f"done: 2 rounds, iter={it + 2 * RELAY_TAU}" in t
              for t in logs2),
          "the relaunch did not go on from the manifest")
    print(f"[relay] coordinated restart: both survivors exit 4 on manifest "
          f"{sha[:16]} (iter {it}), the barrier {barrier} s; the 2-process "
          f"relaunch restored iter {it} and went on; {wall:.1f} s")
    out["restart"] = {"rcs": rcs, "sha": sha, "iter": it,
                      "barrier_s": barrier, "relaunch_rcs": rcs2,
                      "wall_s": wall}

    # 3. grow
    hb = os.path.join(tmp, "hb-grow")
    prefix = os.path.join(tmp, "grow", "snap")
    t0 = time.perf_counter()
    pair = _cifar_procs(
        tmp, "relay-pair", 2,
        base + ["--rounds", str(GROW_ROUNDS), "--heartbeat-dir", hb,
                "--quorum", "1", "--evict-after", "1", "--snapshot-prefix",
                prefix, "--snapshot-every", "1"])
    from sparknet_tpu_torch.resilience.checkpoint import manifest_path
    deadline = time.time() + RELAY_TIMEOUT
    while not os.path.exists(manifest_path(prefix)) and \
            time.time() < deadline and all(p.poll() is None
                                           for p, _, _ in pair):
        time.sleep(0.2)
    jlog = os.path.join(tmp, "relay-joiner.log")
    jmet = os.path.join(tmp, "relay-joiner.jsonl")
    env = {k: v for k, v in os.environ.items()
           if k not in ("SPARKNET_NUM_PROCESSES", "SPARKNET_PROCESS_ID")}
    with open(jlog, "w") as fh:
        joiner = subprocess.Popen(
            [sys.executable, "-m", "sparknet_tpu_torch", "cifar",
             *flags(1),
             "--rounds", str(JOINER_ROUNDS), "--heartbeat-dir", hb,
             "--grow", "--quorum", "1", "--evict-after", "1",
             "--snapshot-prefix", prefix, "--resume", "auto", "--reshard",
             "auto", "--metrics", jmet], cwd=REPO, stdout=fh,
            stderr=subprocess.STDOUT, env=env)
    rcs = _wait_procs(pair + [(joiner, jlog, jmet)])
    wall = time.perf_counter() - t0
    jtext = _read(jlog)
    for line in jtext.strip().splitlines()[-6:]:
        print(f"[relay-joiner] {line}")
    check(rcs == [0, 0, 0], f"grow run exited {rcs}: {jtext[-3000:]}")
    rs = _jsonl(jmet, "reshard")
    check(rs and rs[0]["from_world"]["processes"] == 2 and
          rs[0]["to_world"]["processes"] == 1,
          f"the joiner's reshard events {rs}")
    joined = [e for e in _jsonl(pair[0][2], "host_joined")]
    masks = []
    for name in sorted(os.listdir(hb)):
        if name.startswith("mask-") and name.endswith(".json"):
            rec = json.loads(_read(os.path.join(hb, name)))
            masks.append((rec["round"], rec["included"]))
    three = [r for r, inc in masks if sorted(inc) == [0, 1, 2]]
    check(joined and joined[0]["host"] == 2, f"host_joined {joined}")
    check(three, f"no round's mask counts three hosts: {masks}")
    print(f"[relay] grow: the joiner's reshard {rs[0]['from_world']} -> "
          f"{rs[0]['to_world']} ({rs[0]['direction']}), admitted as host 2 "
          f"at round {joined[0]['round']}; {len(three)} rounds counted three "
          f"hosts; {wall:.1f} s")
    out["grow"] = {"rcs": rcs, "reshard": rs[0], "joined": joined[0],
                   "three_host_rounds": len(three), "wall_s": wall}
    return out


def phase_hosts_all(torch, card, tmp, records, feeds):
    t0 = time.perf_counter()
    two_tier = phase_two_tier(torch, card)
    verb = phase_elastic_train_verb(records["solver"], card,
                                    feeds["cli"]["dp"]["launches"], tmp)
    relay = phase_relay_processes(tmp, card)
    wall = time.perf_counter() - t0
    print(f"[hosts] phase 14 wall time {wall:.1f} s")
    return {"two_tier": two_tier, "train_verb": verb, "relay": relay,
            "wall_s": wall}


# -- phase 15 -------------------------------------------------------------

MESH_SMALL = ["--vocab", "512", "--seq-len", "512", "--batch", "8",
              "--d-model", "256", "--layers", "2", "--heads", "4"]
# dp x tp x sp on one mesh: GSPMDSolver(seq_axis="seq"), which no verb
# flag builds (_gspmd_sp_setup)
GSPMD_SP = "gspmd dp 2 x tp 2 x sp 2"
GSPMD_SP_AXES = {"data": 2, "model": 2, "seq": 2}
MESH_PARITY = (("dp 4", ["--dp", "4"]),
               ("fsdp 4", ["--fsdp", "on", "--dp", "4"]),
               ("tp 2", ["--tp", "2"]),
               ("sp 4", ["--sp", "4"]),
               ("pipeline 2 x 4", ["--pipeline-stages", "2",
                                   "--microbatches", "4"]),
               (GSPMD_SP, []))
MESH_EP = ["--ep", "4", "--moe-experts", str(MOE_EXPERTS)]
MESH_SGD = ["--solver-type", "SGD", "--lr", "0.01"]
MESH_FULL = (("dp 4", ["--dp", "4"]),
             ("fsdp 4", ["--fsdp", "on", "--dp", "4"]),
             ("tp 2", ["--tp", "2"]),
             ("tp 4", ["--tp", "4"]),
             # b4 over 4 seq slots keeps the ring's f32 scores and
             # probabilities of every slot and layer, ~52 GB, beside the
             # step's own ~16 GB: without remat its peak read 77.2-80.0
             # GB of the card's 85 and ran out once in the whole script
             # (PERF.md, PR 14), so it runs under --remat full, b4
             ("sp 4", ["--sp", "4", "--remat", "full"]),
             ("pipeline 4 x 4", ["--pipeline-stages", "4",
                                 "--microbatches", "4"]),
             ("ep 4", MESH_EP),
             # each (data, model) group's attention runs on its gathered
             # sequence through the flash kernels: no S x S scores are
             # held, so no remat
             (GSPMD_SP, []))
MESH_STEPS = 3
MESH_LOSS_RTOL = 1e-5           # each step's loss against one device
MESH_PARAM_ATOL = 1e-4          # every param after the steps, max-abs
# the flash kernels at the per-slot shapes of the full-width branches:
# dp/fsdp slots and pipeline microbatches (1, 8, 4096, 128), tp 2 slots
# (4, 4, 4096, 128), a gspmd (data, model) group's gathered sequence
# (2, 4, 4096, 128)
MESH_FLASH_CASES = (((1, 8, 4096, 128), "bfloat16", True, True),
                    ((4, 4, 4096, 128), "bfloat16", True, True),
                    ((2, 4, 4096, 128), "bfloat16", True, True))
MESH_FLASH_PATH = {(1, 8, 4096, 128): "dp 4", (4, 4, 4096, 128): "tp 2",
                   (2, 4, 4096, 128): GSPMD_SP}


def _mesh_path(label):
    """The launch path a mesh branch's rows name: the lm verb's flags, or
    the GSPMD sequence branch, which has none."""
    return label if label == GSPMD_SP else f"lm --{label}"


def _mesh_setup(flags, device="cuda"):
    """The lm verb's solver and stream for ``flags`` (its own code path,
    cli.lm_setup), the sharding variables pinned first and --remat none
    unless the flags give a policy."""
    from sparknet_tpu_torch import cli
    os.environ["SPARKNET_FSDP"] = "off"
    os.environ["SPARKNET_TP"] = "0"
    remat = [] if "--remat" in flags else ["--remat", "none"]
    args = cli.parser().parse_args(
        ["lm", "--display", "0", "--seed", str(SEED), "--device", device]
        + remat + flags)
    return cli.lm_setup(args)


def _gspmd_sp_setup(flags, device="cuda"):
    """GSPMDSolver(seq_axis="seq") over GSPMD_SP_AXES with
    transformer_tp_rule(2) on the lm verb's flags, built as cli.lm_setup
    builds its tp branch (the JAX lm verb builds GSPMDSolver without a
    seq axis, so no flag reaches it), restored from --resume."""
    import torch
    from sparknet_tpu_torch import cli
    from sparknet_tpu_torch.data import lm_batch_stream
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.parallel import (GSPMDSolver, make_mesh,
                                             transformer_tp_rule)
    from sparknet_tpu_torch.proto import Message
    os.environ["SPARKNET_FSDP"] = "off"
    os.environ["SPARKNET_TP"] = "0"
    remat = [] if "--remat" in flags else ["--remat", "none"]
    args = cli.parser().parse_args(
        ["lm", "--display", "0", "--seed", str(SEED), "--device", device]
        + remat + flags)
    cli._apply_perf_flags(args)
    sp = Message("SolverParameter", base_lr=args.lr, lr_policy="fixed",
                 display=0, type=args.solver_type, random_seed=args.seed)
    net = zoo.transformer_lm(
        vocab_size=args.vocab, seq_len=args.seq_len, batch_size=args.batch,
        d_model=args.d_model, num_layers=args.layers, num_heads=args.heads,
        flash=not args.no_flash)
    solver = GSPMDSolver(
        sp, mesh=make_mesh(GSPMD_SP_AXES), seq_axis="seq",
        param_rule=transformer_tp_rule(GSPMD_SP_AXES["model"]),
        net_param=net, device=args.device,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else None)
    if args.resume:
        solver.restore(args.resume)
    stream, _ = lm_batch_stream(args.vocab, args.batch, args.seq_len,
                                seed=args.seed)
    return dict(solver=solver, stream=stream,
                branch='GSPMDSolver, seq_axis="seq"')


def _branch_setup(label, flags, device="cuda"):
    setup = _gspmd_sp_setup if label == GSPMD_SP else _mesh_setup
    return setup(flags, device=device)


def _lm_params_cpu(solver):
    """{name: [f64 CPU tensors]} of a solver's params in the
    single-device layout (the pipeline's stacked blocks unstacked)."""
    out = {}
    for name, blobs in solver.params.items():
        vals = [p.detach().double().cpu() for p in blobs]
        kind, _, layer = name.partition("/")
        if kind == "blocks":
            for i in range(vals[0].shape[0]):
                out[f"block{i}/{layer}"] = [v[i] for v in vals]
        else:
            out[layer if kind in ("prefix", "suffix") else name] = vals
    return out


def _param_error(params, ref):
    """Worst max |p - p_ref| over the blobs, and the blob."""
    worst, where = 0.0, None
    for name, refs in ref.items():
        for i, r in enumerate(refs):
            e = float((params[name][i] - r).abs().max())
            if e > worst:
                worst, where = e, f"{name}[{i}]"
    return worst, where


def _change_error_of(params, w0, ref):
    """Worst blob's max |dw - dw_ref| / max |dw_ref| (dw = w - w0): under
    plain SGD the first step's change is -lr times the gradient."""
    worst, where = 0.0, None
    for name, refs in ref.items():
        for i, r in enumerate(refs):
            dr = r - w0[name][i]
            e = float(((params[name][i] - w0[name][i]) - dr).abs().max()
                      / dr.abs().max().clamp_min(1e-30))
            if e > worst:
                worst, where = e, f"{name}[{i}]"
    return worst, where


def _to_pipeline(torch, solver, params):
    """Copy single-device LM params into a PipelineLMSolver's layout."""
    with torch.no_grad():
        for name, blobs in solver.params.items():
            kind, layer = name.split("/", 1)
            for i, b in enumerate(blobs):
                if kind == "blocks":
                    b.copy_(torch.stack([params[f"block{j}/{layer}"][i]
                                         for j in range(b.shape[0])]))
                else:
                    b.copy_(params[layer][i])


def phase_mesh_parity(torch, tmp, steps=MESH_STEPS, device="cuda"):
    """(a) On the card, a small LM (vocab 512, 2 layers, d 256, 4 heads, S
    512, batch 8, f32) from one init and one batch stream, under plain
    SGD (lr 0.01: a step's change is lr times the gradient, so the
    params read the gradients; under Adam a gradient that is zero up to
    rounding, or a ReLU input within rounding of 0, turns another
    summation order into a step of ~lr of either sign). Each mesh branch
    against the single-device port on the card: each step's loss within
    1e-5 relative, every param within 1e-4 max-abs after the steps, the
    first step's change within 1e-2 of each blob's largest (phase 7's
    weight-change measure); the GSPMD dp 2 x tp 2 x sp 2 mesh too
    (_gspmd_sp_setup). The EP branch (8 experts over 4 expert
    slots, each slot's own capacity, so no single device matches it)
    against the port's own EP run on the CPU at phase 11's MoE limits:
    each step's loss 1e-5, the first step's gradients 1e-4, the weight
    changes 1e-2 of each blob's largest, the routing of every token whose
    margin clears twice its card-CPU logit difference the same."""
    from sparknet_tpu_torch.ops import kernel_launches
    sgd = MESH_SMALL + MESH_SGD
    ref = _mesh_setup(sgd, device=device)
    solver, stream = ref["solver"], ref["stream"]
    _, state = solver.snapshot(os.path.join(tmp, "mesh_start"))
    w0 = _lm_params_cpu(solver)
    batches = [next(stream) for _ in range(steps)]
    ref_losses = [float(solver.train_step(batches[0]))]
    ref_first = _lm_params_cpu(solver)
    ref_losses += [float(solver.train_step(b)) for b in batches[1:]]
    ref_params = _lm_params_cpu(solver)
    del ref, solver
    out = {"single": {"losses": ref_losses}}
    for label, flags in MESH_PARITY:
        pipe = "--pipeline-stages" in flags
        run = _branch_setup(label, sgd + flags + ([] if pipe else
                                                  ["--resume", state]),
                            device=device)
        s = run["solver"]
        if pipe:
            _to_pipeline(torch, s, {k: [v.float() for v in vs]
                                    for k, vs in w0.items()})
        before = dict(kernel_launches())
        losses = [float(s.train_step(batches[0]))]
        first, where1 = _change_error_of(_lm_params_cpu(s), w0, ref_first)
        losses += [float(s.train_step(b)) for b in batches[1:]]
        launches = {k: v - before[k] for k, v in kernel_launches().items()}
        rels = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        err, where = _param_error(_lm_params_cpu(s), ref_params)
        print(f"[mesh] (a) {label} ({run['branch']}) against one device on "
              f"the card: first-step change {first:.3e} at {where1} (limit "
              f"{LM_WEIGHT_CHANGE_LIMIT:g}); losses {[round(x, 6) for x in losses]}, "
              f"relative {[f'{r:.2e}' for r in rels]} (limit "
              f"{MESH_LOSS_RTOL:g}); params max-abs {err:.3e} at {where} "
              f"(limit {MESH_PARAM_ATOL:g}); flash launches "
              f"{launches['flash_attention']}")
        check(first <= LM_WEIGHT_CHANGE_LIMIT, f"mesh {label}: the first "
              f"step's change differs from one device's by {first:.3e} "
              f"at {where1}")
        check(max(rels) <= MESH_LOSS_RTOL, f"mesh {label}: loss differs "
              f"from one device by {max(rels):.3e} relative")
        check(err <= MESH_PARAM_ATOL, f"mesh {label}: params differ from "
              f"one device by {err:.3e} at {where}")
        out[label] = {"losses": losses, "loss_rel_err": max(rels),
                      "first_change_err": first, "param_err": err,
                      "launches": launches}
        del run, s
        if device == "cuda":
            torch.cuda.empty_cache()
    out["ep 4"] = _mesh_ep_card_vs_cpu(torch, steps, device=device)
    return out


def _mesh_ep_card_vs_cpu(torch, steps, device="cuda"):
    """The EP branch on ``device`` against the same run on the CPU."""
    flags = MESH_SMALL + MESH_SGD + MESH_EP
    runs = {"card": _mesh_setup(flags, device=device),
            "cpu": _mesh_setup(flags, device="cpu")}
    card, cpu = runs["card"]["solver"], runs["cpu"]["solver"]
    w0 = _lm_params_cpu(cpu)
    batches = [next(runs["cpu"]["stream"]) for _ in range(steps)]
    # the routing of the first step's tokens, card against CPU
    dev_batch = {k: torch.as_tensor(v).to(card.device)
                 for k, v in batches[0].items()}
    with torch.no_grad():
        bc, _ = card.net.apply(card.params, {}, dev_batch, train=False)
        bp, _ = cpu.net.apply(cpu.params, {}, batches[0], train=False)
    unclear = 0
    for i in range(2):
        r = cpu.params[f"block{i}/moe"][0].detach().double().t()
        t = bp[f"block{i}/ln2"].double().reshape(-1, r.shape[0]) @ r
        c = bc[f"block{i}/ln2"].cpu().double().reshape(-1, r.shape[0]) @ r
        shift = (c - t).abs().max(dim=1).values.clamp_min(1e-6)
        top2 = t.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > ROUTING_FACTOR * shift
        same = c.argmax(1) == t.argmax(1)
        check(bool(same[clear].all()), f"mesh ep: block{i} tokens clear of "
              "their card-CPU shift route to different experts")
        unclear += int((~clear).sum())
    n_tok = 2 * batches[0]["data"].size
    check(unclear <= 0.02 * n_tok, f"mesh ep: {unclear} of {n_tok} tokens "
          "within twice their card-CPU logit shift")
    losses, grads = {}, {}
    decisions = []            # the CPU takes the card's expert ReLU
    for key, s in (("card", card), ("cpu", cpu)):   # decisions
        losses[key] = []
        with _expert_relu(torch, record=decisions if key == "card" else None,
                          replay=decisions if key == "cpu" else None) as flips:
            for j, b in enumerate(batches):
                losses[key].append(float(s.train_step(b)))
                if j == 0:
                    grads[key] = {n: [p.grad.detach().double().cpu()
                                      for p in ps]
                                  for n, ps in s.params.items()}
    _check_relu_flips(flips, "mesh")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["cpu"]))
    g_err, g_where = 0.0, None
    for n, gs in grads["cpu"].items():
        for i, g in enumerate(gs):
            e = float((grads["card"][n][i] - g).abs().max()
                      / g.abs().max().clamp_min(1e-30))
            if e > g_err:
                g_err, g_where = e, f"{n}[{i}]"
    dw_ref = {n: [p - w0[n][i] for i, p in enumerate(ps)]
              for n, ps in _lm_params_cpu(cpu).items()}
    w_err, w_where = _weight_change_error(card.params, w0, dw_ref)
    print(f"[mesh] (a) ep 4 x {MOE_EXPERTS} experts, card against the CPU: "
          f"losses {[round(x, 6) for x in losses['card']]}, worst relative "
          f"{rel:.3e} (limit {MESH_LOSS_RTOL:g}); first-step gradients "
          f"{g_err:.3e} at {g_where} (limit {LM_GRAD_LIMIT:g}); weight "
          f"changes {w_err:.3e} at {w_where} (limit "
          f"{LM_WEIGHT_CHANGE_LIMIT:g}); {unclear} of {n_tok} tokens "
          f"within {ROUTING_FACTOR:g}x their logit shift")
    check(rel <= MESH_LOSS_RTOL, f"mesh ep: loss card-vs-CPU {rel:.3e}")
    check(g_err <= LM_GRAD_LIMIT, f"mesh ep: gradients {g_err:.3e} at "
          f"{g_where}")
    check(w_err <= LM_WEIGHT_CHANGE_LIMIT, f"mesh ep: weight changes "
          f"{w_err:.3e} at {w_where}")
    return {"losses": losses, "loss_rel_err": rel, "grad_err": g_err,
            "weight_change_err": w_err, "unclear_tokens": unclear,
            "tokens": n_tok,
            "relu_flips": {k: flips[k] for k in ("units", "near", "taken",
                                                 "clear")}}


def _mesh_full_run(torch, card, label, flags, steps, device="cuda"):
    """One full-width branch through the lm verb's setup: steps timed by
    CUDA synchronisation, tokens/s, the peak allocated memory, the
    kernels' launches a step."""
    from sparknet_tpu_torch.ops import KERNEL_WRAPPERS, kernel_launches
    f = LM_FULL
    full = ["--vocab", str(f["vocab"]), "--seq-len", str(f["seq_len"]),
            "--batch", str(f["batch"]), "--d-model", str(f["d_model"]),
            "--layers", str(f["layers"]), "--heads", str(f["heads"]),
            "--dtype", "bf16"]
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run = _branch_setup(label, full + flags, device=device)
    s, stream = run["solver"], run["stream"]
    _zero_launches()
    times, losses = [], []
    for _ in range(steps):
        b = next(stream)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(s.train_step(b)))     # the fetch synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    step_ms = statistics.median(times)
    tps = f["batch"] * f["seq_len"] / (step_ms / 1e3)
    per_step = {k: v / steps for k, v in launches.items()}
    check(all(np.isfinite(losses)), f"mesh {label}: non-finite losses "
          f"{losses}")
    print(f"[mesh] (b) {label} ({run['branch']}): losses "
          f"{[round(x, 4) for x in losses]}, step {step_ms:.1f} ms (median "
          f"of {steps}), {tps:,.0f} tokens/s, peak allocated {peak:.1f} GB, "
          f"flash launches a step {per_step['flash_attention']:g} / "
          f"{per_step['flash_attention_dq']:g} / "
          f"{per_step['flash_attention_dkv']:g}; {card}")
    del run, s
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    if cuda:
        torch.cuda.empty_cache()
    return {"branch": label, "losses": losses, "step_ms": step_ms,
            "step_ms_all": times, "tokens_per_s": tps, "peak_gb": peak,
            "launches": launches, "launches_per_step": per_step}


def phase_mesh_full(torch, card, steps=MESH_STEPS, device="cuda"):
    """(b) The full-width LM (bench.py's row: vocab 8192, S 4096, batch 4,
    d 1024, 12 layers, 8 heads, bf16 over f32 masters, Adam) through the
    lm verb's setup on every branch, and the MoE row (8 experts, F 4096,
    top-1, capacity 1.25) over 4 expert slots; --sp 4 under --remat full
    at the same widths (MESH_FULL says why); the GSPMD dp 2 x tp 2 x sp 2
    mesh (_gspmd_sp_setup), whose flash kernels must launch once a block
    and (data, model) group a step."""
    out = {}
    for label, flags in MESH_FULL:
        out[label] = _mesh_full_run(torch, card, label, flags, steps,
                                    device=device)
        if device == "cuda":
            want = label != "sp 4"
            got = out[label]["launches"]
            check(all((got[k] > 0) == want for k in FLASH_KERNELS),
                  f"mesh {label}: flash launches {got}")
            if label == GSPMD_SP:
                # each block's kernels once per (data, model) group a step
                n = LM_FULL["layers"] * GSPMD_SP_AXES["data"] * \
                    GSPMD_SP_AXES["model"]
                per = out[label]["launches_per_step"]
                check(all(per[k] == n for k in FLASH_KERNELS),
                      f"mesh {label}: flash launches a step {per}, want "
                      f"{n} each")
    os.environ["SPARKNET_REMAT"] = "none"
    return out


def phase_mesh_all(torch, card, tmp):
    t0 = time.perf_counter()
    parity = phase_mesh_parity(torch, tmp)
    t1 = time.perf_counter()
    full = phase_mesh_full(torch, card)
    t2 = time.perf_counter()
    flash = phase_flash_kernels(torch, cases=MESH_FLASH_CASES)
    for r in flash:
        r["launches_path"] = MESH_FLASH_PATH[tuple(r["shape"])]
    wall = time.perf_counter() - t0
    print(f"[mesh] phase 15 wall time {wall:.1f} s: (a) {t1 - t0:.1f}, "
          f"(b) {t2 - t1:.1f}, (c) {time.perf_counter() - t2:.1f}")
    return {"parity": parity, "full": full, "flash": flash, "wall_s": wall}


# -- phase 16 -------------------------------------------------------------

FISSION_STEPS = 20
FISSION_LOSS_RTOL = 1e-4        # each step's loss, fission on against off
FISSION_PARAM_ATOL = 1e-4       # every param after the steps, max-abs
# each step's weight change, leaf by leaf, of the leaf's largest change.
# Fission reorders float32 sums, and a leaf whose change is a long sum
# that nearly cancels (a bias) keeps the most of it: 2.9e-4 to 5.5e-3 on
# an H100 over 20 steps. float64 closes the gap (1.2e-15 against 1.65e-3
# in float32 on the CPU), and a dropped branch gradient moves a leaf by
# 1.0-1.4 (tests/test_torch_fission.py).
FISSION_DW_RTOL = 5e-2
FISSION_SERVE_LIMIT = 1e-3      # bucket-8 logits, of the largest (phase 4's)
SCAN_STEPS = 3
SCAN_LOSS_RTOL = 1e-5           # each step's loss, --scan on against off
HOST_STEPS = 10                 # timed host-transform steps an arm
EVENT_ITERS = 60                # past the stager's gauge at its 50th put
LEVELDB_RECORDS = 2000
# the fields of the JAX package's emit sites: PrefetchIterator.stats()
# with the train verb's extras, H2DStager's h2d_stage, and the device
# cache's gauges (sparknet_tpu/data/prefetch.py, device_cache.py)
PREFETCH_FIELDS = {"name", "gets", "depth_cap", "depth_mean", "empty_frac",
                   "echo", "staging"}
H2D_FIELDS = {"name", "puts", "bytes", "kb_per_item", "dispatch_ms",
              "wait_ms", "in_flight", "slots"}
CACHE_FIELDS = {"source", "records", "nbytes", "hits", "misses", "hit_rate"}


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _empty_cache(torch, device):
    if device == "cuda":
        torch.cuda.empty_cache()


def _conv_window(torch, fn, reps=2):
    """Convolution kernels a call (cuDNN forward and backward, by
    phase 5's grouping) and the device's busy share over ``reps`` calls
    under torch.profiler, after one call outside the window; None when
    the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof, reps)
    busy = sum(ms for ms, _, _ in events)
    if busy <= 0:
        return None
    conv = sum(n for _, n, key in events
               if _train_group(key.lower()).startswith("convolution"))
    return {"conv_launches": conv, "busy_share": busy * reps / wall,
            "device_ms": busy, "wall_ms": wall / reps}


def _copy_tree(dst, src):
    """Copy a nest of tensors (dicts, lists) into ``dst`` in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _copy_tree(a, b)
    else:
        dst.copy_(src)


# The aux heads' ReLUs right after a leaf and the leaf (a layer whose
# params' rows are its output units: the fc's rows, the conv's output
# channels). In lock step both arms start from the same params, but
# fission reorders the float32 sums before each ReLU, and a unit within
# rounding of zero can take another sign in the two arms; the backward
# then passes that unit's gradient in one arm only, and its row of the
# leaf's update differs by one sample's share: loss1/fc[0] read 7.899e-02
# at one step on an H100 (the limit 5e-2) with fission code unchanged.
FISSION_RELUS = {f"loss{h}/relu_{u}": f"loss{h}/{u}"
                 for h in (1, 2) for u in ("conv", "fc")}
# a planted fault in the on arm's update that the check must reject: an
# inception branch's update negated, and that of a leaf whose rows the
# attribution may leave out
FISSION_FAULTS = ("inception_4a/3x3", "loss1/fc")


@contextlib.contextmanager
def _relu_inputs(solver, record):
    """Around ``solver``'s steps: each FISSION_RELUS layer's input (the
    leaf's output, before the ReLU) is kept in ``record`` by layer name,
    the layer's output unchanged."""
    patched = []
    for lp, impl, _, _ in solver.net.layers:
        if lp.name in FISSION_RELUS:
            def apply(params, bottoms, train, _run=impl.apply,
                      _name=lp.name):
                record[_name] = bottoms[0].detach().clone()
                return _run(params, bottoms, train)
            impl.apply = apply
            patched.append(impl)
    try:
        yield record
    finally:
        for impl in patched:
            del impl.apply


def _relu_flips(torch, pre_on, pre_off):
    """The units where a FISSION_RELUS ReLU's input took another sign in
    the two arms: {leaf: (units, near, clear)}, units the leaf's rows
    (output units) with a flip, ``near`` the flips at a near-tie (both
    inputs within ROUTING_FACTOR times the largest on-off difference of
    that layer's inputs that kept their sign), ``clear`` the others."""
    out = {}
    for name, leaf in FISSION_RELUS.items():
        a, b = pre_on[name].double(), pre_off[name].double()
        flip = (a > 0) != (b > 0)
        shift = float((a - b).abs()[~flip].max()) if bool(
            (~flip).any()) else 0.0
        near = flip & (torch.maximum(a.abs(), b.abs())
                       <= ROUTING_FACTOR * shift)
        units = flip.transpose(0, 1).reshape(flip.shape[1], -1).any(-1)
        out[leaf] = (units.cpu(), int(near.sum()), int((flip & ~near).sum()))
    return out


def _leaf_gap(d_on, d_off):
    """max |d_on - d_off| over max |d_off|: one leaf's update gap."""
    if not d_off.numel():
        return 0.0
    return float((d_on - d_off).abs().max()) / max(
        float(d_off.abs().max()), 1e-30)


def _attributed_gap(torch, start, on, off, flips):
    """One step's weight changes from ``start``, the on arm's against the
    off arm's, leaf by leaf, with the ReLU flips attributed: -> (the worst
    leaf gap and its leaf, the worst gap after attribution, what fails or
    None, the largest |d_off| of any leaf). A leaf over FISSION_DW_RTOL
    passes only if it is a FISSION_RELUS leaf whose ReLU flipped at
    near-ties alone and whose other rows (the units that did not flip)
    read within the limit; a flip at a clear input fails."""
    worst, after, top, failed = (0.0, None), 0.0, 0.0, None
    clear = {leaf: f[2] for leaf, f in flips.items() if f[2]}
    if clear:
        failed = (f"ReLU inputs clear of a near-tie took another sign in "
                  f"the two arms: {clear}")
    for k, v in start.items():
        for i, p0 in enumerate(v):
            d_on = on[k][i].detach() - p0
            d_off = off[k][i].detach() - p0
            top = max(top, float(d_off.abs().max()))
            gap = _leaf_gap(d_on, d_off)
            if gap > worst[0]:
                worst = (gap, f"{k}[{i}]")
            if gap > FISSION_DW_RTOL and k in flips and bool(
                    flips[k][0].any()):
                keep = ~flips[k][0].to(d_on.device)
                gap = _leaf_gap(d_on[keep], d_off[keep])
            after = max(after, gap)
            if gap > FISSION_DW_RTOL and failed is None:
                failed = (f"a step's update of {k}[{i}] differs by "
                          f"{gap:.3e} of its largest change")
    return worst, after, failed, top


def _set_fission(arm):
    os.environ["SPARKNET_FISSION"] = "1" if arm == "on" else "0"


def phase_fission(torch, card, tmp, batch=32, steps=FISSION_STEPS,
                  device="cuda"):
    """GoogLeNet b32 training (dropout 0) with inception fission on (the
    default) and off, two Solvers from the same weights on the same
    batches. Free-running, ``steps`` steps each: each arm's step median,
    the port kernels' launches (equal in both arms), the convolution
    kernels a step and busy share (a profiler window), and how far the
    two trajectories drift apart (printed: the random-init net's
    training amplifies any change of summation order step by step).
    Then ``steps`` steps in lock step under deterministic cuDNN: before
    each, the off arm takes the on arm's params and momentum, and the
    step's loss must agree within 1e-4 relative, every param after it
    within 1e-4 max-abs, and each leaf's weight change within
    FISSION_DW_RTOL of that leaf's largest change, but for the rows of
    an aux-head leaf whose ReLU took another sign in the two arms at a
    near-tie (_attributed_gap; a flip at a clear input fails), and the
    last step's update with a planted fault (FISSION_FAULTS) must fail
    that check. Last, a
    bucket-8 batch served under both, within 1e-3 of the largest
    logit, and each arm's bucket-8 forward (phase 4's timing)."""
    from sparknet_tpu_torch.graph import CompiledNet, TEST
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.ops import kernel_launches
    from sparknet_tpu_torch.resilience import save_model_snapshot
    from sparknet_tpu_torch.serve import ServeEngine, deploy_net_param
    from sparknet_tpu_torch.solver import Solver
    os.environ.pop("SPARKNET_EPILOGUE", None)
    rs = np.random.RandomState(SEED + 16)
    feeds = [{k: torch.as_tensor(v).to(device) for k, v in
              _batch(rs, batch).items()} for _ in range(4)]
    arms, solvers = {}, {}
    try:
        for arm in ("on", "off"):
            solvers[arm] = Solver(_googlenet_solver(
                batch, os.path.join(tmp, f"fission_{arm}"), dropout=False),
                device=device, log_fn=None)
        with torch.no_grad():
            _copy_tree(solvers["off"].params, solvers["on"].params)
        w0 = {k: [p.detach().cpu().numpy().copy() for p in v]
              for k, v in solvers["on"].params.items()}
        for arm, solver in solvers.items():
            _set_fission(arm)
            _zero_launches()
            losses, times = [], []
            for i in range(steps):
                _sync(torch, device)
                t0 = time.perf_counter()
                losses.append(float(solver.train_step(feeds[i % 4])))
                times.append((time.perf_counter() - t0) * 1e3)
            launches = kernel_launches()
            ms = statistics.median(times[1:])
            arms[arm] = {"losses": losses, "step_ms": ms, "steps_ms": times,
                         "launches": launches}
            check(all(np.isfinite(losses)), f"fission {arm}: losses "
                  f"{losses}")
        drift_loss = max(abs(a - b) / abs(b) for a, b in
                         zip(arms["on"]["losses"], arms["off"]["losses"]))
        drift = max(float((a - b).detach().abs().max())
                    for k, v in solvers["on"].params.items()
                    for a, b in zip(v, solvers["off"].params[k]))
        moved = max(float(np.abs(a.detach().cpu().numpy() - b).max())
                    for k, v in solvers["on"].params.items()
                    for a, b in zip(v, w0[k]))
        for arm, solver in solvers.items():
            _set_fission(arm)
            window = _conv_window(torch, lambda: solver.train_step(
                feeds[0])) if device == "cuda" else None
            arms[arm]["window"] = window
            conv = "not measured" if window is None else \
                f"{window['conv_launches']} convolution kernels a step, " \
                f"device busy {100 * window['busy_share']:.1f}%"
            print(f"[fission] GoogLeNet b{batch}, fission {arm}: step "
                  f"{arms[arm]['step_ms']:.2f} ms (median of {steps - 1}, "
                  f"host clock around the step and its loss), {conv}; "
                  f"launches {arms[arm]['launches']}; {card}")
        print(f"[fission] free-running {steps} steps: the arms drift "
              f"{drift_loss:.3e} apart in loss (relative) and {drift:.3e} "
              f"in params (max-abs), the largest move from the start "
              f"{moved:.3e}")
        check(arms["on"]["launches"] == arms["off"]["launches"],
              "fission changed the port kernels' launches")
        lock_loss = lock_param = 0.0
        dw_gaps, dw_tops, dw_after, dw_failed, dw_flips = [], [], [], [], []
        determ = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for i in range(steps):
                with torch.no_grad():
                    _copy_tree(solvers["off"].params, solvers["on"].params)
                    _copy_tree(solvers["off"].history,
                               solvers["on"].history)
                    start = {k: [p.detach().clone() for p in v]
                             for k, v in solvers["on"].params.items()}
                solvers["off"].iter = solvers["on"].iter
                step, pre = {}, {"on": {}, "off": {}}
                for arm, solver in solvers.items():
                    _set_fission(arm)
                    with _relu_inputs(solver, pre[arm]):
                        step[arm] = float(solver.train_step(feeds[i % 4]))
                lock_loss = max(lock_loss, abs(step["on"] - step["off"])
                                / abs(step["off"]))
                lock_param = max(lock_param, max(
                    float((a - b).detach().abs().max())
                    for k, v in solvers["on"].params.items()
                    for a, b in zip(v, solvers["off"].params[k])))
                flips = _relu_flips(torch, pre["on"], pre["off"])
                gap, after, failed, top = _attributed_gap(
                    torch, start, solvers["on"].params,
                    solvers["off"].params, flips)
                dw_gaps.append(gap)
                dw_tops.append(top)
                dw_after.append(after)
                dw_failed.append(failed)
                dw_flips.append({leaf: [int(f[0].sum()), f[1], f[2]]
                                 for leaf, f in flips.items()})
            # the planted faults, on the last step's update
            planted = {}
            for fault in FISSION_FAULTS:
                bad = {k: [p.detach().clone() for p in v]
                       for k, v in solvers["on"].params.items()}
                bad[fault] = [2 * p0 - p for p0, p in zip(start[fault],
                                                          bad[fault])]
                planted[fault] = _attributed_gap(
                    torch, start, bad, solvers["off"].params, flips)[2]
                del bad
        finally:
            torch.backends.cudnn.deterministic = determ
        worst = max(dw_gaps)
        print(f"[fission] lock step, {steps} steps each from the on arm's "
              f"state, cuDNN deterministic: losses within {lock_loss:.3e} "
              f"relative (limit {FISSION_LOSS_RTOL:g}), params after each "
              f"step within {lock_param:.3e} max-abs (limit "
              f"{FISSION_PARAM_ATOL:g}); each step's update, leaf by "
              f"leaf, within {worst[0]:.3e} of the leaf's largest change "
              f"({worst[1]}, step {dw_gaps.index(worst)}; limit "
              f"{FISSION_DW_RTOL:g})")
        print(f"[fission] lock step, each step's worst leaf gap "
              f"{[float(f'{g:.3e}') for g, _ in dw_gaps]} ("
              f"{[leaf for _, leaf in dw_gaps]}), after the ReLU flips' "
              f"rows are left out {[float(f'{g:.3e}') for g in dw_after]}, "
              f"and largest update (max-abs over all leaves) "
              f"{[float(f'{t:.3e}') for t in dw_tops]}")
        detail = "; ".join(
            f"step {i}: " + ", ".join(f"{k} {v}" for k, v in f.items()
                                      if v[0])
            for i, f in enumerate(dw_flips) if any(v[0] for v in f.values()))
        print(f"[fission] lock step, the aux heads' ReLU units with a flip "
              f"per step {[sum(v[0] for v in f.values()) for f in dw_flips]}"
              f" ({detail or 'none'}; leaf: [units with a flip, flips at a "
              "near-tie, flips at a clear input])")
        for fault, why in planted.items():
            print(f"[fission] planted fault, {fault}'s update negated in the "
                  f"on arm at the last step: {why or 'passed the check'}")
            check(why is not None, f"fission: the planted fault in "
                  f"{fault} passed the update check")
        check(lock_loss <= FISSION_LOSS_RTOL, f"fission: losses differ by "
              f"{lock_loss:.3e} relative")
        check(lock_param <= FISSION_PARAM_ATOL, f"fission: params differ by "
              f"{lock_param:.3e}")
        for i, failed in enumerate(dw_failed):
            check(failed is None, f"fission: lock step {i}: {failed}")
        check(moved > 10 * FISSION_PARAM_ATOL, "fission: the params barely "
              "moved, the param check reads nothing")
        solvers.clear()
        _empty_cache(torch, device)
        # serving: one deploy snapshot, a bucket-8 batch under both
        net = CompiledNet(deploy_net_param(zoo.googlenet(
            batch_size=8, with_aux=False)), TEST, device="cpu")
        params, state = net.init(torch.Generator().manual_seed(SEED))
        prefix = os.path.join(tmp, "fission_serve")
        save_model_snapshot(net, params, prefix, iter=0, state=state)
        engine = ServeEngine(prefix, max_batch=8, device=device,
                             log_fn=None)
        engine.load()
        x = np.round(rs.randn(8, 3, 224, 224), 3).astype(np.float32)
        feeds8 = {"data": torch.as_tensor(x).to(device)}
        served, serve_ms = {}, {}
        for arm in ("on", "off"):
            _set_fission(arm)
            served[arm] = engine.forward({"data": x})[0]["loss3/classifier"]
            # phase 4's reading: the bucket's forward over CUDA events
            serve_ms[arm] = Timer(torch, reps=20)(
                lambda: engine.run_bucket(8, feeds8)) \
                if device == "cuda" else None
        ref = served["off"]
        serve_err = float(np.abs(served["on"] - ref).max()
                          / np.abs(ref).max())
        print(f"[fission] served bucket 8: on against off {serve_err:.3e} "
              f"of the largest logit (limit {FISSION_SERVE_LIMIT:g}); "
              f"device forward on {serve_ms['on']} ms, off "
              f"{serve_ms['off']} ms (median of 20, CUDA events); {card}")
        check(np.abs(ref).max() > 0, "fission serve: all-zero logits")
        check(serve_err <= FISSION_SERVE_LIMIT, f"fission serve: "
              f"{serve_err:.3e}")
        del engine
    finally:
        os.environ.pop("SPARKNET_FISSION", None)       # the default: on
    return {"arms": arms, "drift_loss_rel": drift_loss,
            "drift_param_max_abs": drift, "moved": moved,
            "lock_loss_rel_err": lock_loss,
            "lock_param_max_abs_err": lock_param,
            "lock_update_gap": worst[0], "lock_update_gap_leaf": worst[1],
            "lock_update_gaps": [g for g, _ in dw_gaps],
            "lock_update_gaps_attributed": dw_after,
            "lock_relu_flips": dw_flips,
            "lock_update_max": dw_tops, "serve_err": serve_err,
            "serve_b8_ms": serve_ms}


class _NumpyHostPath:
    """The native library switched off for a measurement: its entry
    points take their numpy paths, as where it does not build."""

    def __enter__(self):
        from sparknet_tpu_torch import native
        self.native, self.load = native, native._load
        native._load = lambda: None
        return self

    def __exit__(self, *exc):
        self.native._load = self.load
        return False


def phase_native_host(torch, card, tmp, db, solver_path, steps=HOST_STEPS,
                      device="cuda"):
    """The native host library: built (available() true); at CaffeNet's
    b256 (3x256x256 uint8, 227 crops, mirror), its transform against the
    numpy path and the device transform, bit for bit, for every mean
    kind; the train verb's --host-transform feed on phase 9's records
    (the source, a PrefetchIterator with the H2DStager) through one
    Solver, native and numpy, step medians over CUDA events; and a
    LevelDB read, native against pure Python."""
    from sparknet_tpu_torch import native
    from sparknet_tpu_torch.data import device_transform
    from sparknet_tpu_torch.data.datum import array_to_datum
    from sparknet_tpu_torch.data.db_source import build_db_feed
    from sparknet_tpu_torch.data.leveldb import LevelDBReader, LevelDBWriter
    from sparknet_tpu_torch.data.prefetch import H2DStager, PrefetchIterator
    from sparknet_tpu_torch.graph.compiler import TRAIN
    from sparknet_tpu_torch.ops import kernel_launches
    from sparknet_tpu_torch.proto import text_format
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.solver.solver import resolve_nets
    check(native.available(), "the native host library did not build")
    print(f"[native] {native.library_path()}")
    rs = np.random.RandomState(SEED + 17)
    n, (c, h, w), crop = CAFFENET_BATCH, RECORD_SHAPE, CAFFENET_CROP
    images = rs.randint(0, 256, (n, c, h, w)).astype(np.uint8)
    ys = rs.randint(0, h - crop + 1, n).astype(np.int32)
    xs = rs.randint(0, w - crop + 1, n).astype(np.int32)
    flips = rs.randint(0, 2, n).astype(np.uint8)
    kinds = {"none": (None, 1.0),
             "channel": ((rs.rand(c) * 128).astype(np.float32), 0.0078125),
             "crop_image": ((rs.rand(c, crop, crop) * 128).astype(
                 np.float32), 0.017),
             "full_image": ((rs.rand(c, h, w) * 128).astype(np.float32),
                            1.0)}
    x_card = torch.from_numpy(images).to(device)
    transform = {}
    for kind, (mean, scale) in kinds.items():
        args = (images, crop, ys, xs, flips, mean, scale,
                kind == "full_image")
        got = native.transform_batch(*args)
        with _NumpyHostPath():
            ref = native.transform_batch(*args)
        dev = device_transform.transform_batch(
            x_card, crop, ys=ys, xs=xs, mirror=flips, mean=mean,
            scale=scale, full_mean=kind == "full_image").cpu().numpy()
        same = bool(np.array_equal(got, ref)) and \
            bool(np.array_equal(got, dev))
        native_ms = _host_ms(lambda: native.transform_batch(*args))
        with _NumpyHostPath():
            numpy_ms = _host_ms(lambda: native.transform_batch(*args),
                                reps=3)
        transform[kind] = {"bitwise": same, "native_ms": native_ms,
                           "numpy_ms": numpy_ms}
        print(f"[native] b{n} transform, mean {kind}: native {native_ms:.1f}"
              f" ms, numpy {numpy_ms:.1f} ms (host, median); equal to the "
              f"numpy path and the device transform: {same}")
        check(same, f"native transform ({kind}) differs")
    # the --host-transform feed, native against numpy, one Solver
    sp = text_format.load(solver_path, "SolverParameter")
    train_np, _ = resolve_nets(sp, db)
    shapes, probe = build_db_feed(train_np, TRAIN, db, seed=SEED,
                                  device_transform=False)
    probe.close()
    solver = Solver(sp, base_dir=db, feed_shapes=shapes, device=device,
                    log_fn=None)
    solver.set_input_transform(None)
    arms = {}
    for arm in ("native", "numpy"):
        with _NumpyHostPath() if arm == "numpy" else \
                contextlib.nullcontext():
            _, src = build_db_feed(train_np, TRAIN, db, seed=SEED,
                                   device_transform=False)
            data = PrefetchIterator(iter(src), depth=3, transform=H2DStager(
                slots=2, device=device), name="train_feed")
            try:
                for _ in range(2):                      # warm-up
                    solver.train_step(next(data))
                _sync(torch, device)
                _zero_launches()
                if device == "cuda":
                    times = _step_events(torch, solver, data, steps)
                else:
                    times = [_host_ms(lambda: float(solver.train_step(
                        next(data))), reps=1) for _ in range(steps)]
                launches = kernel_launches()
            finally:
                data.close()
                src.close()
        ms = statistics.median(times)
        arms[arm] = {"step_ms": ms, "steps_ms": times, "launches": launches,
                     "images_per_s": n / (ms / 1e3)}
        print(f"[native] CaffeNet b{n} --host-transform, {arm}: step "
              f"{ms:.2f} ms (median of {steps} over CUDA events between "
              f"steps; {[round(t, 2) for t in times]}), "
              f"{n / (ms / 1e3):,.0f} images/s; LRN launches "
              f"{launches['lrn_across']} forward, "
              f"{launches['lrn_across_bwd']} backward; {card}")
        want = 2 * steps * (device == "cuda")
        check(launches["lrn_across"] == want and
              launches["lrn_across_bwd"] == want,
              f"host-transform {arm}: LRN launches {launches}")
    del solver
    _empty_cache(torch, device)
    # a LevelDB of CIFAR-sized Datums, read whole, native and pure Python
    path = os.path.join(tmp, "leveldb16")
    with LevelDBWriter(path) as wr:
        for i in range(LEVELDB_RECORDS):
            wr.put(b"%08d" % i, array_to_datum(
                rs.randint(0, 256, (3, 32, 32)).astype(np.uint8), i % 10))
    reads = {}
    for verify in (False, True):
        for arm in ("native", "python"):
            with _NumpyHostPath() if arm == "python" else \
                    contextlib.nullcontext():
                t0 = time.perf_counter()
                with LevelDBReader(path, verify_checksums=verify) as r:
                    count = sum(1 for _ in r.items())
                secs = time.perf_counter() - t0
            check(count == LEVELDB_RECORDS, f"LevelDB read {count} records")
            key = f"{arm}{', crc verified' if verify else ''}"
            reads[key] = LEVELDB_RECORDS / secs
            print(f"[native] LevelDB read of {LEVELDB_RECORDS} 3x32x32 "
                  f"Datums, {key}: {reads[key]:,.0f} records/s")
    return {"library": native.library_path(), "transform": transform,
            "host_transform": arms, "leveldb_records_per_s": reads}


def phase_lm_scan(torch, card, steps=SCAN_STEPS, device="cuda"):
    """The lm verb's setup (cli.lm_setup) at phase 7's full width with
    --scan off, then --scan on, from one seed and one stream: each
    step's loss within 1e-5 relative (bit for bit said when seen), the
    step median and the flash launches (each kernel once a layer a
    step)."""
    from sparknet_tpu_torch.ops import kernel_launches
    f = LM_FULL
    full = ["--vocab", str(f["vocab"]), "--seq-len", str(f["seq_len"]),
            "--batch", str(f["batch"]), "--d-model", str(f["d_model"]),
            "--layers", str(f["layers"]), "--heads", str(f["heads"]),
            "--dtype", "bf16"]
    arms = {}
    try:
        for mode in ("off", "on"):
            run = _mesh_setup(full + ["--scan", mode], device=device)
            s, stream = run["solver"], run["stream"]
            runs = s.net._scan_runs()
            check(s.net._scan_enabled() == (mode == "on") and len(runs) == 1
                  and runs[0]["n"] == f["layers"],
                  f"--scan {mode}: enabled {s.net._scan_enabled()}, runs "
                  f"{[(r['n'], r['glen']) for r in runs]}")
            _zero_launches()
            times, losses = [], []
            for _ in range(steps):
                b = next(stream)
                _sync(torch, device)
                t0 = time.perf_counter()
                losses.append(float(s.train_step(b)))
                times.append((time.perf_counter() - t0) * 1e3)
            launches = kernel_launches()
            ms = statistics.median(times)
            arms[mode] = {"losses": losses, "step_ms": ms,
                          "steps_ms": times, "launches": launches}
            print(f"[scan] lm --scan {mode} at full width: losses "
                  f"{losses}, step {ms:.1f} ms (median of {steps}, host "
                  f"clock around the step and its loss), flash launches "
                  f"{sum(launches[k] for k in FLASH_KERNELS) / steps:g} a "
                  f"step; {card}")
            for k in FLASH_KERNELS:
                check(launches[k] == f["layers"] * steps * (device == "cuda"),
                      f"--scan {mode}: {k} launched {launches[k]} times")
            del run, s
            _empty_cache(torch, device)
    finally:
        os.environ.pop("SPARKNET_SCAN", None)
    err = max(abs(a - b) / abs(b) for a, b in
              zip(arms["on"]["losses"], arms["off"]["losses"]))
    bitwise = arms["on"]["losses"] == arms["off"]["losses"]
    print(f"[scan] on against off: losses within {err:.3e} relative "
          f"(limit {SCAN_LOSS_RTOL:g}); bit for bit: {bitwise}")
    check(err <= SCAN_LOSS_RTOL, f"--scan on: losses differ by {err:.3e}")
    return {"arms": arms, "loss_rel_err": err, "bitwise": bitwise}


def phase_input_events(torch, card, tmp, device="cuda"):
    """`train --metrics` on the card on a small LMDB (256 Datums of
    3x36x36, cifar10_full b16 on 32 crops with mirror, the default
    device-cached feed) for EVENT_ITERS iterations in process: the
    stream holds prefetch, h2d_stage and device_cache events with the
    JAX emit sites' fields, and the report verb reads them."""
    import io
    from sparknet_tpu_torch import cli
    from sparknet_tpu_torch.data.datum import array_to_datum
    from sparknet_tpu_torch.data.lmdb import LMDBWriter
    from sparknet_tpu_torch.models import zoo
    from sparknet_tpu_torch.proto import Message, text_format
    d = os.path.join(tmp, "events16")
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(SEED + 18)
    with LMDBWriter(os.path.join(d, "train_lmdb")) as wr:
        for i in range(256):
            wr.put(b"%05d" % i, array_to_datum(
                rs.randint(0, 256, (3, 36, 36)).astype(np.uint8), i % 10))
    net = Message("NetParameter", name="events")
    lp = Message("LayerParameter", name="data", type="Data",
                 data_param=dict(source="train_lmdb", batch_size=16,
                                 backend="LMDB"),
                 transform_param=dict(crop_size=32, mirror=True))
    lp.top.extend(["data", "label"])
    net.layer.append(lp)
    for layer in zoo.cifar10_full(batch_size=16, with_data=False).layer:
        net.layer.append(layer)
    text_format.dump(net, os.path.join(d, "train_val.prototxt"))
    sp = Message("SolverParameter", net="train_val.prototxt", base_lr=0.001,
                 momentum=0.9, lr_policy="fixed", display=20,
                 max_iter=EVENT_ITERS, random_seed=SEED)
    solver_path = os.path.join(d, "solver.prototxt")
    text_format.dump(sp, solver_path)
    metrics = os.path.join(d, "m.jsonl")
    buf = io.StringIO()
    _zero_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", "--solver", solver_path, "--metrics",
                       metrics, "--device", device])
    for line in buf.getvalue().strip().splitlines():
        print(f"[events] {line}")
    check(rc == 0, f"train --metrics exited {rc}")
    check("device-cached" in buf.getvalue(), "the feed was not cached")
    events = [json.loads(line) for line in open(metrics)]
    fields = {}
    for e in events:
        if e["event"] in ("prefetch", "h2d_stage", "device_cache"):
            fields.setdefault(e["event"], []).append(
                set(e) - {"event", "t"})
    counts = {k: len(v) for k, v in fields.items()}
    print(f"[events] {len(events)} events; input path: {counts}")
    check(set(counts) == {"prefetch", "h2d_stage", "device_cache"},
          f"input events {counts}")
    check(all(f == PREFETCH_FIELDS for f in fields["prefetch"]),
          f"prefetch fields {fields['prefetch']}")
    check(all(f == H2D_FIELDS for f in fields["h2d_stage"]),
          f"h2d_stage fields {fields['h2d_stage']}")
    # the promotion's gauge (one a cached source) adds "resident"
    resident = [f for f in fields["device_cache"] if "resident" in f]
    check(resident and all(f == CACHE_FIELDS | {"resident"}
                           for f in resident) and
          all(f == CACHE_FIELDS for f in fields["device_cache"]
              if "resident" not in f) and
          len(resident) < len(fields["device_cache"]),
          f"device_cache fields {fields['device_cache']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["report", metrics, "--format", "json"])
    check(rc == 0, f"report exited {rc}")
    rep = json.loads(buf.getvalue())
    check(rep.get("device_cache") and rep.get("prefetch") and
          "h2d_stage" in json.dumps(rep), f"report sections {sorted(rep)}")
    h2d = [e for e in events if e["event"] == "h2d_stage"][-1]
    print(f"[events] report: device_cache {rep['device_cache']}, prefetch "
          f"{rep['prefetch']}; last h2d_stage {h2d}; {card}")
    return {"counts": counts, "report_device_cache": rep["device_cache"],
            "report_prefetch": rep["prefetch"], "h2d_stage": h2d}


def phase_rest_all(torch, card, tmp, records):
    """Phase 16 on phase 9's records, or, run without phase 9, on records
    of its own (phase 9's, written here)."""
    if records is None:
        db = os.path.join(tmp, "records16")
        os.makedirs(db, exist_ok=True)
        solver_path, _ = _caffenet_db_files(db)
        records = {"dir": db, "solver": solver_path}
    fission = phase_fission(torch, card, tmp)
    host = phase_native_host(torch, card, tmp, records["dir"],
                             records["solver"])
    scan = phase_lm_scan(torch, card)
    events = phase_input_events(torch, card, tmp)
    return {"fission": fission, "native": host, "scan": scan,
            "events": events}


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
          11: "zoo", 12: "levers, run safety, metrics", 13: "fleet",
          14: "hosts", 15: "mesh", 16: "rest"}


def _selected(argv):
    """--phases 3,12 -> {1, 2, 3, 12} (phase 10 brings 9, whose records
    it reads, 13 brings 4, whose snapshot it serves, and 14 brings 9 and
    10, whose records and dp verb run it reads; 16 writes its own records
    when 9 does not run); no argument -> every phase."""
    if not argv:
        return set(PHASES)
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases N[,N...]]")
    want = {int(x) for x in argv[1].split(",")}
    bad = want - set(PHASES)
    if bad:
        raise SystemExit(f"no phase {sorted(bad)}; phases are 1-16")
    if 14 in want:
        want.add(10)
    if 10 in want:
        want.add(9)
    if 13 in want:
        want.add(4)
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
    trained_cli, trained = section(5, phase_train_all, torch, card,
                                   tmp) or (None, None)
    _flash_built()
    flash = section(6, phase_flash_kernels, torch)
    (lm_cli, lm_step, lm_step_f32, lm_default, lm_d256, lm_d256_f32,
     lm_parity) = section(
        7, lambda: (phase_lm_cli(tmp), phase_lm_step(torch, card),
                    phase_lm_step(torch, card, dtype="f32"),
                    phase_lm_default_verb(), phase_lm_d256(),
                    phase_lm_d256(dtype=None),
                    phase_lm_card_vs_cpu(torch, tmp))) or (None,) * 7
    local_sgd = section(8, phase_local_sgd_all, torch, card, tmp)
    records = section(9, phase_records_all, torch, card, tmp)
    feeds = section(10, lambda: phase_feeds_all(
        torch, card, tmp, records["dir"], records["solver"]))
    zoo = section(11, phase_zoo_all, torch, card, tmp)
    levers = section(12, phase_levers_all, torch, card, tmp)
    fleet = section(13, lambda: phase_fleet(torch, card, served["prefix"]))
    hosts = section(14, lambda: phase_hosts_all(torch, card, tmp, records,
                                                feeds))
    mesh = section(15, phase_mesh_all, torch, card, tmp)
    rest = section(16, lambda: phase_rest_all(torch, card, tmp, records))
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
             "lm step, f32": lm_step_f32["launches"],
             "lm verb, defaults (f32)": lm_default["launches"],
             "lm verb, d_model 2048": lm_d256["launches"],
             "lm verb, d_model 2048, f32": lm_d256_f32["launches"],
             "local-sgd caffenet": local_sgd["rounds"]["caffenet"][
                 "launches"],
             "train verb on records": records["cli"]["launches"],
             "train verb, device-cached": feeds["cli"]["cached"]["launches"],
             "train verb, dp": feeds["cli"]["dp"]["launches"],
             **{_mesh_path(k): v["launches"]
                for k, v in mesh["full"].items()}}
    remat = levers["googlenet"]["policies"]
    remat_lm = levers["lm"]["policies"]
    table = []
    for name, (source, replaces, own_path) in KERNELS.items():
        rows = [r for r in results + flash + mesh["flash"]
                if r["name"] == name and r["row"]]
        check(rows, f"no timed row of {name}")
        for r in rows:          # one entry per timed shape of the kernel
            # CaffeNet's shapes: the train verb's default, device-cached
            # feed, and its dp slots (phase 10); the flash kernels at a
            # mesh branch's per-slot shape: that branch (phase 15)
            caffenet = tuple(r["shape"]) in CAFFENET_LRN_SHAPES
            path = "train verb, device-cached" if caffenet else \
                "train verb, dp" if tuple(r["shape"]) in \
                CAFFENET_DP_LRN_SHAPES else \
                _mesh_path(r["launches_path"]) if "launches_path" in r \
                else FLASH_ROW_PATHS.get((tuple(r["shape"]), r["dtype"]),
                                         own_path)
            per_iter, model = (remat_lm, "lm") if name in FLASH_KERNELS \
                else (remat, "googlenet")
            table.append({
                "name": name, "route": "cuda",
                "source": r.get("source", source),
                "replaces": replaces, "launches": paths[path][name],
                "launches_path": path,
                "launches_train": trained["launches"]["auto"][name],
                "launches_lm_step": lm_step["launches"][name],
                f"launches_{model}_iteration_by_remat": {
                    pol: per_iter[pol]["launches"][name]
                    for pol in REMAT_POLICIES},
                **({"launches_fleet_r0": fleet["launches"][name]}
                   if own_path.startswith("serve") else {}),
                **({"launches_lm_step_f32": lm_step_f32["launches"][name],
                    "launches_lm_verb_defaults_f32": lm_default["launches"][
                        name],
                    "launches_lm_verb_d_model_2048": lm_d256["launches"][
                        name],
                    "launches_lm_verb_d_model_2048_f32": lm_d256_f32[
                        "launches"][name],
                    "launches_moe_lm_verb": zoo["moe_cli"]["launches"][name],
                    "launches_moe_lm_step": zoo["moe_step"]["launches"][
                        name],
                    "launches_mesh_per_step": {
                        k: v["launches_per_step"][name]
                        for k, v in mesh["full"].items()}}
                   if name in FLASH_KERNELS else {}),
                **({"launches_local_sgd": paths["local-sgd caffenet"][name],
                    "launches_imagenet": records["imagenet"]["launches"][
                        name],
                    "launches_records_streaming":
                        paths["train verb on records"][name],
                    "launches_dp_verb": feeds["cli"]["dp"]["launches"][name],
                    "launches_two_tier_armed": hosts["two_tier"][
                        "launches"][name],
                    "launches_two_tier_unarmed_round": hosts["two_tier"][
                        "unarmed_launches"][name]}
                   if caffenet else {}),
                **({"launches_elastic_dp_verb": hosts["train_verb"][
                    "launches"][name]}
                   if tuple(r["shape"]) in CAFFENET_DP_LRN_SHAPES else {}),
                # phase 16's paths: the GoogLeNet step with fission on and
                # off, CaffeNet's --host-transform feed native and numpy,
                # the LM under --scan off and on
                **({"launches_lm_scan": {
                    k: v["launches"][name]
                    for k, v in rest["scan"]["arms"].items()}}
                   if name in FLASH_KERNELS else
                   {"launches_host_transform": {
                       k: v["launches"][name]
                       for k, v in rest["native"]["host_transform"].items()}}
                   if caffenet else
                   {"launches_googlenet_fission": {
                       k: v["launches"][name]
                       for k, v in rest["fission"]["arms"].items()}}),
                "shape": r["shape"], "dtype": r["dtype"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **{k: r[k] for k in ("kernel", "tflops", "registers",
                                     "smem_bytes", "ctas_per_sm",
                                     "bound_share")
                   if k in r}})
    print("[details] " + json.dumps({
        "card": card, "cases": results, "flash_cases": flash,
        "serve": {k: served[k] for k in ("per_bucket_ms", "images_per_s_b8",
                                         "p50_ms", "profile_b8")},
        "train": {**{k: trained[k] for k in (
            "launches", "fixed_batch_losses", "step_ms", "images_per_s",
            "profile", "card_vs_cpu")}, **trained_cli},
        "lm": {"cli": lm_cli, "step": lm_step, "step_f32": lm_step_f32,
               "default_verb": lm_default, "d256_verb": lm_d256,
               "d256_verb_f32": lm_d256_f32,
               "card_vs_cpu": lm_parity},
        "local_sgd": local_sgd, "records": records, "feeds": feeds,
        "zoo": zoo, "levers": levers, "fleet": fleet, "hosts": hosts,
        "mesh": mesh, "rest": rest,
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
