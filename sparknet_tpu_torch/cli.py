"""Command line of the PyTorch/CUDA port: ``python -m sparknet_tpu_torch``.

  train   train from a solver prototxt on one device: Caffe's solver
          schedule (display, test_interval, snapshot cadence), crash-safe
          snapshots (binaryproto or HDF5), ``--weights`` finetuning,
          ``--snapshot`` / ``--resume auto|STATE`` restores. The net's
          Data layers read their LMDB/LevelDB records: a dataset within
          SPARKNET_DEVICE_CACHE_MB is uploaded to the card once and each
          step ships only its record indices and crop/mirror draws;
          otherwise the raw records stream to the card (``--wire``
          codecs, ``--staging``, ``--echo``) and are cropped, mirrored
          and mean-subtracted there (``--host-transform`` does that on
          the host). ImageData, WindowData and HDF5Data layers read their
          files. ``--strategy dp --mesh data=W`` splits each batch over W
          worker slots. A net whose sources do not exist trains on
          synthetic batches of its feed shapes and says so. Run safety
          and observability as in the JAX verb: ``--metrics`` (one JSONL
          stream: spans, steps, comms, memory, checkpoints), ``--profile``
          (a torch.profiler trace of one steady block), the signal
          policies, ``--stall-seconds`` (a ``watchdog`` event on a stall
          or NaN), ``--recover`` (rollback; exit 3 on abort),
          ``--keep N``, ``--health-*``; ``--remat`` and ``--precision``;
          the multi-host flags as in ``cifar`` (``--chaos``, elastic
          membership, ``--staleness``, the heartbeat, ``--reshard``),
          exit 4 on a lost quorum.
          Its last line counts each CUDA kernel's launches in the run.
  test    score a model's TEST net over its data layer's source.
  time    per-layer forward and forward+backward times.
  device_query
          list the CUDA devices.
  serve   weights-only inference over a snapshot prefix — continuous
          batching into power-of-two buckets, hot reload on new
          snapshots, graceful SIGTERM/SIGINT drain (exit 0); exit 3 when
          the checkpoint has no servable model blob, before the socket
          opens. ``--fleet_dir`` leases the replica into a serving fleet,
          ``--chaos`` injects the serving faults, ``--metrics`` and
          ``--trace_*`` write the request stream.
  route   the serving fleet's router: replicas found through their
          leases, least-queue-depth dispatch with retry-once failover,
          SLO autoscaling decisions, canary rollback.
  serve-bench
          closed- and open-loop load against a replica or the router.
  simfleet
          the training fleet on a simulated clock (virtual hosts driving
          the real heartbeat, relay and elastic-policy code; --sweep
          grids, --record_real / --replay), and with --serve the serving
          fleet (no device).
  monitor a live terminal view of a --metrics stream.
  lm      train the transformer LM (models/zoo.py transformer_lm) on the
          synthetic bigram corpus: the single-device Solver, or the JAX
          verb's mesh branches over slots on the card (--dp, --fsdp,
          --tp, --sp, --ep with --moe-experts, --pipeline-stages and
          --microbatches; parallel/); the corpus floor first, optional
          --metrics JSONL, snapshots and --resume, and as the last line
          each CUDA kernel's launches.
  cifar   the CifarApp loop: cifar10_full on CIFAR-10 binaries (or
          synthetic class-gaussians) under local SGD over --workers
          slots (--tau steps each, then the weights averaged) or per-step
          data parallelism (--strategy dp); tests every --test-every
          rounds, snapshots and --resume auto; --metrics, --health-*,
          --remat, --precision. --hosts H splits the slots into H fault
          domains (two-tier local SGD); with SPARKNET_NUM_PROCESSES and
          SPARKNET_PROCESS_ID each process is one host, and
          --heartbeat-dir leases it and relays the cross-host average
          through the directory. --quorum / --evict-after /
          --readmit-after arm elastic membership (exit 4 on a lost
          quorum, after a snapshot every survivor agrees on),
          --staleness the bounded-staleness mode, --chaos the fault
          injectors, --grow a late joiner, --reshard auto a resume on
          another world.
  imagenet
          the ImageNetApp loop: CaffeNet under local SGD (or --strategy
          dp) on synthetic class-gaussian images, transformed on the
          device.
  make_synth_cifar, convert_cifar_data, compute_image_mean,
  convert_imageset
          write a synthetic CIFAR-format dataset (no download needed),
          turn CIFAR binaries or image files into Datum LMDBs, and
          compute a DB's mean image.
  extract_features
          forward a TEST net on the device and write named blobs as
          float-Datum DBs.
  upgrade_net_proto_text, upgrade_net_proto_binary,
  upgrade_solver_proto_text
          rewrite old-format net and solver files in the latest format.
  report  aggregate a --metrics JSONL into a run report (phases, step
          percentiles, comms, health, loss curve).
  trace   merge metrics JSONLs into one clock-aligned timeline: Chrome
          trace export and the per-round critical path.

All run on the card (``--device cuda``, the default) unless
``--device cpu`` is given.
"""

import argparse
import json
import os
import signal
import sys

import numpy as np

from .utils.exit_codes import EXIT_RECOVERY_ABORT, EXIT_USAGE


def _mesh_arg(s):
    """"data=8,seq=2" -> {"data": 8, "seq": 2}; "8" -> {"data": 8} (the
    JAX verb's parser). Each axis is that many slots on the card (-1:
    one); the train verb's dp solver splits the batch over "data" and
    replicates over the others."""
    if s.isdigit():
        return {"data": int(s)}
    out = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        try:
            out[k.strip()] = int(v)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"mesh {s!r}: want axis=N[,axis=N...] or N") from None
    return out


def _apply_feed_flags(args):
    """The feed flags write their SPARKNET_* env vars (the env stays the
    fallback when a flag is not given, as in the JAX package); returns
    the echo factor. Echo > 1 with a precrop wire exits: precropped
    bytes cannot take fresh crop draws."""
    for flag, env in (("wire", "SPARKNET_WIRE"),
                      ("wire_bits", "SPARKNET_WIRE_BITS"),
                      ("staging", "SPARKNET_STAGING"),
                      ("echo", "SPARKNET_ECHO"),
                      ("shard_ingest", "SPARKNET_SHARD_INGEST")):
        if getattr(args, flag, None) is not None:
            os.environ[env] = str(getattr(args, flag))
    echo = int(os.environ.get("SPARKNET_ECHO", "1") or 1)
    wire = os.environ.get("SPARKNET_WIRE", "raw") or "raw"
    if echo > 1 and "precrop" in wire:
        raise SystemExit(
            "--echo > 1 is incompatible with a precrop wire mode: "
            "pre-cropping bakes the crop window into the shipped bytes, "
            "so echoes could not get fresh crop draws (use --wire raw "
            "or --wire pack with echo)")
    return max(1, echo)


def _apply_perf_flags(args):
    """--remat, --scan, --precision, --fsdp and --tp write
    SPARKNET_REMAT, SPARKNET_SCAN, SPARKNET_PRECISION, SPARKNET_FSDP and
    SPARKNET_TP before any net is built, as the JAX verbs do (the
    variables stay the fallback when a flag is not given)."""
    for flag, env in (("remat", "SPARKNET_REMAT"),
                      ("scan", "SPARKNET_SCAN"),
                      ("precision", "SPARKNET_PRECISION"),
                      ("fsdp", "SPARKNET_FSDP"), ("tp", "SPARKNET_TP")):
        if getattr(args, flag, None) is not None:
            os.environ[env] = str(getattr(args, flag))


def _add_sharding_flags(p):
    """--fsdp / --tp: the one-big-model levers (parallel/fsdp.py,
    parallel/gspmd.py); each writes its SPARKNET_* variable."""
    p.add_argument("--fsdp", choices=("on", "off"), default=None,
                   help="ZeRO/FSDP sharding: params + optimizer state "
                        "dim0-sharded over the data slots (all-gather at "
                        "use, reduce-scatter grads, per-shard update). "
                        "Default: SPARKNET_FSDP, else off")
    p.add_argument("--tp", type=int, default=None, metavar="N",
                   help="N>1: Megatron-style tensor parallelism for the "
                        "LM's matmuls over an N-way \"model\" slot axis. "
                        "Default: SPARKNET_TP, else 1")


def _add_perf_flags(p, scan=False):
    p.add_argument("--remat", choices=("none", "dots", "full"),
                   default=None,
                   help="rematerialization of the TRAIN forward's "
                        "prefix/ segments: none (keep everything), dots "
                        "(keep matmul and convolution outputs, recompute "
                        "the rest), full (recompute whole segments). "
                        "Default: SPARKNET_REMAT, else none")
    if scan:
        p.add_argument("--scan", choices=("auto", "on", "off"),
                       default=None,
                       help="scan-over-layers for isomorphic block "
                            "stacks: on runs the first block's layers "
                            "once per block with that block's params, "
                            "its internal blobs absent (auto scans only "
                            "on a TPU, so it is off here). Default: "
                            "SPARKNET_SCAN, else auto")
    p.add_argument("--precision", choices=("bf16", "fp32"), default=None,
                   help="resolves net.compute_dtype; as in the JAX "
                        "package the layers keep the constructor's dtype "
                        "(only Embed reads one), so a CNN runs in f32 "
                        "either way. Default: SPARKNET_PRECISION, else "
                        "fp32")


def _add_health_flags(p):
    """The --health-* thresholds of the training verbs (applied by
    _apply_health_flags once the solver exists)."""
    p.add_argument("--no-health", action="store_true",
                   help="disable the training-dynamics health detectors")
    p.add_argument("--health-straggler-factor", type=float, default=1.5,
                   help="flag a worker whose round latency exceeds this "
                        "factor x the median of its peers")
    p.add_argument("--health-loss-skew-factor", type=float, default=3.0,
                   help="flag when the per-worker loss spread jumps past "
                        "this factor x its rolling EMA")
    p.add_argument("--health-div-abs", type=float, default=0.0,
                   help=">0: critical alarm when mean worker divergence "
                        "crosses this absolute L2 threshold")
    p.add_argument("--health-trend-rounds", type=int, default=5,
                   help="divergence-trend alarm window (consecutive "
                        "growing observations)")
    p.add_argument("--health-trend-factor", type=float, default=2.0,
                   help="total growth over the trend window that "
                        "triggers the divergence-trend alarm")
    p.add_argument("--health-cooldown", type=int, default=5,
                   help="min observations between same-kind alarms")
    p.add_argument("--health-arm-recovery", action="store_true",
                   help="critical health alarms arm the divergence "
                        "RecoveryPolicy if none is armed yet")


def _apply_health_flags(solver, args):
    if getattr(solver, "metrics", None) is None:
        return
    if args.no_health:
        solver.arm_health(enabled=False)
        return
    solver.arm_health(
        straggler_factor=args.health_straggler_factor,
        loss_skew_factor=args.health_loss_skew_factor,
        div_abs=args.health_div_abs,
        trend_rounds=args.health_trend_rounds,
        trend_factor=args.health_trend_factor,
        cooldown=args.health_cooldown,
        arm_recovery=args.health_arm_recovery)


def _add_feed_flags(p):
    p.add_argument("--wire", default=None,
                   choices=("raw", "precrop", "pack", "precrop+pack"),
                   help="wire format of the streaming device-transform "
                        "feed: raw uint8 records (default), host-side "
                        "precrop (crop/mirror still on the device, bit "
                        "for bit), lossless bit-pack for low-entropy "
                        "sources, or both. Default: SPARKNET_WIRE, else "
                        "raw")
    p.add_argument("--wire-bits", type=int, choices=(1, 2, 4, 8),
                   default=None,
                   help="pack width of the pack modes (8 = no pack); "
                        "default: SPARKNET_WIRE_BITS, else inferred from "
                        "the first record (a batch out of range raises)")
    p.add_argument("--staging", choices=("on", "off"), default=None,
                   help="on: the copy to the card runs on a side stream "
                        "in the prefetch worker (H2DStager); off: a plain "
                        "copy in that worker. Default: SPARKNET_STAGING, "
                        "else on")
    p.add_argument("--echo", type=int, default=None, metavar="E",
                   help="data echoing: serve each shipped batch E times, "
                        "with fresh crop/mirror draws for each echo. "
                        "Default: SPARKNET_ECHO, else 1")
    p.add_argument("--shard-ingest", choices=("on", "off"), default=None,
                   help="per-host sharded ingest in multi-process runs: "
                        "each host reads only its owned record partition "
                        "(data/ingest.py; ownership re-spreads with "
                        "elastic membership). Default: "
                        "SPARKNET_SHARD_INGEST env var, else on")


def _net_base_dir(sp, solver_path):
    """Stock solver prototxts name their net relative to the caffe repo
    root (e.g. "examples/cifar10/..."); caffe resolves against CWD. Walk
    up from the solver file until the referenced net path exists."""
    rel = None
    for f in ("net", "train_net"):
        if sp.has(f):
            rel = getattr(sp, f)
            break
    if rel is None or os.path.isabs(rel) or os.path.exists(rel):
        return ""
    d = os.path.dirname(os.path.abspath(solver_path))
    while True:
        if os.path.exists(os.path.join(d, rel)):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return ""
        d = parent


def _feed_shapes_arg(specs):
    """["data=100,3,32,32", ...] -> {"data": (100,3,32,32)} (the shape DB
    records would supply)."""
    out = {}
    for spec in specs or ():
        name, _, dims = spec.partition("=")
        out[name.strip()] = tuple(int(d) for d in dims.replace("x", ",")
                                  .split(","))
    return out


def _real_feeds(train_np, test_np, base_dir, seed=None,
                device_transform=False):
    """Open the DB sources the net's Data layers name, when they exist.
    Returns (train_shapes, train_src, test_shapes, test_src) with None
    entries where no real source is available."""
    from .data.db_source import build_db_feed
    from .graph.compiler import TEST, TRAIN
    train_shapes, train_src = build_db_feed(
        train_np, TRAIN, base_dir, seed=seed,
        device_transform=device_transform)
    test_shapes = test_src = None
    if test_np is not None:
        test_shapes, test_src = build_db_feed(
            test_np, TEST, base_dir, seed=seed,
            device_transform=device_transform)
    return train_shapes, train_src, test_shapes, test_src


def make_data_iter(net, seed=0):
    """Synthetic batch stream of the net's feed shapes: N(0, 1) data,
    labels in [0, 10)."""
    rs = np.random.RandomState(seed)
    shapes = net.feed_shapes()
    while True:
        batch = {}
        for name, shape in shapes.items():
            if len(shape) <= 1 or "label" in name:
                batch[name] = rs.randint(0, 10, shape).astype(np.int32)
            else:
                batch[name] = rs.randn(*shape).astype(np.float32)
        yield batch


def cmd_train(args):
    from .data.device_cache import DeviceCachedSource, maybe_device_cache
    from .data.prefetch import EchoIterator, H2DStager, PrefetchIterator
    from .device import resolve_device
    from .obs import TorchProfiler, Tracer
    from .ops import kernel_launches
    from .proto import text_format
    from .resilience import checkpoint
    from .parallel.multihost import exit_if_peers_died
    from .resilience.elastic import EXIT_QUORUM_LOST, QuorumLost
    from .resilience.recovery import RecoveryAbort
    from .solver import Solver
    from .solver.solver import resolve_nets, to_device
    from .utils.metrics import MetricsLogger
    from .utils.signals import SignalPolicy
    _apply_perf_flags(args)          # before any net is built
    echo = _apply_feed_flags(args)   # before any data source is built
    if echo > 1 and args.host_transform:
        raise SystemExit(
            "--echo > 1 needs the device-transform feed (drop "
            "--host-transform): echoes re-draw crop/mirror on the device")
    # one metrics stream and span tracer for the whole run: the solver's
    # step, comms and memory accounting and the verb's phase spans
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    tracer = Tracer(metrics)
    # before the solver and the sources: they take the injector through
    # active_chaos()
    chaos = _install_chaos(args, metrics=metrics)
    sp = text_format.load(args.solver, "SolverParameter")
    base_dir = _net_base_dir(sp, args.solver)
    if sp.has("snapshot_prefix") and base_dir \
            and not os.path.isabs(sp.snapshot_prefix):
        # stock prefixes are caffe-root-relative: anchor them where the
        # net resolved, not the process CWD
        sp.snapshot_prefix = os.path.join(base_dir, sp.snapshot_prefix)
    train_np, test_np = resolve_nets(sp, base_dir)
    seed = int(sp.random_seed) if int(sp.random_seed) >= 0 else None
    device = resolve_device(args.device)
    train_shapes, train_src, test_shapes, test_src = _real_feeds(
        train_np, test_np, base_dir, seed=seed,
        device_transform=not args.host_transform)
    data_iter = solver = hb = None
    prof = TorchProfiler(args.profile)
    rc = 0
    try:
        # a dataset within the budget lives on the card: one upload, then
        # each step ships its (B, k) control array (data/device_cache.py);
        # only the single-device feed with the device transform, as in the
        # JAX verb. SPARKNET_DEVICE_CACHE_MB=0 disables.
        budget = float(os.environ.get("SPARKNET_DEVICE_CACHE_MB", "2048"))
        off = "--host-transform" if args.host_transform else \
            "--strategy dp" if args.strategy == "dp" else \
            "SPARKNET_DEVICE_CACHE_MB=0" if budget <= 0 else None
        if off and train_src is not None:
            print(f"device cache: off under {off}; the records stream")
        if not off:
            isz = int(sp.iter_size)
            train_src = maybe_device_cache(train_src, budget, iter_size=isz,
                                           device=device, metrics=metrics)
            if isinstance(train_src, DeviceCachedSource):
                budget -= train_src.nbytes / (1 << 20)      # one budget
            test_src = maybe_device_cache(test_src, budget, iter_size=isz,
                                          device=device, metrics=metrics)
        feed = {**(train_shapes or {}), **_feed_shapes_arg(args.input_shape)}
        kw = dict(base_dir=base_dir, feed_shapes=feed or None,
                  test_feed_shapes=test_shapes, device=device,
                  metrics=metrics, tracer=tracer)
        with tracer.span("setup", strategy=args.strategy):
            if args.strategy == "dp":
                from .parallel import DataParallelSolver
                solver = DataParallelSolver(sp, mesh=args.mesh, **kw)
            else:
                solver = Solver(sp, **kw)
        # device mode: the sources yield raw records (or control arrays)
        # and the crop/mirror draws; the transform runs on the device
        # before each forward, on the whole batch before the dp solver
        # cuts its slots' rows
        test_fn = test_src.device_fn if test_src is not None and \
            getattr(test_src, "device_mode", False) else None
        if train_src is not None and getattr(train_src, "device_mode",
                                             False):
            solver.set_input_transform(train_src.device_fn,
                                       train_src.raw_feed_overrides,
                                       test_fn=test_fn)
        elif test_fn is not None:
            solver.set_input_transform(None, None, test_fn=test_fn)
        solver.snapshot_keep = args.keep or None
        prefix = args.snapshot_prefix or (
            sp.snapshot_prefix if sp.has("snapshot_prefix") else None)
        if args.stall_seconds:
            solver.arm_watchdog(stall_seconds=args.stall_seconds)
        if args.recover:
            solver.arm_recovery(max_rollbacks=args.recover,
                                lr_decay=args.recover_lr_decay,
                                explode_factor=args.recover_explode_factor)
        _apply_health_flags(solver, args)
        _apply_heartbeat_flags(solver, args)   # before elastic: the relay
        _apply_elastic_flags(solver, args)     # world sizes to processes
        hb = solver.heartbeat                  # close() drops the reference
        if args.weights:
            solver.load_weights(args.weights)
        if args.snapshot:
            solver.restore(args.snapshot, reshard=args.reshard)
        if args.resume:
            if args.resume == "auto":
                if not prefix:
                    raise SystemExit("--resume auto needs a snapshot prefix "
                                     "(--snapshot-prefix or the solver's "
                                     "snapshot_prefix)")
                checkpoint.resume_auto(solver, prefix, log_fn=print,
                                       reshard=args.reshard)
            else:
                solver.restore(args.resume, reshard=args.reshard)
        total = args.iterations or int(sp.max_iter) or 1000
        if train_src is not None:
            cached = isinstance(train_src, DeviceCachedSource)
            kind = "device-cached" if cached else (
                "device-transform" if getattr(train_src, "device_mode",
                                              False) else "host-transform")
            print(f"Training from {train_src.source} "
                  f"({train_src.num_records} records, {kind})")
            # the copy to the card runs in the prefetch worker: with
            # staging on a side stream, so batch k+1's copy overlaps step
            # k (both solvers' train_step wait on the staged copy and cut
            # the dp slots from the batch on the card); iter_size > 1
            # stacks micro-batches on the host, so those are fed as they
            # are
            put = stager = None
            if int(sp.iter_size) <= 1:
                if os.environ.get("SPARKNET_STAGING", "on") != "off":
                    put = stager = H2DStager(
                        slots=2, device=solver.device, chaos=chaos,
                        metrics=metrics, name="train_feed")
                else:
                    put = lambda b: to_device(b, solver.device)  # noqa: E731
            extra = {"echo": echo, "staging": int(stager is not None)}
            codec = getattr(train_src, "wire", None)
            if codec is not None:
                extra.update(codec.describe())
            data_iter = PrefetchIterator(iter(train_src), depth=3,
                                         transform=put, metrics=metrics,
                                         name="train_feed", extra=extra)
            if echo > 1:
                if cached:
                    # each batch is already a small control array
                    print("NOTE: --echo ignored for the device-cached feed")
                elif not hasattr(train_src, "fresh_aux"):
                    raise SystemExit(
                        f"--echo > 1 needs a source with re-drawable "
                        f"device-side augmentation; "
                        f"{type(train_src).__name__} has none")
                else:
                    data_iter = EchoIterator(
                        data_iter, echo,
                        fresh_aux=lambda b: train_src.fresh_aux())
        else:
            print("WARNING: no Data-layer LMDB source found; "
                  "feeding synthetic noise (shapes only)")
            data_iter = make_data_iter(solver.net)
        if test_src is not None:
            # a fresh pass per test, not prefetched: a prefetch worker
            # would draw augmentation randomness for batches past the
            # test_iter consumed, moving the source's RandomState between
            # passes
            test_data_fn = lambda: iter(test_src)  # noqa: E731
        else:
            test_data_fn = (lambda: make_data_iter(solver.test_net, seed=1)) \
                if solver.test_net is not None else None
        policy = SignalPolicy(sigint=args.sigint_effect,
                              sighup=args.sighup_effect,
                              sigterm=args.sigterm_effect)
        blocks_done = 0
        with policy:
            while solver.iter < total:
                prof.maybe_start(blocks_done, total - solver.iter)
                n = min(100, total - solver.iter)
                with tracer.span("train_block", iter0=solver.iter, iters=n):
                    try:
                        solver.step(n, data_iter, test_data_fn=test_data_fn)
                    except RecoveryAbort as e:
                        # the run is over; the last good snapshot on disk
                        # is intact
                        print(f"ABORT: {e}")
                        rc = EXIT_RECOVERY_ABORT
                        break
                    except QuorumLost as e:
                        # too few live workers for a trustworthy
                        # consensus: a distinct exit for the supervisor.
                        # The masked consensus up to here is healthy:
                        # keep it, and in a multi-host world barrier
                        # every survivor on the same manifest
                        print(f"QUORUM LOST: {e}")
                        if prefix:
                            solver.snapshot(prefix=prefix)
                            solver.coordinated_restart(prefix)
                        rc = EXIT_QUORUM_LOST
                        break
                blocks_done += 1
                prof.maybe_stop()
                if chaos is not None:
                    chaos.maybe_sigterm(blocks_done)
                action = policy.pending()
                if action in ("snapshot", "snapshot_stop"):
                    solver.snapshot(prefix=prefix or "snap")
                if action in ("stop", "snapshot_stop"):
                    print("stopping early on signal")
                    break
    finally:
        prof.abort()
        if train_src is not None:
            if data_iter is not None:
                data_iter.close()
            train_src.close()
        if test_src is not None:
            test_src.close()
        if solver is not None:
            solver.close()      # the watchdog thread, the summaries
        if args.profile:
            # the host-side twin of the profiler's device trace
            tracer.export_chrome(os.path.join(args.profile,
                                              "spans.trace.json"))
    # a final snapshot unless the in-loop cadence already wrote this
    # iteration (Caffe solver.cpp Solve tail :300-306); never after a
    # recovery abort, whose params may be the diverged ones
    cadence_fired = int(sp.snapshot) and sp.has("snapshot_prefix") \
        and solver.iter % int(sp.snapshot) == 0
    if prefix and sp.snapshot_after_train and not cadence_fired and rc == 0:
        solver.snapshot(prefix=prefix)
    print(f"Optimization done, iter={solver.iter}")
    if metrics:
        metrics.close()
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    sys.stdout.flush()
    # a run that survived a peer's death reports its own exit code
    exit_if_peers_died(rc, hb)
    return rc


def cmd_test(args):
    """Score a model's TEST net over its Data-layer records (the JAX
    verb's host-transformed feed), or synthetic batches where the source
    does not exist."""
    from .data.db_source import resolve_db_feed
    from .graph.compiler import TEST
    from .proto import Message, text_format
    from .solver import Solver
    net_param = text_format.load(args.model, "NetParameter")
    sp = Message("SolverParameter", base_lr=0.0, lr_policy="fixed",
                 display=0)
    sp.net_param = net_param
    # stock prototxt sources are caffe-root-relative: walk up from the
    # model file until one resolves
    test_shapes, test_src = resolve_db_feed(
        net_param, TEST, os.path.dirname(os.path.abspath(args.model)))
    try:
        # the (unused) TRAIN net compiles with the test shapes: param
        # shapes do not depend on the batch, and only the TEST net runs
        solver = Solver(sp, feed_shapes=_feed_shapes_arg(args.input_shape)
                        or test_shapes, test_feed_shapes=test_shapes,
                        device=args.device)
        if args.weights:
            solver.load_weights(args.weights)
        if test_src is not None:
            print(f"Scoring on {test_src.source} "
                  f"({test_src.num_records} records)")
            it = iter(test_src)
        else:
            print("WARNING: no Data-layer LMDB source found; synthetic "
                  "batches")
            it = make_data_iter(solver.test_net or solver.net)
        scores = solver.test(it, num_iters=args.iterations)
    finally:
        if test_src is not None:
            test_src.close()
    for k, v in scores.items():
        print(f"{k} = {np.asarray(v).mean():.6f}")
    return 0


def cmd_time(args):
    """Per-layer forward and forward+backward times (`caffe time`,
    caffe.cpp:290-376): each layer alone on random inputs of its true
    shapes, on the device; a layer that cannot run so (a loss fed
    random labels) prints its error."""
    import time
    import torch
    from .graph.compiler import TRAIN, CompiledNet
    from .proto import text_format
    net = CompiledNet(text_format.load(args.model, "NetParameter"), TRAIN,
                      feed_shapes=_feed_shapes_arg(args.input_shape),
                      device=args.device)
    params, _ = net.init(torch.Generator().manual_seed(0))
    dev = net.device
    rs = np.random.RandomState(0)
    iters = args.iterations

    def timed(fn):
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / iters * 1e3

    print(f"{'layer':<28}{'type':<18}{'fwd ms':>10}{'fwd+bwd ms':>12}")
    total_f = total_fb = 0.0
    for lp, impl, bottoms, tops in net.layers:
        if getattr(impl, "is_feed", False):
            continue
        bvals = [torch.tensor(rs.randn(*net.blob_shapes[b]),
                              dtype=torch.float32, device=dev,
                              requires_grad=True) for b in bottoms]
        lparams = [p.detach().requires_grad_(True)
                   for p in net.resolve_params(params, lp.name)]
        gen = torch.Generator(device=dev).manual_seed(0)

        def fwd():
            tv = impl.apply(lparams, bvals, True, gen) if impl.needs_rng \
                else impl.apply(lparams, bvals, True)
            return sum(t.float().sum() for t in tv)

        def fwd_bwd():
            out = fwd()
            leaves = bvals + lparams
            if out.requires_grad:
                torch.autograd.grad(out, leaves, allow_unused=True)

        try:
            f_ms = timed(fwd)
            fb_ms = timed(fwd_bwd)
        except Exception as e:     # a layer that cannot run on random input
            print(f"{lp.name:<28}{lp.type:<18}{'—':>10}  ({e})")
            continue
        total_f += f_ms
        total_fb += fb_ms
        print(f"{lp.name:<28}{lp.type:<18}{f_ms:>10.3f}{fb_ms:>12.3f}")
    print(f"{'TOTAL':<28}{'':<18}{total_f:>10.3f}{total_fb:>12.3f}")
    print(f"device: {dev}; layer by layer, so the whole step (one "
          "autograd graph, the fused epilogue sites) differs")
    return 0


def cmd_device_query(args):
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        print("no CUDA device (torch.cuda.is_available() is False)")
        return 1
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"id {i}: {p.name} (cuda) sm_{p.major}{p.minor}, "
              f"{p.multi_processor_count} SMs, "
              f"{p.total_memory / 2 ** 30:.1f} GiB")
    return 0


def cmd_convert_cifar(args):
    from . import tools
    tools.convert_cifar_data(args.input, args.output)
    return 0


def cmd_compute_mean(args):
    from . import tools
    # backend None: open_db sniffs the layout, so LevelDB dirs work like
    # the reference tool's -backend flag (compute_image_mean.cpp:22)
    tools.compute_image_mean(args.db, args.output, backend=args.backend)
    return 0


def cmd_convert_imageset(args):
    from . import tools
    tools.convert_imageset(args.root, args.listfile, args.db,
                           resize_height=args.resize_height,
                           resize_width=args.resize_width, gray=args.gray,
                           shuffle=args.shuffle, encoded=args.encoded,
                           backend=args.backend)
    return 0


def cmd_imagenet(args):
    from .apps import ImageNetApp
    from .ops import kernel_launches
    app = ImageNetApp(num_workers=args.workers, strategy=args.strategy,
                      tau=args.tau, batch=args.batch, log_path=args.log,
                      num_classes=args.classes, device=args.device,
                      metrics_path=args.metrics)
    solver = app.run(num_rounds=args.rounds, test_every=args.test_every)
    print(f"done: {args.rounds} rounds, iter={solver.iter}")
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    return 0


def lm_setup(args):
    """The ``lm`` verb's run up to its first step: the perf and sharding
    flags applied, the solver its mesh flags choose (the JAX verb's
    branches, sparknet_tpu/cli.py cmd_lm) restored from ``--resume``,
    the bigram stream. -> dict(solver, stream, floor, metrics, branch)."""
    import torch
    from .data import lm_batch_stream
    from .models import zoo
    from .parallel import make_mesh
    from .parallel.fsdp import fsdp_enabled
    from .proto import Message
    from .utils import MetricsLogger

    if args.snapshot_every and not args.snapshot_prefix:
        raise SystemExit("--snapshot-every needs --snapshot-prefix")
    _apply_perf_flags(args)   # before any net is built
    fsdp_on = fsdp_enabled()
    tp_ways = int(os.environ.get("SPARKNET_TP", "0") or 0)
    if fsdp_on and tp_ways > 1:
        raise SystemExit(
            "--fsdp and --tp do not compose yet: FSDP shards over the "
            "data axis via shard_map, TP annotates a (data, model) mesh "
            "via GSPMD — pick one lever per run")
    if (fsdp_on or tp_ways > 1) and (args.pipeline_stages > 1
                                     or args.ep > 1 or args.sp > 1):
        raise SystemExit("--fsdp/--tp compose with --dp only (not "
                         "--ep/--sp/--pipeline-stages)")
    sp = Message("SolverParameter", base_lr=args.lr, lr_policy="fixed",
                 display=args.display, type=args.solver_type,
                 random_seed=args.seed, snapshot=args.snapshot_every or 0)
    if args.snapshot_prefix:
        sp.snapshot_prefix = args.snapshot_prefix
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    compute_dtype = torch.bfloat16 if args.dtype == "bf16" else None
    lm_kw = dict(vocab_size=args.vocab, seq_len=args.seq_len,
                 batch_size=args.batch, d_model=args.d_model,
                 num_heads=args.heads, flash=not args.no_flash)
    kw = dict(metrics=metrics, compute_dtype=compute_dtype,
              device=args.device)
    stream, floor = lm_batch_stream(args.vocab, args.batch, args.seq_len,
                                    seed=args.seed)
    if metrics:
        metrics.log("config", loss_floor_nats=round(floor, 4),
                    d_model=args.d_model, layers=args.layers,
                    seq_len=args.seq_len, batch=args.batch,
                    pipeline_stages=args.pipeline_stages, dtype=args.dtype,
                    precision=os.environ.get("SPARKNET_PRECISION",
                                             "fp32") or "fp32",
                    fsdp=int(fsdp_on), tp=max(tp_ways, 1))
    mesh_on = args.ep > 1 or args.dp > 1 or args.sp > 1 or fsdp_on
    if tp_ways > 1:
        # tensor parallelism over a (data, model) slot grid:
        # wqkv/ffn1/lm_head column-split, wo/ffn2 row-split
        from .parallel import (GSPMDSolver, make_tp_mesh,
                               transformer_tp_rule)
        branch = f"tp {tp_ways}"
        solver = GSPMDSolver(
            sp, mesh=make_tp_mesh(tp_ways),
            param_rule=transformer_tp_rule(tp_ways),
            net_param=zoo.transformer_lm(num_layers=args.layers, **lm_kw),
            **kw)
    elif mesh_on:
        if args.pipeline_stages > 1:
            raise SystemExit("--ep/--dp/--sp cannot combine with "
                             "--pipeline-stages")
        if args.ep > 1 and not args.moe_experts:
            raise SystemExit("--ep needs --moe-experts")
        if args.sp > 1:
            lm_kw = dict(lm_kw, flash=False)   # ring attention path
        net = zoo.transformer_lm(num_layers=args.layers,
                                 moe_experts=args.moe_experts,
                                 moe_aux_weight=args.moe_aux_weight,
                                 moe_stats=bool(args.moe_experts),
                                 ring=args.sp > 1, **lm_kw)
        if args.moe_experts:
            from .parallel import ExpertParallelSolver
            axes = {"data": args.dp}
            if args.sp > 1:
                axes["seq"] = args.sp
            axes["expert"] = args.ep
            branch = "ep " + " x ".join(f"{k} {v}" for k, v in axes.items())
            solver = ExpertParallelSolver(
                sp, mesh=make_mesh(axes),
                seq_axis="seq" if args.sp > 1 else None, net_param=net,
                **kw)
        elif args.sp > 1:
            from .parallel import SeqParallelSolver
            branch = f"sp {args.sp} x dp {args.dp}"
            solver = SeqParallelSolver(
                sp, mesh=make_mesh({"data": args.dp, "seq": args.sp}),
                net_param=net, **kw)
        else:
            # --dp alone (or --fsdp, which implies the data axis): the
            # per-step slot average, or FSDP's sharded twin
            from .parallel import DataParallelSolver, FSDPSolver
            from .parallel.multihost import process_count
            cls = FSDPSolver if fsdp_on else DataParallelSolver
            branch = f"{'fsdp' if fsdp_on else 'dp'} {max(args.dp, 1)}"
            solver = cls(sp, mesh=make_mesh(
                {"data": args.dp if args.dp > 1 else -1}), net_param=net,
                **kw)
            if process_count() > 1:
                # every process draws the identical seeded stream and
                # takes its own slice of each batch
                from .parallel import local_batch_slice

                def _host_slice(it, B=args.batch):
                    for b in it:
                        s0, ln = local_batch_slice(B)
                        yield {k: v[s0:s0 + ln] for k, v in b.items()}
                stream = _host_slice(stream)
    elif args.pipeline_stages > 1:
        from .parallel import PipelineLMSolver
        if args.moe_experts:
            raise SystemExit("--moe-experts is not supported under "
                             "--pipeline-stages (dense-FFN blocks only)")
        solver = PipelineLMSolver(
            sp, mesh=make_mesh({"pipe": args.pipeline_stages}),
            num_layers=args.layers,
            num_microbatches=args.microbatches or None, **kw, **lm_kw)
        branch = (f"pipeline {args.pipeline_stages} x "
                  f"{solver.num_microbatches} microbatches")
        solver.snapshot_prefix = args.snapshot_prefix
    else:
        from .solver import Solver
        branch = "single"
        solver = Solver(sp, net_param=zoo.transformer_lm(
            num_layers=args.layers, moe_experts=args.moe_experts,
            moe_aux_weight=args.moe_aux_weight, **lm_kw), **kw)
    if args.resume:
        solver.restore(args.resume)
    return dict(solver=solver, stream=stream, floor=floor, metrics=metrics,
                branch=branch, mesh=mesh_on and tp_ways <= 1)


def _routing_diagnostics(solver, stream, metrics):
    """The MoE mesh branch's routing line: one TEST-phase forward, the
    stats tops (each expert's token fraction and the overflow) averaged
    over the slots and the blocks."""
    scores = solver.test(iter([next(stream)]), num_iters=1)
    stats = {k: np.asarray(v) for k, v in scores.items()
             if k.endswith("/moe_stats")}
    if not stats:
        return
    util = np.mean([s[:-1] for s in stats.values()], axis=0)
    overflow = float(np.mean([s[-1] for s in stats.values()]))
    print(f"    iter {solver.iter}: expert util "
          f"[{', '.join(f'{u:.3f}' for u in util)}] "
          f"overflow {overflow:.4f}")
    if metrics:
        ce = scores.get("loss")
        metrics.log("moe", iter=solver.iter,
                    eval_ce=round(float(np.mean(ce)), 4)
                    if ce is not None else None,
                    expert_util=[round(float(u), 4) for u in util],
                    overflow_fraction=round(overflow, 5),
                    **{k.replace("/moe_stats", "_util"):
                       [round(float(x), 4) for x in s[:-1]]
                       for k, s in stats.items()})


def cmd_lm(args):
    """The JAX package's ``lm`` verb (sparknet_tpu/cli.py cmd_lm): the
    transformer LM on the bigram stream, through the solver its flags
    choose — the single-device Solver; ``--tp N`` GSPMDSolver over a
    (data, model) slot grid; ``--dp``/``--fsdp``/``--sp``/``--ep`` the
    data, FSDP, sequence (ring attention) and expert slot solvers, with
    the MoE routing line every display chunk; ``--pipeline-stages S``
    the GPipe PipelineLMSolver (``--microbatches``, ``.lm.npz``
    snapshots). ``--dtype bf16`` is mixed precision: f32 master params,
    bf16 activations cast at the embedding. ``--moe-experts X`` swaps
    every block's FFN for a Switch-MoE of X experts."""
    import time
    import torch
    from .ops import kernel_launches

    run = lm_setup(args)
    solver, stream, floor = run["solver"], run["stream"], run["floor"]
    metrics = run["metrics"]
    print(f"bigram corpus floor: {floor:.4f} nats/token "
          f"(untrained: {np.log(args.vocab):.4f})")
    start_iter = solver.iter
    t0 = time.time()
    if run["mesh"] and args.moe_experts:
        chunk = args.display or 50
        while solver.iter < args.steps:
            solver.step(min(chunk, args.steps - solver.iter), stream)
            _routing_diagnostics(solver, stream, metrics)
    else:
        solver.step(max(0, args.steps - solver.iter), stream)
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    dt = time.time() - t0
    executed = solver.iter - start_iter
    toks = executed * args.batch * args.seq_len
    final = solver.smoothed_loss()
    # a final snapshot unless the cadence already wrote this iteration
    if args.snapshot_prefix and not (args.snapshot_every and executed and
                                     solver.iter % args.snapshot_every == 0):
        solver.snapshot(args.snapshot_prefix)
    rate = toks / dt if dt > 0 else 0
    print(f"done: {executed} steps, {rate:,.0f} tokens/s wall, "
          f"final loss {final}")
    solver.close()          # the step and comms summaries
    if metrics:
        metrics.log("summary", steps=executed,
                    tokens_per_sec=round(rate, 1),
                    final_loss=final, loss_floor_nats=round(floor, 4))
        metrics.close()
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    return 0


def cmd_cifar(args):
    """The CifarApp loop. Exit 0, or 4 (EXIT_QUORUM_LOST) when elastic
    membership lost its quorum: the app has then snapshotted and, with
    the heartbeat armed, barriered every surviving process on the same
    manifest."""
    from .apps import CifarApp
    from .ops import kernel_launches
    from .parallel.multihost import exit_if_peers_died
    from .resilience.elastic import EXIT_QUORUM_LOST, QuorumLost
    _apply_perf_flags(args)   # before the app builds its nets
    # the app feeds host-transformed CIFAR batches: as in the JAX
    # package, the wire and staging flags only set their env vars there
    echo = _apply_feed_flags(args)
    chaos = _install_chaos(args)    # before the app builds its solver
    app = CifarApp(num_workers=args.workers, data_dir=args.data,
                   prototxt_dir=args.prototxt_dir, strategy=args.strategy,
                   tau=args.tau, log_path=args.log, device=args.device,
                   echo=echo, metrics_path=args.metrics, hosts=args.hosts)
    if chaos is not None and chaos.metrics is None:
        chaos.metrics = app.metrics  # chaos events land in the run's JSONL
    _apply_health_flags(app.solver, args)
    _apply_heartbeat_flags(app.solver, args)   # before elastic: the relay
    _apply_elastic_flags(app.solver, args)     # world sizes to processes
    hb = app.solver.heartbeat                  # close() drops the reference
    rc = 0
    try:
        solver = app.run(num_rounds=args.rounds, test_every=args.test_every,
                         snapshot_prefix=args.snapshot_prefix,
                         snapshot_every=args.snapshot_every,
                         resume=args.resume, reshard=args.reshard)
        print(f"done: {args.rounds} rounds, iter={solver.iter}")
    except QuorumLost as e:
        print(f"QUORUM LOST: {e}")
        rc = EXIT_QUORUM_LOST
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    sys.stdout.flush()
    # a run that survived a peer's death reports its own exit code
    exit_if_peers_died(rc, hb)
    return rc


def cmd_upgrade_net_proto(args):
    from . import tools
    tools.upgrade_net_proto(args.input, args.output, binary=args.binary)
    return 0


def cmd_upgrade_solver_proto(args):
    from . import tools
    tools.upgrade_solver_proto(args.input, args.output)
    return 0


def cmd_extract_features(args):
    from . import tools
    if args.db_type not in ("lmdb", "leveldb"):
        raise SystemExit(f"unknown db_type {args.db_type!r}")
    weights = None if args.weights.lower() == "none" else args.weights
    tools.extract_features(args.model, args.blobs.split(","),
                           args.dbs.split(","), args.num_batches,
                           weights_path=weights, backend=args.db_type,
                           device=args.device)
    return 0


def cmd_make_synth_cifar(args):
    from . import tools
    tools.make_synth_cifar(args.output, n_train=args.train, n_test=args.test,
                           seed=args.seed, noise=args.noise,
                           label_noise=args.label_noise)
    return 0


def cmd_report(args):
    """Aggregate a --metrics JSONL into a run report (obs/report.py):
    per-phase time, step-time percentiles, comms, health, the loss
    curve; --json / --format json for machines, --chrome for the spans."""
    from .obs import report as obs_report
    events = [e for e in (args.event.split(",") if args.event else [])
              if e.strip()]
    try:
        obs_report.report_file(args.jsonl, json_out=args.json,
                               chrome_out=args.chrome, since=args.since,
                               event_types=events or None, fmt=args.format)
    except obs_report.MetricsFileError as e:
        print(f"sparknet_tpu_torch report: error: {e}", file=sys.stderr)
        return EXIT_USAGE
    except BrokenPipeError:          # `report | head` closed the pipe
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


def cmd_trace(args):
    """Merge metrics JSONLs into one clock-aligned timeline
    (obs/fleettrace.py): --chrome writes one Chrome trace with a track
    group per host, --critpath prints the per-round critical path
    (obs/critpath.py); with neither, the alignment summary."""
    from .obs import critpath as obs_critpath
    from .obs import fleettrace as obs_fleettrace
    from .obs.report import MetricsFileError, load_events
    try:
        streams, bad = [], 0
        for path in args.metrics:
            evs, b = load_events(path)
            streams.append(evs)
            bad += b
        if not any(streams):
            raise MetricsFileError(
                "no parseable events in " + ", ".join(args.metrics)
                + (f" ({bad} malformed line(s) skipped)" if bad else ""))
        ft = obs_fleettrace.merge_streams(streams)
        if bad:
            print(f"sparknet_tpu_torch trace: WARNING: {bad} malformed "
                  "JSONL line(s) skipped", file=sys.stderr)
        if args.chrome:
            obs_fleettrace.export_chrome(args.chrome, ft)
            print(f"wrote {args.chrome} ({len(ft.hosts)} host track(s), "
                  f"{sum(len(v) for v in ft.events.values())} event(s))")
        if args.critpath:
            cp = obs_critpath.compute(ft, round_filter=args.round)
            if args.json:
                print(json.dumps(cp, indent=1, sort_keys=True, default=str))
            else:
                obs_critpath.render(cp)
        if not args.chrome and not args.critpath:
            summ = obs_fleettrace.align_summary(ft)
            if args.json:
                print(json.dumps(summ, indent=1, sort_keys=True))
            else:
                print(f"fleet: {len(summ['hosts'])} track(s), "
                      f"{summ['beacons']} clock beacon(s)")
                for h, o in sorted(summ["offsets"].items()):
                    if not o.get("aligned"):
                        print(f"  host {h}: unaligned (no beacon path)")
                        continue
                    err = o.get("err_s")
                    err_txt = "one-sided bound" if err is None \
                        else f"±{err * 1e3:.1f} ms"
                    print(f"  host {h}: offset "
                          f"{o.get('offset_s', 0.0) * 1e3:+.1f} ms "
                          f"({err_txt}, {o.get('samples', 0)} "
                          "beacon(s))")
    except MetricsFileError as e:
        print(f"sparknet_tpu_torch trace: error: {e}", file=sys.stderr)
        return EXIT_USAGE
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


def _add_resilience_flags(p, hosts=False):
    """The JAX train and cifar verbs' multi-host flags: --reshard,
    --chaos, the elastic membership and bounded-staleness flags
    (resilience/elastic.py) and the heartbeat flags
    (resilience/heartbeat.py); with ``hosts``, cifar's --hosts."""
    if hosts:
        p.add_argument("--hosts", type=int, default=0,
                       help="N>0: hierarchical local SGD over N host "
                            "fault domains (two-tier: per-step grad "
                            "pmean inside a host, tau-interval masked "
                            "averaging across hosts; membership/eviction "
                            "at host granularity). Single-process: N "
                            "virtual domains partition the worker slots; "
                            "multi-process (SPARKNET_NUM_PROCESSES): one "
                            "domain per process, relayed through "
                            "--heartbeat-dir")
    p.add_argument("--reshard", choices=("strict", "auto"),
                   default="strict",
                   help="cross-world restore policy: 'strict' refuses a "
                        "snapshot stamped by a different world "
                        "(WorldMismatch names both worlds); 'auto' "
                        "re-partitions it for THIS world — an 8-way "
                        "run's checkpoint resumes on 4 or 16 "
                        "(resilience/checkpoint.reshard_for_world)")
    p.add_argument("--chaos", metavar="SPEC",
                   help="deterministic fault injection, e.g. "
                        "'nan_step=30,io_p=0.02,sigterm_round=3,seed=1' "
                        "or 'kill_worker=1,kill_round=3' (also via "
                        "SPARKNET_CHAOS; see resilience/chaos.py)")
    p.add_argument("--quorum", type=int, default=0, metavar="N",
                   help="arm elastic membership: sync rounds become "
                        "validity-masked quorum averages that survive "
                        "worker loss; abort with exit 4 when fewer than "
                        "N workers are live (0 = elasticity off unless "
                        "--evict-after/--readmit-after is given, then "
                        "quorum defaults to 1)")
    p.add_argument("--evict-after", type=int, default=None, metavar="R",
                   help="evict a worker after R consecutive rounds with "
                        "an invalid (non-finite) contribution "
                        "(default 2); its data shard re-spreads over "
                        "the survivors")
    p.add_argument("--readmit-after", type=int, default=None, metavar="R",
                   help="readmit an evicted worker after an R-round "
                        "cooldown, restarting it from the consensus "
                        "weights (default 5; 0 = never readmit)")
    p.add_argument("--staleness", type=int, default=None, metavar="S",
                   help="arm the ASYNC bounded-staleness update mode "
                        "(the knob next to --tau): rounds are barrier-"
                        "free — a worker up to S rounds behind the "
                        "fastest live peer still contributes "
                        "(staleness-discounted), beyond S it is parked "
                        "and resynced from the consensus; the round "
                        "never waits for a straggler. S=0 is bit-for-"
                        "bit the synchronous masked round")
    p.add_argument("--s-decay", type=float, default=0.5,
                   help="geometric per-round-of-lag discount applied "
                        "to stale contributions in async mode "
                        "(1.0 = no discount inside the bound)")
    p.add_argument("--unpark-after", type=int, default=1, metavar="R",
                   help="rounds a parked (over-stale) worker spends "
                        "resyncing before it rejoins at the front "
                        "(async mode; default 1)")
    p.add_argument("--evict-stale-after", type=int, default=0,
                   metavar="K",
                   help="evict a worker after K chronic parks without "
                        "a sustained in-bound stretch (async mode; "
                        "0 = park/resync forever, never evict)")
    p.add_argument("--heartbeat-dir", metavar="DIR",
                   help="shared rendezvous directory (every host must "
                        "reach it): arms leased heartbeats, host-level "
                        "eviction on lease expiry, the no-hang round "
                        "gate, and coordinated restart on quorum loss")
    p.add_argument("--lease-s", type=float, default=3.0,
                   help="heartbeat lease: a host silent this long is "
                        "dead (evicted at the next round gate)")
    p.add_argument("--heartbeat-interval", type=float, default=0.5,
                   help="seconds between heartbeat re-leases (must be "
                        "well under --lease-s)")
    p.add_argument("--grow", action="store_true",
                   help="late-join an already-RUNNING world through "
                        "--heartbeat-dir: this standalone process scans "
                        "the fresh leases, takes the next host id, and "
                        "is admitted at the incumbents' next round gate "
                        "(nothing rebuilt); pair with --resume auto "
                        "--reshard auto to bootstrap weights from the "
                        "running world's checkpoint")


def _install_chaos(args, metrics=None):
    """--chaos arms the process-wide injector BEFORE any solver or data
    source is built, so they pick it up through active_chaos(); a bad
    spec is a usage error."""
    if not getattr(args, "chaos", None):
        return None
    from .resilience.chaos import ChaosMonkey, install_chaos
    try:
        monkey = ChaosMonkey.parse(args.chaos, metrics=metrics)
    except ValueError as e:
        raise SystemExit(f"--chaos: {e}") from None
    install_chaos(monkey)
    return monkey


def _apply_heartbeat_flags(solver, args):
    if not getattr(args, "heartbeat_dir", None):
        return
    solver.arm_heartbeat(args.heartbeat_dir,
                         interval_s=args.heartbeat_interval,
                         lease_s=args.lease_s,
                         grow=getattr(args, "grow", False))


def _apply_elastic_flags(solver, args):
    on = args.quorum > 0 or args.evict_after is not None \
        or args.readmit_after is not None
    if on:
        solver.arm_elastic(
            quorum=max(1, args.quorum),
            evict_after=args.evict_after
            if args.evict_after is not None else 2,
            readmit_after=args.readmit_after
            if args.readmit_after is not None else 5)
    if getattr(args, "staleness", None) is not None:
        # after arm_elastic: the policy the flags armed gains the
        # staleness fields (arm_staleness updates it in place)
        solver.arm_staleness(args.staleness, decay=args.s_decay,
                             unpark_after=args.unpark_after,
                             evict_parked_after=args.evict_stale_after)


def cmd_serve(args):
    """Weights-only inference over a snapshot prefix — continuous
    batching, hot reload, graceful drain, as the JAX verb. Exit 0 after
    a clean SIGTERM/SIGINT drain (or a router's drain order); exit 3
    (EXIT_RECOVERY_ABORT) when the checkpoint has no servable model
    blob, before the socket ever opens; exit 2 on a bad --chaos spec.
    With --fleet_dir the replica leases into the fleet rendezvous
    (serve/fleet.py) for the ``route`` verb to discover."""
    from .obs.tracing import TraceSampler
    from .serve import Batcher, ReplicaMember, ServeEngine, serve_http
    from .utils.metrics import MetricsLogger
    from .utils.signals import SignalPolicy
    _apply_perf_flags(args)   # before any net is built
    net_param = None
    if args.model:
        from .proto import text_format
        net_param = text_format.load(args.model, "NetParameter")
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    chaos = None
    if args.chaos:
        from .resilience.chaos import ChaosMonkey
        try:
            chaos = ChaosMonkey.parse(args.chaos, metrics=metrics)
        except ValueError as e:
            print(f"sparknet_tpu_torch serve: error: {e}", file=sys.stderr)
            if metrics:
                metrics.close()
            return EXIT_USAGE
    engine = ServeEngine(args.prefix, net_param=net_param,
                         max_batch=args.max_batch, device=args.device,
                         metrics=metrics)
    try:
        engine.load()
    except ValueError as e:
        print(f"sparknet_tpu_torch serve: error: {e}", file=sys.stderr)
        if metrics:
            metrics.close()
        return EXIT_RECOVERY_ABORT
    if not args.no_warmup:
        engine.warmup()           # builds the kernels, runs every bucket
    batcher = Batcher(max_batch=args.max_batch,
                      max_wait_s=args.max_wait_ms / 1e3,
                      queue_limit=args.queue_limit, metrics=metrics)
    member = None
    if args.fleet_dir:
        member = ReplicaMember(args.fleet_dir, args.replica,
                               replicas=args.replicas, engine=engine,
                               batcher=batcher,
                               interval_s=args.heartbeat_interval,
                               lease_s=args.lease, metrics=metrics)
    tracer = TraceSampler(sample=args.trace_sample,
                          tail_ms=args.trace_tail_ms)
    # SIGTERM = the scheduler's preemption notice -> drain, exit 0
    policy = SignalPolicy(sigint="stop", sighup="none", sigterm="stop")
    with policy:
        rc = serve_http(engine, batcher, host=args.host, port=args.port,
                        metrics=metrics, policy=policy,
                        reload_poll_s=args.reload_poll,
                        request_timeout_s=args.request_timeout,
                        member=member, chaos=chaos,
                        replica=args.replica, tracer=tracer)
    if metrics:
        metrics.close()
    return rc


def cmd_route(args):
    """The serving-fleet router (serve/fleet.py): lease-based membership
    over --fleet_dir, least-queue-depth dispatch with retry-once
    failover, SLO autoscaling decisions, canary auto-rollback. Exit 0
    after a clean SIGTERM/SIGINT drain; a fleet with no live replica
    answers 503s and waits for capacity to lease back in. Plain Python:
    no device."""
    from .obs.tracing import BurnRateLedger, TraceSampler
    from .serve import CanaryController, Router, SLOAutoscaler, route_http
    from .utils.metrics import MetricsLogger
    from .utils.signals import SignalPolicy
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    canary = CanaryController(
        pct=args.canary_pct, min_requests=args.canary_min_requests,
        max_err_delta=args.canary_err_delta,
        max_p99_delta_ms=args.canary_p99_delta_ms, metrics=metrics)
    tracer = TraceSampler(sample=args.trace_sample,
                          tail_ms=args.trace_tail_ms)
    slo = None
    if not args.no_slo_burn:
        slo = BurnRateLedger(
            slo_ms=(args.slo_ms if args.slo_ms is not None
                    else args.slo_p99_ms),
            objective=args.slo_objective, scale=args.burn_scale,
            metrics=metrics)
    router = Router(args.fleet_dir, replicas=args.replicas,
                    lease_s=args.lease, canary=canary, metrics=metrics,
                    tracer=tracer, slo=slo)
    autoscaler = None
    if not args.no_autoscale:
        autoscaler = SLOAutoscaler(
            p99_ms=args.slo_p99_ms, depth=args.slo_depth,
            windows=args.breach_windows, idle_windows=args.idle_windows,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas, metrics=metrics)
    policy = SignalPolicy(sigint="stop", sighup="none", sigterm="stop")
    with policy:
        rc = route_http(router, autoscaler=autoscaler, host=args.host,
                        port=args.port, window_s=args.window_s,
                        policy=policy, request_timeout_s=args.request_timeout)
    if metrics:
        metrics.close()
    return rc


def cmd_serve_bench(args):
    """Load-generate against a running ``serve`` replica or ``route``
    router (closed and/or open loop); exit 1 when any request failed."""
    from .serve import run_loadgen
    from .utils.metrics import MetricsLogger
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    modes = ("closed", "open") if args.mode == "both" else (args.mode,)
    results = []
    for mode in modes:
        results.append(run_loadgen(
            args.url, mode=mode, concurrency=args.concurrency,
            rate=args.rate, duration_s=args.duration, rows=args.rows,
            timeout=args.request_timeout, metrics=metrics))
    if metrics:
        metrics.close()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    bad = sum(r["errors"] for r in results)
    return 0 if bad == 0 else 1


def cmd_monitor(args):
    """Tail a --metrics JSONL and render a live terminal summary
    (obs/monitor.py): round/iter/loss, per-worker losses, divergence,
    stragglers, memory, the serving fleet, last health alarm."""
    from .obs import monitor as obs_monitor
    from .obs.report import MetricsFileError
    try:
        state = obs_monitor.monitor_file(
            args.jsonl, interval=args.interval, once=args.once,
            wait=args.wait, duration=args.duration)
    except MetricsFileError as e:
        print(f"sparknet_tpu_torch monitor: error: {e}", file=sys.stderr)
        return EXIT_USAGE
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    return 0 if state.events else EXIT_USAGE


def _print_serve_sim(s):
    print(f"servefleet: {s['replicas']} replicas x "
          f"{s['windows']} windows (sim {s['sim_s']}s) "
          f"trace={s['trace']} rate={s['rate']:g}/s "
          f"lease={s['lease_s']:g} interval={s['interval_s']:g}")
    print(f"traffic: {s['arrivals']} arrivals -> {s['ok']} ok, "
          f"{s['rejected']} rejected (429), {s['errors']} "
          f"errors, {s['retries']} retried; lost {s['lost']}")
    print(f"availability {s['availability']}  "
          f"p99 {s['p99_ms']}ms"
          + (f"  top stage {s['top_stage']}"
             if s.get("top_stage") else ""))
    if s.get("burn"):
        b = s["burn"]
        print(f"slo burn: fast x{b.get('fast')}"
              f"/{b.get('fast_long')} slow x{b.get('slow')}"
              f"/{b.get('slow_long')} budget left "
              f"{b.get('budget_left')}"
              + (f"  ALERT {b['alert']}" if b.get("alert") else ""))
    print(f"membership: {s['evictions']} evictions, "
          f"{s['readmissions']} readmissions, "
          f"{s['admissions']} admissions; final live "
          f"{s['replicas_final']}; grow {s['grow']} shrink "
          f"{s['shrink']}; canary rollbacks "
          f"{s['canary_rollbacks']}"
          + ("  QUORUM LOST" if s["quorum_lost"] else ""))


def cmd_simfleet(args):
    """The discrete-event fleet simulator (sim/): virtual hosts driving
    the real heartbeat, consensus and elastic-policy code on a simulated
    clock and an in-memory rendezvous directory — one run, a --sweep
    grid, or the replay pair (--record_real / --replay); with --serve
    the serving fleet's simulator (sim/servefleet.py) instead. Exit 0 on
    success, 1 on a replay mismatch or a lost serving request
    (no-lost-request-without-429 invariant), 2 on a bad chaos/sweep
    spec, 4 (EXIT_QUORUM_LOST) when the simulated fleet loses quorum.
    Plain Python: no device."""
    import tempfile
    from .sim import FleetSim, ServeFleetSim, replay, sweep
    from .utils.exit_codes import EXIT_QUORUM_LOST
    from .utils.metrics import MetricsLogger
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    log = print if args.verbose else None
    try:
        if not args.serve:
            return _simfleet_training(args, metrics, log, FleetSim, replay,
                                      sweep, tempfile)
        if args.sweep:
            cells = []
            for spec in args.sweep:
                cells.extend(sweep.parse_serve_grid(spec))
            results = sweep.run_sweep(cells, metrics=metrics, log_fn=print,
                                      budget_s=args.budget_s,
                                      cell_fn=sweep.run_serve_cell)
            print(sweep.render_serve_table(results))
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(results, f, indent=1)
            lost = sum(r["lost"] for r in results)
            if lost:
                print(f"sparknet_tpu_torch simfleet: {lost} request(s) "
                      "LOST without an explicit 429/5xx — the serving "
                      "invariant is broken", file=sys.stderr)
                return 1
            return 0
        sim = ServeFleetSim(
            replicas=args.replicas, windows=args.windows,
            window_s=args.window_s, interval_s=args.interval,
            lease_s=args.lease, service_ms=args.service_ms,
            queue_limit=args.queue_limit, rate=args.rate,
            trace=args.trace, spike_x=args.spike_x,
            slo_p99_ms=args.slo_p99_ms, slo_depth=args.slo_depth,
            breach_windows=args.breach_windows,
            idle_windows=args.idle_windows,
            max_replicas=args.max_replicas, canary_w=args.canary_w,
            canary_pct=args.canary_pct, canary_err=args.canary_err,
            canary_min_requests=args.canary_min_requests,
            die_w=args.die_w, rejoin_w=args.rejoin_w,
            chaos=args.chaos, seed=args.seed,
            trace_sample=args.trace_sample,
            tail_ms=args.trace_tail_ms, slo_burn=args.slo_burn,
            burn_scale=args.burn_scale, metrics=metrics, log_fn=log)
        s = sim.run()
        _print_serve_sim(s)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(s, f, indent=1)
        if s["quorum_lost"]:
            return EXIT_QUORUM_LOST
        return 1 if s["lost"] else 0
    except ValueError as e:
        print(f"sparknet_tpu_torch simfleet: error: {e}", file=sys.stderr)
        return EXIT_USAGE
    finally:
        if metrics:
            metrics.close()


def _simfleet_training(args, metrics, log, FleetSim, replay, sweep,
                       tempfile):
    """simfleet without --serve: the training fleet (sim/fleet.py)."""
    from .utils.exit_codes import EXIT_QUORUM_LOST
    if args.record_real:
        with tempfile.TemporaryDirectory() as d:
            rec = replay.record_real(
                d, hosts=min(args.hosts, 4), rounds=args.rounds,
                interval_s=args.interval, lease_s=args.lease,
                round_s=args.round_s or 0.12,
                evict_after=args.evict_after,
                readmit_after=args.readmit_after,
                quorum=args.quorum, log_fn=log)
        with open(args.record_real, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"simfleet: recorded real {rec['config']['hosts']}-"
              f"coordinator run -> {args.record_real} "
              f"({len(rec['sequence'])} membership events)")
        return 0
    if args.replay:
        with open(args.replay) as f:
            rec = json.load(f)
        ok, real_seq, sim_seq = replay.replay_sim(rec, metrics=metrics,
                                                  log_fn=log)
        if ok:
            print(f"simfleet: REPLAY MATCH — {len(sim_seq)} "
                  "membership events reproduced exactly")
            return 0
        print("simfleet: REPLAY MISMATCH", file=sys.stderr)
        print(f"  real: {real_seq}", file=sys.stderr)
        print(f"  sim:  {sim_seq}", file=sys.stderr)
        return 1
    if args.sweep:
        cells = []
        for spec in args.sweep:
            cells.extend(sweep.parse_grid(spec))
        results = sweep.run_sweep(cells, metrics=metrics, log_fn=print,
                                  budget_s=args.budget_s)
        print(sweep.render_table(results))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=1)
        return 0
    sim = FleetSim(hosts=args.hosts, rounds=args.rounds,
                   interval_s=args.interval, lease_s=args.lease,
                   round_s=args.round_s, jitter=args.jitter, tau=args.tau,
                   step_s=args.step_s, quorum=args.quorum,
                   evict_after=args.evict_after,
                   readmit_after=args.readmit_after,
                   staleness=args.staleness, s_decay=args.s_decay,
                   consensus=args.consensus,
                   recover_after=args.recover_after, chaos=args.chaos,
                   seed=args.seed, metrics=metrics, log_fn=log)
    s = sim.run()
    w = s["gate_wait_s"]
    print(f"fleet: {s['hosts']} hosts x {s['rounds']} rounds "
          f"(sim {s['sim_s']}s) consensus={s['consensus']} "
          f"lease={s['lease_s']:g} interval={s['interval_s']:g} "
          f"round_s={s['round_s']:g}")
    print(f"membership: {s['evictions']} evictions, "
          f"{s['readmissions']} readmissions, "
          f"{s['admissions']} admissions; "
          f"final live {s['live_final']}/{s['hosts']}"
          + ("  QUORUM LOST" if s["quorum_lost"] else ""))
    print(f"gate wait: mean {w['mean']}s p50 {w['p50']}s "
          f"p95 {w['p95']}s max {w['max']}s")
    print(f"staleness: parks {s['parks']} unparks {s['unparks']}"
          + (f" max_lag {s['max_lag']}" if "max_lag" in s else "")
          + f"  rollbacks {s['rollbacks']}"
          + f"  retry_exhausted {s['retry_exhausted']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)
    return EXIT_QUORUM_LOST if s["quorum_lost"] else 0


def _add_fleet_parsers(sub):
    """The serving fleet's verbs — route, serve-bench, simfleet --serve
    and monitor — with the JAX verbs' flags and defaults. None of them
    touches a device."""
    rt = sub.add_parser(
        "route",
        help="serving-fleet router: discovers `serve --fleet_dir` "
             "replicas through their leases, spreads POST /predict by "
             "least queue depth with retry-once failover, makes SLO "
             "autoscaling decisions, auto-rolls-back a bad canary "
             "checkpoint")
    rt.add_argument("--fleet_dir", required=True,
                    help="the fleet rendezvous directory replicas "
                         "lease into")
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port (announced on stdout)")
    rt.add_argument("--replicas", type=int, default=1,
                    help="expected initial fleet size (late replicas "
                         "grow the world on admission)")
    rt.add_argument("--lease", type=float, default=3.0,
                    help="lease_s: a replica whose beat is staler "
                         "than this is evicted (failover window)")
    rt.add_argument("--window_s", type=float, default=1.0,
                    help="membership/SLO evaluation cadence")
    rt.add_argument("--request_timeout", type=float, default=30.0,
                    help="per-dispatch timeout toward a replica")
    rt.add_argument("--no_autoscale", action="store_true",
                    help="disable SLO autoscaling decisions")
    rt.add_argument("--slo_p99_ms", type=float, default=500.0,
                    help="autoscaler p99 target")
    rt.add_argument("--slo_depth", type=int, default=32,
                    help="autoscaler queue-depth target")
    rt.add_argument("--breach_windows", type=int, default=3,
                    help="consecutive breach windows before a grow "
                         "decision (scale events; an orchestrator "
                         "launches the replica)")
    rt.add_argument("--idle_windows", type=int, default=30,
                    help="consecutive idle windows before a shrink "
                         "(drain order to the highest replica)")
    rt.add_argument("--min_replicas", type=int, default=1)
    rt.add_argument("--max_replicas", type=int, default=8)
    rt.add_argument("--canary_pct", type=float, default=20.0,
                    help="traffic share for a second checkpoint sha "
                         "while a canary is in flight")
    rt.add_argument("--canary_min_requests", type=int, default=20,
                    help="canary responses required before a verdict")
    rt.add_argument("--canary_err_delta", type=float, default=0.05,
                    help="rollback when canary error rate exceeds "
                         "baseline by this")
    rt.add_argument("--canary_p99_delta_ms", type=float, default=500.0,
                    help="rollback when canary p99 exceeds baseline "
                         "by this")
    rt.add_argument("--metrics", help="JSONL metrics output path "
                                      "(route/scale/canary + "
                                      "membership events)")
    rt.add_argument("--trace_sample", type=float, default=1.0,
                    help="serve_trace head-sampling rate at the "
                         "router (1.0 = every request)")
    rt.add_argument("--trace_tail_ms", type=float, default=250.0,
                    help="always keep serve_trace exemplars at/above "
                         "this latency, regardless of sampling")
    rt.add_argument("--slo_ms", type=float, default=None,
                    help="error-budget SLO latency bound (default: "
                         "--slo_p99_ms)")
    rt.add_argument("--slo_objective", type=float, default=0.999,
                    help="error-budget availability objective "
                         "(fraction of requests that must be good)")
    rt.add_argument("--burn_scale", type=float, default=1.0,
                    help="burn-rate window scale (0.01 shrinks the "
                         "5m/1h/6h windows 100x for short runs)")
    rt.add_argument("--no_slo_burn", action="store_true",
                    help="disable the SLO error-budget ledger")
    rt.set_defaults(fn=cmd_route)

    sb = sub.add_parser(
        "serve-bench",
        help="load-generate against a running serve replica or route "
             "router (closed loop = capacity, open loop = honest tail "
             "latency at a fixed arrival rate)")
    sb.add_argument("--url", required=True,
                    help="server base URL, e.g. http://127.0.0.1:8080")
    sb.add_argument("--mode", choices=("closed", "open", "both"),
                    default="closed")
    sb.add_argument("--concurrency", type=int, default=4,
                    help="closed loop: workers with one request in "
                         "flight each (also bounds open-loop dispatch)")
    sb.add_argument("--rate", type=float, default=50.0,
                    help="open loop: offered requests/second")
    sb.add_argument("--duration", type=float, default=5.0,
                    help="seconds per mode")
    sb.add_argument("--rows", type=int, default=1,
                    help="rows per request")
    sb.add_argument("--request_timeout", type=float, default=10.0)
    sb.add_argument("--metrics", help="JSONL metrics output path "
                                      "(bench rows)")
    sb.add_argument("--json", help="write per-mode summaries here")
    sb.set_defaults(fn=cmd_serve_bench)

    mo = sub.add_parser("monitor",
                        help="tail a --metrics JSONL and render a live "
                             "terminal summary (round/loss per worker, "
                             "divergence, stragglers, memory, the "
                             "serving fleet, alarms)")
    mo.add_argument("jsonl", help="metrics JSONL a run is writing "
                                  "via --metrics")
    mo.add_argument("--interval", type=float, default=1.0,
                    help="refresh period in seconds")
    mo.add_argument("--once", action="store_true",
                    help="render the current state once and exit")
    mo.add_argument("--wait", action="store_true",
                    help="wait for the file to appear instead of erroring "
                         "(a run that hasn't started writing yet)")
    mo.add_argument("--duration", type=float, default=None,
                    help="stop after this many seconds (default: forever)")
    mo.set_defaults(fn=cmd_monitor)

    sf = sub.add_parser(
        "simfleet",
        help="discrete-event fleet simulator: thousands of virtual "
             "hosts drive the real heartbeat/consensus/elastic-policy "
             "code (simulated clock, in-memory rendezvous) — single "
             "runs, --sweep grids, and replay validation against a "
             "recorded real multi-coordinator run")
    sf.add_argument("--hosts", type=int, default=64,
                    help="virtual fleet size")
    sf.add_argument("--rounds", type=int, default=50,
                    help="simulated training rounds")
    sf.add_argument("--interval", type=float, default=0.5,
                    help="heartbeat interval_s, simulated seconds")
    sf.add_argument("--lease", type=float, default=3.0,
                    help="heartbeat lease_s, simulated seconds")
    sf.add_argument("--round_s", type=float, default=None,
                    help="simulated round duration (default: "
                         "tau * step_s)")
    sf.add_argument("--tau", type=int, default=4,
                    help="local steps per consensus round (round_s = "
                         "tau * step_s — sweeping tau changes how much "
                         "compute amortizes each gate)")
    sf.add_argument("--step_s", type=float, default=0.25,
                    help="simulated seconds per local step")
    sf.add_argument("--jitter", type=float, default=0.15,
                    help="per-host round-duration jitter (std dev "
                         "fraction, seeded)")
    sf.add_argument("--quorum", type=int, default=1,
                    help="ElasticPolicy quorum (exit 4 below it)")
    sf.add_argument("--evict_after", type=int, default=1,
                    help="ElasticPolicy evict_after")
    sf.add_argument("--readmit_after", type=int, default=0,
                    help="ElasticPolicy readmit cooldown (0 = never)")
    sf.add_argument("--staleness", type=int, default=None,
                    help="bounded-staleness s (parking past it)")
    sf.add_argument("--s_decay", type=float, default=0.5,
                    help="staleness consensus weight decay per lag")
    sf.add_argument("--consensus",
                    choices=("auto", "sync", "async", "none"),
                    default="auto",
                    help="cross-host transport: the real File/"
                         "AsyncFileConsensus at small fleets, policy-"
                         "level version clocks at scale (auto)")
    sf.add_argument("--recover_after", type=int, default=0,
                    help="revive chaos-killed hosts after this many "
                         "rounds (0 = never) — the MTBF repair half")
    sf.add_argument("--chaos",
                    help="chaos spec, e.g. 'fail_rate=0.001,"
                         "fail_seed=7,fail_corr=8' or 'kill_host=2,"
                         "kill_host_round=5'; with --serve "
                         "'kill_replica=1,kill_req=40' "
                         "(resilience/chaos.py)")
    sf.add_argument("--seed", type=int, default=0,
                    help="master seed: same spec + seed = same "
                         "timeline, to the event")
    sf.add_argument("--metrics",
                    help="JSONL metrics output — the standard stream; "
                         "renders through the report and monitor verbs "
                         "unchanged")
    sf.add_argument("--json", help="write the summary (or sweep "
                                   "results) JSON here")
    sf.add_argument("--sweep", action="append", metavar="GRID",
                    help="axis grid 'hosts=200:1000,fail_rate="
                         "0.0005:0.005', or with --serve "
                         "'replicas=2:4,trace=spike:flash' (Cartesian; "
                         "repeatable — cells accumulate)")
    sf.add_argument("--budget_s", type=float, default=None,
                    help="real wall-clock budget for a sweep; unfired "
                         "cells are reported, never silently dropped")
    sf.add_argument("--record_real", metavar="OUT",
                    help="run a REAL multi-coordinator SIGKILL-shaped "
                         "scenario (threads + wall clock + on-disk "
                         "rendezvous) and record its membership "
                         "sequence to OUT for --replay")
    sf.add_argument("--replay", metavar="REC",
                    help="re-run a recording in the simulator; exit 1 "
                         "unless the membership sequence matches "
                         "exactly")
    sf.add_argument("-v", "--verbose", action="store_true",
                    help="log the simulated fleet's membership story")
    sf.add_argument("--serve", action="store_true",
                    help="simulate the serving fleet: virtual replicas + "
                         "the REAL router/autoscaler/canary under "
                         "open-loop arrival traces; exit 1 when any "
                         "request is lost without an explicit 429/5xx")
    sf.add_argument("--replicas", type=int, default=3,
                    help="(--serve) initial replica count")
    sf.add_argument("--windows", type=int, default=30,
                    help="(--serve) router windows to simulate")
    sf.add_argument("--window_s", type=float, default=1.0,
                    help="(--serve) router window, simulated seconds")
    sf.add_argument("--service_ms", type=float, default=20.0,
                    help="(--serve) per-request service time")
    sf.add_argument("--queue_limit", type=int, default=64,
                    help="(--serve) per-replica queue bound (429 past "
                         "it)")
    sf.add_argument("--rate", type=float, default=40.0,
                    help="(--serve) base arrival rate, req/s")
    sf.add_argument("--trace",
                    choices=("flat", "diurnal", "spike", "flash"),
                    default="flat",
                    help="(--serve) open-loop arrival shape")
    sf.add_argument("--spike_x", type=float, default=4.0,
                    help="(--serve) spike/flash rate multiplier")
    sf.add_argument("--slo_p99_ms", type=float, default=500.0,
                    help="(--serve) autoscaler p99 target")
    sf.add_argument("--slo_depth", type=int, default=32,
                    help="(--serve) autoscaler queue-depth target")
    sf.add_argument("--breach_windows", type=int, default=3,
                    help="(--serve) consecutive breach windows before "
                         "grow")
    sf.add_argument("--idle_windows", type=int, default=10,
                    help="(--serve) consecutive idle windows before "
                         "shrink")
    sf.add_argument("--max_replicas", type=int, default=8,
                    help="(--serve) autoscaler growth ceiling")
    sf.add_argument("--canary_w", type=int, default=0,
                    help="(--serve) window at which one replica "
                         "hot-reloads to a faulty sha (0 = never)")
    sf.add_argument("--canary_pct", type=float, default=20.0,
                    help="(--serve) canary traffic percentage")
    sf.add_argument("--canary_err", type=float, default=1.0,
                    help="(--serve) canary per-request fault "
                         "probability")
    sf.add_argument("--canary_min_requests", type=int, default=10,
                    help="(--serve) canary verdict sample floor")
    sf.add_argument("--die_w", type=int, default=None,
                    help="(--serve) window at which the lowest live "
                         "replica dies (deterministic kill)")
    sf.add_argument("--rejoin_w", type=int, default=None,
                    help="(--serve) window at which a dead replica "
                         "rejoins")
    sf.add_argument("--trace_sample", type=float, default=1.0,
                    help="(--serve) serve_trace head-sampling rate "
                         "(1.0 = every request)")
    sf.add_argument("--trace_tail_ms", type=float, default=None,
                    help="(--serve) always keep serve_trace exemplars "
                         "at/above this latency, regardless of "
                         "sampling")
    sf.add_argument("--slo_burn", action="store_true",
                    help="(--serve) track the SLO error budget and "
                         "multi-window burn-rate alerts")
    sf.add_argument("--burn_scale", type=float, default=1.0,
                    help="(--serve) burn-rate window scale (0.01 "
                         "shrinks the 5m/1h/6h windows 100x for "
                         "short sims)")
    sf.set_defaults(fn=cmd_simfleet)


def cmd_lint(args):
    """Static analysis (sparknet_tpu_torch.analysis): the JAX package's
    rule families over the port's source — the lock-discipline and
    deadlock rules of the threaded host side, the distributed
    file-protocol rules and the metrics event-schema rules. The
    analysis package imports no torch."""
    from .analysis.cli import run_lint
    return run_lint(args)


def _add_lint_parser(sub):
    """The JAX verb's flags; the default target, baseline and schema
    are the port's."""
    li = sub.add_parser(
        "lint",
        help="static analysis: JAX hazard rules (host syncs/recompiles/"
             "PRNG reuse/axis mismatches in jitted code), the "
             "guarded-by lock-discipline race checker, deadlock rules "
             "(lock-order cycles, blocking/callbacks under locks), "
             "distributed file-protocol rules (atomic rendezvous "
             "writes, bounded gates, canonical exit codes), and the "
             "metrics event-schema rules")
    li.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "sparknet_tpu_torch package source)")
    li.add_argument("--strict", action="store_true",
                    help="exit 1 on ANY non-baselined finding (warnings "
                         "included), stale baseline entries, or "
                         "baseline entries without a justification")
    li.add_argument("--baseline",
                    help="baseline file (default: "
                         ".sparknet-torch-lint-baseline.json next to the "
                         "lint root, then CWD)")
    li.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings into the baseline "
                         "(new entries need --justification; stale "
                         "entries expire)")
    li.add_argument("--justification",
                    help="justification text recorded on entries newly "
                         "added by --write-baseline")
    li.add_argument("--select", metavar="CODES",
                    help="comma-separated rule codes to run "
                         "(e.g. SPK201,SPK301), or a profile: @tests "
                         "(parse/file-protocol/exit-code rules for the "
                         "test tree), @tools (those plus the JAX "
                         "host-sync hazards)")
    li.add_argument("--exclude", action="append", default=[],
                    metavar="PATTERN",
                    help="skip files whose path matches (substring, "
                         "glob, or path-component glob); repeatable — "
                         "e.g. --exclude fixtures")
    li.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="lint files across N forked workers (the "
                         "parsed project index is shared "
                         "copy-on-write)")
    li.add_argument("--cache", action="store_true",
                    help="reuse per-file results keyed on content + "
                         "rule sources + cross-module summaries "
                         "(.sparknet-torch-lint-cache.json next to the "
                         "root; safe to delete any time)")
    li.add_argument("--write-event-schema", action="store_true",
                    help="regenerate sparknet_tpu_torch/obs/"
                         "event_schema.py from the port's and the repo "
                         "root scripts' metrics emit sites and exit "
                         "(rules SPK401/402 check against it)")
    li.add_argument("--root", help="directory finding paths are "
                                   "reported relative to (default: "
                                   "CWD, or the package parent when "
                                   "linting the default target)")
    li.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    li.add_argument("-v", "--verbose", action="store_true",
                    help="also print baselined findings with their "
                         "justifications")
    li.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    li.set_defaults(fn=cmd_lint)


def parser():
    """The command line's argparse parser (every verb)."""
    p = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch",
        description="SparkNet's PyTorch/CUDA port: train and serve on an "
                    "NVIDIA GPU")
    sub = p.add_subparsers(dest="verb", required=True)
    t = sub.add_parser("train", help="train from a solver prototxt")
    t.add_argument("--solver", required=True)
    t.add_argument("--weights", help=".caffemodel to finetune from")
    t.add_argument("--snapshot", help=".solverstate to resume from")
    t.add_argument("--iterations", type=int, default=None,
                   help="train until this iteration (default: the "
                        "solver's max_iter, else 1000)")
    t.add_argument("--snapshot-prefix",
                   help="override the solver's snapshot_prefix")
    t.add_argument("--resume", metavar="auto|STATE",
                   help="'auto': continue from the newest valid snapshot "
                        "under the snapshot prefix (partial/corrupt ones "
                        "are skipped with a reason); or an explicit "
                        ".solverstate path")
    t.add_argument("--input-shape", action="append", default=[],
                   help='feed blob shape, e.g. "data=100,3,32,32" (stands '
                        "in for the record shape where no source exists)")
    t.add_argument("--strategy", choices=("single", "dp"), default="single",
                   help="single: one solver (the default); dp: each batch "
                        "split over the --mesh data axis's worker slots, "
                        "their gradients averaged")
    t.add_argument("--mesh", type=_mesh_arg, default=None,
                   help='"data=W[,axis=N...]" or "W": slots under '
                        "--strategy dp; the batch splits over the data "
                        "axis, the other axes replicate, and snapshots "
                        "are stamped with the whole mesh (default: one "
                        "data slot)")
    t.add_argument("--host-transform", action="store_true",
                   help="crop/mirror/mean on the host and ship float32 "
                        "crops, instead of the default: raw uint8 records "
                        "transformed on the device")
    t.add_argument("--metrics", help="JSONL metrics output path")
    t.add_argument("--profile",
                   help="write a torch.profiler trace of one steady "
                        "100-iteration block (the card's kernels) to this "
                        "directory as torch.trace.json, beside the run's "
                        "spans as spans.trace.json")
    t.add_argument("--stall-seconds", type=float, default=0,
                   help="arm a stall/NaN watchdog with this timeout: a "
                        "stall or a NaN is printed and, with --metrics, "
                        "logged as a `watchdog` event, as in the JAX verb; "
                        "the run goes on")
    for sig, effect in (("sigint", "stop"), ("sighup", "snapshot"),
                        ("sigterm", "snapshot_stop")):
        t.add_argument(f"--{sig}_effect", default=effect,
                       choices=("snapshot", "stop", "snapshot_stop",
                                "none"),
                       help=f"what {sig.upper()} does between blocks "
                            f"(default {effect})")
    t.add_argument("--keep", type=int, default=5,
                   help="snapshot retention: keep the newest N manifested "
                        "snapshots, delete older ones (0 = keep all)")
    t.add_argument("--recover", type=int, default=0, metavar="N",
                   help="arm divergence recovery: roll back to the last "
                        "known-good state on a NaN/exploding loss, up to "
                        "N consecutive times before a clean abort "
                        "(exit 3)")
    t.add_argument("--recover-lr-decay", type=float, default=1.0,
                   help="multiply the lr schedule by this on every "
                        "rollback (e.g. 0.5)")
    t.add_argument("--recover-explode-factor", type=float, default=0.0,
                   help=">0: also roll back when the loss exceeds this "
                        "factor times its recent healthy EMA")
    _add_perf_flags(t)
    _add_feed_flags(t)
    _add_health_flags(t)
    _add_resilience_flags(t)
    t.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; the "
                        "CPU runs only when asked: --device cpu)")
    t.set_defaults(fn=cmd_train)
    te = sub.add_parser("test", help="score a model")
    te.add_argument("--model", required=True)
    te.add_argument("--weights")
    te.add_argument("--iterations", type=int, default=50)
    te.add_argument("--input-shape", action="append", default=[])
    te.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu)")
    te.set_defaults(fn=cmd_test)
    ti = sub.add_parser("time", help="per-layer timing")
    ti.add_argument("--model", required=True)
    ti.add_argument("--iterations", type=int, default=10)
    ti.add_argument("--input-shape", action="append", default=[])
    ti.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu)")
    ti.set_defaults(fn=cmd_time)
    d = sub.add_parser("device_query", help="list CUDA devices")
    d.set_defaults(fn=cmd_device_query)
    cc = sub.add_parser("convert_cifar_data",
                        help="CIFAR-10 .bin batches -> train/test LMDBs")
    cc.add_argument("input", help="dir with data_batch_*.bin + test_batch.bin")
    cc.add_argument("output", help="dir to create cifar10_{train,test}_lmdb")
    cc.set_defaults(fn=cmd_convert_cifar)
    cm = sub.add_parser("compute_image_mean",
                        help="Datum DB -> mean image .binaryproto")
    cm.add_argument("db")
    cm.add_argument("output")
    cm.add_argument("--backend", choices=("lmdb", "leveldb"), default=None,
                    help="DB backend (default: sniff the directory layout)")
    cm.set_defaults(fn=cmd_compute_mean)
    ci = sub.add_parser("convert_imageset",
                        help='images + "path label" listfile -> Datum DB')
    ci.add_argument("root", help="root folder of image paths")
    ci.add_argument("listfile")
    ci.add_argument("db")
    ci.add_argument("--resize_height", type=int, default=0)
    ci.add_argument("--resize_width", type=int, default=0)
    ci.add_argument("--gray", action="store_true")
    ci.add_argument("--shuffle", action="store_true")
    ci.add_argument("--encoded", action="store_true")
    ci.add_argument("--backend", choices=["lmdb", "leveldb"],
                    default="lmdb")
    ci.set_defaults(fn=cmd_convert_imageset)
    for verb, binary in (("upgrade_net_proto_text", False),
                         ("upgrade_net_proto_binary", True)):
        u = sub.add_parser(verb,
                           help="V0/V1 NetParameter file -> latest format")
        u.add_argument("input")
        u.add_argument("output")
        u.set_defaults(fn=cmd_upgrade_net_proto, binary=binary)
    us = sub.add_parser("upgrade_solver_proto_text",
                        help="solver_type enum -> type string")
    us.add_argument("input")
    us.add_argument("output")
    us.set_defaults(fn=cmd_upgrade_solver_proto)
    ef = sub.add_parser("extract_features",
                        help="forward a net, write named blobs as "
                             "float-Datum DBs; positional order as the "
                             "reference binary's "
                             "(tools/extract_features.cpp): weights model "
                             "blobs dbs n [db_type]")
    ef.add_argument("weights",
                    help=".caffemodel[.h5]; `none` for random init")
    ef.add_argument("model", help="feature-extraction prototxt with a "
                                  "TEST data layer")
    ef.add_argument("blobs", help="blob_name1[,name2,...]")
    ef.add_argument("dbs", help="db_path1[,path2,...]")
    ef.add_argument("num_batches", type=int)
    ef.add_argument("db_type", nargs="?", default="lmdb")
    ef.add_argument("--device", default="cuda",
                    help="torch device to forward on (default cuda; the "
                         "CPU runs only when asked: --device cpu)")
    ef.set_defaults(fn=cmd_extract_features)
    i = sub.add_parser("imagenet", help="the ImageNetApp training loop")
    i.add_argument("--workers", type=int, default=None,
                   help="worker slots on the device (default 1)")
    i.add_argument("--strategy", choices=("local_sgd", "dp"),
                   default="local_sgd")
    i.add_argument("--tau", type=int, default=50)
    i.add_argument("--batch", type=int, default=256)
    i.add_argument("--classes", type=int, default=1000)
    i.add_argument("--rounds", type=int, default=2)
    i.add_argument("--test-every", type=int, default=10,
                   help="test every N rounds (0 never)")
    i.add_argument("--log")
    i.add_argument("--metrics", help="JSONL metrics output path")
    i.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; the "
                        "CPU runs only when asked: --device cpu)")
    i.set_defaults(fn=cmd_imagenet)
    sv = sub.add_parser(
        "serve",
        help="serve a resilient checkpoint over HTTP: weights-only "
             "load, continuous batching into power-of-two buckets, "
             "hot reload on new snapshots, graceful SIGTERM drain")
    sv.add_argument("--prefix", required=True,
                    help="snapshot prefix (reads <prefix>.latest.json)")
    sv.add_argument("--model",
                    help="deploy/net prototxt (optional: the binaryproto "
                         "model blob is self-describing)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port (announced on stdout)")
    sv.add_argument("--max_batch", type=int, default=8,
                    help="largest padding bucket; buckets are powers "
                         "of two up to this")
    sv.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="deadline: a batch closes once its oldest "
                         "request waited this long, even unfilled")
    sv.add_argument("--queue_limit", type=int, default=64,
                    help="queued-row bound; submissions beyond it get "
                         "429 (backpressure, not a latency tail)")
    sv.add_argument("--reload_poll", type=float, default=2.0,
                    help="seconds between manifest polls for hot "
                         "reload (0 disables)")
    sv.add_argument("--request_timeout", type=float, default=30.0,
                    help="per-request inference timeout (504 past it)")
    sv.add_argument("--no_warmup", action="store_true",
                    help="skip running every bucket before traffic")
    sv.add_argument("--metrics", help="JSONL metrics output path")
    sv.add_argument("--fleet_dir",
                    help="fleet rendezvous directory: lease this "
                         "replica into the serving fleet "
                         "(serve/fleet.py) for the route verb")
    sv.add_argument("--replica", type=int, default=0,
                    help="this replica's id in the fleet (also tags "
                         "the chaos injectors)")
    sv.add_argument("--replicas", type=int, default=0,
                    help="initial fleet size hint (a higher --replica "
                         "grows the world through admission)")
    sv.add_argument("--lease", type=float, default=3.0,
                    help="fleet lease_s: the router evicts this "
                         "replica when its beat goes stale past this")
    sv.add_argument("--heartbeat_interval", type=float, default=0.5,
                    help="fleet beat cadence (also bounds how stale "
                         "the router's queue-depth view can be)")
    sv.add_argument("--chaos",
                    help="chaos spec, e.g. 'kill_replica=0,kill_req=20'"
                         " (SIGKILL self after the 20th request) or "
                         "'slow_replica=0,slow_ms=50' "
                         "(resilience/chaos.py)")
    sv.add_argument("--trace_sample", type=float, default=1.0,
                    help="serve_trace head-sampling rate (1.0 = every "
                         "request emits a trace event)")
    sv.add_argument("--trace_tail_ms", type=float, default=250.0,
                    help="always keep serve_trace exemplars at/above "
                         "this latency, regardless of sampling")
    sv.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the "
                         "CPU runs only when asked: --device cpu)")
    _add_perf_flags(sv, scan=True)
    sv.set_defaults(fn=cmd_serve)
    _add_fleet_parsers(sub)
    lm = sub.add_parser("lm", help="train the transformer LM on the "
                                   "synthetic bigram corpus")
    lm.add_argument("--vocab", type=int, default=512)
    lm.add_argument("--seq-len", type=int, default=256)
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--d-model", type=int, default=256)
    lm.add_argument("--layers", type=int, default=4)
    lm.add_argument("--heads", type=int, default=8)
    lm.add_argument("--steps", type=int, default=500,
                    help="train until this iteration")
    lm.add_argument("--lr", type=float, default=3e-4)
    lm.add_argument("--solver-type", default="Adam")
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--display", type=int, default=50)
    lm.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="bf16: bf16 activations over f32 master params")
    lm.add_argument("--no-flash", action="store_true",
                    help="dense attention instead of the flash kernels")
    lm.add_argument("--moe-experts", type=int, default=0, metavar="X",
                    help="X>0: a Switch-MoE FFN of X experts in every "
                         "block (top-1, capacity factor 1.25)")
    lm.add_argument("--moe-aux-weight", type=float, default=0.01,
                    help="Switch load-balancing aux loss weight")
    lm.add_argument("--ep", type=int, default=1,
                    help="N>1: ExpertParallelSolver over an N-way "
                         "\"expert\" slot axis (needs --moe-experts)")
    lm.add_argument("--dp", type=int, default=1,
                    help="data-parallel slots (composed with --ep: mesh "
                         "{data: dp, expert: ep})")
    lm.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel slots: ring attention over "
                         "\"seq\" (composed with --dp, and with --ep: "
                         "dp x sp x ep)")
    lm.add_argument("--pipeline-stages", type=int, default=1,
                    help="N>1: run the trunk as an N-stage GPipe pipeline "
                         "over \"pipe\" slots (PipelineLMSolver)")
    lm.add_argument("--microbatches", type=int, default=0,
                    help="GPipe microbatches (default 2 x stages)")
    _add_perf_flags(lm, scan=True)
    _add_sharding_flags(lm)
    lm.add_argument("--metrics", help="JSONL loss-curve output path")
    lm.add_argument("--snapshot-every", type=int, default=0)
    lm.add_argument("--snapshot-prefix")
    lm.add_argument("--resume", help=".lm.npz (pipeline) or "
                                     ".solverstate to resume from")
    lm.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; the "
                         "CPU runs only when asked: --device cpu)")
    lm.set_defaults(fn=cmd_lm)
    ms = sub.add_parser("make_synth_cifar",
                        help="synthetic CIFAR-format dataset (zero-egress "
                             "stand-in for get_cifar10.sh)")
    ms.add_argument("output", help="dir for data_batch_*.bin/test_batch.bin")
    ms.add_argument("--train", type=int, default=50000)
    ms.add_argument("--test", type=int, default=10000)
    ms.add_argument("--seed", type=int, default=0)
    ms.add_argument("--noise", type=float, default=28.0)
    ms.add_argument("--label-noise", type=float, default=0.0,
                    help="fraction of labels resampled uniformly (hard "
                         "mode: caps accuracy at (1-p)+p/10)")
    ms.set_defaults(fn=cmd_make_synth_cifar)
    c = sub.add_parser("cifar", help="the CifarApp training loop")
    c.add_argument("--workers", type=int, default=None,
                   help="worker slots on the device (default 1)")
    c.add_argument("--data", help="dir with CIFAR-10 .bin batches")
    c.add_argument("--prototxt-dir", help="dir with stock cifar10 prototxts")
    c.add_argument("--strategy", choices=("local_sgd", "dp"),
                   default="local_sgd")
    c.add_argument("--tau", type=int, default=10)
    c.add_argument("--rounds", type=int, default=20)
    c.add_argument("--test-every", type=int, default=10,
                   help="test every N rounds (CifarApp.scala:98)")
    c.add_argument("--log")
    c.add_argument("--snapshot-prefix",
                   help="write periodic snapshots under this prefix "
                        "(enables --resume auto and the QuorumLost "
                        "best-effort snapshot)")
    c.add_argument("--snapshot-every", type=int, default=0,
                   help="snapshot every N rounds (0 disables)")
    c.add_argument("--resume", metavar="auto|STATE",
                   help="'auto': continue from the newest valid snapshot "
                        "under --snapshot-prefix; or an explicit "
                        ".solverstate path")
    c.add_argument("--metrics", help="JSONL metrics output path")
    _add_perf_flags(c)
    _add_feed_flags(c)
    _add_health_flags(c)
    _add_resilience_flags(c, hosts=True)
    c.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; the "
                        "CPU runs only when asked: --device cpu)")
    c.set_defaults(fn=cmd_cifar)
    rp = sub.add_parser("report",
                        help="aggregate a --metrics JSONL into a run "
                             "report (phases, step percentiles, comms, "
                             "health, loss curve)")
    rp.add_argument("jsonl", help="metrics JSONL written by --metrics")
    rp.add_argument("--json", help="also write the machine-readable "
                                   "report as JSON here")
    rp.add_argument("--chrome", help="also export the run's spans as a "
                                     "Chrome trace_event file")
    rp.add_argument("--since", type=float, default=None, metavar="T",
                    help="only events at or after T seconds into the run "
                         "(the JSONL 't' field); selecting no event is "
                         "an error (exit 2)")
    rp.add_argument("--event", metavar="KINDS",
                    help="comma-separated event kinds to keep (e.g. "
                         "'health,divergence'); selecting no event is an "
                         "error (exit 2)")
    rp.add_argument("--format", choices=("text", "json"), default="text",
                    help="text (default) or the report as one JSON "
                         "document on stdout")
    rp.set_defaults(fn=cmd_report)
    tr = sub.add_parser("trace",
                        help="merge metrics JSONLs into one clock-aligned "
                             "timeline: Chrome trace export and the "
                             "per-round critical path")
    tr.add_argument("metrics", nargs="+",
                    help="metrics JSONL files (one per host)")
    tr.add_argument("--chrome", metavar="OUT",
                    help="write one Chrome trace_event file")
    tr.add_argument("--critpath", action="store_true",
                    help="print the per-round critical path")
    tr.add_argument("--round", type=int, default=None, metavar="N",
                    help="limit --critpath to round N")
    tr.add_argument("--json", action="store_true",
                    help="JSON instead of text")
    tr.set_defaults(fn=cmd_trace)
    _add_lint_parser(sub)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)
