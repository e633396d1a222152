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
          synthetic batches of its feed shapes and says so. Its last line
          counts each CUDA kernel's launches in the run.
  test    score a model's TEST net over its data layer's source.
  time    per-layer forward and forward+backward times.
  device_query
          list the CUDA devices.
  serve   weights-only inference over a snapshot prefix — continuous
          batching into power-of-two buckets, hot reload on new
          snapshots, graceful SIGTERM/SIGINT drain (exit 0); exit 3 when
          the checkpoint has no servable model blob, before the socket
          opens.
  lm      train the transformer LM (models/zoo.py transformer_lm) on the
          synthetic bigram corpus with the single-device Solver: the
          corpus floor first, optional --metrics JSONL, snapshots and
          --resume, and as the last line each CUDA kernel's launches.
  cifar   the CifarApp loop: cifar10_full on CIFAR-10 binaries (or
          synthetic class-gaussians) under local SGD over --workers
          slots (--tau steps each, then the weights averaged) or per-step
          data parallelism (--strategy dp); tests every --test-every
          rounds, snapshots and --resume auto. The JAX verb's multi-host,
          chaos, metrics, health, elastic and heartbeat flags exit 2.
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

All run on the card (``--device cuda``, the default) unless
``--device cpu`` is given.
"""

import argparse
import json
import os
import signal
import sys
import threading

import numpy as np

EXIT_RECOVERY_ABORT = 3


def _mesh_arg(s):
    """"data=4" or "4" -> {"data": 4}. The port's one mesh axis is the
    data axis over worker slots; any other axis is a usage error."""
    if s.isdigit():
        return {"data": int(s)}
    out = {}
    for part in s.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k != "data":
            raise argparse.ArgumentTypeError(
                f"mesh axis {k!r}: not ported (the port's one axis is "
                "'data', over worker slots; model, sequence and pipeline "
                "axes are ROADMAP A5, host axes A6)")
        try:
            out[k] = int(v)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"mesh {s!r}: want data=W or W") from None
    return out


def _apply_feed_flags(args):
    """The feed flags write their SPARKNET_* env vars (the env stays the
    fallback when a flag is not given, as in the JAX package); returns
    the echo factor. Echo > 1 with a precrop wire exits: precropped
    bytes cannot take fresh crop draws."""
    for flag, env in (("wire", "SPARKNET_WIRE"),
                      ("wire_bits", "SPARKNET_WIRE_BITS"),
                      ("staging", "SPARKNET_STAGING"),
                      ("echo", "SPARKNET_ECHO")):
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
    from .ops import kernel_launches
    from .proto import text_format
    from .resilience import checkpoint
    from .solver import Solver
    from .solver.solver import resolve_nets, to_device
    echo = _apply_feed_flags(args)   # before any data source is built
    if echo > 1 and args.host_transform:
        raise SystemExit(
            "--echo > 1 needs the device-transform feed (drop "
            "--host-transform): echoes re-draw crop/mirror on the device")
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
    data_iter = None
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
                                           device=device)
            if isinstance(train_src, DeviceCachedSource):
                budget -= train_src.nbytes / (1 << 20)      # one budget
            test_src = maybe_device_cache(test_src, budget, iter_size=isz,
                                          device=device)
        feed = {**(train_shapes or {}), **_feed_shapes_arg(args.input_shape)}
        kw = dict(base_dir=base_dir, feed_shapes=feed or None,
                  test_feed_shapes=test_shapes, device=device)
        if args.strategy == "dp":
            from .parallel import DataParallelSolver
            workers = (args.mesh or {}).get("data", 1)
            solver = DataParallelSolver(sp, workers=workers, **kw)
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
        prefix = args.snapshot_prefix or (
            sp.snapshot_prefix if sp.has("snapshot_prefix") else None)
        if args.weights:
            solver.load_weights(args.weights)
        if args.snapshot:
            solver.restore(args.snapshot)
        if args.resume:
            if args.resume == "auto":
                if not prefix:
                    raise SystemExit("--resume auto needs a snapshot prefix "
                                     "(--snapshot-prefix or the solver's "
                                     "snapshot_prefix)")
                checkpoint.resume_auto(solver, prefix, log_fn=print)
            else:
                solver.restore(args.resume)
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
            put = None
            if int(sp.iter_size) <= 1:
                if os.environ.get("SPARKNET_STAGING", "on") != "off":
                    put = H2DStager(slots=2, device=solver.device)
                else:
                    put = lambda b: to_device(b, solver.device)  # noqa: E731
            data_iter = PrefetchIterator(iter(train_src), depth=3,
                                         transform=put, name="train_feed")
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
        while solver.iter < total:
            solver.step(min(100, total - solver.iter), data_iter,
                        test_data_fn=test_data_fn)
    finally:
        if train_src is not None:
            if data_iter is not None:
                data_iter.close()
            train_src.close()
        if test_src is not None:
            test_src.close()
    # a final snapshot unless the in-loop cadence already wrote this
    # iteration (Caffe solver.cpp Solve tail :300-306)
    cadence_fired = int(sp.snapshot) and sp.has("snapshot_prefix") \
        and solver.iter % int(sp.snapshot) == 0
    if prefix and sp.snapshot_after_train and not cadence_fired:
        solver.snapshot(prefix=prefix)
    print(f"Optimization done, iter={solver.iter}")
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    return 0


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
                      num_classes=args.classes, device=args.device)
    solver = app.run(num_rounds=args.rounds, test_every=args.test_every)
    print(f"done: {args.rounds} rounds, iter={solver.iter}")
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    return 0


def cmd_lm(args):
    """The JAX package's ``lm`` verb, single-device branch
    (sparknet_tpu/cli.py cmd_lm): Solver over zoo.transformer_lm on the
    bigram stream. ``--dtype bf16`` is mixed precision: f32 master
    params, bf16 activations cast at the embedding. ``--moe-experts X``
    swaps every block's FFN for a Switch-MoE of X experts whose
    load-balancing loss joins the objective at ``--moe-aux-weight``."""
    import time
    import torch
    from .data import lm_batch_stream
    from .models import zoo
    from .ops import kernel_launches
    from .proto import Message
    from .solver import Solver
    from .utils import MetricsLogger

    if args.snapshot_every and not args.snapshot_prefix:
        raise SystemExit("--snapshot-every needs --snapshot-prefix")
    sp = Message("SolverParameter", base_lr=args.lr, lr_policy="fixed",
                 display=args.display, type=args.solver_type,
                 random_seed=args.seed, snapshot=args.snapshot_every or 0)
    if args.snapshot_prefix:
        sp.snapshot_prefix = args.snapshot_prefix
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    compute_dtype = torch.bfloat16 if args.dtype == "bf16" else None
    stream, floor = lm_batch_stream(args.vocab, args.batch, args.seq_len,
                                    seed=args.seed)
    if metrics:
        metrics.log("config", loss_floor_nats=round(floor, 4),
                    d_model=args.d_model, layers=args.layers,
                    seq_len=args.seq_len, batch=args.batch,
                    dtype=args.dtype,
                    precision=os.environ.get("SPARKNET_PRECISION",
                                             "fp32") or "fp32",
                    device=args.device)
    print(f"bigram corpus floor: {floor:.4f} nats/token "
          f"(untrained: {np.log(args.vocab):.4f})")
    net = zoo.transformer_lm(vocab_size=args.vocab, seq_len=args.seq_len,
                             batch_size=args.batch, d_model=args.d_model,
                             num_layers=args.layers, num_heads=args.heads,
                             flash=not args.no_flash,
                             moe_experts=args.moe_experts,
                             moe_aux_weight=args.moe_aux_weight)
    solver = Solver(sp, net_param=net, device=args.device, metrics=metrics,
                    compute_dtype=compute_dtype)
    if args.resume:
        solver.restore(args.resume)
    start_iter = solver.iter
    t0 = time.time()
    solver.step(args.steps - solver.iter, stream)
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
    if metrics:
        metrics.log("summary", steps=executed,
                    tokens_per_sec=round(rate, 1),
                    final_loss=final, loss_floor_nats=round(floor, 4))
        metrics.close()
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    return 0


def cmd_cifar(args):
    from .apps import CifarApp
    from .ops import kernel_launches
    # the app feeds host-transformed CIFAR batches: as in the JAX
    # package, the wire and staging flags only set their env vars there
    echo = _apply_feed_flags(args)
    app = CifarApp(num_workers=args.workers, data_dir=args.data,
                   prototxt_dir=args.prototxt_dir, strategy=args.strategy,
                   tau=args.tau, log_path=args.log, device=args.device,
                   echo=echo)
    solver = app.run(num_rounds=args.rounds, test_every=args.test_every,
                     snapshot_prefix=args.snapshot_prefix,
                     snapshot_every=args.snapshot_every, resume=args.resume)
    print(f"done: {args.rounds} rounds, iter={solver.iter}")
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    return 0


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


class _NotPorted(argparse.Action):
    """A flag of the JAX package's verb that the port does not have yet:
    giving it is a usage error (exit 2) naming what is missing. Values
    in ``allow`` pass through (``--reshard strict``)."""

    def __init__(self, option_strings, dest, what="", allow=(), **kw):
        self.what, self.allow = what, allow
        super().__init__(option_strings, dest, **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        if values in self.allow:
            setattr(namespace, self.dest, values)
            return
        shown = f" {values}" if values else ""
        parser.error(f"{option_string}{shown}: not ported ({self.what})")


# flags of the JAX `train` and `cifar` verbs the port refuses: (flags,
# takes a value, what is missing and where the roadmap has it)
_RESILIENCE_NOT_PORTED = (
    (("--chaos",), True, "fault injection, ROADMAP A6"),
    (("--shard-ingest",), True, "per-host sharded ingest, ROADMAP A6"),
    (("--no-health", "--health-arm-recovery"), False,
     "the health monitor, ROADMAP A6"),
    (("--health-straggler-factor", "--health-loss-skew-factor",
      "--health-div-abs", "--health-trend-rounds", "--health-trend-factor",
      "--health-cooldown"), True, "the health monitor, ROADMAP A6"),
    (("--quorum", "--evict-after", "--readmit-after", "--staleness",
      "--s-decay", "--unpark-after", "--evict-stale-after"), True,
     "elastic membership and bounded staleness, ROADMAP A6"),
    (("--heartbeat-dir", "--lease-s", "--heartbeat-interval"), True,
     "the heartbeat and its relay, ROADMAP A6"),
    (("--grow",), False, "the heartbeat and its relay, ROADMAP A6"),
)
_CIFAR_NOT_PORTED = _RESILIENCE_NOT_PORTED + (
    (("--hosts",), True, "hierarchical host fault domains, ROADMAP A6"),
    (("--metrics",), True, "the app's JSONL metrics, ROADMAP A6"),
    (("--remat", "--precision", "--fsdp", "--tp"), True,
     "remat, precision and sharding levers, ROADMAP A5"),
)
_TRAIN_NOT_PORTED = _RESILIENCE_NOT_PORTED + (
    (("--metrics", "--profile"), True,
     "the metrics stream and the profiler trace, ROADMAP A6"),
    (("--stall-seconds",), True, "the train verb's watchdog, ROADMAP A6"),
    (("--sigint_effect", "--sighup_effect", "--sigterm_effect"), True,
     "signal policies (utils/signals.py), ROADMAP A6"),
    (("--recover", "--recover-lr-decay", "--recover-explode-factor"), True,
     "divergence recovery, ROADMAP A6"),
    (("--remat", "--precision"), True,
     "remat and precision levers, ROADMAP A5"),
)

# the JAX `lm` verb's mesh and perf flags: (flags, values that pass, what
# is missing and where the roadmap has it)
_LM_NOT_PORTED = (
    (("--ep", "--dp", "--sp", "--pipeline-stages", "--tp"), ("1",),
     "expert, data, sequence, pipeline and tensor parallelism over a "
     "mesh, ROADMAP A5"),
    (("--microbatches",), ("0",), "the GPipe pipeline, ROADMAP A5"),
    (("--fsdp",), ("off",), "FSDP sharding, ROADMAP A5"),
    (("--remat", "--precision", "--scan"), (),
     "remat, precision and scan levers, ROADMAP A5"),
)


def _add_not_ported(p, table):
    """Each flag of ``table`` on ``p`` as a usage error naming its
    ROADMAP item; --reshard and --keep take only what the port does
    (strict worlds; every snapshot kept)."""
    p.add_argument("--reshard", action=_NotPorted, default="strict",
                   allow=("strict",),
                   what="cross-world resharding, ROADMAP A6",
                   help="strict only: a snapshot of another world is "
                        "refused with WorldMismatch")
    for flags, value, what in table:
        for flag in flags:
            p.add_argument(flag, action=_NotPorted, what=what,
                           nargs=None if value else 0,
                           metavar="V" if value else None,
                           help=f"not ported: {what}")


def cmd_serve(args):
    from .serve import Batcher, ServeEngine, serve_http
    net_param = None
    if args.model:
        from .proto import text_format
        net_param = text_format.load(args.model, "NetParameter")
    engine = ServeEngine(args.prefix, net_param=net_param,
                         max_batch=args.max_batch, device=args.device)
    try:
        engine.load()
    except ValueError as e:
        print(f"sparknet_tpu_torch serve: error: {e}", file=sys.stderr)
        return EXIT_RECOVERY_ABORT
    if not args.no_warmup:
        engine.warmup()           # builds the kernels, runs every bucket
    batcher = Batcher(max_batch=args.max_batch,
                      max_wait_s=args.max_wait_ms / 1e3,
                      queue_limit=args.queue_limit)
    stop = threading.Event()
    # SIGTERM = the scheduler's preemption notice -> drain, exit 0
    previous = {s: signal.signal(s, lambda *_: stop.set())
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return serve_http(engine, batcher, host=args.host, port=args.port,
                          reload_poll_s=args.reload_poll, stop_event=stop,
                          request_timeout_s=args.request_timeout)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def main(argv=None):
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
                   help='"data=W" or "W": worker slots under --strategy '
                        "dp (default 1)")
    t.add_argument("--host-transform", action="store_true",
                   help="crop/mirror/mean on the host and ship float32 "
                        "crops, instead of the default: raw uint8 records "
                        "transformed on the device")
    _add_feed_flags(t)
    t.add_argument("--keep", action=_NotPorted, default="0", allow=("0",),
                   what="snapshot retention, ROADMAP A6",
                   help="0 only: every snapshot is kept")
    _add_not_ported(t, _TRAIN_NOT_PORTED)
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
    i.add_argument("--metrics", action=_NotPorted,
                   what="the app's JSONL metrics, ROADMAP A6",
                   help="not ported: the app's JSONL metrics, ROADMAP A6")
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
    sv.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the "
                         "CPU runs only when asked: --device cpu)")
    sv.set_defaults(fn=cmd_serve)
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
    for flags, allow, what in _LM_NOT_PORTED:
        for flag in flags:
            lm.add_argument(flag, action=_NotPorted, what=what,
                            allow=allow, metavar="V",
                            help=f"not ported: {what}")
    lm.add_argument("--metrics", help="JSONL loss-curve output path")
    lm.add_argument("--snapshot-every", type=int, default=0)
    lm.add_argument("--snapshot-prefix")
    lm.add_argument("--resume", help=".solverstate to resume from")
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
                        "(enables --resume auto)")
    c.add_argument("--snapshot-every", type=int, default=0,
                   help="snapshot every N rounds (0 disables)")
    c.add_argument("--resume", metavar="auto|STATE",
                   help="'auto': continue from the newest valid snapshot "
                        "under --snapshot-prefix; or an explicit "
                        ".solverstate path")
    _add_feed_flags(c)
    _add_not_ported(c, _CIFAR_NOT_PORTED)
    c.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; the "
                        "CPU runs only when asked: --device cpu)")
    c.set_defaults(fn=cmd_cifar)
    args = p.parse_args(argv)
    return args.fn(args)
