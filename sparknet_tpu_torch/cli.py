"""Command line of the PyTorch/CUDA port: ``python -m sparknet_tpu_torch``.

  train   train from a solver prototxt on one device: Caffe's solver
          schedule (display, test_interval, snapshot cadence), crash-safe
          snapshots, ``--weights`` finetuning, ``--snapshot`` /
          ``--resume auto|STATE`` restores. The port has no LMDB readers
          yet, so it feeds synthetic batches of the net's feed shapes.
          Its last line counts each CUDA kernel's launches in the run.
  serve   weights-only inference over a snapshot prefix — continuous
          batching into power-of-two buckets, hot reload on new
          snapshots, graceful SIGTERM/SIGINT drain (exit 0); exit 3 when
          the checkpoint has no servable model blob, before the socket
          opens.

Both run on the card (``--device cuda``, the default) unless
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
    from .ops import kernel_launches
    from .proto import text_format
    from .resilience import checkpoint
    from .solver import Solver
    sp = text_format.load(args.solver, "SolverParameter")
    base_dir = _net_base_dir(sp, args.solver)
    if sp.has("snapshot_prefix") and base_dir \
            and not os.path.isabs(sp.snapshot_prefix):
        # stock prefixes are caffe-root-relative: anchor them where the
        # net resolved, not the process CWD
        sp.snapshot_prefix = os.path.join(base_dir, sp.snapshot_prefix)
    solver = Solver(sp, base_dir=base_dir, device=args.device)
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
    print("WARNING: the port has no Data-layer LMDB reader yet; "
          "feeding synthetic noise (shapes only)")
    data_iter = make_data_iter(solver.net)
    test_fn = (lambda: make_data_iter(solver.test_net, seed=1)) \
        if solver.test_net is not None else None
    while solver.iter < total:
        solver.step(min(100, total - solver.iter), data_iter,
                    test_data_fn=test_fn)
    # a final snapshot unless the in-loop cadence already wrote this
    # iteration (Caffe solver.cpp Solve tail :300-306)
    cadence_fired = int(sp.snapshot) and sp.has("snapshot_prefix") \
        and solver.iter % int(sp.snapshot) == 0
    if prefix and sp.snapshot_after_train and not cadence_fired:
        solver.snapshot(prefix=prefix)
    print(f"Optimization done, iter={solver.iter}")
    print(f"Kernel launches: {json.dumps(kernel_launches())}")
    return 0


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
    t.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; the "
                        "CPU runs only when asked: --device cpu)")
    t.set_defaults(fn=cmd_train)
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
    args = p.parse_args(argv)
    return args.fn(args)
