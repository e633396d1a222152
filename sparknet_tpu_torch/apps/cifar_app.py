"""CIFAR-10 training app: the reference CifarApp.scala over the port's
worker slots (the port of sparknet_tpu/apps/cifar_app.py).

The reference app (CifarApp.scala:33-135): load CIFAR from binary
batches, build cifar10_full with JavaData layers, then loop {broadcast
weights -> each of N workers runs tau=10 local SGD steps on its
partition -> collect & average}, testing every 10 rounds. Here the loop
body is LocalSGDSolver.train_round over N slots on one device, or, with
strategy="dp", DataParallelSolver.train_step (per-step gradient
averaging).

Timing log: elapsed-seconds-prefixed phases, like the reference's
training_log_<ts>.txt (CifarApp.scala:43-52).

Not ported (ROADMAP A6): hierarchical host fault domains (``hosts``),
chaos injection, per-host sharded ingest and elastic membership; the
app's JSONL metrics stream.
"""

import os
import time

import numpy as np

from ..data.cifar import CifarDataset
from ..data.synthetic import class_gaussian_images
from ..models import zoo
from ..models.proto_loader import (load_net_prototxt,
                                   load_solver_prototxt_with_net,
                                   replace_data_layers)
from ..parallel import DataParallelSolver, LocalSGDSolver
from ..proto import Message

TRAIN_BATCH = 100   # cifar10_full_train_test.prototxt batch sizes
TEST_BATCH = 100


class CifarApp:
    """num_workers = the number of worker slots (the reference's Spark
    executor count, CifarApp.scala:34; the JAX package's "data" mesh
    axis). None means 1, the JAX package's count on one device.
    ``device`` defaults to the card; the CPU runs only when asked."""

    def __init__(self, num_workers=None, data_dir=None, prototxt_dir=None,
                 strategy="local_sgd", tau=10, log_path=None, seed=None,
                 hosts=0, device="cuda", echo=1):
        if hosts:
            raise ValueError(
                "hosts (hierarchical local SGD over host fault domains) is "
                "not ported (ROADMAP A6)")
        if strategy not in ("local_sgd", "dp"):
            raise ValueError(f"strategy must be local_sgd or dp, got "
                             f"{strategy!r}")
        self.t0 = time.time()
        self.logf = open(log_path, "w") if log_path else None
        self.rng = np.random.RandomState(seed)
        self._train_f32 = None
        self.num_workers = int(num_workers or 1)
        self.strategy = strategy
        self.echo = max(1, int(echo))

        # data: real CIFAR binaries if present, synthetic stand-in otherwise
        if data_dir and os.path.isdir(data_dir):
            self.log(f"loading CIFAR-10 from {data_dir}")
            self.data = CifarDataset(data_dir, seed=seed)
        else:
            self.log("no CIFAR data dir; using synthetic class-gaussians")
            self.data = _SyntheticCifar(seed=seed or 0)

        # net: stock prototxt (with data layers swapped like
        # ProtoLoader.replaceDataLayers) or the built-in zoo twin
        scale = 1 if strategy == "local_sgd" else self.num_workers
        per_worker = TRAIN_BATCH * scale
        if prototxt_dir:
            net = load_net_prototxt(os.path.join(
                prototxt_dir, "cifar10_full_train_test.prototxt"))
            net = replace_data_layers(net, per_worker, TEST_BATCH * scale,
                                      3, 32, 32)
            solver_param = load_solver_prototxt_with_net(
                os.path.join(prototxt_dir, "cifar10_full_solver.prototxt"),
                net)
        else:
            net = zoo.cifar10_full(batch_size=per_worker)
            solver_param = Message(
                "SolverParameter", base_lr=0.001, momentum=0.9,
                weight_decay=0.004, lr_policy="fixed", display=0,
                random_seed=seed if seed is not None else -1)

        if strategy == "local_sgd":
            self.solver = LocalSGDSolver(solver_param,
                                         workers=self.num_workers, tau=tau,
                                         net_param=net, log_fn=self.log,
                                         device=device)
        else:
            self.solver = DataParallelSolver(solver_param,
                                             workers=self.num_workers,
                                             net_param=net, log_fn=self.log,
                                             device=device)
        self.log(f"initialized: {self.num_workers} workers, "
                 f"strategy={strategy}, device={self.solver.device}")

    def log(self, msg):
        line = f"{time.time() - self.t0:9.2f}: {msg}"
        print(line)
        if self.logf:
            self.logf.write(line + "\n")
            self.logf.flush()

    # -- data feeds ---------------------------------------------------------
    def _train_arrays(self, n_images):
        if self._train_f32 is None:     # mean-subtract once, not per round
            self._train_f32 = self.data.train_images.astype(np.float32) \
                - self.data.mean_image
        imgs, labs = self._train_f32, self.data.train_labels
        n = len(imgs)
        # random contiguous window (MinibatchSampler.scala:20-21), modular
        # so a request larger than the dataset wraps instead of raising
        # (e.g. local_sgd tau*batch*workers on a small set)
        start = self.rng.randint(0, n)
        idx = (start + np.arange(n_images)) % n
        return imgs[idx], labs[idx]

    def _tau_batches(self, tau):
        """(tau, workers*batch, ...) arrays: each worker's contiguous
        window of its partition (the MinibatchSampler random-window
        behavior)."""
        n_slots = self.num_workers
        imgs, labs = self._train_arrays(tau * TRAIN_BATCH * n_slots)
        imgs = imgs.reshape(n_slots, tau, TRAIN_BATCH, 3, 32, 32)
        labs = labs.reshape(n_slots, tau, TRAIN_BATCH)
        # worker w gets a contiguous run of tau batches from its partition;
        # reorder to (tau, workers*batch) so the round slices per worker
        imgs = imgs.transpose(1, 0, 2, 3, 4, 5) \
            .reshape(tau, n_slots * TRAIN_BATCH, 3, 32, 32)
        labs = labs.transpose(1, 0, 2).reshape(tau, -1)
        return {"data": imgs, "label": labs}

    def _test_batch_size(self):
        # the TEST net's feed batch (global across the slots for dp)
        return self.solver.test_net.feed_shapes()["data"][0] \
            if self.strategy == "local_sgd" \
            else self.solver.net.feed_shapes()["data"][0]

    def run_test(self, max_iters=100):
        """Full test pass -> {score_name: float mean} (CifarApp.scala:98)."""
        n = min(len(self.data.test_images) // self._test_batch_size(),
                max_iters)
        scores = self.solver.test(self._test_iter(), num_iters=n)
        return {k: float(np.asarray(v).mean()) for k, v in scores.items()}

    def _test_iter(self):
        imgs = self.data.test_images.astype(np.float32) - self.data.mean_image
        labs = self.data.test_labels
        bs = self._test_batch_size()
        for i in range(0, len(imgs) // bs * bs, bs):
            yield {"data": imgs[i:i + bs], "label": labs[i:i + bs]}

    def _round_stream(self):
        """Infinite per-round batch generator — runs in the prefetch worker
        so host-side window sampling overlaps the device round (the
        base_data_layer.cpp:70-101 double-buffering, loader-push style)."""
        while True:
            if self.strategy == "local_sgd":
                yield self._tau_batches(self.solver.tau)
            else:
                imgs, labs = self._train_arrays(
                    TRAIN_BATCH * self.num_workers)
                yield {"data": imgs, "label": labs}

    # -- the training loop (CifarApp.scala:92-135) -------------------------
    def run(self, num_rounds=100, test_every=10, stall_seconds=600.0,
            snapshot_prefix=None, snapshot_every=0, resume=None):
        """Test every ``test_every`` rounds, then one round (local_sgd)
        or one step (dp); ``snapshot_every`` N snapshots under
        ``snapshot_prefix`` every N rounds, and resume="auto" first
        restores the newest valid snapshot under it (a path restores
        that snapshot). Returns the solver."""
        from ..data.prefetch import EchoIterator, PrefetchIterator
        from ..resilience import checkpoint
        from ..utils.watchdog import Watchdog

        if resume == "auto":
            if snapshot_prefix:
                checkpoint.resume_auto(self.solver, snapshot_prefix,
                                       log_fn=self.log)
            else:
                self.log("resume auto: no snapshot prefix; starting fresh")
        elif resume:
            self.solver.restore(resume)

        wd = Watchdog(stall_seconds=stall_seconds,
                      on_stall=lambda dt: self.log(
                          f"WATCHDOG: no round finished in {dt:.0f}s"),
                      on_nan=lambda v: self.log(f"WATCHDOG: loss = {v}"))
        batches = PrefetchIterator(self._round_stream(), depth=2,
                                   name="round_feed")
        if self.echo > 1:
            batches = EchoIterator(batches, self.echo)
        try:
            with wd:
                for r in range(num_rounds):
                    if r % test_every == 0:
                        self.log("testing")
                        for k, v in self.run_test().items():
                            self.log(f"round {r}: test {k} = {v:.4f}")

                    self.log("broadcasting weights & running workers")
                    if self.strategy == "local_sgd":
                        loss = self.solver.train_round(next(batches))
                    else:
                        loss = self.solver.train_step(next(batches))
                    loss = float(loss)
                    wd.beat(loss)
                    self.log(f"round {r}: loss = {loss:.4f}")
                    if snapshot_prefix and snapshot_every and \
                            (r + 1) % snapshot_every == 0:
                        self.solver.snapshot(prefix=snapshot_prefix)
        finally:
            if not batches.close():
                self.log("prefetch worker did not stop within its timeout")
            if self.logf:
                self.logf.close()
                self.logf = None
        return self.solver


class _SyntheticCifar:
    """CifarDataset-shaped stand-in when no binary data is available."""

    def __init__(self, n_train=2000, n_test=500, seed=0):
        ti, tl = class_gaussian_images(n_train, shape=(3, 32, 32),
                                       num_classes=10, seed=seed)
        vi, vl = class_gaussian_images(n_test, shape=(3, 32, 32),
                                       num_classes=10, seed=seed + 1)
        self.train_images = np.asarray(ti)
        self.train_labels = np.asarray(tl)
        self.test_images = np.asarray(vi)
        self.test_labels = np.asarray(vl)
        self.mean_image = self.train_images.astype(np.float64).mean(0) \
            .astype(np.float32)
