"""ImageNet/CaffeNet training app — the reference ImageNetApp.scala (the
port of sparknet_tpu/apps/imagenet_app.py).

Reference behavior: AlexNet-class CaffeNet, batch 256, 256x256 source
images, random 227x227 crop + mirror + mean subtraction on TRAIN (center
crop on TEST), the mean image via ComputeMean, tau=50 local steps per
round. Data arrives as (image, label) record streams (reference: S3 tar
archives -> RDD; here: any iterator of (N,3,256,256) uint8 batches — see
data/imagenet.py for the tar reader).

The JAX app crops, mirrors and subtracts the mean on the host and ships
float32 crops (618 KB an image). This app draws the same crop offsets
and flips from the same RandomState in the same order, ships the round's
uint8 images with them (196 KB an image) and applies the transform on the
device, through the solver's input transform. The mean is the app's own:
the mean image's center window, subtracted after the mirror
(transforms.transform_train), not DataTransformer's source-indexed one.

With ``metrics_path`` one JSONL stream carries the solver's step,
comms, divergence and health events, the watchdog's and the app's own
"round" and "test" events.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.device_transform import aux_keys, transform_batch
from ..data.synthetic import class_gaussian_images
from ..data.transforms import _crop_mean, compute_mean, draw_crops
from ..models import zoo
from ..parallel import DataParallelSolver, LocalSGDSolver
from ..proto import Message

SOURCE_SIZE = 256
CROP = 227
BATCH = 256
KY, KX, KF = aux_keys("data")


class ImageNetApp:
    """num_workers = the number of worker slots (None means 1, the JAX
    package's count on one device). ``device`` defaults to the card; the
    CPU runs only when asked."""

    def __init__(self, num_workers=None, train_source=None, test_source=None,
                 num_classes=1000, strategy="local_sgd", tau=50, batch=BATCH,
                 log_path=None, seed=0, device="cuda", metrics_path=None):
        if strategy not in ("local_sgd", "dp"):
            raise ValueError(f"strategy must be local_sgd or dp, got "
                             f"{strategy!r}")
        self.t0 = time.time()
        self.logf = open(log_path, "w") if log_path else None
        from ..utils.metrics import MetricsLogger
        self.metrics = MetricsLogger(metrics_path) if metrics_path else None
        self.num_workers = int(num_workers or 1)
        self.strategy = strategy
        self.batch = batch
        self.num_classes = num_classes
        self.rng = np.random.RandomState(seed)

        if train_source is None:
            self.log("no ImageNet source; using synthetic class-gaussians")
            train_source = SyntheticSource(self.rng, num_classes)
            test_source = SyntheticSource(
                np.random.RandomState(seed + 1), num_classes)
        self.train_source = train_source
        self.test_source = test_source

        self.log("computing mean image (ComputeMean.scala equivalent)")
        probe = _take(self.train_source, 4)
        self.mean_image = compute_mean(
            (b[0] for b in probe), (3, SOURCE_SIZE, SOURCE_SIZE))
        self._mean = _crop_mean(self.mean_image, 3, CROP)
        self._means = {}

        scale = 1 if strategy == "local_sgd" else self.num_workers
        bs = batch * scale
        net = zoo.caffenet(batch_size=bs, num_classes=num_classes,
                           crop_size=CROP)
        solver_param = Message(
            "SolverParameter", base_lr=0.01, momentum=0.9,
            weight_decay=0.0005, lr_policy="step", gamma=0.1, stepsize=100000,
            display=0, random_seed=seed)
        if strategy == "local_sgd":
            self.solver = LocalSGDSolver(solver_param, metrics=self.metrics,
                                         workers=self.num_workers, tau=tau,
                                         net_param=net, log_fn=self.log,
                                         device=device)
        else:
            self.solver = DataParallelSolver(solver_param,
                                             metrics=self.metrics,
                                             workers=self.num_workers,
                                             net_param=net, log_fn=self.log,
                                             device=device)
        raw = {"data": (bs, 3, SOURCE_SIZE, SOURCE_SIZE), KY: (bs,),
               KX: (bs,), KF: (bs,)}
        self.solver.set_input_transform(self._device_fn, raw,
                                        test_fn=self._device_fn)
        self.log(f"initialized: {self.num_workers} workers, "
                 f"strategy={strategy}, batch={bs}, "
                 f"device={self.solver.device}")

    def log(self, msg):
        line = f"{time.time() - self.t0:9.2f}: {msg}"
        print(line)
        if self.logf:
            self.logf.write(line + "\n")
            self.logf.flush()

    # -- preprocessing (ImageNetApp.scala:155-169 / :117-131) --------------
    def _device_fn(self, batch):
        """Crop, mirror (TRAIN batches carry flips) and subtract the mean's
        center window, on the batch's device."""
        batch = dict(batch)
        x = batch.pop("data")
        if x.device not in self._means:      # one upload per device
            self._means[x.device] = torch.from_numpy(self._mean).to(x.device)
        batch["data"] = transform_batch(
            x, CROP, ys=batch.pop(KY), xs=batch.pop(KX),
            mirror=batch.pop(KF, None), mean=self._means[x.device])
        return batch

    def _collect(self, source, n):
        if isinstance(source, SyntheticSource):
            got = source.take(-(-n // source.batch))
        else:
            got, have = [], 0
            while have < n:
                got.append(next(source))
                have += len(got[-1][0])
        return (np.concatenate([b[0] for b in got])[:n],
                np.concatenate([b[1] for b in got])[:n])

    def _train_batch(self, n):
        """n source images and labels with their random crops and flips,
        drawn as transform_train draws them."""
        images, labels = self._collect(self.train_source, n)
        ys, xs, flips = draw_crops(self.rng, n, SOURCE_SIZE, SOURCE_SIZE,
                                   CROP, True)
        return {"data": images, "label": labels, KY: ys, KX: xs, KF: flips}

    def _round_stream(self):
        """Per-round batches, produced in the prefetch worker, overlapping
        the device round (base_data_layer.cpp:70-101 economics)."""
        W, B = self.num_workers, self.batch
        while True:
            if self.strategy == "local_sgd":
                tau = self.solver.tau
                raw = self._train_batch(tau * B * W)
                # worker w takes a contiguous run of tau batches; lay them
                # out as (tau, W*B) so the round slices per worker
                yield {k: v.reshape((W, tau, B) + v.shape[1:])
                       .swapaxes(0, 1).reshape((tau, W * B) + v.shape[1:])
                       for k, v in raw.items()}
            else:
                yield self._train_batch(B * W)

    def _test_batches(self):
        bs = self.batch * (1 if self.strategy == "local_sgd"
                           else self.num_workers)
        off = (SOURCE_SIZE - CROP) // 2
        while True:
            images, labels = self._collect(self.test_source, bs)
            yield {"data": images, "label": labels,
                   KY: np.full(bs, off, np.int32),
                   KX: np.full(bs, off, np.int32)}

    # -- the training loop (ImageNetApp.scala:100-182) ---------------------
    def run(self, num_rounds=10, test_every=10, test_iters=4,
            stall_seconds=1200.0):
        """Test every ``test_every`` rounds (``test_iters`` batches), then
        one round (local_sgd) or one step (dp), logging its loss and
        images/s. Returns the solver."""
        from ..data.prefetch import PrefetchIterator
        from ..utils.watchdog import Watchdog

        metrics = self.metrics
        steps = self.solver.tau if self.strategy == "local_sgd" else 1
        imgs_per_round = self.batch * self.num_workers * steps
        wd = Watchdog(stall_seconds=stall_seconds, metrics=metrics,
                      on_stall=lambda dt: self.log(
                          f"WATCHDOG: no round finished in {dt:.0f}s"),
                      on_nan=lambda v: self.log(f"WATCHDOG: loss = {v}"))
        batches = PrefetchIterator(self._round_stream(), depth=2,
                                   name="round_feed")
        try:
            with wd:
                for r in range(num_rounds):
                    if test_every and r % test_every == 0 and \
                            self.test_source:
                        scores = self.solver.test(self._test_batches(),
                                                  num_iters=test_iters)
                        for k, v in scores.items():
                            v = float(np.asarray(v).mean())
                            self.log(f"round {r}: test {k} = {v:.4f}")
                            if metrics:
                                metrics.log("test", round=r, metric=k,
                                            value=v)
                    rt0 = time.perf_counter()
                    if self.strategy == "local_sgd":
                        loss = self.solver.train_round(next(batches))
                    else:
                        loss = self.solver.train_step(next(batches))
                    loss = float(loss)
                    dt = time.perf_counter() - rt0
                    wd.beat(loss)
                    self.log(f"round {r}: loss = {loss:.4f}, "
                             f"{imgs_per_round / max(dt, 1e-9):.1f} "
                             f"images/s")
                    if metrics:
                        metrics.log("round", round=r, loss=loss,
                                    iter=self.solver.iter,
                                    images_per_s=round(
                                        imgs_per_round / max(dt, 1e-9), 1))
        finally:
            if not batches.close():
                self.log("prefetch worker did not stop within its timeout")
            self.solver.close()     # the step, comms and health summaries
            if metrics:
                metrics.close()
            if self.logf:
                self.logf.close()
                self.logf = None
        return self.solver


class SyntheticSource:
    """Endless (images uint8 (batch,3,256,256), labels) batches of
    class-gaussians, each from a seed drawn from ``rng`` (the JAX app's
    _synthetic_source). ``take(k)`` draws k seeds in order and makes
    their batches in threads: the batches, and what is left of ``rng``,
    are those of k calls of next(). A batch makes num_classes prototype
    images first (196,608 normals each at 1,000 classes), so one thread
    makes a few batches a second at most; numpy's generators release
    the interpreter lock while they fill."""

    def __init__(self, rng, num_classes, batch=64):
        self.rng = rng
        self.num_classes = num_classes
        self.batch = batch

    def _make(self, seed):
        images, labels = class_gaussian_images(
            self.batch, shape=(3, SOURCE_SIZE, SOURCE_SIZE),
            num_classes=self.num_classes, seed=seed)
        img8 = np.clip(np.asarray(images) * 32 + 128, 0, 255) \
            .astype(np.uint8)
        return img8, np.asarray(labels)

    def take(self, k):
        seeds = [int(self.rng.randint(1 << 31)) for _ in range(k)]
        with ThreadPoolExecutor(min(k, os.cpu_count() or 1)) as pool:
            return list(pool.map(self._make, seeds))

    def __iter__(self):
        return self

    def __next__(self):
        return self.take(1)[0]


def _take(source, k):
    """k batches of ``source``."""
    if isinstance(source, SyntheticSource):
        return source.take(k)
    return [next(source) for _ in range(k)]
