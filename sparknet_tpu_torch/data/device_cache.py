"""The dataset resident on the card: SparkNet's RDD-in-cluster-memory model
(the port of sparknet_tpu/data/device_cache.py).

SparkNet's apps keep the whole training set in cluster memory: CifarApp
caches all records in an RDD and each worker samples minibatches from its
in-memory partition (CifarApp.scala:56-64). Here the dataset lives in the
card's memory: one bulk upload at startup, then each training step ships
only a (B, k) int32 control array (the cursor's record indices and the
host-drawn crop/mirror draws, a few KB), and the step gathers its batch
and applies the device transform (device_transform.py) on the card.

Cursor semantics match the streaming source (db_source.DatumBatchSource)
and the reference data layer: sequential order with wrap-around
(data_layer.cpp:40-45), rand_skip consumed at construction, TEST passes
from record 0 (a fresh ``iter()`` per test). The crop/mirror draws come
from the wrapped source's DeviceTransformer in the streaming order, so
the cached and streaming feeds give the same batches, bit for bit.
"""

import os

import numpy as np
import torch

from .datum import datum_to_array


def _chunk_bytes():
    """Upload chunk size: the one definition shared by the uploader and
    maybe_device_cache's headroom gate."""
    return int(float(os.environ.get("SPARKNET_CACHE_CHUNK_MB", "32"))
               * (1 << 20))


class DeviceCachedSource:
    """Wrap a device-mode DatumBatchSource: every record and label goes to
    ``device`` once, as one uint8 (or float32) tensor and one int32
    tensor; iteration then yields per-step control arrays.

    Feed protocol: ``{data_top}#ctl``, a (B, k) int32 array with columns
    [idx][, y, x][, flip] per the transform's config; device_fn() gathers
    the records and labels by index on the card and applies the device
    transform. The resident tensors never ride in a batch: device_fn
    holds them, so the control array is the only copy to the card a step,
    and the net's data and label blobs are not host-fed (their
    check_batch overrides are None).

    ``metrics`` gets ``device_cache`` hit/miss gauges, next to the
    prefetch queue's: one at promotion (``resident=True``), one every
    ``emit_every`` batches served and a last partial one at close.
    Every batch served from the resident tensors is a hit; misses happen
    only where promotion was refused (maybe_device_cache logs that
    refusal as an all-miss event)."""

    def __init__(self, dbsource, device, metrics=None, emit_every=100):
        if not dbsource.device_mode:
            raise ValueError("DeviceCachedSource needs a device-mode source")
        self.metrics = metrics
        self.emit_every = max(1, int(emit_every))
        self.hits = 0
        self.source = dbsource.source
        self.batch_size = dbsource.batch_size
        self.data_top = dbsource.data_top
        self.label_top = dbsource.label_top
        self.record_shape = tuple(dbsource.record_shape)
        self.shape = dbsource.shape
        self._devt = dbsource._devt
        self._ctl_key = f"{self.data_top}#ctl"
        device = torch.device(device)

        n = len(dbsource.db)
        labels = np.empty(n, np.int32)
        # one preallocated tensor filled chunk by chunk: the card holds the
        # dataset once, with no transient copy (the JAX package assembles
        # its chunks with a concatenate, whose 2x the promotion gate
        # budgets for; the gate stays the same here)
        images = chunk = None
        per = start = 0
        for i, (_, value) in enumerate(dbsource.db.items()):
            arr, labels[i] = datum_to_array(value)
            if images is None:
                rec_bytes = int(np.prod(self.record_shape)) * arr.itemsize + 4
                per = max(1, min(n, _chunk_bytes() // rec_bytes))
                chunk = np.empty((per,) + self.record_shape, arr.dtype)
                images = torch.empty((n,) + self.record_shape,
                                     dtype=torch.from_numpy(chunk).dtype,
                                     device=device)
            chunk[i - start] = arr.reshape(self.record_shape)
            if i - start + 1 == per or i + 1 == n:
                images[start:i + 1].copy_(torch.from_numpy(
                    chunk[:i + 1 - start]))
                start = i + 1
        self.num_records = n
        self._images = images
        self._labels = torch.from_numpy(labels).to(device)
        self._start = dbsource._skip % n
        dbsource.db.close()
        self._gauge(resident=True)

    def _gauge(self, **extra):
        if self.metrics is None:
            return
        self.metrics.log("device_cache", source=self.source,
                         records=self.num_records, nbytes=self.nbytes,
                         hits=self.hits, misses=0, hit_rate=1.0, **extra)

    @property
    def nbytes(self):
        """Bytes resident on the card (records and labels)."""
        if self._images is None:
            return 0
        return self._images.numel() * self._images.element_size() + \
            self._labels.numel() * self._labels.element_size()

    @property
    def device_mode(self):
        return True

    def _ctl_columns(self):
        t = self._devt.h
        return 1 + 2 * bool(t.crop_size) + bool(t.mirror)

    def __iter__(self):
        """Infinite control stream: the sequential cursor and the source
        rng's crop/mirror draws (the streaming device mode's rng, in its
        order)."""
        n, b = self.num_records, self.batch_size
        pos = self._start
        self._start = 0
        while True:
            idx = (pos + np.arange(b)) % n
            pos = (pos + b) % n
            cols = [idx.astype(np.int32)]
            aux = self._devt.aux(b, self.record_shape)
            ky, kx, kf = self._devt.ky, self._devt.kx, self._devt.kf
            if ky in aux:
                cols += [aux[ky], aux[kx]]
            if kf in aux:
                cols.append(aux[kf].astype(np.int32))
            self.hits += 1
            if self.hits % self.emit_every == 0:
                self._gauge()
            yield {self._ctl_key: np.stack(cols, axis=1)}

    @property
    def device_fn(self):
        """fn(batch)->batch for Solver.set_input_transform: unpack the
        control array (a tensor on the card), gather the resident records
        and labels by index and transform them, all on the card's stream
        with no host sync."""
        t = self._devt.h
        ctl_key, data_top, label_top = \
            self._ctl_key, self.data_top, self.label_top
        ky, kx, kf = self._devt.ky, self._devt.kx, self._devt.kf
        has_crop, has_flip = bool(t.crop_size), bool(t.mirror)
        inner_fn = self._devt.device_fn()

        def fn(batch):
            batch = dict(batch)
            ctl = batch.pop(ctl_key)
            idx = ctl[:, 0].long()
            feed = {data_top: self._images.index_select(0, idx),
                    label_top: self._labels.index_select(0, idx)}
            col = 1
            if has_crop:
                feed[ky], feed[kx] = ctl[:, col], ctl[:, col + 1]
                col += 2
            if has_flip:
                feed[kf] = ctl[:, col]
            out = inner_fn(feed)
            out.update(batch)      # extra host-fed blobs pass through
            return out

        return fn

    @property
    def raw_feed_overrides(self):
        """check_batch overrides: the control array; the net's data and
        label blobs are made on the card (None: not host-fed)."""
        return {self.data_top: None, self.label_top: None,
                self._ctl_key: (self.batch_size, self._ctl_columns())}

    def close(self):
        if self.hits % self.emit_every:
            self._gauge()              # the last partial window's gauge
        self._images = self._labels = None


def _log_miss_mode(metrics, src, reason, **extra):
    """Promotion refused: every batch will stream through the host — an
    all-miss ``device_cache`` gauge with the reason, so a report can tell
    "cache never engaged" from "no gauge at all"."""
    if metrics is None:
        return
    metrics.log("device_cache", source=getattr(src, "source", "?"),
                resident=False, reason=reason, hits=0,
                misses=getattr(src, "num_records", None), hit_rate=0.0,
                **extra)


def maybe_device_cache(src, budget_mb=2048, iter_size=1, device="cuda",
                       log_fn=print, metrics=None):
    """Promote a device-mode DatumBatchSource to a DeviceCachedSource when
    the whole dataset fits the budget; otherwise return it unchanged (the
    streaming device-transform feed), after ``log_fn`` says why on one
    line and, for a device-mode Datum source, ``metrics`` gets the
    refusal's all-miss ``device_cache`` event (the JAX package's).

    The gate is the JAX package's: the dataset is sized from its first
    record's actual dtype (float_data Datums decode to float32, 4x the
    uint8 estimate); a dataset larger than one upload chunk must fit
    twice; iter_size > 1 is refused (Solver.step stacks micro-batch dicts
    on the host)."""
    if src is None:
        return src
    log = log_fn or (lambda *a: None)
    if not getattr(src, "device_mode", False) or not hasattr(src, "db"):
        log(f"device cache: {src.source} streams ({type(src).__name__} "
            "is not a device-mode Datum DB source)")
        return src
    if int(iter_size) > 1:
        log(f"device cache: {src.source} streams (iter_size "
            f"{int(iter_size)} > 1 stacks micro-batches on the host)")
        _log_miss_mode(metrics, src, "iter_size")
        return src
    arr, _ = datum_to_array(next(src.db.items())[1])
    est = len(src.db) * (arr.size * arr.itemsize + 4)
    needed = est * 2 if est > _chunk_bytes() else est
    if needed > budget_mb * (1 << 20):
        log(f"device cache: {src.source} streams ({needed / 2 ** 20:.1f} "
            f"MiB needed for {est / 2 ** 20:.1f} MiB of records, over the "
            f"{budget_mb:g} MiB budget SPARKNET_DEVICE_CACHE_MB leaves)")
        _log_miss_mode(metrics, src, "over_budget", est_bytes=est,
                       budget_mb=budget_mb)
        return src
    return DeviceCachedSource(src, device, metrics=metrics)
