"""DB-backed Datum batch sources — the host side of the reference DataLayer
(the port of sparknet_tpu/data/db_source.py).

The reference's Data layer owns a DB cursor that walks records sequentially
and wraps at the end (data_layer.cpp:14-60, db_lmdb.cpp LMDBCursor), with
``rand_skip`` advancing the cursor once at startup and a DataTransformer
applying crop/mirror/scale/mean per record. Here a `DatumBatchSource`
yields feed dicts that the training loop (or a PrefetchIterator wrapping
it) hands to the solver. In device mode a SPARKNET_WIRE codec
(data/wire.py) may re-encode the shipped records. build_db_feed also
dispatches the ImageData, WindowData and HDF5Data layers to
data/file_sources.py. Record reads go through a jittered-backoff
RetryPolicy (resilience/retry.py; SPARKNET_IO_RETRIES attempts, 0
disables), and the process-wide chaos injector's ``io_p`` exercises it.
"""

import os

import numpy as np

from .datum import datum_to_array
from .lmdb import LMDBReader
from .transforms import DataTransformer

SOURCE_LAYERS = ("Data", "ImageData", "HDF5Data", "WindowData")


def open_db(source, backend="lmdb"):
    """DataParameter.DB -> reader (db.cpp:10-22 GetDB dispatch). Both
    backends read through pure-Python format implementations: LMDB B+tree
    pages (lmdb.py) and LevelDB SSTables+MANIFEST+WAL with snappy blocks
    (leveldb.py). backend=None sniffs the directory layout."""
    if isinstance(backend, int):
        backend = {0: "leveldb", 1: "lmdb"}[backend]
    if backend is None:
        backend = "leveldb" if os.path.exists(
            os.path.join(source, "CURRENT")) else "lmdb"
    backend = backend.lower()
    if backend == "lmdb":
        return LMDBReader(source)
    if backend == "leveldb":
        from .leveldb import LevelDBReader
        return LevelDBReader(source)
    raise ValueError(f"unknown DB backend {backend!r}")


class DatumBatchSource:
    """Infinite batched iterator over a Datum database.

    Yields {data_top: float32 (B,C,ch,cw), label_top: int32 (B,)} feed
    dicts; in device mode {data_top: the raw records (B,C,H,W),
    label_top, and the aux arrays of device_transform.aux_keys}, which
    ``device_fn`` turns into the former on the batch's device.
    Sequential wrap-around read order matches the reference cursor
    (data_layer.cpp:40-45: "restarting data prefetching from start").
    """

    def __init__(self, source, batch_size, phase=0, transform_param=None,
                 backend="lmdb", rand_skip=0, base_dir="", seed=None,
                 data_top="data", label_top="label", device_transform=False,
                 retry=None):
        self.source = source
        # transient-IO resilience: record reads go through a jittered
        # backoff RetryPolicy (SPARKNET_IO_RETRIES attempts by default, 0
        # disables) and the process-wide chaos injector exercises the path
        from ..resilience.chaos import active_chaos
        from ..resilience.retry import retry_from_env
        self._retry = retry if retry is not None else retry_from_env()
        self._chaos = active_chaos()
        self.batch_size = int(batch_size)
        self.data_top, self.label_top = data_top, label_top
        rng = np.random.RandomState(seed)
        self.transformer = DataTransformer(transform_param, phase=phase,
                                           base_dir=base_dir, rng=rng)
        # device mode: the DeviceTransformer shares self.transformer's
        # config AND rng, so both modes see the same augmentation stream
        self.device_mode = bool(device_transform)
        if self.device_mode:
            from .device_transform import DeviceTransformer
            self._devt = DeviceTransformer(self.transformer,
                                           data_top=data_top)
        self.db = open_db(source, backend)
        if len(self.db) == 0:
            raise ValueError(f"{source}: empty database")
        # rand_skip: advance the cursor once by rand() % rand_skip
        # (data_layer.cpp DataLayerSetUp)
        self._skip = int(rng.randint(0, rand_skip)) if rand_skip else 0
        first = next(self.db.items())[1]
        arr, _ = datum_to_array(first)
        self.record_shape = arr.shape if arr.ndim == 3 \
            else (1, 1, int(arr.size))
        self.shape = (self.batch_size,) + \
            self.transformer.output_shape(self.record_shape)
        # the compressed wire (device mode only): host-side precrop and/or
        # lossless bit-pack per SPARKNET_WIRE, decoded by device_fn; raw
        # mode is no codec, the feed byte for byte
        self._codec = None
        if self.device_mode:
            from .wire import WireCodec, wire_bits_from_env, \
                wire_mode_from_env
            mode = wire_mode_from_env()
            if mode != "raw":
                self._codec = WireCodec(
                    self._devt, self.record_shape, mode=mode,
                    bits=wire_bits_from_env(), sample=arr)

    @property
    def num_records(self):
        return len(self.db)

    def _records(self):
        """Sequential wrap-around record stream, from the rand_skip
        position on the first pass. A transient IO error mid-cursor
        restarts the DB iterator and fast-forwards to the record that
        failed, under the retry policy's backoff and budget — a flaky
        read costs a re-walk, not the run."""
        pos = self._skip
        self._skip = 0
        attempt = 0
        while True:
            try:
                seen = 0
                for _, value in self.db.items():
                    if seen < pos:
                        seen += 1
                        continue
                    if self._chaos is not None:
                        self._chaos.maybe_io_error(self.source)
                    arr = datum_to_array(value)
                    seen += 1
                    pos += 1
                    if pos >= len(self.db):
                        pos = 0     # wrap ("restarting data prefetching")
                    attempt = 0     # progress resets the per-read attempts
                    yield arr
                pos = 0             # clean end of pass
            except OSError as e:
                if self._retry is None:
                    raise
                attempt += 1
                self._retry.record_failure(e, attempt, where=self.source)

    def __iter__(self):
        rec = self._records()
        c, h, w = self.record_shape
        while True:
            arrs = []
            labels = np.empty(self.batch_size, np.int32)
            for i in range(self.batch_size):
                arr, labels[i] = next(rec)
                arrs.append(arr.reshape(c, h, w))
            batch = np.stack(arrs)  # uint8, or float32 for float_data nets
            if self.device_mode:
                out = {self.data_top: batch, self.label_top: labels,
                       **self._devt.aux(self.batch_size, self.record_shape)}
                yield self._codec.encode(out) if self._codec else out
            else:
                yield {self.data_top: self.transformer(batch),
                       self.label_top: labels}

    def fresh_aux(self):
        """New crop/mirror draws for one batch (data echoing: each echo
        of a shipped batch gets its own augmentation)."""
        return self._devt.aux(self.batch_size, self.record_shape)

    @property
    def wire(self):
        """The active WireCodec, or None (raw wire, or host mode)."""
        return self._codec

    @property
    def device_fn(self):
        """The transform on the batch's device (device mode only),
        decoding the wire first when a codec is active."""
        if self._codec is not None:
            return self._codec.device_fn()
        return self._devt.device_fn()

    @property
    def raw_feed_overrides(self):
        """check_batch shape overrides for the raw feed (device mode):
        the SHIPPED shapes when a codec is active."""
        if self._codec is not None:
            return self._codec.raw_overrides(self.batch_size)
        return self._devt.raw_overrides(self.batch_size, self.record_shape)

    def close(self):
        self.db.close()


def phase_data_layers(net_param, phase):
    """Data-source layers of `net_param` active in `phase` (after the same
    include/exclude filtering FilterNet applies, net.cpp:287)."""
    from ..graph.compiler import filter_net
    return [lp for lp in filter_net(net_param, phase).layer
            if lp.type in SOURCE_LAYERS]


def _resolve(path, base_dir):
    return os.path.join(base_dir, path) \
        if base_dir and not os.path.isabs(path) else path


def build_db_feed(net_param, phase, base_dir="", seed=None,
                  device_transform=False):
    """If the net's phase-filtered data layer points at an existing source
    (Data -> LMDB/LevelDB, ImageData -> listfile, WindowData -> window
    file, HDF5Data -> list of .h5 files), return (feed_shapes, source);
    else (None, None) — the caller falls back to synthetic feeds and says
    so. Only Data takes the device transform; the file sources yield
    host-transformed float32 batches, as in the JAX package."""
    from .file_sources import (HDF5DataSource, ImageDataSource,
                               WindowDataSource)
    for lp in phase_data_layers(net_param, phase):
        tops = list(lp.top)
        tp = lp.transform_param if lp.has("transform_param") else None
        label_top = tops[1] if len(tops) > 1 else "label"
        if lp.type == "Data" and lp.has("data_param"):
            dp = lp.data_param
            source = _resolve(dp.source, base_dir)
            backend = int(dp.backend) if dp.has("backend") else None
            if not _db_exists(source, backend):
                continue
            src = DatumBatchSource(
                source, int(dp.batch_size), phase=phase, transform_param=tp,
                backend=backend, rand_skip=int(dp.rand_skip),
                base_dir=base_dir, seed=seed, data_top=tops[0],
                label_top=label_top, device_transform=device_transform)
        elif lp.type == "ImageData" and lp.has("image_data_param"):
            ip = lp.image_data_param
            source = _resolve(ip.source, base_dir)
            if not os.path.exists(source):
                continue
            src = ImageDataSource(
                source, int(ip.batch_size), phase=phase, transform_param=tp,
                root_folder=_resolve(ip.root_folder, base_dir)
                if ip.root_folder else base_dir,
                new_height=int(ip.new_height), new_width=int(ip.new_width),
                is_color=bool(int(ip.is_color)),
                shuffle=bool(int(ip.shuffle)), rand_skip=int(ip.rand_skip),
                base_dir=base_dir, seed=seed, data_top=tops[0],
                label_top=label_top)
        elif lp.type == "WindowData" and lp.has("window_data_param"):
            wp = lp.window_data_param
            source = _resolve(wp.source, base_dir)
            if not os.path.exists(source):
                continue
            if wp.has("cache_images") and bool(int(wp.cache_images)):
                import warnings
                warnings.warn(
                    f"layer {lp.name!r}: cache_images is ignored — "
                    "WindowDataSource decodes per sampled window (the "
                    "deliberate no-cache choice, file_sources.py), so "
                    "expect per-window decode cost", stacklevel=2)
            src = WindowDataSource(
                source, int(wp.batch_size), phase=phase, transform_param=tp,
                fg_threshold=float(wp.fg_threshold),
                bg_threshold=float(wp.bg_threshold),
                fg_fraction=float(wp.fg_fraction),
                context_pad=int(wp.context_pad), crop_mode=wp.crop_mode,
                root_folder=_resolve(wp.root_folder, base_dir)
                if wp.root_folder else base_dir,
                base_dir=base_dir, seed=seed, data_top=tops[0],
                label_top=label_top)
        elif lp.type == "HDF5Data" and lp.has("hdf5_data_param"):
            hp = lp.hdf5_data_param
            source = _resolve(hp.source, base_dir)
            if not os.path.exists(source):
                continue
            src = HDF5DataSource(source, int(hp.batch_size), tops,
                                 shuffle=bool(int(hp.shuffle)), seed=seed)
            return dict(src.shape), src
        else:
            continue
        shapes = {tops[0]: src.shape}
        if len(tops) > 1:
            shapes[tops[1]] = (src.batch_size,)
        return shapes, src
    return None, None


def resolve_db_feed(net_param, phase, start_dir, seed=None,
                    device_transform=False):
    """build_db_feed with the CLI's walk-up source resolution: stock
    prototxt sources are caffe-root-relative, so try start_dir, then each
    parent, until a readable source appears. -> (shapes, src), or
    (None, None) when the net has no phase data layer or no source
    resolves at any level."""
    if not phase_data_layers(net_param, phase):
        return None, None
    d = os.path.abspath(start_dir or ".")
    while True:
        shapes, src = build_db_feed(net_param, phase, d, seed=seed,
                                    device_transform=device_transform)
        if src is not None:
            return shapes, src
        parent = os.path.dirname(d)
        if parent == d:
            return None, None
        d = parent


def _db_file(source):
    return os.path.join(source, "data.mdb") if not source.endswith(".mdb") \
        else source


def _db_exists(source, backend):
    """Does a readable DB of the declared (or sniffed) backend live here?"""
    if backend in (0, "leveldb"):
        return os.path.exists(os.path.join(source, "CURRENT"))
    if backend in (1, "lmdb"):
        return os.path.exists(_db_file(source))
    return os.path.exists(_db_file(source)) or \
        os.path.exists(os.path.join(source, "CURRENT"))
