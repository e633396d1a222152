"""DB-backed Datum batch sources — the host side of the reference DataLayer
(the port of sparknet_tpu/data/db_source.py).

The reference's Data layer owns a DB cursor that walks records sequentially
and wraps at the end (data_layer.cpp:14-60, db_lmdb.cpp LMDBCursor), with
``rand_skip`` advancing the cursor once at startup and a DataTransformer
applying crop/mirror/scale/mean per record. Here a `DatumBatchSource`
yields feed dicts that the training loop (or a PrefetchIterator wrapping
it) hands to the solver.

Not ported (ROADMAP A4, A6): the ImageData, WindowData and HDF5Data
sources (a net naming one that exists raises NotImplementedError), the
compressed wire formats (SPARKNET_WIRE other than ``raw`` raises), and
the retry and chaos hooks around record reads.
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


def _check_wire():
    mode = os.environ.get("SPARKNET_WIRE", "").strip().lower() or "raw"
    if mode != "raw":
        raise NotImplementedError(
            f"SPARKNET_WIRE={mode!r}: the port ships raw records only "
            "(the wire codecs are ROADMAP A4)")


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
                 data_top="data", label_top="label", device_transform=False):
        self.source = source
        self.batch_size = int(batch_size)
        self.data_top, self.label_top = data_top, label_top
        rng = np.random.RandomState(seed)
        self.transformer = DataTransformer(transform_param, phase=phase,
                                           base_dir=base_dir, rng=rng)
        # device mode: the DeviceTransformer shares self.transformer's
        # config AND rng, so both modes see the same augmentation stream
        self.device_mode = bool(device_transform)
        if self.device_mode:
            _check_wire()
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

    @property
    def num_records(self):
        return len(self.db)

    def _records(self):
        """Sequential wrap-around record stream, from the rand_skip
        position on the first pass."""
        pos = self._skip
        self._skip = 0
        while True:
            for i, (_, value) in enumerate(self.db.items()):
                if i >= pos:
                    yield datum_to_array(value)
            pos = 0             # "restarting data prefetching from start"

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
                yield {self.data_top: batch, self.label_top: labels,
                       **self._devt.aux(self.batch_size, self.record_shape)}
            else:
                yield {self.data_top: self.transformer(batch),
                       self.label_top: labels}

    @property
    def device_fn(self):
        """The transform on the batch's device (device mode only)."""
        return self._devt.device_fn()

    @property
    def raw_feed_overrides(self):
        """check_batch shape overrides for the raw feed (device mode)."""
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


_UNPORTED_SOURCES = {"ImageData": "image_data_param",
                     "WindowData": "window_data_param",
                     "HDF5Data": "hdf5_data_param"}


def build_db_feed(net_param, phase, base_dir="", seed=None,
                  device_transform=False):
    """If the net's phase-filtered Data layer points at an existing DB,
    return (feed_shapes, source); else (None, None) — the caller falls
    back to synthetic feeds and says so. An ImageData, WindowData or
    HDF5Data layer whose source exists raises NotImplementedError: the
    port does not read those formats yet, and feeding noise in their
    place would train on nothing."""
    for lp in phase_data_layers(net_param, phase):
        tops = list(lp.top)
        if lp.type in _UNPORTED_SOURCES:
            field = _UNPORTED_SOURCES[lp.type]
            if lp.has(field) and os.path.exists(
                    _resolve(getattr(lp, field).source, base_dir)):
                raise NotImplementedError(
                    f"layer {lp.name!r} ({lp.type}): its source "
                    f"{getattr(lp, field).source!r} exists, but the port "
                    f"reads only Data-layer LMDB/LevelDB sources "
                    f"(ROADMAP A4)")
            continue
        if not lp.has("data_param"):
            continue
        dp = lp.data_param
        source = _resolve(dp.source, base_dir)
        backend = int(dp.backend) if dp.has("backend") else None
        if not _db_exists(source, backend):
            continue
        src = DatumBatchSource(
            source, int(dp.batch_size), phase=phase,
            transform_param=lp.transform_param
            if lp.has("transform_param") else None,
            backend=backend, rand_skip=int(dp.rand_skip), base_dir=base_dir,
            seed=seed, data_top=tops[0],
            label_top=tops[1] if len(tops) > 1 else "label",
            device_transform=device_transform)
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
