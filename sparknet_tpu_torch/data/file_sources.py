"""File-backed batch sources: ImageData, HDF5Data, MemoryData, WindowData
(the port of sparknet_tpu/data/file_sources.py).

Host-side equivalents of the reference's non-DB data layers — each yields
ready feed dicts, like DatumBatchSource in host mode, for the training
loop (or a PrefetchIterator) to hand to the solver:

  ImageDataSource   image_data_layer.cpp: listfile of "path label" lines,
                    optional resize/gray, shuffle-on-epoch, transform_param
  HDF5DataSource    hdf5_data_layer.cpp: source file listing .h5 files whose
                    datasets are keyed by top name; row shuffle per file
  MemoryDataSource  memory_data_layer.cpp: in-memory arrays via Reset()
  WindowDataSource  window_data_layer.cpp: R-CNN window files

The graph-side shape stubs live in ops/feed.py; build_db_feed
(db_source.py) dispatches a net's data layers to these classes. PIL and
h5py are imported only where an image or an .h5 file is read. Image
decodes and .h5 loads retry with backoff (resilience/retry.py), and the
process-wide chaos injector's ``io_p`` exercises the image path.
"""

import os

import numpy as np

from .transforms import DataTransformer


def _decode_chw_bgr(Image, path, color=True, resize=None):
    """Decode to CHW uint8, BGR channel order (the reference's OpenCV
    convention, so stock mean files line up); gray -> (1, H, W)."""
    img = Image.open(path)
    img = img.convert("RGB" if color else "L")
    if resize:
        img = img.resize(resize, Image.BILINEAR)
    a = np.asarray(img, np.uint8)
    if a.ndim == 2:
        return a[None]
    return np.ascontiguousarray(a[:, :, ::-1].transpose(2, 0, 1))


class ImageDataSource:
    """Infinite batched iterator over a listfile of images.

    Matches reference ImageDataLayer: lines are "relative/path label";
    new_height/new_width force-resize; is_color selects RGB vs gray;
    shuffle reshuffles the line order on every epoch wrap (ShuffleImages);
    rand_skip advances once at startup; transform_param applies
    crop/mirror/scale/mean per batch. Images are decoded to CHW BGR uint8,
    the reference's OpenCV convention, so stock mean files line up.
    """

    def __init__(self, source, batch_size, phase=0, transform_param=None,
                 root_folder="", new_height=0, new_width=0, is_color=True,
                 shuffle=False, rand_skip=0, base_dir="", seed=None,
                 data_top="data", label_top="label"):
        from PIL import Image       # decode dependency kept out of import
        self._Image = Image
        self.source = source
        self.batch_size = int(batch_size)
        self.root = root_folder
        self.new_height, self.new_width = int(new_height), int(new_width)
        if (self.new_height > 0) != (self.new_width > 0):
            raise ValueError("new_height and new_width must be set together "
                             "(image_data_layer.cpp CHECK)")
        self.is_color = bool(is_color)
        self.shuffle = bool(shuffle)
        self.data_top, self.label_top = data_top, label_top
        # transient-IO resilience: image decodes retry with backoff (a
        # flaky NFS read costs a sleep, not the round); chaos injects
        from ..resilience.chaos import active_chaos
        from ..resilience.retry import retry_from_env
        self._retry = retry_from_env()
        self._chaos = active_chaos()
        self.rng = np.random.RandomState(seed)
        self.transformer = DataTransformer(transform_param, phase=phase,
                                           base_dir=base_dir, rng=self.rng)
        self.lines = []
        with open(source) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                path, _, label = line.rpartition(" ")
                self.lines.append((path, int(label)))
        if not self.lines:
            raise ValueError(f"{source}: empty image list")
        if self.shuffle:
            self.rng.shuffle(self.lines)
        self._skip = int(self.rng.randint(0, rand_skip)) if rand_skip else 0
        first = self._read(self.lines[0][0])
        self.record_shape = first.shape
        self.shape = (self.batch_size,) + \
            self.transformer.output_shape(self.record_shape)

    @property
    def num_records(self):
        return len(self.lines)


    def _read(self, rel):
        return _decode_chw_bgr(
            self._Image, os.path.join(self.root, rel), color=self.is_color,
            resize=(self.new_width, self.new_height)
            if self.new_height and self.new_width else None)

    def _read_resilient(self, rel):
        def read():
            if self._chaos is not None:
                self._chaos.maybe_io_error(rel)
            return self._read(rel)
        if self._retry is None:
            return read()
        return self._retry.call(read, where=rel)

    def _records(self):
        skip = self._skip
        self._skip = 0
        while True:
            for rel, label in self.lines:
                if skip:
                    skip -= 1
                    continue
                yield self._read_resilient(rel), label
            if self.shuffle:                    # reshuffle on wrap
                self.rng.shuffle(self.lines)

    def __iter__(self):
        rec = self._records()
        while True:
            arrs = []
            labels = np.empty(self.batch_size, np.int32)
            for i in range(self.batch_size):
                a, labels[i] = next(rec)
                if a.shape != self.record_shape:
                    raise ValueError(
                        f"image shape {a.shape} != first image "
                        f"{self.record_shape}; set new_height/new_width to "
                        "force a common size")
                arrs.append(a)
            yield {self.data_top: self.transformer(np.stack(arrs)),
                   self.label_top: labels}

    def close(self):
        pass


class HDF5DataSource:
    """Infinite batched iterator over HDF5 files listed in ``source``.

    Matches reference HDF5DataLayer: every top name is a dataset in each
    file; batches are sliced along axis 0; ``shuffle`` permutes the file
    order and the rows within each file per epoch. No transform_param (the
    reference layer has none). Labels come through as-is (float or int).
    """

    def __init__(self, source, batch_size, tops, shuffle=False, seed=None):
        import h5py
        self._h5py = h5py
        self.source = source
        self.batch_size = int(batch_size)
        self.tops = list(tops)
        self.shuffle = bool(shuffle)
        self.rng = np.random.RandomState(seed)
        with open(source) as f:
            self.files = [ln.strip() for ln in f if ln.strip()]
        if not self.files:
            raise ValueError(f"{source}: lists no HDF5 files")
        base = os.path.dirname(os.path.abspath(source))
        self.files = [p if os.path.isabs(p) else os.path.join(base, p)
                      for p in self.files]
        self.shapes = {}
        self._count = 0
        for p in self.files:
            with h5py.File(p, "r") as f:
                n = None
                for t in self.tops:
                    if t not in f:
                        raise KeyError(f"{p}: no dataset {t!r}")
                    if n is None:
                        n = f[t].shape[0]
                        self._count += n
                    elif f[t].shape[0] != n:
                        raise ValueError(f"{p}: dataset {t!r} rows "
                                         f"{f[t].shape[0]} != {n}")
                    self.shapes.setdefault(t, tuple(f[t].shape[1:]))
        self.shape = {t: (self.batch_size,) + s
                      for t, s in self.shapes.items()}

    @property
    def num_records(self):
        return self._count


    def _load(self, p):
        with self._h5py.File(p, "r") as f:
            return {t: np.asarray(f[t]) for t in self.tops}

    def _rows(self):
        from ..resilience.retry import retry_from_env
        retry = retry_from_env()
        files = list(self.files)
        while True:
            if self.shuffle:
                self.rng.shuffle(files)
            for p in files:
                data = self._load(p) if retry is None \
                    else retry.call(self._load, p, where=p)
                n = len(data[self.tops[0]])
                order = self.rng.permutation(n) if self.shuffle \
                    else np.arange(n)
                for i in order:
                    yield {t: data[t][i] for t in self.tops}

    def __iter__(self):
        rows = self._rows()
        while True:
            batch = [next(rows) for _ in range(self.batch_size)]
            yield {t: np.stack([b[t] for b in batch]) for t in self.tops}

    def close(self):
        pass


class MemoryDataSource:
    """In-memory array feed (reference MemoryDataLayer::Reset). Batches
    cycle over the arrays; Reset() swaps them (sizes must stay divisible
    by batch_size, like the reference CHECK)."""

    def __init__(self, batch_size, data=None, labels=None,
                 data_top="data", label_top="label"):
        self.batch_size = int(batch_size)
        self.data_top, self.label_top = data_top, label_top
        self._pos = 0
        self.data = self.labels = None
        if data is not None:
            self.reset(data, labels)

    def reset(self, data, labels):
        data = np.asarray(data)
        labels = np.asarray(labels)
        if len(data) != len(labels):
            raise ValueError(f"data rows {len(data)} != labels {len(labels)}")
        if len(data) % self.batch_size:
            raise ValueError(
                f"size {len(data)} not divisible by batch {self.batch_size} "
                "(memory_data_layer.cpp CHECK on AddMatVector/Reset)")
        self.data, self.labels = data, labels
        self._pos = 0

    @property
    def num_records(self):
        return 0 if self.data is None else len(self.data)

    def __iter__(self):
        if self.data is None:
            raise RuntimeError("MemoryDataSource: call reset(data, labels) "
                               "before iterating")
        while True:
            i = self._pos
            self._pos = (self._pos + self.batch_size) % len(self.data)
            yield {self.data_top:
                   self.data[i:i + self.batch_size].astype(np.float32),
                   self.label_top:
                   self.labels[i:i + self.batch_size].astype(np.int32)}

    def close(self):
        pass


class WindowDataSource:
    """R-CNN window-file feed (reference window_data_layer.cpp).

    Window file format (window_data_layer.cpp:40-47)::

        # image_index
        img_path
        channels height width
        num_windows
        class_index overlap x1 y1 x2 y2     (num_windows lines)

    Windows with overlap >= fg_threshold are foreground (label must be
    > 0); overlap < bg_threshold are background with label forced to 0
    (:129-141). Each batch draws batch*(1-fg_fraction) background then
    batch*fg_fraction foreground windows uniformly at random (:260-267),
    crops each (optionally context-padded / squared, :306-330), warps to
    crop_size x crop_size with out-of-image extent zero-padded
    (:330-385), mirrors at random, and applies mean/scale from
    transform_param (after upgrade_data_transform the deprecated
    window_data_param fields land there). Images decode to CHW BGR like
    ImageDataSource, so stock mean files line up.
    """

    def __init__(self, source, batch_size, phase=0, transform_param=None,
                 fg_threshold=0.5, bg_threshold=0.5, fg_fraction=0.25,
                 context_pad=0, crop_mode="warp", root_folder="",
                 base_dir="", seed=None, data_top="data",
                 label_top="label"):
        from PIL import Image
        self._Image = Image
        self.source = source
        self.batch_size = int(batch_size)
        self.fg_fraction = float(fg_fraction)
        self.context_pad = int(context_pad)
        self.use_square = crop_mode == "square"
        self.root = root_folder
        self.rng = np.random.RandomState(seed)
        self.data_top, self.label_top = data_top, label_top
        self.transformer = DataTransformer(transform_param, phase=phase,
                                           base_dir=base_dir, rng=self.rng)
        self.crop = self.transformer.crop_size
        if not self.crop:
            raise ValueError(f"{source}: WindowData requires crop_size > 0 "
                             "(window_data_layer.cpp CHECK_GT)")

        self.images = []          # (abs_path, channels)
        self.fg, self.bg = [], []  # (image_idx, label, x1, y1, x2, y2)
        with open(source) as f:
            toks = f.read().split()
        i = 0
        while i < len(toks):
            if toks[i] != "#":
                raise ValueError(f"{source}: expected '#', got {toks[i]!r}")
            path = toks[i + 2]
            if self.root and not os.path.isabs(path):
                path = os.path.join(self.root, path)
            channels = int(toks[i + 3])
            nwin = int(toks[i + 6])
            img_idx = len(self.images)
            self.images.append((path, channels))
            i += 7
            for _ in range(nwin):
                label, overlap = int(toks[i]), float(toks[i + 1])
                box = tuple(int(v) for v in toks[i + 2:i + 6])
                if overlap >= fg_threshold:
                    if label <= 0:
                        raise ValueError(
                            f"{source}: foreground window with label "
                            f"{label} (CHECK_GT(label, 0))")
                    self.fg.append((img_idx, label) + box)
                elif overlap < bg_threshold:
                    self.bg.append((img_idx, 0) + box)
                i += 6
        if not self.images:
            raise ValueError(f"{source}: no images")
        self.channels = self.images[0][1]
        self.shape = (self.batch_size, self.channels, self.crop, self.crop)

    @property
    def num_records(self):
        return len(self.fg) + len(self.bg)


    def _read(self, idx):
        # decode per window (the reference's default; its cache_images
        # byte-cache is an opt-in we don't carry) — an unbounded decoded
        # cache would OOM on real R-CNN window files (~20k images)
        path, channels = self.images[idx]
        return _decode_chw_bgr(self._Image, path, color=channels == 3)

    def _window(self, win, do_mirror):
        """One warped, padded, mean-subtracted (C, crop, crop) float32."""
        img_idx, label, x1, y1, x2, y2 = win
        img = self._read(img_idx)
        c, ih, iw = img.shape
        crop = self.crop
        pad_w = pad_h = 0
        out_w = out_h = crop
        if self.context_pad > 0 or self.use_square:
            context_scale = crop / float(crop - 2 * self.context_pad)
            half_h = (y2 - y1 + 1) / 2.0
            half_w = (x2 - x1 + 1) / 2.0
            cx, cy = x1 + half_w, y1 + half_h
            if self.use_square:
                half_h = half_w = max(half_h, half_w)
            x1 = int(round(cx - half_w * context_scale))
            x2 = int(round(cx + half_w * context_scale))
            y1 = int(round(cy - half_h * context_scale))
            y2 = int(round(cy + half_h * context_scale))
            unclipped_h, unclipped_w = y2 - y1 + 1, x2 - x1 + 1
            pad_x1, pad_y1 = max(0, -x1), max(0, -y1)
            pad_x2, pad_y2 = max(0, x2 - iw + 1), max(0, y2 - ih + 1)
            x1, x2 = x1 + pad_x1, x2 - pad_x2
            y1, y2 = y1 + pad_y1, y2 - pad_y2
            scale_x = crop / float(unclipped_w)
            scale_y = crop / float(unclipped_h)
            out_w = int(round((x2 - x1 + 1) * scale_x))
            out_h = int(round((y2 - y1 + 1) * scale_y))
            pad_x1 = int(round(pad_x1 * scale_x))
            pad_x2 = int(round(pad_x2 * scale_x))
            pad_y1 = int(round(pad_y1 * scale_y))
            pad_h = pad_y1
            # mirrored windows mirror their padding too (:371-376)
            pad_w = pad_x2 if do_mirror else pad_x1
            out_h = min(out_h, crop - pad_h)
            out_w = min(out_w, crop - pad_w)
        roi = img[:, y1:y2 + 1, x1:x2 + 1]
        pil = self._Image.fromarray(
            roi.transpose(1, 2, 0) if c == 3 else roi[0])
        pil = pil.resize((out_w, out_h), self._Image.BILINEAR)
        warped = np.asarray(pil, np.uint8)
        warped = warped.transpose(2, 0, 1) if c == 3 else warped[None]
        if do_mirror:
            warped = warped[:, :, ::-1]
        canvas = np.zeros((c, self.crop, self.crop), np.float32)
        canvas[:, pad_h:pad_h + out_h, pad_w:pad_w + out_w] = warped
        t = self.transformer
        if t.mean is not None and t.full_mean:
            moff = (t.mean.shape[-1] - crop) // 2
            mean_roi = t.mean[:, moff:moff + crop, moff:moff + crop]
            # mean subtracted only where the warped window landed
            # (zero padding stays zero, :399-409 indexes mean per pixel)
            region = np.zeros_like(canvas)
            region[:, pad_h:pad_h + out_h, pad_w:pad_w + out_w] = \
                mean_roi[:, pad_h:pad_h + out_h, pad_w:pad_w + out_w]
            canvas -= region
        elif t.mean is not None:
            region = np.zeros_like(canvas)
            region[:, pad_h:pad_h + out_h, pad_w:pad_w + out_w] = \
                t.mean[:, None, None]
            canvas -= region
        return canvas * t.scale

    def __iter__(self):
        n_fg = int(self.batch_size * self.fg_fraction)
        counts = [self.batch_size - n_fg, n_fg]    # bg first, then fg
        while True:
            data = np.empty(self.shape, np.float32)
            labels = np.empty(self.batch_size, np.int32)
            item = 0
            for is_fg, pool in ((0, self.bg), (1, self.fg)):
                for _ in range(counts[is_fg]):
                    if not pool:
                        raise ValueError(
                            f"{self.source}: no "
                            f"{'foreground' if is_fg else 'background'} "
                            "windows to sample")
                    win = pool[self.rng.randint(len(pool))]
                    do_mirror = bool(self.transformer.mirror
                                     and self.rng.randint(2))
                    data[item] = self._window(win, do_mirror)
                    labels[item] = win[1]
                    item += 1
            yield {self.data_top: data, self.label_top: labels}

    def close(self):
        pass
