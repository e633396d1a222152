"""Input transforms on the host: the reference DataTransformer and the
ImageNet app's preprocessing (the port's copy of
sparknet_tpu/data/transforms.py).

Replaces caffe/src/caffe/data_transformer.cpp (crop/mirror/scale/mean,
:42-51) and the per-image Scala preprocessing closures
(ImageNetApp.scala:155-169: random 227x227 crop + mean subtraction; test
variant :117-131: center crop). The crop/mirror/mean/scale pass and the
mean accumulator run in the native host library (native/, built with
g++ on first use; its numpy path gives the same numbers where it does
not build), as the JAX package's do. data/device_transform.py is the
same arithmetic on the card.
"""

import os

import numpy as np

from .. import native
from ..native import transform_batch  # noqa: F401  (the transforms' API)


def check_mean(mean, full_mean, c, h, w, crop):
    """The kind of ``mean`` (0 none, 1 per-channel, 2 cropped image, 3
    full source-size image), or ValueError when its shape fits neither
    the source (C,H,W) nor the crop (C,crop,crop)."""
    if mean is None:
        return 0
    shape = tuple(np.shape(mean))
    if len(shape) == 1:
        return 1
    if full_mean:
        if shape != (c, h, w):
            raise ValueError(f"full mean shape {shape} != {(c, h, w)}")
        return 3
    if shape != (c, crop, crop):
        raise ValueError(f"mean shape {shape} != {(c, crop, crop)}")
    return 2


def draw_crops(rng, n, h, w, crop, mirror):
    """(ys, xs, flips) for ``n`` random crops of (h, w) images, drawn from
    ``rng`` in transform_train's order (ys, then xs, then flips); flips
    is None without ``mirror``."""
    ys = rng.randint(0, h - crop + 1, size=n).astype(np.int32)
    xs = rng.randint(0, w - crop + 1, size=n).astype(np.int32)
    flips = rng.randint(0, 2, size=n).astype(np.uint8) if mirror else None
    return ys, xs, flips


def transform_train(images, crop, mean=None, mirror=True, rng=None,
                    scale=1.0):
    """Random crop + mirror + mean-subtract + scale over the batch (the
    data_transformer.cpp TRAIN path). mean must be per-channel (C,) or
    a mean image, whose center window is taken (C,crop,crop)."""
    n, c, h, w = images.shape
    ys, xs, flips = draw_crops(rng or np.random, n, h, w, crop, mirror)
    return transform_batch(images, crop, ys=ys, xs=xs, mirror=flips,
                           mean=_crop_mean(mean, c, crop), scale=scale)


def transform_test(images, crop, mean=None, scale=1.0):
    """Center crop + mean-subtract (the TEST path)."""
    n, c, h, w = images.shape
    ys = np.full(n, (h - crop) // 2, np.int32)
    xs = np.full(n, (w - crop) // 2, np.int32)
    return transform_batch(images, crop, ys=ys, xs=xs,
                           mean=_crop_mean(mean, c, crop), scale=scale)


def _crop_mean(mean, c, crop):
    """A mean image larger than the crop -> its center (C,crop,crop)
    window; a per-channel mean or one of the crop's size unchanged."""
    if mean is None:
        return None
    mean = np.asarray(mean, np.float32)
    if mean.ndim == 3 and mean.shape[-2:] != (crop, crop):
        mh, mw = mean.shape[-2:]
        y, x = (mh - crop) // 2, (mw - crop) // 2
        mean = np.ascontiguousarray(mean[:, y:y + crop, x:x + crop])
    return mean


def load_mean_binaryproto(path):
    """.binaryproto BlobProto -> (C,H,W) float32 mean image
    (data_transformer.cpp:19-28 mean_file load)."""
    from ..proto import wire
    blob = wire.load(path, "BlobProto")
    data = np.asarray(blob.data, np.float32)
    if blob.has("shape"):
        shape = tuple(int(d) for d in blob.shape.dim)
    else:
        shape = (int(blob.num), int(blob.channels), int(blob.height),
                 int(blob.width))
    data = data.reshape([d for d in shape if d] or [-1])
    if data.ndim == 4:       # legacy num=1 leading axis
        data = data[0]
    return data


def save_mean_binaryproto(mean, path):
    """(C,H,W) float32 -> .binaryproto BlobProto with legacy NCHW dims
    (what tools/compute_image_mean.cpp writes)."""
    from ..proto import Message, wire
    mean = np.asarray(mean, np.float32)
    c, h, w = mean.shape
    blob = Message("BlobProto", num=1, channels=c, height=h, width=w)
    blob.data.extend_np(mean.ravel())
    wire.dump(blob, path)


class DataTransformer:
    """TransformationParameter-driven batch transform — the configuration
    surface of the reference DataTransformer (data_transformer.cpp:19-51):
    scale, mirror, crop_size, mean_file XOR mean_value, with TRAIN = random
    crop + random mirror and TEST = center crop + random mirror (caffe
    mirrors in both phases when mirror:true)."""

    def __init__(self, tp=None, phase=0, base_dir="", rng=None):
        self.phase = phase
        self.rng = rng or np.random.RandomState()
        self.scale = float(tp.scale) if tp is not None else 1.0
        self.mirror = bool(tp.mirror) if tp is not None else False
        self.crop_size = int(tp.crop_size) if tp is not None else 0
        self.mean = None
        self.full_mean = False
        if tp is not None and tp.has("mean_file"):
            if list(tp.mean_value):
                raise ValueError(
                    "specify either mean_file or mean_value, not both "
                    "(data_transformer.cpp CHECK)")
            path = tp.mean_file
            if base_dir and not os.path.isabs(path):
                path = os.path.join(base_dir, path)
            self.mean = load_mean_binaryproto(path)
            self.full_mean = True
        elif tp is not None and list(tp.mean_value):
            self.mean = np.asarray([float(v) for v in tp.mean_value],
                                   np.float32)

    def output_shape(self, record_shape):
        c, h, w = record_shape
        s = self.crop_size or None
        return (c, s or h, s or w)

    def draws(self, n, record_shape):
        """This batch's randomness, (ys, xs, flips): TRAIN draws random
        offsets, TEST takes the center window; flips are drawn in both
        phases under mirror. ys/xs are None without a crop, flips None
        without mirror. Consumes ``rng`` as the reference's per-record
        Rand() calls do, in the same order on the host and device paths."""
        h, w = record_shape[1], record_shape[2]
        crop = self.crop_size
        ys = xs = None
        if crop:
            if self.phase == 0:
                ys = self.rng.randint(0, h - crop + 1, n).astype(np.int32)
                xs = self.rng.randint(0, w - crop + 1, n).astype(np.int32)
            else:
                ys = np.full(n, (h - crop) // 2, np.int32)
                xs = np.full(n, (w - crop) // 2, np.int32)
        flips = self.rng.randint(0, 2, n).astype(np.uint8) \
            if self.mirror else None
        return ys, xs, flips

    def channel_mean(self, c):
        """The mean as transform_batch takes it: the full image, or a
        per-channel (C,) vector (one mean_value broadcast to every
        channel)."""
        mean = self.mean
        if mean is not None and not self.full_mean:
            if len(mean) not in (1, c):
                raise ValueError(
                    f"mean_value count {len(mean)} != channels {c}")
            if len(mean) == 1:
                mean = np.repeat(mean, c)
        return mean

    def __call__(self, images):
        """uint8/float (N,C,H,W) -> float32 (N,C,crop,crop), or (N,C,H,W)
        when crop_size is 0 (caffe crops are always square; uncropped
        records keep their full, possibly non-square, extent)."""
        images = np.asarray(images)
        n, c, h, w = images.shape
        mean = self.channel_mean(c)
        if not self.crop_size:
            out = images.astype(np.float32)
            if mean is not None and self.full_mean:
                out -= mean[None]          # source-index == full image
            if self.mirror:
                flips = self.rng.randint(0, 2, n).astype(bool)
                out[flips] = out[flips][:, :, :, ::-1]
            if mean is not None and not self.full_mean:
                out -= mean.reshape(1, -1, 1, 1)
            if self.scale != 1.0:
                out *= self.scale
            return out
        ys, xs, flips = self.draws(n, images.shape[1:])
        crop = self.crop_size
        if images.dtype == np.uint8:
            return transform_batch(images, crop, ys=ys, xs=xs, mirror=flips,
                                   mean=mean, scale=self.scale,
                                   full_mean=self.full_mean)
        # float records (float_data datums)
        out = np.empty((n, c, crop, crop), np.float32)
        for i in range(n):
            y0, x0 = int(ys[i]), int(xs[i])
            win = images[i, :, y0:y0 + crop, x0:x0 + crop].astype(np.float32)
            if mean is not None and self.full_mean:
                win = win - mean[:, y0:y0 + crop, x0:x0 + crop]
            if flips is not None and flips[i]:
                win = win[:, :, ::-1]
            out[i] = win
        if mean is not None and not self.full_mean:
            out -= mean.reshape(1, -1, 1, 1)
        if self.scale != 1.0:
            out *= self.scale
        return out


def accumulate_sum(images, acc):
    """Add the sum over the batch of uint8 (N,...) into int64 acc (...)."""
    return native.accumulate_sum(np.asarray(images), acc)


def compute_mean(image_iter, shape):
    """Streaming mean image over an iterator of (N, C, H, W) uint8 arrays —
    the ComputeMean.scala:10-37 accumulator without the RDD."""
    acc = np.zeros(shape, np.int64)
    count = 0
    for batch in image_iter:
        native.accumulate_sum(np.asarray(batch), acc)
        count += len(batch)
    if count == 0:
        raise ValueError("empty image stream")
    return (acc / count).astype(np.float32)
