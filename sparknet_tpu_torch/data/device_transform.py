"""DataTransformer on the device: crop/mirror/mean/scale as PyTorch ops on
the batch's own device (the port of sparknet_tpu/data/device_transform.py).

The host path (transforms.DataTransformer) ships float32 *crops* to the
card: for CaffeNet 227*227*3*4 = 618 KB an image. The device path ships
the raw uint8 source batch (256*256*3 = 196 KB an image, 3.2x less) and
applies the reference semantics there (data_transformer.cpp:42-51:
``top[mirrored_index] = (src[data_index] - mean[data_index]) * scale``):

  host:   draws per-image crop offsets and mirror flags from the host
          transformer's own RandomState — small int arrays riding along
          with the uint8 batch under the keys of ``aux_keys``;
  device: gathers the crop windows, subtracts the mean (a full mean
          source-indexed *before* the mirror, a per-channel or cropped
          mean after it), mirrors and scales.

The float32 operations run in the host path's order, so on the same draws
the device's output equals transforms.transform_batch's bit for bit.
The JAX package lets XLA fuse this into the step; here it is a handful
of PyTorch ops (a gather, a cast, subtractions, a select), with no kernel
of the port's own.
"""

import numpy as np
import torch

from .transforms import DataTransformer, check_mean


def aux_keys(data_top):
    """Names of the host-side randomness arrays riding with ``data_top``.
    '#' keeps them out of any legal prototxt blob namespace."""
    return (f"{data_top}#y", f"{data_top}#x", f"{data_top}#flip")


def _tensor(v, device):
    """An array (copied: the records' arrays may be read-only) or a
    tensor, on ``device``."""
    return (v if torch.is_tensor(v) else torch.tensor(np.asarray(v))) \
        .to(device)


def _index(v, n, device):
    if v is None:
        return torch.zeros(n, dtype=torch.long, device=device)
    return _tensor(v, device).long()


def transform_batch(images, crop, ys=None, xs=None, mirror=None, mean=None,
                    scale=1.0, full_mean=False, precropped=False):
    """uint8 tensor (N,C,H,W) -> float32 (N,C,crop,crop) on the tensor's
    device; crop 0 keeps the whole (H,W). The arguments are
    transforms.transform_batch's (numpy arrays or tensors), and so is the
    result on the same draws, to the bit. ``precropped``: the images are
    already the (N,C,crop,crop) windows at ys/xs (the precrop wire), so
    the gather is skipped; a full mean is still taken at ys/xs."""
    n, c, h, w = images.shape
    dev = images.device
    if precropped and full_mean and mean is not None:
        h, w = tuple(mean.shape[-2:])       # the source records' extent
    kind = check_mean(mean, full_mean, c, h, w, crop or h)
    if mean is not None:
        mean = _tensor(mean, dev).float()
    if crop:
        ar = torch.arange(crop, device=dev)
        rows = (_index(ys, n, dev)[:, None] + ar).view(n, 1, crop, 1)
        cols = (_index(xs, n, dev)[:, None] + ar).view(n, 1, 1, crop)
        chan = torch.arange(c, device=dev).view(1, c, 1, 1)
        img = torch.arange(n, device=dev).view(n, 1, 1, 1)
        # slicing uint8 then casting equals casting then slicing
        out = images.float() if precropped \
            else images[img, chan, rows, cols].float()
        if kind == 3:        # the source-indexed window, before the mirror
            out = out - mean[chan, rows, cols]
    else:
        out = images.float()
        if kind == 3:
            out = out - mean[None]
    if mirror is not None:
        flips = _tensor(mirror, dev).view(n, 1, 1, 1) != 0
        out = torch.where(flips, out.flip(-1), out)
    if kind == 1:
        out = out - mean.view(1, c, 1, 1)
    elif kind == 2:
        out = out - mean
    if scale != 1.0:
        out = out * scale
    return out


class DeviceTransformer:
    """Device-side twin of a (configured) DataTransformer.

    Wraps the host transformer for its parsed TransformationParameter state
    (scale / mirror / crop_size / mean_file XOR mean_value, phase) and its
    RandomState: the aux draws below consume the rng as
    DataTransformer.__call__ does, so a source switched between host and
    device modes sees the identical augmentation stream.
    """

    def __init__(self, host_transformer, data_top="data"):
        self.h = host_transformer
        self.data_top = data_top
        self.ky, self.kx, self.kf = aux_keys(data_top)

    def aux(self, n, record_shape):
        """Per-batch randomness: {aux_key: int array} for ``n`` images of
        ``record_shape`` (C,H,W): DataTransformer.draws, under the keys
        the device side reads."""
        ys, xs, flips = self.h.draws(n, record_shape)
        out = {}
        if ys is not None:
            out[self.ky], out[self.kx] = ys, xs
        if flips is not None:
            out[self.kf] = flips
        return out

    def raw_overrides(self, batch_size, record_shape):
        """check_batch shape overrides for the raw (pre-transform) feed:
        the uint8 source extent plus the aux arrays."""
        over = {self.data_top: (batch_size,) + tuple(record_shape)}
        for k in self.aux(0, record_shape):
            over[k] = (batch_size,)
        return over

    def device_fn(self, precropped=False):
        """-> fn(batch dict) -> batch dict. Consumes ``data_top`` (a uint8
        tensor on its device) and the aux keys, passes every other entry
        (labels, extra feeds) through. ``precropped``: the wire codec
        already sliced the crop windows on the host (data/wire.py); the
        y/x aux still place the full mean's window, so the output bits
        equal the uncropped path's."""
        t = self.h
        data_top, ky, kx, kf = self.data_top, self.ky, self.kx, self.kf
        means = {}

        def fn(batch):
            batch = dict(batch)
            x = batch.pop(data_top)
            mean = t.channel_mean(x.shape[1])
            if mean is not None:       # one upload per device
                if x.device not in means:
                    means[x.device] = _tensor(mean, x.device)
                mean = means[x.device]
            batch[data_top] = transform_batch(
                x, t.crop_size, ys=batch.pop(ky, None),
                xs=batch.pop(kx, None), mirror=batch.pop(kf, None),
                mean=mean, scale=t.scale, full_mean=t.full_mean,
                precropped=precropped)
            return batch

        return fn


def build_device_transformer(tp, phase=0, base_dir="", rng=None,
                             data_top="data"):
    """TransformationParameter -> DeviceTransformer (parsing — incl. the
    mean_file binaryproto load — delegated to the host DataTransformer)."""
    host = DataTransformer(tp, phase=phase, base_dir=base_dir, rng=rng)
    return DeviceTransformer(host, data_top=data_top)
