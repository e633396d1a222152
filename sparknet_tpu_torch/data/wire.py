"""Compressed wire formats for the host-to-card feed (the port of
sparknet_tpu/data/wire.py).

The device-transform feed (device_transform.py) ships raw uint8 records
instead of float32 crops. The codecs ship fewer bytes still:

  precrop  — the host slices each record's crop window (with the SAME
             y/x draws that ride along as aux arrays) before shipping, so
             the wire carries crop^2 pixels instead of src^2. Exact uint8
             slicing: the device skips its crop gather but still slices
             the full-size mean at the ORIGINAL y/x and mirrors there, so
             the float32 op order, and every output bit, is unchanged
             (DeviceTransformer.device_fn(precropped=True)). CaffeNet's
             256^2 -> 227^2 is 1.27x.
  pack     — lossless bit-pack for low-entropy sources: when every pixel
             value fits in 1/2/4 bits, 8/4/2 pixels share each shipped
             byte; the device unpacks with shifts and masks before the
             transform. The width is fixed ONCE (explicitly, or inferred
             from the first record), and a later batch that exceeds it
             raises instead of clipping. Width 8 is the raw passthrough.

``precrop+pack`` composes both. Selected by SPARKNET_WIRE / ``--wire``
(default: raw, no codec).

Echo: data echoing re-draws crop/mirror for each echo of one shipped
batch, which a precropped wire cannot give, so the verb refuses echo > 1
with a precrop mode.
"""

import os

import numpy as np
import torch

WIRE_MODES = ("raw", "precrop", "pack", "precrop+pack")
PACK_WIDTHS = (1, 2, 4, 8)


def wire_mode_from_env(default="raw"):
    """SPARKNET_WIRE -> a validated wire mode (a typo is an error: a
    misspelled lever silently measuring the baseline would fake an A/B)."""
    mode = os.environ.get("SPARKNET_WIRE", "").strip().lower() or default
    if mode not in WIRE_MODES:
        raise ValueError(f"SPARKNET_WIRE={mode!r}: expected one of "
                         f"{', '.join(WIRE_MODES)}")
    return mode


def wire_bits_from_env():
    """SPARKNET_WIRE_BITS -> an explicit pack width (None: infer it from
    a sample record when the codec is built)."""
    raw = os.environ.get("SPARKNET_WIRE_BITS", "").strip()
    if not raw:
        return None
    bits = int(raw)
    if bits not in PACK_WIDTHS:
        raise ValueError(f"SPARKNET_WIRE_BITS={bits}: expected one of "
                         f"{PACK_WIDTHS}")
    return bits


def infer_pack_bits(sample):
    """Smallest lossless pack width for ``sample``'s value range. A sample
    may understate the global max: encode() then raises on the first
    batch out of range (set SPARKNET_WIRE_BITS to be explicit)."""
    mx = int(np.max(sample)) if np.size(sample) else 0
    for bits in PACK_WIDTHS:
        if mx < (1 << bits):
            return bits
    return 8


def unpack(packed, bits, count, shape):
    """uint8 tensor (N, bytes) of ``bits``-bit fields, field i of a byte
    at bit i*bits (the host's _pack order) -> uint8 (N,) + shape, the
    first ``count`` fields of each row. Shifts and masks on the tensor's
    own device."""
    per_byte = 8 // bits
    shifts = torch.arange(per_byte, dtype=torch.uint8,
                          device=packed.device) * bits
    vals = (packed[:, :, None] >> shifts) & ((1 << bits) - 1)
    flat = vals.reshape(packed.shape[0], -1)[:, :count]
    return flat.reshape((packed.shape[0],) + tuple(shape))


class WireCodec:
    """Host-side encode and device-side decode around a DeviceTransformer.

    encode() runs where the source yields (the prefetch worker);
    device_fn() wraps the transformer's transform with the matching
    unpack, so the solver's input transform is one composed fn.
    raw_overrides() gives check_batch the SHIPPED shapes."""

    def __init__(self, devt, record_shape, mode="raw", bits=None,
                 sample=None):
        if mode not in WIRE_MODES:
            raise ValueError(f"wire mode {mode!r}: expected one of "
                             f"{', '.join(WIRE_MODES)}")
        self.devt = devt
        self.record_shape = tuple(int(d) for d in record_shape)
        self.mode = mode
        crop = devt.h.crop_size
        # precrop with no crop configured degenerates to raw shipping
        self.precrop = "precrop" in mode and bool(crop)
        self._crop = int(crop) if crop else 0
        self.packing = "pack" in mode
        if self.packing:
            if bits is None:
                if sample is None:
                    raise ValueError(
                        "pack wire mode needs an explicit bit width "
                        "(SPARKNET_WIRE_BITS / --wire-bits) or a sample "
                        "record to infer one from")
                bits = infer_pack_bits(sample)
            if bits not in PACK_WIDTHS:
                raise ValueError(f"pack width {bits}: expected one of "
                                 f"{PACK_WIDTHS}")
            if bits == 8:
                self.packing = False    # raw passthrough
        self.bits = int(bits) if self.packing else 8
        c, h, w = self.record_shape
        self.image_shape = (c, self._crop, self._crop) if self.precrop \
            else (c, h, w)
        self._flat_n = int(np.prod(self.image_shape))
        if self.packing:
            self._per_byte = 8 // self.bits
            self._pad = (-self._flat_n) % self._per_byte
            self.wire_shape = ((self._flat_n + self._pad) // self._per_byte,)
        else:
            self.wire_shape = self.image_shape

    # -- host side ---------------------------------------------------------
    def encode(self, batch):
        """Feed dict (uint8 records + aux draws) -> the same dict with the
        records re-encoded for the wire. The aux arrays ship unchanged:
        the device needs the ORIGINAL y/x for the full mean's window even
        when the crop happened here."""
        data_top = self.devt.data_top
        x = batch[data_top]
        if self.precrop:
            ys, xs = batch[self.devt.ky], batch[self.devt.kx]
            crop = self._crop
            out = np.empty((len(x), x.shape[1], crop, crop), x.dtype)
            for i in range(len(x)):
                out[i] = x[i, :, ys[i]:ys[i] + crop, xs[i]:xs[i] + crop]
            x = out
        if self.packing:
            x = self._pack(x)
        if x is not batch[data_top]:
            batch = dict(batch)
            batch[data_top] = x
        return batch

    def _pack(self, x):
        mx = int(x.max(initial=0))
        if mx >= (1 << self.bits):
            raise ValueError(
                f"wire pack width {self.bits} is not lossless for this "
                f"batch (max value {mx}); set SPARKNET_WIRE_BITS to a "
                f"wider width or drop the pack mode")
        flat = np.ascontiguousarray(x, np.uint8).reshape(len(x), -1)
        if self._pad:
            flat = np.concatenate(
                [flat, np.zeros((len(x), self._pad), np.uint8)], axis=1)
        vals = flat.reshape(len(x), -1, self._per_byte).astype(np.uint16)
        shifts = np.arange(self._per_byte, dtype=np.uint16) * self.bits
        # each field occupies disjoint bits, so the sum fits a byte
        return (vals << shifts).sum(axis=2).astype(np.uint8)

    # -- device side -------------------------------------------------------
    def device_fn(self):
        """fn(batch of tensors) -> the net's feed: unpack (when packing),
        then the transformer's precrop-aware transform."""
        inner = self.devt.device_fn(precropped=self.precrop)
        if not self.packing:
            return inner
        bits, count, shape = self.bits, self._flat_n, self.image_shape
        data_top = self.devt.data_top

        def fn(batch):
            batch = dict(batch)
            batch[data_top] = unpack(batch[data_top], bits, count, shape)
            return inner(batch)

        return fn

    def raw_overrides(self, batch_size):
        """check_batch shape overrides for the SHIPPED feed."""
        over = self.devt.raw_overrides(batch_size, self.record_shape)
        over[self.devt.data_top] = (batch_size,) + tuple(self.wire_shape)
        return over

    # -- accounting --------------------------------------------------------
    @property
    def raw_kb_per_image(self):
        """The uncompressed wire (the raw uint8 record)."""
        return int(np.prod(self.record_shape)) / 1024.0

    @property
    def kb_per_image(self):
        """Shipped pixel bytes per image under this codec."""
        return int(np.prod(self.wire_shape)) / 1024.0

    def describe(self):
        """The codec's fields for the ``prefetch`` event's extras."""
        row = {"wire": self.mode,
               "h2d_kb_per_image": round(self.kb_per_image, 2),
               "wire_reduction": round(
                   self.raw_kb_per_image / max(self.kb_per_image, 1e-9), 2)}
        if self.packing:
            row["wire_bits"] = self.bits
        return row
