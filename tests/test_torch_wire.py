"""The port's wire codecs (data/wire.py) against the JAX package's on the
CPU: each mode ships the bytes the JAX encoder ships, and the decoded,
transformed batch equals the raw path's and the JAX decode's bit for bit
(the codec moves where the crop slice and the unpack happen, never the
float32 op order). Small seeded uint8 records (6 x 3x16x16); the
DatumBatchSource case reads a 20-record LMDB written here.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu.data.db_source import DatumBatchSource as JSource
from sparknet_tpu.data.device_transform import \
    build_device_transformer as jbuild
from sparknet_tpu.data.wire import WireCodec as JCodec
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.data.datum import array_to_datum
from sparknet_tpu_torch.data.db_source import DatumBatchSource
from sparknet_tpu_torch.data.device_transform import (aux_keys,
                                                      build_device_transformer)
from sparknet_tpu_torch.data.lmdb import LMDBWriter
from sparknet_tpu_torch.data.wire import (PACK_WIDTHS, WIRE_MODES, WireCodec,
                                          infer_pack_bits, unpack,
                                          wire_bits_from_env,
                                          wire_mode_from_env)
from sparknet_tpu_torch.proto import Message


def _tp(M, crop=12, mirror=True, mean_values=(10.0, 20.0, 30.0), scale=0.5):
    tp = M("TransformationParameter", mirror=mirror, scale=scale)
    if crop:
        tp.crop_size = crop
    if mean_values:
        tp.mean_value.extend(list(mean_values))
    return tp


def _pair(full_mean=False, seed=9, **kw):
    """The port's and the JAX package's DeviceTransformer on one config,
    their RandomStates seeded alike."""
    port = build_device_transformer(_tp(Message, **kw), phase=0,
                                    rng=np.random.RandomState(seed))
    ref = jbuild(_tp(JMessage, **kw), phase=0,
                 rng=np.random.RandomState(seed))
    if full_mean:
        mean = np.random.RandomState(2).rand(3, 16, 16).astype(
            np.float32) * 90
        for d in (port, ref):
            d.h.mean, d.h.full_mean = mean, True
    return port, ref


def _feed(devt, images):
    n = len(images)
    return {"data": images, "label": np.zeros(n, np.int32),
            **devt.aux(n, images.shape[1:])}


def _uniform(n=6, hi=256, seed=0):
    return np.random.RandomState(seed).randint(
        0, hi, (n, 3, 16, 16)).astype(np.uint8)


def _run(fn, batch):
    return fn({k: torch.from_numpy(np.asarray(v))
               for k, v in batch.items()})["data"].numpy()


@pytest.mark.parametrize("full_mean", [False, True],
                         ids=["mean_value", "full-mean"])
@pytest.mark.parametrize("mode", ["precrop", "pack", "precrop+pack"])
def test_each_mode_ships_the_jax_bytes_and_decodes_bit_exact(mode,
                                                             full_mean):
    kw = dict(mean_values=None) if full_mean else {}
    port, ref = _pair(full_mean=full_mean, **kw)
    # low-entropy pixels: the inferred pack width is 2 bits
    images = _uniform(hi=4, seed=1)
    batch, jbatch = _feed(port, images), _feed(ref, images)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    raw = _run(port.device_fn(), batch)
    codec = WireCodec(port, images.shape[1:], mode=mode, sample=images)
    jcodec = JCodec(ref, images.shape[1:], mode=mode, sample=images)
    assert (codec.bits, codec.wire_shape, codec.precrop) == \
        (jcodec.bits, jcodec.wire_shape, jcodec.precrop)
    assert (codec.kb_per_image, codec.raw_kb_per_image) == \
        (jcodec.kb_per_image, jcodec.raw_kb_per_image)
    assert codec.raw_overrides(6) == jcodec.raw_overrides(6)
    shipped, jshipped = codec.encode(batch), jcodec.encode(jbatch)
    assert sorted(shipped) == sorted(jshipped)
    for k in shipped:
        assert np.asarray(shipped[k]).dtype == np.asarray(jshipped[k]).dtype
        np.testing.assert_array_equal(shipped[k], jshipped[k])
    got = _run(codec.device_fn(), shipped)
    want = np.asarray(jcodec.device_fn()(dict(jshipped))["data"])
    np.testing.assert_array_equal(got, raw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_pack_field_order_is_the_jax_encoders(bits):
    port, ref = _pair(crop=0, mirror=False, mean_values=None, scale=1.0)
    images = _uniform(n=3, hi=1 << bits, seed=5)
    codec = WireCodec(port, images.shape[1:], mode="pack", bits=bits)
    jpacked = JCodec(ref, images.shape[1:], mode="pack",
                     bits=bits).encode(_feed(ref, images))["data"]
    # the port's unpack of the JAX encoder's bytes gives the pixels back
    out = unpack(torch.from_numpy(np.asarray(jpacked)), bits,
                 codec._flat_n, codec.image_shape)
    np.testing.assert_array_equal(out.numpy(), images)
    # field i of a byte at bit i * bits
    one = np.zeros((1, 3, 16, 16), np.uint8)
    one.reshape(-1)[1] = 1
    byte = codec.encode(_feed(port, one))["data"][0, 0]
    assert byte == 1 << bits


def test_pack_overflow_raises_not_clips():
    port, _ = _pair(crop=0)
    images = _uniform(hi=4, seed=6)
    codec = WireCodec(port, images.shape[1:], mode="pack", bits=2)
    hot = images.copy()
    hot[0, 0, 0, 0] = 200
    with pytest.raises(ValueError, match="lossless"):
        codec.encode(_feed(port, hot))


def test_widths_are_fixed_once_and_precrop_needs_a_crop():
    port, _ = _pair(crop=0)
    images = _uniform(hi=256, seed=7)
    codec = WireCodec(port, images.shape[1:], mode="pack", sample=images)
    assert not codec.packing and codec.bits == 8
    assert codec.wire_shape == images.shape[1:]
    assert [infer_pack_bits(np.array([v])) for v in (0, 3, 15, 16)] == \
        [1, 2, 4, 8]
    pre = WireCodec(port, (3, 16, 16), mode="precrop")
    assert not pre.precrop and pre.wire_shape == (3, 16, 16)
    batch = _feed(port, images)
    assert pre.encode(batch)["data"] is batch["data"]
    with pytest.raises(ValueError, match="sample"):
        WireCodec(port, (3, 16, 16), mode="pack")
    # CaffeNet's geometry at 2 bits: 192 KB -> 37.8 KB an image
    cn, _ = _pair(crop=227)
    codec = WireCodec(cn, (3, 256, 256), mode="precrop+pack", bits=2)
    assert codec.raw_kb_per_image == 192 and codec.kb_per_image < 38


def test_env_validation(monkeypatch):
    monkeypatch.setenv("SPARKNET_WIRE", "precrop+pack")
    assert wire_mode_from_env() == "precrop+pack"
    monkeypatch.setenv("SPARKNET_WIRE", "precorp")
    with pytest.raises(ValueError, match="SPARKNET_WIRE"):
        wire_mode_from_env()
    monkeypatch.delenv("SPARKNET_WIRE")
    assert wire_mode_from_env() == "raw"
    monkeypatch.setenv("SPARKNET_WIRE_BITS", "3")
    with pytest.raises(ValueError, match="SPARKNET_WIRE_BITS"):
        wire_bits_from_env()
    monkeypatch.setenv("SPARKNET_WIRE_BITS", "4")
    assert wire_bits_from_env() == 4
    assert WIRE_MODES == ("raw", "precrop", "pack", "precrop+pack")
    assert PACK_WIDTHS == (1, 2, 4, 8)


@pytest.mark.parametrize("mode", ["precrop", "pack"])
def test_batch_source_ships_the_jax_sources_wire(tmp_path, monkeypatch,
                                                 mode):
    rs = np.random.RandomState(3)
    imgs = rs.randint(0, 4, (20, 3, 16, 16)).astype(np.uint8)
    with LMDBWriter(str(tmp_path / "db")) as w:
        for i in range(20):
            w.put(b"%05d" % i, array_to_datum(imgs[i], i % 10))
    monkeypatch.setenv("SPARKNET_WIRE", mode)
    monkeypatch.delenv("SPARKNET_WIRE_BITS", raising=False)
    kw = dict(batch_size=6, seed=4, device_transform=True)
    tp = dict(crop_size=12, mirror=True, mean_value=[1.0, 2.0, 3.0])
    port = DatumBatchSource(str(tmp_path / "db"), transform_param=Message(
        "TransformationParameter", **tp), **kw)
    ref = JSource(str(tmp_path / "db"), transform_param=JMessage(
        "TransformationParameter", **tp), **kw)
    assert (port.wire.mode, port.wire.bits, port.wire.wire_shape) == \
        (ref.wire.mode, ref.wire.bits, ref.wire.wire_shape)
    assert port.raw_feed_overrides == ref.raw_feed_overrides
    monkeypatch.setenv("SPARKNET_WIRE", "raw")
    raw = DatumBatchSource(str(tmp_path / "db"), transform_param=Message(
        "TransformationParameter", **tp), **kw)
    assert raw.wire is None
    for _, got, want, plain in zip(range(4), port, ref, raw):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(
            _run(port.device_fn, got), _run(raw.device_fn, plain))
    for s in (port, ref, raw):
        s.close()
    ky, kx, kf = aux_keys("data")
    assert set(port.fresh_aux()) == {ky, kx, kf}
