"""The port's native host library (sparknet_tpu_torch/native/): it builds
from the port's own pipeline.cpp into sparknet_tpu_torch/_build/, and
every entry point matches its numpy path and the JAX package's native
library bit for bit; the data modules dispatch to it where the JAX
package's do."""

import contextlib
import os

import numpy as np
import pytest

from sparknet_tpu import native as jnative
from sparknet_tpu_torch import native
from sparknet_tpu_torch.data import cifar, leveldb, transforms

PORT = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available()
    return native.library_path()


@contextlib.contextmanager
def numpy_path():
    """The entry points' numpy paths, as where the library does not
    build."""
    real = native._load
    native._load = lambda: None
    try:
        yield
    finally:
        native._load = real


def test_library_builds_into_the_ports_build_dir(built):
    assert os.path.dirname(built) == os.path.join(PORT, "_build")
    assert os.path.exists(built)
    assert os.path.basename(built).startswith("libsparknet_native_")
    src = os.path.join(PORT, "native", "pipeline.cpp")
    assert native._SRC == src and os.path.exists(src)
    # the key moves with the source: another source, another file
    real = native._SRC
    try:
        native._SRC = os.path.join(os.path.dirname(real), "__init__.py")
        assert native.library_path() != built
    finally:
        native._SRC = real


def _images(seed, n=6, c=3, h=13, w=11):
    rs = np.random.RandomState(seed)
    return rs, rs.randint(0, 256, (n, c, h, w)).astype(np.uint8)


@pytest.mark.parametrize("kind", ["none", "channel", "crop_image",
                                  "full_image"])
@pytest.mark.parametrize("crop", [8, 11])
@pytest.mark.parametrize("mirror", [False, True])
def test_transform_batch_bit_for_bit(kind, crop, mirror):
    rs, images = _images(crop + 3 * mirror)
    n, c, h, w = images.shape
    ys = rs.randint(0, h - crop + 1, n).astype(np.int32)
    xs = rs.randint(0, w - crop + 1, n).astype(np.int32)
    flips = rs.randint(0, 2, n).astype(np.uint8) if mirror else None
    mean = {"none": None,
            "channel": rs.rand(c).astype(np.float32) * 120,
            "crop_image": rs.rand(c, crop, crop).astype(np.float32) * 120,
            "full_image": rs.rand(c, h, w).astype(np.float32) * 120}[kind]
    full = kind == "full_image"
    for scale in (1.0, 0.00390625, 0.7):
        args = (images, crop, ys, xs, flips, mean, scale, full)
        got = native.transform_batch(*args)
        with numpy_path():
            ref = native.transform_batch(*args)
        jax_lib = jnative.transform_batch(*args)
        assert got.dtype == np.float32 and got.shape == (n, c, crop, crop)
        assert np.array_equal(got, ref), (kind, crop, mirror, scale)
        assert np.array_equal(got, jax_lib), (kind, crop, mirror, scale)


def test_data_transformer_runs_the_native_transform():
    from sparknet_tpu_torch.proto import Message
    tp = Message("TransformationParameter", crop_size=9, mirror=True,
                 scale=0.5)
    tp.mean_value.extend([104.0, 117.0, 123.0])
    rs, images = _images(3, h=12, w=12)
    got = transforms.DataTransformer(tp, phase=0,
                                     rng=np.random.RandomState(5))(images)
    dt = transforms.DataTransformer(tp, phase=0,
                                    rng=np.random.RandomState(5))
    ys, xs, flips = dt.draws(len(images), images.shape[1:])
    with numpy_path():
        ref = native.transform_batch(images, 9, ys, xs, flips,
                                     dt.channel_mean(3), 0.5)
    assert np.array_equal(got, ref)
    assert transforms.transform_batch is native.transform_batch


def test_decode_cifar_records_and_the_loader(tmp_path):
    rs = np.random.RandomState(4)
    raw = rs.randint(0, 256, 7 * cifar.RECORD).astype(np.uint8)
    got = native.decode_cifar_records(raw, cifar.RECORD)
    with numpy_path():
        ref = native.decode_cifar_records(raw, cifar.RECORD)
    jref = jnative.decode_cifar_records(raw, cifar.RECORD)
    for a, b, c in zip(got, ref, jref):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
    path = str(tmp_path / "data_batch_1.bin")
    raw.tofile(path)
    images, labels = cifar.read_batch_file(path)
    assert np.array_equal(images.reshape(7, -1), got[0])
    assert np.array_equal(labels, got[1])


def test_accumulate_sum_and_compute_mean():
    rs, images = _images(5)
    acc = np.zeros(images.shape[1:], np.int64)
    native.accumulate_sum(images, acc)
    native.accumulate_sum(images[:2], acc)
    ref = np.zeros_like(acc)
    with numpy_path():
        native.accumulate_sum(images, ref)
        native.accumulate_sum(images[:2], ref)
    jacc = np.zeros_like(acc)
    jnative.accumulate_sum(images, jacc)
    jnative.accumulate_sum(images[:2], jacc)
    assert np.array_equal(acc, ref) and np.array_equal(acc, jacc)
    mean = transforms.compute_mean(iter([images[:4], images[4:]]),
                                   images.shape[1:])
    assert np.array_equal(mean, (images.astype(np.int64).sum(0)
                                 / len(images)).astype(np.float32))


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4096 + 7])
def test_crc32c_matches_the_pure_python_one(n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    for crc in (0, 0x12345678):
        want = leveldb._crc32c_py(data, crc)
        assert native.crc32c(data, crc) == want
        assert jnative.crc32c(data, crc) == want
        assert leveldb.crc32c(data, crc) == want
    # the Castagnoli check value of "123456789"
    assert native.crc32c(b"123456789") == 0xE3069283
    assert leveldb.crc32c(b"123456789" * 8) == \
        leveldb._crc32c_py(b"123456789" * 8)


def _snappy_stream(rs):
    """A stream with literals, and copies of each offset width, some
    overlapping their own output (the pure decoder is the spec)."""
    out, body = bytearray(), bytearray()
    lit = bytes(rs.randint(0, 256, 50).astype(np.uint8))
    body += bytes([(len(lit) - 1) << 2]) + lit          # literal
    out += lit
    big = bytes(rs.randint(0, 256, 200).astype(np.uint8))
    body += bytes([60 << 2, len(big) - 1]) + big        # 1-byte length
    out += big
    for ln, off in ((4, 1), (11, 7), (60, 100)):        # copy-1 / copy-2
        if ln <= 11 and off < 2048:
            body += bytes([1 | ((ln - 4) << 2) | ((off >> 8) << 5),
                           off & 0xff])
        else:
            body += bytes([2 | ((ln - 1) << 2)]) + off.to_bytes(2, "little")
        for _ in range(ln):
            out.append(out[-off])
    body += bytes([3 | ((9 - 1) << 2)]) + (50).to_bytes(4, "little")
    for _ in range(9):                                  # copy-4
        out.append(out[-50])
    pre = bytearray()
    leveldb._put_varint(pre, len(out))
    return bytes(pre + body), bytes(out)


def test_snappy_matches_the_pure_python_decoder():
    rs = np.random.RandomState(9)
    data, want = _snappy_stream(rs)
    n, p = leveldb._get_varint(data, 0)
    assert leveldb._snappy_decompress_py(data, n, p) == want
    assert native.snappy_uncompress(data, n) == want
    assert jnative.snappy_uncompress(data, n) == want
    assert leveldb.snappy_decompress(data) == want
    payload = bytes(rs.randint(0, 256, 5000).astype(np.uint8))
    comp = leveldb.snappy_compress(payload)
    assert leveldb.snappy_decompress(comp) == payload
    assert native.snappy_uncompress(comp, len(payload)) == payload


def test_corrupt_and_oversized_snappy_take_the_error_path():
    rs = np.random.RandomState(10)
    data, want = _snappy_stream(rs)
    n, p = leveldb._get_varint(data, 0)
    # a preamble claiming more than the element stream makes
    pre = bytearray()
    leveldb._put_varint(pre, n + 5)
    bad = bytes(pre) + data[p:]
    assert native.snappy_uncompress(bad, n + 5) is None
    with pytest.raises(ValueError, match="snappy"):
        leveldb.snappy_decompress(bad)
    # a preamble past any valid expansion is refused before allocating
    huge = bytearray()
    leveldb._put_varint(huge, 1 << 40)
    huge = bytes(huge) + data[p:]
    assert native.snappy_uncompress(huge, 1 << 40) is None
    assert native.snappy_uncompress(data, -1) is None
    # a copy reaching before the start of the output
    pre = bytearray()
    leveldb._put_varint(pre, 8)
    early = bytes(pre) + bytes([1 | (4 << 2), 9])
    assert native.snappy_uncompress(early, 8) is None
    assert native.snappy_uncompress(data[:len(data) // 2], n) is None
