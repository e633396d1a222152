"""The port's input transforms against the JAX package's on the CPU:
DataTransformer in both phases with every mean kind, scale and mirror;
the ImageNet app's transform_train / transform_test; the port's device
transform (PyTorch ops, here on the CPU) against the JAX package's
DeviceTransformer.device_fn; and the host and device paths drawing one
RandomState stream.

The JAX package's host transforms run through its numpy path (its native
library is patched out), the path the port copies. Every comparison is
exact: both sides do the same float32 operations in the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sparknet_tpu import native as jnative
from sparknet_tpu.data import transforms as jtransforms
from sparknet_tpu.data.device_transform import \
    build_device_transformer as jbuild_device_transformer
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.data import transforms
from sparknet_tpu_torch.data.device_transform import (
    aux_keys, build_device_transformer, transform_batch)
from sparknet_tpu_torch.proto import Message as TMessage


@pytest.fixture(autouse=True)
def jax_numpy_path(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)


def _images(n=6, c=3, h=12, w=14, seed=0, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, (n, c, h, w)).astype(np.uint8)
    return (50 * rs.randn(n, c, h, w)).astype(np.float32)


@pytest.fixture(scope="module")
def mean_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mean") / "mean.binaryproto")
    mean = (128 + 20 * np.random.RandomState(9).randn(3, 12, 14)) \
        .astype(np.float32)
    transforms.save_mean_binaryproto(mean, path)
    return path


# (phase, transform_param fields); "MEAN" stands for the mean file
CASES = [
    pytest.param(0, dict(crop_size=9, mirror=True), id="train-crop-mirror"),
    pytest.param(1, dict(crop_size=9, mirror=True), id="test-center-mirror"),
    pytest.param(0, dict(crop_size=9, mirror=True, mean_file="MEAN"),
                 id="train-full-mean"),
    pytest.param(1, dict(crop_size=9, mean_file="MEAN", scale=0.0039),
                 id="test-full-mean-scale"),
    pytest.param(0, dict(crop_size=9, mirror=True,
                         mean_value=[104.0, 117.0, 123.0], scale=0.017),
                 id="train-channel-mean-scale"),
    pytest.param(0, dict(crop_size=7, mean_value=[120.5]),
                 id="train-one-mean-value"),
    pytest.param(0, dict(mirror=True, mean_file="MEAN", scale=0.5),
                 id="no-crop-full-mean"),
    pytest.param(1, dict(mirror=True, mean_value=[1.0, 2.0, 3.0]),
                 id="no-crop-channel-mean"),
]


def _tp(message, fields, mean_file):
    fields = {k: (mean_file if v == "MEAN" else v) for k, v in fields.items()}
    return message("TransformationParameter", **fields)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
@pytest.mark.parametrize("phase,fields", CASES)
def test_data_transformer_equals_the_jax_numpy_path(phase, fields, dtype,
                                                    mean_file):
    images = _images(dtype=dtype)
    port = transforms.DataTransformer(_tp(TMessage, fields, mean_file),
                                      phase=phase,
                                      rng=np.random.RandomState(3))
    ref = jtransforms.DataTransformer(_tp(JMessage, fields, mean_file),
                                      phase=phase,
                                      rng=np.random.RandomState(3))
    for _ in range(2):                  # the rng streams stay together
        got, want = port(images), ref(images)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert port.output_shape(images.shape[1:]) == \
        ref.output_shape(images.shape[1:])


@pytest.mark.parametrize("mean", ["none", "image", "channel"])
def test_app_transforms_equal_the_jax_package_s(mean):
    images = _images(n=5, h=16, w=16, seed=1)
    m = {"none": None,
         "image": (100 + 10 * np.random.RandomState(2).randn(3, 16, 16))
         .astype(np.float32),
         "channel": np.array([10.0, 20.0, 30.0], np.float32)}[mean]
    got = transforms.transform_train(images, 11, mean=m,
                                     rng=np.random.RandomState(4))
    want = jtransforms.transform_train(images, 11, mean=m,
                                       rng=np.random.RandomState(4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        transforms.transform_test(images, 11, mean=m, scale=0.25),
        jtransforms.transform_test(images, 11, mean=m, scale=0.25))
    batches = [images, images[:2]]
    np.testing.assert_array_equal(
        transforms.compute_mean(iter(batches), (3, 16, 16)),
        jtransforms.compute_mean(iter(batches), (3, 16, 16)))


@pytest.mark.parametrize("phase,fields", CASES)
def test_device_transform_equals_the_jax_device_fn(phase, fields,
                                                   mean_file):
    images = _images(seed=2)
    port = build_device_transformer(_tp(TMessage, fields, mean_file),
                                    phase=phase,
                                    rng=np.random.RandomState(5))
    ref = jbuild_device_transformer(_tp(JMessage, fields, mean_file),
                                    phase=phase,
                                    rng=np.random.RandomState(5))
    aux = port.aux(len(images), images.shape[1:])
    jaux = ref.aux(len(images), images.shape[1:])
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_array_equal(aux[k], jaux[k])
    assert port.raw_overrides(6, images.shape[1:]) == \
        ref.raw_overrides(6, images.shape[1:])
    labels = np.arange(len(images), dtype=np.int32)
    got = port.device_fn()({"data": torch.from_numpy(images),
                            "label": torch.from_numpy(labels),
                            **{k: torch.from_numpy(v)
                               for k, v in aux.items()}})
    want = ref.device_fn()({"data": jnp.asarray(images),
                            "label": jnp.asarray(labels),
                            **{k: jnp.asarray(v) for k, v in aux.items()}})
    assert sorted(got) == sorted(want) == ["data", "label"]
    np.testing.assert_array_equal(got["data"].numpy(),
                                  np.asarray(want["data"]))
    np.testing.assert_array_equal(got["label"].numpy(), labels)


@pytest.mark.parametrize("phase", [0, 1], ids=["train", "test"])
def test_host_and_device_modes_share_one_rng_stream(phase, mean_file):
    """A source switched between host and device modes sees the same
    augmentation: the device transformer draws what DataTransformer
    draws, and the device output equals the host output, batch after
    batch."""
    images = _images(n=10, seed=8)
    fields = dict(crop_size=8, mirror=True, mean_file=mean_file)
    host = transforms.DataTransformer(_tp(TMessage, fields, mean_file),
                                      phase=phase,
                                      rng=np.random.RandomState(11))
    dev = build_device_transformer(_tp(TMessage, fields, mean_file),
                                   phase=phase,
                                   rng=np.random.RandomState(11))
    fn = dev.device_fn()
    outs = []
    for _ in range(3):
        aux = dev.aux(len(images), images.shape[1:])
        got = fn({"data": torch.from_numpy(images),
                  **{k: torch.from_numpy(v) for k, v in aux.items()}})
        want = host(images)
        np.testing.assert_array_equal(got["data"].numpy(), want)
        outs.append(want)
    # the draws move: TRAIN crops and both phases' flips differ per batch
    assert not np.array_equal(outs[0], outs[1])


def test_device_transform_control_a_shifted_offset_differs():
    # the equality above is not vacuous: one column of shift shows
    images = _images(seed=9)
    ys = np.array([1, 0, 2, 3, 1, 0], np.int32)
    xs = np.array([0, 4, 1, 2, 3, 4], np.int32)
    ref = transforms.transform_batch(images, 9, ys=ys, xs=xs)
    np.testing.assert_array_equal(
        transform_batch(torch.from_numpy(images), 9, ys=ys, xs=xs).numpy(),
        ref)
    shifted = transform_batch(torch.from_numpy(images), 9, ys=ys,
                              xs=xs + 1).numpy()
    assert np.abs(shifted - ref).max() > 0


def test_transforms_refuse_a_mean_of_the_wrong_shape():
    images = _images()
    with pytest.raises(ValueError, match="mean shape"):
        transforms.transform_batch(images, 9, mean=np.zeros((3, 8, 8)))
    with pytest.raises(ValueError, match="full mean shape"):
        transform_batch(torch.from_numpy(images), 9,
                        mean=np.zeros((3, 9, 9)), full_mean=True)
    tp = TMessage("TransformationParameter", crop_size=9,
                  mean_value=[1.0, 2.0])
    with pytest.raises(ValueError, match="mean_value count"):
        transforms.DataTransformer(tp)(images)
    assert aux_keys("img") == ("img#y", "img#x", "img#flip")
