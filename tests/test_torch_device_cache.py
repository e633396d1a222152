"""The port's device-cached feed (data/device_cache.py) against the JAX
package's, and against the port's own streaming feed, on the CPU.

The records are written here with the port's LMDB writer from seeded
images (20 records of 3x12x12 uint8, batch 6, so the cursor wraps in
the fourth batch). Equality is exact: the cache moves where the records
live, never the float32 op order of the transform.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu.data.db_source import DatumBatchSource as JSource
from sparknet_tpu.data.device_cache import \
    maybe_device_cache as jmaybe_device_cache
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch.data.datum import array_to_datum
from sparknet_tpu_torch.data.db_source import DatumBatchSource
from sparknet_tpu_torch.data.device_cache import (DeviceCachedSource,
                                                  maybe_device_cache)
from sparknet_tpu_torch.data.lmdb import LMDBWriter
from sparknet_tpu_torch.models import zoo
from sparknet_tpu_torch.proto import Message
from sparknet_tpu_torch.solver import Solver
from sparknet_tpu_torch.tools import compute_image_mean

N, BATCH = 20, 6


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache_db")
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (N, 3, 12, 12)).astype(np.uint8)
    labels = rs.randint(0, 10, N)
    with LMDBWriter(str(d / "db")) as w:
        for i in range(N):
            w.put(b"%05d" % i, array_to_datum(imgs[i], int(labels[i])))
    compute_image_mean(str(d / "db"), str(d / "mean.binaryproto"),
                       log=lambda *a: None)
    return d


# transform configs: crop + mirror + full mean; crop + per-channel mean
# and scale, with rand_skip; no crop, mirror; the TEST phase's center
# crop
CONFIGS = {
    "crop-mirror-mean_file": (0, dict(crop_size=10, mirror=True,
                                      mean_file="mean.binaryproto"), 0),
    "crop-mean_value-skip": (0, dict(crop_size=8, scale=0.5,
                                     mean_value=[100.0, 110.0, 120.0]), 7),
    "mirror-no-crop": (0, dict(mirror=True), 0),
    "test-center-crop": (1, dict(crop_size=10,
                                 mean_file="mean.binaryproto"), 0),
}


def _sources(db, config, seed=5):
    phase, tp, skip = CONFIGS[config]
    kw = dict(batch_size=BATCH, phase=phase, rand_skip=skip, seed=seed,
              base_dir=str(db), device_transform=True)
    port = DatumBatchSource(
        str(db / "db"), transform_param=Message("TransformationParameter",
                                                **tp), **kw)
    ref = JSource(str(db / "db"),
                  transform_param=JMessage("TransformationParameter", **tp),
                  **kw)
    return port, ref


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cached_feed_equals_the_jax_cache_and_the_streaming_feed(db,
                                                                 config):
    port, ref = _sources(db, config)
    stream, _ = _sources(db, config)
    cached = maybe_device_cache(port, device="cpu", log_fn=None)
    jcached = jmaybe_device_cache(ref)
    assert isinstance(cached, DeviceCachedSource)
    assert type(jcached).__name__ == "DeviceCachedSource"
    assert cached.nbytes == jcached.nbytes
    assert cached.raw_feed_overrides == {
        k: v for k, v in jcached.raw_feed_overrides.items()
        if not k.endswith(("#cacheimg", "#cachelab"))}
    fn, jfn, sfn = cached.device_fn, jcached.device_fn, stream.device_fn
    for got_b, want_b, raw_b in zip(iter(cached), iter(jcached),
                                    iter(stream)):
        # the control array is the only entry shipped
        assert list(got_b) == ["data#ctl"]
        np.testing.assert_array_equal(got_b["data#ctl"],
                                      want_b["data#ctl"])
        got = fn(_torch_batch(got_b))
        want = jfn(want_b)
        streamed = sfn(_torch_batch(raw_b))
        assert sorted(got) == sorted(want) == ["data", "label"]
        for k in ("data", "label"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            np.testing.assert_array_equal(got[k].numpy(),
                                          streamed[k].numpy())
        if int(got_b["data#ctl"][-1, 0]) < BATCH:   # wrapped: enough
            break
    else:
        pytest.fail("the cursor never wrapped")
    for s in (cached, jcached, stream):
        s.close()


def test_cached_test_passes_restart_from_record_zero(db):
    port, _ = _sources(db, "test-center-crop")
    cached = maybe_device_cache(port, device="cpu", log_fn=None)
    firsts = [next(iter(cached))["data#ctl"] for _ in range(2)]
    np.testing.assert_array_equal(firsts[0], firsts[1])
    np.testing.assert_array_equal(firsts[0][:, 0], np.arange(BATCH))
    cached.close()


def test_chunked_upload_fills_one_tensor(db, monkeypatch):
    port, _ = _sources(db, "mirror-no-crop")
    monkeypatch.setenv("SPARKNET_CACHE_CHUNK_MB", "0.002")   # ~4 records
    chunked = DeviceCachedSource(port, "cpu")
    port, _ = _sources(db, "mirror-no-crop")
    monkeypatch.setenv("SPARKNET_CACHE_CHUNK_MB", "1024")
    whole = DeviceCachedSource(port, "cpu")
    np.testing.assert_array_equal(chunked._images.numpy(),
                                  whole._images.numpy())
    np.testing.assert_array_equal(chunked._labels.numpy(),
                                  whole._labels.numpy())
    assert chunked._images.shape == (N, 3, 12, 12)


@pytest.mark.parametrize("budget_mb, iter_size, chunk_mb", [
    (1.0, 1, "32"),          # fits
    (1e-3, 1, "32"),         # over the budget
    (1.0, 2, "32"),          # iter_size > 1
    # 8.5 KiB of records: fits once (12 KiB), not twice once the
    # dataset is larger than a chunk
    (12 / 1024, 1, "32"), (12 / 1024, 1, "0.002")])
def test_promotion_gate_is_the_jax_gate(db, monkeypatch, budget_mb,
                                        iter_size, chunk_mb):
    monkeypatch.setenv("SPARKNET_CACHE_CHUNK_MB", chunk_mb)
    port, ref = _sources(db, "mirror-no-crop")
    said = []
    got = maybe_device_cache(port, budget_mb, iter_size=iter_size,
                             device="cpu", log_fn=said.append)
    want = jmaybe_device_cache(ref, budget_mb, iter_size=iter_size)
    promoted = want is not ref
    assert (got is not port) == promoted
    # a refusal is said on one line, never silent
    assert len(said) == (not promoted) and \
        all("\n" not in s and "streams" in s for s in said)
    for s in (got, want):
        s.close()


def test_host_mode_source_streams_and_says_so(db):
    tp = Message("TransformationParameter", crop_size=8)
    src = DatumBatchSource(str(db / "db"), BATCH, transform_param=tp)
    said = []
    assert maybe_device_cache(src, device="cpu", log_fn=said.append) is src
    assert len(said) == 1 and "not a device-mode" in said[0]
    src.close()


def test_solver_takes_the_control_array_as_its_only_feed(db):
    port, _ = _sources(db, "crop-mirror-mean_file")
    cached = maybe_device_cache(port, device="cpu", log_fn=None)
    sp = Message("SolverParameter", base_lr=0.01, lr_policy="fixed",
                 display=0, random_seed=1)
    s = Solver(sp, net_param=zoo.cifar10_full(batch_size=BATCH),
               device="cpu", log_fn=None,
               feed_shapes={"data": (BATCH, 3, 10, 10), "label": (BATCH,)})
    s.set_input_transform(cached.device_fn, cached.raw_feed_overrides)
    # the resident blobs are not host-fed: only the control array is
    # checked, at its (B, k) shape
    assert s.input_shapes() == {"data#ctl": (BATCH, 4)}
    it = iter(cached)
    loss = s.train_step(next(it))
    assert np.isfinite(float(loss)) and s.iter == 1
    with pytest.raises(ValueError, match="data#ctl"):
        s.check_batch({"data#ctl": np.zeros((BATCH, 3), np.int32)})
    cached.close()
