"""The port's record-fed training path against the JAX package's on the
CPU: DatumBatchSource's wrap-around and rand_skip, build_db_feed from a
stock-form prototxt, the data-source layers, the `train` verb on LMDB
records (3 steps from one caffemodel, with a record-shuffled control),
the `test` verb's scores, and one ImageNetApp round.

Fixtures are written here with the port's LMDB writer from seeded
images; the nets come from the zoo (cifar10_full at batch 8 under Data
layers, the stock train_val form). Tolerances: the verbs' losses and
scores within 1e-4 (f32 on both sides; XLA:CPU and PyTorch's CPU
convolutions sum in different orders, ~1e-6 apart); the record-shuffled
control must read above it. The app's round: each blob's change within
1e-3 of the JAX package's largest change in that blob (the parallel
solvers' limit, tests/test_torch_parallel.py).
"""

import os
import re

import numpy as np
import pytest
import torch

from sparknet_tpu import cli as jcli
from sparknet_tpu import native as jnative
from sparknet_tpu.apps import imagenet_app as jimagenet_app
from sparknet_tpu.data.db_source import DatumBatchSource as JSource
from sparknet_tpu.graph.registry import get as jget
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.data import prefetch
from sparknet_tpu_torch.data.datum import array_to_datum
from sparknet_tpu_torch.data.db_source import (DatumBatchSource,
                                               build_db_feed)
from sparknet_tpu_torch.data.lmdb import LMDBWriter
from sparknet_tpu_torch.data.synthetic import shape_texture_images
from sparknet_tpu_torch.graph import TRAIN, CompiledNet
from sparknet_tpu_torch.graph.registry import get as tget
from sparknet_tpu_torch.models import zoo
from sparknet_tpu_torch.proto import Message, text_format, wire
from sparknet_tpu_torch.tools import compute_image_mean

LOSS_LIMIT = 1e-4
APP_LIMIT = 1e-3


def _write_lmdb(path, n, seed, size=36, order=None):
    imgs, labels = shape_texture_images(n, seed=seed, size=size)
    order = range(n) if order is None else order
    with LMDBWriter(str(path)) as w:
        for key, i in enumerate(order):
            w.put(b"%05d" % key, array_to_datum(imgs[i], int(labels[i])))


def _data_layer(phase, source, batch, crop, mirror, mean_file):
    lp = Message("LayerParameter", name="data", type="Data",
                 data_param=dict(source=source, batch_size=batch,
                                 backend="LMDB"),
                 transform_param=dict(crop_size=crop, mirror=mirror,
                                      mean_file=mean_file))
    lp.top.append("data")
    lp.top.append("label")
    lp.add("include", phase=phase)
    return lp


def _train_val(train_src="train_lmdb", batch=8):
    """cifar10_full under stock Data layers: TRAIN random 32x32 crops of
    the 36x36 records with mirror, TEST center crops, both mean-file."""
    net = Message("NetParameter", name="CIFAR10_full_db")
    net.layer.append(_data_layer("TRAIN", train_src, batch, 32, True,
                                 "mean.binaryproto"))
    net.layer.append(_data_layer("TEST", "test_lmdb", batch, 32, False,
                                 "mean.binaryproto"))
    for lp in zoo.cifar10_full(batch_size=batch, with_data=False).layer:
        net.layer.append(lp)
    return net


@pytest.fixture(scope="module")
def db_tree(tmp_path_factory):
    """train/test LMDBs, a shuffled copy of train, the mean, a train_val
    and solver prototxt per train source, and one caffemodel."""
    d = tmp_path_factory.mktemp("db_tree")
    _write_lmdb(d / "train_lmdb", 40, seed=0)
    _write_lmdb(d / "test_lmdb", 16, seed=1)
    _write_lmdb(d / "shuffled_lmdb", 40, seed=0,
                order=np.random.RandomState(7).permutation(40))
    compute_image_mean(str(d / "train_lmdb"), str(d / "mean.binaryproto"),
                       log=lambda *a: None)
    for name, src in (("", "train_lmdb"), ("shuffled_", "shuffled_lmdb")):
        text_format.dump(_train_val(src), str(d / f"{name}train_val.prototxt"))
        sp = Message("SolverParameter", net=f"{name}train_val.prototxt",
                     base_lr=0.01, momentum=0.9, weight_decay=0.004,
                     lr_policy="fixed", display=1, test_iter=[2],
                     test_interval=2, max_iter=3, random_seed=5)
        text_format.dump(sp, str(d / f"{name}solver.prototxt"))
    # weights large enough that the loss depends on the records
    net = CompiledNet(_train_val(), TRAIN, device="cpu",
                      feed_shapes={"data": (8, 3, 32, 32), "label": (8,)})
    params, state = net.init(torch.Generator().manual_seed(3))
    rs = np.random.RandomState(4)
    for blobs in params.values():
        w = blobs[0]
        fan_in = int(np.prod(w.shape[1:]))
        w.copy_(torch.from_numpy((rs.randn(*w.shape) * np.sqrt(0.5 / fan_in))
                                 .astype(np.float32)))
    wire.dump(net.params_to_netproto(params, state),
              str(d / "start.caffemodel"))
    return d


# -- the source ----------------------------------------------------------

@pytest.mark.parametrize("device_mode", [False, True],
                         ids=["host-transform", "device-transform"])
@pytest.mark.parametrize("rand_skip", [0, 9])
def test_batch_source_wraps_and_skips_as_the_jax_source(db_tree, rand_skip,
                                                        device_mode):
    # 16 records, batch 6: the third batch wraps; rand_skip moves the
    # first pass's start only
    kw = dict(batch_size=6, phase=0, rand_skip=rand_skip, seed=12,
              device_transform=device_mode)
    tp = dict(crop_size=30, mirror=True, mean_value=[100.0, 110.0, 120.0])
    port = DatumBatchSource(str(db_tree / "test_lmdb"),
                            transform_param=Message(
                                "TransformationParameter", **tp), **kw)
    ref = JSource(str(db_tree / "test_lmdb"),
                  transform_param=JMessage("TransformationParameter", **tp),
                  **kw)
    assert port.shape == ref.shape == (6, 3, 30, 30)
    assert port.record_shape == ref.record_shape
    if device_mode:
        assert port.raw_feed_overrides == ref.raw_feed_overrides
    labels = []
    for got, want in zip(iter(port), iter(ref)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        labels.append(got["label"])
        if len(labels) == 6:
            break
    port.close()
    ref.close()
    # the records in order from the skip (the first draw of the source's
    # RandomState), wrapping at the end
    skip = np.random.RandomState(12).randint(0, rand_skip) if rand_skip \
        else 0
    _, want = shape_texture_images(16, seed=1, size=36)
    np.testing.assert_array_equal(np.concatenate(labels),
                                  want[(skip + np.arange(36)) % 16])


def _prototxt(tmp_path, text):
    p = tmp_path / "net.prototxt"
    p.write_text(text)
    return text_format.load(str(p), "NetParameter")


def test_build_db_feed_reads_a_stock_prototxt(db_tree, tmp_path,
                                              monkeypatch):
    net = text_format.load(str(db_tree / "train_val.prototxt"),
                           "NetParameter")
    shapes, src = build_db_feed(net, TRAIN, str(db_tree), seed=1)
    assert shapes == {"data": (8, 3, 32, 32), "label": (8,)}
    assert src.num_records == 40 and not src.device_mode
    src.close()
    # a source that does not exist: (None, None), the caller's synthetic
    # shapes
    assert build_db_feed(net, TRAIN, str(tmp_path)) == (None, None)
    # an ImageData source that exists is read (data/file_sources.py;
    # tests/test_torch_file_sources.py holds it against the JAX package)
    from PIL import Image
    Image.new("RGB", (5, 4), (10, 20, 30)).save(tmp_path / "a.png")
    (tmp_path / "list.txt").write_text("a.png 0\n")
    img = _prototxt(tmp_path, 'layer { name: "d" type: "ImageData" '
                    'top: "data" top: "label" image_data_param { '
                    'source: "list.txt" batch_size: 2 } }')
    shapes, src = build_db_feed(img, TRAIN, str(tmp_path))
    assert shapes == {"data": (2, 3, 4, 5), "label": (2,)}
    batch = next(iter(src))
    np.testing.assert_array_equal(batch["data"][1, :, 0, 0], [30, 20, 10])
    missing = _prototxt(tmp_path, 'layer { name: "d" type: "HDF5Data" '
                        'top: "data" hdf5_data_param { source: "no.txt" '
                        'batch_size: 2 } }')
    assert build_db_feed(missing, TRAIN, str(tmp_path)) == (None, None)
    # a wire mode that does not exist is an error, not the raw wire
    monkeypatch.setenv("SPARKNET_WIRE", "crop")
    with pytest.raises(ValueError, match="SPARKNET_WIRE"):
        build_db_feed(net, TRAIN, str(db_tree), device_transform=True)


def test_source_layers_take_the_jax_package_s_shapes():
    cases = [
        ("MemoryData", dict(memory_data_param=dict(batch_size=3, channels=2,
                                                   height=4, width=5)),
         ["data", "label"], {}),
        ("Data", dict(data_param=dict(batch_size=6)), ["data", "label"],
         {"data": (6, 3, 8, 8)}),
        ("WindowData", dict(window_data_param=dict(batch_size=2)), ["data"],
         {"data": (2, 3, 5, 5)}),
    ]
    for type_name, fields, tops, feed in cases:
        lps = [m("LayerParameter", name="d", type=type_name, top=tops,
                 **fields) for m in (Message, JMessage)]
        port = tget(type_name)(lps[0], [], 0, feed_shapes=feed)
        ref = jget(type_name)(lps[1], [], 0, feed_shapes=feed)
        assert port.out_shapes() == ref.out_shapes(), type_name
    dummy = dict(dummy_data_param=dict(
        shape=[dict(dim=[2, 3]), dict(dim=[4])],
        data_filler=[dict(type="constant", value=2.5)]))
    lp = Message("LayerParameter", name="d", type="DummyData",
                 top=["a", "b"], **dummy)
    port = tget("DummyData")(lp, [], 0)
    ref = jget("DummyData")(JMessage("LayerParameter", name="d",
                                     type="DummyData", top=["a", "b"],
                                     **dummy), [], 0)
    assert port.out_shapes() == ref.out_shapes() == [(2, 3), (4,)]
    port.device = torch.device("cpu")
    outs = port.apply([], [], True, None)
    assert [tuple(o.shape) for o in outs] == [(2, 3), (4,)]
    assert all(bool((o == 2.5).all()) for o in outs)


def test_h2d_stager_is_the_identity_on_the_cpu_and_runs_in_the_worker():
    batches = [{"data": np.full((2, 3), i, np.float32)} for i in range(4)]
    stager = prefetch.H2DStager(slots=2, device="cpu")
    assert stager(batches[0]) is batches[0]
    seen = []

    def mark(b):
        seen.append(int(b["data"][0, 0]))
        return stager(b)

    it = prefetch.PrefetchIterator(iter(batches), depth=2, transform=mark)
    got = [int(b["data"][0, 0]) for b in it]
    assert got == seen == [0, 1, 2, 3]
    assert it.close()
    assert prefetch.wait_staged(batches[1]) is batches[1]


# -- the verbs -----------------------------------------------------------

_LOSS = re.compile(r"Iteration (\d+), loss = ([-+.\de]+)")
_TEST = re.compile(r"Test net output: (\w+) = ([-+.\de]+)")


def _run(main, argv, capsys):
    assert main(argv) in (0, None)
    return capsys.readouterr().out


def _train_losses(out):
    return [float(v) for _, v in _LOSS.findall(out)], \
        [(k, float(v)) for k, v in _TEST.findall(out)]


def _jax_verb(db_tree, cache_mb, extra=(), kind="device-transform"):
    """The JAX verb's losses on the records; ``cache_mb`` None leaves
    SPARKNET_DEVICE_CACHE_MB unset (the default, the device cache on)."""
    import contextlib
    import io
    buf = io.StringIO()
    old = os.environ.pop("SPARKNET_DEVICE_CACHE_MB", None)
    if cache_mb is not None:
        os.environ["SPARKNET_DEVICE_CACHE_MB"] = cache_mb
    try:
        with contextlib.redirect_stdout(buf):
            jcli.main(["train", "--solver", str(db_tree / "solver.prototxt"),
                       "--weights", str(db_tree / "start.caffemodel"),
                       *extra])
    finally:
        os.environ.pop("SPARKNET_DEVICE_CACHE_MB", None)
        if old is not None:
            os.environ["SPARKNET_DEVICE_CACHE_MB"] = old
    out = buf.getvalue()
    assert f"40 records, {kind}" in out
    return _train_losses(out)


@pytest.fixture(scope="module")
def jax_train(db_tree):
    """The JAX verb's losses on the records, through its streaming
    device-transform feed (the device cache off)."""
    return _jax_verb(db_tree, "0")


def _assert_matches(out, jax_run):
    losses, tests = _train_losses(out)
    jlosses, jtests = jax_run
    assert len(losses) == len(jlosses) == 3 and len(tests) == len(jtests) == 4
    assert max(abs(a - b) for a, b in zip(losses, jlosses)) <= LOSS_LIMIT
    for (k, v), (jk, jv) in zip(tests, jtests):
        assert k == jk and abs(v - jv) <= LOSS_LIMIT, (k, v, jv)
    assert abs(losses[0] - np.log(10)) > 10 * LOSS_LIMIT   # not chance


@pytest.mark.parametrize("mode", ["device-transform", "host-transform"])
def test_train_verb_on_records_matches_the_jax_verb(db_tree, jax_train,
                                                    mode, capsys,
                                                    monkeypatch):
    # the streaming feeds: the device cache off, as in the JAX run
    monkeypatch.setenv("SPARKNET_DEVICE_CACHE_MB", "0")
    argv = ["train", "--solver", str(db_tree / "solver.prototxt"),
            "--weights", str(db_tree / "start.caffemodel"),
            "--device", "cpu"]
    out = _run(cli.main, argv + (["--host-transform"]
                                 if mode == "host-transform" else []),
               capsys)
    assert f"Training from " in out and f"40 records, {mode}" in out
    assert "synthetic" not in out
    _assert_matches(out, jax_train)


def test_train_verb_default_is_device_cached_as_the_jax_verb(db_tree,
                                                             capsys,
                                                             monkeypatch):
    monkeypatch.delenv("SPARKNET_DEVICE_CACHE_MB", raising=False)
    out = _run(cli.main, ["train", "--solver",
                          str(db_tree / "solver.prototxt"), "--weights",
                          str(db_tree / "start.caffemodel"), "--device",
                          "cpu"], capsys)
    assert "40 records, device-cached" in out
    _assert_matches(out, _jax_verb(db_tree, None, kind="device-cached"))


@pytest.mark.parametrize("flags", [
    ["--wire", "precrop"], ["--wire", "precrop+pack"], ["--staging", "off"]],
    ids=lambda f: " ".join(f))
def test_train_verb_feed_flags_keep_the_streaming_losses(db_tree, jax_train,
                                                         flags, capsys,
                                                         monkeypatch):
    # the flags write their env vars: monkeypatch restores them after
    for env in ("SPARKNET_WIRE", "SPARKNET_WIRE_BITS", "SPARKNET_STAGING",
                "SPARKNET_ECHO"):
        monkeypatch.setenv(env, "")
    monkeypatch.setenv("SPARKNET_DEVICE_CACHE_MB", "0")
    out = _run(cli.main, ["train", "--solver",
                          str(db_tree / "solver.prototxt"), "--weights",
                          str(db_tree / "start.caffemodel"), "--device",
                          "cpu", *flags], capsys)
    assert "40 records, device-transform" in out
    _assert_matches(out, jax_train)


def test_train_verb_dp_matches_the_jax_verb_s_dp(db_tree, capsys,
                                                 monkeypatch):
    monkeypatch.delenv("SPARKNET_DEVICE_CACHE_MB", raising=False)
    dp = ["--strategy", "dp", "--mesh", "data=2"]
    out = _run(cli.main, ["train", "--solver",
                          str(db_tree / "solver.prototxt"), "--weights",
                          str(db_tree / "start.caffemodel"), "--device",
                          "cpu", *dp], capsys)
    # dp streams: the cache is the single-device feed's, as in the JAX
    # verb, and the verb says so
    assert "40 records, device-transform" in out
    assert "device cache: off under --strategy dp" in out
    _assert_matches(out, _jax_verb(db_tree, None, extra=dp))


def test_train_verb_echo_and_refusals(db_tree, capsys, monkeypatch):
    for env in ("SPARKNET_WIRE", "SPARKNET_ECHO"):
        monkeypatch.setenv(env, "")
    argv = ["train", "--solver", str(db_tree / "solver.prototxt"),
            "--device", "cpu", "--iterations", "2"]
    monkeypatch.delenv("SPARKNET_DEVICE_CACHE_MB", raising=False)
    out = _run(cli.main, argv + ["--echo", "2"], capsys)
    assert "NOTE: --echo ignored for the device-cached feed" in out
    monkeypatch.setenv("SPARKNET_DEVICE_CACHE_MB", "0")
    out = _run(cli.main, argv + ["--echo", "2"], capsys)
    assert "device-transform" in out and "Optimization done, iter=2" in out
    assert "device cache: off under SPARKNET_DEVICE_CACHE_MB=0" in out
    for bad in (["--echo", "2", "--wire", "precrop"],
                ["--echo", "2", "--host-transform"]):
        with pytest.raises(SystemExit, match="--echo > 1"):
            cli.main(argv + bad)
        monkeypatch.setenv("SPARKNET_WIRE", "")
        monkeypatch.setenv("SPARKNET_ECHO", "")
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--strategy", "dp", "--mesh", "data=2,model=2"])
    assert e.value.code == 2
    assert "ROADMAP A5" in capsys.readouterr().err


def test_train_verb_control_shuffled_records_differ(db_tree, jax_train,
                                                    capsys):
    out = _run(cli.main, ["train", "--solver",
                          str(db_tree / "shuffled_solver.prototxt"),
                          "--weights", str(db_tree / "start.caffemodel"),
                          "--device", "cpu"], capsys)
    losses, _ = _train_losses(out)
    jlosses, _ = jax_train
    assert max(abs(a - b) for a, b in zip(losses, jlosses)) > LOSS_LIMIT


def test_train_verb_without_a_source_says_it_feeds_noise(db_tree, tmp_path,
                                                         capsys):
    text_format.dump(_train_val(), str(tmp_path / "train_val.prototxt"))
    sp = Message("SolverParameter", net="train_val.prototxt", base_lr=0.01,
                 lr_policy="fixed", display=1, max_iter=1, random_seed=5)
    text_format.dump(sp, str(tmp_path / "solver.prototxt"))
    out = _run(cli.main, ["train", "--solver",
                          str(tmp_path / "solver.prototxt"),
                          "--input-shape", "data=8,3,32,32",
                          "--input-shape", "label=8", "--device", "cpu"],
               capsys)
    assert "WARNING: no Data-layer LMDB source found; feeding synthetic " \
        "noise" in out and "Optimization done, iter=1" in out


def test_test_verb_scores_match_the_jax_verb(db_tree, capsys):
    argv = ["test", "--model", str(db_tree / "train_val.prototxt"),
            "--weights", str(db_tree / "start.caffemodel"),
            "--iterations", "2"]
    out = _run(cli.main, argv + ["--device", "cpu"], capsys)
    jout = _run(jcli.main, argv, capsys)
    score = re.compile(r"^(\w+) = (\S+)$", re.M)
    got = dict(score.findall(out))
    want = dict(score.findall(jout))
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= LOSS_LIMIT, k
    assert "Scoring on" in out and "16 records" in out


# -- the ImageNet app ----------------------------------------------------

def _comparable(caffenet):
    """zoo.caffenet without its two input-dependent discrete choices that
    f32 noise decides differently in the two packages: dropout masks
    (different generators) are off, and max pooling becomes average
    pooling. The packages' convolutions differ by ~1e-5 of their output
    (XLA:CPU and PyTorch's CPU kernels sum in different orders), and on
    the app's images, a fifth of whose pixels saturate at 0 or 255,
    that flips max pooling's choice among near-equal neighbours. With
    max pooling the round reads 4.3e-3 of conv1's change and 1.3e-2 of
    conv2's bias; with average pooling 1.6e-4 and, the worst blob,
    3.9e-4 of fc6's bias (biases at 1.0, whose f32 rounding the step
    moves by a few hundred ulps)."""
    def build(*a, **kw):
        net = caffenet(*a, **kw)
        for lp in net.layer:
            if lp.type == "Dropout":
                lp.dropout_param.dropout_ratio = 0.0
            if lp.type == "Pooling":
                lp.pooling_param.pool = "AVE"
        return net
    return build


def test_imagenet_app_round_matches_the_jax_app(tmp_path, monkeypatch):
    monkeypatch.setattr(jimagenet_app.zoo, "caffenet",
                        _comparable(jimagenet_app.zoo.caffenet))
    monkeypatch.setattr(imagenet_app.zoo, "caffenet",
                        _comparable(imagenet_app.zoo.caffenet))
    monkeypatch.setattr(jnative, "_load", lambda: None)
    kw = dict(num_workers=2, tau=1, batch=4, num_classes=10)
    japp = jimagenet_app.ImageNetApp(**kw)
    app = imagenet_app.ImageNetApp(device="cpu", **kw)
    np.testing.assert_array_equal(app.mean_image, japp.mean_image)
    # the round's batch: the JAX app's host-transformed float32 crops, and
    # the port's uint8 images with the same draws, transformed as the
    # solver transforms them
    want = next(japp._round_stream())
    raw = next(app._round_stream())
    assert raw["data"].dtype == np.uint8 and \
        raw["data"].shape == (1, 8, 3, 256, 256)
    got = app._device_fn({k: torch.from_numpy(v[0]) for k, v in raw.items()})
    np.testing.assert_array_equal(got["data"].numpy(), want["data"][0])
    np.testing.assert_array_equal(got["label"].numpy(), want["label"][0])
    # one round each from the same weights, on the next batch of each
    _, state = japp.solver.snapshot(str(tmp_path / "start"))
    app.solver.restore(state)
    w0 = {n: [np.asarray(p, np.float64) for p in ps]
          for n, ps in japp.solver.params.items()}
    japp.run(num_rounds=1, test_every=0)
    app.run(num_rounds=1, test_every=0)
    assert app.solver.iter == japp.solver.iter == 1
    worst = 0.0
    for n, ps in japp.solver.params.items():
        for i, p in enumerate(ps):
            ref = np.asarray(p, np.float64) - w0[n][i]
            got = app.solver.params[n][i].detach().numpy() - w0[n][i]
            scale = max(float(np.abs(ref).max()), 1e-30)
            worst = max(worst, float(np.abs(got - ref).max()) / scale)
    assert worst <= APP_LIMIT, worst


def test_imagenet_verb_runs_rounds_on_the_cpu(capsys):
    out = _run(cli.main, ["imagenet", "--device", "cpu", "--workers", "2",
                          "--tau", "1", "--batch", "2", "--classes", "10",
                          "--rounds", "2", "--test-every", "1"], capsys)
    losses = [float(v) for v in re.findall(r"round \d+: loss = (\S+),", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(re.findall(r"images/s", out)) == 2
    assert "test accuracy" in out and "done: 2 rounds, iter=2" in out


@pytest.mark.parametrize("flags", [
    ["--shard-ingest", "on"], ["--reshard", "auto"], ["--staleness", "1"],
    ["--heartbeat-dir", "hb"], ["--lease-s", "3"], ["--grow"],
    ["--chaos", "nan_step=1"], ["--quorum", "2"]],
    ids=lambda f: f[0])
def test_train_verb_refuses_unported_flags_naming_the_roadmap(db_tree, flags,
                                                              capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--solver", str(db_tree / "solver.prototxt"),
                  "--device", "cpu", *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP A" in err
