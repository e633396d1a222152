"""The port's file-backed sources (data/file_sources.py) and their
build_db_feed dispatch against the JAX package's on the CPU: ImageData
(PIL decode, BGR order, BILINEAR resize, shuffle on each epoch),
HDF5Data (row and file shuffles), MemoryData and WindowData (fg/bg
sampling, context_pad, crop_mode), each over two epochs with the same
seed. Batches must be equal, exactly: both packages run the same numpy
and PIL calls in the same order. Also the `test` verb on an ImageData
net, the HDF5Output sink, and the cache_images warning.

The images (8 of 8x10 RGB, 3 of 24x24 for the windows) and the .h5
files are written here from seeds.
"""

import re

import numpy as np
import pytest
import torch

from sparknet_tpu import cli as jcli
from sparknet_tpu.data import file_sources as jfs
from sparknet_tpu.data.db_source import build_db_feed as jbuild_db_feed
from sparknet_tpu.graph.registry import get as jget
from sparknet_tpu.proto import Message as JMessage
from sparknet_tpu_torch import cli
from sparknet_tpu_torch.data import file_sources as fs
from sparknet_tpu_torch.data.db_source import build_db_feed
from sparknet_tpu_torch.graph import TEST, TRAIN, CompiledNet
from sparknet_tpu_torch.graph.registry import get as tget
from sparknet_tpu_torch.proto import Message, text_format, wire

N_IMAGES = 8


def _equal_batches(port, ref, n):
    for _, got, want in zip(range(n), iter(port), iter(ref)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """N_IMAGES random 8x10 RGB PNGs and their listfile."""
    from PIL import Image
    d = tmp_path_factory.mktemp("images")
    rs = np.random.RandomState(0)
    lines = []
    for i in range(N_IMAGES):
        Image.fromarray(rs.randint(0, 256, (8, 10, 3)).astype(np.uint8)) \
            .save(d / f"im{i}.png")
        lines.append(f"im{i}.png {i % 3}")
    (d / "list.txt").write_text("\n".join(lines) + "\n")
    return d


def _image_sources(images, **kw):
    base = dict(batch_size=3, root_folder=str(images), seed=4)
    base.update(kw)
    tp = base.pop("tp", None)
    return (fs.ImageDataSource(
                str(images / "list.txt"), transform_param=tp and Message(
                    "TransformationParameter", **tp), **base),
            jfs.ImageDataSource(
                str(images / "list.txt"), transform_param=tp and JMessage(
                    "TransformationParameter", **tp), **base))


@pytest.mark.parametrize("case", [
    dict(),
    dict(shuffle=True, rand_skip=5),
    dict(new_height=12, new_width=9, shuffle=True,
         tp=dict(crop_size=6, mirror=True, mean_value=[100.0, 90, 80])),
    dict(is_color=False, phase=1, tp=dict(crop_size=6, mirror=True,
                                          scale=0.5))],
    ids=["plain", "shuffle-skip", "resize-crop-mirror", "gray-test"])
def test_image_data_equals_the_jax_source_over_two_epochs(images, case):
    port, ref = _image_sources(images, **case)
    assert port.shape == ref.shape and port.record_shape == ref.record_shape
    # 8 records in batches of 3: 6 batches span two shuffled epochs and
    # more
    _equal_batches(port, ref, 6)


def test_image_data_refuses_half_a_resize(images):
    with pytest.raises(ValueError, match="new_height"):
        fs.ImageDataSource(str(images / "list.txt"), 2,
                           root_folder=str(images), new_height=4)


def _write_h5(path, rows, seed, extra_top=True):
    import h5py
    rs = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        f["data"] = rs.randn(rows, 2, 4, 4).astype(np.float32)
        f["label"] = rs.randint(0, 5, rows).astype(np.float32)
        if extra_top:
            f["aux"] = rs.randn(rows, 3).astype(np.float32)


@pytest.mark.parametrize("shuffle", [False, True])
def test_hdf5_data_equals_the_jax_source_over_two_epochs(tmp_path,
                                                         shuffle):
    for i, rows in enumerate((5, 4)):
        _write_h5(str(tmp_path / f"p{i}.h5"), rows, seed=i)
    (tmp_path / "list.txt").write_text("p0.h5\np1.h5\n")
    tops = ["data", "label", "aux"]
    port = fs.HDF5DataSource(str(tmp_path / "list.txt"), 4, tops,
                             shuffle=shuffle, seed=3)
    ref = jfs.HDF5DataSource(str(tmp_path / "list.txt"), 4, tops,
                             shuffle=shuffle, seed=3)
    assert port.shape == ref.shape and port.num_records == 9
    _equal_batches(port, ref, 5)        # 20 rows: two epochs and more
    _write_h5(str(tmp_path / "bad.h5"), 3, 0, extra_top=False)
    (tmp_path / "bad.txt").write_text("bad.h5\n")
    with pytest.raises(KeyError, match="aux"):
        fs.HDF5DataSource(str(tmp_path / "bad.txt"), 2, tops)


def test_memory_data_cycles_and_resets_as_the_jax_source():
    rs = np.random.RandomState(0)
    data, labels = rs.randn(6, 1, 2, 2), rs.randint(0, 4, 6)
    port, ref = fs.MemoryDataSource(3, data, labels), \
        jfs.MemoryDataSource(3, data, labels)
    _equal_batches(port, ref, 3)
    for s in (port, ref):
        s.reset(data[:3] * 2, labels[:3])
    _equal_batches(port, ref, 2)
    with pytest.raises(ValueError, match="divisible"):
        port.reset(data[:4], labels[:4])


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("windows")
    rs = np.random.RandomState(0)
    lines = []
    for i in range(3):
        Image.fromarray(rs.randint(0, 256, (24, 24, 3)).astype(np.uint8)) \
            .save(d / f"img{i}.png")
        lines += [f"# {i}", f"img{i}.png", "3", "24", "24", "4",
                  f"{i + 1} 0.9 2 2 12 12", f"{i + 1} 0.8 5 5 23 20",
                  "0 0.1 0 0 8 8", "0 0.3 10 3 22 21"]
    (d / "windows.txt").write_text("\n".join(lines) + "\n")
    return d


@pytest.mark.parametrize("case", [
    dict(),
    dict(context_pad=4, mirror=True),
    dict(crop_mode="square", context_pad=2, mirror=True, mean="values"),
    dict(fg_fraction=0.5, mirror=True, mean="file")],
    ids=["warp", "context-pad-mirror", "square-mean_value", "mean_file"])
def test_window_data_equals_the_jax_source(windows, case):
    case = dict(case)
    tp = dict(crop_size=16, mirror=case.pop("mirror", False))
    mean = case.pop("mean", None)
    if mean == "values":
        tp["mean_value"] = [100.0, 110.0, 120.0]
    elif mean == "file":
        from sparknet_tpu_torch.data.transforms import save_mean_binaryproto
        save_mean_binaryproto(np.random.RandomState(1).rand(3, 20, 20)
                              .astype(np.float32) * 100,
                              str(windows / "mean.binaryproto"))
        tp["mean_file"] = "mean.binaryproto"
    kw = dict(batch_size=8, seed=2, root_folder=str(windows),
              base_dir=str(windows), **case)
    path = str(windows / "windows.txt")
    port = fs.WindowDataSource(path, transform_param=Message(
        "TransformationParameter", **tp), **kw)
    ref = jfs.WindowDataSource(path, transform_param=JMessage(
        "TransformationParameter", **tp), **kw)
    assert (len(port.fg), len(port.bg)) == (len(ref.fg), len(ref.bg)) == \
        (6, 6)
    _equal_batches(port, ref, 3)


def _layer(M, type_name, field, params, tp=None):
    lp = M("LayerParameter", name="d", type=type_name, top=["data", "label"],
           **{field: params})
    if tp:
        lp.transform_param = M("TransformationParameter", **tp)
    net = M("NetParameter", name="t")
    net.layer.append(lp)
    return net


def test_build_db_feed_dispatches_each_source_as_the_jax_package(
        images, windows, tmp_path):
    _write_h5(str(tmp_path / "a.h5"), 4, 0, extra_top=False)
    (tmp_path / "h5list.txt").write_text("a.h5\n")
    cases = [
        ("ImageData", "image_data_param",
         dict(source="list.txt", batch_size=2, shuffle=True), images,
         dict(crop_size=6)),
        ("WindowData", "window_data_param",
         dict(source="windows.txt", batch_size=4, fg_fraction=0.5),
         windows, dict(crop_size=16)),
        ("HDF5Data", "hdf5_data_param",
         dict(source="h5list.txt", batch_size=2), tmp_path, None)]
    for type_name, field, params, base, tp in cases:
        shapes, src = build_db_feed(
            _layer(Message, type_name, field, params, tp), TRAIN,
            str(base), seed=1)
        jshapes, jsrc = jbuild_db_feed(
            _layer(JMessage, type_name, field, params, tp), TRAIN,
            str(base), seed=1)
        assert type(src).__name__ == type(jsrc).__name__
        assert shapes == jshapes, type_name
        _equal_batches(src, jsrc, 2)
    missing = _layer(Message, "ImageData", "image_data_param",
                     dict(source="nope.txt", batch_size=2))
    assert build_db_feed(missing, TRAIN, str(images)) == (None, None)


def test_window_data_cache_images_is_ignored_with_a_warning(windows):
    net = _layer(Message, "WindowData", "window_data_param",
                 dict(source="windows.txt", batch_size=4, cache_images=True),
                 dict(crop_size=16))
    with pytest.warns(UserWarning, match="cache_images"):
        _, src = build_db_feed(net, TRAIN, str(windows), seed=0)
    assert src.shape == (4, 3, 16, 16)


def test_test_verb_scores_an_image_data_net_as_the_jax_verb(images,
                                                            capsys):
    net = _layer(Message, "ImageData", "image_data_param",
                 dict(source="list.txt", batch_size=4), dict(crop_size=6))
    for lp in text_format.loads("""
        layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
                inner_product_param { num_output: 3
                  weight_filler { type: "gaussian" std: 0.1 } } }
        layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip"
                bottom: "label" top: "loss" }
        layer { name: "acc" type: "Accuracy" bottom: "ip" bottom: "label"
                top: "acc" }""", "NetParameter").layer:
        net.layer.append(lp)
    path = images / "net.prototxt"
    text_format.dump(net, str(path))
    cn = CompiledNet(net, TEST, device="cpu",
                     feed_shapes={"data": (4, 3, 6, 6), "label": (4,)})
    params, state = cn.init(torch.Generator().manual_seed(1))
    wire.dump(cn.params_to_netproto(params, state), str(images / "w.cm"))
    argv = ["test", "--model", str(path), "--weights",
            str(images / "w.cm"), "--iterations", "3"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert jcli.main(argv) == 0
    jout = capsys.readouterr().out
    score = re.compile(r"^(\w+) = (\S+)$", re.M)
    got, want = dict(score.findall(out)), dict(score.findall(jout))
    assert sorted(got) == sorted(want) == ["acc", "loss"]
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5, k
    assert f"Scoring on {images / 'list.txt'} ({N_IMAGES} records)" in out


def test_hdf5_output_is_a_sink_as_in_the_jax_package():
    lps = [M("LayerParameter", name="out", type="HDF5Output",
             bottom=["a", "b"]) for M in (Message, JMessage)]
    port = tget("HDF5Output")(lps[0], [(2, 3), (2,)], 0)
    ref = jget("HDF5Output")(lps[1], [(2, 3), (2,)], 0)
    assert port.out_shapes() == ref.out_shapes() == []
    assert port.apply([], [torch.zeros(2, 3), torch.zeros(2)], True) == []
    net = text_format.loads("""
        input: "a" input_shape { dim: 2 dim: 3 }
        layer { name: "ip" type: "InnerProduct" bottom: "a" top: "b"
                inner_product_param { num_output: 2 } }
        layer { name: "out" type: "HDF5Output" bottom: "a" bottom: "b" }
    """, "NetParameter")
    cn = CompiledNet(net, TEST, device="cpu")
    # the sink consumes its bottoms: the net has no output blob left
    assert cn.output_blobs == []
    params, state = cn.init()
    blobs, _ = cn.apply(params, state, {"a": np.ones((2, 3), np.float32)})
    assert tuple(blobs["b"].shape) == (2, 2)
