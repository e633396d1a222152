"""The port's record formats and record tools against the JAX package's on
the CPU: the Datum codec, LMDB and LevelDB files written by either
package and read by the other, the two LMDB writers' bytes, and the
convert_cifar_data and compute_image_mean tools.

Every fixture is made here with a seed (numpy images, the packages' own
writers); none comes from a stock Caffe tree. The comparisons are exact:
the formats are bytes, and the mean image is an integer sum over a count
in both packages.
"""

import io
import os

import numpy as np
import pytest

from sparknet_tpu import tools as jtools
from sparknet_tpu.data import datum as jdatum
from sparknet_tpu.data.leveldb import (LevelDBReader as JLevelDBReader,
                                       LevelDBWriter as JLevelDBWriter)
from sparknet_tpu.data.lmdb import (LMDBReader as JLMDBReader,
                                    LMDBWriter as JLMDBWriter)
from sparknet_tpu_torch import tools
from sparknet_tpu_torch.data import datum
from sparknet_tpu_torch.data.db_source import open_db
from sparknet_tpu_torch.data.leveldb import (LevelDBReader, LevelDBWriter,
                                             snappy_compress,
                                             snappy_decompress)
from sparknet_tpu_torch.data.lmdb import LMDBReader, LMDBWriter
from sparknet_tpu_torch.data.transforms import load_mean_binaryproto


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return [
        (rs.randint(0, 256, (3, 8, 9)).astype(np.uint8), 7),
        (rs.randint(0, 256, (1, 5, 5)).astype(np.uint8), 0),
        (rs.randn(2, 3, 4).astype(np.float32), 3),
        (rs.randint(0, 256, (3, 32, 32)).astype(np.uint8), 9),
    ]


@pytest.mark.parametrize("i", range(4), ids=["u8", "gray", "float", "cifar"])
def test_datum_round_trips_against_the_jax_codec(i):
    arr, label = _arrays(0)[i]
    buf = datum.array_to_datum(arr, label)
    assert buf == jdatum.array_to_datum(arr, label)
    for parse in (datum.datum_to_array, jdatum.datum_to_array):
        got, lab = parse(buf)
        assert lab == label and got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
    assert datum.parse_datum(buf)[:3] == jdatum.parse_datum(buf)[:3]


def test_encoded_datum_decodes_as_the_jax_codec():
    from PIL import Image
    rgb = np.random.RandomState(1).randint(0, 256, (6, 7, 3)).astype(np.uint8)
    png = io.BytesIO()
    Image.fromarray(rgb).save(png, format="PNG")
    buf = datum.encoded_datum(png.getvalue(), label=4)
    assert buf == jdatum.encoded_datum(png.getvalue(), label=4)
    got, lab = datum.datum_to_array(buf)
    ref, _ = jdatum.datum_to_array(buf)
    assert lab == 4
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, rgb[:, :, ::-1].transpose(2, 0, 1))


def _records(kind, seed=0):
    """(key, value) puts: small inline values, values past a page
    (overflow runs), or enough keys for a branch level over the leaves."""
    rs = np.random.RandomState(seed)
    if kind == "inline":
        return [(b"%05d" % i, bytes(rs.randint(0, 256, 40).astype(np.uint8)))
                for i in range(30)]
    if kind == "overflow":
        return [(b"%05d" % i, bytes(rs.randint(0, 256, 3000 + 2500 * i)
                                    .astype(np.uint8))) for i in range(5)]
    return [(b"%08d_img" % i, bytes(rs.randint(0, 256, 60).astype(np.uint8)))
            for i in range(700)]


KINDS = ["inline", "overflow", "multi-level"]


def _write(writer_cls, path, recs, **kw):
    with writer_cls(str(path), **kw) as w:
        for k, v in reversed(recs):         # the writers sort on close
            w.put(k, v)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_lmdb_written_by_either_package_is_read_by_both(tmp_path, writer,
                                                        kind):
    recs = _records(kind)
    _write(LMDBWriter if writer == "port" else JLMDBWriter, tmp_path / "db",
           recs)
    for reader in (LMDBReader, JLMDBReader):
        with reader(str(tmp_path / "db")) as db:
            assert len(db) == len(recs)
            assert list(db.items()) == recs
            assert db.get(recs[len(recs) // 2][0]) == recs[len(recs) // 2][1]
            if kind == "multi-level":
                assert db.depth >= 2 and db.branch_pages >= 1
            if kind == "overflow":
                assert db.overflow_pages > 0


@pytest.mark.parametrize("kind", KINDS)
def test_the_two_lmdb_writers_write_the_same_bytes(tmp_path, kind):
    # the port's writer is a copy of the JAX package's, so the same puts
    # give the same single-transaction file
    recs = _records(kind, seed=1)
    _write(LMDBWriter, tmp_path / "port", recs)
    _write(JLMDBWriter, tmp_path / "jax", recs)
    for f in ("data.mdb", "lock.mdb"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


@pytest.mark.parametrize("compress", [True, False], ids=["snappy", "raw"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_leveldb_written_by_either_package_is_read_by_both(tmp_path, writer,
                                                           compress):
    recs = _records("inline", seed=2) + _records("overflow", seed=3)[:2]
    recs = sorted(dict(recs).items())
    _write(LevelDBWriter if writer == "port" else JLevelDBWriter,
           tmp_path / "db", recs, compress=compress)
    for reader in (LevelDBReader, JLevelDBReader):
        with reader(str(tmp_path / "db"), verify_checksums=True) as db:
            assert list(db.items()) == recs
    with open_db(str(tmp_path / "db"), backend=None) as db:   # sniffed
        assert len(db) == len(recs)


def test_snappy_round_trips_every_element_kind():
    from sparknet_tpu.data.leveldb import snappy_decompress as jdecompress
    data = bytes(np.random.RandomState(4).randint(0, 4, 70000)
                 .astype(np.uint8))
    assert snappy_decompress(snappy_compress(data)) == data
    # a literal "AB", then copy-1 (overlapping), copy-2 (overlapping)
    # and copy-4 elements
    stream = bytes([11, 1 << 2, 65, 66, 1, 2, (2 << 2) | 2, 1, 0,
                    (1 << 2) | 3, 5, 0, 0, 0])
    assert snappy_decompress(stream) == jdecompress(stream) == b"ABABABBBBAB"


@pytest.fixture(scope="module")
def cifar_bins(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar_bins")
    tools.make_synth_cifar(str(d), n_train=40, n_test=12, seed=3,
                           log=lambda *a: None)
    return d


def test_convert_cifar_data_writes_the_jax_tool_s_lmdbs(tmp_path,
                                                        cifar_bins):
    tools.convert_cifar_data(str(cifar_bins), str(tmp_path / "port"),
                             log=lambda *a: None)
    jtools.convert_cifar_data(str(cifar_bins), str(tmp_path / "jax"),
                              log=lambda *a: None)
    for split, n in (("train", 40), ("test", 12)):
        name = f"cifar10_{split}_lmdb/data.mdb"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
        with LMDBReader(str(tmp_path / "port" / name)) as db:
            assert len(db) == n


@pytest.mark.parametrize("backend", ["lmdb", "leveldb"])
def test_compute_image_mean_gives_the_jax_tool_s_mean(tmp_path, backend):
    rs = np.random.RandomState(5)
    recs = [(b"%05d" % i,
             datum.array_to_datum(rs.randint(0, 256, (3, 6, 7))
                                  .astype(np.uint8), i % 3))
            for i in range(9)]
    _write(LMDBWriter if backend == "lmdb" else LevelDBWriter,
           tmp_path / "db", recs)
    mean = tools.compute_image_mean(str(tmp_path / "db"),
                                    str(tmp_path / "port.binaryproto"),
                                    backend=backend, log=lambda *a: None)
    jmean = jtools.compute_image_mean(str(tmp_path / "db"),
                                      str(tmp_path / "jax.binaryproto"),
                                      backend=backend, log=lambda *a: None)
    np.testing.assert_array_equal(mean, jmean)
    assert (tmp_path / "port.binaryproto").read_bytes() == \
        (tmp_path / "jax.binaryproto").read_bytes()
    np.testing.assert_array_equal(
        load_mean_binaryproto(str(tmp_path / "jax.binaryproto")), mean)
    assert os.path.getsize(tmp_path / "port.binaryproto") > 3 * 6 * 7 * 4


def test_convert_imageset_writes_the_jax_tool_s_db(tmp_path):
    from PIL import Image
    rs = np.random.RandomState(6)
    lines = []
    for i in range(4):
        Image.fromarray(rs.randint(0, 256, (10, 12, 3)).astype(np.uint8)) \
            .save(tmp_path / f"im{i}.png")
        lines.append(f"im{i}.png {i % 2}")
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    for mod, out in ((tools, "port"), (jtools, "jax")):
        assert mod.convert_imageset(
            str(tmp_path), str(tmp_path / "list.txt"), str(tmp_path / out),
            resize_height=8, resize_width=8, log=lambda *a: None) == 4
    assert (tmp_path / "port" / "data.mdb").read_bytes() == \
        (tmp_path / "jax" / "data.mdb").read_bytes()


def test_imagenet_loader_streams_the_jax_loader_s_batches(tmp_path):
    import tarfile
    from PIL import Image
    from sparknet_tpu.data.imagenet import ImageNetLoader as JLoader
    from sparknet_tpu_torch.data.imagenet import ImageNetLoader
    rs = np.random.RandomState(7)
    lines = []
    for t in range(2):
        with tarfile.open(tmp_path / f"part{t}.tar", "w") as tf:
            for i in range(5):
                name = f"n0{t}_{i}.png"
                buf = io.BytesIO()
                Image.fromarray(rs.randint(0, 256, (9 + i, 7, 3))
                                .astype(np.uint8)).save(buf, format="PNG")
                info = tarfile.TarInfo(name)
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))
                lines.append(f"{name} {3 * t + i}")
            info = tarfile.TarInfo("broken.png")        # undecodable: dropped
            info.size = 3
            tf.addfile(info, io.BytesIO(b"abc"))
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\nbroken.png 1\n")
    kw = dict(labels_path=str(tmp_path / "train.txt"), batch_size=4, size=8,
              loop=False)
    got = list(ImageNetLoader(str(tmp_path / "part*.tar"), **kw))
    want = list(JLoader(str(tmp_path / "part*.tar"), **kw))
    assert len(got) == len(want) == 2           # 10 images, ragged tail out
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.shape == (4, 3, 8, 8) and gi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
