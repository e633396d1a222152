"""Dataset tools of the port (sparknet_tpu/tools.py; the reference's tools/
binaries):

  convert_cifar_data   examples/cifar10/convert_cifar_data.cpp: CIFAR-10
                       binary batches -> train/test Datum LMDBs
  compute_image_mean   tools/compute_image_mean.cpp: Datum DB -> mean image
                       .binaryproto (+ per-channel means printed)
  convert_imageset     tools/convert_imageset.cpp: listfile of
                       "relpath label" lines -> Datum DB (optional resize,
                       gray, shuffle, encoded passthrough)
  make_synth_cifar     a synthetic CIFAR-10-format dataset
  upgrade_net_proto    tools/upgrade_net_proto_{text,binary}.cpp
  upgrade_solver_proto tools/upgrade_solver_proto_text.cpp
  extract_features     tools/extract_features.cpp: forward a TEST net on
                       a device, write named blobs as float-Datum DBs

Both DB backends are pure Python: LMDB (data/lmdb.py) is the default
writer; convert_imageset also writes LevelDB (data/leveldb.py), and every
reader goes through data/db_source.open_db, which reads either. The JAX
package's native host library is not used: its numpy equivalents give
the same files.
"""

import os

import numpy as np

from .data.datum import array_to_datum, datum_to_array, encoded_datum
from .data.lmdb import LMDBWriter
from .data.transforms import accumulate_sum, save_mean_binaryproto


def convert_cifar_data(input_folder, output_folder, log=print):
    """CIFAR-10 binary batches -> cifar10_{train,test}_lmdb of Datums,
    keys "%05d" in read order (convert_cifar_data.cpp:38-88)."""
    from .data.cifar import read_batch_file

    def write(db_path, files):
        with LMDBWriter(db_path) as w:
            idx = 0
            for f in files:
                images, labels = read_batch_file(
                    os.path.join(input_folder, f))
                for img, label in zip(images, labels):
                    w.put(b"%05d" % idx, array_to_datum(img, int(label)))
                    idx += 1
        return idx

    log("Writing Training data")
    n = write(os.path.join(output_folder, "cifar10_train_lmdb"),
              [f"data_batch_{i}.bin" for i in range(1, 6)])
    log(f"  {n} records")
    log("Writing Testing data")
    n = write(os.path.join(output_folder, "cifar10_test_lmdb"),
              ["test_batch.bin"])
    log(f"  {n} records")


def compute_image_mean(db_path, out_path=None, backend="lmdb", log=print):
    """Mean image over every Datum in a DB -> BlobProto .binaryproto
    (tools/compute_image_mean.cpp)."""
    from .data.db_source import open_db
    db = open_db(db_path, backend)
    acc = None
    count = 0
    try:
        for _, value in db.items():
            arr, _ = datum_to_array(value)
            if arr.dtype != np.uint8:
                arr = arr.astype(np.float64)
                acc = arr if acc is None else acc + arr
            else:
                if acc is None:
                    acc = np.zeros(arr.shape, np.int64)
                accumulate_sum(arr[None], acc)
            count += 1
    finally:
        db.close()
    if not count:
        raise ValueError(f"{db_path}: empty database")
    mean = (acc / count).astype(np.float32)
    if out_path:
        save_mean_binaryproto(mean, out_path)
        log(f"Write to {out_path}")
    for ch in range(mean.shape[0]):
        log(f"mean_value channel [{ch}]: {mean[ch].mean():.6g}")
    return mean


def make_synth_cifar(out_dir, n_train=50000, n_test=10000, seed=0,
                     noise=28.0, label_noise=0.0, log=print):
    """Write a CIFAR-10-format synthetic dataset (5 train .bin batches +
    test_batch.bin) of shape/texture-class images (see
    data/synthetic.shape_texture_images).  Stands in for the real bits the
    reference downloads in data/cifar10/get_cifar10.sh when the environment
    has no network egress; the files feed CifarDataset and the ``cifar``
    verb unchanged, and equal the JAX package's byte for byte."""
    from .data.synthetic import shape_texture_images
    from .data.cifar import write_batch_file
    os.makedirs(out_dir, exist_ok=True)
    per = n_train // 5
    for b in range(5):
        imgs, labels = shape_texture_images(per, seed=seed + b, noise=noise,
                                            label_noise=label_noise)
        write_batch_file(os.path.join(out_dir, f"data_batch_{b + 1}.bin"),
                         imgs, labels)
        log(f"data_batch_{b + 1}.bin: {per} records")
    imgs, labels = shape_texture_images(n_test, seed=seed + 1000, noise=noise,
                                        label_noise=label_noise)
    write_batch_file(os.path.join(out_dir, "test_batch.bin"), imgs, labels)
    log(f"test_batch.bin: {n_test} records")


def convert_imageset(root_folder, list_file, db_path, resize_height=0,
                     resize_width=0, gray=False, shuffle=False,
                     encoded=False, seed=0, backend="lmdb", log=print):
    """Images listed as "relative/path label" lines -> Datum DB.

    Matches tools/convert_imageset.cpp keys ("%08d_<path>") and flags
    (--resize_height/width, --gray, --shuffle, --encoded, --backend
    lmdb/leveldb). Undecodable images are skipped with a warning, like the
    reference's ReadImageToDatum false return (and
    ScaleAndConvert.scala:22-26)."""
    from PIL import Image

    lines = []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            path, _, label = line.rpartition(" ")
            lines.append((path, int(label)))
    if shuffle:
        np.random.RandomState(seed).shuffle(lines)
    log(f"A total of {len(lines)} images.")

    if backend == "leveldb":
        from .data.leveldb import LevelDBWriter as _Writer
    else:
        _Writer = LMDBWriter
    written = 0
    with _Writer(db_path) as w:
        for i, (rel, label) in enumerate(lines):
            full = os.path.join(root_folder, rel)
            try:
                if encoded and not (resize_height or resize_width or gray):
                    with open(full, "rb") as f:
                        raw = f.read()
                    datum = encoded_datum(raw, label)
                else:
                    img = Image.open(full)
                    img = img.convert("L" if gray else "RGB")
                    if resize_height and resize_width:
                        img = img.resize((resize_width, resize_height),
                                         Image.BILINEAR)
                    a = np.asarray(img, np.uint8)
                    if a.ndim == 2:
                        a = a[None]            # (1,H,W)
                    else:
                        a = a[:, :, ::-1].transpose(2, 0, 1)  # HWC RGB->CHW BGR
                    datum = array_to_datum(np.ascontiguousarray(a), label)
            except (OSError, ValueError) as e:
                log(f"Could not open or find file {full}: {e}")
                continue
            w.put(b"%08d_%s" % (i, rel.encode()), datum)
            written += 1
            if written % 1000 == 0:
                log(f"Processed {written} files.")
    log(f"Processed {written} files.")
    return written


def upgrade_net_proto(in_path, out_path, binary=False, log=print):
    """Any-vintage NetParameter file -> latest format
    (tools/upgrade_net_proto_text.cpp / upgrade_net_proto_binary.cpp:
    V0 upgrade + V1 upgrade + deprecated data-transform move, then write).

    binary=False reads/writes prototxt text; True reads/writes wire bytes
    (.caffemodel-style)."""
    from .graph.upgrade import (needs_v0_upgrade, net_needs_data_upgrade,
                                upgrade_net)
    from .proto import text_format, wire
    codec = wire if binary else text_format
    net = codec.load(in_path, "NetParameter")
    if not (needs_v0_upgrade(net) or len(net.layers)
            or net_needs_data_upgrade(net)):
        log(f"File already in latest proto format: {in_path}")
    net = upgrade_net(net)
    codec.dump(net, out_path)
    log(f"Wrote upgraded NetParameter {'binary' if binary else 'text'} "
        f"proto to {out_path}")
    return net


def upgrade_solver_proto(in_path, out_path, log=print):
    """Deprecated solver_type enum -> type string in a solver prototxt
    (tools/upgrade_solver_proto_text.cpp)."""
    from .graph.upgrade import solver_needs_type_upgrade, upgrade_solver
    from .proto import text_format
    sp = text_format.load(in_path, "SolverParameter")
    if not solver_needs_type_upgrade(sp):
        log(f"File already in latest proto format: {in_path}")
    sp = upgrade_solver(sp)
    text_format.dump(sp, out_path)
    log(f"Wrote upgraded SolverParameter text proto to {out_path}")
    return sp


def extract_features(model_path, blob_names, db_paths, num_batches,
                     weights_path=None, base_dir=None, backend="lmdb",
                     device="cuda", log=print):
    """Forward a TEST-phase net num_batches times on ``device`` and write
    the named blobs' per-image activations as float Datums, keys "%010d"
    (tools/extract_features.cpp:135-185; Datum channels/height/width
    follow the legacy 4-d blob accessors, so an (N, D) blob writes
    (D, 1, 1) features).

    blob_names / db_paths are parallel lists (the reference's
    comma-separated pairs). The net's own TEST data layer supplies input,
    host-transformed; its source is resolved relative to base_dir
    (default: the model file's directory, walking up like the CLI).
    Random-init params (weights_path None) draw from a generator seeded
    with 0."""
    import torch
    from .data.db_source import resolve_db_feed
    from .graph.compiler import TEST, CompiledNet
    from .graph.upgrade import upgrade_net
    from .proto import text_format, wire
    from .solver import hdf5_io

    if len(blob_names) != len(db_paths):
        raise ValueError("the number of blob names and dataset names "
                         "must be equal")
    net_param = upgrade_net(text_format.load(model_path, "NetParameter"))
    feed_shapes, src = resolve_db_feed(
        net_param, TEST,
        base_dir or os.path.dirname(os.path.abspath(model_path)), seed=0)
    if src is None:
        raise ValueError(
            f"{model_path}: no TEST data layer with a readable source "
            "(extract_features needs the net to feed itself)")
    counts = [0] * len(blob_names)
    try:
        net = CompiledNet(net_param, TEST, feed_shapes=feed_shapes,
                          device=device)
        params, state = net.init(torch.Generator().manual_seed(0))
        if weights_path:
            if weights_path.endswith(".h5"):
                hdf5_io.load_net_hdf5(weights_path, params)
            else:
                params, state = net.load_netproto(
                    wire.load(weights_path, "NetParameter"), params, state)
        for b in blob_names:
            if b not in net.blob_shapes:
                raise ValueError(f"Unknown feature blob name {b} in the "
                                 f"network {model_path}")
        log("Extracting Features")
        if backend == "leveldb":
            from .data.leveldb import LevelDBWriter as _W
        else:
            _W = LMDBWriter
        writers = [_W(p) for p in db_paths]
        try:
            it = iter(src)
            for _ in range(num_batches):
                with torch.inference_mode():
                    blobs, _ = net.apply(params, state, next(it),
                                         train=False)
                for i, b in enumerate(blob_names):
                    arr = blobs[b].to("cpu", torch.float32).numpy()
                    n = arr.shape[0]
                    # legacy 4-d accessors: (N, C[, H[, W]]) -> (C, H, W)
                    chw = arr.reshape(n,
                                      arr.shape[1] if arr.ndim > 1 else 1,
                                      arr.shape[2] if arr.ndim > 2 else 1,
                                      -1)
                    for row in chw:
                        writers[i].put(b"%010d" % counts[i],
                                       array_to_datum(row))
                        counts[i] += 1
                        if counts[i] % 1000 == 0:
                            log(f"Extracted features of {counts[i]} query "
                                f"images for feature blob {b}")
        finally:
            for w in writers:
                w.close()
    finally:
        src.close()
    for b, c in zip(blob_names, counts):
        log(f"Extracted features of {c} query images for feature blob {b}")
    return counts
