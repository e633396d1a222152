"""ImageNet-style loader: tar archives of JPEGs + label map (the port's
copy of sparknet_tpu/data/imagenet.py).

Behavioral port of reference ImageNetLoader.scala: list archives (S3 there,
filesystem/glob here — zero-egress), build a filename->label map from a
``train.txt``-style file (:41-54: lines "n01440764_10026.JPEG 0"), stream
each tar's entries into (jpeg bytes, label) records (:56-86), then decode +
force-resize like ScaleAndConvert.scala (:16-27 — undecodable images are
silently dropped, :22-26) and pack fixed-size minibatches dropping the
ragged tail (:30-76).
"""

import glob
import io
import os
import tarfile

import numpy as np

SOURCE_SIZE = 256


def load_label_map(path):
    """"<filename> <int label>" lines -> {basename_without_ext: label}."""
    labels = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                name = os.path.basename(parts[0])
                labels[os.path.splitext(name)[0]] = int(parts[1])
    return labels


def _decode_resize(jpeg_bytes, size):
    """JPEG/PNG bytes -> (3, size, size) uint8 CHW, or None if undecodable
    (ScaleAndConvert drops those)."""
    try:
        from PIL import Image
        img = Image.open(io.BytesIO(jpeg_bytes)).convert("RGB")
        img = img.resize((size, size))   # force-resize, aspect be damned —
        # exactly what Thumbnailator forceSize did (ScaleAndConvert.scala:20)
        arr = np.asarray(img, np.uint8)
        return arr.transpose(2, 0, 1)
    except Exception:
        return None


def stream_tar_records(tar_path, label_map, size=SOURCE_SIZE):
    """Yield (image CHW uint8, label) from one tar archive."""
    with tarfile.open(tar_path) as tf:
        for member in tf:
            if not member.isfile():
                continue
            key = os.path.splitext(os.path.basename(member.name))[0]
            if label_map is not None and key not in label_map:
                continue
            data = tf.extractfile(member).read()
            img = _decode_resize(data, size)
            if img is None:
                continue    # dropped, like ScaleAndConvert.scala:22-26
            yield img, (label_map[key] if label_map is not None else 0)


class ImageNetLoader:
    """archive_glob -> endless stream of (images (N,3,S,S) uint8, labels)."""

    def __init__(self, archive_glob, labels_path=None, batch_size=256,
                 size=SOURCE_SIZE, loop=True, shard_index=0, num_shards=1):
        self.paths = sorted(glob.glob(archive_glob))
        if not self.paths:
            raise FileNotFoundError(f"no archives match {archive_glob!r}")
        # per-host sharding of the archive list (replaces RDD partitioning)
        self.paths = self.paths[shard_index::num_shards]
        self.label_map = load_label_map(labels_path) if labels_path else None
        self.batch_size = batch_size
        self.size = size
        self.loop = loop

    def __iter__(self):
        imgs, labs = [], []
        while True:
            for path in self.paths:
                for img, lab in stream_tar_records(path, self.label_map,
                                                   self.size):
                    imgs.append(img)
                    labs.append(lab)
                    if len(imgs) == self.batch_size:
                        yield (np.stack(imgs),
                               np.asarray(labs, np.int32))
                        imgs, labs = [], []
            if not self.loop:
                return   # ragged tail dropped (ScaleAndConvert.scala:48)
