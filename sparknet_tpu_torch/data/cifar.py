"""CIFAR-10 binary-format loader, copied from sparknet_tpu/data/cifar.py
(records decoded by the native host library, native/, as there).

Behavioral port of reference CifarLoader.scala: reads the five
``data_batch_N.bin`` files (each record = 1 label byte + 3072 CHW image
bytes) plus ``test_batch.bin``, shuffles the train set by a permutation, and
computes the mean image over the train set (CifarLoader.scala:58-64). Arrays
are numpy (N, 3, 32, 32) uint8 — vectorized, not per-byte loops.
"""

import os
import glob

import numpy as np

HEIGHT = WIDTH = 32
CHANNELS = 3
SIZE = CHANNELS * HEIGHT * WIDTH
RECORD = 1 + SIZE


def read_batch_file(path):
    """One .bin file -> (images uint8 (N,3,32,32), labels int32 (N,))."""
    raw = np.fromfile(path, np.uint8)
    if raw.size % RECORD:
        raise ValueError(f"{path}: size {raw.size} not a multiple of {RECORD}")
    from .. import native
    images, labels = native.decode_cifar_records(raw, RECORD)
    return images.reshape(-1, CHANNELS, HEIGHT, WIDTH), labels


def write_batch_file(path, images, labels):
    """Inverse of read_batch_file (test fixtures / format round-trip)."""
    images = np.asarray(images, np.uint8).reshape(-1, SIZE)
    labels = np.asarray(labels, np.uint8).reshape(-1, 1)
    np.concatenate([labels, images], axis=1).tofile(path)


class CifarDataset:
    """Train/test arrays + mean image, shuffled like the reference loader."""

    def __init__(self, path, seed=None):
        files = sorted(glob.glob(os.path.join(path, "*.bin")))
        test_files = [f for f in files
                      if os.path.basename(f) == "test_batch.bin"]
        if not test_files:
            raise FileNotFoundError(f"no test_batch.bin under {path}")
        train_files = [f for f in files if f not in test_files]
        imgs, labs = zip(*(read_batch_file(f) for f in train_files))
        self.train_images = np.concatenate(imgs)
        self.train_labels = np.concatenate(labs)
        self.test_images, self.test_labels = read_batch_file(test_files[0])
        rng = np.random.RandomState(seed)
        perm = rng.permutation(len(self.train_images))
        self.train_images = self.train_images[perm]
        self.train_labels = self.train_labels[perm]
        # mean image over the train set, float32 CHW
        self.mean_image = self.train_images.astype(np.float64) \
            .mean(axis=0).astype(np.float32)

    def minibatches(self, batch_size, train=True, subtract_mean=True,
                    scale=1.0, drop_ragged=True):
        """Yield {'data','label'} batches; ragged tail dropped like the
        reference's fixed-size minibatch packing (ScaleAndConvert.scala:48)."""
        images = self.train_images if train else self.test_images
        labels = self.train_labels if train else self.test_labels
        n = len(images) // batch_size * batch_size if drop_ragged \
            else len(images)
        for i in range(0, n, batch_size):
            x = images[i:i + batch_size].astype(np.float32)
            if subtract_mean:
                x = x - self.mean_image
            if scale != 1.0:
                x = x * scale
            yield {"data": x, "label": labels[i:i + batch_size]}
