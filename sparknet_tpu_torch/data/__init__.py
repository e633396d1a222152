"""Data sources of the port: CIFAR-10 binaries, Datum records in LMDB
and LevelDB (datum, lmdb, leveldb, db_source), image lists, window files
and HDF5 files (file_sources), ImageNet tar archives, synthetic images
and token streams; the input transforms on the host (transforms) and on
the device (device_transform), the compressed wire (wire), the dataset
resident on the card (device_cache), minibatch sampling (sampler), and
the prefetching iterators and host-to-card stager the apps and the train
verb read through."""

from .cifar import CifarDataset, read_batch_file, write_batch_file
from .prefetch import EchoIterator, PrefetchIterator
from .sampler import MinibatchSampler, partition_owners, reshard_owners
from .synthetic import (bigram_corpus, class_gaussian_images,
                        lm_batch_stream, shape_texture_images)

__all__ = ["CifarDataset", "read_batch_file", "write_batch_file",
           "EchoIterator", "PrefetchIterator", "MinibatchSampler",
           "partition_owners", "reshard_owners", "bigram_corpus",
           "class_gaussian_images", "lm_batch_stream",
           "shape_texture_images"]
