"""Data sources of the port: CIFAR-10 binaries, synthetic images and
token streams, and the prefetching iterators the CIFAR app reads them
through."""

from .cifar import CifarDataset, read_batch_file, write_batch_file
from .prefetch import EchoIterator, PrefetchIterator
from .synthetic import (bigram_corpus, class_gaussian_images,
                        lm_batch_stream, shape_texture_images)

__all__ = ["CifarDataset", "read_batch_file", "write_batch_file",
           "EchoIterator", "PrefetchIterator", "bigram_corpus",
           "class_gaussian_images", "lm_batch_stream",
           "shape_texture_images"]
