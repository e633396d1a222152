"""Minibatch sampling over a partition's batch stream (the port of
sparknet_tpu/data/sampler.py; numpy only).

Behavioral port of reference MinibatchSampler.scala: from a stream of
``totalNumBatches`` minibatches, sample a random *contiguous window* of
``numSampledBatches`` (start index uniform in [0, total - sampled],
MinibatchSampler.scala:20-21) and iterate it. The reference's dual
image/label callback trick (:28-60) existed only because Caffe pulled
images and labels through two separate C callbacks against one iterator;
with dict batches there is nothing to keep in lock-step.

partition_owners() is the JAX package's elastic re-sharding rule (its
resilience/elastic.py; ROADMAP A6 in the port): when workers are evicted
from the mesh, each dead slot's data partition is re-assigned to a
survivor round-robin, so the stream keeps being consumed by the workers
that can still train on it.
"""

import numpy as np


class MinibatchSampler:
    def __init__(self, batches, total_num_batches, num_sampled_batches,
                 rng=None):
        """batches: iterable of batch dicts (or (images, labels) tuples)."""
        rng = rng or np.random
        self.total = int(total_num_batches)
        self.start = int(rng.randint(0, total_num_batches
                                     - num_sampled_batches + 1))
        self.num_sampled = num_sampled_batches
        self._it = iter(batches)
        self._pos = -1
        self._emitted = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._emitted >= self.num_sampled:
            raise StopIteration
        target = self.start + self._emitted
        while self._pos < target:
            try:
                batch = next(self._it)
            except StopIteration:
                # a bare StopIteration here would read as "window done"
                # (and, inside a generator, PEP 479's opaque
                # RuntimeError) — the stream lied about its length, say
                # so with the numbers
                raise ValueError(
                    f"batch stream exhausted after {self._pos + 1} "
                    f"batches; the sampled window [{self.start}, "
                    f"{self.start + self.num_sampled}) needs "
                    f"{target + 1} (total_num_batches={self.total})"
                ) from None
            self._pos += 1
        self._emitted += 1
        return batch


def partition_owners(num_partitions, alive):
    """Map every data partition (one per mesh slot) to the live worker
    that consumes it: live slots own their partition; dead slots'
    partitions are re-assigned round-robin across the survivors.

    >>> partition_owners(4, [True, False, True, False])
    array([0, 0, 2, 2])
    """
    alive = np.asarray(alive, bool).ravel()
    if len(alive) != int(num_partitions):
        raise ValueError(f"alive mask has {len(alive)} entries for "
                         f"{num_partitions} partitions")
    live = np.nonzero(alive)[0]
    if len(live) == 0:
        raise ValueError("no live workers to own the partitions")
    owners = np.empty(int(num_partitions), np.int64)
    j = 0
    for p in range(int(num_partitions)):
        if alive[p]:
            owners[p] = p
        else:
            owners[p] = live[j % len(live)]
            j += 1
    return owners


def reshard_owners(n_from, n_to):
    """Cross-world re-partitioning rule (the JAX package's
    resilience/checkpoint.py reshard_for_world): carry ``n_from`` data partitions written by
    world W1 onto world W2's ``n_to`` slots, reusing partition_owners
    in both directions so resharding and eviction follow ONE rule.

    Shrink (n_to < n_from): W1's world with the trailing slots dead —
    owners[p] is the W2 slot that inherits W1 partition p, so every
    old partition stays owned:

    >>> reshard_owners(4, 2)
    array([0, 1, 0, 1])

    Grow (n_to > n_from): W2's world where only the first n_from slots
    arrive with data — owners[s] is the W1 partition new slot s
    bootstraps from:

    >>> reshard_owners(2, 4)
    array([0, 1, 0, 1])

    Same size is the identity (bit-for-bit restore, no re-spread). The
    returned array always has max(n_from, n_to) entries — the larger
    world's slot count.
    """
    a, b = int(n_from), int(n_to)
    if a <= 0 or b <= 0:
        raise ValueError(f"worlds need at least one slot "
                         f"(got {n_from} -> {n_to})")
    n = max(a, b)
    k = min(a, b)
    alive = np.zeros(n, bool)
    alive[:k] = True
    return partition_owners(n, alive)
