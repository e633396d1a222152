"""Per-host sharded ingest — each host reads only the records it owns
(the port of sparknet_tpu/data/ingest.py).

The paper's design flaw was funneling all *weight* traffic through one
Spark driver; a single-reader ingest funnels all *data* traffic through
one host the same way. IngestShard splits the record index space into one
partition per host of the multi-host runtime and maps partitions to live
hosts with ``sampler.partition_owners`` — the SAME ownership rule that
drives eviction re-spread and cross-world checkpoint resharding — so
ingest bandwidth scales with the fleet and elastic membership changes
move data ownership and ingest ownership together, by construction.

A shard is immutable; ``respread(alive)`` derives the successor shard for
a new membership mask. Reads are index-space only (``take``): the caller
owns the actual record storage, which keeps this reusable across the
in-memory CIFAR arrays, LMDB cursors, and anything else indexable.
"""

import numpy as np

from .sampler import partition_owners


class IngestShard:
    """The record indices one host reads, under a live-host mask.

    num_records: total records in the (globally shared) dataset.
    host/hosts:  this host's index and the world size (one partition per
                 host slot).
    alive:       optional bool mask over host slots (default: all live);
                 dead slots' partitions fold onto survivors per
                 partition_owners.
    metrics:     optional MetricsLogger; emits closed ``ingest`` events
                 (kind=init/respread at construction, throttled kind=read
                 from take()) so a run can be checked from the
                 metrics stream that a host touched only owned records.
    """

    def __init__(self, num_records, host, hosts, alive=None, metrics=None,
                 _kind="init"):
        self.num_records = int(num_records)
        self.host = int(host)
        self.hosts = int(hosts)
        if alive is None:
            alive = np.ones(self.hosts, bool)
        self.alive = np.asarray(alive, bool).copy()
        owners = partition_owners(self.hosts, self.alive)
        self.partitions = [p for p in range(self.hosts)
                           if owners[p] == self.host]
        n, H = self.num_records, self.hosts
        chunks = [np.arange(p * n // H, (p + 1) * n // H)
                  for p in self.partitions]
        self.indices = (np.concatenate(chunks) if chunks
                        else np.empty(0, np.int64)).astype(np.int64)
        self.owned = len(self.indices)
        self._metrics = metrics
        self._reads = 0
        self._emit(_kind)

    def _emit(self, kind, lo=-1, hi=-1):
        if self._metrics is not None:
            self._metrics.log(
                "ingest", kind=kind, host=self.host, hosts=self.hosts,
                partitions=len(self.partitions), records=self.owned,
                lo=int(lo), hi=int(hi), reads=self._reads)

    def take(self, start, count, emit_every=25):
        """``count`` record indices from the owned set, starting at owned
        position ``start`` and wrapping modulo the shard (the same
        wrap-around cursor discipline as db_source._records, confined to
        owned records)."""
        if self.owned == 0:
            raise ValueError(
                f"host {self.host} owns no records "
                f"({self.num_records} records over {self.hosts} hosts)")
        pos = (int(start) + np.arange(int(count))) % self.owned
        idx = self.indices[pos]
        self._reads += 1
        if self._reads % max(1, emit_every) == 1:
            self._emit("read", lo=idx.min(), hi=idx.max())
        return idx

    def respread(self, alive):
        """Successor shard for a new live-host mask (elastic evict/admit):
        survivors inherit dead hosts' partitions round-robin, exactly as
        data ownership re-spreads."""
        return IngestShard(self.num_records, self.host, self.hosts,
                           alive=alive, metrics=self._metrics,
                           _kind="respread")

    def describe(self):
        return {"host": self.host, "hosts": self.hosts,
                "partitions": len(self.partitions), "records": self.owned}
