"""Comms accounting: bytes a sync round moves, in the paper's
broadcast/collect cost model (the port of sparknet_tpu/obs/comms.py).

The port's W worker slots share one card, so its slot average moves no
bytes between chips; each parallel solver registers what the JAX
package's collective over a W-device data axis would move, from the same
formulas (a pmean of B bytes over N peers moves 2(N-1)/N * B past every
chip on a ring; the paper's driver broadcasts and collects 2*N*B), so a
report reads the tau tradeoff in the same units. Host-to-device feed
traffic is counted from the batch tensors.
"""


def tree_bytes(tree):
    """Total bytes of every tensor or array leaf of a nested dict/list/
    tuple (the solvers' {layer: [blobs]} trees)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if tree is None:
        return 0
    numel = getattr(tree, "numel", None)
    if callable(numel):                 # torch.Tensor
        return int(numel()) * int(tree.element_size())
    nb = getattr(tree, "nbytes", None)
    if nb is not None:
        return int(nb)
    import numpy as np
    try:
        return int(np.asarray(tree).nbytes)
    except Exception:
        return 0


def ring_allreduce_bytes(nbytes, n):
    """Per-chip bytes for one ring allreduce (reduce-scatter+all-gather)
    of ``nbytes`` over ``n`` peers. world_size<=1 or an empty payload is
    a no-op collective: 0 bytes, never negative/NaN."""
    n, nbytes = int(n), int(nbytes)
    if n <= 1 or nbytes <= 0:
        return 0
    return int(2 * (n - 1) / n * nbytes)


def ring_reduce_scatter_bytes(nbytes, n):
    """Per-chip bytes for one ring reduce-scatter of ``nbytes`` over
    ``n`` peers: the gradient half of an allreduce ((n-1)/n * B), all
    FSDP pays on the backward side."""
    n, nbytes = int(n), int(nbytes)
    if n <= 1 or nbytes <= 0:
        return 0
    return int((n - 1) / n * nbytes)


def ring_all_gather_bytes(nbytes, n):
    """Per-chip bytes for one ring all-gather reassembling a ``nbytes``
    global payload from its n shards ((n-1)/n * B): FSDP's
    params-at-use leg."""
    return ring_reduce_scatter_bytes(nbytes, n)


def all_to_all_bytes(nbytes, n):
    """Per-chip bytes for one all_to_all of a ``nbytes`` local buffer:
    (n-1)/n of it leaves the chip (the diagonal block stays)."""
    return ring_reduce_scatter_bytes(nbytes, n)


def broadcast_collect_bytes(nbytes, n):
    """The paper's driver-centric sync cost: broadcast N copies out plus
    collect N copies back through one driver (SparkNet's per-round
    weight movement, CifarApp.scala:92-135). A single worker IS the
    driver — nothing moves — and an empty payload moves nothing."""
    n, nbytes = int(n), int(nbytes)
    if n <= 1 or nbytes <= 0:
        return 0
    return int(2 * n * nbytes)


class CommsMeter:
    """Counts host->device feed bytes and attributes registered
    per-round collective volume; emits ``comms`` events on the same
    sampled cadence as step accounting."""

    def __init__(self, sink, emit_every=20):
        self.sink = sink
        self.emit_every = max(1, int(emit_every))
        self.topology = {}
        self.collectives = []
        self.h2d_bytes = 0           # since last emit
        self.h2d_total = 0
        self._nticks = 0
        self._last_emit_it = None

    def set_topology(self, **kw):
        self.topology.update({k: v for k, v in kw.items() if v is not None})

    def register(self, kind, bytes_per_round, axis=None, steps_per_round=1,
                 note=None, **extra):
        """Declare a collective the compiled step performs: per-chip
        ``bytes_per_round`` every ``steps_per_round`` steps (tau for
        local SGD, 1 for per-step DP). A zero-byte collective (world
        size 1, empty payload) is a no-op: nothing is registered —
        0 bytes, 0 rounds — so single-worker runs never report phantom
        (or negative) collective traffic."""
        if int(bytes_per_round) <= 0:
            return None
        c = {"kind": kind, "bytes_per_round": int(bytes_per_round),
             "steps_per_round": max(1, int(steps_per_round))}
        if axis is not None:
            c["axis"] = axis
        if note:
            c["note"] = note
        c.update(extra)
        self.collectives.append(c)
        return c

    def add_h2d(self, nbytes):
        self.h2d_bytes += int(nbytes)
        self.h2d_total += int(nbytes)

    def collective_bytes_per_step(self):
        return int(sum(c["bytes_per_round"] / c["steps_per_round"]
                       for c in self.collectives))

    def overlapped_bytes_per_step(self):
        """Per-step bytes of collectives the registering solver marked
        ``overlappable=True`` — issued while compute that doesn't depend
        on them still runs (the bucketed grad allreduce: every bucket
        but the last-issued one hides under the backward tail)."""
        return int(sum(c["bytes_per_round"] / c["steps_per_round"]
                       for c in self.collectives
                       if c.get("overlappable")))

    def exposed_bytes_per_step(self):
        """Per-step bytes structurally stuck on the critical path: the
        whole-tree collectives plus the last-issued bucket."""
        return (self.collective_bytes_per_step()
                - self.overlapped_bytes_per_step())

    def tick(self, it, force=False):
        """Call once per step/round with the just-finished iteration."""
        self._nticks += 1
        if not (force or self._nticks <= 2 or self._last_emit_it is None
                or (it - self._last_emit_it) >= self.emit_every):
            return
        steps = it - self._last_emit_it if self._last_emit_it is not None \
            else it + 1
        ev = dict(self.topology)
        ev.update(iter=it, steps=max(1, steps),
                  h2d_bytes=self.h2d_bytes,
                  h2d_bytes_total=self.h2d_total,
                  collective_bytes_per_step=self.collective_bytes_per_step())
        if self.collectives:
            ev["collectives"] = self.collectives
            over = self.overlapped_bytes_per_step()
            if over:
                total = self.collective_bytes_per_step()
                ev["overlapped_bytes_per_step"] = over
                ev["exposed_bytes_per_step"] = self.exposed_bytes_per_step()
                # upper bound: realized overlap depends on backward being
                # long enough to hide under — the trace, not this model,
                # settles that. This is the structural ceiling.
                ev["overlap_ceiling"] = round(over / total, 4) if total \
                    else 0.0
        self.sink.log("comms", **ev)
        self.h2d_bytes = 0
        self._last_emit_it = it

    def flush(self, it):
        if self.h2d_bytes > 0 or self._last_emit_it is None \
                or (self._last_emit_it != it and self._nticks):
            self.tick(it, force=True)
