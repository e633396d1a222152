"""ZeRO/FSDP sharded data parallelism over the "data" slots (the port of
sparknet_tpu/parallel/fsdp.py).

Each eligible blob (its leading dim divides the slot count, at least
SPARKNET_FSDP_MIN_SIZE elements, default 2048) is dim-0 sharded over
the W data slots: slot w owns rows [w*d0/W, (w+1)*d0/W), and its
optimizer history shards the same way. A step runs the JAX solver's
three legs over the slots:

  * the params are gathered at use (``gather_full``: the slot
    collective all_gather of the shards), one slot at a time, and the
    slot takes its gradient of its own rows of the batch;
  * the gradients are reduce-scattered (``scatter_grads``: psum_scatter
    of the slots' gradients over the data axis, divided by W; the
    replicated blobs take the pmean), so each slot keeps the mean of
    its own shard rows;
  * each shard takes its own update, elementwise on its rows; the
    replicated blobs are updated once. A clip uses the global norm
    (``sharded_sq_norm``).

On one card the W shards of a blob are W row blocks of one buffer (the
full tensor in ``params``), so snapshots, restores and weight loads are
the single-device files, and the params, the history and the update are
exactly what W devices would hold and do; the memory a card saves is
not saved here, where every shard shares the card. The JAX contract
that FSDP is bit for bit DP at fp32 is not one (ROADMAP C5): the port
is held to the JAX FSDPSolver within a tolerance. Elastic membership and
bounded staleness are refused, as in the JAX solver.
"""

import os
import time

import numpy as np
import torch

from ..data.prefetch import wait_staged
from ..obs.comms import (ring_all_gather_bytes, ring_allreduce_bytes,
                         ring_reduce_scatter_bytes, tree_bytes)
from ..resilience.elastic import masked_consensus_stats
from ..solver.solver import Solver, to_device
from ..solver.updates import clip_factor
from .data_parallel import DataParallelSolver, _average_states
from .mesh import DATA_AXIS, SlotMesh, all_gather, psum, psum_scatter
from .overlap import plan_buckets


def fsdp_enabled(default=False):
    """SPARKNET_FSDP=on|off: shard params + optimizer state over the data
    slots (default off: the replicated DP path)."""
    v = os.environ.get("SPARKNET_FSDP", "").strip().lower()
    if not v:
        return default
    return v in ("1", "on", "true", "yes")


def fsdp_min_size(default=2048):
    """SPARKNET_FSDP_MIN_SIZE: the smallest element count worth sharding;
    blobs under it stay replicated."""
    v = os.environ.get("SPARKNET_FSDP_MIN_SIZE", "").strip()
    return int(v) if v else default


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *[x[k] for x in trees]) for k in t}
    if isinstance(t, list):
        return [_tree_map(fn, *[x[i] for x in trees]) for i in range(len(t))]
    return fn(*trees)


def _leaves(tree):
    """Leaves in jax.tree_util order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def plan_param_specs(tree, n, axis=DATA_AXIS, min_size=None):
    """Per-leaf sharding: ``(axis,)`` (dim-0 sharded) for a leaf whose
    leading dim divides ``n`` and whose element count clears
    ``min_size``, ``()`` (replicated) otherwise; a tree congruent with
    ``tree`` (the JAX function's PartitionSpecs as tuples)."""
    if min_size is None:
        min_size = fsdp_min_size()

    def spec(x):
        shape = tuple(x.shape)
        if n > 1 and shape and shape[0] % n == 0 and \
                int(np.prod(shape)) >= min_size:
            return (axis,)
        return ()

    return _tree_map(spec, tree)


def sharded_bytes(tree, specs, n):
    """(per-slot bytes, replicated-equivalent bytes) of ``tree`` placed
    per ``specs``."""
    per_dev = total = 0
    for x, s in zip(_leaves(tree), _leaves(specs)):
        b = int(x.numel()) * x.element_size()
        total += b
        per_dev += b // n if s else b
    return per_dev, total


def take_shard(tree, specs, mesh, axis, w):
    """Slot ``w``'s dim-0 block of each sharded leaf (a view), the
    replicated leaves whole."""
    n = mesh.shape[axis]
    i = mesh.axis_index(w, axis)

    def one(x, s):
        if not s:
            return x
        blk = x.shape[0] // n
        return x.narrow(0, i * blk, blk)

    return _tree_map(one, tree, specs)


def gather_full(shards, specs, mesh, axis):
    """The all_gather of the sharded leaves: ``shards`` holds one tree of
    slot blocks a slot; returns one tree a slot with each sharded leaf
    whole again (the blocks concatenated in axis order, the exact
    inverse of ``take_shard``), the replicated leaves passed through."""
    W = mesh.size
    flat = [_leaves(t) for t in shards]
    spec_leaves = _leaves(specs)
    out = [[None] * len(spec_leaves) for _ in range(W)]
    for j, s in enumerate(spec_leaves):
        col = [flat[w][j] for w in range(W)]
        full = all_gather(col, mesh, axis) if s else col
        for w in range(W):
            out[w][j] = full[w]
    return [_unflatten(specs, o) for o in out]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    tree = build(like)
    return {k: tree[k] for k in like} if isinstance(like, dict) else tree


def scatter_grads(grads, specs, mesh, axis):
    """The FSDP gradient consensus over one gradient tree a slot: a
    sharded leaf is reduce-scattered (psum_scatter over ``axis``,
    divided by the axis size: each slot keeps the mean of its own shard
    rows), a replicated leaf takes the pmean. Collectives go per
    reverse-order bucket (overlap.plan_buckets), as in the JAX
    function; the per-element sums are the same either way."""
    W, n = mesh.size, mesh.shape[axis]
    flat = [_leaves(t) for t in grads]
    spec_leaves = _leaves(specs)
    out = [[None] * len(spec_leaves) for _ in range(W)]
    for bucket in plan_buckets(grads[0])["buckets"]:
        for j, _, _, _ in bucket:
            col = [flat[w][j] for w in range(W)]
            parts = psum_scatter(col, mesh, axis) if spec_leaves[j] \
                else psum(col, mesh, axis)
            for w in range(W):
                out[w][j] = parts[w] / n
    return [_unflatten(specs, o) for o in out]


def sharded_sq_norm(grads, specs, mesh, axis):
    """Global squared L2 norm of a shard/replicated gradient tree a slot:
    the sharded leaves' partial sums added over the slots of ``axis``
    (each holds disjoint rows), the replicated leaves counted once."""
    group, total = mesh.groups(axis)[0], None
    for w in group:
        for x, s in zip(_leaves(grads[w]), _leaves(specs)):
            if s or w == group[0]:
                ss = x.float().square().sum()
                total = ss if total is None else total + ss
    return total


class FSDPSolver(DataParallelSolver):
    """DataParallelSolver whose params and optimizer history live dim-0
    sharded over the data slots; the same construction, step, test and
    snapshot surface. ``min_shard_size`` overrides
    SPARKNET_FSDP_MIN_SIZE."""

    def __init__(self, solver_param, mesh=None, axis=DATA_AXIS,
                 min_shard_size=None, workers=None, **kw):
        if kw.get("staleness") is not None:
            raise ValueError(
                "FSDP refuses bounded staleness: a lagging worker holds "
                "the only copy of its param shard, so discounting it "
                "corrupts the model instead of degrading gracefully")
        if mesh is not None:
            workers = mesh.shape[axis]
        self.axis = axis
        super().__init__(solver_param, workers=workers or 1, **kw)
        self.mesh = SlotMesh({axis: self.workers})
        n = self.workers
        self._min_shard_size = min_shard_size
        self.fsdp_specs = plan_param_specs(self.params, n, axis,
                                           min_size=min_shard_size)
        self.fsdp_hist_specs = plan_param_specs(self.history, n, axis,
                                                min_size=min_shard_size)
        self._fsdp_logged = False
        if self.metrics is not None:
            sl = sum(bool(s) for s in _leaves(self.fsdp_specs))
            pd, tot = sharded_bytes(self.params, self.fsdp_specs, n)
            hd, htot = sharded_bytes(self.history, self.fsdp_hist_specs, n)
            self.metrics.log(
                "fsdp", kind="plan", axis=axis, world=n,
                sharded_leaves=int(sl),
                total_leaves=len(_leaves(self.fsdp_specs)),
                param_bytes_per_device=int(pd),
                param_bytes_replicated=int(tot),
                hist_bytes_per_device=int(hd),
                hist_bytes_replicated=int(htot),
                min_size=int(min_shard_size if min_shard_size is not None
                             else fsdp_min_size()))

    def arm_elastic(self, *a, **kw):
        raise ValueError(
            "FSDP shards each param over the workers; evicting one "
            "loses its shard. Use snapshots + restore (--resume auto) "
            "for fault tolerance, or run elastic training with fsdp=off")

    def arm_staleness(self, *a, **kw):
        raise ValueError(
            "FSDP refuses bounded staleness (sharded params cannot "
            "tolerate a discounted worker); run with fsdp=off")

    def train_step(self, batch):
        """One step: each slot gathers the params, takes its gradient of
        its rows, the gradients reduce-scatter, each shard updates."""
        iter_size = int(self.param.iter_size)
        self.check_batch(batch, leading=(iter_size,) if iter_size > 1
                         else ())
        fed = batch
        stats = self._obs_sampled_next() and self.divergence is not None
        self._obs_begin()
        t0 = time.perf_counter()
        batch = self._transform(to_device(wait_staged(batch), self.device),
                                self.input_transform, iter_size)
        mesh, axis, W = self.mesh, self.axis, self.workers
        with torch.no_grad():
            shards = [take_shard(_detach(self.params), self.fsdp_specs,
                                 mesh, axis, w) for w in range(W)]
        losses, states, grads = [], [], []
        for w, (shard, gen) in enumerate(zip(
                self._shards(batch, self.local_net, int(iter_size > 1)),
                self.slot_generators)):
            full = gather_full(shards, self.fsdp_specs, mesh, axis)[w]
            full = {n: [p.detach().requires_grad_(True) for p in ps]
                    for n, ps in full.items()}
            micros = [shard] if iter_size == 1 else \
                [{k: v[i] for k, v in shard.items()}
                 for i in range(iter_size)]
            state, slot, acc = self.state, [], None
            for micro in micros:
                loss, (_, state) = self.local_net.loss_fn(
                    full, state, micro, gen)
                leaves = [p for n in full for p in full[n]]
                g = torch.autograd.grad(loss, leaves, allow_unused=True)
                g = [torch.zeros_like(p) if x is None else x
                     for p, x in zip(leaves, g)]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                slot.append(loss.detach())
            it = iter(acc)
            grads.append({n: [next(it) for _ in ps] for n, ps in full.items()})
            losses.append(torch.stack(slot).mean())
            states.append(state)
        losses = torch.stack(losses)
        aux = None
        if stats:
            stacked = _tree_map(lambda *g: torch.stack(g), *grads)
            gfull, aux = masked_consensus_stats(
                stacked, torch.ones(W, device=self.device))
            aux["ref_sq"] = sum(g.float().square().sum()
                                for gs in gfull.values() for g in gs)
            aux["worker_loss"] = losses
            gsh = [take_shard(gfull, self.fsdp_specs, mesh, axis, w)
                   for w in range(W)]
        else:
            gsh = scatter_grads(grads, self.fsdp_specs, mesh, axis)
        self.state = _average_states(states)
        self._sharded_update(gsh)
        self.iter += 1
        self._obs_step(time.perf_counter() - t0, losses.mean(), fed,
                       aux=dict(aux, kind="grads") if aux else None)
        if not self._fsdp_logged and self.metrics is not None:
            self._fsdp_logged = True
            pd, tot = sharded_bytes(self.params, self.fsdp_specs, W)
            self.metrics.log(
                "fsdp", kind="exec", axis=axis, world=W, iter=self.iter,
                param_bytes_per_device=int(pd), param_bytes_replicated=tot)
        return self._chaos_loss(losses.mean())

    def _sharded_update(self, gsh):
        """Each slot's update of its own shard rows (views into the full
        params and history); the replicated blobs once."""
        mesh, axis, W = self.mesh, self.axis, self.workers
        scale = None
        if float(self.updater.clip) >= 0:
            scale = clip_factor(
                sharded_sq_norm(gsh, self.fsdp_specs, mesh, axis),
                float(self.updater.clip))
        rate = self.lr_fn(self.iter)
        for w in range(W):
            p_w = take_shard(self.params, self.fsdp_specs, mesh, axis, w)
            h_w = take_shard(self.history, self.fsdp_hist_specs, mesh,
                             axis, w)
            for lname, blobs in p_w.items():
                for i, p in enumerate(blobs):
                    if not self.fsdp_specs[lname][i] and w:
                        continue
                    self.updater.update_blob(
                        lname, i, p.detach(), gsh[w][lname][i],
                        [h for h in h_w[lname][i]], rate, self.iter, scale)

    def _register_comms(self, cm):
        """FSDP per step: the all-gather of the sharded params, the
        reduce-scatter of their grads and the allreduce of what stayed
        replicated, per reverse-order bucket, as the JAX solver
        registers them."""
        Solver._register_comms(self, cm)
        n = self.workers
        cm.set_topology(axes=dict(self.mesh_shape))
        leaves = _leaves(self.params)
        sharded = [bool(s) for s in _leaves(self.fsdp_specs)]
        buckets = plan_buckets(self.params)["buckets"]
        for bi, bucket in enumerate(buckets):
            shard_b = sum(sz * leaves[i].element_size()
                          for i, _, _, sz in bucket if sharded[i])
            rep_b = sum(sz * leaves[i].element_size()
                        for i, _, _, sz in bucket if not sharded[i])
            last = bi == len(buckets) - 1
            if shard_b:
                cm.register("fsdp_allgather_params",
                            ring_all_gather_bytes(shard_b, n),
                            axis=self.axis, bucket=bi, overlappable=True,
                            note="param all-gather at use; hides under "
                                 "the previous layer's compute")
                cm.register("fsdp_reduce_scatter_grads",
                            ring_reduce_scatter_bytes(shard_b, n),
                            axis=self.axis, bucket=bi,
                            overlappable=not last,
                            note="grad reduce-scatter, issued as backward "
                                 "drains; ring model per chip")
            if rep_b:
                cm.register("allreduce_grads_bucket",
                            ring_allreduce_bytes(rep_b, n),
                            axis=self.axis, bucket=bi,
                            overlappable=not last,
                            note="replicated-leaf grad pmean (blobs under "
                                 "the shard threshold)")
        cm.register("allreduce_state",
                    ring_allreduce_bytes(tree_bytes(self.state), n),
                    axis=self.axis,
                    note="pmean(state) per step, ring model per chip")


def _detach(tree):
    return _tree_map(lambda x: x.detach(), tree)
